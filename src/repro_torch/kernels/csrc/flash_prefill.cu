// Causal flash attention for prefill on Hopper.  Replaces the Pallas TPU
// kernel repro/kernels/flash_prefill.py::flash_prefill (body _kernel).
//
// What it computes: grouped-query attention of q (B,S,H,D) against
// k/v (B,Skv,Hkv,D/Dv), the KV head of query head h being h / (H/Hkv):
// scores softcap(scale * q . k), masked to kv positions < kv_len[b] and,
// when causal, to positions <= the query's (and > query - window when a
// window is set); output the softmax-weighted V sum, normalized, in q's
// dtype.  The online softmax keeps the TPU kernel's running triple
// (m_safe, l, acc) in f32, so rows with context match
// models.common.chunked_attention; a row with no valid key gives 0.
//
// Bound on the H100: operations, about 4*B*H*S^2*D/2 for a causal prompt
// (each query against the keys up to its own position); its bytes (q, k,
// v read once, o written once) are small beside them.
//
// Design.  The TPU grid is (B*H, S/bq, Skv/bk) with the KV axis sequential
// and the triple in VMEM scratch.  Here one block of 128 threads takes one
// (16-query tile, batch*head) pair and loops over 32-key tiles itself,
// stopping at the causal limit and the row's kv_len and starting at the
// window's edge, so masked tiles are never read.  Per tile: K and V are
// staged in shared memory as f32 (K rows padded by one float so the score
// loop is free of bank conflicts), each thread forms 4 scores of one query
// row, one thread per row updates that row's (m, l) and turns its scores
// into probabilities, and the threads then update the (16, Dv)
// accumulator column by column.  The products are CUDA-core f32 FMAs;
// wgmma tiles and TMA pipelines are work for a later PR.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per block (kThreads / 8)
constexpr int kBK = 32;  // keys per tile (8 threads x 4 scores)

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * (D + 1) +
          static_cast<size_t>(kBK) * Dv + kBQ * kBK +
          static_cast<size_t>(kBQ) * Dv + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ kv_len, T* __restrict__ o,
                         int S, int Skv, int H, int Hkv, int D, int Dv,
                         int causal, int window, float scale, float cap) {
  extern __shared__ float sm[];
  const int ldk = D + 1;
  float* qs = sm;                 // [kBQ][ldk]  pre-scaled queries
  float* ks = qs + kBQ * ldk;     // [kBK][ldk]
  float* vs = ks + kBK * ldk;     // [kBK][Dv]
  float* ps = vs + kBK * Dv;      // [kBQ][kBK]  scores, then probabilities
  float* os = ps + kBQ * kBK;     // [kBQ][Dv]   unnormalized output
  float* ms = os + kBQ * Dv;      // [kBQ]       running m_safe
  float* ls = ms + kBQ;           // [kBQ]       running denominator
  float* cs = ls + kBQ;           // [kBQ]       this tile's correction
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, S - q0);
  const int len = min(kv_len[b], Skv);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[r * ldk + d] =
        r < nq ? to_f32(q[((static_cast<size_t>(b) * S + q0 + r) * H + h) *
                              D + d]) * scale
               : 0.f;
  }
  for (int i = tid; i < kBQ * Dv; i += kThreads) os[i] = 0.f;
  if (tid < kBQ) {
    ms[tid] = REPRO_NEG_INF;
    ls[tid] = 0.f;
  }
  int kend = len;
  if (causal) kend = min(kend, q0 + nq);
  int kbeg = 0;
  if (causal && window > 0) kbeg = max(0, q0 - window + 1) / kBK * kBK;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      ks[r * ldk + d] =
          k0 + r < Skv
              ? to_f32(k[((static_cast<size_t>(b) * Skv + k0 + r) * Hkv + hk) *
                             D + d])
              : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int r = i / Dv, d = i % Dv;
      vs[i] = k0 + r < Skv
                  ? to_f32(v[((static_cast<size_t>(b) * Skv + k0 + r) * Hkv +
                              hk) * Dv + d])
                  : 0.f;
    }
    __syncthreads();
    {
      const int r = tid >> 3, c = tid & 7;  // query row r, keys c + 8t
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; ++d) {
        const float qv = qs[r * ldk + d];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          a[t] = fmaf(qv, ks[(c + 8 * t) * ldk + d], a[t]);
      }
      const int qp = q0 + r;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = c + 8 * t, kp = k0 + j;
        float s = a[t];
        if (cap > 0.f) s = cap * tanhf(s / cap);
        bool ok = r < nq && kp < len;
        if (causal) {
          ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
        }
        ps[r * kBK + j] = ok ? s : REPRO_NEG_INF;
      }
    }
    __syncthreads();
    if (tid < kBQ) {
      float* pr = ps + tid * kBK;
      const float m_prev = ms[tid];
      float m_blk = REPRO_NEG_INF;
      for (int j = 0; j < kBK; ++j) m_blk = fmaxf(m_blk, pr[j]);
      const float m_new = fmaxf(m_prev, m_blk);
      const float m_safe = m_new <= REPRO_NEG_INF / 2 ? 0.f : m_new;
      float l = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = pr[j] > REPRO_NEG_INF / 2 ? expf(pr[j] - m_safe) : 0.f;
        pr[j] = p;
        l += p;
      }
      const float corr =
          m_prev <= REPRO_NEG_INF / 2 ? 0.f : expf(m_prev - m_safe);
      ls[tid] = ls[tid] * corr + l;
      cs[tid] = corr;
      ms[tid] = m_safe;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * Dv; i += kThreads) {
      const int r = i / Dv, d = i % Dv;
      float a = os[i] * cs[r];
      for (int j = 0; j < kBK; ++j) a = fmaf(ps[r * kBK + j], vs[j * Dv + d], a);
      os[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * Dv; i += kThreads) {
    const int r = i / Dv, d = i % Dv;
    o[((static_cast<size_t>(b) * S + q0 + r) * H + h) * Dv + d] =
        from_f32<T>(os[i] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, int B, int S, int Skv, int H, int Hkv, int D, int Dv,
           int causal, int window, float scale, float cap, cudaStream_t st) {
  const size_t smem = smem_bytes(D, Dv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_prefill_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), S, Skv, H, Hkv,
      D, Dv, causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,S,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), o (B,S,H,Dv) of one
// dtype; kv_len (B,) int32.  window <= 0: no window; cap <= 0: no softcap.
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, const int* kv_len,
                                    void* o, int B, int S, int Skv, int H,
                                    int Hkv, int D, int Dv, int causal,
                                    int window, float scale, float cap,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(q, k, v, kv_len, o, B, S, Skv, H, Hkv, D, Dv, causal,
                         window, scale, cap, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, kv_len, o, B, S, Skv, H, Hkv, D, Dv,
                                 causal, window, scale, cap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
