// The backward of flash attention for prefill (csrc/flash_prefill.cu) on
// Hopper: the gradients of q, k and v of the forward's full contract
// (causal or not, window, softcap, kv_len, any H / Hkv, D != Dv), for the
// training path.  The JAX package trains through plain XLA attention,
// differentiated by jax.value_and_grad, so no Pallas kernel stands behind
// this one: it is the port's own, as expert_gather.cu is.
//
// What it computes, for one (batch, query head h) with KV head
// hk = h / (H / Hkv), raw scores x = scale * q . k, capped scores
// s = softcap(x) (x itself without a cap), masked as the forward masks
// them, and the forward's log-sum-exp per query row (lse = m + log l,
// written by flash_prefill_launch when it is given an lse buffer):
//   P  = exp(s - lse)                      (0 where masked)
//   D_i = rowsum(dO_i * O_i)               (the pre-pass, f32)
//   dP = dO . V^T,  dS = P * (dP - D) * (1 - (s / cap)^2 with a cap)
//   dQ = scale * dS . K,  dK = scale * dS^T . Q,  dV = P^T . dO
// dK and dV sum over the G = H / Hkv query heads of the KV head.
//
// Three kernels, on CUDA cores with f32 staging and f32 accumulation for
// both input types (f32 and bf16); each gradient leaves in the input type.
//  * delta: one warp per (batch, position, head) row.
//  * dQ: one block per (16-query tile, batch * head).  It stages the tile's
//    q and dO once, then walks 32-key tiles of K and V (only those the
//    causal / window range reaches), recomputing P from the saved lse; the
//    (16, D) accumulator stays in shared memory.
//  * dK / dV: one block per (32-key tile, batch * KV head).  It stages its
//    K and V tile once, then loops over the G query heads and over their
//    16-query tiles that can see the keys, accumulating the (32, D) and
//    (32, Dv) sums in shared memory.  No block shares an output row with
//    another, so there are no atomics and the result is deterministic.
// Bound on the H100: operations, five products of the forward's two
// shapes (S, dP, dQ, dK, dV), about 2.5 x the forward's.  This first
// design runs them on CUDA cores: staged tiles, not mma.sync or wgmma.
//
// Shared memory: (32 + 16) * (D + 1 + Dv + 1) + 32 * (D + Dv) + 2 * 16 * 32
// floats for the dK / dV block, the larger of the two; D = Dv = 256 takes
// 168 KB of the 227 KB a block may hold.  The launch refuses a shape past
// that with kErrSmem, which the wrapper raises as a ValueError.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per tile
constexpr int kBK = 32;  // keys per tile
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kErrSmem = -1;  // no CUDA error code is negative

size_t smem_dq(int D, int Dv) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * (D + 1) +
          static_cast<size_t>(kBQ + kBK) * (Dv + 1) + kBQ * kBK +
          static_cast<size_t>(kBQ) * D + 2 * kBQ);
}

size_t smem_dkv(int D, int Dv) {
  return sizeof(float) *
         (static_cast<size_t>(kBK + kBQ) * (D + 1) +
          static_cast<size_t>(kBK + kBQ) * (Dv + 1) +
          static_cast<size_t>(kBK) * (D + Dv) + 2 * kBQ * kBK + 2 * kBQ);
}

__device__ __forceinline__ bool key_ok(int qp, int kp, int len, int causal,
                                       int window) {
  bool ok = kp < len;
  if (causal) {
    ok = ok && kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
  }
  return ok;
}

// stage `rows` rows of `width` elements (row r at src + r * str) into
// shared dst (row stride ld) as f32; rows from nvalid on are zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      size_t str, int rows, int nvalid,
                                      int width) {
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width, d = i % width;
    dst[r * ld + d] = r < nvalid ? to_f32(src[r * str + d]) : 0.f;
  }
}

template <typename T>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, int rows, int S,
                             int H, int Dv) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // row = (b * S + s) * H + h
  const T* orow = o + static_cast<size_t>(row) * Dv;
  const T* drow = dout + static_cast<size_t>(row) * Dv;
  float a = 0.f;
  for (int d = lane; d < Dv; d += 32) a += to_f32(orow[d]) * to_f32(drow[d]);
  a = warp_sum(a);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    delta[(static_cast<size_t>(b) * H + h) * S + s] = a;
  }
}

// The masked P and dS of one score: x = scale * q.k, y = dO.v.
__device__ __forceinline__ void p_ds(float x, float y, float lse, float dl,
                                     bool ok, float cap, float& p,
                                     float& ds) {
  float s = x;
  if (cap > 0.f) s = cap * tanhf(x / cap);
  p = ok ? expf(s - lse) : 0.f;
  ds = p * (y - dl);
  if (cap > 0.f) {
    const float t = s / cap;
    ds *= 1.f - t * t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ kv_len, T* __restrict__ dq, int S,
              int Skv, int H, int Hkv, int D, int Dv, int causal, int window,
              float scale, float cap) {
  extern __shared__ float sm[];
  const int ldq = D + 1, ldv = Dv + 1;
  float* qs = sm;                  // [kBQ][ldq]
  float* dos = qs + kBQ * ldq;     // [kBQ][ldv]
  float* ks = dos + kBQ * ldv;     // [kBK][ldq]
  float* vs = ks + kBK * ldq;      // [kBK][ldv]
  float* dss = vs + kBK * ldv;     // [kBQ][kBK]
  float* acc = dss + kBQ * kBK;    // [kBQ][D]
  float* lse_s = acc + kBQ * D;    // [kBQ]
  float* dl_s = lse_s + kBQ;       // [kBQ]
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, S - q0);
  const int len = min(kv_len[b], Skv);
  const size_t qstr = static_cast<size_t>(H) * D;
  const size_t ostr = static_cast<size_t>(H) * Dv;
  const size_t kstr = static_cast<size_t>(Hkv) * D;
  const size_t vstr = static_cast<size_t>(Hkv) * Dv;
  const T* qb = q + (static_cast<size_t>(b) * S * H + h) * D;
  const T* db = dout + (static_cast<size_t>(b) * S * H + h) * Dv;
  const T* kb = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Skv * Hkv + hk) * Dv;

  stage(qs, ldq, qb + q0 * qstr, qstr, kBQ, nq, D);
  stage(dos, ldv, db + q0 * ostr, ostr, kBQ, nq, Dv);
  for (int i = tid; i < kBQ * D; i += kThreads) acc[i] = 0.f;
  if (tid < kBQ) {
    const size_t row = (static_cast<size_t>(b) * H + h) * S + q0 + tid;
    lse_s[tid] = tid < nq ? lse[row] : 0.f;
    dl_s[tid] = tid < nq ? delta[row] : 0.f;
  }
  int kend = len;
  if (causal) kend = min(kend, q0 + nq);
  int kbeg = 0;
  if (causal && window > 0) kbeg = max(0, q0 - window + 1) / kBK * kBK;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();
    stage(ks, ldq, kb + k0 * kstr, kstr, kBK, Skv - k0, D);
    stage(vs, ldv, vb + k0 * vstr, vstr, kBK, Skv - k0, Dv);
    __syncthreads();
    {
      const int r = tid >> 3, c = tid & 7;  // query row r, keys c + 8t
      float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; ++d) {
        const float qv = qs[r * ldq + d];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          x[t] = fmaf(qv, ks[(c + 8 * t) * ldq + d], x[t]);
      }
      for (int d = 0; d < Dv; ++d) {
        const float gv = dos[r * ldv + d];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          y[t] = fmaf(gv, vs[(c + 8 * t) * ldv + d], y[t]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = c + 8 * t;
        const bool ok = r < nq && key_ok(q0 + r, k0 + j, len, causal, window);
        float p, ds;
        p_ds(x[t] * scale, y[t], lse_s[r], dl_s[r], ok, cap, p, ds);
        dss[r * kBK + j] = ds;
      }
    }
    __syncthreads();
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float a = acc[i];
#pragma unroll 8
      for (int j = 0; j < kBK; ++j)
        a = fmaf(dss[r * kBK + j], ks[j * ldq + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  T* qo = dq + (static_cast<size_t>(b) * S * H + h) * D;
  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qo[(q0 + r) * qstr + d] = from_f32<T>(acc[i] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ kv_len, T* __restrict__ dk,
               T* __restrict__ dv, int S, int Skv, int H, int Hkv, int D,
               int Dv, int causal, int window, float scale, float cap) {
  extern __shared__ float sm[];
  const int ldq = D + 1, ldv = Dv + 1;
  float* ks = sm;                  // [kBK][ldq]
  float* vs = ks + kBK * ldq;      // [kBK][ldv]
  float* qs = vs + kBK * ldv;      // [kBQ][ldq]
  float* dos = qs + kBQ * ldq;     // [kBQ][ldv]
  float* ps = dos + kBQ * ldv;     // [kBQ][kBK]
  float* dss = ps + kBQ * kBK;     // [kBQ][kBK]
  float* dka = dss + kBQ * kBK;    // [kBK][D]
  float* dva = dka + kBK * D;      // [kBK][Dv]
  float* lse_s = dva + kBK * Dv;   // [kBQ]
  float* dl_s = lse_s + kBQ;       // [kBQ]
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.x * kBK;
  const int nk = min(kBK, Skv - k0);
  const int len = min(kv_len[b], Skv);
  const size_t qstr = static_cast<size_t>(H) * D;
  const size_t ostr = static_cast<size_t>(H) * Dv;
  const size_t kstr = static_cast<size_t>(Hkv) * D;
  const size_t vstr = static_cast<size_t>(Hkv) * Dv;
  const T* kb = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Skv * Hkv + hk) * Dv;

  for (int i = tid; i < kBK * D; i += kThreads) dka[i] = 0.f;
  for (int i = tid; i < kBK * Dv; i += kThreads) dva[i] = 0.f;
  // the queries that can see a key of this tile
  int qbeg = 0, qend = S;
  if (causal) {
    qbeg = k0 / kBQ * kBQ;
    if (window > 0) qend = min(S, k0 + kBK - 1 + window);
  }
  if (k0 < len) {
    stage(ks, ldq, kb + k0 * kstr, kstr, kBK, nk, D);
    stage(vs, ldv, vb + k0 * vstr, vstr, kBK, nk, Dv);
  } else {
    qend = qbeg;  // no valid key: the gradients are 0
  }
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = q + (static_cast<size_t>(b) * S * H + h) * D;
    const T* db = dout + (static_cast<size_t>(b) * S * H + h) * Dv;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* dl_h = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = qbeg; q0 < qend; q0 += kBQ) {
      const int nq = min(kBQ, S - q0);
      __syncthreads();
      stage(qs, ldq, qb + q0 * qstr, qstr, kBQ, nq, D);
      stage(dos, ldv, db + q0 * ostr, ostr, kBQ, nq, Dv);
      if (tid < kBQ) {
        lse_s[tid] = tid < nq ? lse_h[q0 + tid] : 0.f;
        dl_s[tid] = tid < nq ? dl_h[q0 + tid] : 0.f;
      }
      __syncthreads();
      {
        const int j = tid >> 2, c = tid & 3;  // key j, query rows c + 4t
        float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < D; ++d) {
          const float kv = ks[j * ldq + d];
#pragma unroll
          for (int t = 0; t < 4; ++t)
            x[t] = fmaf(kv, qs[(c + 4 * t) * ldq + d], x[t]);
        }
        for (int d = 0; d < Dv; ++d) {
          const float vv = vs[j * ldv + d];
#pragma unroll
          for (int t = 0; t < 4; ++t)
            y[t] = fmaf(vv, dos[(c + 4 * t) * ldv + d], y[t]);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = c + 4 * t;
          const bool ok =
              i < nq && key_ok(q0 + i, k0 + j, len, causal, window);
          float p, ds;
          p_ds(x[t] * scale, y[t], lse_s[i], dl_s[i], ok, cap, p, ds);
          ps[i * kBK + j] = p;
          dss[i * kBK + j] = ds;
        }
      }
      __syncthreads();
      for (int e = tid; e < kBK * Dv; e += kThreads) {
        const int j = e / Dv, d = e % Dv;
        float a = dva[e];
#pragma unroll 8
        for (int i = 0; i < kBQ; ++i)
          a = fmaf(ps[i * kBK + j], dos[i * ldv + d], a);
        dva[e] = a;
      }
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int j = e / D, d = e % D;
        float a = dka[e];
#pragma unroll 8
        for (int i = 0; i < kBQ; ++i)
          a = fmaf(dss[i * kBK + j], qs[i * ldq + d], a);
        dka[e] = a;
      }
    }
  }
  __syncthreads();
  T* ko = dk + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  T* vo = dv + (static_cast<size_t>(b) * Skv * Hkv + hk) * Dv;
  for (int e = tid; e < nk * D; e += kThreads)
    ko[(k0 + e / D) * kstr + e % D] = from_f32<T>(dka[e] * scale);
  for (int e = tid; e < nk * Dv; e += kThreads)
    vo[(k0 + e / Dv) * vstr + e % Dv] = from_f32<T>(dva[e]);
}

template <typename Kern>
int allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, const int* kv_len,
           float* delta, void* dq, void* dk, void* dv, int B, int S, int Skv,
           int H, int Hkv, int D, int Dv, int causal, int window, float scale,
           float cap, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const int rows = B * S * H;
  delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                    st>>>(static_cast<const T*>(o), dt, delta, rows, S, H,
                          Dv);
  const size_t sq = smem_dq(D, Dv), skv = smem_dkv(D, Dv);
  int err = allow_smem(dq_kernel<T>, sq);
  if (err) return err;
  err = allow_smem(dkv_kernel<T>, skv);
  if (err) return err;
  dq_kernel<T><<<dim3((S + kBQ - 1) / kBQ, B * H), kThreads, sq, st>>>(
      qt, kt, vt, dt, lse, delta, kv_len, static_cast<T*>(dq), S, Skv, H, Hkv,
      D, Dv, causal, window, scale, cap);
  dkv_kernel<T><<<dim3((Skv + kBK - 1) / kBK, B * Hkv), kThreads, skv, st>>>(
      qt, kt, vt, dt, lse, delta, kv_len, static_cast<T*>(dk),
      static_cast<T*>(dv), S, Skv, H, Hkv, D, Dv, causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,S,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), o and dout (B,S,H,Dv),
// dq / dk / dv shaped as q / k / v, all of one dtype; lse (B,H,S) f32 from
// the forward; kv_len (B,) int32; delta a (B,H,S) f32 workspace.
// window <= 0: no window; cap <= 0: no softcap.  Returns kErrSmem, having
// launched nothing, where either tile kernel needs more than kMaxSmem.
extern "C" int flash_prefill_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, const int* kv_len, float* delta,
    void* dq, void* dk, void* dv, int B, int S, int Skv, int H, int Hkv,
    int D, int Dv, int causal, int window, float scale, float cap,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem_dq(D, Dv) > kMaxSmem || smem_dkv(D, Dv) > kMaxSmem)
    return kErrSmem;
  if (H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return launch<float>(q, k, v, o, dout, lse, kv_len, delta, dq, dk, dv, B,
                         S, Skv, H, Hkv, D, Dv, causal, window, scale, cap,
                         st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, dout, lse, kv_len, delta, dq, dk,
                                 dv, B, S, Skv, H, Hkv, D, Dv, causal, window,
                                 scale, cap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
