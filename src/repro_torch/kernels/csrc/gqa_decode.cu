// Flash-decode GQA over a dense KV ring for Hopper.  Replaces the Pallas
// TPU kernel repro/kernels/gqa_decode.py::gqa_decode (body _kernel).
//
// What it computes: for each row b and query head h, the partials of one
// decode step of attention against k/v (B,W,Hkv,D) under a validity mask
// (B,W):  s_w = softcap(scale * q . k_w) on valid slots,
//   m = max_w s_w (0 for a row with no valid slot),
//   l = sum_w exp(s_w - m),  o_unnorm = sum_w exp(s_w - m) v_w,
// all in f32, the (o_unnorm, m, l) contract of models.attention.
//
// Bound on the H100: the K and V bytes of the valid slots, each read once:
// nvalid*Hkv*(D+Dv)*2 in bf16 (at most 16.8 MB for 8 full rows of a
// 512-slot mixtral ring, about 5 us at 3.35 TB/s), plus q, the mask and
// the f32 outputs.  The 2*nvalid*H*(D+Dv) operations are far below the
// card's rate, so it is bound by bytes.
//
// Design.  The TPU grid walks W sequentially with the running triple in
// VMEM.  Here W is cut into chunks of `wchunk` slots and each block takes
// one (chunk, kv head, row), so that a batch of 8 rows still fills the
// SMs; the G = H/Hkv query heads of the group share every K/V row the
// block reads.  A block first compacts its chunk's valid slots into a list
// (one warp, ballots), so no K or V row of an invalid slot is loaded and
// the loops below carry no data-dependent branch.  It then computes the
// scores of the listed slots (one warp per slot, lanes across D), the
// chunk's max, exponentials and sum (one warp per query head), and the
// weighted V sum (one thread per column for all G heads, so each V element
// is loaded once, neighbouring threads on neighbouring addresses).
// A second launch merges the chunks' partials under the reference's rule
// (repro/models/attention.py: m_safe = 0 when nothing is valid, p = 0 on
// invalid slots).  int8 K/V are refused by the Python wrapper.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;  // query heads per pass of the V sum

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gqa_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const unsigned char* __restrict__ valid,
                     float* __restrict__ po, float* __restrict__ pm,
                     float* __restrict__ pl, int H, int Hkv, int W, int D,
                     int Dv, int wchunk, float scale, float cap) {
  extern __shared__ float sm[];
  __shared__ int nv_s;
  const int G = H / Hkv;
  float* qs = sm;           // [G][D], pre-scaled queries of the group
  float* ps = sm + G * D;   // [G][wchunk], scores, then probabilities
  int* idx = reinterpret_cast<int*>(ps + G * wchunk);  // [wchunk] valid slots
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int w0 = sp * wchunk;
  const int nw = min(wchunk, W - w0);

  if (warp == 0) {  // compact the valid slots of the chunk, in order
    int n = 0;
    for (int j0 = 0; j0 < nw; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < nw && valid[static_cast<size_t>(b) * W + w0 + j];
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) idx[n + __popc(bal & ((1u << lane) - 1u))] = j;
      n += __popc(bal);
    }
    if (lane == 0) nv_s = n;
  }
  const size_t qbase = (static_cast<size_t>(b) * H + hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = to_f32(q[qbase + i]) * scale;
  __syncthreads();
  const int nv = nv_s;

  for (int jj = warp; jj < nv; jj += kWarps) {
    const size_t kr =
        ((static_cast<size_t>(b) * W + w0 + idx[jj]) * Hkv + hk) * D;
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32)
        a = fmaf(qs[g * D + d], to_f32(k[kr + d]), a);
      a = warp_sum(a);
      if (cap > 0.f) a = cap * tanhf(a / cap);
      if (lane == 0) ps[g * wchunk + jj] = a;
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += kWarps) {
    float m = REPRO_NEG_INF;
    for (int jj = lane; jj < nv; jj += 32) m = fmaxf(m, ps[g * wchunk + jj]);
    m = warp_max(m);
    const float m_safe = m <= REPRO_NEG_INF / 2 ? 0.f : m;
    float l = 0.f;
    for (int jj = lane; jj < nv; jj += 32) {
      const float p = expf(ps[g * wchunk + jj] - m_safe);
      ps[g * wchunk + jj] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t r = (static_cast<size_t>(b) * H + hk * G + g) * nsplit + sp;
      pm[r] = m;  // the chunk's true max; the sentinel when nothing is valid
      pl[r] = l;
    }
  }
  __syncthreads();

  for (int d = tid; d < Dv; d += kThreads) {
    for (int g0 = 0; g0 < G; g0 += kMaxG) {
      float acc[kMaxG];
#pragma unroll
      for (int t = 0; t < kMaxG; ++t) acc[t] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < nv; ++jj) {
        const float x = to_f32(
            v[((static_cast<size_t>(b) * W + w0 + idx[jj]) * Hkv + hk) * Dv +
              d]);
#pragma unroll
        for (int t = 0; t < kMaxG; ++t)
          if (g0 + t < G) acc[t] = fmaf(ps[(g0 + t) * wchunk + jj], x, acc[t]);
      }
#pragma unroll
      for (int t = 0; t < kMaxG; ++t)
        if (g0 + t < G)
          po[((static_cast<size_t>(b) * H + hk * G + g0 + t) * nsplit + sp) *
                 Dv + d] = acc[t];
    }
  }
}

__global__ void gqa_combine_kernel(const float* __restrict__ po,
                                   const float* __restrict__ pm,
                                   const float* __restrict__ pl,
                                   float* __restrict__ o,
                                   float* __restrict__ m,
                                   float* __restrict__ l, int nsplit,
                                   int Dv) {
  combine_partials_row(po, pm, pl, o, m, l, nsplit, Dv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* valid, float* po, float* pm, float* pl,
           float* o, float* m, float* l, int B, int H, int Hkv, int W, int D,
           int Dv, int wchunk, float scale, float cap, cudaStream_t st) {
  const int nsplit = (W + wchunk - 1) / wchunk;
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * static_cast<size_t>(G) * (D + wchunk) +
                      sizeof(int) * static_cast<size_t>(wchunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gqa_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(nsplit, Hkv, B);
  gqa_chunk_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, po, pm, pl, H, Hkv, W, D, Dv, wchunk,
      scale, cap);
  gqa_combine_kernel<<<B * H, 128, 0, st>>>(po, pm, pl, o, m, l, nsplit, Dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,H,D), k (B,W,Hkv,D), v (B,W,Hkv,Dv) of one dtype; valid (B,W) bool;
// po (B,H,nsplit,Dv), pm/pl (B,H,nsplit) f32 scratch with
// nsplit = ceil(W / wchunk); o (B,H,Dv), m/l (B,H) f32 outputs.
// cap <= 0 disables the softcap.
extern "C" int gqa_decode_launch(int dtype, const void* q, const void* k,
                                 const void* v, const void* valid, float* po,
                                 float* pm, float* pl, float* o, float* m,
                                 float* l, int B, int H, int Hkv, int W,
                                 int D, int Dv, int wchunk, float scale,
                                 float cap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* vm = static_cast<const unsigned char*>(valid);
  if (dtype == DT_F32)
    return launch<float>(q, k, v, vm, po, pm, pl, o, m, l, B, H, Hkv, W, D,
                         Dv, wchunk, scale, cap, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, vm, po, pm, pl, o, m, l, B, H, Hkv,
                                 W, D, Dv, wchunk, scale, cap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
