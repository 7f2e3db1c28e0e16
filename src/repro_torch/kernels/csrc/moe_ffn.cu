// Grouped gated expert FFN for Hopper.  Replaces the Pallas TPU kernel
// repro/kernels/moe_ffn.py::moe_ffn (body _kernel).
//
// What it computes, per expert e and bucket row c (f32 accumulation):
//   gate = (x[e,c] . wi[e,:,0,:]) * si[e]     up = (x[e,c] . wi[e,:,1,:]) * si[e]
//   y    = act(gate) * up                      (silu, or tanh-approximated gelu)
//   out[e,c] = (y . wo[e]) * so[e]             cast to the input dtype
//
// Bound on the H100: at decode the bucket capacity C is a few rows, so the
// work is to stream every expert's weights once: E*D*3F*2 bytes in bf16,
// 2.8 GB for one mixtral layer, about 0.85 ms at 3.35 TB/s.  It is bound by
// bytes.  At prefill C grows to ~120 rows and the 6*E*C*D*F operations
// dominate instead.
//
// Design.  The TPU grid walks F sequentially and carries the (bc, D)
// accumulator across it in VMEM.  Hopper blocks run in parallel with no
// order, so the F reduction is split into passes:
//   1. moe_up: one thread per hidden column f, one block per (f tile,
//      C tile, expert).  Each thread streams its gate and up columns of wi
//      once (neighbouring threads read neighbouring addresses) against the
//      x rows staged in shared memory, and writes act(gate)*up to an f32
//      (E, C, F) buffer.  Unlike on the TPU, the hidden activation reaches
//      device memory: 4*E*C*F bytes, small beside the weights at decode.
//      Keeping it on chip is a later design.
//   2. moe_down: one thread per output column d, one block per (d tile,
//      C tile, expert, F split).  Each thread streams its wo column over
//      one F range and writes an f32 partial sum.  The F split gives the
//      decode shapes enough blocks to keep the memory system busy.
//   3. moe_reduce: sums the F-split partials in a fixed order (results are
//      deterministic), applies so[e] and casts.
// The products are CUDA-core f32 FMAs; tensor cores (wgmma) and TMA
// pipelines are work for a later PR.  int8 weights are refused by the
// Python wrapper.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // output columns per block, both passes
constexpr int kChunk = 128;    // reduction rows staged in shared memory

__device__ __forceinline__ float act_fn(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));  // silu = g * sigmoid(g)
  const float c = 0.7978845608028654f;        // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
}

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
    moe_up_kernel(const T* __restrict__ x, const T* __restrict__ wi,
                  const float* __restrict__ si, float* __restrict__ hid,
                  int C, int D, int F, int act) {
  __shared__ float xs[kChunk][CT + 1];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const size_t row = 2 * static_cast<size_t>(F);  // wi[e, d, :, :] stride
  const T* xe = x + (static_cast<size_t>(e) * C + c0) * D;
  // threads past the last column read column F-1 and write nothing, so
  // every thread reaches the barriers
  const T* wcol = wi + static_cast<size_t>(e) * D * row + min(f, F - 1);
  float ag[CT], au[CT];
#pragma unroll
  for (int i = 0; i < CT; ++i) {
    ag[i] = 0.f;
    au[i] = 0.f;
  }
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int dk = min(kChunk, D - d0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < CT * kChunk; idx += kThreads) {
      const int c = idx / kChunk, dd = idx % kChunk;
      xs[dd][c] = (c < nc && dd < dk)
                      ? to_f32(xe[static_cast<size_t>(c) * D + d0 + dd])
                      : 0.f;
    }
    __syncthreads();
    const T* w = wcol + static_cast<size_t>(d0) * row;
#pragma unroll 4
    for (int dd = 0; dd < dk; ++dd) {
      const float g = to_f32(w[dd * row]);
      const float u = to_f32(w[dd * row + F]);
#pragma unroll
      for (int i = 0; i < CT; ++i) {
        ag[i] = fmaf(xs[dd][i], g, ag[i]);
        au[i] = fmaf(xs[dd][i], u, au[i]);
      }
    }
  }
  if (f >= F) return;
  const float s = si ? si[e] : 1.f;
#pragma unroll
  for (int i = 0; i < CT; ++i)
    if (i < nc)
      hid[(static_cast<size_t>(e) * C + c0 + i) * F + f] =
          act_fn(ag[i] * s, act) * (au[i] * s);
}

template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
    moe_down_kernel(const float* __restrict__ hid, const T* __restrict__ wo,
                    float* __restrict__ part, int E, int C, int D, int F,
                    int fsplit) {
  __shared__ float ys[kChunk][CT + 1];
  const int e = blockIdx.z / fsplit, sp = blockIdx.z % fsplit;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int flen = (F + fsplit - 1) / fsplit;
  const int fbeg = sp * flen, fend = min(F, fbeg + flen);
  const float* he = hid + (static_cast<size_t>(e) * C + c0) * F;
  const T* wcol = wo + static_cast<size_t>(e) * F * D + min(d, D - 1);
  float acc[CT];
#pragma unroll
  for (int i = 0; i < CT; ++i) acc[i] = 0.f;
  for (int f0 = fbeg; f0 < fend; f0 += kChunk) {
    const int fk = min(kChunk, fend - f0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < CT * kChunk; idx += kThreads) {
      const int c = idx / kChunk, ff = idx % kChunk;
      ys[ff][c] = (c < nc && ff < fk)
                      ? he[static_cast<size_t>(c) * F + f0 + ff]
                      : 0.f;
    }
    __syncthreads();
    const T* w = wcol + static_cast<size_t>(f0) * D;
#pragma unroll 4
    for (int ff = 0; ff < fk; ++ff) {
      const float wv = to_f32(w[static_cast<size_t>(ff) * D]);
#pragma unroll
      for (int i = 0; i < CT; ++i) acc[i] = fmaf(ys[ff][i], wv, acc[i]);
    }
  }
  if (d >= D) return;
#pragma unroll
  for (int i = 0; i < CT; ++i)
    if (i < nc)
      part[((static_cast<size_t>(sp) * E + e) * C + c0 + i) * D + d] = acc[i];
}

template <typename T>
__global__ void moe_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ so,
                                  T* __restrict__ out, int C, int D,
                                  size_t n, int fsplit) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < fsplit; ++sp) s += part[sp * n + i];
    const int e = static_cast<int>(i / (static_cast<size_t>(C) * D));
    out[i] = from_f32<T>(s * (so ? so[e] : 1.f));
  }
}

template <typename T, int CT>
void launch(const void* x, const void* wi, const void* wo, const float* si,
            const float* so, void* out, float* hid, float* part, int E, int C,
            int D, int F, int fsplit, int act, cudaStream_t st) {
  const dim3 gu((F + kThreads - 1) / kThreads, (C + CT - 1) / CT, E);
  moe_up_kernel<T, CT><<<gu, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wi), si, hid, C, D, F,
      act);
  const dim3 gd((D + kThreads - 1) / kThreads, (C + CT - 1) / CT,
                E * fsplit);
  moe_down_kernel<T, CT><<<gd, kThreads, 0, st>>>(
      hid, static_cast<const T*>(wo), part, E, C, D, F, fsplit);
  const size_t n = static_cast<size_t>(E) * C * D;
  const int blocks = static_cast<int>(
      n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  moe_reduce_kernel<T><<<blocks, 256, 0, st>>>(
      part, so, static_cast<T*>(out), C, D, n, fsplit);
}

template <typename T>
int launch_ct(int ct, const void* x, const void* wi, const void* wo,
              const float* si, const float* so, void* out, float* hid,
              float* part, int E, int C, int D, int F, int fsplit, int act,
              cudaStream_t st) {
  switch (ct) {
    case 4:
      launch<T, 4>(x, wi, wo, si, so, out, hid, part, E, C, D, F, fsplit,
                   act, st);
      break;
    case 8:
      launch<T, 8>(x, wi, wo, si, so, out, hid, part, E, C, D, F, fsplit,
                   act, st);
      break;
    case 32:
      launch<T, 32>(x, wi, wo, si, so, out, hid, part, E, C, D, F, fsplit,
                    act, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (E,C,D), wi (E,D,2,F), wo (E,F,D) of one dtype; si/so (E,) f32 or null
// (scale 1); out (E,C,D); hid (E,C,F) f32 and part (fsplit,E,C,D) f32
// scratch.  ct: bucket rows per block (4, 8 or 32).  act: 0 silu, 1 gelu.
extern "C" int moe_ffn_launch(int dtype, const void* x, const void* wi,
                              const void* wo, const float* si,
                              const float* so, void* out, float* hid,
                              float* part, int E, int C, int D, int F,
                              int ct, int fsplit, int act, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_ct<float>(ct, x, wi, wo, si, so, out, hid, part, E, C, D,
                            F, fsplit, act, st);
  if (dtype == DT_BF16)
    return launch_ct<__nv_bfloat16>(ct, x, wi, wo, si, so, out, hid, part, E,
                                    C, D, F, fsplit, act, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
