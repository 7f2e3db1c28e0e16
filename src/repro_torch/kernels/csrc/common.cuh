// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own by nvcc (sm_90a) into a shared
// object with a plain C interface and loaded with ctypes
// (repro_torch/kernels/build.py).  Launch functions take raw device
// pointers and the caller's CUDA stream, allocate nothing, never
// synchronise, and return cudaGetLastError() right after their launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Dtype codes shared with the Python wrappers (build.DTYPE_CODES).
enum : int { DT_F32 = 0, DT_BF16 = 1 };

// The reference's masking sentinel: -0.7 * FLT_MAX, far below any real
// score yet safe to subtract from without overflowing to -inf.
#define REPRO_NEG_INF (-0.7f * 3.40282346638528859811704183484516925e+38f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Merge the partials of one (row, head) over `nsplit` chunks, in chunk
// order, under the reference's rule (repro/models/attention.py): a chunk
// with no valid slot carries the sentinel max and adds nothing, and a row
// with none at all yields (0, 0, 0).  Called by a combine kernel with one
// block per (row, head): po (B*H, nsplit, Dv), pm/pl (B*H, nsplit) ->
// o (B*H, Dv), m/l (B*H).
__device__ __forceinline__ void combine_partials_row(
    const float* __restrict__ po, const float* __restrict__ pm,
    const float* __restrict__ pl, float* __restrict__ o,
    float* __restrict__ m, float* __restrict__ l, int nsplit, int Dv) {
  const size_t r = blockIdx.x;  // b * H + h
  const float* pmr = pm + r * nsplit;
  float M = REPRO_NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pmr[s]);
  const bool none = M <= REPRO_NEG_INF / 2;
  for (int d = threadIdx.x; d < Dv; d += blockDim.x) {
    float a = 0.f;
    if (!none)
      for (int s = 0; s < nsplit; ++s)
        if (pmr[s] > REPRO_NEG_INF / 2)
          a += expf(pmr[s] - M) * po[(r * nsplit + s) * Dv + d];
    o[r * Dv + d] = a;
  }
  if (threadIdx.x == 0) {
    float ls = 0.f;
    if (!none)
      for (int s = 0; s < nsplit; ++s)
        if (pmr[s] > REPRO_NEG_INF / 2)
          ls += expf(pmr[s] - M) * pl[r * nsplit + s];
    m[r] = none ? 0.f : M;
    l[r] = ls;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
