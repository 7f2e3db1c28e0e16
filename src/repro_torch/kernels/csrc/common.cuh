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
// o (B*H, Dv), m/l (B*H); any nsplit.  The chunks' weights exp(m_s - M)
// go to shared memory kSeg chunks at a time; each thread then issues the
// po loads of four chunks together (none for an empty chunk) before it
// adds them, in chunk order.
constexpr int kSeg = 256;

__device__ __forceinline__ void combine_partials_row(
    const float* __restrict__ po, const float* __restrict__ pm,
    const float* __restrict__ pl, float* __restrict__ o,
    float* __restrict__ m, float* __restrict__ l, int nsplit, int Dv) {
  __shared__ float ws[kSeg];  // a chunk's weight; 0 when it is empty
  __shared__ float big_m;
  const size_t r = blockIdx.x;  // b * H + h
  const float* pmr = pm + r * nsplit;
  if (threadIdx.x < 32) {
    float M = REPRO_NEG_INF;
    for (int s = threadIdx.x; s < nsplit; s += 32) M = fmaxf(M, pmr[s]);
    M = warp_max(M);
    if (threadIdx.x == 0) big_m = M;
  }
  __syncthreads();
  const float M = big_m;
  const bool none = M <= REPRO_NEG_INF / 2;
  // a pass takes 4 * blockDim.x columns, four adjacent ones a thread (one
  // 16-byte load a chunk when Dv % 4 == 0); every thread takes every pass,
  // since the passes meet at barriers
  const bool vec = Dv % 4 == 0;
  for (int base = 0; base < Dv; base += 4 * blockDim.x) {
    const int d0 = base + 4 * threadIdx.x;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nsplit; s0 += kSeg) {
      const int ns = min(kSeg, nsplit - s0);
      __syncthreads();  // the previous segment's weights are read
      for (int j = threadIdx.x; j < ns; j += blockDim.x) {
        const float ms = pmr[s0 + j];
        ws[j] = ms > REPRO_NEG_INF / 2 ? expf(ms - M) : 0.f;
      }
      __syncthreads();
      for (int j0 = 0; j0 < ns; j0 += 4) {
        float x[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool busy = j0 + j < ns && ws[j0 + j] > 0.f;
          const float* src = po + (r * nsplit + s0 + j0 + j) * Dv + d0;
          if (vec && busy && d0 < Dv) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            x[j][0] = v.x; x[j][1] = v.y; x[j][2] = v.z; x[j][3] = v.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              x[j][c] = busy && d0 + c < Dv ? src[c] : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w = j0 + j < ns ? ws[j0 + j] : 0.f;
          if (w > 0.f) {
#pragma unroll
            for (int c = 0; c < 4; ++c) a[c] += w * x[j][c];
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (d0 + c < Dv) o[r * Dv + d0 + c] = a[c];
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
