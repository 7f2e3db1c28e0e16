// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own by nvcc (sm_90a) into a shared
// object with a plain C interface and loaded with ctypes
// (repro_torch/kernels/build.py).  Launch functions take raw device
// pointers and the caller's CUDA stream, allocate nothing, never
// synchronise, and return cudaGetLastError() right after their launches;
// expert_gather alone keeps a page-locked plan and waits for it.
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
// int8 storage (int8 KV, int8 expert weights): the value itself, exact
__device__ __forceinline__ float to_f32(signed char x) {
  return static_cast<float>(x);
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

// Merge the partials of one (row, head) over `nsplit` chunks under the
// reference's rule (repro/models/attention.py): a chunk with no valid slot
// carries the sentinel max and adds nothing, and a row with none at all
// yields (0, 0, 0).  Called by a combine kernel of kCombineThreads threads
// with one block per (row, head): po (B*H, nsplit, Dv), pm/pl (B*H,
// nsplit) -> o (B*H, Dv), m/l (B*H); any nsplit and Dv.  Two dependent
// trips to memory where nsplit <= kSeg and Dv <= 4 * kCombineThreads:
// every thread loads its chunks' (m, l) into shared memory while the
// row's max is taken, and then the po rows of kBatch chunks at once.  A
// thread takes four adjacent columns; where a row has fewer than
// 4 * kCombineThreads columns the threads split into groups that take
// every ng-th chunk, summed group by group after, so the sum runs in a
// fixed order.
constexpr int kCombineThreads = 128;
constexpr int kSeg = 256;   // chunks weighed per pass
constexpr int kBatch = 8;   // po loads a thread issues together

__device__ __forceinline__ void combine_partials_row(
    const float* __restrict__ po, const float* __restrict__ pm,
    const float* __restrict__ pl, float* __restrict__ o,
    float* __restrict__ m, float* __restrict__ l, int nsplit, int Dv) {
  constexpr int T = kCombineThreads, NW = T / 32;
  __shared__ float ms_s[kSeg];  // a chunk's max, then its weight
  __shared__ float ls_s[kSeg];  // a chunk's l
  __shared__ float red[NW];
  __shared__ float4 gsum[T];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t r = blockIdx.x;  // b * H + h
  const float* pmr = pm + r * nsplit;
  const float* plr = pl + r * nsplit;
  float M = REPRO_NEG_INF;
  for (int s = tid; s < nsplit; s += T) {
    const float x = pmr[s];
    M = fmaxf(M, x);
    if (s < kSeg) {
      ms_s[s] = x;
      ls_s[s] = plr[s];
    }
  }
  M = warp_max(M);
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) M = fmaxf(M, red[w]);
  const int q4 = (Dv + 3) / 4;                   // column quads of a row
  int gw = 32;                                   // threads of a group
  while (gw < T && gw < q4) gw *= 2;
  const int ng = T / gw;                         // groups
  const int grp = tid / gw, gt = tid % gw;
  const bool vec = Dv % 4 == 0;
  float lsum = 0.f;  // thread 0: the row's l, in chunk order
  for (int base = 0; base < q4; base += gw) {
    const int cq = base + gt, d0 = 4 * cq;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nsplit; s0 += kSeg) {
      const int ns = min(kSeg, nsplit - s0);
      if (base > 0 || s0 > 0) {  // the first was staged with the max
        __syncthreads();           // the previous weights are read
        for (int j = tid; j < ns; j += T) {
          ms_s[j] = pmr[s0 + j];
          ls_s[j] = plr[s0 + j];
        }
      }
      __syncthreads();
      for (int j = tid; j < ns; j += T) {
        const float x = ms_s[j];
        ms_s[j] = x > REPRO_NEG_INF / 2 ? expf(x - M) : 0.f;
      }
      __syncthreads();
      if (base == 0 && tid == 0)
        for (int j = 0; j < ns; ++j)
          if (ms_s[j] > 0.f) lsum += ms_s[j] * ls_s[j];
      for (int j0 = grp; j0 < ns; j0 += ng * kBatch) {
        float x[kBatch][4];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int j = j0 + k * ng;
          const bool busy = j < ns && ms_s[j] > 0.f && d0 < Dv;
          const float* src = po + (r * nsplit + s0 + j) * Dv + d0;
          if (vec && busy) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            x[k][0] = v.x; x[k][1] = v.y; x[k][2] = v.z; x[k][3] = v.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              x[k][c] = busy && d0 + c < Dv ? src[c] : 0.f;
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int j = j0 + k * ng;
          const float w = j < ns ? ms_s[j] : 0.f;
          if (w > 0.f) {
#pragma unroll
            for (int c = 0; c < 4; ++c) a[c] += w * x[k][c];
          }
        }
      }
    }
    if (ng > 1) {  // the groups' sums, added in group order
      gsum[tid] = make_float4(a[0], a[1], a[2], a[3]);
      __syncthreads();
      if (grp == 0)
        for (int g = 1; g < ng; ++g) {
          const float4 v = gsum[g * gw + gt];
          a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
        }
    }
    if (grp == 0)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d0 + c < Dv) o[r * Dv + d0 + c] = a[c];
  }
  if (tid == 0) {
    m[r] = M <= REPRO_NEG_INF / 2 ? 0.f : M;
    l[r] = lsum;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
