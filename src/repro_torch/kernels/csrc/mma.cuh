// Tensor-core building blocks of the port's bf16 kernel bodies (sm_90a):
// 16-byte cp.async staging into shared memory, ldmatrix fragment loads and
// the warp-level mma.sync m16n8k16 bf16 -> f32 product.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 * g + t, with
// g = lane / 4 and t = lane % 4):
//   A (16 x 16, row-major): a0 = (row g,   cols 2t, 2t+1)
//                           a1 = (row g+8, cols 2t, 2t+1)
//                           a2 = (row g,   cols 2t+8, 2t+9)
//                           a3 = (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8, k by n):     b0 = (k 2t, 2t+1;   n g)
//                           b1 = (k 2t+8, 2t+9; n g)
//   C (16 x 8, f32):        c0, c1 = (row g, cols 2t, 2t+1)
//                           c2, c3 = (row g+8, cols 2t, 2t+1)
// Each 32-bit register holds two bf16 values, the lower index in the low
// half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously, bypassing L1
// and prefetching the 128-byte line into L2; with `full` false nothing is
// read and the 16 bytes are zero-filled.  `src` must be 16-byte aligned
// and valid either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(full ? 16 : 0)
      : "memory");
}

// An L2 policy under which the lines a copy brings in are the first to be
// evicted: for data read once, so that streaming it does not push out
// lines that are used again or dirty.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// cp_async16 under an L2 policy (l2_evict_first).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full, uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint.L2::128B [%0], [%1], 16, %2, "
      "%3;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(full ? 16 : 0), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row (l % 8) of
// matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 b16 matrices; lanes 0-15 give the addresses (the others' are
// read but unused).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 values as the bf16x2 pair hi = bf16(x) and lo = bf16(x - hi):
// an A operand split in two so that hi . b + lo . b keeps about 16 bits
// of each x (|x - hi - lo| <= 2^-18 |x|) instead of bf16's 8.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// Eight int8 values (one 8-byte word) as eight bf16 values (one 16-byte
// word), lower index first.  Every int8 value is exact in bf16, so a
// bf16 product of them on the tensor cores is the int8 product's.
__device__ __forceinline__ uint4 i8x8_to_bf16x8(uint2 r) {
  const signed char* e = reinterpret_cast<const signed char*>(&r);
  uint4 o;
  o.x = pack_bf16(static_cast<float>(e[0]), static_cast<float>(e[1]));
  o.y = pack_bf16(static_cast<float>(e[2]), static_cast<float>(e[3]));
  o.z = pack_bf16(static_cast<float>(e[4]), static_cast<float>(e[5]));
  o.w = pack_bf16(static_cast<float>(e[6]), static_cast<float>(e[7]));
  return o;
}
