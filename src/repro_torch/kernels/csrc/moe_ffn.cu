// Grouped gated expert FFN for Hopper.  Replaces the Pallas TPU kernel
// repro/kernels/moe_ffn.py::moe_ffn (body _kernel).
//
// What it computes, per expert e and bucket row c (f32 accumulation):
//   gate = (x[e,c] . wi[e,:,0,:]) * si[e]     up = (x[e,c] . wi[e,:,1,:]) * si[e]
//   y    = act(gate) * up                      (silu, or tanh-approximated gelu)
//   out[e,c] = (y . wo[e]) * so[e]             cast to the input dtype
//
// Bound on the H100: at decode the bucket capacity C is a few rows, so the
// work is to stream the weights of every expert that holds a token once:
// D*3F*2 bytes each in bf16 (88 MB for one DeepSeek-V3 expert, 2.8 GB for
// all 8 of a mixtral layer, about 0.85 ms at 3.35 TB/s).  It is bound by
// bytes.  At prefill C grows to ~120 rows and the 6*E*C*D*F operations
// approach the bytes' time on the tensor cores (0.34 ms against 0.85 ms
// at mixtral's C 120).
//
// The TPU grid walks every expert and F sequentially and carries the
// (bc, D) accumulator across F in VMEM.  Hopper blocks run in parallel
// with no order, so the F reduction is split into two passes.  Two bodies,
// chosen by dtype:
//
// bf16 (the served type): tensor cores, with empty buckets skipped.
//   0. moe_flags: one warp per (expert, bucket row) writes whether any x
//      value of the row is nonzero.  No bias and act(0) = 0 for silu and
//      gelu, so the outputs of a row tile whose rows are all zero are
//      exactly 0: the passes below write those zeros and read no weight.
//      A tile that is partly empty computes the whole tile.  Nothing is
//      read back to the host and every shape stays fixed.
//   1. moe_up_tc: hidden (E,C,F) = act(x.wi_gate * si) * (x.wi_up * si),
//      stored in bf16 (as the torch.bmm chain keeps it).
//   2. moe_down_tc: out = (hidden.wo) * so, with the whole F reduction in
//      one block, in a fixed order (deterministic, no split, no atomics).
//   Both products are swapped so that the weights fill the M = 16 side of
//   mma.sync m16n8k16 (bf16 in, f32 accumulate) and the bucket rows fill
//   N (a tile of 8 rows at decode, up to 128 at prefill).  A block owns a
//   tile of weight columns -- in the up pass half gate, half up, for the
//   same hidden columns -- and streams it, with the matching x / hidden
//   rows, through a ring of 16-byte cp.async copies in shared memory
//   (rows padded by 16 bytes against bank conflicts); ldmatrix.trans turns
//   the k-major weight tile into A fragments, and each k16 step's
//   fragments load while the previous step's products run.  Decode tiles
//   are narrow and many (several blocks to an SM keep the most bytes in
//   flight); prefill tiles give each of 8 warps a 64-column tile.  Copies
//   that would be misaligned or cross the ragged edge (F % 8 != 0, the
//   last reduction rows) take predicated 2-byte loads; missing rows and
//   columns are zero.  The epilogue goes through shared memory so that
//   the scales, the activation and the stores run along contiguous
//   columns.
//
// f32: the first design, on CUDA cores, kept so that f32 checks hold to
// 1e-4 (no bucket is skipped): moe_up (one thread per hidden column,
// hidden in f32), moe_down (one thread per output column, one block per
// (d tile, C tile, expert, F split)) and moe_reduce (sums the F-split
// partials in a fixed order, applies so[e]).
//
// int8 weights (weight-only quantization, the Pallas kernel's int8 path:
// per-expert f32 scales si, so applied to the product tiles, as above):
// the weights stay int8 in HBM, so a decode step streams half the bytes
// (D*3F each).  The bf16 body's ring stages the int8 weight tiles by
// 16-byte cp.async as they are; once a stage has landed the block widens
// it to bf16 in one shared tile (exact: |w| <= 127), and the fragments and
// products run on it as on a bf16 stage.  That costs the block a barrier
// and a pass over the stage per k tile; no dequantized weight is written
// to device memory.  The f32 body reads the int8 weights in its loads.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

__device__ __forceinline__ float act_fn(float g, int act) {
  if (act == 0) return g / (1.f + expf(-g));  // silu = g * sigmoid(g)
  const float c = 0.7978845608028654f;        // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
}

// ------------------------------------------------------- f32 body (CUDA cores)

constexpr int kThreads = 128;  // output columns per block, both passes
constexpr int kChunk = 128;    // reduction rows staged in shared memory

template <int CT, typename WT>
__global__ void __launch_bounds__(kThreads)
    moe_up_kernel(const float* __restrict__ x, const WT* __restrict__ wi,
                  const float* __restrict__ si, float* __restrict__ hid,
                  int C, int D, int F, int act) {
  __shared__ float xs[kChunk][CT + 1];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const size_t row = 2 * static_cast<size_t>(F);  // wi[e, d, :, :] stride
  const float* xe = x + (static_cast<size_t>(e) * C + c0) * D;
  // threads past the last column read column F-1 and write nothing, so
  // every thread reaches the barriers
  const WT* wcol = wi + static_cast<size_t>(e) * D * row + min(f, F - 1);
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
                      ? xe[static_cast<size_t>(c) * D + d0 + dd]
                      : 0.f;
    }
    __syncthreads();
    const WT* w = wcol + static_cast<size_t>(d0) * row;
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

template <int CT, typename WT>
__global__ void __launch_bounds__(kThreads)
    moe_down_kernel(const float* __restrict__ hid,
                    const WT* __restrict__ wo, float* __restrict__ part,
                    int E, int C, int D, int F, int fsplit) {
  __shared__ float ys[kChunk][CT + 1];
  const int e = blockIdx.z / fsplit, sp = blockIdx.z % fsplit;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int flen = (F + fsplit - 1) / fsplit;
  const int fbeg = sp * flen, fend = min(F, fbeg + flen);
  const float* he = hid + (static_cast<size_t>(e) * C + c0) * F;
  const WT* wcol = wo + static_cast<size_t>(e) * F * D + min(d, D - 1);
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
    const WT* w = wcol + static_cast<size_t>(f0) * D;
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

__global__ void moe_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ so,
                                  float* __restrict__ out, int C, int D,
                                  size_t n, int fsplit) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < fsplit; ++sp) s += part[sp * n + i];
    const int e = static_cast<int>(i / (static_cast<size_t>(C) * D));
    out[i] = s * (so ? so[e] : 1.f);
  }
}

template <int CT, typename WT>
void launch_f32(const float* x, const WT* wi, const WT* wo, const float* si,
                const float* so, float* out, float* hid, float* part, int E,
                int C, int D, int F, int fsplit, int act, cudaStream_t st) {
  const dim3 gu((F + kThreads - 1) / kThreads, (C + CT - 1) / CT, E);
  moe_up_kernel<CT, WT><<<gu, kThreads, 0, st>>>(x, wi, si, hid, C, D, F,
                                                 act);
  const dim3 gd((D + kThreads - 1) / kThreads, (C + CT - 1) / CT,
                E * fsplit);
  moe_down_kernel<CT, WT><<<gd, kThreads, 0, st>>>(hid, wo, part, E, C, D,
                                                   F, fsplit);
  const size_t n = static_cast<size_t>(E) * C * D;
  const int blocks = static_cast<int>(
      n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  moe_reduce_kernel<<<blocks, 256, 0, st>>>(part, so, out, C, D, n, fsplit);
}

// ----------------------------------------------------- bf16 body (tensor cores)

using bf16 = __nv_bfloat16;
constexpr int kPad = 8;          // bf16 elements of padding per shared row

// A block's tile: WM x WN warps, each owning MW m16 tiles (weight columns)
// and NW n8 tiles (bucket rows); KT reduction rows per pipeline stage,
// STAGES stages in the cp.async ring.
template <int WM_, int WN_, int MW_, int NW_, int KT_, int STAGES_>
struct TcCfg {
  static constexpr int WM = WM_, WN = WN_, MW = MW_, NW = NW_, KT = KT_,
                       STAGES = STAGES_;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int M = WM * 16 * MW;  // weight columns of the block
  static constexpr int N = WN * 8 * NW;   // bucket rows of the block
  static constexpr int LDA = M + kPad;    // weight stage: [KT][LDA]
  static constexpr int LDX = KT + kPad;   // x / hidden stage: [N][LDX]
  static constexpr int STAGE = KT * LDA + N * LDX;
  static constexpr int LDE = N + 1;       // f32 epilogue tile: [M][LDE]
  static constexpr size_t PIPE = sizeof(bf16) * STAGES * STAGE;
  static constexpr size_t EPI = sizeof(float) * M * LDE;
  static constexpr size_t SMEM = PIPE > EPI ? PIPE : EPI;
  // int8 weights: a stage holds KT rows of M int8 weights (padded by 16
  // bytes) and the x rows; one bf16 tile [KT][LDA] after the ring takes
  // the stage being consumed, widened
  static constexpr int LDA8 = M + 16;                   // bytes
  static constexpr int STAGE8 = KT * LDA8 + 2 * N * LDX;  // bytes
  static constexpr size_t PIPE8 =
      static_cast<size_t>(STAGES) * STAGE8 + sizeof(bf16) * KT * LDA;
  static constexpr size_t SMEM8 = PIPE8 > EPI ? PIPE8 : EPI;
  static_assert(N <= THREADS, "one thread per bucket row reads its flag");
  static_assert(THREADS % (M / 8) == 0 && KT % (THREADS / (M / 8)) == 0,
                "each thread stages whole rows' worth of weight chunks");
  static_assert(THREADS % (M / 16) == 0 && KT % (THREADS / (M / 16)) == 0 &&
                    (M / 2) % 16 == 0,
                "int8: each thread stages whole 16-column chunks");
  static_assert(KT % 16 == 0 && THREADS % (KT / 8) == 0, "k16 steps");
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Eight bf16 values from `src` into shared `dst`: one 16-byte cp.async
// when all eight exist and the source is aligned, else `n` (< 8 or
// misaligned) 2-byte loads and zeros after them.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int n) {
  if (n >= 8 && aligned16(src)) {
    cp_async16(dst, src, true);
    return;
  }
  alignas(16) bf16 tmp[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    tmp[j] = j < n ? src[j] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
}

// Sixteen int8 weights from `src` into shared `dst` by `n` (< 16 or
// misaligned) byte loads, zeros after them.
__device__ __forceinline__ void stage16_i8(void* dst, const signed char* src,
                                           int n) {
  alignas(16) signed char tmp[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) tmp[j] = j < n ? src[j] : 0;
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
}

__device__ __forceinline__ void zero8(void* dst) {  // 16 bytes
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// The weights' element type: bf16, or int8 (W8).
template <bool W8>
using WType = typename std::conditional<W8, signed char, bf16>::type;

// acc += W^T X^T over k in [0, K): the block's M x N output tile, left in
// the f32 epilogue tile ep[m][n] in shared memory.  W is k-major (row k at
// W + k * ldw); the block's M columns come in two halves, half h starting
// at column col[h] with its first nv[h] columns present (the rest read as
// zero).  X holds nx rows of K values (row n at X + n * ldx).  W8: int8
// weights, widened to bf16 in shared memory a stage at a time.
template <class Cfg, bool W8>
__device__ __forceinline__ void tc_gemm(const WType<W8>* __restrict__ W,
                                        size_t ldw, const int (&col)[2],
                                        const int (&nv)[2],
                                        const bf16* __restrict__ X,
                                        size_t ldx, int nx, int K,
                                        unsigned char* smem) {
  constexpr int M = Cfg::M, N = Cfg::N, KT = Cfg::KT, ST = Cfg::STAGES;
  constexpr int MW = Cfg::MW, NW = Cfg::NW, T = Cfg::THREADS;
  constexpr int WCH = 16 / sizeof(WType<W8>);  // weights per 16 bytes
  constexpr int MCH = M / WCH;    // 16-byte chunks of a weight row
  constexpr int ARS = T / MCH;    // weight rows staged per pass
  constexpr int XCH = KT / 8;     // 16-byte chunks of an x row in a stage
  constexpr int XRS = T / XCH;    // x rows staged per pass
  constexpr int KK = KT / 16;     // k16 steps per stage
  constexpr int NB = NW == 1 ? 1 : NW / 2;  // B fragment loads per k16
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % Cfg::WM * 16 * MW;  // the warp's first column
  const int wn = warp / Cfg::WM * 8 * NW;   // ... and first bucket row
  const int nk = (K + KT - 1) / KT;
  // the chunks this thread stages are the same in every stage: one weight
  // column chunk in rows ar0 + j * ARS, one x chunk in rows xr0 + j * XRS
  const int ac = tid % MCH, ar0 = tid / MCH;
  const int ah = ac / (MCH / 2), acol = ac % (MCH / 2) * WCH;
  const int an = nv[ah] - acol;  // columns of the chunk that exist
  const WType<W8>* wc = W + col[ah] + acol;
  const bool afast = an >= WCH && ldw % WCH == 0 && aligned16(wc);
  const int xk = tid % XCH * 8, xr0 = tid / XCH;
  const bool xfast = ldx % 8 == 0 && aligned16(X);
  // a stage's weight tile and x rows (W8: the int8 tile, in bytes)
  auto stage_w = [&](int slot) -> unsigned char* {
    return smem + slot * (W8 ? static_cast<size_t>(Cfg::STAGE8)
                             : sizeof(bf16) * Cfg::STAGE);
  };
  auto stage_x = [&](int slot) -> bf16* {
    return reinterpret_cast<bf16*>(
        stage_w(slot) + (W8 ? static_cast<size_t>(KT) * Cfg::LDA8
                            : sizeof(bf16) * KT * Cfg::LDA));
  };

  auto load_stage = [&](int kt, int slot) {
    unsigned char* As = stage_w(slot);
    bf16* Xs = stage_x(slot);
    const int k0 = kt * KT;
#pragma unroll
    for (int j = 0; j < KT / ARS; ++j) {
      const int r = ar0 + j * ARS, k = k0 + r;
      void* dst = As + (W8 ? static_cast<size_t>(r) * Cfg::LDA8 + ac * 16
                           : sizeof(bf16) * (r * Cfg::LDA + ac * 8));
      if (k >= K || an <= 0)
        zero8(dst);
      else if (afast)
        cp_async16(dst, wc + k * ldw, true);
      else if constexpr (W8)
        stage16_i8(dst, wc + k * ldw, an);
      else
        stage8(static_cast<bf16*>(dst), wc + k * ldw, an);
    }
#pragma unroll
    for (int j = 0; j < (N + XRS - 1) / XRS; ++j) {
      const int r = xr0 + j * XRS, k = k0 + xk;
      if (r < N) {
        bf16* dst = Xs + r * Cfg::LDX + xk;
        if (r >= nx || k >= K)
          zero8(dst);
        else if (xfast && k + 8 <= K)
          cp_async16(dst, X + r * ldx + k, true);
        else
          stage8(dst, X + r * ldx + k, K - k);
      }
    }
  };

  const int q = lane >> 3;
  uint32_t af[2][MW][4], bfr[2][NB][4];
  // the fragments of k16 step kk of a stage into buffer b
  auto load_frags = [&](const bf16* As, const bf16* Xs, int kk, int b) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
      ldmatrix_x4_trans(af[b][mi], As + (kk * 16 + (q >> 1) * 8 + (lane & 7)) *
                                           Cfg::LDA + wm + mi * 16 +
                                       (q & 1) * 8);
    if constexpr (NW == 1) {
      uint32_t (&b2)[2] = *reinterpret_cast<uint32_t(*)[2]>(bfr[b][0]);
      ldmatrix_x2(b2, Xs + (wn + (lane & 7)) * Cfg::LDX + kk * 16 +
                          (q & 1) * 8);
    } else {
#pragma unroll
      for (int np = 0; np < NB; ++np)
        ldmatrix_x4(bfr[b][np], Xs + (wn + np * 16 + (q >> 1) * 8 +
                                      (lane & 7)) * Cfg::LDX +
                                    kk * 16 + (q & 1) * 8);
    }
  };

  float acc[MW][NW][4] = {};
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();  // stage kt has landed
    __syncthreads();          // ... and stage kt - 1 is consumed
    if (kt + ST - 1 < nk) load_stage(kt + ST - 1, (kt + ST - 1) % ST);
    cp_async_commit();
    const bf16* As;
    const bf16* Xs = stage_x(kt % ST);
    if constexpr (W8) {
      // widen the landed int8 stage into the bf16 tile after the ring (the
      // barrier above: every warp is done with the previous one)
      const unsigned char* A8 = stage_w(kt % ST);
      bf16* Ab = reinterpret_cast<bf16*>(smem + ST * Cfg::STAGE8);
      for (int i = tid; i < KT * (M / 16); i += T) {
        const int r = i / (M / 16), c = i % (M / 16);
        const uint4 raw = *reinterpret_cast<const uint4*>(
            A8 + static_cast<size_t>(r) * Cfg::LDA8 + c * 16);
        uint4* d = reinterpret_cast<uint4*>(Ab + r * Cfg::LDA + c * 16);
        d[0] = i8x8_to_bf16x8(make_uint2(raw.x, raw.y));
        d[1] = i8x8_to_bf16x8(make_uint2(raw.z, raw.w));
      }
      __syncthreads();
      As = Ab;
    } else {
      As = reinterpret_cast<const bf16*>(stage_w(kt % ST));
    }
    load_frags(As, Xs, 0, 0);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      // the next step's fragments load while this step's products run
      if (kk + 1 < KK) load_frags(As, Xs, kk + 1, (kk + 1) & 1);
      const int b = kk & 1;
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        if constexpr (NW == 1) {
          mma_bf16(acc[mi][0], af[b][mi], bfr[b][0][0], bfr[b][0][1]);
        } else {
#pragma unroll
          for (int np = 0; np < NB; ++np) {
            mma_bf16(acc[mi][2 * np], af[b][mi], bfr[b][np][0],
                     bfr[b][np][1]);
            mma_bf16(acc[mi][2 * np + 1], af[b][mi], bfr[b][np][2],
                     bfr[b][np][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue tile reuses the ring
  float* ep = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int ni = 0; ni < NW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ep[(wm + mi * 16 + g + (e >> 1) * 8) * Cfg::LDE + wn + ni * 8 +
           2 * t + (e & 1)] = acc[mi][ni][e];
  __syncthreads();
}

// flags[e, c]: whether bucket row c of expert e holds any nonzero value
// (-0 counts as zero); one warp per row.  D % 8 == 0.
__global__ void __launch_bounds__(256)
    moe_flags_kernel(const bf16* __restrict__ x, int* __restrict__ flags,
                     int rows, int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* p =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * D);
  bool any = false;
  for (int i = threadIdx.x & 31; i < D / 8; i += 32) {
    const uint4 u = p[i];
    any |= ((u.x | u.y | u.z | u.w) & 0x7fff7fffu) != 0u;
  }
  any = __any_sync(0xffffffffu, any);
  if ((threadIdx.x & 31) == 0) flags[row] = any;
}

// Whether any of the block's nc bucket rows (from row e*C + c0) is
// nonzero; block-uniform.
__device__ __forceinline__ bool tile_occupied(const int* __restrict__ flags,
                                              size_t row0, int nc) {
  const int i = threadIdx.x;
  return __syncthreads_or(i < nc && flags[row0 + i]) != 0;
}

// hid[e, c, f] (row stride FP) for f in the block's M / 2 hidden columns:
// the block's weight columns are those gate columns and the same up
// columns.  Grid (C tiles, F tiles, E).
template <class Cfg, bool W8>
__global__ void __launch_bounds__(Cfg::THREADS)
    moe_up_tc_kernel(const bf16* __restrict__ x,
                     const WType<W8>* __restrict__ wi,
                     const float* __restrict__ si,
                     const int* __restrict__ flags, bf16* __restrict__ hid,
                     int C, int D, int F, int FP, int act) {
  constexpr int FH = Cfg::M / 2;  // hidden columns per block
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * Cfg::N, nc = min(Cfg::N, C - c0);
  const size_t row0 = static_cast<size_t>(e) * C + c0;
  if (!tile_occupied(flags, row0, nc)) return;  // hidden never read
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f0 = blockIdx.y * FH;
  const int col[2] = {f0, F + f0};
  const int nv[2] = {min(FH, F - f0), min(FH, F - f0)};
  tc_gemm<Cfg, W8>(wi + static_cast<size_t>(e) * D * 2 * F,
               2 * static_cast<size_t>(F), col, nv, x + row0 * D, D, nc, D,
               smem_raw);
  const float* ep = reinterpret_cast<const float*>(smem_raw);
  const float s = si ? si[e] : 1.f;
  for (int i = threadIdx.x; i < FH * Cfg::N; i += Cfg::THREADS) {
    const int f = i % FH, c = i / FH;
    if (c < nc && f0 + f < F) {
      const float gv = ep[f * Cfg::LDE + c] * s;
      const float uv = ep[(FH + f) * Cfg::LDE + c] * s;
      hid[(row0 + c) * FP + f0 + f] = __float2bfloat16(act_fn(gv, act) * uv);
    }
  }
}

// out[e, c, d] for d in the block's M output columns.  Grid (C tiles,
// D tiles, E).
template <class Cfg, bool W8>
__global__ void __launch_bounds__(Cfg::THREADS)
    moe_down_tc_kernel(const bf16* __restrict__ hid,
                       const WType<W8>* __restrict__ wo,
                       const float* __restrict__ so,
                       const int* __restrict__ flags, bf16* __restrict__ out,
                       int C, int D, int F, int FP) {
  constexpr int M = Cfg::M;
  const int e = blockIdx.z;
  const int c0 = blockIdx.x * Cfg::N, nc = min(Cfg::N, C - c0);
  const size_t row0 = static_cast<size_t>(e) * C + c0;
  const int d0 = blockIdx.y * M;
  bf16* oe = out + row0 * D + d0;
  if (!tile_occupied(flags, row0, nc)) {  // empty tile: exact zeros
    for (int i = threadIdx.x; i < M * nc; i += Cfg::THREADS)
      if (d0 + i % M < D)
        oe[static_cast<size_t>(i / M) * D + i % M] = __float2bfloat16(0.f);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col[2] = {d0, d0 + M / 2};
  const int nv[2] = {max(0, min(M / 2, D - d0)),
                     max(0, min(M / 2, D - d0 - M / 2))};
  tc_gemm<Cfg, W8>(wo + static_cast<size_t>(e) * F * D, D, col, nv,
               hid + row0 * FP, FP, nc, F, smem_raw);
  const float* ep = reinterpret_cast<const float*>(smem_raw);
  const float s = so ? so[e] : 1.f;
  for (int i = threadIdx.x; i < M * nc; i += Cfg::THREADS) {
    const int m = i % M, c = i / M;
    if (d0 + m < D)
      oe[static_cast<size_t>(c) * D + m] =
          __float2bfloat16(ep[m * Cfg::LDE + c] * s);
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Up and down passes with their own tiles; both take Up::N bucket rows.
template <class Up, class Down, bool W8>
int launch_tc(const bf16* x, const void* wiv, const void* wov,
              const float* si, const float* so, bf16* out, bf16* hid,
              int* flags, int E, int C, int D, int F, int FP, int act,
              cudaStream_t st) {
  static_assert(Up::N == Down::N, "one row tile for both passes");
  const auto* wi = static_cast<const WType<W8>*>(wiv);
  const auto* wo = static_cast<const WType<W8>*>(wov);
  constexpr size_t up_smem = W8 ? Up::SMEM8 : Up::SMEM;
  constexpr size_t down_smem = W8 ? Down::SMEM8 : Down::SMEM;
  cudaError_t err = allow_smem(moe_up_tc_kernel<Up, W8>, up_smem);
  if (err == cudaSuccess)
    err = allow_smem(moe_down_tc_kernel<Down, W8>, down_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = E * C, nct = (C + Up::N - 1) / Up::N;
  moe_flags_kernel<<<(rows + 7) / 8, 256, 0, st>>>(x, flags, rows, D);
  // the row tiles of one weight tile are neighbours in launch order, so
  // the weight tile comes from device memory once and from L2 after
  const dim3 gu(nct, (F + Up::M / 2 - 1) / (Up::M / 2), E);
  moe_up_tc_kernel<Up, W8><<<gu, Up::THREADS, up_smem, st>>>(
      x, wi, si, flags, hid, C, D, F, FP, act);
  const dim3 gd(nct, (D + Down::M - 1) / Down::M, E);
  moe_down_tc_kernel<Down, W8><<<gd, Down::THREADS, down_smem, st>>>(
      hid, wo, so, flags, out, C, D, F, FP);
  return static_cast<int>(cudaGetLastError());
}

// Tiles by bucket rows.  At decode (8, 16 rows) the weights stream
// through a 4-stage ring of 64-row stages, several blocks to an SM, the up
// pass with 128 weight columns a block (64 gate, 64 up) and the down pass
// with 64; at prefill (64, 128 rows) 8 warps each hold a 64 x 16 or 64 x
// 32 tile so that every fragment feeds several products; 32 rows (a
// DeepSeek-V3 prefill bucket) streams 256 weight columns a block.  Wider
// decode tiles at one block to an SM were slower on the H100: with
// per-thread cp.async issue, more blocks keep more bytes in flight.
template <bool W8>
int launch_bf16(int nt, const bf16* x, const void* wi, const void* wo,
                const float* si, const float* so, bf16* out, bf16* hid,
                int* flags, int E, int C, int D, int F, int FP, int act,
                cudaStream_t st) {
  using Up8 = TcCfg<4, 1, 2, 1, 64, 4>;
  using Down8 = TcCfg<4, 1, 1, 1, 64, 4>;
  using Up16 = TcCfg<4, 1, 2, 2, 64, 4>;
  using Down16 = TcCfg<4, 1, 1, 2, 64, 4>;
  using Both32 = TcCfg<4, 1, 4, 4, 64, 3>;
  using Both64 = TcCfg<2, 4, 4, 2, 32, 4>;
  using Both128 = TcCfg<2, 4, 4, 4, 32, 4>;
#define REPRO_MOE_TC(U, D_)                                                \
  launch_tc<U, D_, W8>(x, wi, wo, si, so, out, hid, flags, E, C, D, F, FP, \
                       act, st)
  switch (nt) {
    case 8: return REPRO_MOE_TC(Up8, Down8);
    case 16: return REPRO_MOE_TC(Up16, Down16);
    case 32: return REPRO_MOE_TC(Both32, Both32);
    case 64: return REPRO_MOE_TC(Both64, Both64);
    case 128: return REPRO_MOE_TC(Both128, Both128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MOE_TC
}

}  // namespace

// f32 body.  x (E,C,D), wi (E,D,2,F), wo (E,F,D), f32 or, with w8, int8
// weights; si/so (E,) or null (scale 1); out (E,C,D); hid (E,C,F) and part
// (fsplit,E,C,D) scratch.  ct: bucket rows per block (4, 8 or 32).  act:
// 0 silu, 1 gelu.
extern "C" int moe_ffn_f32_launch(const float* x, const void* wi,
                                  const void* wo, const float* si,
                                  const float* so, float* out, float* hid,
                                  float* part, int E, int C, int D, int F,
                                  int ct, int fsplit, int act, int w8,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MOE_F32(CT)                                                  \
  (w8 ? launch_f32<CT, signed char>(                                       \
            x, static_cast<const signed char*>(wi),                        \
            static_cast<const signed char*>(wo), si, so, out, hid, part, E, \
            C, D, F, fsplit, act, st)                                      \
      : launch_f32<CT, float>(x, static_cast<const float*>(wi),             \
                              static_cast<const float*>(wo), si, so, out,   \
                              hid, part, E, C, D, F, fsplit, act, st))
  switch (ct) {
    case 4: REPRO_MOE_F32(4); break;
    case 8: REPRO_MOE_F32(8); break;
    case 32: REPRO_MOE_F32(32); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MOE_F32
  return static_cast<int>(cudaGetLastError());
}

// bf16 body.  x (E,C,D) bf16; wi (E,D,2,F), wo (E,F,D) bf16 or, with w8,
// int8; D % 8 == 0 and 16-byte aligned bases; si/so (E,) f32 or null;
// out (E,C,D) bf16; hid (E,C,FP) bf16 scratch, FP = F rounded up to 8;
// flags (E,C) int32 scratch.  nt: bucket rows per block (8, 16, 32, 64 or
// 128).
extern "C" int moe_ffn_bf16_launch(const void* x, const void* wi,
                                   const void* wo, const float* si,
                                   const float* so, void* out, void* hid,
                                   int* flags, int E, int C, int D, int F,
                                   int FP, int nt, int act, int w8,
                                   void* stream) {
  if (D % 8 || FP % 8 || FP < F) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const bf16*>(x);
  auto* ob = static_cast<bf16*>(out);
  auto* hb = static_cast<bf16*>(hid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w8 ? launch_bf16<true>(nt, xb, wi, wo, si, so, ob, hb, flags, E, C,
                                D, F, FP, act, st)
            : launch_bf16<false>(nt, xb, wi, wo, si, so, ob, hb, flags, E, C,
                                 D, F, FP, act, st);
}
