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
// Two bodies, chosen by dtype.  Both cut W into chunks of 64 slots, one
// block per (chunk, kv head, row), so that a batch of 8 rows still fills
// the SMs, and the G = H/Hkv query heads of the group share every K/V row
// the block reads; a second launch merges the chunks' partials in a fixed
// order under the reference's rule (repro/models/attention.py: m_safe = 0
// when nothing is valid, p = 0 on invalid slots).  A chunk with no valid
// slot writes its sentinel (m, l) and nothing else.
//
// int8 K/V (the int8 ring of repro/models/kvcache.py, the Pallas kernel's
// `quantized` branch): k, v hold int8 values and ks, vs (B,W,Hkv) one f32
// scale per (slot, head); s = softcap(scale * (q . k_int) * ks) and
// o_unnorm = sum exp(s - m) * vs * v_int, l unscaled.  The ring stays int8
// in HBM (half the bf16 bytes); each body widens it in registers or
// shared memory only, and no dequantized ring is ever written.
//
// bf16 (the served type): tensor cores.  The first design (the f32 body
// below, once for both types) was set by serial per-slot phases: one warp
// compacting the valid slots while three waited, a 5-shuffle dot per slot
// and head, a chain of dependent 2-byte V loads per column.  Now a block
// of 4 warps stages the group's queries and the chunk's K and V rows with
// 16-byte cp.async, all in flight at once (V in its own group, landing
// while the scores run); an invalid slot and the padding columns are
// zero-filled by the copy and never read from memory, so no compaction
// and no data-dependent branch is needed.  The staged tile then runs the
// tile body shared with paged_decode.cu (decode_tile.cuh): S on mma.sync
// m16n8k16 with the heads padded to 16 rows, the masked softmax on a
// shared f32 score tile, P.V with P split into bf16 hi + lo, G > 16
// looping over head tiles.  Takes D, Dv multiples of 8 up to 256 (padded
// to 32, 64, 128 or 256) and 16-byte aligned rows; the wrapper raises
// otherwise.
//
// int8 on the tensor cores: the int8 K and V rows are loaded 8 bytes a
// thread and stored to the shared tile as bf16 (exact), and the tile's
// scales are staged beside them; the shared tile body folds them in.
//
// f32: the first design, on CUDA cores, kept so that f32 checks hold to
// 1e-4: a block compacts its chunk's valid slots (one warp, ballots),
// scores them one warp per slot, takes the softmax one warp per head and
// the V sum one thread per column for all G heads.  It reads int8 K/V as
// well (f32 queries over an int8 ring).
#include <type_traits>

#include "decode_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;  // query heads per pass of the V sum

// KV: the ring's element type, T or signed char (int8, with ksc / vsc).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    gqa_chunk_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ ksc,
                     const float* __restrict__ vsc,
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
      if (ksc != nullptr) a *= ksc[kr / D];  // (b, slot, hk) scale
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
        const size_t vr = (static_cast<size_t>(b) * W + w0 + idx[jj]) * Hkv +
                          hk;
        const float x = to_f32(v[vr * Dv + d]);
        const float vs = vsc != nullptr ? vsc[vr] : 1.f;
#pragma unroll
        for (int t = 0; t < kMaxG; ++t)
          if (g0 + t < G)
            acc[t] = fmaf(ps[(g0 + t) * wchunk + jj] * vs, x, acc[t]);
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

// ----------------------------------------------------- bf16 body (tensor cores)

using decode_tile::bf16;
using decode_tile::kSlots;
constexpr int kTcThreads = decode_tile::kThreads;  // 4 warps

// DP: max(D, Dv) rounded up to 32, 64, 128 or 256; the shared columns past
// D (Dv) are zero-filled by the copies.  Q8: int8 K/V with the scales
// ksc / vsc (B,W,Hkv), else bf16 K/V.
template <int DP, bool Q8>
__global__ void __launch_bounds__(kTcThreads)
    gqa_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ kp,
                  const void* __restrict__ vp,
                  const unsigned char* __restrict__ valid,
                  const float* __restrict__ ksc,
                  const float* __restrict__ vsc,
                  float* __restrict__ po, float* __restrict__ pm,
                  float* __restrict__ pl, int H, int Hkv, int W, int D,
                  int Dv, float scale, float cap) {
  using Tile = decode_tile::Tile<DP>;
  using KV = typename std::conditional<Q8, signed char, bf16>::type;
  const KV* __restrict__ k = static_cast<const KV*>(kp);
  const KV* __restrict__ v = static_cast<const KV*>(vp);
  constexpr int LD = Tile::LD, CH = Tile::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned char ok_s[kSlots];
  __shared__ float ks_s[kSlots], vs_s[kSlots];  // Q8: the tile's scales
  const int G = H / Hkv, GP = (G + 15) / 16 * 16;
  const Tile tl(smem_raw, GP);
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int w0 = sp * kSlots;
  const int nw = min(kSlots, W - w0);
  const size_t row0 = static_cast<size_t>(b) * H + hk * G;  // (b, 1st head)

  const size_t kvrow = static_cast<size_t>(b) * W + w0;  // slot w0 of row b
  bool any = false;
  if (tid < kSlots) {
    any = tid < nw && valid[static_cast<size_t>(b) * W + w0 + tid];
    ok_s[tid] = any;
    if (Q8) {
      const size_t r = (kvrow + tid) * Hkv + hk;
      ks_s[tid] = any ? ksc[r] : 0.f;
      vs_s[tid] = any ? vsc[r] : 0.f;
    }
  }
  if (!__syncthreads_or(any)) {
    // a chunk with no valid slot: the sentinel max and nothing else
    decode_tile::write_empty(pm, pl, row0, G, nsplit, sp);
    return;
  }
  // every copy in flight at once: Q and K in one group, V in the next;
  // rows past G, invalid slots and padding columns are zero-filled
  const int dch = D / 8, vch = Dv / 8;
  for (int i = tid; i < GP * CH; i += kTcThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r < G && c < dch;
    cp_async16(tl.qs + r * LD + c * 8, q + (in ? (row0 + r) * D + c * 8 : 0),
               in);
  }
  for (int i = tid; i < kSlots * CH; i += kTcThreads) {
    const int j = i / CH, c = i % CH;
    const bool in = ok_s[j] && c < dch;
    const KV* src = k + (in ? ((kvrow + j) * Hkv + hk) * D + c * 8 : 0);
    if constexpr (Q8)  // int8 rows widened to bf16 on the way into the tile
      decode_tile::stage_i8(tl.ks + j * LD + c * 8,
                            reinterpret_cast<const signed char*>(src), in);
    else
      cp_async16(tl.ks + j * LD + c * 8, src, in);
  }
  cp_async_commit();
  for (int i = tid; i < kSlots * CH; i += kTcThreads) {
    const int j = i / CH, c = i % CH;
    const bool in = ok_s[j] && c < vch;
    const KV* src = v + (in ? ((kvrow + j) * Hkv + hk) * Dv + c * 8 : 0);
    if constexpr (Q8)
      decode_tile::stage_i8(tl.vs + j * LD + c * 8,
                            reinterpret_cast<const signed char*>(src), in);
    else
      cp_async16(tl.vs + j * LD + c * 8, src, in);
  }
  cp_async_commit();
  decode_tile::attend<DP>(tl, ok_s, G, Dv, scale, cap, po, pm, pl, row0,
                          nsplit, sp, Q8 ? ks_s : nullptr,
                          Q8 ? vs_s : nullptr);
}

template <int DP, bool Q8>
int launch_tc(const void* q, const void* k, const void* v,
              const unsigned char* valid, const float* ks, const float* vs,
              float* po, float* pm, float* pl, float* o, float* m, float* l,
              int B, int H, int Hkv, int W, int D, int Dv, float scale,
              float cap, cudaStream_t st) {
  const int G = H / Hkv;
  const size_t smem = decode_tile::smem_bytes((G + 15) / 16 * 16, DP);
  const cudaError_t err = cudaFuncSetAttribute(
      gqa_tc_kernel<DP, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nsplit = (W + kSlots - 1) / kSlots;
  const dim3 grid(nsplit, Hkv, B);
  gqa_tc_kernel<DP, Q8><<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), k, v, valid, ks, vs, po, pm, pl, H, Hkv,
      W, D, Dv, scale, cap);
  gqa_combine_kernel<<<B * H, kCombineThreads, 0, st>>>(po, pm, pl, o, m, l,
                                                        nsplit, Dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* valid, const float* ks, const float* vs,
           float* po, float* pm, float* pl, float* o, float* m, float* l,
           int B, int H, int Hkv, int W, int D, int Dv, int wchunk,
           float scale, float cap, cudaStream_t st) {
  const int nsplit = (W + wchunk - 1) / wchunk;
  const int G = H / Hkv;
  const size_t smem = sizeof(float) * static_cast<size_t>(G) * (D + wchunk) +
                      sizeof(int) * static_cast<size_t>(wchunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gqa_chunk_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(nsplit, Hkv, B);
  gqa_chunk_kernel<T, KV><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), valid, ks, vs, po, pm, pl, H, Hkv, W, D, Dv,
      wchunk, scale, cap);
  gqa_combine_kernel<<<B * H, kCombineThreads, 0, st>>>(po, pm, pl, o, m, l,
                                                        nsplit, Dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,H,D), k (B,W,Hkv,D), v (B,W,Hkv,Dv) of one dtype, or int8 k, v
// with their scales ks, vs (B,W,Hkv) f32 (null for unquantized K/V);
// valid (B,W) bool; po (B,H,nsplit,Dv), pm/pl (B,H,nsplit) f32 scratch
// with nsplit = ceil(W / wchunk); o (B,H,Dv), m/l (B,H) f32 outputs.
// cap <= 0 disables the softcap.  f32 takes the CUDA-core body (any
// wchunk), bf16 the tensor-core body (wchunk 64, D and Dv multiples of 8
// up to 256, 16-byte aligned rows; 8-byte aligned for int8).
extern "C" int gqa_decode_launch(int dtype, const void* q, const void* k,
                                 const void* v, const void* valid,
                                 const float* ks, const float* vs, float* po,
                                 float* pm, float* pl, float* o, float* m,
                                 float* l, int B, int H, int Hkv, int W,
                                 int D, int Dv, int wchunk, float scale,
                                 float cap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* vm = static_cast<const unsigned char*>(valid);
  const bool q8 = ks != nullptr;
  if (q8 != (vs != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return q8 ? launch<float, signed char>(q, k, v, vm, ks, vs, po, pm, pl,
                                           o, m, l, B, H, Hkv, W, D, Dv,
                                           wchunk, scale, cap, st)
              : launch<float, float>(q, k, v, vm, ks, vs, po, pm, pl, o, m,
                                     l, B, H, Hkv, W, D, Dv, wchunk, scale,
                                     cap, st);
  const int dm = D > Dv ? D : Dv;
  if (dtype != DT_BF16 || wchunk != kSlots || D % 8 || Dv % 8 || dm > 256)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_GQA_TC(DP)                                                    \
  (q8 ? launch_tc<DP, true>(q, k, v, vm, ks, vs, po, pm, pl, o, m, l, B, H, \
                            Hkv, W, D, Dv, scale, cap, st)                  \
      : launch_tc<DP, false>(q, k, v, vm, ks, vs, po, pm, pl, o, m, l, B,   \
                             H, Hkv, W, D, Dv, scale, cap, st))
  if (dm <= 32) return REPRO_GQA_TC(32);
  if (dm <= 64) return REPRO_GQA_TC(64);
  if (dm <= 128) return REPRO_GQA_TC(128);
  return REPRO_GQA_TC(256);
#undef REPRO_GQA_TC
}
