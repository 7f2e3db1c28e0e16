// Paged absorbed-MLA decode for Hopper: DeepSeek's multi-head latent
// attention at decode, read straight through the (row, logical block) ->
// physical block page table of the latent arena.  Replaces the Pallas TPU
// kernel repro/kernels/paged_decode.py::paged_mla_decode (body _mla_kernel).
//
// What it computes: for each row b and query head h, the partials of one
// decode step in the absorbed form.  The query qcat[b, h] = [q_lat | q_rope]
// (lat + dr values) scores against one cached token as
//   s = scale * (q_lat . ckv + q_rope . kr),
// the key being concat(ckv, kr) shared by every head, and the attended
// value is the latent ckv itself.  Logical block lb of row b lives in
// physical block pt[b, lb] (-1 = unmapped) of the arena ckv (NB+1, bt, lat)
// / kr (NB+1, bt, dr); position t of a mapped block is valid when
// slot_pos[pb, t] >= 0 and slot_pos[pb, t] <= pos[b].  Over the valid
// positions m = max s (0 for a row with none), l = sum exp(s - m),
// o_unnorm = sum exp(s - m) ckv, all in f32: the (o_unnorm, m, l) contract
// of models.attention.  An unmapped logical block is skipped whole and none
// of its bytes are loaded; the trash block (index NB, the scatter target of
// unmapped rows) is therefore never read.
//
// Fused decode-write epilogue: given the fresh latents ckv_new (B, lat) /
// kr_new (B, dr) in the arena dtype, the row's token at ring position
// i = pos % (MB*bt) replaces position i % bt of logical block i / bt when
// that block's tile is staged, before any score math, and its slot_pos
// reads as pos.  Attention over the un-written arena then equals attention
// after the scatter bit for bit (the Python wrapper performs the scatter
// right after, on the same stream).
//
// Bound on the H100: every head of a row attends over the same latent
// rows, so the 128 heads of DeepSeek-V3 share each (bt x (lat + dr)) tile
// and the work is a (heads x 576) . (576 x bt) product per block plus a
// (heads x bt) . (bt x 512) one.  Its bytes (the mapped blocks' latents,
// qcat, the f32 outputs) take ~2 us at 3.35 TB/s for 8 rows of ~460
// tokens, its 4*valid*H*(lat+dr/2) operations ~1 us on the bf16 tensor
// cores (~16 us on the CUDA cores' f32 FMAs): it is bound by bytes.
//
// Two bodies, chosen by dtype.
//
// bf16 (the served type): tensor cores.  The first design (the f32 body
// below, once for both types) ran both products on the CUDA cores in f32,
// took 16 heads a block, so that each latent tile was loaded and
// converted to f32 by 8 head groups, and passed four barriers per 16
// positions with no load in flight during the math.  Now a block of 8
// warps takes 64 heads and one chunk of a row: two tiles of 32 ring
// positions (64 positions; the grid's slowest dimension is the chunk, so
// the low chunks, busy in every row, are dispatched first and the empty
// ones after).  It reads only its own page-table entries (a chunk that
// maps no block loads nothing else) and its positions' slot_pos, then
// issues every bulk copy at once, behind those small dependent loads: Q
// (64 x 576) and both tiles [ckv | kr] in bf16 by 16-byte cp.async, rows
// padded by 16 bytes for conflict-free ldmatrix; an invalid or unmapped
// row and the padding columns are zero-filled by the copy without a read,
// a tile with no valid position is not loaded, and the fused token's row
// is copied from ckv_new / kr_new in place of its arena row.
// S = Q.[ckv | kr]^T runs on mma.sync m16n8k16 (f32 accumulators, scale
// applied to S in f32): warps (h, 0) and (h, 1) each take 16 positions of
// head tile h and swap them through shared memory at a named barrier.  The
// online softmax runs on the fragments (quad shuffles, the true running
// max, the REPRO_NEG_INF sentinel rules).  O += P.ckv runs on the tensor
// cores with P split into hi = bf16(P) and lo = bf16(P - hi), both
// multiplied, so P keeps ~16 bits as the Pallas kernel's f32 P does; warp
// (h, c) owns the 16 x 256 f32 accumulator of head tile h and value
// columns c*256..+255 in registers (128 a thread; ptxas -v: 200 registers,
// no spills), four n8 tiles at a time so that independent accumulators
// take turns.  A chunk with no valid position writes its sentinel (m, l)
// and no o_unnorm; the others stage their f32 partials in shared memory
// and write each head's row with 16-byte stores, and a second launch
// merges them in a fixed order (combine_partials_row).  What keeps it from
// its byte bound: the partials' round trip (f32, 128 KB a busy chunk,
// written and read back), a single block per SM (157 KB of shared memory,
// 200 registers a thread), so that no other block hides a block's chain
// of dependent loads, and shared-memory reads of the S product (each warp
// reloads its 16 queries for each tile).
//
// f32: the first design, on CUDA cores, kept so that f32 checks hold to
// 1e-4.  A block of 128 threads takes one (chunk of logical blocks, group
// of 16 heads, row); per mapped block, in tiles of 16 positions, it stages
// the valid rows [ckv | kr] as f32 in shared memory (each thread issues
// all of its 16-byte loads before converting any), scores them (each warp
// 4 heads, 8-lane groups of 4 positions, three shuffle rounds), runs the
// online softmax (8 lanes per head) and adds p * ckv into 64 f32
// accumulators a thread (4 latent columns of all 16 heads).  A chunk that
// maps no block returns at once after writing its sentinel (m, l).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHeads = 16;               // query heads per block
constexpr int kTile = 16;                // positions per staged tile
constexpr int kMaxD = 576;               // lat + dr, at most
constexpr int kMaxLat = 4 * kThreads;    // 4 latent columns per thread
constexpr int kMaxChunk = 64;            // logical blocks per block
constexpr int kChunkBlocks = 8;          // logical blocks per block, as run
constexpr int kMaxChunkPos = 1024;       // chunk * bt slot_pos entries
constexpr int kSS = kTile + 1;           // score row stride (no conflicts)
// the score tile: 4 warps x 4 heads, 4 groups of 8 lanes x 4 positions;
// the softmax: 8 lanes per head, 2 positions per lane
static_assert(kThreads == 8 * kHeads && kTile == 16 && kHeads == 16,
              "the thread maps below assume these sizes");

// The 16 bytes at p (aligned) as floats.
__device__ __forceinline__ void unpack16(const uint4& r, float (&out)[4]) {
  const float* e = reinterpret_cast<const float*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = e[j];
}

size_t smem_bytes(int D, int chunk, int bt) {
  const size_t Dp = (D + 31) / 32 * 32;
  return sizeof(float) * ((kHeads + kTile) * Dp + kTile * kHeads +
                          kHeads * kSS + 3 * kHeads) +
         sizeof(int) * (static_cast<size_t>(chunk) * bt + kMaxChunk + kTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mla_chunk_kernel(const T* __restrict__ q, const T* __restrict__ ckv,
                     const T* __restrict__ kr,
                     const int* __restrict__ slot_pos,
                     const int* __restrict__ pt,
                     const int* __restrict__ pos_arr,
                     const T* __restrict__ ckv_new,
                     const T* __restrict__ kr_new, float* __restrict__ po,
                     float* __restrict__ pm, float* __restrict__ pl, int H,
                     int bt, int L, int R, int MB, int chunk, float scale) {
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int NV = (kTile * kMaxD / VEC + kThreads - 1) / kThreads;
  extern __shared__ float sm[];
  const int D = L + R;
  const int Dp = (D + 31) / 32 * 32;     // padded with zero columns
  float* qs = sm;                        // [kHeads][Dp] scaled queries
  float* ks = qs + kHeads * Dp;          // [kTile][Dp]  [ckv | kr | 0]
  float* pT = ks + kTile * Dp;           // [kTile][kHeads] probabilities
  float* ss = pT + kTile * kHeads;       // [kHeads][kSS] scores
  float* ms = ss + kHeads * kSS;         // [kHeads] running max
  float* ls = ms + kHeads;               // [kHeads] running denominator
  float* cs = ls + kHeads;               // [kHeads] this tile's correction
  int* sps = reinterpret_cast<int*>(cs + kHeads);  // [chunk * bt]
  int* pts = sps + chunk * bt;           // [kMaxChunk]
  int* vld = pts + kMaxChunk;            // [kTile]

  const int sp = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * kHeads;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lb0 = sp * chunk;
  const int nlb = min(chunk, MB - lb0);
  const int p = pos_arr[b];

  // nlb <= kMaxChunk < kThreads: thread i reads page-table entry i
  bool own = false;
  if (tid < nlb) {
    pts[tid] = pt[static_cast<size_t>(b) * MB + lb0 + tid];
    own = pts[tid] >= 0;
  }
  if (!__syncthreads_or(own)) {
    // a chunk that maps no block: the sentinel max and nothing else
    if (tid < kHeads && h0 + tid < H) {
      const size_t r = (static_cast<size_t>(b) * H + h0 + tid) * nsplit + sp;
      pm[r] = REPRO_NEG_INF;
      pl[r] = 0.f;
    }
    return;
  }
  // the group's queries, pre-scaled: every 16-byte load first, then the
  // conversions; heads past H and the padding columns are zero
  {
    const int vq = D / VEC;
    uint4 rq[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int idx = tid + j * kThreads, h = idx / vq;
      rq[j] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kHeads * vq && h0 + h < H)
        rq[j] = __ldg(reinterpret_cast<const uint4*>(
            q + (static_cast<size_t>(b) * H + h0 + h) * D +
            (idx - h * vq) * VEC));
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int idx = tid + j * kThreads, h = idx / vq;
      if (idx < kHeads * vq) {
        float f[VEC];
        unpack16(rq[j], f);
        float* dst = qs + h * Dp + (idx - h * vq) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = f[e] * scale;
      }
    }
  }
  const int pad = Dp - D;
  for (int i = tid; i < kHeads * pad; i += kThreads)
    qs[(i / pad) * Dp + D + i % pad] = 0.f;
  for (int i = tid; i < kTile * pad; i += kThreads)
    ks[(i / pad) * Dp + D + i % pad] = 0.f;
  if (tid < kHeads) {
    ms[tid] = REPRO_NEG_INF;  // the true running max; sentinel until valid
    ls[tid] = 0.f;
  }
  // the slot_pos entries of every mapped block of the chunk, at once
  for (int i = tid; i < nlb * bt; i += kThreads) {
    const int pb = pts[i / bt];
    sps[i] = pb >= 0 ? slot_pos[static_cast<size_t>(pb) * bt + i % bt] : -1;
  }
  // the fused token's logical block and offset (-1: none)
  int tgt_lb = -1, tgt_off = -1;
  if (ckv_new != nullptr) {
    const int i = p % (MB * bt);
    tgt_lb = i / bt;
    tgt_off = i % bt;
  }
  __syncthreads();

  // scores: heads sh..sh+3, positions st..st+3, d slice sl of 8
  const int sh = warp * 4, st = (lane >> 3) * 4, sl = lane & 7;
  // values: latent columns c0..c0+3 of all kHeads heads
  const int c0 = tid * 4;
  float acc[kHeads][4];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[h][j] = 0.f;

  const int vl = L / VEC, vrow = D / VEC;
  const int nvec = kTile * vrow;
  for (int jb = 0; jb < nlb; ++jb) {
    const int pb = pts[jb];
    if (pb < 0) continue;  // unmapped: masked whole, never loaded
    const int hit = (lb0 + jb == tgt_lb) ? tgt_off : -1;
    for (int t0 = 0; t0 < bt; t0 += kTile) {
      const int nt = min(kTile, bt - t0);
      bool ok = false;
      if (tid < nt) {
        const int t = t0 + tid;
        const int spos = t == hit ? p : sps[jb * bt + t];
        ok = spos >= 0 && spos <= p;
      }
      if (tid < kTile) vld[tid] = ok;
      if (!__syncthreads_or(ok)) continue;  // no valid position: skipped

      // stage the tile: every 16-byte load first, then the conversions
      uint4 raw[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int idx = tid + j * kThreads;
        raw[j] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < nvec) {
          const int t = idx / vrow, c = idx - t * vrow;
          if (vld[t]) {
            const T* src;
            if (t0 + t == hit) {
              src = c < vl ? ckv_new + static_cast<size_t>(b) * L + c * VEC
                           : kr_new + static_cast<size_t>(b) * R +
                                 (c - vl) * VEC;
            } else {
              const size_t row = static_cast<size_t>(pb) * bt + t0 + t;
              src = c < vl ? ckv + row * L + c * VEC
                           : kr + row * R + (c - vl) * VEC;
            }
            raw[j] = __ldg(reinterpret_cast<const uint4*>(src));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int idx = tid + j * kThreads;
        if (idx < nvec) {
          const int t = idx / vrow, c = idx - t * vrow;
          const int col = c < vl ? c * VEC : L + (c - vl) * VEC;
          float f[VEC];
          unpack16(raw[j], f);
          float4* dst = reinterpret_cast<float4*>(ks + t * Dp + col);
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e)
            dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                                 f[4 * e + 3]);
        }
      }
      __syncthreads();

      // scores of the 16 heads against the tile's 16 rows
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 2
      for (int d = sl * 4; d < Dp; d += 32) {
        float4 qa[4], kb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          qa[a] = *reinterpret_cast<const float4*>(qs + (sh + a) * Dp + d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          kb[c] = *reinterpret_cast<const float4*>(ks + (st + c) * Dp + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float v = s[a][c];
            v = fmaf(qa[a].x, kb[c].x, v);
            v = fmaf(qa[a].y, kb[c].y, v);
            v = fmaf(qa[a].z, kb[c].z, v);
            v = fmaf(qa[a].w, kb[c].w, v);
            s[a][c] = v;
          }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[a][c] += __shfl_xor_sync(0xffffffffu, s[a][c], o);
      // lane sl of the group writes scores 2*sl and 2*sl + 1 of its tile
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (((a * 4 + c) >> 1) == sl)
            ss[(sh + a) * kSS + st + c] = vld[st + c] ? s[a][c]
                                                      : REPRO_NEG_INF;
      __syncthreads();

      // the online-softmax update: 8 lanes per head, 2 positions each
      {
        const int h = tid >> 3, j8 = tid & 7;
        const float s0 = ss[h * kSS + j8], s1 = ss[h * kSS + j8 + 8];
        const float m_prev = ms[h];
        float tmax = fmaxf(s0, s1);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        const float m_new = fmaxf(m_prev, tmax);
        const float m_safe = m_new <= REPRO_NEG_INF / 2 ? 0.f : m_new;
        const float e0 = s0 > REPRO_NEG_INF / 2 ? expf(s0 - m_safe) : 0.f;
        const float e1 = s1 > REPRO_NEG_INF / 2 ? expf(s1 - m_safe) : 0.f;
        pT[j8 * kHeads + h] = e0;
        pT[(j8 + 8) * kHeads + h] = e1;
        float lsum = e0 + e1;
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
        __syncwarp();  // every lane has read ms[h] before it changes
        if (j8 == 0) {
          const float corr =
              m_prev <= REPRO_NEG_INF / 2 ? 0.f : expf(m_prev - m_safe);
          ls[h] = ls[h] * corr + lsum;
          cs[h] = corr;
          ms[h] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * corr + p . ckv over the tile's valid rows
      if (c0 < L) {
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          const float c = cs[h];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[h][j] *= c;
        }
        for (int t = 0; t < nt; ++t) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + t * Dp + c0);
          const float4* pr = reinterpret_cast<const float4*>(pT + t * kHeads);
#pragma unroll
          for (int h4 = 0; h4 < kHeads / 4; ++h4) {
            const float4 pv = pr[h4];
            const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int h = h4 * 4 + i;
              acc[h][0] = fmaf(pp[i], kv.x, acc[h][0]);
              acc[h][1] = fmaf(pp[i], kv.y, acc[h][1]);
              acc[h][2] = fmaf(pp[i], kv.z, acc[h][2]);
              acc[h][3] = fmaf(pp[i], kv.w, acc[h][3]);
            }
          }
        }
      }
    }
  }

  // ms / ls were last written before a barrier that every thread passed
  const size_t r0 = (static_cast<size_t>(b) * H + h0) * nsplit + sp;
  if (c0 < L) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      if (h0 + h < H && ms[h] > REPRO_NEG_INF / 2)
        *reinterpret_cast<float4*>(po + (r0 + static_cast<size_t>(h) *
                                                  nsplit) * L + c0) =
            make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
  if (tid < kHeads && h0 + tid < H) {
    const size_t r = r0 + static_cast<size_t>(tid) * nsplit;
    pm[r] = ms[tid];  // the chunk's true max; the sentinel when none valid
    pl[r] = ls[tid];
  }
}

__global__ void mla_combine_kernel(const float* __restrict__ po,
                                   const float* __restrict__ pm,
                                   const float* __restrict__ pl,
                                   float* __restrict__ o,
                                   float* __restrict__ m,
                                   float* __restrict__ l, int nsplit,
                                   int L) {
  combine_partials_row(po, pm, pl, o, m, l, nsplit, L);
}

// ----------------------------------------------------- bf16 body (tensor cores)

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 256;      // 8 warps: 4 head tiles x 2 column halves
constexpr int kTcHeads = 64;         // query heads per block
constexpr int kTcTile = 32;          // positions per staged tile
constexpr int kTcTiles = 2;          // tiles per block, both in flight
constexpr int kLd = kMaxD + 8;       // bf16 row stride in shared memory
constexpr int kHalf = kMaxLat / 2;   // value columns per warp
constexpr int kOs = kMaxLat + 8;     // f32 row stride of the staged partials
constexpr size_t kTcSmem =
    sizeof(bf16) * static_cast<size_t>(kTcHeads + kTcTiles * kTcTile) * kLd +
    sizeof(float) * 8 * 32 * 8;  // the score exchange of the warp pairs
static_assert(sizeof(float) * kTcHeads * kOs <= kTcSmem,
              "the staged partials reuse the queries' and tiles' memory");

__global__ void __launch_bounds__(kTcThreads, 1)
    mla_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ckv,
                  const bf16* __restrict__ kr,
                  const int* __restrict__ slot_pos,
                  const int* __restrict__ pt,
                  const int* __restrict__ pos_arr,
                  const bf16* __restrict__ ckv_new,
                  const bf16* __restrict__ kr_new, float* __restrict__ po,
                  float* __restrict__ pm, float* __restrict__ pl, int H,
                  int bt, int L, int R, int MB, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int rsrc[kTcTiles * kTcTile];  // a chunk position's arena
                                            // row; kFresh: the fused token;
                                            // -1: invalid
  __shared__ int ptc[kTcTiles * kTcTile + 1];  // the chunk's page table
  __shared__ unsigned vbits[kTcTiles];  // their valid positions, bit i for
                                        // the tile's position i
  __shared__ int tiles[kTcTiles];                // first positions of the
  __shared__ int ntiles_s;                       // tiles that hold a valid one
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][kLd] queries
  bf16* kv = qs + kTcHeads * kLd;  // [kTcTiles][32][kLd] [ckv | kr | 0]
  float* sx = reinterpret_cast<float*>(kv + kTcTiles * kTcTile * kLd);
                                   // [8][32][8] the warp pairs' scores
  // the chunk index is the slowest grid dimension, so that the low
  // chunks, busy in every row, are dispatched first
  const int h0 = blockIdx.x * kTcHeads, b = blockIdx.y, sp = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int p = pos_arr[b];
  const int D = L + R, DP = (D + 15) / 16 * 16;
  const int nch = DP / 8, dch = D / 8, lch = L / 8;  // 16-byte chunks
  constexpr int kFresh = -2;

  // the fused token's ring position (-1: none)
  const int hit = ckv_new != nullptr ? p % (MB * bt) : -1;
  // chunk sp is the row's tiles 2 sp and 2 sp + 1: ring positions
  // pos0 .. pos0+npos-1, in logical blocks lb0 .. lb0+nlb-1
  const int pos0 = sp * kTcTiles * kTcTile;
  const int npos = min(kTcTiles * kTcTile, MB * bt - pos0);
  const int lb0 = pos0 / bt, nlb = (pos0 + npos - 1) / bt - lb0 + 1;
  bool mapped = false;
  if (tid < nlb) {
    ptc[tid] = pt[static_cast<size_t>(b) * MB + lb0 + tid];
    mapped = ptc[tid] >= 0;
  }
  // a chunk with no valid position: the sentinel max and nothing else
  auto empty = [&]() {
    if (tid < kTcHeads && h0 + tid < H) {
      const size_t r = (static_cast<size_t>(b) * H + h0 + tid) * nsplit + sp;
      pm[r] = REPRO_NEG_INF;
      pl[r] = 0.f;
    }
  };
  if (!__syncthreads_or(mapped)) {  // maps no block: nothing is loaded
    empty();
    return;
  }
  for (int i = tid; i < npos; i += kTcThreads) {
    const int gi = pos0 + i;
    const int pb = ptc[gi / bt - lb0];
    int src = -1;
    if (pb >= 0) {  // unmapped: masked whole, never loaded
      const int row = pb * bt + gi % bt;
      const int spos = gi == hit ? p : slot_pos[row];
      if (spos >= 0 && spos <= p) src = gi == hit ? kFresh : row;
    }
    rsrc[i] = src;
  }
  __syncthreads();
  if (warp == 0) {  // the tiles that hold a valid position, in order
    int n = 0;
    for (int t0 = 0; t0 < npos; t0 += kTcTile) {
      const bool ok = t0 + lane < npos && rsrc[t0 + lane] != -1;
      const unsigned bits = __ballot_sync(0xffffffffu, ok);
      if (bits) {
        if (lane == 0) {
          tiles[n] = t0;
          vbits[n] = bits;
        }
        ++n;
      }
    }
    if (lane == 0) ntiles_s = n;
  }
  __syncthreads();
  const int ntiles = ntiles_s;
  if (ntiles == 0) {
    empty();
    return;
  }

  constexpr int kCh = kMaxD / 8;  // 16-byte chunks of a shared row
  // a tile's rows [ckv | kr] by 16-byte cp.async; the fused token's row
  // comes from ckv_new / kr_new, invalid rows and the padding columns are
  // zero-filled without a read
  auto stage = [&](int t0, bf16* dst) {
#pragma unroll
    for (int j = 0; j < kTcTile * kCh / kTcThreads; ++j) {
      const int i = tid + j * kTcThreads;
      const int r = i / kCh, c = i - r * kCh, ip = t0 + r;
      if (c >= nch) continue;  // past the contraction width: never read
      const int row = ip < npos ? rsrc[ip] : -1;
      const bool in = row != -1 && c < dch;
      const bf16* src = ckv;
      if (in) {
        if (row == kFresh)
          src = c < lch ? ckv_new + static_cast<size_t>(b) * L + c * 8
                        : kr_new + static_cast<size_t>(b) * R + (c - lch) * 8;
        else
          src = c < lch ? ckv + static_cast<size_t>(row) * L + c * 8
                        : kr + static_cast<size_t>(row) * R + (c - lch) * 8;
      }
      cp_async16(dst + r * kLd + c * 8, src, in);
    }
  };
  // the bulk copies go out only now, behind the small dependent loads
  // above (page table, then slot_pos), which would otherwise queue behind
  // them: tile 0 and Q in one commit group, tile 1 in the next
  stage(tiles[0], kv);
#pragma unroll
  for (int j = 0; j < kTcHeads * kCh / kTcThreads; ++j) {
    const int i = tid + j * kTcThreads;
    const int r = i / kCh, c = i - r * kCh;
    if (c >= nch) continue;
    const bool in = h0 + r < H && c < dch;
    cp_async16(qs + r * kLd + c * 8,
               q + (in ? (static_cast<size_t>(b) * H + h0 + r) * D + c * 8
                       : 0),
               in);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kTcTiles; ++i) {
    if (i < ntiles) stage(tiles[i], kv + i * kTcTile * kLd);
    cp_async_commit();
  }

  // warp: head rows hrow..hrow+15 of the block, value columns
  // half*256 .. +255; the two warps of a head tile share its scores
  const int hrow = (warp & 3) * 16, half = warp >> 2;
  const bool live = h0 + hrow < H;
  float oacc[kHalf / 8][4];
#pragma unroll
  for (int n = 0; n < kHalf / 8; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_run[2] = {REPRO_NEG_INF, REPRO_NEG_INF};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    if (it == 0)
      cp_async_wait<kTcTiles - 1>();  // tile 0 and Q have landed
    else
      cp_async_wait<0>();
    __syncthreads();
    const bf16* kt = kv + it * kTcTile * kLd;
    if (live) {
      // S = Q.[ckv | kr]^T: 16 heads x 32 positions; this warp computes
      // positions half*16 .. +15 and takes the others from its partner
      // (even and odd k16 steps in separate accumulators: four
      // independent mma chains instead of two)
      float mine[2][4], odd[2][4], other[2][4], sacc[4][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[j][e] = odd[j][e] = 0.f;
      const bf16* qa = qs + (hrow + (lane & 15)) * kLd + (lane >> 4) * 8;
      const bf16* ka =
          kt + (half * 16 + (mi >> 1) * 8 + (lane & 7)) * kLd + (mi & 1) * 8;
      const int nk = DP / 16;
#pragma unroll 2
      for (int kk = 0; kk < nk; kk += 2) {
        uint32_t qf[4], kf[4];
        ldmatrix_x4(qf, qa + kk * 16);
        ldmatrix_x4(kf, ka + kk * 16);
        mma_bf16(mine[0], qf, kf[0], kf[1]);
        mma_bf16(mine[1], qf, kf[2], kf[3]);
        if (kk + 1 < nk) {
          ldmatrix_x4(qf, qa + kk * 16 + 16);
          ldmatrix_x4(kf, ka + kk * 16 + 16);
          mma_bf16(odd[0], qf, kf[0], kf[1]);
          mma_bf16(odd[1], qf, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[j][e] += odd[j][e];
      {
        float4* xw = reinterpret_cast<float4*>(sx + (warp * 32 + lane) * 8);
        xw[0] = make_float4(mine[0][0], mine[0][1], mine[0][2], mine[0][3]);
        xw[1] = make_float4(mine[1][0], mine[1][1], mine[1][2], mine[1][3]);
        // the two warps of a head tile meet at named barrier 1 + head tile
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (warp & 3)) : "memory");
        const float4* xr = reinterpret_cast<const float4*>(
            sx + ((warp ^ 4) * 32 + lane) * 8);
        const float4 a = xr[0], c = xr[1];
        other[0][0] = a.x; other[0][1] = a.y; other[0][2] = a.z;
        other[0][3] = a.w; other[1][0] = c.x; other[1][1] = c.y;
        other[1][2] = c.z; other[1][3] = c.w;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sacc[j][e] = half ? other[j][e] : mine[j][e];
          sacc[2 + j][e] = half ? mine[j][e] : other[j][e];
        }
      // scale in f32, then mask
      const unsigned vb = vbits[it];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (vb >> (j * 8 + 2 * t + (e & 1))) & 1u;
          sacc[j][e] = ok ? sacc[j][e] * scale : REPRO_NEG_INF;
        }
      // the online softmax on rows g (r = 0) and g + 8 (r = 1); a row's
      // 32 scores sit on the 4 lanes of a quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mb = REPRO_NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mb = fmaxf(mb, fmaxf(sacc[j][2 * r], sacc[j][2 * r + 1]));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
        const float m_new = fmaxf(m_run[r], mb);
        const float m_safe = m_new <= REPRO_NEG_INF / 2 ? 0.f : m_new;
        const float corr =
            m_run[r] <= REPRO_NEG_INF / 2 ? 0.f : __expf(m_run[r] - m_safe);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float s = sacc[j][e];
            const float pe = s > REPRO_NEG_INF / 2 ? __expf(s - m_safe) : 0.f;
            sacc[j][e] = pe;
            ls += pe;
          }
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        ls += __shfl_xor_sync(0xffffffffu, ls, 2);
        l_run[r] = l_run[r] * corr + ls;
        m_run[r] = m_new;  // the true running max; sentinel until valid
        // (nothing to rescale on the first tile, or where no row's max
        // moved: x * 1 = x)
        if (it > 0 && __any_sync(0xffffffffu, corr != 1.f)) {
#pragma unroll
          for (int n = 0; n < kHalf / 8; ++n) {
            oacc[n][2 * r] *= corr;
            oacc[n][2 * r + 1] *= corr;
          }
        }
      }
      // O += P.ckv, P split into hi + lo as A fragments
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        split_bf16(sacc[2 * kk][0], sacc[2 * kk][1], ah[kk][0], al[kk][0]);
        split_bf16(sacc[2 * kk][2], sacc[2 * kk][3], ah[kk][1], al[kk][1]);
        split_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ah[kk][2],
                   al[kk][2]);
        split_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ah[kk][3],
                   al[kk][3]);
      }
      // four n8 tiles at a time, so that four independent accumulators
      // take turns; columns past L (up to the group's end, inside the
      // shared row) are computed and never stored
#pragma unroll
      for (int n0 = 0; n0 < kHalf / 8; n0 += 4) {
        if (half * kHalf + n0 * 8 < L) {
          // matrix m of an x4 holds positions 8m .. 8m+7: b0, b1 of the
          // first k16 step, then of the second
          uint32_t vf[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ldmatrix_x4_trans(vf[i],
                              kt + lane * kLd + half * kHalf + (n0 + i) * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(oacc[n0 + i], ah[0], vf[i][0], vf[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(oacc[n0 + i], al[0], vf[i][0], vf[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(oacc[n0 + i], ah[1], vf[i][2], vf[i][3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(oacc[n0 + i], al[1], vf[i][2], vf[i][3]);
        }
      }
    }
    __syncthreads();  // the exchange buffer is rewritten next
  }

  // the f32 partials leave through shared memory (the queries and tiles
  // are no longer read: the loop ended at a barrier), so that each head's
  // row is written by 16-byte stores of whole lines
  float* os = reinterpret_cast<float*>(smem_raw);  // [64][kOs]
  __shared__ bool busy_h[kTcHeads];                 // a row to write
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hr = hrow + g + 8 * r;
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
        *reinterpret_cast<float2*>(os + hr * kOs + half * kHalf + n * 8 +
                                   2 * t) =
            make_float2(oacc[n][2 * r], oacc[n][2 * r + 1]);
      if (half == 0 && t == 0) {
        busy_h[hr] = m_run[r] > REPRO_NEG_INF / 2;
        if (h0 + hr < H) {
          const size_t row =
              (static_cast<size_t>(b) * H + h0 + hr) * nsplit + sp;
          pm[row] = m_run[r];  // the chunk's true max; the sentinel when none
          pl[row] = l_run[r];
        }
      }
    }
  }
  __syncthreads();
  const int nq = min(kTcHeads, H - h0);
  for (int hr = warp; hr < nq; hr += kTcThreads / 32) {
    if (!busy_h[hr]) continue;  // no valid position: no o_unnorm
    float* dst =
        po + ((static_cast<size_t>(b) * H + h0 + hr) * nsplit + sp) * L;
    for (int c = lane * 4; c < L; c += 128)
      *reinterpret_cast<float4*>(dst + c) =
          *reinterpret_cast<const float4*>(os + hr * kOs + c);
  }
}


int launch_tc(const void* q, const void* ckv, const void* kr,
              const int* slot_pos, const int* pt, const int* pos,
              const void* ckv_new, const void* kr_new, float* po, float* pm,
              float* pl, float* o, float* m, float* l, int B, int H, int bt,
              int L, int R, int MB, int nsplit, float scale, cudaStream_t st) {
  if (L % 8 || R % 8 || L + R > kMaxD || L > kMaxLat)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      mla_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTcSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kTcHeads - 1) / kTcHeads, B, nsplit);
  mla_tc_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ckv),
      static_cast<const bf16*>(kr), slot_pos, pt, pos,
      static_cast<const bf16*>(ckv_new), static_cast<const bf16*>(kr_new), po,
      pm, pl, H, bt, L, R, MB, scale);
  mla_combine_kernel<<<B * H, kCombineThreads, 0, st>>>(po, pm, pl, o, m, l,
                                                        nsplit, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* ckv, const void* kr,
           const int* slot_pos, const int* pt, const int* pos,
           const void* ckv_new, const void* kr_new, float* po, float* pm,
           float* pl, float* o, float* m, float* l, int B, int H, int bt,
           int L, int R, int MB, int nsplit, float scale, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int chunk = kChunkBlocks;
  if (L % VEC || R % VEC || L + R > kMaxD || L > kMaxLat)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L + R, chunk, bt);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(nsplit, (H + kHeads - 1) / kHeads, B);
  mla_chunk_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ckv),
      static_cast<const T*>(kr), slot_pos, pt, pos,
      static_cast<const T*>(ckv_new), static_cast<const T*>(kr_new), po, pm,
      pl, H, bt, L, R, MB, chunk, scale);
  mla_combine_kernel<<<B * H, kCombineThreads, 0, st>>>(po, pm, pl, o, m, l,
                                                        nsplit, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The chunks of a row, each a block of the first launch whose partials the
// combine merges: f32, kChunkBlocks logical blocks (bt <= 128); bf16,
// kTcTiles tiles of kTcTile positions.  0 when the dtype or bt is not taken.
extern "C" int paged_mla_decode_splits(int dtype, int MB, int bt) {
  if (dtype == DT_F32)
    return kChunkBlocks * bt <= kMaxChunkPos
               ? (MB + kChunkBlocks - 1) / kChunkBlocks : 0;
  if (dtype == DT_BF16)
    return (MB * bt + kTcTiles * kTcTile - 1) / (kTcTiles * kTcTile);
  return 0;
}

// qcat (B,H,L+R), ckv (NB1,bt,L), kr (NB1,bt,R) of one dtype (one layer's
// latent arena, NB1 = NB + 1 with the trash block last), 16-byte aligned;
// slot_pos (NB1,bt), pt (B,MB) and pos (B,) int32; ckv_new (B,L), kr_new
// (B,R) in the arena dtype, or null (unfused); po (B,H,nsplit,L), pm/pl
// (B,H,nsplit) f32 scratch with nsplit = paged_mla_decode_splits(dtype, MB,
// bt); o (B,H,L), m/l (B,H) f32 outputs.  L and R multiples of 16 bytes'
// worth of elements, L + R <= 576, L <= 512.
extern "C" int paged_mla_decode_launch(
    int dtype, const void* q, const void* ckv, const void* kr,
    const void* slot_pos, const void* pt, const void* pos,
    const void* ckv_new, const void* kr_new, float* po, float* pm, float* pl,
    float* o, float* m, float* l, int B, int H, int bt, int L, int R, int MB,
    float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const int*>(slot_pos);
  const auto* ptp = static_cast<const int*>(pt);
  const auto* ps = static_cast<const int*>(pos);
  const int nsplit = paged_mla_decode_splits(dtype, MB, bt);
  if (nsplit < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32)
    return launch<float>(q, ckv, kr, sp, ptp, ps, ckv_new, kr_new, po, pm, pl,
                         o, m, l, B, H, bt, L, R, MB, nsplit, scale, st);
  return launch_tc(q, ckv, kr, sp, ptp, ps, ckv_new, kr_new, po, pm, pl, o, m,
                   l, B, H, bt, L, R, MB, nsplit, scale, st);
}
