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
// qcat, the f32 partials) take ~2 us at 3.35 TB/s for 8 rows of ~490
// tokens, its 4*valid*H*(lat+dr/2) operations ~1 us on the bf16 tensor
// cores but ~16 us on the CUDA cores' f32 FMAs, which this design uses: it
// is bound by its own choice of units.
//
// Design.  The TPU kernel walks (row, logical block) in order with the
// (H, lat) accumulator in VMEM; 128 heads x 512 f32 is 256 KB, more than a
// Hopper block's shared memory, so here a block of 128 threads takes one
// (chunk of logical blocks, group of 16 heads, row), and a second,
// fixed-order launch merges the chunks (combine_partials_row).  The group's
// 16 queries, pre-scaled, sit in shared memory as f32.  Per mapped block,
// in tiles of 16 positions, the block reads the tile's validity from the
// slot_pos entries it staged at the start (one load per position of the
// chunk), skips a tile with no valid position, and otherwise stages the
// valid rows [ckv | kr] of the tile as f32 in shared memory (each thread
// issues all of its 16-byte loads before converting any of them; an
// invalid row is written as zeros, so stale or unwritten slots never reach
// the sums).  Scores: each warp takes 4 heads and each 8-lane group of it
// 4 positions, its lanes splitting the 576-long dots into 8 interleaved
// slices (one 4x4 register tile per lane) that three shuffle rounds add
// up.  Eight lanes per head then run the online-softmax update on the
// tile's 16 scores.  Values: each thread owns 4 latent columns of all 16
// heads, 64 f32 accumulators in registers, and adds p * ckv over the tile.
// A chunk that maps no block returns at once after writing its sentinel
// (m, l), and empty chunks write no o_unnorm: the combine reads none of a
// chunk whose max is the sentinel, so the f32 chunk partials cost bytes
// only for chunks that hold a valid position.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHeads = 16;               // query heads per block
constexpr int kTile = 16;                // positions per staged tile
constexpr int kMaxD = 576;               // lat + dr, at most
constexpr int kMaxLat = 4 * kThreads;    // 4 latent columns per thread
constexpr int kMaxChunk = 64;            // logical blocks per block
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
__device__ __forceinline__ void unpack16(const uint4& r, float (&out)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(e[j]);
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

template <typename T>
int launch(const void* q, const void* ckv, const void* kr,
           const int* slot_pos, const int* pt, const int* pos,
           const void* ckv_new, const void* kr_new, float* po, float* pm,
           float* pl, float* o, float* m, float* l, int B, int H, int bt,
           int L, int R, int MB, int chunk, float scale, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (L % VEC || R % VEC || L + R > kMaxD || L > kMaxLat)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L + R, chunk, bt);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nsplit = (MB + chunk - 1) / chunk;
  const dim3 grid(nsplit, (H + kHeads - 1) / kHeads, B);
  mla_chunk_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ckv),
      static_cast<const T*>(kr), slot_pos, pt, pos,
      static_cast<const T*>(ckv_new), static_cast<const T*>(kr_new), po, pm,
      pl, H, bt, L, R, MB, chunk, scale);
  mla_combine_kernel<<<B * H, 128, 0, st>>>(po, pm, pl, o, m, l, nsplit, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qcat (B,H,L+R), ckv (NB1,bt,L), kr (NB1,bt,R) of one dtype (one layer's
// latent arena, NB1 = NB + 1 with the trash block last), 16-byte aligned;
// slot_pos (NB1,bt), pt (B,MB) and pos (B,) int32; ckv_new (B,L), kr_new
// (B,R) in the arena dtype, or null (unfused); po (B,H,nsplit,L), pm/pl
// (B,H,nsplit) f32 scratch with nsplit = ceil(MB / chunk); o (B,H,L),
// m/l (B,H) f32 outputs.  L and R multiples of 16 bytes' worth of
// elements, L + R <= 576, L <= 512; chunk <= 64 and chunk * bt <= 1024.
extern "C" int paged_mla_decode_launch(
    int dtype, const void* q, const void* ckv, const void* kr,
    const void* slot_pos, const void* pt, const void* pos,
    const void* ckv_new, const void* kr_new, float* po, float* pm, float* pl,
    float* o, float* m, float* l, int B, int H, int bt, int L, int R, int MB,
    int chunk, float scale, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || chunk * bt > kMaxChunkPos)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const int*>(slot_pos);
  const auto* ptp = static_cast<const int*>(pt);
  const auto* ps = static_cast<const int*>(pos);
  if (dtype == DT_F32)
    return launch<float>(q, ckv, kr, sp, ptp, ps, ckv_new, kr_new, po, pm, pl,
                         o, m, l, B, H, bt, L, R, MB, chunk, scale, st);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, ckv, kr, sp, ptp, ps, ckv_new, kr_new, po,
                                 pm, pl, o, m, l, B, H, bt, L, R, MB, chunk,
                                 scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
