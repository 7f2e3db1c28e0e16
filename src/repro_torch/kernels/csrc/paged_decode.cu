// Paged flash-decode GQA for Hopper: decode attention read straight through
// the (row, logical block) -> physical block page table of the block-paged
// KV arena.  Replaces the Pallas TPU kernel
// repro/kernels/paged_decode.py::paged_gqa_decode (body _gqa_kernel).
//
// What it computes: for each row b and query head h, the partials of one
// decode step against the head-major arena k/v (Hkv, NB+1, bt, D):
// logical block lb of row b lives in physical block pt[b, lb] (-1 =
// unmapped); position t of that block is valid when it is mapped,
// slot_pos[pb, t] >= 0, slot_pos[pb, t] <= pos[b] and, with a window,
// slot_pos[pb, t] > pos[b] - window.  Over the valid positions
//   s = softcap(scale * q . k),  m = max s (0 for a row with none),
//   l = sum exp(s - m),  o_unnorm = sum exp(s - m) v,
// all in f32: the (o_unnorm, m, l) contract of models.attention.
// An unmapped logical block is masked whole and none of its bytes are
// loaded; the trash block (index NB, the scatter target of unmapped rows)
// is therefore never read.
//
// Fused decode-write: given the fresh token k_new/v_new (B, Hkv, D) in the
// arena dtype, the row's token at ring position i = pos % (MB*bt) takes
// the place of position i % bt of logical block i / bt, before any score
// math, when that block is mapped; its slot_pos reads as pos.  Attention
// over the un-written arena then equals attention after the scatter bit
// for bit (the Python wrapper performs the scatter right after, on the
// same stream).  A fresh token whose block is unmapped is masked with it.
//
// Bound on the H100: the K and V bytes of the mapped blocks, each read
// once (mapped*Hkv*bt*2D*2 in bf16; about 16 MB for 8 rows of ~480
// tokens of mixtral, ~5 us at 3.35 TB/s), plus slot_pos, q and the f32
// partials.  Its 4*valid*H*D operations are far below the card's rate,
// so it is bound by bytes.
//
// int8 arena (the Pallas kernel's `quantized` branch): k, v hold int8
// values and ks, vs (Hkv, NB+1, bt) one f32 scale per (head, position);
// s = softcap(scale * (q . k_int) * ks) and o_unnorm sums
// exp(s - m) * vs * v_int, l unscaled.  The fused form's fresh token
// brings its scales ks_new, vs_new (B, Hkv) with its int8 rows, merged
// like them, so fused equals write-then-attend bit for bit here too.  The
// arena stays int8 in HBM (its K/V bytes halve); the rows are widened in
// registers or shared memory only.
//
// Two bodies, chosen by dtype.  The source sizes a row's chunks, whose
// partials a second launch merges in a fixed order (combine_partials_row):
// paged_gqa_decode_splits.
//
// bf16 (the served type): tensor cores, the tile body of gqa_decode.cu
// (decode_tile.cuh) over the paged arena.  The first design (the f32 body
// below, once for both types) walked each warp's logical blocks in turn,
// a chain of dependent loads per block (slot_pos, a ballot, then one
// 8-position tile of K and V), scored on the CUDA cores with 5 shuffle
// rounds per 8 positions, and merged its 4 warps through a barrier and a
// 4*G*D f32 shared-memory pass in every block, empty ones included.  Now
// a block takes one tile of 64 logical positions of one row and kv head,
// so a row's chunk count is ceil(MB*bt / 64) whatever bt is: a tile may
// hold part of a block (bt > 64, or a bt that does not divide 64), and
// each position finds its page-table entry and offset from its own
// logical position.  The chunk is the grid's slowest dimension, so the
// low chunks, busy in every row, are dispatched first.  The first 64
// threads each read one position's page-table entry; a tile whose
// positions are all unmapped writes its sentinel and leaves (at the
// served shape about half the grid).  Then each of those threads loads
// its position's slot_pos while the block issues Q and the K rows of
// every mapped position by 16-byte cp.async (each (kv head, physical
// block) slab is one contiguous bt*D run): K does not wait for slot_pos,
// since a K row of an invalid position only feeds a score that the mask
// replaces.  V rows are issued once validity is known, those of the valid
// positions only; the others are zero-filled without a read (P is 0
// there, and 0 * NaN would not be).  Unmapped positions and padding
// columns are zero-filled too, and the fresh token's rows are copied from
// k_new / v_new in place of its arena rows.  K and V are read once per
// step and not again before the next step has streamed every other layer
// through L2, so their copies carry an evict-first L2 policy: they do not
// push out lines that are used again, or dirty lines that would have to
// be written back first.
// The rest is the shared tile body: S on mma.sync m16n8k16 with the heads
// padded to 16 rows (any G, G > 16 looping over head tiles), the masked
// softmax on a shared f32 score tile, P.V with P split into bf16 hi + lo.
// Takes any G, D a multiple of 8 up to 256, any bt and MB (at most 65535
// chunks a row), 16-byte aligned rows.  An int8 arena's rows are loaded 8
// bytes a thread and stored to the tile as bf16 (exact), the tile's
// scales staged beside them (decode_tile.cuh folds them in); int8 rows
// need 8-byte alignment.
//
// What bounds it: with a cold L2 the tile kernel streams the mapped
// blocks' K and V near the card's memory rate, counting the dirty lines
// their reads evict; the rest of the call is the two launches and the
// merge (PERF.md).
//
// f32: the first design, on CUDA cores, kept so that f32 checks hold to
// 1e-4.  Each of a block's 4 warps walks its own logical blocks of a
// chunk of kChunk and keeps its own running (max, sum, accumulator) in
// registers; per tile of 8 positions that holds a valid one it issues
// every K and V load of the tile back to back (lanes across D, D/32
// elements a lane), then scores them (shuffle sums), and the warps merge
// through shared memory at the end.  Takes G in {1, 2, 4, 8} and
// D <= 128, and an int8 arena as well (f32 queries over int8 rows).
#include <type_traits>

#include "decode_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;        // positions per register tile
constexpr int kChunk = 8;       // logical blocks per thread block

template <int N>
struct Raw;
template <>
struct Raw<1> { using type = unsigned char; };
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

// VPL consecutive elements of T, loaded as one word of their total size.
template <typename T, int VPL>
using RawVec = typename Raw<VPL * sizeof(T)>::type;

// The VPL elements at p (aligned to their size), raw.
template <typename T, int VPL>
__device__ __forceinline__ RawVec<T, VPL> load_raw(const T* __restrict__ p) {
  return __ldg(reinterpret_cast<const RawVec<T, VPL>*>(p));
}

template <typename T, int VPL>
__device__ __forceinline__ void unpack(const RawVec<T, VPL>& r,
                                       float (&out)[VPL]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < VPL; ++j) out[j] = to_f32(e[j]);
}

// VPL consecutive elements at p (aligned to their size) as floats.
template <typename T, int VPL>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VPL]) {
  unpack<T, VPL>(load_raw<T, VPL>(p), out);
}

// KV: the arena's element type, T or signed char (int8, with ksc / vsc and
// the fresh token's ksn / vsn).
template <typename T, typename KV, int G, int VPL>
__global__ void __launch_bounds__(kThreads)
    paged_chunk_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v,
                       const int* __restrict__ slot_pos,
                       const int* __restrict__ pt,
                       const int* __restrict__ pos_arr,
                       const KV* __restrict__ k_new,
                       const KV* __restrict__ v_new,
                       const float* __restrict__ ksc,
                       const float* __restrict__ vsc,
                       const float* __restrict__ ksn,
                       const float* __restrict__ vsn, float* __restrict__ po,
                       float* __restrict__ pm, float* __restrict__ pl,
                       int H, int Hkv, int NB1, int bt, int D, int MB,
                       int chunk, float scale, float cap, int window) {
  __shared__ int pts[kChunk];
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  extern __shared__ float sm_acc[];  // [kWarps][G][D]
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lb0 = sp * chunk;
  const int nlb = min(chunk, MB - lb0);
  for (int i = threadIdx.x; i < nlb; i += kThreads)
    pts[i] = pt[static_cast<size_t>(b) * MB + lb0 + i];
  const int p = pos_arr[b];
  __syncthreads();

  const bool has = lane * VPL < D;  // this lane's D columns exist
  const int c0 = lane * VPL;
  float qr[G][VPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (has) {
      load_vec<T, VPL>(q + (static_cast<size_t>(b) * H + hk * G + g) * D + c0,
                       qr[g]);
#pragma unroll
      for (int j = 0; j < VPL; ++j) qr[g][j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < VPL; ++j) qr[g][j] = 0.f;
    }
  }
  // the fused token's logical block and offset (-1: none)
  int tgt_lb = -1, tgt_off = -1;
  float kn[VPL], vn[VPL];
  float kns = 1.f, vns = 1.f;  // the fresh token's int8 scales
#pragma unroll
  for (int j = 0; j < VPL; ++j) kn[j] = vn[j] = 0.f;
  if (k_new != nullptr) {
    const int i = p % (MB * bt);
    tgt_lb = i / bt;
    tgt_off = i % bt;
    if (has) {
      const size_t r = (static_cast<size_t>(b) * Hkv + hk) * D + c0;
      load_vec<KV, VPL>(k_new + r, kn);
      load_vec<KV, VPL>(v_new + r, vn);
    }
    if (ksc != nullptr) {
      kns = ksn[static_cast<size_t>(b) * Hkv + hk];
      vns = vsn[static_cast<size_t>(b) * Hkv + hk];
    }
  }

  float m_run[G], l_run[G], acc[G][VPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = REPRO_NEG_INF;  // the true running max; sentinel until valid
    l_run[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[g][j] = 0.f;
  }

  for (int jb = warp; jb < nlb; jb += kWarps) {
    const int pb = pts[jb];
    if (pb < 0) continue;  // unmapped: masked whole, never loaded
    const int hit = (lb0 + jb == tgt_lb) ? tgt_off : -1;
    const size_t base = (static_cast<size_t>(hk) * NB1 + pb) * bt;
    const int* spb = slot_pos + static_cast<size_t>(pb) * bt;
    for (int t32 = 0; t32 < bt; t32 += 32) {
      // validity of up to 32 positions of the block: one slot_pos load
      // and one ballot
      const int tl = t32 + lane;
      bool ok = false;
      if (tl < bt) {
        const int spos = tl == hit ? p : spb[tl];
        ok = spos >= 0 && spos <= p && (window <= 0 || spos > p - window);
      }
      const unsigned valid32 = __ballot_sync(0xffffffffu, ok);
      const int tend = min(bt, t32 + 32);
      for (int t0 = t32; t0 < tend; t0 += kTile) {
        const unsigned mask = (valid32 >> (t0 - t32)) & ((1u << kTile) - 1u);
        if (mask == 0u) continue;
        // every K/V row of the tile is requested before any is used, with
        // no branch between the loads, so that they are all in flight at
        // once (a row past the block's end, or a lane past D, reads an
        // address inside the block and is dropped); an invalid position's
        // row (a stale or unwritten slot of a mapped block) is zeroed, the
        // fused token's replaced by k_new / v_new
        RawVec<KV, VPL> rk[kTile], rv[kTile];
        float ks[kTile], vs[kTile];  // int8: the positions' scales
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const size_t t = base + min(t0 + i, tend - 1);
          const size_t r = t * D + (has ? c0 : 0);
          rk[i] = load_raw<KV, VPL>(k + r);
          rv[i] = load_raw<KV, VPL>(v + r);
          const bool fresh = t0 + i == hit;
          ks[i] = ksc == nullptr ? 1.f : (fresh ? kns : __ldg(ksc + t));
          vs[i] = ksc == nullptr ? 1.f : (fresh ? vns : __ldg(vsc + t));
        }
        float kr[kTile][VPL], vr[kTile][VPL];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          unpack<KV, VPL>(rk[i], kr[i]);
          unpack<KV, VPL>(rv[i], vr[i]);
          const bool use = has && ((mask >> i) & 1u);
          const bool fresh = t0 + i == hit;
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            kr[i][j] = fresh ? kn[j] : (use ? kr[i][j] : 0.f);
            vr[i][j] = fresh ? vn[j] : (use ? vr[i][j] : 0.f);
          }
        }
        float s[G][kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float a = 0.f;
#pragma unroll
            for (int j = 0; j < VPL; ++j) a = fmaf(qr[g][j], kr[i][j], a);
            s[g][i] = a;
          }
        }
        // the G * kTile warp sums, one shuffle round at a time for all of
        // them, so that their shuffles overlap instead of chaining
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int i = 0; i < kTile; ++i)
#pragma unroll
            for (int g = 0; g < G; ++g)
              s[g][i] += __shfl_xor_sync(0xffffffffu, s[g][i], o);
        if (ksc != nullptr) {  // s = (q . k_int) * ks
#pragma unroll
          for (int i = 0; i < kTile; ++i)
#pragma unroll
            for (int g = 0; g < G; ++g) s[g][i] *= ks[i];
        }
        if (cap > 0.f) {
#pragma unroll
          for (int i = 0; i < kTile; ++i)
#pragma unroll
            for (int g = 0; g < G; ++g) s[g][i] = cap * tanhf(s[g][i] / cap);
        }
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (!((mask >> i) & 1u)) s[g][i] = REPRO_NEG_INF;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float tmax = REPRO_NEG_INF;
#pragma unroll
          for (int i = 0; i < kTile; ++i) tmax = fmaxf(tmax, s[g][i]);
          const float m_new = fmaxf(m_run[g], tmax);  // a real score
          const float corr =
              m_run[g] <= REPRO_NEG_INF / 2 ? 0.f : expf(m_run[g] - m_new);
          float lsum = 0.f;
#pragma unroll
          for (int i = 0; i < kTile; ++i) {
            const float e = ((mask >> i) & 1u) ? expf(s[g][i] - m_new) : 0.f;
            s[g][i] = e;
            lsum += e;
          }
          l_run[g] = l_run[g] * corr + lsum;
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            float a = acc[g][j] * corr;
#pragma unroll
            for (int i = 0; i < kTile; ++i)
              a = fmaf(s[g][i] * vs[i], vr[i][j], a);
            acc[g][j] = a;
          }
          m_run[g] = m_new;
        }
      }
    }
  }

  // merge the warps' states in warp order, one thread per (head, column)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sm_m[warp][g] = m_run[g];
      sm_l[warp][g] = l_run[g];
    }
  }
  if (has) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        sm_acc[(warp * G + g) * D + c0 + j] = acc[g][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float M = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float a = 0.f, ls = 0.f;
    if (M > REPRO_NEG_INF / 2) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (sm_m[w][g] > REPRO_NEG_INF / 2) {
          const float c = expf(sm_m[w][g] - M);
          a += c * sm_acc[(w * G + g) * D + d];
          ls += c * sm_l[w][g];
        }
      }
    }
    const size_t r = (static_cast<size_t>(b) * H + hk * G + g) * nsplit + sp;
    po[r * D + d] = a;
    if (d == 0) {
      pm[r] = M;  // the chunk's true max; the sentinel when nothing is valid
      pl[r] = ls;
    }
  }
}

__global__ void paged_combine_kernel(const float* __restrict__ po,
                                     const float* __restrict__ pm,
                                     const float* __restrict__ pl,
                                     float* __restrict__ o,
                                     float* __restrict__ m,
                                     float* __restrict__ l, int nsplit,
                                     int D) {
  combine_partials_row(po, pm, pl, o, m, l, nsplit, D);
}

// The int8 scales of the arena and of the fresh token (all null for an
// unquantized arena).
struct Scales {
  const float* ks;
  const float* vs;
  const float* ksn;
  const float* vsn;
};

template <typename T, int G, int VPL>
int launch(const void* q, const void* k, const void* v, const int* slot_pos,
           const int* pt, const int* pos, const void* k_new,
           const void* v_new, Scales sc, float* po, float* pm, float* pl,
           float* o, float* m, float* l, int B, int H, int Hkv, int NB1,
           int bt, int D, int MB, int chunk, float scale, float cap,
           int window, cudaStream_t st) {
  const int nsplit = (MB + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * kWarps * G * D;
  const dim3 grid(nsplit, Hkv, B);
  if (sc.ks != nullptr)
    paged_chunk_kernel<T, signed char, G, VPL><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const signed char*>(k),
        static_cast<const signed char*>(v), slot_pos, pt, pos,
        static_cast<const signed char*>(k_new),
        static_cast<const signed char*>(v_new), sc.ks, sc.vs, sc.ksn, sc.vsn,
        po, pm, pl, H, Hkv, NB1, bt, D, MB, chunk, scale, cap, window);
  else
    paged_chunk_kernel<T, T, G, VPL><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), slot_pos, pt, pos,
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), nullptr,
        nullptr, nullptr, nullptr, po, pm, pl, H, Hkv, NB1, bt, D, MB, chunk,
        scale, cap, window);
  paged_combine_kernel<<<B * H, kCombineThreads, 0, st>>>(po, pm, pl, o, m,
                                                          l, nsplit, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_vpl(int vpl, const void* q, const void* k, const void* v,
               const int* slot_pos, const int* pt, const int* pos,
               const void* k_new, const void* v_new, Scales sc, float* po,
               float* pm,
               float* pl, float* o, float* m, float* l, int B, int H,
               int Hkv, int NB1, int bt, int D, int MB, int chunk,
               float scale, float cap, int window, cudaStream_t st) {
#define REPRO_PAGED_ARGS                                                   \
  q, k, v, slot_pos, pt, pos, k_new, v_new, sc, po, pm, pl, o, m, l, B, H, \
      Hkv, NB1, bt, D, MB, chunk, scale, cap, window, st
  switch (vpl) {
    case 1: return launch<T, G, 1>(REPRO_PAGED_ARGS);
    case 2: return launch<T, G, 2>(REPRO_PAGED_ARGS);
    case 4: return launch<T, G, 4>(REPRO_PAGED_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_g(int G, int vpl, const void* q, const void* k, const void* v,
             const int* slot_pos, const int* pt, const int* pos,
             const void* k_new, const void* v_new, Scales sc, float* po,
             float* pm,
             float* pl, float* o, float* m, float* l, int B, int H, int Hkv,
             int NB1, int bt, int D, int MB, int chunk, float scale,
             float cap, int window, cudaStream_t st) {
  switch (G) {
    case 1: return launch_vpl<T, 1>(vpl, REPRO_PAGED_ARGS);
    case 2: return launch_vpl<T, 2>(vpl, REPRO_PAGED_ARGS);
    case 4: return launch_vpl<T, 4>(vpl, REPRO_PAGED_ARGS);
    case 8: return launch_vpl<T, 8>(vpl, REPRO_PAGED_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef REPRO_PAGED_ARGS

// ----------------------------------------------------- bf16 body (tensor cores)

using decode_tile::bf16;
using decode_tile::kSlots;
constexpr int kTcThreads = decode_tile::kThreads;  // 4 warps
constexpr long long kUnmapped = -1;   // src_s: a position of no mapped block
constexpr long long kFresh = -2;      // src_s: the fused token's position

// DP: D rounded up to 32, 64, 128 or 256; the shared columns past D are
// zero-filled by the copies.  Q8: an int8 arena with its scales (sc),
// else bf16.
template <int DP, bool Q8>
__global__ void __launch_bounds__(kTcThreads)
    paged_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ kp,
                    const void* __restrict__ vp,
                    const int* __restrict__ slot_pos,
                    const int* __restrict__ pt,
                    const int* __restrict__ pos_arr,
                    const void* __restrict__ knp,
                    const void* __restrict__ vnp, Scales sc,
                    float* __restrict__ po, float* __restrict__ pm,
                    float* __restrict__ pl, int H, int Hkv, int NB1, int bt,
                    int D, int MB, float scale, float cap, int window) {
  using Tile = decode_tile::Tile<DP>;
  using KV = typename std::conditional<Q8, signed char, bf16>::type;
  const KV* __restrict__ k = static_cast<const KV*>(kp);
  const KV* __restrict__ v = static_cast<const KV*>(vp);
  const KV* __restrict__ k_new = static_cast<const KV*>(knp);
  const KV* __restrict__ v_new = static_cast<const KV*>(vnp);
  constexpr int LD = Tile::LD, CH = Tile::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long src_s[kSlots];  // a position's K/V row (elements)
  __shared__ unsigned char ok_s[kSlots];
  __shared__ float ks_s[kSlots], vs_s[kSlots];  // Q8: the tile's scales
  const int G = H / Hkv, GP = (G + 15) / 16 * 16;
  const Tile tl(smem_raw, GP);
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv, sp = blockIdx.y;
  const int nsplit = gridDim.y;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * H + hk * G;  // (b, 1st head)
  const int ring = MB * bt;
  const int p = pos_arr[b];

  // thread j < 64 owns logical position sp*64 + j: its page-table entry,
  // then its slot_pos (loaded now, used after the K copies are issued)
  bool mapped = false;
  int spos = -1;
  float kscale = 0.f, vscale = 0.f;  // Q8: this position's scales
  if (tid < kSlots) {
    const int t = sp * kSlots + tid;
    long long src = kUnmapped;
    if (t < ring) {
      const int lb = t / bt, off = t - lb * bt;
      const int pb = pt[static_cast<size_t>(b) * MB + lb];
      if (pb >= 0) {
        mapped = true;
        if (k_new != nullptr && t == p % ring) {
          src = kFresh;
          spos = p;
          if (Q8) {
            kscale = sc.ksn[static_cast<size_t>(b) * Hkv + hk];
            vscale = sc.vsn[static_cast<size_t>(b) * Hkv + hk];
          }
        } else {
          const long long row = (static_cast<long long>(hk) * NB1 + pb) * bt +
                                off;
          src = row * D;
          spos = slot_pos[static_cast<size_t>(pb) * bt + off];
          if (Q8) {
            kscale = sc.ks[row];
            vscale = sc.vs[row];
          }
        }
      }
    }
    src_s[tid] = src;
    ks_s[tid] = kscale;
  }
  if (!__syncthreads_or(mapped)) {
    // no mapped position: the sentinel max and nothing else
    decode_tile::write_empty(pm, pl, row0, G, nsplit, sp);
    return;
  }
  // Q and the K rows of every mapped position, in flight while slot_pos
  // lands; rows past G, unmapped positions and padding columns are
  // zero-filled without a read
  const int dch = D / 8;
  const uint64_t pol = l2_evict_first();
  const size_t nrow = (static_cast<size_t>(b) * Hkv + hk) * D;  // k_new row
  for (int i = tid; i < GP * CH; i += kTcThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = r < G && c < dch;
    cp_async16(tl.qs + r * LD + c * 8, q + (in ? (row0 + r) * D + c * 8 : 0),
               in);
  }
  for (int i = tid; i < kSlots * CH; i += kTcThreads) {
    const int j = i / CH, c = i % CH;
    const long long s = src_s[j];
    const bool in = s != kUnmapped && c < dch;
    const KV* src = s == kFresh ? k_new + nrow : k + (s >= 0 ? s : 0);
    if constexpr (Q8)  // int8 rows widened to bf16 on the way into the tile
      decode_tile::stage_i8(tl.ks + j * LD + c * 8, src + (in ? c * 8 : 0),
                            in);
    else
      cp_async16(tl.ks + j * LD + c * 8, src + (in ? c * 8 : 0), in, pol);
  }
  cp_async_commit();
  bool ok = false;
  if (tid < kSlots) {
    ok = mapped && spos >= 0 && spos <= p &&
         (window <= 0 || spos > p - window);
    ok_s[tid] = ok;
    vs_s[tid] = ok ? vscale : 0.f;
  }
  if (!__syncthreads_or(ok)) {
    cp_async_wait<0>();  // nothing valid: drain the K copies, then leave
    decode_tile::write_empty(pm, pl, row0, G, nsplit, sp);
    return;
  }
  // V rows of the valid positions only; the others zero-filled, unread
  for (int i = tid; i < kSlots * CH; i += kTcThreads) {
    const int j = i / CH, c = i % CH;
    const long long s = src_s[j];
    const bool in = ok_s[j] && c < dch;
    const KV* src = s == kFresh ? v_new + nrow : v + (s >= 0 ? s : 0);
    if constexpr (Q8)
      decode_tile::stage_i8(tl.vs + j * LD + c * 8, src + (in ? c * 8 : 0),
                            in);
    else
      cp_async16(tl.vs + j * LD + c * 8, src + (in ? c * 8 : 0), in, pol);
  }
  cp_async_commit();
  decode_tile::attend<DP>(tl, ok_s, G, D, scale, cap, po, pm, pl, row0,
                          nsplit, sp, Q8 ? ks_s : nullptr,
                          Q8 ? vs_s : nullptr);
}

template <int DP, bool Q8>
int launch_tc(const void* q, const void* k, const void* v,
              const int* slot_pos, const int* pt, const int* pos,
              const void* k_new, const void* v_new, Scales sc, float* po,
              float* pm, float* pl, float* o, float* m, float* l, int B,
              int H, int Hkv, int NB1, int bt, int D, int MB, int nsplit,
              float scale, float cap, int window, cudaStream_t st) {
  const int G = H / Hkv;
  const size_t smem = decode_tile::smem_bytes((G + 15) / 16 * 16, DP);
  const cudaError_t err = cudaFuncSetAttribute(
      paged_tc_kernel<DP, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the chunk is the slowest grid dimension: the low chunks, busy in every
  // row, are dispatched first and the empty ones after
  const dim3 grid(B * Hkv, nsplit);
  paged_tc_kernel<DP, Q8><<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), k, v, slot_pos, pt, pos, k_new, v_new, sc,
      po, pm, pl, H, Hkv, NB1, bt, D, MB, scale, cap, window);
  paged_combine_kernel<<<B * H, kCombineThreads, 0, st>>>(po, pm, pl, o, m,
                                                          l, nsplit, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The chunks of a row, each a block of the first launch whose partials the
// combine merges: f32, kChunk logical blocks; bf16, one tile of kSlots
// logical positions.  0 when the dtype is not taken.
extern "C" int paged_gqa_decode_splits(int dtype, int MB, int bt) {
  if (dtype == DT_F32) return (MB + kChunk - 1) / kChunk;
  if (dtype == DT_BF16) return (MB * bt + kSlots - 1) / kSlots;
  return 0;
}

// q (B,H,D); k, v (Hkv, NB1, bt, D) of one dtype (one layer's arena,
// NB1 = NB + 1 with the trash block last), or int8 with their scales
// ks, vs (Hkv, NB1, bt) f32 (null for an unquantized arena); slot_pos
// (NB1, bt), pt (B, MB) and pos (B,) int32; k_new, v_new (B, Hkv, D) in
// the arena dtype or null (unfused), with, for int8, ksn, vsn (B, Hkv)
// f32; po (B,H,nsplit,D), pm/pl (B,H,nsplit) f32 scratch with
// nsplit = paged_gqa_decode_splits(dtype, MB, bt); o (B,H,D), m/l (B,H)
// f32 outputs.  cap <= 0 disables the softcap, window <= 0 the window.
// bf16: any G = H / Hkv, D a multiple of 8 up to 256, 16-byte aligned
// rows (int8: 8-byte).  f32: G in {1, 2, 4, 8}, vpl = D columns per lane
// in {1, 2, 4} with D <= 32 * vpl and D % vpl == 0.
extern "C" int paged_gqa_decode_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* slot_pos, const void* pt, const void* pos, const void* k_new,
    const void* v_new, const float* ks, const float* vs, const float* ksn,
    const float* vsn, float* po, float* pm, float* pl, float* o, float* m,
    float* l, int B, int H, int Hkv, int NB1, int bt, int D, int MB, int vpl,
    float scale, float cap, int window, void* stream) {
  const int nsplit = paged_gqa_decode_splits(dtype, MB, bt);
  if (nsplit < 1 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool q8 = ks != nullptr;
  if (q8 != (vs != nullptr) ||
      (q8 && k_new != nullptr && (ksn == nullptr || vsn == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scales sc{ks, vs, ksn, vsn};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const int*>(slot_pos);
  const auto* ptp = static_cast<const int*>(pt);
  const auto* ps = static_cast<const int*>(pos);
  if (dtype == DT_F32)
    return launch_g<float>(H / Hkv, vpl, q, k, v, sp, ptp, ps, k_new, v_new,
                           sc, po, pm, pl, o, m, l, B, H, Hkv, NB1, bt, D,
                           MB, kChunk, scale, cap, window, st);
  if (D % 8 || D > 256 || nsplit > 65535)  // nsplit: the grid's y dimension
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_PAGED_TC(DP)                                                  \
  (q8 ? launch_tc<DP, true>(q, k, v, sp, ptp, ps, k_new, v_new, sc, po, pm, \
                            pl, o, m, l, B, H, Hkv, NB1, bt, D, MB, nsplit, \
                            scale, cap, window, st)                         \
      : launch_tc<DP, false>(q, k, v, sp, ptp, ps, k_new, v_new, sc, po,   \
                             pm, pl, o, m, l, B, H, Hkv, NB1, bt, D, MB,    \
                             nsplit, scale, cap, window, st))
  if (D <= 32) return REPRO_PAGED_TC(32);
  if (D <= 64) return REPRO_PAGED_TC(64);
  if (D <= 128) return REPRO_PAGED_TC(128);
  return REPRO_PAGED_TC(256);
#undef REPRO_PAGED_TC
}
