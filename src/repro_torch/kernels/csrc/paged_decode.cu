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
// An unmapped logical block is skipped whole and none of its bytes are
// loaded; the trash block (index NB, the scatter target of unmapped rows)
// is therefore never read.
//
// Fused decode-write epilogue: given the fresh token k_new/v_new
// (B, Hkv, D) in the arena dtype, the row's token at ring position
// i = pos % (MB*bt) replaces position i % bt of logical block i / bt in
// registers, before any score math, when that block is mapped; its
// slot_pos reads as pos.  Attention over the un-written arena then equals
// attention after the scatter bit for bit (the Python wrapper performs the
// scatter right after, on the same stream).
//
// Bound on the H100: the K and V bytes of the mapped blocks, each read
// once (mapped*Hkv*bt*2D*2 in bf16; about 18 MB for 8 rows of ~700
// tokens of mixtral, ~5.5 us at 3.35 TB/s), plus slot_pos, q and the
// f32 partials.  Its 4*valid*H*D operations are far below the card's
// rate, so it is bound by bytes.
//
// Design, and how it differs from csrc/gqa_decode.cu.  As there, a block
// takes one (chunk of logical blocks, kv head, row), so a batch of 8 rows
// still fills the SMs, the G = H/Hkv query heads of the group share every
// K/V row, and a second, fixed-order launch merges the chunks' partials.
// The dense kernel was bound by its block's serial phases: one warp per
// slot and a block-wide barrier between scores, softmax and the V sum.
// Here each warp of the block walks its own logical blocks and keeps its
// own running (max, sum, accumulator) in registers, so the main loop has
// no barrier and no shared-memory score array.  Per logical block the
// warp reads the validity of up to 32 positions with one slot_pos load and
// one ballot; per tile of 8 positions that holds a valid one, it issues
// every K and V load of the tile back to back, with no branch between them
// (lanes across D, each lane a contiguous vector of D/32 elements; a row
// past the block's end reads inside the block and is dropped), so that
// the 16 loads are in flight together, and only then converts them and
// computes the scores, the tile's online-softmax update and the V sum.
// A load inside a per-row branch, followed in the same branch by its use,
// made the warp wait for each row in turn: 16 round trips to memory per
// tile, which set the time of the first design (PERF.md).  The
// warps' states merge once, through shared memory, at the end.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;        // positions per register tile
constexpr int kMaxChunk = 64;   // logical blocks per thread block, at most

template <int N>
struct Raw;
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

template <typename T, int G, int VPL>
__global__ void __launch_bounds__(kThreads)
    paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ slot_pos,
                       const int* __restrict__ pt,
                       const int* __restrict__ pos_arr,
                       const T* __restrict__ k_new,
                       const T* __restrict__ v_new, float* __restrict__ po,
                       float* __restrict__ pm, float* __restrict__ pl,
                       int H, int Hkv, int NB1, int bt, int D, int MB,
                       int chunk, float scale, float cap, int window) {
  __shared__ int pts[kMaxChunk];
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
#pragma unroll
  for (int j = 0; j < VPL; ++j) kn[j] = vn[j] = 0.f;
  if (k_new != nullptr) {
    const int i = p % (MB * bt);
    tgt_lb = i / bt;
    tgt_off = i % bt;
    if (has) {
      const size_t r = (static_cast<size_t>(b) * Hkv + hk) * D + c0;
      load_vec<T, VPL>(k_new + r, kn);
      load_vec<T, VPL>(v_new + r, vn);
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
        RawVec<T, VPL> rk[kTile], rv[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const size_t r = (base + min(t0 + i, tend - 1)) * D + (has ? c0 : 0);
          rk[i] = load_raw<T, VPL>(k + r);
          rv[i] = load_raw<T, VPL>(v + r);
        }
        float kr[kTile][VPL], vr[kTile][VPL];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          unpack<T, VPL>(rk[i], kr[i]);
          unpack<T, VPL>(rv[i], vr[i]);
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
            for (int i = 0; i < kTile; ++i) a = fmaf(s[g][i], vr[i][j], a);
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

template <typename T, int G, int VPL>
int launch(const void* q, const void* k, const void* v, const int* slot_pos,
           const int* pt, const int* pos, const void* k_new,
           const void* v_new, float* po, float* pm, float* pl, float* o,
           float* m, float* l, int B, int H, int Hkv, int NB1, int bt, int D,
           int MB, int chunk, float scale, float cap, int window,
           cudaStream_t st) {
  const int nsplit = (MB + chunk - 1) / chunk;
  const size_t smem = sizeof(float) * kWarps * G * D;
  const dim3 grid(nsplit, Hkv, B);
  paged_chunk_kernel<T, G, VPL><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), slot_pos, pt, pos,
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), po, pm,
      pl, H, Hkv, NB1, bt, D, MB, chunk, scale, cap, window);
  paged_combine_kernel<<<B * H, 128, 0, st>>>(po, pm, pl, o, m, l, nsplit,
                                              D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_vpl(int vpl, const void* q, const void* k, const void* v,
               const int* slot_pos, const int* pt, const int* pos,
               const void* k_new, const void* v_new, float* po, float* pm,
               float* pl, float* o, float* m, float* l, int B, int H,
               int Hkv, int NB1, int bt, int D, int MB, int chunk,
               float scale, float cap, int window, cudaStream_t st) {
#define REPRO_PAGED_ARGS                                                   \
  q, k, v, slot_pos, pt, pos, k_new, v_new, po, pm, pl, o, m, l, B, H, Hkv, \
      NB1, bt, D, MB, chunk, scale, cap, window, st
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
             const void* k_new, const void* v_new, float* po, float* pm,
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

}  // namespace

// q (B,H,D); k, v (Hkv, NB1, bt, D) of one dtype (one layer's arena,
// NB1 = NB + 1 with the trash block last); slot_pos (NB1, bt), pt (B, MB)
// and pos (B,) int32; k_new, v_new (B, Hkv, D) in the arena dtype or null
// (unfused); po (B,H,nsplit,D), pm/pl (B,H,nsplit) f32 scratch with
// nsplit = ceil(MB / chunk), chunk <= 64; o (B,H,D), m/l (B,H) f32
// outputs.  G = H / Hkv in {1, 2, 4, 8}; vpl = D columns per lane in
// {1, 2, 4} with D <= 32 * vpl and D % vpl == 0.  cap <= 0 disables the
// softcap, window <= 0 the window.
extern "C" int paged_gqa_decode_launch(
    int dtype, const void* q, const void* k, const void* v,
    const void* slot_pos, const void* pt, const void* pos, const void* k_new,
    const void* v_new, float* po, float* pm, float* pl, float* o, float* m,
    float* l, int B, int H, int Hkv, int NB1, int bt, int D, int MB,
    int chunk, int vpl, float scale, float cap, int window, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  const auto* sp = static_cast<const int*>(slot_pos);
  const auto* ptp = static_cast<const int*>(pt);
  const auto* ps = static_cast<const int*>(pos);
  if (dtype == DT_F32)
    return launch_g<float>(G, vpl, q, k, v, sp, ptp, ps, k_new, v_new, po,
                           pm, pl, o, m, l, B, H, Hkv, NB1, bt, D, MB, chunk,
                           scale, cap, window, st);
  if (dtype == DT_BF16)
    return launch_g<__nv_bfloat16>(G, vpl, q, k, v, sp, ptp, ps, k_new,
                                   v_new, po, pm, pl, o, m, l, B, H, Hkv, NB1,
                                   bt, D, MB, chunk, scale, cap, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
