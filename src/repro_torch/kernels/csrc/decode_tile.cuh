// The bf16 tile body of the port's GQA decode kernels on the tensor cores,
// shared by gqa_decode.cu (a dense ring) and paged_decode.cu (the
// block-paged arena).  The two differ only in how a block finds and stages
// its rows; from the staged tile on they run this code.
//
// A block of 4 warps takes the G = H/Hkv query heads of one kv head over
// one tile of 64 positions.  The caller stages, by 16-byte cp.async:
//   qs [GP][LD]  the group's queries, rows past G zero-filled,
//   ks [64][LD]  the tile's K rows,
//   vs [64][LD]  the tile's V rows, zero-filled where a position is not
//                valid (P is 0 there, and 0 * NaN would not be),
// with LD = DP + kPad and the columns past D (Dv) zero-filled, in two
// commit groups: Q and K first, then V; and ok_s[64], the validity of each
// position.  A K row of an invalid position may hold anything: its score
// is replaced by the mask, never used in arithmetic.
//
// Each warp scores 16 positions for 16 heads at a time on mma.sync
// m16n8k16 (Q and K through ldmatrix, f32 accumulators), applies scale,
// then softcap, then the mask (p = 0 exactly on an invalid position), and
// writes its scores to the shared f32 tile ps [16][kLdP]; 8 threads per
// head then take the tile's max, exponentials and sum.  P.V runs on the
// tensor cores with P split into hi = bf16(P) and lo = bf16(P - hi), both
// multiplied, so P keeps ~16 bits (the Pallas kernels keep P in f32); each
// warp owns a quarter of the Dv columns, V through ldmatrix.trans.  G > 16
// loops over head tiles.  The tile's partials go to po (B*H, nsplit, Dv),
// pm / pl (B*H, nsplit) at chunk `sp`: pm the tile's true max (the
// sentinel when nothing is valid), pl its sum.
//
// int8 KV: the caller stages the int8 rows as bf16 (exact: |q| <= 127;
// stage_i8), synchronously, and the tile's per-position f32 scales in
// shared memory (ksc, vsc; 0 where a position is not valid).  The scores
// become s = (q . k_int) * scale * ks, and each probability is multiplied
// by its vs before the hi + lo split, so P.V sums p * vs * v_int; l sums
// the unscaled p, as the Pallas kernels do.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace decode_tile {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;      // 4 warps, 16 positions of the tile each
constexpr int kSlots = 64;         // positions per tile
constexpr int kPad = 8;            // bf16 elements of padding per shared row
constexpr int kLdP = kSlots + 8;   // f32 row stride of the score tile

// Dynamic shared memory of a block: Q, K, V, then the score tile.  GP: the
// heads rounded up to 16; DP: the padded head width (32, 64, 128 or 256).
inline size_t smem_bytes(int GP, int DP) {
  return sizeof(bf16) * static_cast<size_t>(GP + 2 * kSlots) * (DP + kPad) +
         sizeof(float) * 16 * kLdP;
}

// The tile's query, key and value rows and its score tile, carved out of
// the block's dynamic shared memory.
template <int DP>
struct Tile {
  static constexpr int LD = DP + kPad;  // row stride of Q, K and V
  static constexpr int CH = DP / 8;     // 16-byte chunks of a padded row
  bf16* qs;
  bf16* ks;
  bf16* vs;
  float* ps;
  __device__ Tile(unsigned char* raw, int GP)
      : qs(reinterpret_cast<bf16*>(raw)),
        ks(qs + GP * LD),
        vs(ks + kSlots * LD),
        ps(reinterpret_cast<float*>(vs + kSlots * LD)) {}
};

// Eight int8 values at `src` (8-byte aligned) as bf16 into shared `dst`,
// or eight zeros without a read when `in` is false.
__device__ __forceinline__ void stage_i8(bf16* dst, const signed char* src,
                                         bool in) {
  *reinterpret_cast<uint4*>(dst) =
      in ? i8x8_to_bf16x8(*reinterpret_cast<const uint2*>(src))
         : make_uint4(0u, 0u, 0u, 0u);
}

// The tile's partials for every head of the group (see the header); waits
// for the caller's two cp.async groups itself.  ksc / vsc: the int8 tile's
// per-position scales in shared memory, or null.
template <int DP>
__device__ __forceinline__ void attend(const Tile<DP>& tl,
                                       const unsigned char* ok_s, int G,
                                       int Dv, float scale, float cap,
                                       float* __restrict__ po,
                                       float* __restrict__ pm,
                                       float* __restrict__ pl, size_t row0,
                                       int nsplit, int sp,
                                       const float* ksc = nullptr,
                                       const float* vsc = nullptr) {
  constexpr int LD = Tile<DP>::LD;
  constexpr int KD = DP / 16;     // k16 steps of Q.K^T
  constexpr int NT = DP / 32;     // n8 output tiles of each warp
  const bf16* qs = tl.qs;
  const bf16* ks = tl.ks;
  const bf16* vs = tl.vs;
  float* ps = tl.ps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  cp_async_wait<1>();  // Q and K have landed
  __syncthreads();

  for (int h0 = 0; h0 < G; h0 += 16) {
    // S = Q.K^T: heads h0..h0+15 against this warp's 16 positions
    float sacc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[4], kf[4];
      ldmatrix_x4(qf, qs + (h0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(kf, ks + (warp * 16 + (mi >> 1) * 8 + (lane & 7)) * LD +
                          kk * 16 + (mi & 1) * 8);
      mma_bf16(sacc[0], qf, kf[0], kf[1]);
      mma_bf16(sacc[1], qf, kf[2], kf[3]);
    }
    // scale, softcap, then mask, into the shared score tile
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int slot = warp * 16 + j * 8 + 2 * t;
        float s[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sacc[j][2 * r + e] * scale;
          if (ksc != nullptr) x *= ksc[slot + e];
          if (cap > 0.f) x = cap * tanhf(x / cap);
          s[e] = ok_s[slot + e] ? x : REPRO_NEG_INF;
        }
        *reinterpret_cast<float2*>(ps + (g + 8 * r) * kLdP + slot) =
            make_float2(s[0], s[1]);
      }
    }
    __syncthreads();
    // the tile's max, exponentials and sum: 8 threads per head, 8
    // positions each
    {
      const int r = tid >> 3, j8 = tid & 7;
      float4* pr = reinterpret_cast<float4*>(ps + r * kLdP + j8 * 8);
      float x[8];
      *reinterpret_cast<float4*>(x) = pr[0];
      *reinterpret_cast<float4*>(x + 4) = pr[1];
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int e = 0; e < 8; ++e) mx = fmaxf(mx, x[e]);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_safe = mx <= REPRO_NEG_INF / 2 ? 0.f : mx;
      float l = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = x[e] > REPRO_NEG_INF / 2 ? expf(x[e] - m_safe) : 0.f;
        l += x[e];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      pr[0] = *reinterpret_cast<const float4*>(x);
      pr[1] = *reinterpret_cast<const float4*>(x + 4);
      if (j8 == 0 && h0 + r < G) {
        pm[(row0 + h0 + r) * nsplit + sp] = mx;  // the tile's true max
        pl[(row0 + h0 + r) * nsplit + sp] = l;
      }
    }
    cp_async_wait<0>();  // V has landed
    __syncthreads();
    // O += P.V with P split into hi + lo; this warp's n8 tiles are warp,
    // warp + 4, ...
    float oacc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
      oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < kSlots / 32; ++k2) {  // 32 positions at a time
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int c = k2 * 32 + kk * 16 + 2 * t;
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // a0..a3: rows g / g+8, cols c / c+8
          const int pc = c + 8 * (f >> 1);
          float2 x = *reinterpret_cast<const float2*>(
              ps + (g + 8 * (f & 1)) * kLdP + pc);
          if (vsc != nullptr) {  // fold v_scale into P
            x.x *= vsc[pc];
            x.y *= vsc[pc + 1];
          }
          split_bf16(x.x, x.y, ah[kk][f], al[kk][f]);
        }
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        // matrix m of the x4 holds positions k2*32 + 8m .. +7: b0, b1 of
        // the first k16 step, then of the second
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (k2 * 32 + lane) * LD + (warp + 4 * i) * 8);
        mma_bf16(oacc[i], ah[0], vf[0], vf[1]);
        mma_bf16(oacc[i], al[0], vf[0], vf[1]);
        mma_bf16(oacc[i], ah[1], vf[2], vf[3]);
        mma_bf16(oacc[i], al[1], vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int col = (warp + 4 * i) * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = h0 + g + 8 * r;
        if (col < Dv && h < G)
          *reinterpret_cast<float2*>(po + ((row0 + h) * nsplit + sp) * Dv +
                                     col) =
              make_float2(oacc[i][2 * r], oacc[i][2 * r + 1]);
      }
    }
    __syncthreads();  // the score tile is rewritten by the next head tile
  }
}

// A tile with no valid position: the sentinel max and nothing else (the
// merge skips its o_unnorm).
__device__ __forceinline__ void write_empty(float* __restrict__ pm,
                                            float* __restrict__ pl,
                                            size_t row0, int G, int nsplit,
                                            int sp) {
  for (int i = threadIdx.x; i < G; i += kThreads) {
    pm[(row0 + i) * nsplit + sp] = REPRO_NEG_INF;
    pl[(row0 + i) * nsplit + sp] = 0.f;
  }
}

}  // namespace decode_tile
