// Flash attention for prefill on Hopper, causal or not.  Replaces the
// Pallas TPU kernel repro/kernels/flash_prefill.py::flash_prefill (body
// _kernel).  The non-causal form (whisper's encoder, and its decoder's
// cross-attention: S queries over Skv encoder keys, S = 1 in decode)
// masks by kv_len alone; nothing in it assumes queries and keys aligned.
//
// What it computes: grouped-query attention of q (B,S,H,D) against
// k/v (B,Skv,Hkv,D/Dv), the KV head of query head h being h / (H/Hkv):
// scores softcap(scale * q . k), masked to kv positions < kv_len[b] and,
// when causal, to positions <= the query's (and > query - window when a
// window is set); output the softmax-weighted V sum, normalized, in q's
// dtype.  The online softmax keeps the TPU kernel's running triple
// (m_safe, l, acc) in f32, so rows with context match
// models.common.chunked_attention; a row with no valid key gives 0.
//
// Bound on the H100: operations, about 4*B*H*S^2*D/2 for a causal prompt
// (each query against the keys up to its own position); its bytes (q, k,
// v read once, o written once) are small beside them.
//
// Two bodies, chosen by dtype:
//
// bf16 (the served type): tensor cores, FlashAttention-2 style.  A block
// of 4 warps takes 64 consecutive query positions of one (batch, query
// head) -- the heads of a GQA group are not packed into the tile; they
// read the same K/V through L2 -- and each warp owns 16 of those rows.
// K/V tiles of 64 keys are staged in shared memory in bf16 by 16-byte
// cp.async, double-buffered (tile j+1 loads while tile j computes), rows
// padded by 16 bytes so that ldmatrix is free of bank conflicts; rows past
// Skv are zero-filled by the copy, the contraction past D (and Dv) is zero
// padded to the template width.  S = Q.K^T runs on mma.sync m16n8k16 with
// the Q fragments held in registers for the whole key loop; the online
// softmax runs in registers on the accumulator fragment (row max and sum
// across the 4 lanes of a quad); P is rounded to bf16 in registers and is
// the A operand of P.V, whose V fragments come from ldmatrix.trans; O
// accumulates in f32 registers, is normalized once and leaves through
// shared memory as 16-byte stores.  Masking (kv_len, causal, window) is
// applied in the fragment, after the softcap; tiles wholly outside the
// causal/window range are never loaded, and a warp whose 16 rows all lie
// outside a loaded tile skips its products.  The heaviest causal query
// tiles are launched first.  Takes D % 8 == 0, D <= 256, Dv % 8 == 0,
// Dv <= 256 (the wrapper raises otherwise).  At D 192 / Dv 128 ptxas
// (-Xptxas -v) gives 241 registers a thread and no spills, 221 at D 128,
// so two blocks fit an SM.
//
// Wide heads (D > 192 or Dv > 128: gemma2's D = Dv = 256) take a second
// form of the same body.  Held in registers, the 16 x 256 Q fragments (64
// registers) and the 16 x 256 f32 accumulator (128) would leave too few
// for the 16 x 64 score tile and spill.  So the Q tile stays in shared
// memory and each k16 step of Q.K^T reloads its A fragment by ldmatrix
// (4 registers), at the cost of one shared read of Q per key tile.  The
// block has 8 warps (128 query rows): Q (66 KB) and the double-buffered
// K and V tiles (2 x 2 x 33 KB) take 198 KB of shared memory, one block
// an SM, and 8 warps hide more of the ldmatrix and mma latency than 4.
// Every shape in this range runs the 256 x 256 instance, the contraction
// and the output columns past D and Dv zero padded.
//
// f32: the first design, on CUDA cores, kept so that f32 checks hold to
// 1e-4.  One block of 128 threads takes one (16-query tile, batch*head)
// pair and loops over 32-key tiles, K/V staged as f32 in shared memory,
// each thread forming 4 scores of one row, one thread per row updating
// (m, l), the threads then updating the (16, Dv) accumulator.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ------------------------------------------------------- f32 body (CUDA cores)

constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per block (kThreads / 8)
constexpr int kBK = 32;  // keys per tile (8 threads x 4 scores)

// The log-sum-exp of a row's scores from its running (m_safe, l), which
// the backward (csrc/flash_prefill_bwd.cu) recomputes P from; -inf for a
// row with no valid key.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : -INFINITY;
}

size_t smem_bytes_f32(int D, int Dv) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * (D + 1) +
          static_cast<size_t>(kBK) * Dv + kBQ * kBK +
          static_cast<size_t>(kBQ) * Dv + 3 * kBQ);
}

__global__ void __launch_bounds__(kThreads)
    flash_prefill_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const int* __restrict__ kv_len,
                             float* __restrict__ o,
                             float* __restrict__ lse, int S, int Skv, int H,
                             int Hkv, int D, int Dv, int causal, int window,
                             float scale, float cap) {
  extern __shared__ float sm[];
  const int ldk = D + 1;
  float* qs = sm;                 // [kBQ][ldk]  pre-scaled queries
  float* ks = qs + kBQ * ldk;     // [kBK][ldk]
  float* vs = ks + kBK * ldk;     // [kBK][Dv]
  float* ps = vs + kBK * Dv;      // [kBQ][kBK]  scores, then probabilities
  float* os = ps + kBQ * kBK;     // [kBQ][Dv]   unnormalized output
  float* ms = os + kBQ * Dv;      // [kBQ]       running m_safe
  float* ls = ms + kBQ;           // [kBQ]       running denominator
  float* cs = ls + kBQ;           // [kBQ]       this tile's correction
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, S - q0);
  const int len = min(kv_len[b], Skv);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[r * ldk + d] =
        r < nq ? q[((static_cast<size_t>(b) * S + q0 + r) * H + h) * D + d] *
                     scale
               : 0.f;
  }
  for (int i = tid; i < kBQ * Dv; i += kThreads) os[i] = 0.f;
  if (tid < kBQ) {
    ms[tid] = REPRO_NEG_INF;
    ls[tid] = 0.f;
  }
  int kend = len;
  if (causal) kend = min(kend, q0 + nq);
  int kbeg = 0;
  if (causal && window > 0) kbeg = max(0, q0 - window + 1) / kBK * kBK;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      ks[r * ldk + d] =
          k0 + r < Skv
              ? k[((static_cast<size_t>(b) * Skv + k0 + r) * Hkv + hk) * D +
                  d]
              : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int r = i / Dv, d = i % Dv;
      vs[i] = k0 + r < Skv
                  ? v[((static_cast<size_t>(b) * Skv + k0 + r) * Hkv + hk) *
                          Dv + d]
                  : 0.f;
    }
    __syncthreads();
    {
      const int r = tid >> 3, c = tid & 7;  // query row r, keys c + 8t
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < D; ++d) {
        const float qv = qs[r * ldk + d];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          a[t] = fmaf(qv, ks[(c + 8 * t) * ldk + d], a[t]);
      }
      const int qp = q0 + r;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = c + 8 * t, kp = k0 + j;
        float s = a[t];
        if (cap > 0.f) s = cap * tanhf(s / cap);
        bool ok = r < nq && kp < len;
        if (causal) {
          ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
        }
        ps[r * kBK + j] = ok ? s : REPRO_NEG_INF;
      }
    }
    __syncthreads();
    if (tid < kBQ) {
      float* pr = ps + tid * kBK;
      const float m_prev = ms[tid];
      float m_blk = REPRO_NEG_INF;
      for (int j = 0; j < kBK; ++j) m_blk = fmaxf(m_blk, pr[j]);
      const float m_new = fmaxf(m_prev, m_blk);
      const float m_safe = m_new <= REPRO_NEG_INF / 2 ? 0.f : m_new;
      float l = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = pr[j] > REPRO_NEG_INF / 2 ? expf(pr[j] - m_safe) : 0.f;
        pr[j] = p;
        l += p;
      }
      const float corr =
          m_prev <= REPRO_NEG_INF / 2 ? 0.f : expf(m_prev - m_safe);
      ls[tid] = ls[tid] * corr + l;
      cs[tid] = corr;
      ms[tid] = m_safe;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * Dv; i += kThreads) {
      const int r = i / Dv, d = i % Dv;
      float a = os[i] * cs[r];
      for (int j = 0; j < kBK; ++j) a = fmaf(ps[r * kBK + j], vs[j * Dv + d], a);
      os[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * Dv; i += kThreads) {
    const int r = i / Dv, d = i % Dv;
    o[((static_cast<size_t>(b) * S + q0 + r) * H + h) * Dv + d] =
        os[i] / fmaxf(ls[r], 1e-30f);
  }
  if (lse != nullptr && tid < nq)
    lse[(static_cast<size_t>(b) * H + h) * S + q0 + tid] =
        row_lse(ms[tid], ls[tid]);
}

int launch_f32(const void* q, const void* k, const void* v, const int* kv_len,
               void* o, float* lse, int B, int S, int Skv, int H, int Hkv,
               int D, int Dv, int causal, int window, float scale, float cap,
               cudaStream_t st) {
  const size_t smem = smem_bytes_f32(D, Dv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_prefill_f32_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_len, static_cast<float*>(o), lse, S,
      Skv, H, Hkv, D, Dv, causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------- bf16 body (tensor cores)

using bf16 = __nv_bfloat16;
constexpr int kTcBK = 64;        // keys per tile
constexpr int kPad = 8;          // bf16 elements of padding per shared row

// NW warps take 16 * NW query rows
template <int DP, int DVP, int NW>
constexpr size_t smem_bytes_tc() {
  return sizeof(bf16) *
         (static_cast<size_t>(16 * NW + 2 * kTcBK) * (DP + kPad) +
          2 * static_cast<size_t>(kTcBK) * (DVP + kPad));
}

// `rows` rows of `nch` 16-byte chunks from src (row r at src + r * str)
// into shared dst (row stride ld) by cp.async, NT threads; rows from
// `nvalid` on are zero-filled, chunks from nch to CH (the padding) are left
// alone.
template <int CH, int rows, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld,
                                           const bf16* src, size_t str,
                                           int nvalid, int nch) {
#pragma unroll
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    if (c < nch) {
      const bool in = r < nvalid;
      cp_async16(dst + r * ld + c * 8, src + (in ? r * str : 0) + c * 8, in);
    }
  }
}

// DP / DVP: D / Dv rounded up to the template's width (multiples of 16);
// the shared columns past D / Dv hold zeros.  NW warps of 16 query rows
// each: 4 for D <= 192 and Dv <= 128, which keep the warp's Q fragments
// in registers for the whole key loop, 8 for the wide form, which reloads
// them from shared memory at every k16 step.
template <int DP, int DVP, int NW>
__global__ void __launch_bounds__(NW * 32)
    flash_prefill_tc_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ kv_len,
                            bf16* __restrict__ o,
                            float* __restrict__ lse, int S, int Skv, int H,
                            int Hkv, int D, int Dv, int causal, int window,
                            float scale, float cap) {
  constexpr int LDQ = DP + kPad;   // row stride of Q and K in shared memory
  constexpr int LDV = DVP + kPad;  // row stride of V
  constexpr int KD = DP / 16;      // k16 steps of Q.K^T
  constexpr int NV = DVP / 8;      // n8 tiles of the output
  constexpr int NT = NW * 32;      // threads
  constexpr int BQ = 16 * NW;      // query rows of the block
  constexpr bool QREG = NW == 4;   // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDQ]
  bf16* ks = qs + BQ * LDQ;                      // [2][kTcBK][LDQ]
  bf16* vs = ks + 2 * kTcBK * LDQ;               // [2][kTcBK][LDV]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int nq = min(BQ, S - q0);
  const float cap2 = cap > 0.f ? 2.f / cap : 0.f;  // the softcap's 2 / cap
  const int len = min(kv_len[b], Skv);
  int kend = len;
  if (causal) kend = min(kend, q0 + nq);
  int kbeg = 0;
  if (causal && window > 0) kbeg = max(0, q0 - window + 1) / kTcBK * kTcBK;
  const int dch = D / 8, vch = Dv / 8;  // 16-byte chunks of a row
  const size_t qstr = static_cast<size_t>(H) * D;  // between positions
  const size_t kstr = static_cast<size_t>(Hkv) * D;
  const size_t vstr = static_cast<size_t>(Hkv) * Dv;
  const size_t ostr = static_cast<size_t>(H) * Dv;
  const bf16* qb = q + (static_cast<size_t>(b) * S * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Skv * Hkv + hk) * Dv;
  bf16* ob = o + (static_cast<size_t>(b) * S * H + h) * Dv;

  if (kend <= kbeg) {  // no row of the tile has a valid key: zeros
    for (int i = tid; i < nq * vch; i += NT)
      *reinterpret_cast<uint4*>(ob + (q0 + i / vch) * ostr + i % vch * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    if (lse != nullptr)
      for (int i = tid; i < nq; i += NT)
        lse[static_cast<size_t>(bh) * S + q0 + i] = -INFINITY;
    return;
  }
  // zero the contraction padding (columns D..DP of Q and K, Dv..DVP of
  // V); the copies never write there
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < (BQ + 2 * kTcBK) * (DP / 8); i += NT)
    if (i % (DP / 8) >= dch)
      *reinterpret_cast<uint4*>(qs + i / (DP / 8) * LDQ + i % (DP / 8) * 8) =
          zero;
  for (int i = tid; i < 2 * kTcBK * (DVP / 8); i += NT)
    if (i % (DVP / 8) >= vch)
      *reinterpret_cast<uint4*>(vs + i / (DVP / 8) * LDV + i % (DVP / 8) * 8) =
          zero;

  stage_rows<DP / 8, BQ, NT>(qs, LDQ, qb + q0 * qstr, qstr, nq, dch);
  cp_async_commit();
  stage_rows<DP / 8, kTcBK, NT>(ks, LDQ, kb + kbeg * kstr, kstr, Skv - kbeg,
                                dch);
  stage_rows<DVP / 8, kTcBK, NT>(vs, LDV, vb + kbeg * vstr, vstr, Skv - kbeg,
                                 vch);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this warp's 16 query rows as A fragments: lane l addresses shared
  // row l % 16 from column (l / 16) * 8 of each k16 step
  const bf16* qrow = qs + (warp * 16 + (lane & 15)) * LDQ + (lane >> 4) * 8;
  uint32_t qf[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
  }
  float oacc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_run[2] = {REPRO_NEG_INF, REPRO_NEG_INF};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};
  const int wq = q0 + warp * 16;  // this warp's first query position
  const int ntiles = (kend - kbeg + kTcBK - 1) / kTcBK;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * kTcBK;
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // the next tile loads while this one computes
      const int k1 = k0 + kTcBK;
      stage_rows<DP / 8, kTcBK, NT>(ks + (buf ^ 1) * kTcBK * LDQ, LDQ,
                                    kb + k1 * kstr, kstr, Skv - k1, dch);
      stage_rows<DVP / 8, kTcBK, NT>(vs + (buf ^ 1) * kTcBK * LDV, LDV,
                                     vb + k1 * vstr, vstr, Skv - k1, vch);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a warp whose rows all lie before the tile (causal) or whose windows
    // all end before it has no valid score in it
    const bool skip = causal && (k0 > wq + 15 ||
                                 (window > 0 && k0 + kTcBK <= wq - window + 1));
    if (!skip) {
      const bf16* kt = ks + buf * kTcBK * LDQ;
      const bf16* vt = vs + buf * kTcBK * LDV;
      float sacc[8][4];  // 16 rows x 64 keys
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, qrow + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // pairs of 8-key tiles
          uint32_t kf[4];
          const int mi = lane >> 3;
          ldmatrix_x4(kf, kt + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LDQ +
                              kk * 16 + (mi & 1) * 8);
          mma_bf16(sacc[2 * np], a, kf[0], kf[1]);
          mma_bf16(sacc[2 * np + 1], a, kf[2], kf[3]);
        }
      }
      // scale, softcap, then mask, in the fragment
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = wq + g + (e >> 1) * 8;
          const int kp = k0 + j * 8 + 2 * t + (e & 1);
          float s = sacc[j][e] * scale;
          // cap * tanh(s / cap) as cap - 2 cap / (exp(2 s / cap) + 1), by
          // the fast exponential and division (a few f32 ulps of cap, far
          // below the bf16 rounding of P) in place of tanhf's polynomial
          if (cap > 0.f)
            s = cap - __fdividef(2.f * cap, __expf(s * cap2) + 1.f);
          bool ok = kp < len;
          if (causal) {
            ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
          }
          sacc[j][e] = ok ? s : REPRO_NEG_INF;
        }
      }
      // online softmax on rows g (r = 0) and g + 8 (r = 1); a row's 64
      // scores sit on the 4 lanes of a quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mb = REPRO_NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mb = fmaxf(mb, fmaxf(sacc[j][2 * r], sacc[j][2 * r + 1]));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
        const float m_new = fmaxf(m_run[r], mb);
        const float m_safe = m_new <= REPRO_NEG_INF / 2 ? 0.f : m_new;
        const float corr =
            m_run[r] <= REPRO_NEG_INF / 2 ? 0.f : __expf(m_run[r] - m_safe);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float s = sacc[j][e];
            const float p = s > REPRO_NEG_INF / 2 ? __expf(s - m_safe) : 0.f;
            sacc[j][e] = p;
            ls += p;
          }
        }
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        ls += __shfl_xor_sync(0xffffffffu, ls, 2);
        l_run[r] = l_run[r] * corr + ls;
        m_run[r] = m_safe;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          oacc[n][2 * r] *= corr;
          oacc[n][2 * r + 1] *= corr;
        }
      }
      // O += P.V, P in bf16 as the A operand
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys at a time
        uint32_t pa[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NV / 2; ++np) {
          uint32_t vf[4];
          const int mi = lane >> 3;
          ldmatrix_x4_trans(vf, vt + (kk * 16 + (mi & 1) * 8 + (lane & 7)) *
                                         LDV + np * 16 + (mi >> 1) * 8);
          mma_bf16(oacc[2 * np], pa, vf[0], vf[1]);
          mma_bf16(oacc[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this tile's buffers are refilled next iteration
  }

  // normalize once, stage the warp's 16 rows in shared memory (over the V
  // buffers, free now: their 2 x 64 rows hold the 16 * NW <= 128), store
  // 16 bytes at a time
  bf16* os = vs + warp * 16 * LDV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * LDV + n * 8 + 2 * t) =
          pack_bf16(oacc[n][2 * r] / l, oacc[n][2 * r + 1] / l);
    if (lse != nullptr && t == 0 && wq + g + 8 * r < S)
      lse[static_cast<size_t>(bh) * S + wq + g + 8 * r] =
          row_lse(m_run[r], l_run[r]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * vch; i += 32) {
    const int r = i / vch, c = i % vch;
    if (wq + r < S)
      *reinterpret_cast<uint4*>(ob + (wq + r) * ostr + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LDV + c * 8);
  }
}

template <int DP, int DVP, int NW>
int launch_tc(const void* q, const void* k, const void* v, const int* kv_len,
              void* o, float* lse, int B, int S, int Skv, int H, int Hkv,
              int D, int Dv, int causal, int window, float scale, float cap,
              cudaStream_t st) {
  static_assert(16 * NW <= 2 * kTcBK, "output staging over the V buffers");
  constexpr size_t smem = smem_bytes_tc<DP, DVP, NW>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_tc_kernel<DP, DVP, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + 16 * NW - 1) / (16 * NW), B * H);
  flash_prefill_tc_kernel<DP, DVP, NW><<<grid, NW * 32, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_len, static_cast<bf16*>(o), lse, S, Skv,
      H, Hkv, D, Dv, causal, window, scale, cap);
  return static_cast<int>(cudaGetLastError());
}

// D <= 192 and Dv <= 128: 4 warps, the Q fragments in registers
template <int DP>
int launch_tc_dv(const void* q, const void* k, const void* v,
                 const int* kv_len, void* o, float* lse, int B, int S,
                 int Skv, int H, int Hkv, int D, int Dv, int causal,
                 int window, float scale, float cap, cudaStream_t st) {
  if (Dv <= 32)
    return launch_tc<DP, 32, 4>(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D,
                                Dv, causal, window, scale, cap, st);
  if (Dv <= 64)
    return launch_tc<DP, 64, 4>(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D,
                                Dv, causal, window, scale, cap, st);
  return launch_tc<DP, 128, 4>(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D,
                               Dv, causal, window, scale, cap, st);
}

}  // namespace

// q (B,S,H,D), k (B,Skv,Hkv,D), v (B,Skv,Hkv,Dv), o (B,S,H,Dv) of one
// dtype; kv_len (B,) int32.  window <= 0: no window; cap <= 0: no softcap.
// lse: null, or a (B,H,S) f32 output of each row's log-sum-exp m + log l
// (-inf for a row with no valid key), what the backward recomputes P from.
// f32 takes the CUDA-core body, bf16 the tensor-core body (D % 8 == 0,
// D <= 256, Dv % 8 == 0, Dv <= 256, 16-byte aligned rows; its wide form
// where D > 192 or Dv > 128).
extern "C" int flash_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, const int* kv_len,
                                    void* o, int B, int S, int Skv, int H,
                                    int Hkv, int D, int Dv, int causal,
                                    int window, float scale, float cap,
                                    void* stream, float* lse) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_f32(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D, Dv, causal,
                      window, scale, cap, st);
  if (dtype != DT_BF16 || D % 8 || Dv % 8 || D > 256 || Dv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 192 || Dv > 128)  // wide heads: Q reloaded from shared memory
    return launch_tc<256, 256, 8>(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D,
                                  Dv, causal, window, scale, cap, st);
  if (D <= 32)
    return launch_tc_dv<32>(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D, Dv,
                            causal, window, scale, cap, st);
  if (D <= 64)
    return launch_tc_dv<64>(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D, Dv,
                            causal, window, scale, cap, st);
  if (D <= 128)
    return launch_tc_dv<128>(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D, Dv,
                             causal, window, scale, cap, st);
  return launch_tc_dv<192>(q, k, v, kv_len, o, lse, B, S, Skv, H, Hkv, D, Dv,
                           causal, window, scale, cap, st);
}
