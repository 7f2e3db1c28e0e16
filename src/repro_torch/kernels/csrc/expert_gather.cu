// Expert-span gather for the expert-granular paged weights: the port's own
// kernel, with no Pallas counterpart.  It replaces the XLA gather that
// repro/models/model.py::_ExpertCtx.make_fetch lowers to (a miss is a
// gather from the pinned host store inside the jitted step): no PyTorch
// call indexes pinned host memory with indices that live on the device.
//
// For one layer and the compact slots a < A of the activated expert set
// sel (A,), with n_act real slots:
//   a >= n_act                    -> the slot's outputs are zero-filled;
//   map[layer, sel[a]] = s >= 0   -> the span is read from the device pool
//                                    (slots, span) at slot s;
//   otherwise                     -> the span is read straight from the
//                                    pinned host store (L, E, span) over
//                                    the link (mapped memory, zero-copy).
// The span's leaves (the manifest's offsets and sizes, at most kMaxLeaves)
// are written to contiguous outputs out_j (A, n_j): what moe_ffn takes.
//
// Bound: the host bytes of the missed spans at the link's rate, plus the
// pool bytes read and all output bytes written at HBM's rate; nothing is
// computed.  Design: a grid of (A, chunks of the span), the slots fastest so
// that spans read over the link and from the pool are in flight together;
// each thread moves kUnroll 16-byte units, all loads issued before the
// stores.  Reads of mapped host memory by the SMs run at about half the
// copy engine's rate over the same link (chip_smoke.py: the gather's
// host_GBps against h2d_copy), and neither the grid's order, the unroll
// nor the block size changed that.  n_act, sel and the map are read on the
// device, so the launch depends on shapes alone and the host reads nothing
// back.  A span whose leaf offsets and sizes are not multiples of
// 16 bytes takes the element-wide body.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr long long kMaxGridY = 65535;
constexpr int kMaxLeaves = 4;

struct Leaves {
  long long off[kMaxLeaves];   // span offsets, in units
  long long n[kMaxLeaves];     // sizes, in units
  void* out[kMaxLeaves];       // (A, n) outputs
  int count;
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
    expert_gather_kernel(const U* __restrict__ host,
                         const U* __restrict__ pool,
                         const int* __restrict__ rmap,
                         const int* __restrict__ sel,
                         const int* __restrict__ n_act, Leaves lv,
                         int layer, int E, long long span_units,
                         long long used_units, long long chunks) {
  const int a = blockIdx.x;  // slots fastest: link and pool reads overlap
  const bool pad = a >= *n_act;
  const U* src = nullptr;
  if (!pad) {
    const int e = sel[a];
    const int slot = rmap[static_cast<long long>(layer) * E + e];
    src = slot >= 0 ? pool + static_cast<long long>(slot) * span_units
                    : host + (static_cast<long long>(layer) * E + e) *
                                 span_units;
  }
  for (long long chunk = blockIdx.y; chunk < chunks; chunk += gridDim.y) {
    const long long base = chunk * kThreads * kUnroll + threadIdx.x;
    U v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = base + static_cast<long long>(k) * kThreads;
      if (pad || u >= used_units) {
        v[k] = U{};
      } else {
        v[k] = src[u];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long u = base + static_cast<long long>(k) * kThreads;
      if (u >= used_units) break;
      int j = 0;
      while (j + 1 < lv.count && u >= lv.off[j + 1]) ++j;
      const long long r = u - lv.off[j];
      if (r >= 0 && r < lv.n[j]) {
        static_cast<U*>(lv.out[j])[static_cast<long long>(a) * lv.n[j] + r] =
            v[k];
      }
    }
  }
}

template <typename U>
int launch(const void* host, const void* pool, const int* rmap,
           const int* sel, const int* n_act, Leaves lv, int layer, int E,
           int A, long long span_bytes, long long used_bytes,
           cudaStream_t st) {
  const long long span_units = span_bytes / sizeof(U);
  const long long used_units = used_bytes / sizeof(U);
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long chunks = (used_units + per_block - 1) / per_block;
  if (chunks == 0 || A == 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(A, static_cast<unsigned>(chunks < kMaxGridY ? chunks
                                                          : kMaxGridY));
  expert_gather_kernel<U><<<grid, kThreads, 0, st>>>(
      static_cast<const U*>(host), static_cast<const U*>(pool), rmap, sel,
      n_act, lv, layer, E, span_units, used_units, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// host: the pinned store (L, E, span) as its host pointer, mapped here with
// cudaHostGetDevicePointer (an error is returned if it is not mapped);
// pool (slots, span) on the device, or null when no span is resident (the
// map then holds no entry >= 0); rmap (L, E), sel (A,), n_act (1,) int32 on
// the device.  offs / ns: the leaves' span offsets and sizes in bytes;
// outs: their (A, n) outputs.  span_bytes: one padded span; elem: the
// element size, for the element-wide body.
extern "C" int expert_gather_launch(const void* host, const void* pool,
                                    const int* rmap, const int* sel,
                                    const int* n_act, const long long* offs,
                                    const long long* ns, void* const* outs,
                                    int nleaves, int layer, int E, int A,
                                    long long span_bytes, int elem,
                                    void* stream) {
  if (nleaves < 1 || nleaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  void* dev_host = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&dev_host,
                                             const_cast<void*>(host), 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool vec = span_bytes % 16 == 0 &&
             reinterpret_cast<uintptr_t>(dev_host) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  long long used = 0;
  for (int j = 0; j < nleaves; ++j) {
    vec = vec && offs[j] % 16 == 0 && ns[j] % 16 == 0 &&
          reinterpret_cast<uintptr_t>(outs[j]) % 16 == 0;
    used = offs[j] + ns[j] > used ? offs[j] + ns[j] : used;
  }
  const int unit = vec ? 16 : elem;
  if (unit != 16 && unit != 4 && unit != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Leaves lv{};
  lv.count = nleaves;
  for (int j = 0; j < nleaves; ++j) {
    lv.off[j] = offs[j] / unit;
    lv.n[j] = ns[j] / unit;
    lv.out[j] = outs[j];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (unit == 16)
    return launch<uint4>(dev_host, pool, rmap, sel, n_act, lv, layer, E, A,
                         span_bytes, used, st);
  if (unit == 4)
    return launch<uint32_t>(dev_host, pool, rmap, sel, n_act, lv, layer, E,
                            A, span_bytes, used, st);
  return launch<uint16_t>(dev_host, pool, rmap, sel, n_act, lv, layer, E, A,
                          span_bytes, used, st);
}
