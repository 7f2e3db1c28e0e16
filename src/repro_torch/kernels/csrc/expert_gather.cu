// Expert-span gather for the expert-granular paged weights: the port's own
// kernel, with no Pallas counterpart.  It replaces the XLA gather that
// repro/models/model.py::_ExpertCtx.make_fetch lowers to (a miss is a
// gather from the pinned host store inside the jitted step): no PyTorch
// call copies from pinned host memory at indices that live on the device.
//
// For one layer and the compact slots a < A of the activated expert set
// sel (A,), with n_act real slots:
//   a >= n_act                    -> the slot's outputs are zero-filled;
//   map[layer, sel[a]] = s >= 0   -> the span is read from the device pool
//                                    (slots, span) at slot s;
//   otherwise (a miss)            -> the span is copied from the pinned
//                                    host store (L, E, span) by the copy
//                                    engine.
// The span's leaves (the manifest's offsets and sizes, at most kMaxLeaves)
// are written to contiguous outputs out_j (A, n_j): what moe_ffn takes.
//
// Bound: the missed spans' bytes over the link at the copy engine's rate
// (chip_smoke.py's h2d_copy); the pool's bytes read and written at HBM's
// rate.  The first design read the misses with the SMs through the store's
// mapped address and reached about half the copy engine's rate over the
// same link, whatever its grid order, unroll or block size.  So a miss now
// crosses on the copy engine, and the device decides which spans move:
//
//  1. expert_plan_kernel, one thread on the caller's stream, reads n_act,
//     sel and the map and writes the plan (the misses (a, e) of the real
//     slots, in slot order, and their count) into page-locked mapped host
//     memory; an event is recorded after it.
//  2. expert_gather_kernel, next on the same stream: every block copies a
//     resident slot from the pool or zero-fills a pad slot; a missed slot
//     is not touched.
//  3. expert_gather_launch waits for the plan's event (the host waits for
//     the stream to reach this layer's gather, not for the hits or the
//     copies; the other kernels' launches never wait) and reads the plan.
//  4. It issues one cudaMemcpyAsync per missed leaf, from the store into
//     out_j[a], on a copy stream of its own that first waits for the
//     plan's event (the DMA route that h2d_copy measures, beside the hits),
//     and makes the caller's stream wait for the copies' event: what runs
//     next on it sees every slot.  The outputs' earlier users ran before
//     the plan and their later ones run after the copies, as on one
//     stream.
//
// A thread of this library that issued the copies when the device asked
// (through a mailbox in mapped memory and stream memory operations) would
// spare the host its wait, but on the H100 (CUDA 12.8) any host call
// blocked inside CUDA other than a synchronize (a pageable copy, cudaFree,
// a launch into a full queue) held that thread's calls back while it
// waited for the stream, which waited for the thread: a deadlock, cured
// only by a host wait after every gather.  Issuing the copies here after
// the one wait has no thread and no such hazard.  The wait rules out
// capturing an expert-paged decode chunk as a CUDA graph.
#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr long long kMaxGridY = 65535;
constexpr int kMaxLeaves = 4;
constexpr int kMaxSlots = 256;     // A: at most the experts of a layer
constexpr int kMaxDevices = 64;

struct Leaves {
  long long off[kMaxLeaves];   // span offsets, in units
  long long n[kMaxLeaves];     // sizes, in units
  void* out[kMaxLeaves];       // (A, n) outputs
  int count;
};

// The plan of one call, in page-locked mapped host memory: written by
// expert_plan_kernel, read by the host after the call's event.
struct Plan {
  int n_miss;
  int miss[kMaxSlots][2];      // (slot a, expert e)
};

// Per device: the copy stream and the events that order it.
struct Copier {
  cudaStream_t stream = nullptr;
  cudaEvent_t planned = nullptr, landed = nullptr;
};

std::mutex g_mu;               // one call at a time owns the plan
Plan* g_plan = nullptr;        // host pointer (mapped; the device's is equal)
Copier g_copier[kMaxDevices];

__global__ void expert_plan_kernel(const int* __restrict__ rmap,
                                   const int* __restrict__ sel,
                                   const int* __restrict__ n_act, int layer,
                                   int E, int A, Plan* plan) {
  const int n = *n_act;
  const int* row = rmap + static_cast<long long>(layer) * E;
  int m = 0;
  for (int a = 0; a < n && a < A; ++a) {
    const int e = sel[a];
    if (row[e] < 0) {
      plan->miss[m][0] = a;
      plan->miss[m][1] = e;
      ++m;
    }
  }
  plan->n_miss = m;
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
    expert_gather_kernel(const U* __restrict__ pool,
                         const int* __restrict__ rmap,
                         const int* __restrict__ sel,
                         const int* __restrict__ n_act, Leaves lv,
                         int layer, int E, long long span_units,
                         long long used_units, long long chunks) {
  const int n = *n_act;
  const int* row = rmap + static_cast<long long>(layer) * E;
  const int a = blockIdx.x;    // slots fastest: pool reads spread over HBM
  const bool pad = a >= n;
  const U* src = nullptr;
  if (!pad) {
    const int slot = row[sel[a]];
    if (slot < 0) return;      // a miss: the copy engine fills it
    src = pool + static_cast<long long>(slot) * span_units;
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
int launch(const void* pool, const int* rmap, const int* sel,
           const int* n_act, Leaves lv, int layer, int E, int A,
           long long span_bytes, long long used_bytes, cudaStream_t st) {
  const long long span_units = span_bytes / sizeof(U);
  const long long used_units = used_bytes / sizeof(U);
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long chunks = (used_units + per_block - 1) / per_block;
  dim3 grid(A, static_cast<unsigned>(chunks < kMaxGridY ? chunks
                                                          : kMaxGridY));
  expert_gather_kernel<U><<<grid, kThreads, 0, st>>>(
      static_cast<const U*>(pool), rmap, sel, n_act, lv, layer, E,
      span_units, used_units, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// store: the pinned store (L, E, span) as its host pointer; pool (slots,
// span) on the device, or null when no span is resident (the map then
// holds no entry >= 0); rmap (L, E), sel (A,), n_act (1,) int32 on the
// device.  offs / ns: the leaves' span offsets and sizes in bytes; outs:
// their (A, n) outputs.  span_bytes: one padded span; elem: the element
// size, for the element-wide body.  Waits for the plan (above), then
// enqueues the misses' copies and `stream`'s wait for them, and returns.
extern "C" int expert_gather_launch(const void* store, const void* pool,
                                    const int* rmap, const int* sel,
                                    const int* n_act, const long long* offs,
                                    const long long* ns, void* const* outs,
                                    int nleaves, int layer, int E, int A,
                                    long long span_bytes, int elem,
                                    void* stream) {
  if (nleaves < 1 || nleaves > kMaxLeaves || A < 1 || A > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = span_bytes % 16 == 0 &&
             reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  long long used = 0;
  for (int j = 0; j < nleaves; ++j) {
    vec = vec && offs[j] % 16 == 0 && ns[j] % 16 == 0 &&
          reinterpret_cast<uintptr_t>(outs[j]) % 16 == 0;
    used = offs[j] + ns[j] > used ? offs[j] + ns[j] : used;
  }
  const int unit = vec ? 16 : elem;
  if (unit != 16 && unit != 4 && unit != 2 && unit != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Leaves lv{};
  lv.count = nleaves;
  for (int j = 0; j < nleaves; ++j) {
    lv.off[j] = offs[j] / unit;
    lv.n[j] = ns[j] / unit;
    lv.out[j] = outs[j];
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_plan == nullptr) {
    void* p = nullptr;
    err = cudaHostAlloc(&p, sizeof(Plan),
                        cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* d = nullptr;
    err = cudaHostGetDevicePointer(&d, p, 0);
    if (err == cudaSuccess && d != p) err = cudaErrorNotSupported;
    if (err != cudaSuccess) {
      cudaFreeHost(p);
      return static_cast<int>(err);
    }
    g_plan = static_cast<Plan*>(p);
  }
  Copier& c = g_copier[dev];
  if (c.landed == nullptr) {
    err = cudaStreamCreateWithFlags(&c.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&c.planned, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&c.landed, cudaEventDisableTiming);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  expert_plan_kernel<<<1, 1, 0, st>>>(rmap, sel, n_act, layer, E, A,
                                      g_plan);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(c.planned, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc;
  if (unit == 16)
    rc = launch<uint4>(pool, rmap, sel, n_act, lv, layer, E, A, span_bytes,
                       used, st);
  else if (unit == 4)
    rc = launch<uint32_t>(pool, rmap, sel, n_act, lv, layer, E, A,
                          span_bytes, used, st);
  else if (unit == 2)
    rc = launch<uint16_t>(pool, rmap, sel, n_act, lv, layer, E, A,
                          span_bytes, used, st);
  else  // int8 expert pages
    rc = launch<uint8_t>(pool, rmap, sel, n_act, lv, layer, E, A,
                         span_bytes, used, st);
  if (rc != 0) return rc;
  err = cudaEventSynchronize(c.planned);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = g_plan->n_miss;
  if (m < 0 || m > A) return static_cast<int>(cudaErrorIllegalState);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  err = cudaStreamWaitEvent(c.stream, c.planned, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const char* layer_base =
      static_cast<const char*>(store) +
      static_cast<long long>(layer) * E * span_bytes;
  for (int i = 0; i < m; ++i) {
    const int a = g_plan->miss[i][0], e = g_plan->miss[i][1];
    if (a < 0 || a >= A || e < 0 || e >= E)
      return static_cast<int>(cudaErrorIllegalState);
    const char* span = layer_base + static_cast<long long>(e) * span_bytes;
    for (int j = 0; j < nleaves; ++j) {
      err = cudaMemcpyAsync(static_cast<char*>(outs[j]) + a * ns[j],
                            span + offs[j], ns[j], cudaMemcpyHostToDevice,
                            c.stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  err = cudaEventRecord(c.landed, c.stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(st, c.landed, 0);
  return static_cast<int>(err);
}
