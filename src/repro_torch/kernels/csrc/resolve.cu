// In-place root resolution of the PBA urns' pointer chains for Hopper
// (sm_90a): for every slot j of every row,
//   ptr[r, j] <- the root of j's chain (follow q <- ptr[r, q] until
//                ptr[r, q] == q).
//
// Replaces the JAX package's pba.py::resolve_pointers, a while_loop of
// edge_resolve.py::resolve_step_pallas passes (ptr'[j] = ptr[ptr[j]]) run
// until every entry lands on a terminal slot. A whole-array pass is the
// only schedule a Pallas grid can express, so the TPU pays one full pass
// per doubling round (4 for the phase-2 pool, 5-6 for the phase-1 urn),
// plus a check between rounds. Here one launch resolves the urn: every
// thread walks its slot's chain to the root and writes the root in place.
// Blocks start in ascending slot order within a row (x inside the row,
// rows along y, as in gather.cu), so the slot a chain lands on has
// usually been compressed already by an earlier block, and a walk takes
// one or two reads.
//
// A phase-1 urn's chains end at its faction seeds (the slots below the
// faction size, 93-275 at the paper's 64-rank scale) about half the time,
// so the last read of half the walks of a row hits the same few lines,
// which one L2 slice serves one request at a time (16 ms for 64 x 5M
// slots on an H100). Each block therefore first snapshots the row's
// lowest kLow slots into shared memory, and a walk that goes below kLow
// goes on in the snapshot (4.6 ms). The snapshot costs the phase-2 pools,
// whose roots are spread over their first E slots and have no such hot
// lines, ~0.6 ms of 13 (one coalesced 2 KiB read per block).
//
// Correctness does not depend on the schedule. The urns' pointers never
// rise (ptr[j] <= j, and only roots point at themselves), and a slot is
// written once, with its root. So a value read at slot x, from the array
// or from a snapshot however stale, is x's original pointer or x's root,
// both on x's chain, and every walk reaches the one root of its chain:
// the result is the doubling pass's fixpoint, bit for bit, on every run.
// Other threads write the array while it is read, so every access to it
// is a relaxed device-scope atomic (no read-only path, no __restrict__).
// A pointer outside [0, its slot] sets *err and ends that walk; the
// wrapper reads the word once per launch and raises.
//
// Bound: bytes, the pointer array read once and written once. Offsets are
// 64-bit: 64 rows of 15M slots is close to 2^30 entries.
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLow = 512;                  // slots snapshotted per block

using Slot = cuda::atomic_ref<int32_t, cuda::thread_scope_device>;

__device__ __forceinline__ int32_t load(int32_t* p) {
  return Slot(*p).load(cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ void store(int32_t* p, int32_t value) {
  Slot(*p).store(value, cuda::std::memory_order_relaxed);
}

__global__ void __launch_bounds__(kThreads)
    resolve_roots_kernel(int32_t* ptr, int64_t rows, int64_t m,
                         int32_t* err) {
  __shared__ int32_t low[kLow];
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nlow = m < kLow ? m : kLow;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    int32_t* p = ptr + r * m;
    __syncthreads();                  // the previous row's walks are done
    for (int i = threadIdx.x; i < nlow; i += kThreads) low[i] = load(p + i);
    __syncthreads();
    if (j >= m) continue;
    int32_t cur = load(p + j);
    if (cur == j) continue;           // a root
    bool bad = cur < 0 || cur > j;
    while (!bad) {
      const int32_t next = cur < nlow ? low[cur] : load(p + cur);
      if (next == cur) break;
      bad = next < 0 || next > cur;
      cur = next;
    }
    if (bad) {
      store(err, 1);
    } else {
      store(p + j, cur);
    }
  }
}

}  // namespace

// ptr: (rows, m) int32 on the device, resolved in place; err: one int32
// on the device, zeroed by the caller, set to 1 on a pointer outside
// [0, its slot].
extern "C" int repro_resolve_roots_i32(void* ptr, void* err, int64_t rows,
                                       int64_t m, void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  const int64_t bx = (m + kThreads - 1) / kThreads;
  const int64_t by = rows < 65535 ? rows : 65535;
  resolve_roots_kernel<<<dim3((unsigned)bx, (unsigned)by), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (int32_t*)ptr, rows, m, (int32_t*)err);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_resolve_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
