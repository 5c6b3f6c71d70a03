// Row-batched int32 gather for Hopper (sm_90a):
//   out[r, k] = src[r * src_stride + clamp(idx[r, k], 0, m - 1)]
//
// Replaces the JAX package's edge_resolve.py::_gather_kernel (resident
// source in VMEM) and ::_gather_slab_kernel (source tiled into VMEM slabs
// with per-slab partial sums). On the card the whole source is served by
// L2 and device memory, so there are no slabs: one kernel covers the
// pointer-doubling pass (src == idx), the shared 1-D source (one row,
// src_stride 0) and the batched rows.
//
// Bound: bytes. Each output costs a streamed 4-byte read of idx, a
// streamed 4-byte write of out and a 4-byte read of src; a random read
// of src fetches a whole 32-byte sector, so where the source row misses
// L2 the sectors set the floor: the uniform gather_chunked case (64 rows
// of 15M entries, 60 MB each, at 2M indices per row) moves 64 x 2M x
// 32 B = 4.3 GB, 1.28 ms at 3.35 TB/s. The receive gather's source row
// (2M entries, 8 MB) fits in L2. On the PBA path the grant lookups copy
// runs of consecutive pool slots, and off its band every receive index
// clamps to one of 2P slots of its row, so a warp's loads there hit
// ~20-30 distinct L1 lines at once.
//
// Design. Tuned for the PBA path's indices, which are run-like (the
// grants) or clamped onto a few hot slots (the receives): at uniform
// indices it is no faster than torch.gather (within 3% on 8 MB rows) and
// 7-10% slower than the earlier one-output-per-thread design on 60 MB
// rows (last point below). Revisit it if a caller gathers at uniform
// indices. Times (H100 SXM at 700 W, PERF.md), path grants / path
// receives at round 0, the earlier design -> this one: 0.77-0.85 ->
// 0.56-0.61 ms and 1.87-1.95 -> 1.23-1.35 ms (torch.gather: 0.82-0.85 and
// 1.60-1.66 ms).
//  - Each thread takes kVec = 4 consecutive outputs of a row per tile:
//    one 16-byte index load, four independent source loads issued before
//    any is used, one 16-byte store. The earlier design took one output
//    per thread, its source load waiting on its index load.
//  - The grid is the card's resident blocks (SMs x blocks per SM), and
//    blocks claim tiles of kThreads * kVec outputs, in row-major order,
//    from a counter (atomicAdd, one claim per tile, fetched while the
//    previous tile runs). The tiles in flight then stay within about one
//    grid's worth of each other, so a row's source stays in L2 while it
//    is read. A static grid-stride walk over the same grid drifted
//    apart over a row's thousands of tiles: the uniform receive case took
//    8.4 ms against 2.9 ms with the counter. 128- and 64-thread blocks
//    claim 2x and 4x as often and ran 10-60% slower on the path cases.
//    The counter lives in the library, one per (device, stream), zeroed
//    once when made; every block makes exactly one claim past the last
//    tile, so the launch's last claim is number tiles + grid - 1, and the
//    block that draws it zeroes the counter for the next launch on that
//    stream.
//  - idx and out are streamed (__ldcs / __stcs: evict-first), src read
//    through the read-only path (__ldg), whose L1 serves the receives'
//    hot lines: reading src past L1 (__ldcg) took the path receives from
//    1.29 to 1.77 ms. Dropped after measuring (within 3% on the path
//    cases, or slower): two vectors per thread per tile, an L2
//    evict_last policy on the source reads, and a one-load path for
//    four consecutive aligned indices (no gain on the grants).
//  - In-row offsets are 32-bit; only the row base is 64-bit (the wrapper
//    refuses m or n of 2^31 or more).
//  - Alignment inside the kernel: out's row r starts on a 16-byte
//    boundary only when r * n is a multiple of 4 (and a view can start
//    anywhere), so each row runs a scalar head up to its first aligned
//    output, the vector body, and a scalar tail; the head and tail go to
//    a few threads of the row's first tile. idx and out always differ by
//    a fixed byte offset, so idx's vectors are aligned where out's are
//    exactly when that offset is a multiple of 16 (true unless idx is a
//    view); otherwise the four indices are loaded one by one.
//  - Uniform indices into 60 MB rows (gather_chunked's uniform case) run
//    7-10% slower than the earlier design: its 256 outputs per block kept
//    the blocks in flight inside one row, where this grid's ~1M outputs
//    in flight straddle two rows (two 60 MB sources) about half the time.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                    // outputs per thread per tile
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int32_t at(const int32_t* s, int32_t j,
                                      int32_t last) {
  return __ldg(s + min(max(j, 0), last));
}

// The next tile; the launch's last claim zeroes the counter.
__device__ __forceinline__ uint32_t claim(uint32_t* next_tile,
                                         uint32_t last_claim) {
  const uint32_t id = atomicAdd(next_tile, 1u);
  if (id == last_claim) *next_tile = 0;
  return id;
}

__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const int32_t* __restrict__ src,
                       const int32_t* __restrict__ idx,
                       int32_t* __restrict__ out,
                       uint32_t* __restrict__ next_tile, int32_t n,
                       int32_t last, int64_t src_stride, uint32_t tiles,
                       uint32_t tiles_per_row) {
  // Thread 0 claims the block's next tile while the block works on the
  // current one; the two slots alternate, so one barrier per tile does.
  __shared__ uint32_t claimed[2];
  const bool idx_vec = ((reinterpret_cast<uintptr_t>(idx) ^
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int32_t t = (int32_t)threadIdx.x;
  const uint32_t last_claim = tiles + gridDim.x - 1;
  if (t == 0) claimed[0] = claim(next_tile, last_claim);
  __syncthreads();
  int slot = 0;
  for (uint32_t id = claimed[0]; id < tiles; id = claimed[slot]) {
    if (t == 0) claimed[slot ^ 1] = claim(next_tile, last_claim);
    const uint32_t row = id / tiles_per_row;
    const uint32_t tile = id - row * tiles_per_row;
    const int32_t* s = src + (int64_t)row * src_stride;
    const int32_t* ix = idx + (int64_t)row * n;
    int32_t* o = out + (int64_t)row * n;
    const int32_t head =
        min((int32_t)((0u - (uint32_t)(reinterpret_cast<uintptr_t>(o) >> 2))
                      & 3u), n);
    const int32_t nvec = (n - head) / kVec;
    const int32_t vec = (int32_t)tile * kThreads + t;
    if (vec < nvec) {
      const int32_t k = head + kVec * vec;
      int4 j;
      if (idx_vec) {
        j = __ldcs(reinterpret_cast<const int4*>(ix + k));
      } else {
        j.x = __ldcs(ix + k);
        j.y = __ldcs(ix + k + 1);
        j.z = __ldcs(ix + k + 2);
        j.w = __ldcs(ix + k + 3);
      }
      int4 v;
      v.x = at(s, j.x, last);
      v.y = at(s, j.y, last);
      v.z = at(s, j.z, last);
      v.w = at(s, j.w, last);
      __stcs(reinterpret_cast<int4*>(o + k), v);
    }
    if (tile == 0) {
      // Head: threads [0, head); tail: threads [4, 4 + tail).
      const int32_t tail = n - head - kVec * nvec;
      const int32_t e = t < head ? t
                        : (t >= 4 && t - 4 < tail ? head + kVec * nvec + t - 4
                                                  : -1);
      if (e >= 0) o[e] = at(s, __ldcs(ix + e), last);
    }
    __syncthreads();
    slot ^= 1;
  }
}

// Resident blocks of gather_rows_kernel per SM times the SMs, per device.
int grid_cap(int* code) {
  static int cap[kMaxDevices];
  int dev = 0;
  *code = (int)cudaGetDevice(&dev);
  if (*code) return 0;
  if (dev < kMaxDevices && cap[dev]) return cap[dev];
  int sms = 0, per_sm = 0;
  *code = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!*code)
    *code = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_rows_kernel, kThreads, 0);
  if (*code) return 0;
  const int c = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cap[dev] = c;
  return c;
}

// The tile counter of launches on (the current device, stream).
uint32_t* tile_counter(cudaStream_t stream, int* code) {
  static std::mutex mu;
  static std::map<std::pair<int, cudaStream_t>, uint32_t*> counters;
  int dev = 0;
  *code = (int)cudaGetDevice(&dev);
  if (*code) return nullptr;
  std::lock_guard<std::mutex> lock(mu);
  uint32_t*& c = counters[{dev, stream}];
  if (c) return c;
  *code = (int)cudaMalloc(&c, sizeof(uint32_t));
  if (!*code) *code = (int)cudaMemsetAsync(c, 0, sizeof(uint32_t), stream);
  if (*code) {
    cudaFree(c);
    c = nullptr;
  }
  return c;
}

}  // namespace

extern "C" int repro_gather_i32(const void* src, const void* idx, void* out,
                                int64_t rows, int64_t m, int64_t n,
                                int64_t src_stride, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int64_t tiles_per_row =
      (n / kVec + kThreads - 1) / kThreads > 0
          ? (n / kVec + kThreads - 1) / kThreads : 1;
  const int64_t tiles = rows * tiles_per_row;
  // The claim counter passes `tiles` by one per block and must not wrap.
  if (m < 1 || m > INT32_MAX || n > INT32_MAX || tiles > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int code = 0;
  const int64_t cap = grid_cap(&code);
  if (code) return code;
  uint32_t* next_tile = tile_counter((cudaStream_t)stream, &code);
  if (code) return code;
  gather_rows_kernel<<<(unsigned)(tiles < cap ? tiles : cap), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)idx, (int32_t*)out, next_tile,
      (int32_t)n, (int32_t)(m - 1), src_stride, (uint32_t)tiles,
      (uint32_t)tiles_per_row);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_gather_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
