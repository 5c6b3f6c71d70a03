// Row-batched stable band compaction for Hopper (sm_90a):
//   for each row r, the (u, v) pairs whose band flag is set move to the
//   front of (uo[r], vo[r]) in index order; uo and vo are (rows, cap),
//   filled with -1 by the caller, and pairs past column cap are dropped.
//
// Replaces the JAX package's band_compact.py::_band_compact_kernel, an
// O(e * cap) one-hot accumulation with a cursor in SMEM (the TPU's vector
// unit has no scatter). On the card the same permutation is a prefix-scan
// compaction in three launches on one stream:
//   1. count: each (tile of kTile entries, row) block counts its band
//      flags with warp ballots into tile_counts (rows, n_tiles);
//   2. scan:  one block per row turns tile_counts into exclusive tile
//      offsets in place (a hand-written block scan, carried across chunks
//      of 1024 tiles);
//   3. scatter: each (tile, row) block ranks its band entries with a
//      ballot + popc inside each warp and warp totals in shared memory,
//      and writes u, v to column tile_offset + rank when that is < cap.
// Tiles walk their entries in index order and warps in lane order, so the
// compaction is stable. A tile whose offset is already >= cap is skipped.
//
// Bound: bytes. band is read twice (1 byte per entry, once per pass), u
// and v are read only where band is set, and both outputs are written in
// full (by the caller's fill and by the scatter). Row offsets are 64-bit:
// 64 rows of 5M entries is 320M entries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                // entries per (tile, row) block
constexpr int kScanThreads = 1024;

__global__ void count_kernel(const uint8_t* __restrict__ band,
                             int32_t* __restrict__ tile_counts, int64_t rows,
                             int64_t e, int64_t n_tiles) {
  __shared__ int32_t warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint8_t* b = band + r * e;
    const int64_t lo = t * kTile;
    const int64_t hi = lo + kTile < e ? lo + kTile : e;
    int32_t n = 0;
    for (int64_t k0 = lo; k0 < hi; k0 += kThreads) {
      const int64_t k = k0 + threadIdx.x;
      const bool f = k < hi && b[k];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (lane == 0) n += __popc(m);
    }
    if (lane == 0) warp_sum[warp] = n;
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t s = 0;
      for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
      tile_counts[r * n_tiles + t] = s;
    }
    __syncthreads();
  }
}

// Exclusive scan of each row of tile_counts, in place.
__global__ void scan_kernel(int32_t* __restrict__ tile_counts, int64_t rows,
                            int64_t n_tiles) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t chunk_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    int32_t* c = tile_counts + r * n_tiles;
    int32_t carry = 0;
    for (int64_t base = 0; base < n_tiles; base += kScanThreads) {
      const int64_t i = base + threadIdx.x;
      const int32_t x = i < n_tiles ? c[i] : 0;
      int32_t incl = x;                           // inclusive warp scan
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane == 31) warp_sum[warp] = incl;
      __syncthreads();
      if (warp == 0) {                            // scan the warp totals
        int32_t w = warp_sum[lane];
        for (int d = 1; d < 32; d <<= 1) {
          const int32_t y = __shfl_up_sync(0xffffffffu, w, d);
          if (lane >= d) w += y;
        }
        warp_sum[lane] = w;                       // inclusive
        if (lane == 31) chunk_total = w;
      }
      __syncthreads();
      const int32_t before = warp == 0 ? 0 : warp_sum[warp - 1];
      if (i < n_tiles) c[i] = carry + before + incl - x;
      carry += chunk_total;
      __syncthreads();                            // warp_sum reused
    }
  }
}

__global__ void scatter_kernel(const int32_t* __restrict__ u,
                               const int32_t* __restrict__ v,
                               const uint8_t* __restrict__ band,
                               const int32_t* __restrict__ tile_offsets,
                               int32_t* __restrict__ uo,
                               int32_t* __restrict__ vo, int64_t rows,
                               int64_t e, int64_t cap, int64_t n_tiles) {
  __shared__ int32_t warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;        // lanes before this one
  const int64_t t = blockIdx.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    int64_t pos = tile_offsets[r * n_tiles + t];
    if (pos >= cap) continue;                      // uniform over the block
    const int64_t row = r * e;
    const int64_t lo = t * kTile;
    const int64_t hi = lo + kTile < e ? lo + kTile : e;
    for (int64_t k0 = lo; k0 < hi && pos < cap; k0 += kThreads) {
      const int64_t k = k0 + threadIdx.x;
      const bool f = k < hi && band[row + k];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (lane == 0) warp_sum[warp] = __popc(m);
      __syncthreads();
      int32_t before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int32_t s = warp_sum[w];
        before += w < warp ? s : 0;
        total += s;
      }
      const int64_t dst = pos + before + __popc(m & below);
      if (f && dst < cap) {
        uo[r * cap + dst] = __ldg(u + row + k);
        vo[r * cap + dst] = __ldg(v + row + k);
      }
      pos += total;
      __syncthreads();                             // warp_sum reused
    }
  }
}

}  // namespace

extern "C" int64_t repro_band_compact_tile() { return kTile; }

// u, v: (rows, e) int32; band: (rows, e) bool (one byte, 0 or 1);
// uo, vo: (rows, cap) int32, prefilled with -1; tile_counts: (rows,
// ceil(e / kTile)) int32 scratch. Launches three kernels on stream.
extern "C" int repro_band_compact_i32(const void* u, const void* v,
                                      const void* band, void* uo, void* vo,
                                      void* tile_counts, int64_t rows,
                                      int64_t e, int64_t cap, void* stream) {
  if (rows <= 0 || e <= 0 || cap <= 0) return 0;
  const int64_t n_tiles = (e + kTile - 1) / kTile;
  const int64_t by = rows < 65535 ? rows : 65535;
  const dim3 grid((unsigned)n_tiles, (unsigned)by);
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<grid, kThreads, 0, s>>>((const uint8_t*)band,
                                         (int32_t*)tile_counts, rows, e,
                                         n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t scan_blocks = rows < 65535 ? rows : 65535;
  scan_kernel<<<(unsigned)scan_blocks, kScanThreads, 0, s>>>(
      (int32_t*)tile_counts, rows, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<grid, kThreads, 0, s>>>(
      (const int32_t*)u, (const int32_t*)v, (const uint8_t*)band,
      (const int32_t*)tile_counts, (int32_t*)uo, (int32_t*)vo, rows, e, cap,
      n_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_band_compact_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
