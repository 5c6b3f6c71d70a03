// Row-batched int32 histogram for Hopper (sm_90a):
//   counts[r, b] = #{k : values[r, k] == b},  0 <= b < num_bins
// Values that are negative or >= num_bins are ignored (the round census
// passes -1 for slots outside the band). counts must be zeroed by the
// caller.
//
// Replaces the JAX package's histogram.py::_hist_kernel, which counts by a
// one-hot compare of each value block against an iota of bins (no scatter
// on the TPU's vector unit). On the card integer atomics are exact in any
// order, so each value is one atomicAdd.
//
// Bound: bytes, one streamed read of values (the counts are small). When
// the bins fit in shared memory, each block keeps private bins there and
// adds them to the row's counts once at the end, so device-memory atomics
// are O(blocks * bins) instead of O(values); otherwise the kernel adds
// straight into the counts in device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void histogram_shared_kernel(const int32_t* __restrict__ values,
                                        int32_t* __restrict__ counts,
                                        int64_t rows, int64_t n,
                                        int32_t num_bins) {
  extern __shared__ int32_t bins[];
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    for (int b = threadIdx.x; b < num_bins; b += blockDim.x) bins[b] = 0;
    __syncthreads();
    const int32_t* v = values + r * n;
    for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
         k += step) {
      const int32_t x = __ldg(v + k);
      if (x >= 0 && x < num_bins) atomicAdd(&bins[x], 1);
    }
    __syncthreads();
    int32_t* c = counts + r * (int64_t)num_bins;
    for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
      const int32_t h = bins[b];
      if (h) atomicAdd(&c[b], h);
    }
    __syncthreads();
  }
}

__global__ void histogram_global_kernel(const int32_t* __restrict__ values,
                                        int32_t* __restrict__ counts,
                                        int64_t rows, int64_t n,
                                        int32_t num_bins) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int32_t* v = values + r * n;
    int32_t* c = counts + r * (int64_t)num_bins;
    for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
         k += step) {
      const int32_t x = __ldg(v + k);
      if (x >= 0 && x < num_bins) atomicAdd(&c[x], 1);
    }
  }
}

}  // namespace

// Largest bin count kept in shared memory: 48 KiB, the default a block
// may use without opting in to more.
extern "C" int repro_histogram_shared_bins() { return 12288; }

extern "C" int repro_histogram_i32(const void* values, void* counts,
                                   int64_t rows, int64_t n, int32_t num_bins,
                                   int32_t blocks_per_row, void* stream) {
  if (rows <= 0 || n <= 0 || num_bins <= 0) return 0;
  int64_t bx = (n + kThreads - 1) / kThreads;
  if (bx > blocks_per_row) bx = blocks_per_row;
  const int64_t by = rows < 65535 ? rows : 65535;
  const dim3 grid((unsigned)bx, (unsigned)by);
  cudaStream_t s = (cudaStream_t)stream;
  if (num_bins <= repro_histogram_shared_bins()) {
    histogram_shared_kernel<<<grid, kThreads, num_bins * sizeof(int32_t),
                              s>>>((const int32_t*)values, (int32_t*)counts,
                                   rows, n, num_bins);
  } else {
    histogram_global_kernel<<<grid, kThreads, 0, s>>>(
        (const int32_t*)values, (int32_t*)counts, rows, n, num_bins);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_histogram_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
