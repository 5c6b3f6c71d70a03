// Row-batched int32 histogram for Hopper (sm_90a):
//   counts[r, b] = #{k : values[r, k] == b and (no mask or mask[r, k])},
//   0 <= b < num_bins
// Values that are negative or >= num_bins are ignored.
//
// Replaces the JAX package's histogram.py::_hist_kernel, which counts by a
// one-hot compare of each value block against an iota of bins (no scatter
// on the TPU's vector unit). On the card integer atomics are exact in any
// order, so each counted value is one atomic add; where the adds land is
// the design.
//
// Bound: bytes. The function reads the values once (with a mask: the mask
// once and the values only where it is set) and writes the counts once.
// Its callers: PBA phase 1 (64 rows of 5M tags, 64 bins, every value in
// range), the streamed round's census (the same tags under the round's
// band: 41.5% of entries in round 0, 841 entries in round 10), and degree
// counting (2E endpoints into n + 1 bins, n = 64M: 256 MB of counts, more
// than the 50 MB L2).
//
// Design:
//  - Loads. A warp walks steps of 512 consecutive values of a row; lane l
//    loads the 16-byte vectors l, l + 32, l + 64, l + 96 of the step, so
//    each load instruction reads 512 contiguous bytes, and the next step's
//    four vectors are loaded before this step's values are counted (128
//    bytes a lane in flight). Rows start anywhere: a scalar head up to the
//    row's first 16-byte boundary, a scalar tail after its last vector.
//  - Masked (the census): lane l loads its step's flags as one 16-byte
//    vector (16 flags), the warp stages the step's 512 flags in shared
//    memory, and lane l reads back the 4 flags of each value vector it
//    loads: a vector is loaded only where one of its 4 flags is set (its
//    32-byte sector is fetched whole anyway), and a step whose 512 flags are
//    all clear loads no value. Rows whose mask and values do not reach a
//    16-byte boundary at the same entry (only views can do that) take a
//    scalar loop.
//  - Where the adds land, by regime (the wrapper's pure ``regime`` picks it
//    from num_bins and the card's limits):
//     block:   each block keeps private bins in shared memory, one copy per
//              warp while the copies fit in 16 KB (64 bins: 32 copies, 8
//              KB), so only a warp's own lanes contend; past 48 KB of
//              shared memory the block opts in to up to 227 KB.
//     cluster: a thread-block cluster of c <= 8 blocks shares a row; block
//              i keeps the window [i*S, (i+1)*S) of the bins, reads the
//              same values as the other blocks of its cluster and counts
//              those in its window. The cluster launch puts the c blocks
//              on the card together, so they read each vector close
//              together in time and the later reads can come from L2.
//     global:  past the cluster's capacity, device-memory atomics whose
//              result is unused (red.global.add), one per run of equal
//              values within a 16-byte vector (a degree count's sources
//              come in runs of k).
//    A block (or cluster) that owns whole rows writes its bins to counts
//    with plain stores, and the counts need no zeroing; where several
//    share a row they add their bins with one atomic per bin and block.
//  - 1024 threads a block, one block per SM: a cluster block's window of
//    up to 54K bins leaves room for no second block, and the block regime
//    measured the same at 2 x 512 threads.
// Row offsets are 64-bit (64 rows of 5M entries is 320M entries); more
// than 65,535 rows loop over grid y.
//
// Times (H100 SXM at 700 W, PERF.md), CUDA events, in turns with the
// earlier design (scalar grid-stride loads, 48 KB of shared bins, device
// memory past that): phase 1 1.03-1.07 -> 0.44-0.45 ms (bound 0.38); one
// streamed run's phase 1 and 11 censuses, the censuses before as
// torch.where(band, a, -1) then the count, 23.9-24.2 -> 3.72-3.73 ms
// (where plus this kernel's unmasked count: 17.5-17.9); 70,000 bins
// 3.99-4.11 -> 1.13-1.14 ms; the degree count 22.58-22.67 -> 22.16-22.20
// ms, bound by device-memory atomics (640M uniform values into the same
// 64M bins: 42.7-42.8 ms in both designs). Dropped after measuring in
// turns: the cluster's blocks adding into each other's windows by
// distributed shared memory atomics (map_shared_rank, or
// red.shared::cluster beside local adds), 2.03-2.14 ms at 70,000 bins
// against 1.12-1.13 for the windows; a warp's equal values merged by
// __match_any_sync, 3.9% slower on the degree count; the masks of 4
// steps loaded at once, no faster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                       // 16-byte vectors a lane a step
constexpr int kStep = 32 * kVec * 4;          // values a warp a step: 512
constexpr int kStageWords = kWarps * kStep / 4;  // a step's flags, per warp

enum Kind { kBlock = 0, kCluster = 1, kGlobal = 2 };

struct Args {
  const int32_t* values;
  const uint8_t* mask;
  int32_t* counts;
  int64_t rows, n;
  int32_t num_bins;
  int32_t copies;  // block: bin copies per block (warp w uses w % copies)
  int32_t slice;   // bins a block keeps: block num_bins, cluster S
  int32_t owned;   // one block / cluster per row: store, no atomics
  int32_t cluster; // blocks per cluster (1 outside the cluster regime)
};

// Adds one to the bin of x, if x is in range (cluster: if x is in this
// block's window). bins: this warp's copy (block) or this block's window
// (cluster); row: the row's counts (global).
template <int KIND>
__device__ __forceinline__ void add(int32_t x, const Args& a, int32_t* bins,
                                    int32_t* row) {
  if (x < 0 || x >= a.num_bins) return;
  if (KIND == kBlock) {
    atomicAdd(bins + x, 1);
  } else if (KIND == kCluster) {
    const uint32_t d = (uint32_t)(x - (int32_t)(blockIdx.x % a.cluster) *
                                          a.slice);
    if (d < (uint32_t)a.slice) atomicAdd(bins + d, 1);
  } else {
    atomicAdd(row + x, 1);
  }
}

// Adds c to the bin of x in device memory, if x is in range.
__device__ __forceinline__ void add_run(int32_t x, int32_t c, const Args& a,
                                        int32_t* row) {
  if (x >= 0 && x < a.num_bins) atomicAdd(row + x, c);
}

template <int KIND>
__device__ __forceinline__ void add4(int4 x, const Args& a, int32_t* bins,
                                     int32_t* row) {
  if (KIND == kGlobal) {
    int32_t v = x.x, c = 1;
    if (x.y == v) { ++c; } else { add_run(v, c, a, row); v = x.y; c = 1; }
    if (x.z == v) { ++c; } else { add_run(v, c, a, row); v = x.z; c = 1; }
    if (x.w == v) { ++c; } else { add_run(v, c, a, row); v = x.w; c = 1; }
    add_run(v, c, a, row);
    return;
  }
  add<KIND>(x.x, a, bins, row);
  add<KIND>(x.y, a, bins, row);
  add<KIND>(x.z, a, bins, row);
  add<KIND>(x.w, a, bins, row);
}

// The 4 values of x whose flag byte in w is set.
template <int KIND>
__device__ __forceinline__ void add4_masked(int4 x, uint32_t w, const Args& a,
                                            int32_t* bins, int32_t* row) {
  if (w & 0xffu) add<KIND>(x.x, a, bins, row);
  if (w & 0xff00u) add<KIND>(x.y, a, bins, row);
  if (w & 0xff0000u) add<KIND>(x.z, a, bins, row);
  if (w & 0xff000000u) add<KIND>(x.w, a, bins, row);
}

template <int KIND, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1) histogram_kernel(Args a) {
  extern __shared__ int4 smem4[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem4);
  int32_t* bins =
      reinterpret_cast<int32_t*>(smem4) + (MASKED ? kStageWords : 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_smem = KIND == kGlobal ? 0 : a.copies * a.slice;
  int32_t* wbins = bins + (KIND == kBlock ? (warp % a.copies) * a.slice : 0);
  uint32_t* wstage = stage + warp * (kStep / 4);
  // The blocks of a cluster walk the same steps.
  const int64_t gw = (int64_t)(blockIdx.x / a.cluster) * kWarps + warp;
  const int64_t nw = (int64_t)(gridDim.x / a.cluster) * kWarps;
  const int64_t n = a.n;

  for (int64_t r = blockIdx.y; r < a.rows; r += gridDim.y) {
    if (KIND != kGlobal) {
      for (int i = threadIdx.x; i < n_smem; i += kThreads) bins[i] = 0;
      __syncthreads();
    }
    const int32_t* v = a.values + r * n;
    int32_t* crow = a.counts + r * (int64_t)a.num_bins;
    // Entries before the values' first 16-byte boundary.
    int64_t head = (int64_t)(((16 - ((uintptr_t)v & 15)) & 15) >> 2);
    bool vector_rows = true;
    const uint8_t* m = nullptr;
    if (MASKED) {
      m = a.mask + r * n;
      head = (16 - ((uintptr_t)m & 15)) & 15;
      vector_rows = (((uintptr_t)(v + head)) & 15) == 0;
    }
    if (head > n) head = n;
    // Body: 16-byte value vectors (unmasked), or 16-value units (masked).
    const int64_t units = MASKED ? (n - head) >> 4 : (n - head) >> 2;
    const int64_t tail_at = head + (MASKED ? 16 : 4) * units;

    if (!vector_rows) {
      // Masked rows whose flags and values are out of phase.
      for (int64_t k = gw * 32 + lane; k < n; k += nw * 32)
        if (m[k]) add<KIND>(v[k], a, wbins, crow);
    } else {
      if (gw == 0) {  // scalar head and tail, < 16 entries each
        if (lane < head && (!MASKED || m[lane]))
          add<KIND>(v[lane], a, wbins, crow);
        if (lane < n - tail_at && (!MASKED || m[tail_at + lane]))
          add<KIND>(v[tail_at + lane], a, wbins, crow);
      }
      const int4* v4 = reinterpret_cast<const int4*>(v + head);
      const int64_t steps = MASKED ? (units + 31) >> 5 : (units + 127) >> 7;
      if (MASKED) {
        const uint4* m4 = reinterpret_cast<const uint4*>(m + head);
        for (int64_t t = gw; t < steps; t += nw) {
          const int64_t mi = t * 32 + lane;
          const uint4 f = mi < units ? __ldg(m4 + mi) : make_uint4(0, 0, 0, 0);
          if (!__any_sync(0xffffffffu, f.x | f.y | f.z | f.w)) continue;
          reinterpret_cast<uint4*>(wstage)[lane] = f;
          __syncwarp();
          uint32_t w[kVec];
          int4 x[kVec];
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            w[k] = wstage[32 * k + lane];
            x[k] = w[k] ? __ldg(v4 + t * 128 + 32 * k + lane)
                        : make_int4(-1, -1, -1, -1);
          }
          __syncwarp();  // wstage is rewritten by the next step
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            add4_masked<KIND>(x[k], w[k], a, wbins, crow);
        }
      } else {
        const int4 none = make_int4(-1, -1, -1, -1);
        int4 x[kVec], y[kVec];
        int64_t t = gw;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int64_t q = t * 128 + 32 * k + lane;
          x[k] = t < steps && q < units ? __ldg(v4 + q) : none;
        }
        for (; t < steps; t += nw) {
          const int64_t tn = t + nw;
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const int64_t q = tn * 128 + 32 * k + lane;
            y[k] = tn < steps && q < units ? __ldg(v4 + q) : none;
          }
#pragma unroll
          for (int k = 0; k < kVec; ++k) add4<KIND>(x[k], a, wbins, crow);
#pragma unroll
          for (int k = 0; k < kVec; ++k) x[k] = y[k];
        }
      }
    }

    if (KIND != kGlobal) {
      __syncthreads();  // every add of the row has landed
      int lo = 0, hi = a.num_bins;
      if (KIND == kCluster) {
        lo = (int)(blockIdx.x % a.cluster) * a.slice;
        hi = min(lo + a.slice, a.num_bins);
      }
      for (int b = lo + threadIdx.x; b < hi; b += kThreads) {
        int32_t s = 0;
        if (KIND == kBlock) {
          for (int c = 0; c < a.copies; ++c) s += bins[c * a.slice + b];
        } else {
          s = bins[b - lo];
        }
        if (a.owned)
          crow[b] = s;
        else if (s)
          atomicAdd(crow + b, s);
      }
      __syncthreads();  // bins are zeroed for the next row
    }
  }
}

template <int KIND, bool MASKED>
int launch(const Args& a, int64_t gx, int64_t gy, int64_t smem,
           cudaStream_t s) {
  const int64_t need = (MASKED ? kStageWords * 4 : 0) +
                       (KIND == kGlobal ? 0 : (int64_t)a.copies * a.slice * 4);
  if (smem < need || gx < 1 || gx > 0x7fffffff || gx % a.cluster ||
      gy < 1 || gy > 65535)
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = histogram_kernel<KIND, MASKED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)gx, (unsigned)gy);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (KIND == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

// The card's opt-in shared memory per block, in bytes.
extern "C" int repro_histogram_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Threads a block, and the bytes of shared memory a masked step's flags take
// ahead of the bins: the wrapper sizes a block's bins and copies by these.
extern "C" int repro_histogram_threads() { return kThreads; }
extern "C" int repro_histogram_stage_bytes() { return kStageWords * 4; }

// kind: 0 block, 1 cluster (of `cluster` blocks), 2 global. (gx, gy,
// block, smem): the launch of kernels/geometry.py's histogram: gx blocks
// a row (a multiple of the cluster), rows along y, smem bytes of dynamic
// shared memory (at least the staging and the bins the regime keeps).
// mask may be null.
extern "C" int repro_histogram_i32(const void* values, const void* mask,
                                   void* counts, int64_t rows, int64_t n,
                                   int32_t num_bins, int32_t kind,
                                   int32_t cluster, int32_t copies,
                                   int32_t slice, int32_t owned, int64_t gx,
                                   int64_t gy, int block, int64_t smem,
                                   void* stream) {
  if (rows <= 0 || num_bins <= 0) return 0;
  if (block != kThreads) return (int)cudaErrorInvalidConfiguration;
  const Args a = {(const int32_t*)values, (const uint8_t*)mask,
                  (int32_t*)counts, rows, n, num_bins, copies, slice, owned,
                  kind == kCluster ? cluster : 1};
  cudaStream_t s = (cudaStream_t)stream;
  int code;
  const bool masked = mask != nullptr;
  if (kind == kBlock)
    code = masked ? launch<kBlock, true>(a, gx, gy, smem, s)
                  : launch<kBlock, false>(a, gx, gy, smem, s);
  else if (kind == kCluster)
    code = masked ? launch<kCluster, true>(a, gx, gy, smem, s)
                  : launch<kCluster, false>(a, gx, gy, smem, s);
  else
    code = masked ? launch<kGlobal, true>(a, gx, gy, smem, s)
                  : launch<kGlobal, false>(a, gx, gy, smem, s);
  if (code) return code;
  return (int)cudaGetLastError();
}

// The compiled attributes of kernel k (histogram_kernel<KIND, MASKED>, k =
// 2 * KIND + MASKED: block, cluster, global, each unmasked then masked)
// into out: numRegs, sharedSizeBytes, maxThreadsPerBlock, localSizeBytes.
// Returns a CUDA error code, or -1 past the last kernel.
extern "C" int repro_histogram_kernel_attributes(int k, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (k) {
    case 0: e = cudaFuncGetAttributes(&a, histogram_kernel<kBlock, false>);
      break;
    case 1: e = cudaFuncGetAttributes(&a, histogram_kernel<kBlock, true>);
      break;
    case 2: e = cudaFuncGetAttributes(&a, histogram_kernel<kCluster, false>);
      break;
    case 3: e = cudaFuncGetAttributes(&a, histogram_kernel<kCluster, true>);
      break;
    case 4: e = cudaFuncGetAttributes(&a, histogram_kernel<kGlobal, false>);
      break;
    case 5: e = cudaFuncGetAttributes(&a, histogram_kernel<kGlobal, true>);
      break;
    default: return -1;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* repro_histogram_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
