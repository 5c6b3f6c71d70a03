// Communication-free endpoint expansion for Hopper (sm_90a).
//   For each global edge index t[j] (int32, >= 0), its endpoints (u, v)
//   from uint32 mixing of the model's four stream words w0..w3 and t:
//     ba_cfree: u = t / degree; v by the Batagelj-Brandes chain, each
//               hop's draw r = hash(w0, w1, j, 0) % (2j + 1) recomputed
//               while r is odd (j = r >> 1), at most CHAIN_BOUND = 64
//               hops; v = (r >> 1) / degree;
//     rmat:     one hash per level, three threshold compares give the
//               quadrant, u and v take one bit each per level;
//     er:       u = hash(w0, w1, t, 0) % n, v = hash(w2, w3, t, 0) % n.
//   hash(a, b, t, c) = mix(mix((t ^ a) + GOLDEN * (c + 1)) ^ b) with the
//   murmur-style finalizer mix; all arithmetic is native uint32.
//
// Replaces the JAX package's cfree_expand.py::cfree_expand_pallas, whose
// body _cfree_kernel works on (8, 128) VREG tiles and unrolls the chain
// as 64 masked hops (no per-lane branch on the TPU). Here a chain ends at
// its first even draw: an even r never changes again under the masked
// hops, so the values are the same, including a chain still odd after 64
// hops (both then map (r >> 1) / degree).
//
// Bound: bytes on the streams' slabs (12 B per edge: t read, u and v
// written), integer operations for rmat (log2 n hashes per edge). A slab
// of 2^20 edges is ~17 us of work, so ramp and tail count.
//
// Design.
//  - ba_cfree: chains are short on average (~2 draws per edge) but the
//    longest of 32 averages ~6, so one edge per lane per trip left lanes
//    idle ~2/3 of the time. Here each warp takes a tile of kPerLane * 32
//    consecutive edges and keeps a queue over it: every lane runs one
//    chain, and a lane whose chain ends takes the tile's next unstarted
//    edge (ballot + popc give each finishing lane its own), so all lanes
//    draw until the tile's last chains run out. A chain's final draw goes
//    to shared memory at its edge's position; t comes in and u, v go out
//    through shared memory with 16-byte loads and stores, each lane owning
//    kPerLane consecutive edges. A numpy model in the tests
//    (tests/cfree_queue_model.py) documents the intended claim order and
//    predicts lane use; the kernel itself is held to the plain version
//    by the card tests (its outputs do not depend on the claim order).
//  - u = t / degree and v = (r >> 1) / degree divide by a multiply-high
//    with the wrapper's magic (pk_expand.division_magic: exact for
//    numerators below 2^31, which t and r >> 1 are); degree 1 divides by
//    nothing. The chain's % (2j + 1), whose divisor changes per draw,
//    stays the hardware sequence.
//    Times (H100 SXM at 700 W, PERF.md), a 2^20 slab from the middle of
//    ba_cfree_1b, profiled device time, in turns with the earlier design:
//    one edge per lane per trip 17.0 us -> 15.0 us (modelled lane use
//    31.5% -> 78.5%); 4 or 16 edges per lane (64% / 88% modelled) took
//    16.3 / 17.6 us, cached instead of streaming loads and stores the
//    same. The same kernel with the chains taken out (load t, store u
//    and v) takes 7.1 us: at this size the launch's memory traffic alone
//    is ~1.9x its byte bound, and the draws (hash and hardware
//    remainder) take the rest.
//  - rmat and er: each thread takes 4 consecutive edges per trip (one
//    16-byte load of t, two 16-byte stores), grid-stride; er's % n takes
//    full 32-bit hashes and stays the hardware sequence.
//  - Alignment: edges are placed at positions j + phase, phase = t's
//    offset from 16 bytes in entries, so 16-byte quads of positions are
//    16-byte quads of t; a quad cut by either end of t takes scalar
//    loads and stores. u and v must share t's phase (the wrapper
//    allocates them so).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 8;                 // ba_cfree: edges per lane
constexpr int kWarpTile = 32 * kPerLane;    // edges per warp tile
constexpr int kChainBound = 64;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kMix1 = 0x7FEB352Du;
constexpr uint32_t kMix2 = 0x846CA68Bu;

enum Model { kBaCfree = 0, kRmat = 1, kEr = 2 };

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * kMix1;
  x = (x ^ (x >> 15)) * kMix2;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t cfree_hash(uint32_t a, uint32_t b,
                                               uint32_t t, uint32_t ctr) {
  return mix32(mix32((t ^ a) + kGolden * (ctr + 1u)) ^ b);
}

// x / degree for x < 2^31: magic 0 stands for degree 1.
__device__ __forceinline__ uint32_t div_degree(uint32_t x, uint32_t magic,
                                               int shift) {
  return magic ? __umulhi(x, magic) >> shift : x;
}

// The 4 entries of quad p (a position, multiple of 4) that lie in
// [lo, hi): one 16-byte load when all do.
__device__ __forceinline__ void load_quad(const int32_t* base, int64_t p,
                                          int64_t lo, int64_t hi,
                                          uint32_t x[4]) {
  if (p >= lo && p + 4 <= hi) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(base + p));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[b] = p + b >= lo && p + b < hi ? (uint32_t)base[p + b] : 0u;
  }
}

__device__ __forceinline__ void store_quad(int32_t* base, int64_t p,
                                           int64_t lo, int64_t hi,
                                           const uint32_t x[4]) {
  if (p >= lo && p + 4 <= hi) {
    __stcs(reinterpret_cast<int4*>(base + p),
           make_int4((int)x[0], (int)x[1], (int)x[2], (int)x[3]));
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (p + b >= lo && p + b < hi) __stcs(base + p + b, (int)x[b]);
  }
}

// ba_cfree: one warp per tile of kWarpTile positions, a queue over the
// tile's chains. tb, ub, vb point phase entries before t, u, v.
__global__ void __launch_bounds__(kThreads)
cfree_expand_kernel_ba(const int32_t* __restrict__ tb,
                       int32_t* __restrict__ ub, int32_t* __restrict__ vb,
                       int64_t m, int phase, uint32_t w0, uint32_t w1,
                       uint32_t magic, int shift,
                       int64_t tiles) {
  __shared__ uint32_t s_t[kWarps][kWarpTile];
  __shared__ uint32_t s_r[kWarps][kWarpTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  uint32_t* st = s_t[warp];
  uint32_t* sr = s_r[warp];
  const int64_t end = m + phase;
  for (int64_t k = (int64_t)blockIdx.x * kWarps + warp; k < tiles;
       k += (int64_t)gridDim.x * kWarps) {
    const int64_t p0 = k * kWarpTile;
    const int lo = p0 < phase ? (int)(phase - p0) : 0;
    const int hi = end - p0 < kWarpTile ? (int)(end - p0) : kWarpTile;
#pragma unroll
    for (int qq = 0; qq < kPerLane; qq += 4) {
      const int i = lane * kPerLane + qq;
      uint32_t x[4];
      load_quad(tb, p0 + i, phase, end, x);
#pragma unroll
      for (int b = 0; b < 4; ++b) st[i + b] = x[b];
    }
    __syncwarp();
    // The queue: lane-ordered refill from the tile's next unstarted edge.
    int idx = lo + lane;
    bool live = idx < hi;
    uint32_t j = live ? st[idx] : 0u;
    int hops = 0;
    int next = lo + 32;
    while (__any_sync(0xffffffffu, live)) {
      bool done = false;
      if (live) {
        const uint32_t r = cfree_hash(w0, w1, j, 0u) % ((j << 1) + 1u);
        if (!(r & 1u) || hops == kChainBound) {
          sr[idx] = r >> 1;
          done = true;
        } else {
          j = r >> 1;
          ++hops;
        }
      }
      const unsigned fin = __ballot_sync(0xffffffffu, done);
      if (done) {
        idx = next + __popc(fin & below);
        live = idx < hi;
        if (live) {
          j = st[idx];
          hops = 0;
        }
      }
      next += __popc(fin);
    }
    __syncwarp();
#pragma unroll
    for (int qq = 0; qq < kPerLane; qq += 4) {
      const int i = lane * kPerLane + qq;
      uint32_t uq[4], vq[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uq[b] = div_degree(st[i + b], magic, shift);
        vq[b] = div_degree(sr[i + b], magic, shift);
      }
      store_quad(ub, p0 + i, phase, end, uq);
      store_quad(vb, p0 + i, phase, end, vq);
    }
    __syncwarp();                                  // st, sr reused
  }
}

// rmat, er: 4 consecutive positions per thread per trip.
template <int kModel>
__global__ void __launch_bounds__(kThreads)
cfree_expand_kernel_quad(const int32_t* __restrict__ tb,
                         int32_t* __restrict__ ub, int32_t* __restrict__ vb,
                         int64_t m, int phase, uint32_t w0, uint32_t w1,
                         uint32_t w2, uint32_t w3, uint32_t n,
                         int levels, uint32_t ta, uint32_t tbh, uint32_t tc,
                         int64_t quads) {
  const int64_t end = m + phase;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < quads; q += step) {
    const int64_t p = 4 * q;
    uint32_t tt[4], u[4], v[4];
    load_quad(tb, p, phase, end, tt);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (kModel == kRmat) {
        uint32_t uu = 0u, vv = 0u;
        for (int level = 0; level < levels; ++level) {
          const uint32_t x = cfree_hash(w0, w1, tt[b], (uint32_t)level);
          const uint32_t qd = (uint32_t)(x >= ta) + (uint32_t)(x >= tbh) +
                              (uint32_t)(x >= tc);
          uu = (uu << 1) + (qd >> 1);
          vv = (vv << 1) + (qd & 1u);
        }
        u[b] = uu;
        v[b] = vv;
      } else {
        u[b] = cfree_hash(w0, w1, tt[b], 0u) % n;
        v[b] = cfree_hash(w2, w3, tt[b], 0u) % n;
      }
    }
    store_quad(ub, p, phase, end, u);
    store_quad(vb, p, phase, end, v);
  }
}

}  // namespace

// t: (m,) int32 >= 0; u, v: (m,) int32 outputs at t's offset from 16
// bytes (else cudaErrorMisalignedAddress). model: 0 ba_cfree, 1 rmat,
// 2 er; words w0..w3; n vertices; ba_cfree: (magic, shift) of the degree
// (pk_expand.division_magic; magic 0 for degree 1); rmat: levels = log2 n
// and thresholds ta <= tb <= tc. (grid, block): the launch of
// kernels/geometry.py's cfree_expand (grid-stride: any grid of at least
// one block).
extern "C" int repro_cfree_expand_i32(const void* t, void* u, void* v,
                                      int64_t m, int32_t model, uint32_t w0,
                                      uint32_t w1, uint32_t w2, uint32_t w3,
                                      uint32_t n, uint32_t magic,
                                      int32_t shift, int32_t levels,
                                      uint32_t ta, uint32_t tb, uint32_t tc,
                                      int64_t grid, int block,
                                      void* stream) {
  if (n < 1 || levels < 0 || shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  if (block != kThreads || grid < 1 || grid > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  if (m <= 0) return 0;
  const int phase = (int)(((uintptr_t)t >> 2) & 3);
  if ((int)(((uintptr_t)u >> 2) & 3) != phase ||
      (int)(((uintptr_t)v >> 2) & 3) != phase)
    return (int)cudaErrorMisalignedAddress;
  const int32_t* tp = (const int32_t*)t - phase;
  int32_t* up = (int32_t*)u - phase;
  int32_t* vp = (int32_t*)v - phase;
  const int64_t end = m + phase;
  cudaStream_t s = (cudaStream_t)stream;
  if (model == kBaCfree) {
    const int64_t tiles = (end + kWarpTile - 1) / kWarpTile;
    cfree_expand_kernel_ba<<<(unsigned)grid, kThreads, 0, s>>>(
        tp, up, vp, m, phase, w0, w1, magic, shift, tiles);
    return (int)cudaGetLastError();
  }
  const int64_t quads = (end + 3) / 4;
  switch (model) {
    case kRmat:
      cfree_expand_kernel_quad<kRmat><<<(unsigned)grid, kThreads, 0, s>>>(
          tp, up, vp, m, phase, w0, w1, w2, w3, n, levels, ta, tb, tc,
          quads);
      break;
    case kEr:
      cfree_expand_kernel_quad<kEr><<<(unsigned)grid, kThreads, 0, s>>>(
          tp, up, vp, m, phase, w0, w1, w2, w3, n, levels, ta, tb, tc,
          quads);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The compiled attributes of kernel k (0: cfree_expand_kernel_ba, 1:
// cfree_expand_kernel_quad<kRmat>, 2: cfree_expand_kernel_quad<kEr>) into
// out: numRegs, sharedSizeBytes, maxThreadsPerBlock, localSizeBytes.
// Returns a CUDA error code, or -1 past the last kernel.
extern "C" int repro_cfree_expand_kernel_attributes(int k, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (k == 0)
    e = cudaFuncGetAttributes(&a, cfree_expand_kernel_ba);
  else if (k == 1)
    e = cudaFuncGetAttributes(&a, cfree_expand_kernel_quad<kRmat>);
  else if (k == 2)
    e = cudaFuncGetAttributes(&a, cfree_expand_kernel_quad<kEr>);
  else
    return -1;
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* repro_cfree_expand_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
