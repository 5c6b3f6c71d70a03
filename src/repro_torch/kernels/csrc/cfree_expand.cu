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
// as 64 masked hops (no per-lane branch on the TPU). Here one thread owns
// one edge and its chain ends at the first even draw: an even r never
// changes again under the masked hops, so the values are the same,
// including a chain still odd after 64 hops (both then map (r >> 1) /
// degree). The expected number of draws is about two per edge.
//
// Bound: integer operations. The kernel reads t and writes u and v
// (12 B per edge) but does ~20 32-bit ops per hash, one hash per draw
// (ba_cfree: ~2 draws and a runtime-divisor remainder each; rmat: log2 n
// hashes; er: two hashes and two remainders).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

template <int kModel>
__global__ void cfree_expand_kernel(const int32_t* __restrict__ t,
                                    int32_t* __restrict__ u_out,
                                    int32_t* __restrict__ v_out, int64_t m,
                                    uint32_t w0, uint32_t w1, uint32_t w2,
                                    uint32_t w3, uint32_t n, int32_t degree,
                                    int levels, uint32_t ta, uint32_t tb,
                                    uint32_t tc) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += step) {
    const uint32_t tt = (uint32_t)__ldg(t + j);
    uint32_t u, v;
    if (kModel == kBaCfree) {
      uint32_t r = cfree_hash(w0, w1, tt, 0u) % ((tt << 1) + 1u);
      for (int h = 0; h < kChainBound && (r & 1u); ++h) {
        const uint32_t jj = r >> 1;
        r = cfree_hash(w0, w1, jj, 0u) % ((jj << 1) + 1u);
      }
      u = tt / (uint32_t)degree;
      v = (r >> 1) / (uint32_t)degree;
    } else if (kModel == kRmat) {
      u = 0u;
      v = 0u;
      for (int level = 0; level < levels; ++level) {
        const uint32_t x = cfree_hash(w0, w1, tt, (uint32_t)level);
        const uint32_t q = (uint32_t)(x >= ta) + (uint32_t)(x >= tb) +
                           (uint32_t)(x >= tc);
        u = (u << 1) + (q >> 1);
        v = (v << 1) + (q & 1u);
      }
    } else {
      u = cfree_hash(w0, w1, tt, 0u) % n;
      v = cfree_hash(w2, w3, tt, 0u) % n;
    }
    u_out[j] = (int32_t)u;
    v_out[j] = (int32_t)v;
  }
}

}  // namespace

// t: (m,) int32 >= 0; u, v: (m,) int32 outputs. model: 0 ba_cfree, 1 rmat,
// 2 er; words w0..w3; n vertices; degree (ba_cfree); levels = log2 n and
// thresholds ta <= tb <= tc (rmat). blocks: grid size (the wrapper fills
// the card).
extern "C" int repro_cfree_expand_i32(const void* t, void* u, void* v,
                                      int64_t m, int32_t model, uint32_t w0,
                                      uint32_t w1, uint32_t w2, uint32_t w3,
                                      uint32_t n, int32_t degree,
                                      int32_t levels, uint32_t ta,
                                      uint32_t tb, uint32_t tc,
                                      int64_t blocks, void* stream) {
  if (n < 1 || (model == kBaCfree && degree < 1) || levels < 0)
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  const int64_t need = (m + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(need < blocks ? need : blocks);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* tp = (const int32_t*)t;
  int32_t* up = (int32_t*)u;
  int32_t* vp = (int32_t*)v;
  switch (model) {
    case kBaCfree:
      cfree_expand_kernel<kBaCfree><<<grid, kThreads, 0, s>>>(
          tp, up, vp, m, w0, w1, w2, w3, n, degree, levels, ta, tb, tc);
      break;
    case kRmat:
      cfree_expand_kernel<kRmat><<<grid, kThreads, 0, s>>>(
          tp, up, vp, m, w0, w1, w2, w3, n, degree, levels, ta, tb, tc);
      break;
    case kEr:
      cfree_expand_kernel<kEr><<<grid, kThreads, 0, s>>>(
          tp, up, vp, m, w0, w1, w2, w3, n, degree, levels, ta, tb, tc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cfree_expand_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
