// Kronecker meta-edge expansion for Hopper (sm_90a): the PK inner loop.
//   For each local edge index t[j] (int32, >= 0) of a range that starts
//   at the MSB-first base-e0 digits base[0..L-1]:
//     digits of t[j] in base e0 (LSB first), carry-added to base;
//     where flip[l, j] is set, digit l (MSB-first level l) is redraw[l, j];
//     u[j] = sum_l seed_u[d_l] * n0^(L-1-l),  v[j] likewise.
//
// Replaces the JAX package's pk_expand.py::pk_expand_pallas, both bodies
// (_expand_kernel and _noise_wrapper): (8, 128) int32 VREG tiles, with
// the seed-table lookups done as one-hot x table matmuls because Mosaic
// has no dynamic gather. Here one thread owns one edge: it peels the
// digits LSB first by / and % e0, carries, applies the noise of its level
// (flip and redraw are (L, m), so a warp reads 32 neighbouring entries of
// one level row), and accumulates u += seed_u[d] * n0^k with a running
// power. In uint32 that sum equals the reference's MSB-first int32 Horner
// bit for bit (both are the same polynomial mod 2^32), and no register
// array sized by L is needed.
//
// The seed tables are staged in shared memory when both fit in kSharedTab
// entries each; a larger e0 (dense_power_seed makes e0 = n0 * degree)
// reads them through the read-only cache in the same kernel (template
// flag). A null flip pointer selects the body without noise. The range
// start's digits ride in the kernel's parameter space (__grid_constant__,
// read per level without a copy).
//
// Bound: integer operations at the levels the paper uses (about ten 32-bit
// ops per edge and level: a division, a remainder, the carry add, the
// lookups' multiply-adds); bytes only at small L (t read once, u and v
// written once: 12 B per edge, plus 5 B per edge and level with noise).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 64;
constexpr int kSharedTab = 4096;           // 2 tables x 4096 x 4 B = 32 KiB

struct Digits {
  int32_t d[kMaxLevels];
};

template <bool kShared>
__global__ void pk_expand_kernel(const int32_t* __restrict__ t,
                                 const int32_t* __restrict__ seed_u,
                                 const int32_t* __restrict__ seed_v,
                                 const uint8_t* __restrict__ flip,
                                 const int32_t* __restrict__ redraw,
                                 int32_t* __restrict__ u_out,
                                 int32_t* __restrict__ v_out, int64_t m,
                                 uint32_t n0, uint32_t e0, int levels,
                                 const __grid_constant__ Digits base) {
  extern __shared__ int32_t tab[];
  const int32_t* su = seed_u;
  const int32_t* sv = seed_v;
  if (kShared) {
    for (uint32_t i = threadIdx.x; i < e0; i += blockDim.x) {
      tab[i] = seed_u[i];
      tab[e0 + i] = seed_v[i];
    }
    __syncthreads();
    su = tab;
    sv = tab + e0;
  }
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += step) {
    uint32_t rem = (uint32_t)__ldg(t + j);
    uint32_t carry = 0, pw = 1, u = 0, v = 0;
    for (int k = 0; k < levels; ++k) {          // k-th digit from the LSB
      const int level = levels - 1 - k;         // its MSB-first level
      uint32_t d = rem % e0 + (uint32_t)base.d[level] + carry;
      rem /= e0;
      carry = d >= e0;
      if (carry) d -= e0;
      if (flip != nullptr) {
        const int64_t off = (int64_t)level * m + j;
        if (__ldg(flip + off)) d = (uint32_t)__ldg(redraw + off);
      }
      int32_t tu, tv;
      if (kShared) {
        tu = su[d];
        tv = sv[d];
      } else {
        tu = __ldg(su + d);
        tv = __ldg(sv + d);
      }
      u += (uint32_t)tu * pw;
      v += (uint32_t)tv * pw;
      pw *= n0;
    }
    u_out[j] = (int32_t)u;
    v_out[j] = (int32_t)v;
  }
}

}  // namespace

extern "C" int repro_pk_expand_max_levels() { return kMaxLevels; }
extern "C" int repro_pk_expand_shared_entries() { return kSharedTab; }

// t: (m,) int32 >= 0; base: host array of L int32 digits (MSB first, each
// in [0, e0)); seed_u, seed_v: (e0,) int32 device tables; flip: (L, m)
// bool or null, redraw: (L, m) int32 digits in [0, e0) (used only with
// flip); u, v: (m,) int32 outputs. blocks: grid size (the wrapper fills
// the card).
extern "C" int repro_pk_expand_i32(const void* t, const int32_t* base,
                                   const void* seed_u, const void* seed_v,
                                   const void* flip, const void* redraw,
                                   void* u, void* v, int64_t m, int32_t n0,
                                   int32_t e0, int32_t levels, int64_t blocks,
                                   void* stream) {
  if (levels < 0 || levels > kMaxLevels || e0 < 1 || n0 < 1)
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  Digits digits;
  for (int i = 0; i < kMaxLevels; ++i) digits.d[i] = i < levels ? base[i] : 0;
  int64_t need = (m + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(need < blocks ? need : blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (e0 <= kSharedTab) {
    pk_expand_kernel<true><<<grid, kThreads, 2 * e0 * sizeof(int32_t), s>>>(
        (const int32_t*)t, (const int32_t*)seed_u, (const int32_t*)seed_v,
        (const uint8_t*)flip, (const int32_t*)redraw, (int32_t*)u,
        (int32_t*)v, m, (uint32_t)n0, (uint32_t)e0, levels, digits);
  } else {
    pk_expand_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int32_t*)t, (const int32_t*)seed_u, (const int32_t*)seed_v,
        (const uint8_t*)flip, (const int32_t*)redraw, (int32_t*)u,
        (int32_t*)v, m, (uint32_t)n0, (uint32_t)e0, levels, digits);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_pk_expand_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
