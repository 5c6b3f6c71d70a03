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
// has no dynamic gather.
//
// Bound: bytes at the paths' shapes (t read once, u and v written once:
// 12 B per edge; with noise, flip's byte per edge and level and the
// 32-byte sectors of redraw that set flips touch), operations close
// behind. The card has no integer divider: a / or % by a divisor known
// only at run time compiles to some twenty instructions. So the host
// passes a round-up multiplier for e0 (Granlund-Montgomery, as CUTLASS's
// FastDivmod) and the kernel divides by __umulhi and a shift, and takes
// the remainder with one multiply-subtract. Every numerator is below 2^31
// (t >= 0 is int32, and each quotient is smaller), which makes the
// round-up multiplier exact with no add-back. e0 = 1 has no 32-bit
// multiplier; every digit is then 0 whatever t, so the kernel starts from
// a zero numerator. The powers n0^k mod 2^32 ride in the parameter block
// (__grid_constant__) beside the range start's digits, so the per-level
// sum waits on no running product. In uint32 that sum, LSB first, equals
// the reference's MSB-first int32 Horner bit for bit (the same polynomial
// mod 2^32).
//
// Each thread expands four consecutive edges: one int4 load of t, int4
// stores of u and v, four independent digit chains for the scheduler to
// interleave, and with noise one 32-bit load of the four flip bytes per
// level (a warp reads 128 B of one level row; redraw is read only where a
// flip is set). The vector path needs t, u and v 16-byte aligned (and
// flip 4-byte aligned); a flip row that starts off a word boundary
// (m % 4 != 0) is read as two aligned words and a funnel shift. A
// misaligned pointer (a view such as t[3:]) or the tail of m takes the
// same kernel's one-edge loop. The seed tables are staged in shared
// memory when both fit in kSharedTab entries each; a larger e0
// (dense_power_seed makes e0 = n0 * degree) reads them through the
// read-only cache (template flag). A null flip pointer selects the body
// without noise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 64;
constexpr int kSharedTab = 4096;           // 2 tables x 4096 x 4 B = 32 KiB
constexpr int kVec = 4;                    // edges per thread, vector path

struct Params {
  int32_t digit[kMaxLevels];               // range start, MSB first
  uint32_t pw[kMaxLevels];                 // n0^k mod 2^32, k from the LSB
};

struct Radix {
  uint32_t e0, magic, shift;               // q = umulhi(n, magic) >> shift
};

// The four flip bytes flip[off .. off+3] as one word, byte e for edge e.
// off & 3 is the same for every thread of a level; when it is not 0 the
// caller keeps the second aligned word inside the buffer.
__device__ __forceinline__ uint32_t flip_word(const uint8_t* flip,
                                              int64_t off) {
  const int s = (int)(off & 3);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(flip + (off - s));
  const uint32_t lo = __ldg(w);
  return s == 0 ? lo : __funnelshift_r(lo, __ldg(w + 1), 8 * s);
}

// Expands the N consecutive edges j .. j+N-1 whose indices are t[0..N-1].
template <int N, bool kShared>
__device__ __forceinline__ void expand(const uint32_t (&t)[N], int64_t j,
                                       const int32_t* su, const int32_t* sv,
                                       const uint8_t* flip,
                                       const int32_t* redraw, int64_t m,
                                       int levels, const Radix& rx,
                                       const Params& p, uint32_t (&u)[N],
                                       uint32_t (&v)[N]) {
  uint32_t rem[N], carry[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    rem[e] = rx.e0 == 1 ? 0u : t[e];
    carry[e] = 0;
    u[e] = 0;
    v[e] = 0;
  }
  for (int k = 0; k < levels; ++k) {          // k-th digit from the LSB
    const int level = levels - 1 - k;         // its MSB-first level
    const uint32_t b = (uint32_t)p.digit[level];
    const uint32_t pw = p.pw[k];
    const int64_t off = (int64_t)level * m + j;
    uint32_t flips = 0;
    if (flip != nullptr) flips = N == kVec ? flip_word(flip, off)
                                           : (uint32_t)__ldg(flip + off);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const uint32_t q = __umulhi(rem[e], rx.magic) >> rx.shift;
      uint32_t d = rem[e] - q * rx.e0 + b + carry[e];
      rem[e] = q;
      carry[e] = d >= rx.e0;
      if (carry[e]) d -= rx.e0;
      if ((flips >> (8 * e)) & 0xFFu) d = (uint32_t)__ldg(redraw + off + e);
      int32_t tu, tv;
      if (kShared) {
        tu = su[d];
        tv = sv[d];
      } else {
        tu = __ldg(su + d);
        tv = __ldg(sv + d);
      }
      u[e] += (uint32_t)tu * pw;
      v[e] += (uint32_t)tv * pw;
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    pk_expand_kernel(const int32_t* __restrict__ t,
                     const int32_t* __restrict__ seed_u,
                     const int32_t* __restrict__ seed_v,
                     const uint8_t* __restrict__ flip,
                     const int32_t* __restrict__ redraw,
                     int32_t* __restrict__ u_out,
                     int32_t* __restrict__ v_out, int64_t m, int64_t nvec,
                     Radix rx, int levels,
                     const __grid_constant__ Params p) {
  extern __shared__ int32_t tab[];
  const int32_t* su = seed_u;
  const int32_t* sv = seed_v;
  if (kShared) {
    for (uint32_t i = threadIdx.x; i < rx.e0; i += blockDim.x) {
      tab[i] = seed_u[i];
      tab[rx.e0 + i] = seed_v[i];
    }
    __syncthreads();
    su = tab;
    sv = tab + rx.e0;
  }
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < nvec; i += step) {
    const int4 t4 = __ldg(reinterpret_cast<const int4*>(t) + i);
    const uint32_t tt[kVec] = {(uint32_t)t4.x, (uint32_t)t4.y,
                               (uint32_t)t4.z, (uint32_t)t4.w};
    uint32_t u[kVec], v[kVec];
    expand<kVec, kShared>(tt, kVec * i, su, sv, flip, redraw, m, levels, rx,
                          p, u, v);
    reinterpret_cast<int4*>(u_out)[i] =
        make_int4((int)u[0], (int)u[1], (int)u[2], (int)u[3]);
    reinterpret_cast<int4*>(v_out)[i] =
        make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  }
  for (int64_t j = kVec * nvec + tid; j < m; j += step) {
    const uint32_t tt[1] = {(uint32_t)__ldg(t + j)};
    uint32_t u[1], v[1];
    expand<1, kShared>(tt, j, su, sv, flip, redraw, m, levels, rx, p, u, v);
    u_out[j] = (int32_t)u[0];
    v_out[j] = (int32_t)v[0];
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || (uintptr_t)p % bytes == 0;
}

}  // namespace

extern "C" int repro_pk_expand_max_levels() { return kMaxLevels; }
extern "C" int repro_pk_expand_shared_entries() { return kSharedTab; }

// t: (m,) int32 >= 0; base: host array of L int32 digits (MSB first, each
// in [0, e0)); seed_u, seed_v: (e0,) int32 device tables; flip: (L, m)
// bool or null, redraw: (L, m) int32 digits in [0, e0) (used only with
// flip); u, v: (m,) int32 outputs; (magic, shift): the round-up
// multiplier of e0 (any value when e0 == 1). (grid, block, smem): the
// launch of kernels/geometry.py's pk_expand (grid-stride, so any grid of
// at least one block; smem holds both seed tables when e0 <= kSharedTab).
extern "C" int repro_pk_expand_i32(const void* t, const int32_t* base,
                                   const void* seed_u, const void* seed_v,
                                   const void* flip, const void* redraw,
                                   void* u, void* v, int64_t m, int32_t n0,
                                   int32_t e0, int32_t levels,
                                   uint32_t magic, int32_t shift,
                                   int64_t grid, int block, int64_t smem,
                                   void* stream) {
  if (levels < 0 || levels > kMaxLevels || e0 < 1 || n0 < 1 || shift < 0 ||
      shift > 31)
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  Params p;
  uint32_t pw = 1;
  for (int i = 0; i < kMaxLevels; ++i) {
    p.digit[i] = i < levels ? base[i] : 0;
    p.pw[i] = pw;
    pw *= (uint32_t)n0;
  }
  const Radix rx = {(uint32_t)e0, magic, (uint32_t)shift};
  // The vector path: t, u, v on 16 bytes and flip on 4. When a flip row
  // starts off a word boundary, the last vector group must leave the
  // second word of its funnel shift inside the buffer: stop it 4 edges
  // early (the one-edge loop takes the rest).
  int64_t nvec = 0;
  if (aligned(t, 16) && aligned(u, 16) && aligned(v, 16) &&
      aligned(flip, 4)) {
    nvec = (flip != nullptr && m % kVec != 0) ? (m - kVec) / kVec
                                              : m / kVec;
    if (nvec < 0) nvec = 0;
  }
  if (block != kThreads || grid < 1 || grid > 0x7fffffff || smem < 0 ||
      smem > 48 * 1024 ||
      (e0 <= kSharedTab && smem < 2 * e0 * (int64_t)sizeof(int32_t)))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (e0 <= kSharedTab) {
    pk_expand_kernel<true><<<(unsigned)grid, kThreads, (size_t)smem, s>>>(
        (const int32_t*)t, (const int32_t*)seed_u, (const int32_t*)seed_v,
        (const uint8_t*)flip, (const int32_t*)redraw, (int32_t*)u,
        (int32_t*)v, m, nvec, rx, levels, p);
  } else {
    pk_expand_kernel<false><<<(unsigned)grid, kThreads, (size_t)smem, s>>>(
        (const int32_t*)t, (const int32_t*)seed_u, (const int32_t*)seed_v,
        (const uint8_t*)flip, (const int32_t*)redraw, (int32_t*)u,
        (int32_t*)v, m, nvec, rx, levels, p);
  }
  return (int)cudaGetLastError();
}

// The compiled attributes of kernel k (0: pk_expand_kernel<true>, the
// tables in shared memory, 1: pk_expand_kernel<false>) into out: numRegs,
// sharedSizeBytes, maxThreadsPerBlock, localSizeBytes. Returns a CUDA
// error code, or -1 past the last kernel.
extern "C" int repro_pk_expand_kernel_attributes(int k, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (k == 0)
    e = cudaFuncGetAttributes(&a, pk_expand_kernel<true>);
  else if (k == 1)
    e = cudaFuncGetAttributes(&a, pk_expand_kernel<false>);
  else
    return -1;
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* repro_pk_expand_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
