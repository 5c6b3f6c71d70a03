// Row-batched stable band compaction for Hopper (sm_90a):
//   for each row r, the (u, v) pairs whose band flag is set move to the
//   front of (uo[r], vo[r]) in index order, the rest of the row is -1, and
//   pairs past column cap are dropped; uo and vo are (rows, cap).
//
// Replaces the JAX package's band_compact.py::_band_compact_kernel, an
// O(e * cap) one-hot accumulation with a cursor in SMEM (the TPU's vector
// unit has no scatter). On the card the same permutation is a prefix-sum
// compaction.
//
// Bound: bytes. The function must read band once (1 byte per entry), u
// and v where band is set and the pair is kept, and write both outputs
// once. On the streamed PBA path (64 rows of 5M entries, cap 2,097,152)
// the band of round r is the window occ in [r*C_r, (r+1)*C_r) of each
// edge's request rank, so the rounds run from dense (round 0: 41% of a
// row, every tile and ~78% of u/v's 32-byte sectors touched) to almost
// empty (rounds 6-10: <= 0.5%, <= 9% of tiles). The -1 padding is most of
// the output in every round after the first few.
//
// Design: two launches, one C entry.
//  1. count: block (tile, row) reads its tile of kVecs 16-byte band
//     vectors (16 flags per thread per load), turns each into a 16-bit
//     mask (__vcmpne4, one multiply per 4 flags), stores the masks to
//     scratch (an eighth of band's bytes) and its tile's band count.
//  2. scatter: block (tile, row) sums the row's tile counts (1-2 loads a
//     thread: there is no scan launch), so it knows its tile's offset and
//     the row total. It writes its share of the row's -1 padding, the
//     columns [row total, cap) cut into equal chunks per tile, with 16-byte
//     stores. A tile with no band entry, or whose offset is already >= cap,
//     stops there: it reads no mask and no u/v. Otherwise it walks its
//     masks 4096 entries per step: a block scan of the masks' popcounts,
//     then each thread takes 4 quads of 4 entries (consecutive across the
//     warp, so a warp's loads cover 512 contiguous bytes) and loads u and v
//     as one 16-byte vector per quad that holds a band entry (the sector is
//     fetched whole anyway), stages the band entries in shared memory at
//     their rank, and the block writes the staged run with 16-byte stores.
// Every output element is written once: values [0, min(total, cap)) by
// the tiles that hold them, padding [total, cap) by its chunk's tile. Tiles
// and steps walk entries in index order, so the compaction is stable.
// Rows whose band does not start on 16 bytes (e % 16 != 0, or a view)
// take a scalar head (tile 0) and tail (the last tile) of < 16 entries.
// Row offsets are 64-bit (64 rows of 5M entries is 320M entries); more
// than 65,535 rows loop over grid y.
//
// Times (H100 SXM at 700 W, PERF.md), the 11 rounds of one streamed run,
// in turns with the earlier design (count, scan and scatter launches
// after the caller's -1 fill): 20.3 -> 9.2 ms per run; round 0 2.49 ->
// 1.43-1.46 ms, the last rounds 1.58-1.61 -> 0.50-0.53 ms (bound 0.42).
// Dropped after measuring in turns: a single pass with tiles claimed in
// order and a decoupled look-back per row (each tile also writing a
// chunk of the previous row's padding once that row's total is out):
// 11.3 ms per run, slower at every round; tiles of 512 or 2,048 vectors,
// the 8 u/v loads of a step issued before any is staged (80 registers),
// and 40 registers for 6 blocks per SM: all within 3%.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 1024;                // 16-entry band vectors per tile
constexpr int kStepEntries = 16 * kThreads;  // entries per scatter step

struct Row {
  int head;      // entries before band's first 16-byte boundary in the row
  int64_t nv;    // 16-entry vectors from there
  int tail;      // entries after the last vector (< 16)
};

__device__ __forceinline__ Row row_shape(const uint8_t* row, int64_t e) {
  Row g;
  const int64_t h = (16 - ((uintptr_t)row & 15)) & 15;
  g.head = (int)(h < e ? h : e);
  g.nv = (e - g.head) >> 4;
  g.tail = (int)(e - g.head - 16 * g.nv);
  return g;
}

// 4 flag bytes -> 4 bits, byte i to bit i.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t mask16(uint4 x) {
  return nibble(x.x) | nibble(x.y) << 4 | nibble(x.z) << 8 |
         nibble(x.w) << 12;
}

// Sum over the block; every thread gets it. red: kWarps scratch slots.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* red) {
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();                                  // red reused
  return s;
}

// dst[0, n) = src[0, n) (src in shared memory): a scalar head up to
// dst's 16-byte boundary, 16-byte stores, a scalar tail.
__device__ __forceinline__ void store_run(int32_t* dst, const int32_t* src,
                                          int n) {
  int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2);
  head = head < n ? head : n;
  if ((int)threadIdx.x < head) __stcs(dst + threadIdx.x, src[threadIdx.x]);
  const int body = (n - head) >> 2;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += kThreads) {
    const int k = head + 4 * i;
    __stcs(d4 + i, make_int4(src[k], src[k + 1], src[k + 2], src[k + 3]));
  }
  const int done = head + 4 * body;
  if ((int)threadIdx.x < n - done)
    __stcs(dst + done + threadIdx.x, src[done + threadIdx.x]);
}

// dst[0, n) = -1, the same way.
__device__ __forceinline__ void fill_run(int32_t* dst, int64_t n) {
  int64_t head = ((16 - ((uintptr_t)dst & 15)) & 15) >> 2;
  head = head < n ? head : n;
  if ((int64_t)threadIdx.x < head) __stcs(dst + threadIdx.x, -1);
  const int64_t body = (n - head) >> 2;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const int4 pad = make_int4(-1, -1, -1, -1);
  for (int64_t i = threadIdx.x; i < body; i += kThreads) __stcs(d4 + i, pad);
  const int64_t done = head + 4 * body;
  if ((int64_t)threadIdx.x < n - done) __stcs(dst + done + threadIdx.x, -1);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ band, uint16_t* __restrict__ masks,
             int32_t* __restrict__ tile_counts, int64_t rows, int64_t e,
             int64_t nv_max, int n_tiles) {
  __shared__ int32_t red[kWarps];
  const int t = blockIdx.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint8_t* row = band + r * e;
    const Row g = row_shape(row, e);
    const uint4* vec = reinterpret_cast<const uint4*>(row + g.head);
    uint16_t* mrow = masks + r * nv_max;
    const int64_t q0 = (int64_t)t * kVecs;
    const int64_t q1 = q0 + kVecs < g.nv ? q0 + kVecs : g.nv;
    int32_t n = 0;
#pragma unroll 4
    for (int64_t q = q0 + threadIdx.x; q < q1; q += kThreads) {
      const uint32_t m = mask16(__ldcs(vec + q));
      mrow[q] = (uint16_t)m;
      n += __popc(m);
    }
    if (t == 0 && (int)threadIdx.x < g.head) n += row[threadIdx.x] != 0;
    if (t == n_tiles - 1 && (int)threadIdx.x < g.tail)
      n += row[g.head + 16 * g.nv + threadIdx.x] != 0;
    n = block_sum(n, red);
    if (threadIdx.x == 0) tile_counts[r * n_tiles + t] = n;
  }
}

template <bool kVecUV>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
               const uint8_t* __restrict__ band,
               const uint16_t* __restrict__ masks,
               const int32_t* __restrict__ tile_counts,
               int32_t* __restrict__ uo, int32_t* __restrict__ vo,
               int64_t rows, int64_t e, int64_t cap, int64_t nv_max,
               int n_tiles, int64_t pad_chunk) {
  __shared__ int32_t s_u[kStepEntries];
  __shared__ int32_t s_v[kStepEntries];
  __shared__ uint32_t s_mask[kThreads];
  __shared__ int32_t s_pref[kThreads];      // exclusive, within the warp
  __shared__ int32_t s_wtot[kWarps];
  __shared__ int64_t red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int t = blockIdx.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    // This tile's offset in the row and the row's total.
    const int32_t* crow = tile_counts + r * n_tiles;
    int64_t before = 0, total = 0;
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) {
      const int32_t c = crow[i];
      total += c;
      before += i < t ? c : 0;
    }
    before = block_sum(before, red);
    total = block_sum(total, red);
    const int32_t own = crow[t];

    // This tile's chunk of the padding [total, cap).
    int32_t* urow = uo + r * cap;
    int32_t* vrow = vo + r * cap;
    const int64_t c_lo = (int64_t)t * pad_chunk;
    const int64_t p0 = total > c_lo ? total : c_lo;
    const int64_t p1 = c_lo + pad_chunk < cap ? c_lo + pad_chunk : cap;
    if (p1 > p0) {
      fill_run(urow + p0, p1 - p0);
      fill_run(vrow + p0, p1 - p0);
    }
    if (own == 0 || before >= cap) continue;       // uniform over the block

    const uint8_t* brow = band + r * e;
    const Row g = row_shape(brow, e);
    const int32_t* ur = u + r * e;
    const int32_t* vr = v + r * e;
    int64_t pos = before;
    if (t == 0 && g.head > 0) {                    // scalar head
      const bool f = lane < g.head && brow[lane] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      const int64_t dst = pos + __popc(m & below);
      if (warp == 0 && f && dst < cap) {
        urow[dst] = ur[lane];
        vrow[dst] = vr[lane];
      }
      pos += __popc(m);
    }
    const uint16_t* mrow = masks + r * nv_max;
    const int64_t q0 = (int64_t)t * kVecs;
    const int64_t q1 = q0 + kVecs < g.nv ? q0 + kVecs : g.nv;
    for (int64_t q = q0; q < q1 && pos < cap; q += kThreads) {
      // Block scan of the step's 16-bit masks.
      const int64_t qi = q + threadIdx.x;
      const uint32_t m = qi < q1 ? mrow[qi] : 0u;
      const int c = __popc(m);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      s_mask[threadIdx.x] = m;
      s_pref[threadIdx.x] = incl - c;
      if (lane == 31) s_wtot[warp] = incl;
      __syncthreads();
      int wtot[kWarps];
      int step = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        wtot[w] = s_wtot[w];
        step += wtot[w];
      }
      if (step > 0) {
        // Quad j (4 entries) of the step: its owner's mask nibble.
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = threadIdx.x + k * kThreads;
          const int owner = j >> 2, sub = j & 3;
          const uint32_t mm = s_mask[owner];
          const uint32_t nib = (mm >> (4 * sub)) & 0xFu;
          if (nib == 0) continue;
          int rank = s_pref[owner] + __popc(mm & ((1u << (4 * sub)) - 1u));
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            rank += w < (owner >> 5) ? wtot[w] : 0;
          const int64_t at = g.head + 16 * (q + owner) + 4 * sub;
          int32_t uq[4], vq[4];
          if (kVecUV) {
            const int4 a = __ldcs(reinterpret_cast<const int4*>(ur + at));
            const int4 b = __ldcs(reinterpret_cast<const int4*>(vr + at));
            uq[0] = a.x; uq[1] = a.y; uq[2] = a.z; uq[3] = a.w;
            vq[0] = b.x; vq[1] = b.y; vq[2] = b.z; vq[3] = b.w;
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              uq[b] = (nib >> b) & 1u ? __ldcs(ur + at + b) : 0;
              vq[b] = (nib >> b) & 1u ? __ldcs(vr + at + b) : 0;
            }
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if ((nib >> b) & 1u) {
              s_u[rank] = uq[b];
              s_v[rank] = vq[b];
              ++rank;
            }
          }
        }
        __syncthreads();
        const int n = (int)(cap - pos < step ? cap - pos : step);
        store_run(urow + pos, s_u, n);
        store_run(vrow + pos, s_v, n);
      }
      __syncthreads();                 // s_mask, s_wtot, s_u, s_v reused
      pos += step;
    }
    if (t == n_tiles - 1 && g.tail > 0 && pos < cap) {   // scalar tail
      const int64_t at = g.head + 16 * g.nv + lane;
      const bool f = lane < g.tail && brow[at] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      const int64_t dst = pos + __popc(m & below);
      if (warp == 0 && f && dst < cap) {
        urow[dst] = ur[at];
        vrow[dst] = vr[at];
      }
    }
  }
}

}  // namespace

// Scratch bytes for (rows, e): per-tile counts, then 16-bit band masks.
extern "C" int64_t repro_band_compact_scratch_bytes(int64_t rows,
                                                    int64_t e) {
  const int64_t nv_max = e >> 4;
  const int64_t n_tiles = nv_max > 0 ? (nv_max + kVecs - 1) / kVecs : 1;
  return rows * n_tiles * 4 + rows * nv_max * 2;
}

// u, v: (rows, e) int32; band: (rows, e) bool (one byte, 0 or nonzero);
// uo, vo: (rows, cap) int32, written in full; scratch:
// repro_band_compact_scratch_bytes(rows, e) bytes, 4-byte aligned, any
// contents. Launches two kernels on stream.
extern "C" int repro_band_compact_i32(const void* u, const void* v,
                                      const void* band, void* uo, void* vo,
                                      void* scratch, int64_t rows,
                                      int64_t e, int64_t cap, void* stream) {
  if (rows <= 0 || e <= 0 || cap <= 0) return 0;
  const int64_t nv_max = e >> 4;
  const int64_t n_tiles = nv_max > 0 ? (nv_max + kVecs - 1) / kVecs : 1;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int64_t pad_chunk = (cap + n_tiles - 1) / n_tiles;
  pad_chunk = (pad_chunk + 3) & ~(int64_t)3;
  int32_t* tile_counts = (int32_t*)scratch;
  uint16_t* masks = (uint16_t*)(tile_counts + rows * n_tiles);
  const int64_t by = rows < 65535 ? rows : 65535;
  const dim3 grid((unsigned)n_tiles, (unsigned)by);
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<grid, kThreads, 0, s>>>((const uint8_t*)band, masks,
                                         tile_counts, rows, e, nv_max,
                                         (int)n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // u and v take 16-byte loads where band's 16-byte vectors start on a
  // 16-byte boundary of theirs too: (address / 4 - band address) % 4 == 0.
  const uintptr_t b = (uintptr_t)band;
  const bool vec_uv = ((((uintptr_t)u >> 2) - b) & 3) == 0 &&
                      ((((uintptr_t)v >> 2) - b) & 3) == 0;
  if (vec_uv)
    scatter_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int32_t*)u, (const int32_t*)v, (const uint8_t*)band, masks,
        tile_counts, (int32_t*)uo, (int32_t*)vo, rows, e, cap, nv_max,
        (int)n_tiles, pad_chunk);
  else
    scatter_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int32_t*)u, (const int32_t*)v, (const uint8_t*)band, masks,
        tile_counts, (int32_t*)uo, (int32_t*)vo, rows, e, cap, nv_max,
        (int)n_tiles, pad_chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_band_compact_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
