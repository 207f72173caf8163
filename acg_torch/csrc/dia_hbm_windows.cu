// DIA SpMV with x staged through one shared-memory window per offset
// cluster, with an optional fused <x, y>:
//
//   y[i] = sum_d band[d, i] * x[i + off[d]]      (0 <= i + off[d] < n)
//   dot  = sum_i x[i] * y[i]                      (with_dot: CG's p'Ap)
//
// Replaces the TPU kernel acg_tpu/ops/pallas_kernels.py
// dia_matvec_pallas_hbm2d (_dia_hbm2d_kernel, windows from
// _cluster_windows): the fallback for x past the on-chip store when the
// offset span is too wide for a ring (a 3-D operator's +-nx*ny bands).
//
// Bound on this card: bytes.  Per call the kernel must read D*n band
// values at their storage width, read x once and write y once; its
// 2*D*n flops are far below the card's rate on that traffic.  The
// diagonals are grouped by offset into clusters (acg_torch/ops/
// dia_plan.py cluster_windows: offsets within 1024 elements share one);
// for a tile of T rows at base, cluster c's window is x[base + lo_c,
// base + T + hi_c), so each band's reads are a contiguous, statically
// offset slice of its cluster's window.  A window starts up to one
// 16-byte chunk before base + lo_c, so that it starts 16-byte aligned
// whatever the offset (a band at offset +-1 or +-nx starts anywhere).
//
// What the design does about the bytes:
// - Tile order.  The grid is persistent and walks the tiles in the wave
//   order (acg::wave_tiles: block b takes b, b + nb, ...), so all
//   blocks move through x together and a tile's far windows (+-nx*ny,
//   about a hundred tiles away at 464^3) were streamed by other blocks
//   within about one wave: they come from the L2, and x is read from
//   device memory about once instead of once per cluster.
// - Pipeline.  Each block has one producer warp and eight consumer
//   warps.  The producer's one thread fills a ring of ``stages``
//   buffers, each holding every cluster's window and every band's tile
//   of one tile, with 1-D bulk copies (the TMA's cp.async.bulk, one per
//   window and one per band tile, the bands marked evict-first in the
//   L2 so that they do not push x out), each stage's arrival tracked by
//   its "full" mbarrier (expect_tx of the stage's bytes).  A consumer
//   warp waits on a stage's full barrier, sums its rows from shared
//   memory and arrives on the stage's "empty" barrier; the producer
//   refills a stage when all eight warps have arrived.  No block-wide
//   barrier inside the loop: up to ``stages`` tiles are in flight while
//   the warps compute, and each warp runs on as soon as its own rows
//   are done.
// - Tiles the bulk copies cannot take (a window or a band tile reaching
//   outside [0, n), the ragged last tile, or band rows that are not
//   16-byte aligned; at 464^3 about a hundred tiles at either end of
//   the vector) are summed by the consumers straight from device memory
//   with acg::dia_row, in their turn of the wave order.
// Rows are summed by the row bodies of dia_spmv (acg::dia_row_interior,
// its band count fixed at 7 for the 7-band operators, and acg::dia_row at
// the ends), so y has dia_spmv's bits; the dot goes
// through per-block partials and the fixed one-block tree, so its bits
// depend on n and the plan alone.
#include "common.cuh"

namespace {

using acg::bulk_load;
using acg::bulk_load_once;
using acg::evict_first_policy;
using acg::kThreads;
using acg::mbar_arrive;
using acg::mbar_expect_tx;
using acg::mbar_init;
using acg::mbar_wait;

constexpr int kWarps = kThreads / 32;  // consumer warps
constexpr int kBlock = kThreads + 32;  // and one producer warp

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// table: per cluster (lo, length, base) then, per band, its cluster (-1
// for a band that lies wholly outside the vector).  mis: x's address
// modulo 16 bytes, in elements.  Dynamic shared memory: a head of the
// 2 x stages mbarriers and each band's window position (ndiags ints),
// rounded up to 128 bytes, then ``stages`` buffers, each every cluster's
// window (buflen values of x, rounded up to 16 bytes) and the ndiags
// band tiles (ndiags x tile stored values, rounded up to 16 bytes).
// D > 0: the band count, fixed at compile time; 0: any.
template <typename V, typename B, bool SCALED, bool DOT, int D>
__global__ void __launch_bounds__(kBlock)
dia_windows_kernel(const B* __restrict__ bands, const V* __restrict__ scales,
                   const int64_t* __restrict__ offsets, int64_t ndiags,
                   const V* __restrict__ x, V* __restrict__ y,
                   V* __restrict__ partials, int64_t n, int tile,
                   const int64_t* __restrict__ table, int nclusters,
                   int buflen, int64_t ntiles, int mis, bool bands_aligned,
                   int stages) {
  constexpr int kVe = 16 / static_cast<int>(sizeof(V));
  extern __shared__ __align__(128) unsigned char acg_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(acg_smem);
  uint64_t* empty = full + stages;
  int* pos = reinterpret_cast<int*>(empty + stages);
  const int head = (16 * stages + 4 * static_cast<int>(ndiags) + 127) /
                   128 * 128;
  const int win_bytes =
      (buflen * static_cast<int>(sizeof(V)) + 15) / 16 * 16;
  const int band_bytes =
      (static_cast<int>(ndiags) * tile * static_cast<int>(sizeof(B)) + 15) /
      16 * 16;
  unsigned char* ring = acg_smem + head;
  auto stage_win = [&](int s) {
    return reinterpret_cast<V*>(ring + s * (win_bytes + band_bytes));
  };
  auto stage_band = [&](int s) {
    return reinterpret_cast<B*>(ring + s * (win_bytes + band_bytes) +
                                win_bytes);
  };
  // how far a cluster's window starts before base + lo so that its
  // first element sits on a 16-byte boundary of x
  auto shift_of = [&](int64_t clo) {
    const int64_t r = (clo + mis) % kVe;
    return static_cast<int>(r < 0 ? r + kVe : r);
  };
  // band d of row i of a tile reads its window at pos[d] + i
  for (int64_t d = threadIdx.x; d < ndiags; d += kBlock) {
    const int64_t c = table[3 * nclusters + d];
    int p = 0;
    if (c >= 0) {
      const int64_t clo = table[3 * c];
      p = static_cast<int>(table[3 * c + 2] + offsets[d] - clo) +
          shift_of(clo);
    }
    pos[d] = p;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    acg::mbar_fence_init();
  }
  __syncthreads();

  // The tiles [b0, b1) that arrive by bulk copies: no band leaves the
  // vector, every window lies inside [0, n), the tile is whole and the
  // band rows are 16-byte aligned.  Tile t's window of cluster c starts
  // at t * tile + lo_c - shift_c.
  int64_t b0, b1;
  acg::interior_tiles(offsets, ndiags, n, tile, b0, b1);
  if (!bands_aligned) b1 = b0;
  b1 = b1 < n / tile ? b1 : n / tile;
  for (int c = 0; c < nclusters; ++c) {
    const int64_t start = table[3 * c] - shift_of(table[3 * c]);
    const int64_t first = -floor_div(start, tile);   // t * tile + start >= 0
    const int64_t last =
        floor_div(n - start - table[3 * c + 1], tile) + 1;
    b0 = first > b0 ? first : b0;
    b1 = last < b1 ? last : b1;
  }
  if (b1 < b0) b1 = b0;

  V dot = V(0);
  if (threadIdx.x >= kThreads) {
    // the producer: one thread issues every stage's copies
    if (threadIdx.x == kThreads) {
      const uint64_t once = evict_first_policy();
      const unsigned tx = static_cast<unsigned>(
          buflen * sizeof(V) + ndiags * tile * sizeof(B));
      int k = 0;
      acg::wave_tiles(ntiles, [&](int64_t t) {
        if (t < b0 || t >= b1) return;
        const int s = k % stages;
        if (k >= stages) mbar_wait(&empty[s], (k / stages - 1) & 1);
        mbar_expect_tx(&full[s], tx);
        V* win = stage_win(s);
        for (int c = 0; c < nclusters; ++c) {
          const int64_t clo = table[3 * c];
          bulk_load(win + table[3 * c + 2],
                    x + t * tile + clo - shift_of(clo),
                    static_cast<unsigned>(table[3 * c + 1] * sizeof(V)),
                    &full[s]);
        }
        B* bt = stage_band(s);
        for (int64_t d = 0; d < ndiags; ++d)
          bulk_load_once(bt + d * tile, bands + d * n + t * tile,
                         static_cast<unsigned>(tile * sizeof(B)), &full[s],
                         once);
        ++k;
      });
    }
  } else {
    // the consumers
    int center = -1;
    for (int64_t d = 0; d < ndiags; ++d)
      if (offsets[d] == 0 && table[3 * nclusters + d] >= 0)
        center = static_cast<int>(d);
    const int pc = center >= 0 ? pos[center] : 0;
    constexpr int kD = D > 0 ? D : 1;
    int p[kD];
    V sc[kD];
    if constexpr (D > 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        p[d] = pos[d];
        if constexpr (SCALED) sc[d] = scales[d];
        else sc[d] = V(1);
      }
    }
    int k = 0;
    acg::wave_tiles(ntiles, [&](int64_t t) {
      if (t < b0 || t >= b1) {             // straight from device memory
        for (int i = threadIdx.x; i < tile; i += kThreads) {
          const int64_t row = t * tile + i;
          if (row >= n) break;
          const V acc = acg::dia_row<V, B, SCALED>(bands, scales, offsets,
                                                   ndiags, x, row, n);
          y[row] = acc;
          if constexpr (DOT) dot += x[row] * acc;
        }
        return;
      }
      const int s = k % stages;
      mbar_wait(&full[s], (k / stages) & 1);
      const V* win = stage_win(s);
      const B* bt = stage_band(s);
      if constexpr (D > 0) {
#pragma unroll 2
        for (int i = threadIdx.x; i < tile; i += kThreads) {
          const int64_t row = t * tile + i;
          B bv[D];
          V xv[D];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            bv[d] = bt[d * tile + i];
            xv[d] = win[p[d] + i];
          }
          const V acc = acg::dia_row_interior<V, SCALED, D>(
              sc, D, [&](int d) { return bv[d]; },
              [&](int d) { return xv[d]; });
          y[row] = acc;
          if constexpr (DOT)
            dot += (center >= 0 ? win[pc + i] : x[row]) * acc;
        }
      } else {
        const int nd = static_cast<int>(ndiags);
        for (int i = threadIdx.x; i < tile; i += kThreads) {
          const int64_t row = t * tile + i;
          const V acc = acg::dia_row_interior<V, SCALED>(
              scales, nd, [&](int d) { return bt[d * tile + i]; },
              [&](int d) { return win[pos[d] + i]; });
          y[row] = acc;
          if constexpr (DOT)
            dot += (center >= 0 ? win[pc + i] : x[row]) * acc;
        }
      }
      __syncwarp();                        // the warp is done with stage s
      if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
      ++k;
    });
  }
  if constexpr (DOT) {
    // block_sum_store's tree over the consumers; the producer warp only
    // takes part in the barriers
    __shared__ V red[kThreads];
    if (threadIdx.x < kThreads) red[threadIdx.x] = dot;
    __syncthreads();
#pragma unroll
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
  }
}

template <typename V, typename B, bool SCALED, bool DOT, int D>
cudaError_t launch_kernel(const B* bp, const V* sp, const int64_t* op,
                          int64_t ndiags, const V* xp, V* yp, V* pp,
                          int64_t n, int tile, const int64_t* tp,
                          int nclusters, int buflen, int64_t ntiles, int mis,
                          bool bal, int stages, int smem, unsigned grid,
                          cudaStream_t s) {
  auto k = dia_windows_kernel<V, B, SCALED, DOT, D>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  k<<<grid, kBlock, smem, s>>>(bp, sp, op, ndiags, xp, yp, pp, n, tile, tp,
                               nclusters, buflen, ntiles, mis, bal, stages);
  return cudaGetLastError();
}

template <typename V, typename B, bool SCALED, bool DOT>
cudaError_t launch_rows(const B* bp, const V* sp, const int64_t* op,
                        int64_t ndiags, const V* xp, V* yp, V* pp, int64_t n,
                        int tile, const int64_t* tp, int nclusters,
                        int buflen, int64_t ntiles, int mis, bool bal,
                        int stages, int smem, unsigned grid,
                        cudaStream_t s) {
  if (ndiags == 7)
    return launch_kernel<V, B, SCALED, DOT, 7>(
        bp, sp, op, ndiags, xp, yp, pp, n, tile, tp, nclusters, buflen,
        ntiles, mis, bal, stages, smem, grid, s);
  return launch_kernel<V, B, SCALED, DOT, 0>(
      bp, sp, op, ndiags, xp, yp, pp, n, tile, tp, nclusters, buflen, ntiles,
      mis, bal, stages, smem, grid, s);
}

template <typename V, typename B, bool SCALED>
int launch(const void* bands, const void* scales, const void* offsets,
           int64_t ndiags, const void* x, void* y, int64_t n, int tile,
           const void* table, int nclusters, int buflen, int64_t ntiles,
           int mis, int stages, int smem, int64_t nblocks, void* partials,
           void* dot_out, cudaStream_t s) {
  const B* bp = static_cast<const B*>(bands);
  const V* sp = static_cast<const V*>(scales);
  const int64_t* op = static_cast<const int64_t*>(offsets);
  const int64_t* tp = static_cast<const int64_t*>(table);
  const V* xp = static_cast<const V*>(x);
  V* yp = static_cast<V*>(y);
  const unsigned grid = static_cast<unsigned>(nblocks);
  // the band tiles' copies are 16-byte aligned when every band row is
  const bool bal = reinterpret_cast<uintptr_t>(bands) % 16 == 0 &&
                   (n * static_cast<int64_t>(sizeof(B))) % 16 == 0;
  if (dot_out == nullptr)
    return static_cast<int>(launch_rows<V, B, SCALED, false>(
        bp, sp, op, ndiags, xp, yp, nullptr, n, tile, tp, nclusters, buflen,
        ntiles, mis, bal, stages, smem, grid, s));
  cudaError_t e = launch_rows<V, B, SCALED, true>(
      bp, sp, op, ndiags, xp, yp, static_cast<V*>(partials), n, tile, tp,
      nclusters, buflen, ntiles, mis, bal, stages, smem, grid, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials<V>(partials, nblocks, dot_out, s));
}

template <typename V>
int dispatch_band(int band_type, const void* bands, const void* scales,
                  const void* offsets, int64_t ndiags, const void* x,
                  void* y, int64_t n, int tile, const void* table,
                  int nclusters, int buflen, int64_t ntiles, int mis,
                  int stages, int smem, int64_t nblocks, void* partials,
                  void* dot_out, cudaStream_t s) {
  switch (band_type) {
    case 0:
      return launch<V, __nv_bfloat16, false>(
          bands, scales, offsets, ndiags, x, y, n, tile, table, nclusters,
          buflen, ntiles, mis, stages, smem, nblocks, partials, dot_out, s);
    case 1:
      return launch<V, int8_t, true>(bands, scales, offsets, ndiags, x, y, n,
                                     tile, table, nclusters, buflen, ntiles,
                                     mis, stages, smem, nblocks, partials,
                                     dot_out, s);
    case 2:
      return launch<V, float, false>(bands, scales, offsets, ndiags, x, y, n,
                                     tile, table, nclusters, buflen, ntiles,
                                     mis, stages, smem, nblocks, partials,
                                     dot_out, s);
    case 3:
      return launch<V, double, false>(bands, scales, offsets, ndiags, x, y,
                                      n, tile, table, nclusters, buflen,
                                      ntiles, mis, stages, smem, nblocks,
                                      partials, dot_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  tile: rows per tile (a multiple of 16 bytes
// of x and of the bands); table: int64 on the device, per cluster (lo,
// length, base) then per band its cluster (-1: wholly outside); buflen:
// elements of one stage's windows (the sum of the lengths, each a whole
// number of 16-byte chunks); mis: x's address modulo 16 bytes, in
// elements; stages: buffers in the ring, 3 or 4 (the depths the plan
// makes, acg_torch/ops/dia_plan.py STAGES; any other is refused); smem:
// dynamic shared bytes (round128(16 * stages + 4 * ndiags) + stages *
// (round16(buflen * itemsize) + round16(ndiags * tile * band itemsize)),
// acg_torch/ops/dia_plan.py windows_bytes); nblocks: the persistent grid
// (<= ntiles) of 288-thread blocks.  dot_out == NULL: no fused dot,
// else partials holds nblocks values.  Returns the CUDA error of the
// launches (0 on success).
extern "C" int acg_dia_spmv_windows(const void* bands, int band_type,
                                    const void* scales, const void* offsets,
                                    int64_t ndiags, const void* x, void* y,
                                    int vec_type, int64_t n, int tile,
                                    const void* table, int nclusters,
                                    int buflen, int64_t ntiles, int mis,
                                    int stages, int smem, int64_t nblocks,
                                    void* partials, void* dot_out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages != 3 && stages != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_type == 2)
    return dispatch_band<float>(band_type, bands, scales, offsets, ndiags, x,
                                y, n, tile, table, nclusters, buflen, ntiles,
                                mis, stages, smem, nblocks, partials, dot_out,
                                s);
  if (vec_type == 3)
    return dispatch_band<double>(band_type, bands, scales, offsets, ndiags,
                                 x, y, n, tile, table, nclusters, buflen,
                                 ntiles, mis, stages, smem, nblocks, partials,
                                 dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
