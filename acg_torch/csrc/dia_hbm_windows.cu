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
// offset slice of its cluster's window.  The grid is persistent: each
// block walks its own contiguous run of tiles, double-buffered, starting
// the next tile's windows as cp.async copies before it computes the
// current one.  A window starts up to one 16-byte chunk before
// base + lo_c, so that its copies stay 16-byte aligned whatever the
// offset (a band at offset +-1 or +-nx starts anywhere); elements
// outside [0, n) are zero-filled.  x is read once per cluster per tile
// (three times at 464^3, the TPU kernel's overfetch; the L2 catches
// much of it, since neighbouring blocks stream the same stretch of x at
// about the same time).  The band tiles (the bulk of the bytes) go
// through shared memory too, double-buffered and copied with the
// windows, so every byte the kernel reads from device memory is an
// asynchronous 16-byte copy kept in flight behind the compute, and no
// thread waits on a load of its own.  Rows are summed by the row body
// of dia_spmv (acg::dia_row_at), so y has dia_spmv's bits; the dot goes
// through per-block partials and the fixed one-block tree, so its bits
// depend on n and the plan alone.
#include "common.cuh"

namespace {

using acg::kThreads;

// table: per cluster (lo, length, base) then, per band, its cluster (-1
// for a band that lies wholly outside the vector).  mis: x's address
// modulo 16 bytes, in elements.  Dynamic shared memory: two buffers of
// the windows (2 x buflen values of x), two buffers of the ndiags band
// tiles (2 x ndiags x tile stored values), each band's window position
// (ndiags ints).
template <typename V, typename B, bool SCALED, bool DOT>
__global__ void __launch_bounds__(kThreads)
dia_windows_kernel(const B* __restrict__ bands, const V* __restrict__ scales,
                   const int64_t* __restrict__ offsets, int64_t ndiags,
                   const V* __restrict__ x, V* __restrict__ y,
                   V* __restrict__ partials, int64_t n, int tile,
                   const int64_t* __restrict__ table, int nclusters,
                   int buflen, int64_t ntiles, int mis, bool bands_aligned) {
  constexpr int kVe = 16 / static_cast<int>(sizeof(V));
  extern __shared__ __align__(16) unsigned char acg_smem[];
  V* buf = reinterpret_cast<V*>(acg_smem);             // 2 x buflen
  B* bbuf = reinterpret_cast<B*>(buf + 2 * buflen);    // 2 x ndiags x tile
  const int64_t band_len = ndiags * tile;
  int* pos = reinterpret_cast<int*>(bbuf + 2 * band_len);  // ndiags
  // how far a cluster's window starts before base + lo so that its
  // first element sits on a 16-byte boundary of x
  auto shift_of = [&](int64_t clo) {
    const int64_t r = (clo + mis) % kVe;
    return static_cast<int>(r < 0 ? r + kVe : r);
  };
  // band d of row i of a tile reads its window at pos[d] + i
  for (int64_t d = threadIdx.x; d < ndiags; d += kThreads) {
    const int64_t c = table[3 * nclusters + d];
    int p = 0;
    if (c >= 0) {
      const int64_t clo = table[3 * c];
      p = static_cast<int>(table[3 * c + 2] + offsets[d] - clo) +
          shift_of(clo);
    }
    pos[d] = p;
  }
  // the band at offset 0 (every SPD operator has one): the dot reads x
  // from its window; without one, from device memory
  int center = -1;
  for (int64_t d = 0; d < ndiags; ++d)
    if (offsets[d] == 0 && table[3 * nclusters + d] >= 0)
      center = static_cast<int>(d);
  int64_t t0, t1, in0, in1;
  acg::run_bounds(ntiles, t0, t1);
  acg::interior_tiles(offsets, ndiags, n, tile, in0, in1);

  auto stage = [&](int64_t t, int parity) {
    V* dst = buf + parity * buflen;
    for (int c = 0; c < nclusters; ++c) {
      const int64_t clo = table[3 * c];
      acg::stage_x(dst + table[3 * c + 2], x, n,
                   t * tile + clo - shift_of(clo),
                   static_cast<int>(table[3 * c + 1]), true);
    }
    const int64_t left = n - t * tile;
    const int valid = static_cast<int>(left < tile ? left : tile);
    for (int64_t d = 0; d < ndiags; ++d)
      acg::stage_band(bbuf + parity * band_len + d * tile,
                      bands + d * n + t * tile, valid, bands_aligned);
  };

  V dot = V(0);
  if (t0 < t1) {
    stage(t0, 0);
    acg::cp_async_commit();
    for (int64_t t = t0; t < t1; ++t) {
      const int parity = static_cast<int>((t - t0) & 1);
      if (t + 1 < t1) stage(t + 1, parity ^ 1);
      acg::cp_async_commit();
      acg::cp_async_wait<1>();  // every group but the one just started
      __syncthreads();
      const V* win = buf + parity * buflen;
      const B* bt = bbuf + parity * band_len;
      if (t >= in0 && t < in1) {           // no band leaves the vector
        const int nd = static_cast<int>(ndiags);
        for (int i = threadIdx.x; i < tile; i += kThreads) {
          const int64_t row = t * tile + i;
          const V acc = acg::dia_row_interior<V, SCALED>(
              scales, nd, [&](int d) { return bt[d * tile + i]; },
              [&](int d) { return win[pos[d] + i]; });
          y[row] = acc;
          if constexpr (DOT)
            dot += (center >= 0 ? win[pos[center] + i] : x[row]) * acc;
        }
      } else {
        for (int i = threadIdx.x; i < tile; i += kThreads) {
          const int64_t row = t * tile + i;
          if (row >= n) break;
          const V acc = acg::dia_row_at<V, SCALED>(
              scales, offsets, ndiags, row, n,
              [&](int64_t d) { return bt[d * tile + i]; },
              [&](int64_t d, int64_t) { return win[pos[d] + i]; });
          y[row] = acc;
          if constexpr (DOT)
            dot += (center >= 0 ? win[pos[center] + i] : x[row]) * acc;
        }
      }
      __syncthreads();  // before the next step refills these buffers
    }
  }
  if constexpr (DOT) acg::block_sum_store<V, kThreads>(dot, partials);
}

template <typename V, typename B, bool SCALED>
int launch(const void* bands, const void* scales, const void* offsets,
           int64_t ndiags, const void* x, void* y, int64_t n, int tile,
           const void* table, int nclusters, int buflen, int64_t ntiles,
           int mis, int smem, int64_t nblocks, void* partials,
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
  if (dot_out == nullptr) {
    auto k = dia_windows_kernel<V, B, SCALED, false>;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<grid, kThreads, smem, s>>>(bp, sp, op, ndiags, xp, yp, nullptr, n,
                                   tile, tp, nclusters, buflen, ntiles, mis,
                                   bal);
    return static_cast<int>(cudaGetLastError());
  }
  auto k = dia_windows_kernel<V, B, SCALED, true>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<grid, kThreads, smem, s>>>(bp, sp, op, ndiags, xp, yp,
                                 static_cast<V*>(partials), n, tile, tp,
                                 nclusters, buflen, ntiles, mis, bal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials<V>(partials, nblocks, dot_out, s));
}

template <typename V>
int dispatch_band(int band_type, const void* bands, const void* scales,
                  const void* offsets, int64_t ndiags, const void* x,
                  void* y, int64_t n, int tile, const void* table,
                  int nclusters, int buflen, int64_t ntiles, int mis,
                  int smem, int64_t nblocks, void* partials, void* dot_out,
                  cudaStream_t s) {
  switch (band_type) {
    case 0:
      return launch<V, __nv_bfloat16, false>(
          bands, scales, offsets, ndiags, x, y, n, tile, table, nclusters,
          buflen, ntiles, mis, smem, nblocks, partials, dot_out, s);
    case 1:
      return launch<V, int8_t, true>(bands, scales, offsets, ndiags, x, y, n,
                                     tile, table, nclusters, buflen, ntiles,
                                     mis, smem, nblocks, partials, dot_out,
                                     s);
    case 2:
      return launch<V, float, false>(bands, scales, offsets, ndiags, x, y, n,
                                     tile, table, nclusters, buflen, ntiles,
                                     mis, smem, nblocks, partials, dot_out,
                                     s);
    case 3:
      return launch<V, double, false>(bands, scales, offsets, ndiags, x, y,
                                      n, tile, table, nclusters, buflen,
                                      ntiles, mis, smem, nblocks, partials,
                                      dot_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  tile: rows per tile (a multiple of 16 bytes
// of x); table: int64 on the device, per cluster (lo, length, base)
// then per band its cluster (-1: wholly outside); buflen: elements of
// one buffer (the sum of the lengths, each a whole number of 16-byte
// chunks); mis: x's address modulo 16 bytes, in elements; smem: dynamic
// shared bytes (2 * buflen * itemsize + 2 * ndiags * tile * band
// itemsize + 4 * ndiags); nblocks: the persistent grid (<= ntiles).  dot_out == NULL: no fused dot, else
// partials holds nblocks values.  Returns the CUDA error of the
// launches (0 on success).
extern "C" int acg_dia_spmv_windows(const void* bands, int band_type,
                                    const void* scales, const void* offsets,
                                    int64_t ndiags, const void* x, void* y,
                                    int vec_type, int64_t n, int tile,
                                    const void* table, int nclusters,
                                    int buflen, int64_t ntiles, int mis,
                                    int smem, int64_t nblocks,
                                    void* partials, void* dot_out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return dispatch_band<float>(band_type, bands, scales, offsets, ndiags, x,
                                y, n, tile, table, nclusters, buflen, ntiles,
                                mis, smem, nblocks, partials, dot_out, s);
  if (vec_type == 3)
    return dispatch_band<double>(band_type, bands, scales, offsets, ndiags,
                                 x, y, n, tile, table, nclusters, buflen,
                                 ntiles, mis, smem, nblocks, partials,
                                 dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
