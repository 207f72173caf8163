// DIA SpMV with x streamed once through a shared-memory ring, with an
// optional fused <x, y>:
//
//   y[i] = sum_d band[d, i] * x[i + off[d]]      (0 <= i + off[d] < n)
//   dot  = sum_i x[i] * y[i]                      (with_dot: CG's p'Ap)
//
// Replaces the TPU kernel acg_tpu/ops/pallas_kernels.py
// dia_matvec_pallas_hbm2d_ring (_dia_hbm2d_ring_kernel): the path for x
// too large for the on-chip store, with the ring of consecutive x tiles
// that spans the whole offset reach and one new x tile per step.
//
// Bound on this card: bytes.  Per call the kernel must read D*n band
// values at their storage width, read x once and write y once; its
// 2*D*n flops are far below the card's rate on that traffic.  The TPU
// kernel walks the tiles in grid order with one VMEM ring; here the
// grid is persistent (as many blocks as fit the card at once, the plan
// in acg_torch/ops/dia_plan.py), and each block walks its own
// contiguous run of tiles in order with its own ring of T_ring + 1
// tiles in dynamic shared memory.  The prologue fills the span; each
// step starts one tile's cp.async copies (the next tile the run needs)
// before it computes the current tile, and waits for the tile it needs
// next.  So a block reads its run of x once, plus one span of overlap,
// and the D shifted reads of every row come from shared memory.  Tiles
// outside [0, n) are zero-filled, in place of the TPU's zero halo.  The
// band tiles (the bulk of the bytes) go through shared memory too,
// double-buffered and copied with the x tile, so every byte the kernel
// reads from device memory is an asynchronous 16-byte copy kept in
// flight behind the compute, and no thread waits on a load of its own.
// Rows are summed by the row body of dia_spmv (acg::dia_row_at), so y
// has dia_spmv's bits; the dot goes through per-block partials and the
// fixed one-block tree, so its bits depend on n and the plan alone.
#include "common.cuh"

namespace {

using acg::kThreads;

// slot of absolute tile jt in a ring of `slots` tiles (jt may be < 0)
__device__ __forceinline__ int ring_slot(int64_t jt, int slots) {
  const int64_t s = jt % slots;
  return static_cast<int>(s < 0 ? s + slots : s);
}

// Dynamic shared memory: the ring (slots x tile values of x), then two
// buffers of the ndiags band tiles (2 x ndiags x tile stored values),
// then each band's offset from the ring's first tile (ndiags ints).
template <typename V, typename B, bool SCALED, bool DOT>
__global__ void __launch_bounds__(kThreads)
dia_ring_kernel(const B* __restrict__ bands, const V* __restrict__ scales,
                const int64_t* __restrict__ offsets, int64_t ndiags,
                const V* __restrict__ x, V* __restrict__ y,
                V* __restrict__ partials, int64_t n, int tile, int64_t lo,
                int slots, int64_t ntiles, bool aligned,
                bool bands_aligned) {
  extern __shared__ __align__(16) unsigned char acg_smem[];
  V* ring = reinterpret_cast<V*>(acg_smem);
  const int ring_len = slots * tile;
  B* bbuf = reinterpret_cast<B*>(ring + ring_len);
  const int64_t band_len = ndiags * tile;
  int* rel = reinterpret_cast<int*>(bbuf + 2 * band_len);
  const int span = slots - 1;           // T_ring tiles: lo .. hi
  const int64_t hi = lo + span - 1;
  // row i of a tile reads band d's x at i + rel[d] past the start of the
  // tile t + lo in the ring (bands wholly outside the vector: unused)
  for (int64_t d = threadIdx.x; d < ndiags; d += kThreads) {
    const int64_t o = offsets[d];
    rel[d] = (o < n && -o < n) ? static_cast<int>(o - lo * tile) : 0;
  }
  int64_t t0, t1, in0, in1;
  acg::run_bounds(ntiles, t0, t1);
  acg::interior_tiles(offsets, ndiags, n, tile, in0, in1);

  auto fetch = [&](int64_t jt) {
    acg::stage_x(ring + ring_slot(jt, slots) * tile, x, n, jt * tile, tile,
                 aligned);
  };
  auto fetch_bands = [&](int64_t t, int parity) {
    const int64_t left = n - t * tile;
    const int valid = static_cast<int>(left < tile ? left : tile);
    for (int64_t d = 0; d < ndiags; ++d)
      acg::stage_band(bbuf + parity * band_len + d * tile,
                      bands + d * n + t * tile, valid, bands_aligned);
  };

  V dot = V(0);
  if (t0 < t1) {
    for (int k = 0; k < span; ++k) fetch(t0 + lo + k);
    fetch_bands(t0, 0);
    acg::cp_async_commit();
    for (int64_t t = t0; t < t1; ++t) {
      const int parity = static_cast<int>((t - t0) & 1);
      // the next step's newest tile goes into the one slot this step
      // does not read (it held tile t + lo - 1, last read a step ago),
      // its bands into the other buffer
      if (t + 1 < t1) {
        fetch(t + 1 + hi);
        fetch_bands(t + 1, parity ^ 1);
      }
      acg::cp_async_commit();
      acg::cp_async_wait<1>();  // every group but the one just started
      __syncthreads();
      const int64_t base = (t + lo) * tile;
      const int s0 = ring_slot(t + lo, slots) * tile;
      const B* bt = bbuf + parity * band_len;
      auto at = [&](int p) {               // ring position, wrapped once
        return ring[p >= ring_len ? p - ring_len : p];
      };
      if (t >= in0 && t < in1) {           // no band leaves the vector
        const int nd = static_cast<int>(ndiags);
        for (int i = threadIdx.x; i < tile; i += kThreads) {
          const V acc = acg::dia_row_interior<V, SCALED>(
              scales, nd, [&](int d) { return bt[d * tile + i]; },
              [&](int d) { return at(s0 + rel[d] + i); });
          y[t * tile + i] = acc;
          if constexpr (DOT)
            dot += at(s0 + static_cast<int>(-lo * tile) + i) * acc;
        }
      } else {
        auto xat = [&](int64_t, int64_t j) {
          return at(s0 + static_cast<int>(j - base));
        };
        for (int i = threadIdx.x; i < tile; i += kThreads) {
          const int64_t row = t * tile + i;
          if (row >= n) break;
          const V acc = acg::dia_row_at<V, SCALED>(
              scales, offsets, ndiags, row, n,
              [&](int64_t d) { return bt[d * tile + i]; }, xat);
          y[row] = acc;
          if constexpr (DOT) dot += xat(0, row) * acc;
        }
      }
      __syncthreads();  // before the next step overwrites what was read
    }
  }
  if constexpr (DOT) acg::block_sum_store<V, kThreads>(dot, partials);
}

template <typename V, typename B, bool SCALED>
int launch(const void* bands, const void* scales, const void* offsets,
           int64_t ndiags, const void* x, void* y, int64_t n, int tile,
           int64_t lo, int slots, int64_t ntiles, int aligned, int smem,
           int64_t nblocks, void* partials, void* dot_out, cudaStream_t s) {
  // the band tiles' copies are 16-byte aligned when every band row is
  const bool bal = reinterpret_cast<uintptr_t>(bands) % 16 == 0 &&
                   (n * static_cast<int64_t>(sizeof(B))) % 16 == 0;
  const B* bp = static_cast<const B*>(bands);
  const V* sp = static_cast<const V*>(scales);
  const int64_t* op = static_cast<const int64_t*>(offsets);
  const V* xp = static_cast<const V*>(x);
  V* yp = static_cast<V*>(y);
  const unsigned grid = static_cast<unsigned>(nblocks);
  const bool al = aligned != 0;
  if (dot_out == nullptr) {
    auto k = dia_ring_kernel<V, B, SCALED, false>;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<grid, kThreads, smem, s>>>(bp, sp, op, ndiags, xp, yp, nullptr, n,
                                   tile, lo, slots, ntiles, al, bal);
    return static_cast<int>(cudaGetLastError());
  }
  auto k = dia_ring_kernel<V, B, SCALED, true>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<grid, kThreads, smem, s>>>(bp, sp, op, ndiags, xp, yp,
                                 static_cast<V*>(partials), n, tile, lo,
                                 slots, ntiles, al, bal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials<V>(partials, nblocks, dot_out, s));
}

template <typename V>
int dispatch_band(int band_type, const void* bands, const void* scales,
                  const void* offsets, int64_t ndiags, const void* x,
                  void* y, int64_t n, int tile, int64_t lo, int slots,
                  int64_t ntiles, int aligned, int smem, int64_t nblocks,
                  void* partials, void* dot_out, cudaStream_t s) {
  switch (band_type) {
    case 0:
      return launch<V, __nv_bfloat16, false>(
          bands, scales, offsets, ndiags, x, y, n, tile, lo, slots, ntiles,
          aligned, smem, nblocks, partials, dot_out, s);
    case 1:
      return launch<V, int8_t, true>(bands, scales, offsets, ndiags, x, y, n,
                                     tile, lo, slots, ntiles, aligned, smem,
                                     nblocks, partials, dot_out, s);
    case 2:
      return launch<V, float, false>(bands, scales, offsets, ndiags, x, y, n,
                                     tile, lo, slots, ntiles, aligned, smem,
                                     nblocks, partials, dot_out, s);
    case 3:
      return launch<V, double, false>(bands, scales, offsets, ndiags, x, y,
                                      n, tile, lo, slots, ntiles, aligned,
                                      smem, nblocks, partials, dot_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  tile: x tile in elements (a multiple of 16
// bytes); lo: the span's first tile relative to the row tile; slots:
// T_ring + 1; aligned: x is 16-byte aligned; smem: dynamic shared bytes
// (slots * tile * itemsize + 2 * ndiags * tile * band itemsize + 4 *
// ndiags); nblocks: the persistent grid (<= ntiles).
// dot_out == NULL: no fused dot, else partials holds nblocks values.
// Returns the CUDA error of the launches (0 on success).
extern "C" int acg_dia_spmv_ring(const void* bands, int band_type,
                                 const void* scales, const void* offsets,
                                 int64_t ndiags, const void* x, void* y,
                                 int vec_type, int64_t n, int tile,
                                 int64_t lo, int slots, int64_t ntiles,
                                 int aligned, int smem, int64_t nblocks,
                                 void* partials, void* dot_out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return dispatch_band<float>(band_type, bands, scales, offsets, ndiags, x,
                                y, n, tile, lo, slots, ntiles, aligned, smem,
                                nblocks, partials, dot_out, s);
  if (vec_type == 3)
    return dispatch_band<double>(band_type, bands, scales, offsets, ndiags,
                                 x, y, n, tile, lo, slots, ntiles, aligned,
                                 smem, nblocks, partials, dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
