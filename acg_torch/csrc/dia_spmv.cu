// DIA SpMV with an optional fused <x, y>:
//
//   y[i] = sum_d band[d, i] * x[i + off[d]]      (0 <= i + off[d] < n)
//   dot  = sum_i x[i] * y[i]                      (with_dot: CG's p'Ap)
//
// Replaces the TPU kernels acg_tpu/ops/pallas_kernels.py
// dia_matvec_pallas_2d (_dia2d_kernel, the eager matvec) and
// dia_matvec_pallas_2d_padded (_dia2d_padded_kernel, the fused SpMV +
// p'Ap of the classic-CG loop).
//
// Bound on this card: bytes.  Per call the kernel must read D*n band
// values at their storage width, read x once and write y once; it does
// 2*D*n flops, far below the rate the card could sustain on that
// traffic.  The design keeps to that minimum: one thread per row in a
// grid-stride loop, so the band rows and y are read and written
// coalesced, and the D shifted reads of x hit the same cache lines as
// neighbouring threads' reads (x is fetched from memory about once,
// the rest from L1/L2).  Bands stay in their narrow storage (bf16, or an
// int8 0/1 mask with per-band scales) and are widened in registers.
// The TPU layout's permanent zero halo is dropped: it exists there to
// keep the Mosaic loads aligned and the grid uniform, and here a bounds
// test per band is cheaper than 2*H*128 zero rows on every vector.
// Rows are summed in ascending-offset order, as on the TPU (the row body
// acg::dia_row in common.cuh).  Staging x tiles in shared memory
// (cp.async/TMA) is later work.
#include "common.cuh"

namespace {

using acg::kThreads;

template <typename V, typename B, bool SCALED, bool DOT>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const B* __restrict__ bands, const V* __restrict__ scales,
                const int64_t* __restrict__ offsets, int64_t ndiags,
                const V* __restrict__ x, V* __restrict__ y,
                V* __restrict__ partials, int64_t n) {
  V dot = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const V acc =
        acg::dia_row<V, B, SCALED>(bands, scales, offsets, ndiags, x, i, n);
    y[i] = acc;
    if constexpr (DOT) dot += x[i] * acc;
  }
  if constexpr (DOT) acg::block_sum_store<V, kThreads>(dot, partials);
}

template <typename V, typename B, bool SCALED>
int launch(const void* bands, const void* scales, const void* offsets,
           int64_t ndiags, const void* x, void* y, int64_t n,
           void* partials, int64_t nblocks, void* dot_out,
           cudaStream_t s) {
  const B* bp = static_cast<const B*>(bands);
  const V* sp = static_cast<const V*>(scales);
  const int64_t* op = static_cast<const int64_t*>(offsets);
  const V* xp = static_cast<const V*>(x);
  V* yp = static_cast<V*>(y);
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (dot_out == nullptr) {
    dia_spmv_kernel<V, B, SCALED, false><<<grid, kThreads, 0, s>>>(
        bp, sp, op, ndiags, xp, yp, nullptr, n);
    return static_cast<int>(cudaGetLastError());
  }
  dia_spmv_kernel<V, B, SCALED, true><<<grid, kThreads, 0, s>>>(
      bp, sp, op, ndiags, xp, yp, static_cast<V*>(partials), n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials<V>(partials, nblocks, dot_out, s));
}

template <typename V>
int dispatch_band(int band_type, const void* bands, const void* scales,
                  const void* offsets, int64_t ndiags, const void* x,
                  void* y, int64_t n, void* partials, int64_t nblocks,
                  void* dot_out, cudaStream_t s) {
  switch (band_type) {
    case 0:
      return launch<V, __nv_bfloat16, false>(bands, scales, offsets, ndiags,
                                             x, y, n, partials, nblocks,
                                             dot_out, s);
    case 1:
      return launch<V, int8_t, true>(bands, scales, offsets, ndiags, x, y, n,
                                     partials, nblocks, dot_out, s);
    case 2:
      return launch<V, float, false>(bands, scales, offsets, ndiags, x, y, n,
                                     partials, nblocks, dot_out, s);
    case 3:
      return launch<V, double, false>(bands, scales, offsets, ndiags, x, y,
                                      n, partials, nblocks, dot_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  dot_out == NULL: no fused dot.
// Returns the CUDA error of the launches (0 on success).
extern "C" int acg_dia_spmv(const void* bands, int band_type,
                            const void* scales, const void* offsets,
                            int64_t ndiags, const void* x, void* y,
                            int vec_type, int64_t n, void* partials,
                            int64_t nblocks, void* dot_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return dispatch_band<float>(band_type, bands, scales, offsets, ndiags, x,
                                y, n, partials, nblocks, dot_out, s);
  if (vec_type == 3)
    return dispatch_band<double>(band_type, bands, scales, offsets, ndiags,
                                 x, y, n, partials, nblocks, dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
