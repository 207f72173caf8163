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
// traffic.  One thread per row in a grid-stride loop, so the band rows
// and y are read and written coalesced, and the D shifted reads of x hit
// the same cache lines as neighbouring threads' reads (x is fetched from
// memory about once, the rest from L1/L2).  Bands stay in their narrow
// storage (bf16, or an int8 0/1 mask with per-band scales) and are
// widened in registers.  The TPU layout's permanent zero halo is
// dropped: a bounds test per band is cheaper than 2*H*128 zero rows on
// every vector.  Rows are summed in ascending-offset order, as on the
// TPU.
//
// What the traffic needs is enough loads in flight: a row's 2*D loads
// are independent of each other, but a loop over a runtime band count
// with a bounds branch per band issues them one band at a time.  So at
// f32 vectors, for the band counts the port's operators have (3:
// tridiagonal, 5: 2-D, 7: 3-D, 27: the 27-point stencil), a second
// kernel has D fixed at compile time: the offsets and scales are loaded
// once into registers, a row whose every column lies inside [0, n) (one
// test a row: i + min(off) >= 0 and i + max(off) < n) issues all D band
// loads and D x loads before the first multiply-add and sums them with
// acg::dia_row_interior<D>; the dot takes x[i] from the band at offset 0
// when there is one.  Its band loads are streaming, marked to leave the
// caches first so that they do not push out the x lines the other rows'
// bands still read.  The caller asks for it (``fixed``), and the plan
// does so only where the call's bands, x and y exceed the L2
// (acg_torch/ops/dia_plan.py resident_fixed), where it measured ahead
// of the generic kernel (256^3 int8/f32 without the dot on an H100:
// 0.16-0.18 ms against 0.30); inside the L2 the generic kernel was
// faster (128^3 bf16/f32 with the dot 0.058-0.060 ms against
// 0.066-0.072), and at f64 vectors it was too (5-10% with the dot, 256^3
// f64/f64; PERF.md).  The fixed kernel's first and last rows take
// acg::dia_row.  Both row bodies are dia_row_at's arithmetic, and the
// rows, their owners (one a thread, grid-stride order) and the dot's
// per-thread order and tree are the same whichever kernel runs, so y and
// the dot have the same bits either way and as dia_spmv_batched's
// systems.
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

// The same rows with the band count fixed at D and streaming band loads:
// interior rows load every operand up front; the rest take the generic
// body.
template <typename V, typename B, bool SCALED, bool DOT, int D>
__global__ void __launch_bounds__(kThreads)
dia_spmv_fixed_kernel(const B* __restrict__ bands,
                      const V* __restrict__ scales,
                      const int64_t* __restrict__ offsets,
                      const V* __restrict__ x, V* __restrict__ y,
                      V* __restrict__ partials, int64_t n) {
  int64_t off[D];
  V sc[D];
  int64_t omin = 0, omax = 0;
  int center = -1;  // the band at offset 0: the dot reuses its x value
#pragma unroll
  for (int d = 0; d < D; ++d) {
    off[d] = offsets[d];
    omin = off[d] < omin ? off[d] : omin;
    omax = off[d] > omax ? off[d] : omax;
    if (off[d] == 0) center = d;
    if constexpr (SCALED) sc[d] = scales[d];
    else sc[d] = V(1);
  }
  V dot = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    V acc, xi;
    if (i + omin >= 0 && i + omax < n) {
      B bv[D];
      V xv[D];
#pragma unroll
      for (int d = 0; d < D; ++d) bv[d] = __ldcs(bands + d * n + i);
#pragma unroll
      for (int d = 0; d < D; ++d) xv[d] = x[i + off[d]];
      acc = acg::dia_row_interior<V, SCALED, D>(
          sc, D, [&](int d) { return bv[d]; }, [&](int d) { return xv[d]; });
      xi = xv[0];
#pragma unroll
      for (int d = 1; d < D; ++d)
        if (d == center) xi = xv[d];
      if (center < 0) xi = x[i];
    } else {
      acc = acg::dia_row<V, B, SCALED>(bands, scales, offsets, D, x, i, n);
      xi = x[i];
    }
    y[i] = acc;
    // one multiply-add after the branches, as in dia_spmv_kernel: a dot
    // update in each branch lets the compiler sink the add past them and
    // round the product on its own
    if constexpr (DOT) dot += xi * acc;
  }
  if constexpr (DOT) acg::block_sum_store<V, kThreads>(dot, partials);
}

// The fixed kernel at the call's band count; false when it has none.
template <typename V, typename B, bool SCALED, bool DOT>
bool launch_fixed(const B* bp, const V* sp, const int64_t* op,
                  int64_t ndiags, const V* xp, V* yp, V* pp, int64_t n,
                  unsigned grid, cudaStream_t s) {
  switch (ndiags) {
    case 3:
      dia_spmv_fixed_kernel<V, B, SCALED, DOT, 3>
          <<<grid, kThreads, 0, s>>>(bp, sp, op, xp, yp, pp, n);
      return true;
    case 5:
      dia_spmv_fixed_kernel<V, B, SCALED, DOT, 5>
          <<<grid, kThreads, 0, s>>>(bp, sp, op, xp, yp, pp, n);
      return true;
    case 7:
      dia_spmv_fixed_kernel<V, B, SCALED, DOT, 7>
          <<<grid, kThreads, 0, s>>>(bp, sp, op, xp, yp, pp, n);
      return true;
    case 27:
      dia_spmv_fixed_kernel<V, B, SCALED, DOT, 27>
          <<<grid, kThreads, 0, s>>>(bp, sp, op, xp, yp, pp, n);
      return true;
    default:
      return false;
  }
}

// One launch of the rows: the fixed kernel when asked for (f32 vectors
// and a band count it is compiled for, else cudaErrorInvalidValue), the
// generic one otherwise.
template <typename V, typename B, bool SCALED, bool DOT>
cudaError_t launch_rows(const B* bp, const V* sp, const int64_t* op,
                        int64_t ndiags, const V* xp, V* yp, V* pp, int64_t n,
                        bool fixed, unsigned grid, cudaStream_t s) {
  if (!fixed) {
    dia_spmv_kernel<V, B, SCALED, DOT>
        <<<grid, kThreads, 0, s>>>(bp, sp, op, ndiags, xp, yp, pp, n);
    return cudaGetLastError();
  }
  if constexpr (sizeof(V) == 4) {
    if (launch_fixed<V, B, SCALED, DOT>(bp, sp, op, ndiags, xp, yp, pp, n,
                                        grid, s))
      return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename V, typename B, bool SCALED>
int launch(const void* bands, const void* scales, const void* offsets,
           int64_t ndiags, const void* x, void* y, int64_t n, bool fixed,
           void* partials, int64_t nblocks, void* dot_out, cudaStream_t s) {
  const B* bp = static_cast<const B*>(bands);
  const V* sp = static_cast<const V*>(scales);
  const int64_t* op = static_cast<const int64_t*>(offsets);
  const V* xp = static_cast<const V*>(x);
  V* yp = static_cast<V*>(y);
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (dot_out == nullptr)
    return static_cast<int>(launch_rows<V, B, SCALED, false>(
        bp, sp, op, ndiags, xp, yp, nullptr, n, fixed, grid, s));
  cudaError_t e = launch_rows<V, B, SCALED, true>(
      bp, sp, op, ndiags, xp, yp, static_cast<V*>(partials), n, fixed, grid,
      s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials<V>(partials, nblocks, dot_out, s));
}

template <typename V>
int dispatch_band(int band_type, const void* bands, const void* scales,
                  const void* offsets, int64_t ndiags, const void* x,
                  void* y, int64_t n, bool fixed, void* partials,
                  int64_t nblocks, void* dot_out, cudaStream_t s) {
  switch (band_type) {
    case 0:
      return launch<V, __nv_bfloat16, false>(bands, scales, offsets, ndiags,
                                             x, y, n, fixed, partials,
                                             nblocks, dot_out, s);
    case 1:
      return launch<V, int8_t, true>(bands, scales, offsets, ndiags, x, y, n,
                                     fixed, partials, nblocks, dot_out, s);
    case 2:
      return launch<V, float, false>(bands, scales, offsets, ndiags, x, y, n,
                                     fixed, partials, nblocks, dot_out, s);
    case 3:
      return launch<V, double, false>(bands, scales, offsets, ndiags, x, y,
                                      n, fixed, partials, nblocks, dot_out,
                                      s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  fixed: nonzero for the kernel with the band
// count fixed (f32 vectors and ndiags 3, 5, 7 or 27 only, else
// cudaErrorInvalidValue).  dot_out == NULL: no fused dot.
// Returns the CUDA error of the launches (0 on success).
extern "C" int acg_dia_spmv(const void* bands, int band_type,
                            const void* scales, const void* offsets,
                            int64_t ndiags, const void* x, void* y,
                            int vec_type, int64_t n, int fixed,
                            void* partials, int64_t nblocks, void* dot_out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return dispatch_band<float>(band_type, bands, scales, offsets, ndiags, x,
                                y, n, fixed != 0, partials, nblocks, dot_out,
                                s);
  if (vec_type == 3)
    return dispatch_band<double>(band_type, bands, scales, offsets, ndiags,
                                 x, y, n, fixed != 0, partials, nblocks,
                                 dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
