// Matrix-free constant-coefficient stencil SpMV with an optional fused
// <x, y>:
//
//   y[i] = sum_k c_k * x[i + off_k]   over the arms k whose shifted grid
//          coordinates stay inside the grid (Dirichlet truncation)
//   y[i] = 0                          for n <= i < npad (padding)
//   dot  = sum_i x[i] * y[i]          (with_dot: CG's p'Ap)
//
// Replaces the TPU kernel acg_tpu/ops/stencil.py
// stencil_matvec_pallas_padded (_stencil2d_padded_kernel, tile body
// _stencil_tile_acc).
//
// Bound on this card: bytes.  There is no band operand: the operator is
// its spec (grid, arm offsets, arm digits, coefficients), passed by
// value as a kernel parameter, so it lives in the constant bank and
// costs no memory traffic.  Per call the kernel must read x once and
// write y once.  One thread per element in a grid-stride loop keeps the
// accesses coalesced, and the shifted reads of x hit cache lines
// neighbouring threads also read.  Grids of fewer than 3 axes are padded
// with leading unit axes by the wrapper, so the kernels always work in
// 3-D.  Arms are summed in ascending flat-offset order, as on the TPU.
//
// Two kernels.  The generic one takes any arm count and makes each band
// value in registers from the element's grid coordinates: two integer
// divisions and two modulos an element, then a loop over a runtime arm
// count with a boundary test per arm (acg::stencil_row in common.cuh,
// which the pipelined and multi-RHS stencil kernels share).  On an H100
// it took the same time at f32 as at f64 (0.19-0.21 ms at 256^3, 2.6x
// its f64 bound): not its bytes but its integer work and divergence set
// the pace.  The fixed-arm kernel, compiled for the arm counts of the
// 2-D 5-point, 3-D 7-point and 3-D 27-point grids, does without them:
//
// - each thread divides its first element's index into grid coordinates
//   once and reaches every later element of its grid-stride loop by
//   adding the stride's own coordinates (StencilArgs::stride) with
//   carries: no division in the loop;
// - the host passes the interior box (StencilArgs::lo, hi).  A row
//   inside it on the first two axes is summed with the arm count known
//   at compile time, all NARMS loads issued before the first
//   multiply-add, the coefficients converted to V once per thread, and
//   an arm that leaves the grid along the last axis masked off (at
//   256^3 two warps in every eight hold an element of a face along that
//   axis; sending it to stencil_row made the whole warp run both bodies,
//   and the kernel slower than the generic one at f64);
// - the other rows (the faces along the first two axes, and the
//   padding) take acg::stencil_row unchanged.
//
// Bits: both row bodies start from V(0) and add c_k * x_k over the arms
// inside the grid in ascending offset order, each a fused multiply-add,
// so a row has the same bits from either.  The launch geometry
// (grid_blocks(npad) blocks of kThreads, one element a thread a step in
// grid-stride order), the dot's one multiply-add an element after the
// row (in one place: in both branches the compiler may sink the add and
// round the product alone) and its fixed tree (acg::block_sum_store,
// then acg::launch_sum_partials) are the same in both kernels, so y and
// the dot have the same bits whichever runs, and as
// stencil_spmv_batched's systems.
//
// What limits the fixed kernel (PERF.md, section 6): at 256^3 with the
// dot it reaches about 53% of its f64 bound and 35% of its f32 one,
// timed with calls queued back to back (a call timed alone also holds
// the host's 0.02-0.04 ms wrapper, which hides the gain on a 256 x 128
// x 128 shard: 0.042 ms queued against the generic 0.055).  Each x
// value is read from the L2 by up to five blocks (its row's, the rows
// beside it and the planes beside it), about 0.8 GB a call at f64 that
// the L2 serves at 5-6 TB/s (reasoned from the times; no profiler of
// the L2 here).  Measured on an H100 and dropped: a plane ring in shared
// memory that cut that traffic to about 1.4 x (a producer warp filling 4
// stages of a block's rows by 1-D bulk copies on mbarriers; y's bits
// kept, the dot's owners changed) ran 10-60% slower on every operator;
// one block running 2, 4 or 8 grid-stride blocks' threads (rows beside
// each other on one SM; every bit kept) and a budget of 4 or 8 blocks an
// SM ran no faster.
#include "common.cuh"

namespace {

using acg::kMaxArms;
using acg::kThreads;
using acg::StencilArgs;

template <typename V, bool DOT>
__global__ void __launch_bounds__(kThreads)
stencil_spmv_kernel(const __grid_constant__ StencilArgs a,
                    const V* __restrict__ x,
                    V* __restrict__ y, V* __restrict__ partials,
                    int64_t npad, int64_t n) {
  V dot = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < npad; i += stride) {
    const V acc =
        i < n ? acg::stencil_row<V>(a, x, static_cast<int>(i)) : V(0);
    y[i] = acc;
    if constexpr (DOT) dot += x[i] * acc;
  }
  if constexpr (DOT) acg::block_sum_store<V, kThreads>(dot, partials);
}

// The arms that leave the grid along the last axis at coordinate c2, as
// a bit mask over the arms (needs_lo / needs_hi: the arms stepping -1 /
// +1 along it).
__device__ __forceinline__ unsigned face_mask(const StencilArgs& a, int c2,
                                              unsigned needs_lo,
                                              unsigned needs_hi) {
  return (c2 >= a.lo[2] ? 0u : needs_lo) | (c2 <= a.hi[2] ? 0u : needs_hi);
}

// The fixed-arm row body: the arms not in ``out`` summed from V(0) in
// ascending offset order, xat(k) giving x at arm k; stencil_row's
// arithmetic for a row whose other arms leave the grid.
template <typename V, int NARMS, typename XAt>
__device__ __forceinline__ V fixed_row(const V (&c)[NARMS], unsigned out,
                                       XAt xat) {
  V xv[NARMS];
#pragma unroll
  for (int k = 0; k < NARMS; ++k) xv[k] = (out >> k & 1u) ? V(0) : xat(k);
  V acc = V(0);
#pragma unroll
  for (int k = 0; k < NARMS; ++k)
    if (!(out >> k & 1u)) acc += c[k] * xv[k];
  return acc;
}

// The same rows with the arm count fixed at NARMS: coordinates walked
// with carries; rows inside the interior box on the first two axes
// summed by fixed_row, every load issued before the first multiply-add
// and an arm that leaves the grid along the last axis masked off (no
// divergent branch at the grid's faces along that axis); the other rows
// through stencil_row.  The stride's coordinates must be those of
// gridDim.x * kThreads (the wrapper's).
template <typename V, int NARMS, bool DOT>
__global__ void __launch_bounds__(kThreads)
stencil_spmv_fixed_kernel(const __grid_constant__ StencilArgs a,
                          const V* __restrict__ x, V* __restrict__ y,
                          V* __restrict__ partials, int64_t npad,
                          int64_t n) {
  V c[NARMS];
  int off[NARMS];
  unsigned needs_lo = 0, needs_hi = 0;
#pragma unroll
  for (int k = 0; k < NARMS; ++k) {
    c[k] = static_cast<V>(a.coeffs[k]);
    off[k] = a.offsets[k];
    needs_lo |= (a.digits[k][2] < 0 ? 1u : 0u) << k;
    needs_hi |= (a.digits[k][2] > 0 ? 1u : 0u) << k;
  }
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // the first element's coordinates, the only division; past the grid c0
  // runs past dims[0], outside the box
  int c2 = static_cast<int>(first % a.dims[2]);
  const int64_t r = first / a.dims[2];
  int c1 = static_cast<int>(r % a.dims[1]);
  int c0 = static_cast<int>(r / a.dims[1]);
  V dot = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = first; i < npad; i += stride) {
    V acc;
    if (c0 >= a.lo[0] && c0 <= a.hi[0] && c1 >= a.lo[1] && c1 <= a.hi[1]) {
      acc = fixed_row<V, NARMS>(c, face_mask(a, c2, needs_lo, needs_hi),
                                [&](int k) { return x[i + off[k]]; });
    } else {
      acc = i < n ? acg::stencil_row<V>(a, x, static_cast<int>(i)) : V(0);
    }
    y[i] = acc;
    if constexpr (DOT) dot += x[i] * acc;
    // the next element's coordinates: each digit sum is below twice its
    // axis, so one carry an axis
    c2 += a.stride[2];
    if (c2 >= a.dims[2]) {
      c2 -= a.dims[2];
      ++c1;
    }
    c1 += a.stride[1];
    if (c1 >= a.dims[1]) {
      c1 -= a.dims[1];
      ++c0;
    }
    c0 += a.stride[0];
  }
  if constexpr (DOT) acg::block_sum_store<V, kThreads>(dot, partials);
}

// One launch of the rows: the fixed kernel at the spec's arm count when
// asked for (5, 7 or 27 arms, else cudaErrorInvalidValue), the generic
// one otherwise.
template <typename V, bool DOT>
cudaError_t launch_rows(const StencilArgs& a, const V* xp, V* yp, V* pp,
                        int64_t npad, int64_t n, bool fixed, unsigned grid,
                        cudaStream_t s) {
  if (!fixed) {
    stencil_spmv_kernel<V, DOT><<<grid, kThreads, 0, s>>>(a, xp, yp, pp,
                                                         npad, n);
    return cudaGetLastError();
  }
  switch (a.narms) {
    case 5:
      stencil_spmv_fixed_kernel<V, 5, DOT>
          <<<grid, kThreads, 0, s>>>(a, xp, yp, pp, npad, n);
      return cudaGetLastError();
    case 7:
      stencil_spmv_fixed_kernel<V, 7, DOT>
          <<<grid, kThreads, 0, s>>>(a, xp, yp, pp, npad, n);
      return cudaGetLastError();
    case 27:
      stencil_spmv_fixed_kernel<V, 27, DOT>
          <<<grid, kThreads, 0, s>>>(a, xp, yp, pp, npad, n);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename V>
int launch(const StencilArgs& a, const void* x, void* y, int64_t npad,
           int64_t n, bool fixed, void* partials, int64_t nblocks,
           void* dot_out, cudaStream_t s) {
  const V* xp = static_cast<const V*>(x);
  V* yp = static_cast<V*>(y);
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (dot_out == nullptr)
    return static_cast<int>(launch_rows<V, false>(a, xp, yp, nullptr, npad,
                                                  n, fixed, grid, s));
  cudaError_t e = launch_rows<V, true>(a, xp, yp, static_cast<V*>(partials),
                                       npad, n, fixed, grid, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials<V>(partials, nblocks, dot_out, s));
}

}  // namespace

// args: host pointer to a StencilArgs, copied into the kernel parameters;
// with fixed, its stride must be the coordinates of nblocks * kThreads.
// vec_type: 2 f32, 3 f64.  fixed: nonzero for the fixed-arm kernel (5, 7
// or 27 arms only, else cudaErrorInvalidValue).  dot_out == NULL: no
// fused dot.  Returns the CUDA error of the launches (0 on success).
extern "C" int acg_stencil_spmv(const void* args, const void* x, void* y,
                                int vec_type, int64_t npad, int64_t n,
                                int fixed, void* partials, int64_t nblocks,
                                void* dot_out, void* stream) {
  const StencilArgs& a = *static_cast<const StencilArgs*>(args);
  if (a.narms < 0 || a.narms > kMaxArms)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fixed != 0) {  // the stride's coordinates, each digit inside its axis
    const int64_t step = nblocks * kThreads;
    if (a.stride[2] < 0 || a.stride[2] >= a.dims[2] || a.stride[1] < 0 ||
        a.stride[1] >= a.dims[1] || a.stride[0] < 0 ||
        (static_cast<int64_t>(a.stride[0]) * a.dims[1] + a.stride[1]) *
                    a.dims[2] + a.stride[2] != step)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return launch<float>(a, x, y, npad, n, fixed != 0, partials, nblocks,
                         dot_out, s);
  if (vec_type == 3)
    return launch<double>(a, x, y, npad, n, fixed != 0, partials, nblocks,
                          dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
