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
// write y once.  Each band value is made in registers as coefficient x
// boundary test from the element's grid coordinates, a few integer ops
// per arm (32-bit: the wrapper admits npad < 2^31).  One thread per
// element in a grid-stride loop keeps the accesses coalesced, and the
// shifted reads of x hit cache lines neighbouring threads also read.
// Grids of fewer than 3 axes are padded with leading unit axes by the
// wrapper, so the kernel always works in 3-D.  Arms are summed in
// ascending flat-offset order, as on the TPU (the row body
// acg::stencil_row and the StencilArgs struct are in common.cuh).
// Shared-memory staging of x planes is later work.
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

template <typename V>
int launch(const StencilArgs& a, const void* x, void* y, int64_t npad,
           int64_t n, void* partials, int64_t nblocks, void* dot_out,
           cudaStream_t s) {
  const V* xp = static_cast<const V*>(x);
  V* yp = static_cast<V*>(y);
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (dot_out == nullptr) {
    stencil_spmv_kernel<V, false><<<grid, kThreads, 0, s>>>(
        a, xp, yp, nullptr, npad, n);
    return static_cast<int>(cudaGetLastError());
  }
  stencil_spmv_kernel<V, true><<<grid, kThreads, 0, s>>>(
      a, xp, yp, static_cast<V*>(partials), npad, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials<V>(partials, nblocks, dot_out, s));
}

}  // namespace

// args: host pointer to a StencilArgs, copied into the kernel parameters.
// vec_type: 2 f32, 3 f64.  dot_out == NULL: no fused dot.
// Returns the CUDA error of the launches (0 on success).
extern "C" int acg_stencil_spmv(const void* args, const void* x, void* y,
                                int vec_type, int64_t npad, int64_t n,
                                void* partials, int64_t nblocks,
                                void* dot_out, void* stream) {
  const StencilArgs& a = *static_cast<const StencilArgs*>(args);
  if (a.narms < 0 || a.narms > kMaxArms)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return launch<float>(a, x, y, npad, n, partials, nblocks, dot_out, s);
  if (vec_type == 3)
    return launch<double>(a, x, y, npad, n, partials, nblocks, dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
