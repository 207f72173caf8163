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
// ascending flat-offset order, as on the TPU.  Shared-memory staging of
// x planes is later work.
#include "common.cuh"

namespace {

using acg::kThreads;

constexpr int kMaxArms = 32;

// Mirrored field for field by the ctypes Structure in
// acg_torch/ops/stencil.py (_CStencil).
struct StencilArgs {
  int32_t narms;
  int32_t dims[3];              // grid, slowest axis first
  int32_t offsets[kMaxArms];    // flat offsets, ascending
  int32_t digits[kMaxArms][3];  // per-arm shift along each axis, in {-1,0,1}
  double coeffs[kMaxArms];
};

template <typename V, bool DOT>
__global__ void __launch_bounds__(kThreads)
stencil_spmv_kernel(const StencilArgs a, const V* __restrict__ x,
                    V* __restrict__ y, V* __restrict__ partials,
                    int64_t npad, int64_t n) {
  V dot = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < npad; i += stride) {
    V acc = V(0);
    if (i < n) {
      const int e = static_cast<int>(i);
      const int c2 = e % a.dims[2];
      const int r = e / a.dims[2];
      const int c1 = r % a.dims[1];
      const int c0 = r / a.dims[1];
      for (int k = 0; k < a.narms; ++k) {
        const int n0 = c0 + a.digits[k][0];
        const int n1 = c1 + a.digits[k][1];
        const int n2 = c2 + a.digits[k][2];
        if (n0 >= 0 && n0 < a.dims[0] && n1 >= 0 && n1 < a.dims[1] &&
            n2 >= 0 && n2 < a.dims[2])
          acc += static_cast<V>(a.coeffs[k]) * x[e + a.offsets[k]];
      }
    }
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
