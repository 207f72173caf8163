// One whole pipelined-CG iteration over a DIA operator, in one pass:
//
//   q  = DIA(bands, offsets) @ w              (never stored)
//   z' = q + beta z;  p' = r + beta p;  s' = w + beta s
//   x' = x + alpha p';  r' = r - alpha s';  w' = w - alpha z'
//   gamma = <r', r'>,  delta = <w', r'>
//
// Replaces the TPU kernel acg_tpu/ops/pallas_kernels.py
// cg_pipelined_iter_pallas (_pipe2d_kernel, tile body _banded_tile_acc).
//
// Bound on this card: bytes.  Per call the kernel must read the D*n band
// values at their storage width and the six vectors (w, z, r, p, s, x)
// once, and write the six updated vectors once: 12 vector streams plus
// the bands, against 2*D*n + 12*n + 4*n flops.  The design keeps to
// that: one thread per row in a grid-stride loop computes its row of q
// (acg::dia_row, the SpMV kernel's body), then the update and the two
// dot partials (acg::pipe_update) while everything is in registers, so
// q never reaches memory and the dot operands are never re-read.  z, p,
// s, x and r are updated in place; w' goes to its own buffer (other
// threads read w at neighbour offsets).  alpha and beta are read from
// device memory, so the host never waits for them.  gamma and delta are
// reduced as in the fused SpMV: per-block partials, then one block sums
// both in a fixed tree (acg::sum_partials2_kernel); no float atomics.
// The vectors keep the DeviceDia layout (no zero halo): padding rows
// carry zero bands and zero vectors in, so they come back exactly zero.
#include "common.cuh"

namespace {

using acg::kThreads;

template <typename V, typename B, bool SCALED>
__global__ void __launch_bounds__(kThreads)
dia_pipe_kernel(const B* __restrict__ bands, const V* __restrict__ scales,
                const int64_t* __restrict__ offsets, int64_t ndiags,
                const V* __restrict__ alpha, const V* __restrict__ beta,
                const V* __restrict__ w, V* __restrict__ w_out,
                V* __restrict__ z, V* __restrict__ r, V* __restrict__ p,
                V* __restrict__ s, V* __restrict__ x,
                V* __restrict__ partials, int64_t n) {
  const V a = *alpha;
  const V b = *beta;
  V gsum = V(0), dsum = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const V q =
        acg::dia_row<V, B, SCALED>(bands, scales, offsets, ndiags, w, i, n);
    acg::pipe_update<V>(i, q, a, b, w, w_out, z, r, p, s, x, gsum, dsum);
  }
  acg::block_sum2_store<V, kThreads>(gsum, dsum, partials,
                                     partials + gridDim.x);
}

template <typename V, typename B, bool SCALED>
int launch(const void* bands, const void* scales, const void* offsets,
           int64_t ndiags, const void* alpha, const void* beta,
           const void* w, void* w_out, void* z, void* r, void* p, void* s,
           void* x, int64_t n, void* partials, int64_t nblocks, void* gd_out,
           cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(nblocks);
  dia_pipe_kernel<V, B, SCALED><<<grid, kThreads, 0, st>>>(
      static_cast<const B*>(bands), static_cast<const V*>(scales),
      static_cast<const int64_t*>(offsets), ndiags,
      static_cast<const V*>(alpha), static_cast<const V*>(beta),
      static_cast<const V*>(w), static_cast<V*>(w_out), static_cast<V*>(z),
      static_cast<V*>(r), static_cast<V*>(p), static_cast<V*>(s),
      static_cast<V*>(x), static_cast<V*>(partials), n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials2<V>(partials, nblocks, gd_out, st));
}

template <typename V>
int dispatch_band(int band_type, const void* bands, const void* scales,
                  const void* offsets, int64_t ndiags, const void* alpha,
                  const void* beta, const void* w, void* w_out, void* z,
                  void* r, void* p, void* s, void* x, int64_t n,
                  void* partials, int64_t nblocks, void* gd_out,
                  cudaStream_t st) {
  switch (band_type) {
    case 0:
      return launch<V, __nv_bfloat16, false>(bands, scales, offsets, ndiags,
                                             alpha, beta, w, w_out, z, r, p,
                                             s, x, n, partials, nblocks,
                                             gd_out, st);
    case 1:
      return launch<V, int8_t, true>(bands, scales, offsets, ndiags, alpha,
                                     beta, w, w_out, z, r, p, s, x, n,
                                     partials, nblocks, gd_out, st);
    case 2:
      return launch<V, float, false>(bands, scales, offsets, ndiags, alpha,
                                     beta, w, w_out, z, r, p, s, x, n,
                                     partials, nblocks, gd_out, st);
    case 3:
      return launch<V, double, false>(bands, scales, offsets, ndiags, alpha,
                                      beta, w, w_out, z, r, p, s, x, n,
                                      partials, nblocks, gd_out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  alpha, beta: device scalars at the vector
// type.  partials: 2*nblocks scratch; gd_out: 2 values, gamma then delta.
// Returns the CUDA error of the launches (0 on success).
extern "C" int acg_dia_pipe(const void* bands, int band_type,
                            const void* scales, const void* offsets,
                            int64_t ndiags, const void* alpha,
                            const void* beta, const void* w, void* w_out,
                            void* z, void* r, void* p, void* s, void* x,
                            int vec_type, int64_t n, void* partials,
                            int64_t nblocks, void* gd_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return dispatch_band<float>(band_type, bands, scales, offsets, ndiags,
                                alpha, beta, w, w_out, z, r, p, s, x, n,
                                partials, nblocks, gd_out, st);
  if (vec_type == 3)
    return dispatch_band<double>(band_type, bands, scales, offsets, ndiags,
                                 alpha, beta, w, w_out, z, r, p, s, x, n,
                                 partials, nblocks, gd_out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
