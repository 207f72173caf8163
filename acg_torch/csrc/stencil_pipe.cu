// One whole pipelined-CG iteration over a matrix-free constant-
// coefficient stencil, in one pass:
//
//   q  = stencil @ w                          (never stored; 0 past n)
//   z' = q + beta z;  p' = r + beta p;  s' = w + beta s
//   x' = x + alpha p';  r' = r - alpha s';  w' = w - alpha z'
//   gamma = <r', r'>,  delta = <w', r'>
//
// Replaces the TPU kernel acg_tpu/ops/stencil.py
// cg_pipelined_iter_stencil (_stpipe2d_kernel, tile body
// _stencil_tile_acc).
//
// Bound on this card: bytes.  There is no band operand: the operator is
// its spec (acg::StencilArgs), passed by value as a kernel parameter.
// Per call the kernel must read the six vectors (w, z, r, p, s, x) once
// and write the six updated vectors once, 12 vector streams, against
// 2*arms*n + 12*n + 4*n flops and a few integer ops per arm for the
// boundary tests.  One thread per element in a grid-stride loop makes
// its row of q in registers (acg::stencil_row, the SpMV kernel's body)
// and applies the update and the two dot partials (acg::pipe_update)
// there, so q never reaches memory and the dot operands are never
// re-read.  The integer work that bounds the stencil SpMV alone now
// overlaps eleven more vector streams.  z, p, s, x and r are updated in
// place; w' goes to its own buffer (other threads read w at neighbour
// offsets).  alpha and beta are read from device memory.  gamma and
// delta: per-block partials, then one block sums both in a fixed tree
// (acg::sum_partials2_kernel); no float atomics.  Elements n <= i < npad
// (padding) get q = 0 and zero vectors, so they come back exactly zero.
#include "common.cuh"

namespace {

using acg::kMaxArms;
using acg::kThreads;
using acg::StencilArgs;

template <typename V>
__global__ void __launch_bounds__(kThreads)
stencil_pipe_kernel(const __grid_constant__ StencilArgs a,
                    const V* __restrict__ alpha, const V* __restrict__ beta,
                    const V* __restrict__ w, V* __restrict__ w_out,
                    V* __restrict__ z, V* __restrict__ r, V* __restrict__ p,
                    V* __restrict__ s, V* __restrict__ x,
                    V* __restrict__ partials, int64_t npad, int64_t n) {
  const V al = *alpha;
  const V be = *beta;
  V gsum = V(0), dsum = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < npad; i += stride) {
    const V q = i < n ? acg::stencil_row<V>(a, w, static_cast<int>(i)) : V(0);
    acg::pipe_update<V>(i, q, al, be, w, w_out, z, r, p, s, x, gsum, dsum);
  }
  acg::block_sum2_store<V, kThreads>(gsum, dsum, partials,
                                     partials + gridDim.x);
}

template <typename V>
int launch(const StencilArgs& a, const void* alpha, const void* beta,
           const void* w, void* w_out, void* z, void* r, void* p, void* s,
           void* x, int64_t npad, int64_t n, void* partials, int64_t nblocks,
           void* gd_out, cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(nblocks);
  stencil_pipe_kernel<V><<<grid, kThreads, 0, st>>>(
      a, static_cast<const V*>(alpha), static_cast<const V*>(beta),
      static_cast<const V*>(w), static_cast<V*>(w_out), static_cast<V*>(z),
      static_cast<V*>(r), static_cast<V*>(p), static_cast<V*>(s),
      static_cast<V*>(x), static_cast<V*>(partials), npad, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials2<V>(partials, nblocks, gd_out, st));
}

}  // namespace

// args: host pointer to a StencilArgs, copied into the kernel parameters.
// vec_type: 2 f32, 3 f64.  alpha, beta: device scalars at the vector
// type.  partials: 2*nblocks scratch; gd_out: 2 values, gamma then delta.
// Returns the CUDA error of the launches (0 on success).
extern "C" int acg_stencil_pipe(const void* args, const void* alpha,
                                const void* beta, const void* w, void* w_out,
                                void* z, void* r, void* p, void* s, void* x,
                                int vec_type, int64_t npad, int64_t n,
                                void* partials, int64_t nblocks,
                                void* gd_out, void* stream) {
  const StencilArgs& a = *static_cast<const StencilArgs*>(args);
  if (a.narms < 0 || a.narms > kMaxArms)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return launch<float>(a, alpha, beta, w, w_out, z, r, p, s, x, npad, n,
                         partials, nblocks, gd_out, st);
  if (vec_type == 3)
    return launch<double>(a, alpha, beta, w, w_out, z, r, p, s, x, npad, n,
                          partials, nblocks, gd_out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
