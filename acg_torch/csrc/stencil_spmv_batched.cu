// Multi-RHS matrix-free constant-coefficient stencil SpMV with an
// optional fused per-system <x_s, y_s>:
//
//   Y[s, i] = sum_k c_k * X[s, i + off_k]  over the arms k whose shifted
//             grid coordinates stay inside the grid (Dirichlet truncation)
//   Y[s, i] = 0                            for n <= i < npad (padding)
//   dot[s]  = sum_i X[s, i] * Y[s, i]      (with_dot: p'Ap of every system)
//
// for B systems, X and Y contiguous (B, npad).
//
// Replaces the TPU kernel acg_tpu/ops/stencil.py
// stencil_matvec_pallas_padded_batched (_stencil2d_batched_kernel).
//
// Bound on this card: bytes, B*2*npad*vec_bytes (X read once, Y written
// once; the operator is its spec in the constant bank).  The one-system
// stencil_spmv.cu's generic kernel reaches two fifths of its bound at
// f64 and a fifth at f32 (with the dot, calls queued back to back): it
// is held back by its per-element integer work, the divisions that turn
// the element index into grid coordinates and the per-arm boundary
// tests (its fixed-arm kernel, which walks the coordinates without
// division, reaches about half at f64 and a third at f32: PERF.md).
// Here each thread does that work once per element for all systems of
// its chunk: it derives the coordinates once, tests each arm once, and
// applies an in-bounds arm to every system.  Systems run in chunks of at
// most 8 (template width NB in {1, 2, 4, 8}); the NB accumulators stay
// in registers.  Indices are 32-bit within a system (the wrapper admits
// npad < 2^31) and 64-bit across systems.
//
// Registers: the kernel is compiled for four blocks an SM (at most 64
// registers a thread).  ptxas then schedules the loads better than on
// its own (it gives the f64 kernel with the dot 64 registers either
// way): on an H100 at 256^3, B = 8, 8-10% faster with the dot at f64,
// 15-19% without it, and no slower at f32 (measured: PERF.md section 6).
// Staging x instead (TMA bulk copies into shared memory shared across a
// thread-block cluster) was measured and was slower on that card.
//
// Bits: the launch geometry (grid_blocks(npad) blocks, one thread per
// element in a grid-stride loop), the arm order, the multiply-adds and
// the per-system two-pass dot are those of stencil_spmv.cu, so each
// system's Y row and dot are bit-identical to the one-system kernel on
// that system.  No float atomics.
#include "common.cuh"

namespace {

using acg::kMaxArms;
using acg::kThreads;
using acg::StencilArgs;

// Blocks an SM that the kernel is compiled for: ptxas then keeps a thread
// within 64 registers (65,536 / (4 * 256)).
constexpr int kBlocksPerSm = 4;

template <typename V, int NB, bool DOT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stencil_spmv_batched_kernel(const __grid_constant__ StencilArgs a,
                            const V* __restrict__ X, V* __restrict__ Y,
                            V* __restrict__ partials, int64_t npad,
                            int64_t n, int nsys, int64_t nblocks) {
  V dot[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) dot[s] = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < npad; i += stride) {
    V acc[NB];
#pragma unroll
    for (int s = 0; s < NB; ++s) acc[s] = V(0);
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
            n2 >= 0 && n2 < a.dims[2]) {
          const V c = static_cast<V>(a.coeffs[k]);
          const int j = e + a.offsets[k];
#pragma unroll
          for (int s = 0; s < NB; ++s)
            if (s < nsys) acc[s] += c * X[s * npad + j];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      if (s < nsys) {
        Y[s * npad + i] = acc[s];
        if constexpr (DOT) dot[s] += X[s * npad + i] * acc[s];
      }
    }
  }
  if constexpr (DOT)
    acg::block_sum_rows_store<V, kThreads, NB>(dot, nsys, partials, nblocks);
}

template <typename V, int NB>
cudaError_t launch_chunk(const StencilArgs& a, const V* x, V* y, V* partials,
                         int64_t npad, int64_t n, int nsys, int64_t nblocks,
                         bool dot, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (dot)
    stencil_spmv_batched_kernel<V, NB, true><<<grid, kThreads, 0, s>>>(
        a, x, y, partials, npad, n, nsys, nblocks);
  else
    stencil_spmv_batched_kernel<V, NB, false><<<grid, kThreads, 0, s>>>(
        a, x, y, nullptr, npad, n, nsys, nblocks);
  return cudaGetLastError();
}

template <typename V>
int launch(const StencilArgs& a, const void* x, void* y, int64_t npad,
           int64_t n, int64_t nsys, void* partials, int64_t nblocks,
           void* dot_out, cudaStream_t s) {
  const bool dot = dot_out != nullptr;
  for (int64_t s0 = 0; s0 < nsys; s0 += acg::kMaxChunk) {
    const int64_t left = nsys - s0;
    const int c = static_cast<int>(left < acg::kMaxChunk ? left
                                                         : acg::kMaxChunk);
    const V* xc = static_cast<const V*>(x) + s0 * npad;
    V* yc = static_cast<V*>(y) + s0 * npad;
    V* pc = dot ? static_cast<V*>(partials) + s0 * nblocks : nullptr;
    cudaError_t e;
    switch (acg::chunk_width(c)) {
      case 1:
        e = launch_chunk<V, 1>(a, xc, yc, pc, npad, n, c, nblocks, dot, s);
        break;
      case 2:
        e = launch_chunk<V, 2>(a, xc, yc, pc, npad, n, c, nblocks, dot, s);
        break;
      case 4:
        e = launch_chunk<V, 4>(a, xc, yc, pc, npad, n, c, nblocks, dot, s);
        break;
      default:
        e = launch_chunk<V, 8>(a, xc, yc, pc, npad, n, c, nblocks, dot, s);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!dot) return 0;
  return static_cast<int>(
      acg::launch_sum_partials_rows<V>(partials, nblocks, nsys, dot_out, s));
}

}  // namespace

// args: host pointer to a StencilArgs, copied into the kernel parameters.
// vec_type: 2 f32, 3 f64.  x, y: (nsys, npad) contiguous.  partials:
// (nsys, nblocks) scratch, dot_out: (nsys,); dot_out == NULL: no fused
// dot.  Returns the CUDA error of the launches (0 on success).
extern "C" int acg_stencil_spmv_batched(const void* args, const void* x,
                                        void* y, int vec_type, int64_t npad,
                                        int64_t n, int64_t nsys,
                                        void* partials, int64_t nblocks,
                                        void* dot_out, void* stream) {
  const StencilArgs& a = *static_cast<const StencilArgs*>(args);
  if (a.narms < 0 || a.narms > kMaxArms || nsys < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return launch<float>(a, x, y, npad, n, nsys, partials, nblocks, dot_out,
                         s);
  if (vec_type == 3)
    return launch<double>(a, x, y, npad, n, nsys, partials, nblocks, dot_out,
                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}
