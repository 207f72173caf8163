// Multi-RHS DIA SpMV with an optional fused per-system <x_s, y_s>:
//
//   Y[s, i] = sum_d band[d, i] * X[s, i + off[d]]   (0 <= i + off[d] < n)
//   dot[s]  = sum_i X[s, i] * Y[s, i]               (with_dot: p'Ap of
//                                                    every system)
//
// for B systems against one operator, X and Y contiguous (B, n).
//
// Replaces the TPU kernel acg_tpu/ops/pallas_kernels.py
// dia_matvec_pallas_2d_padded_batched (_dia2d_padded_batched_kernel),
// and its eager wrapper dia_matvec_pallas_2d_batched.
//
// Bound on this card: bytes.  Per call the kernel must read the D*n band
// values once, read X once and write Y once: D*n*band_bytes +
// 2*B*n*vec_bytes; it does 2*D*n*B flops, far below the card's rate on
// that traffic.  The point of batching is the first term: as on the
// TPU, where the band tile is fetched once per row tile for all B
// systems, each thread here tests a band's bounds and loads, widens and
// (int8) scales its band value once, then applies it to every system of
// its chunk.  Systems run in chunks of at most 8 (template width NB in
// {1, 2, 4, 8}), so the NB accumulators stay in registers; B > 8 runs
// ceil(B/8) chunks and reads the band stream once per chunk.
//
// Registers: with the dot a thread carries 2*NB running sums (its row's
// accumulators and its dot partials).  On its own ptxas gives those
// kernels 48-66 registers a thread; compiled for four blocks an SM (at
// most 64) they schedule their loads better and run 6-19% faster on an
// H100 at 256^3, B = 8, in every band tier.  Without the dot ptxas's own
// choice (32-40) is kept: the same bound raises it and costs 11-20% at
// f32 (measured: PERF.md section 6).  So the two forms are two entry points
// over one row walk.  Staging x instead (TMA bulk copies into shared
// memory shared across a thread-block cluster) was measured and was
// slower on that card.
//
// Bits: the launch geometry (grid_blocks(n) blocks, one thread per row
// in a grid-stride loop), the band order, the multiply-adds and the
// per-system two-pass dot (acg::block_sum_rows_store, then
// acg::sum_partials_rows_kernel) are those of dia_spmv.cu, so each
// system's Y row and dot are bit-identical to the one-system kernel on
// that system.  No float atomics.
#include "common.cuh"

namespace {

using acg::kThreads;

// Blocks an SM that the dot kernel is compiled for: ptxas then keeps a
// thread within 64 registers (65,536 / (4 * 256)).
constexpr int kDotBlocksPerSm = 4;

template <typename V, typename B, bool SCALED, int NB, bool DOT>
__device__ __forceinline__ void dia_rows(const B* __restrict__ bands,
                                         const V* __restrict__ scales,
                                         const int64_t* __restrict__ offsets,
                                         int64_t ndiags,
                                         const V* __restrict__ X,
                                         V* __restrict__ Y,
                                         V* __restrict__ partials, int64_t n,
                                         int nsys, int64_t nblocks) {
  V dot[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) dot[s] = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    V acc[NB];
#pragma unroll
    for (int s = 0; s < NB; ++s) acc[s] = V(0);
    for (int64_t d = 0; d < ndiags; ++d) {
      const int64_t j = i + offsets[d];
      if (j >= 0 && j < n) {
        V b = acg::band_value<V>(bands[d * n + i]);
        if constexpr (SCALED) b *= scales[d];
#pragma unroll
        for (int s = 0; s < NB; ++s)
          if (s < nsys) acc[s] += b * X[s * n + j];
      }
    }
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      if (s < nsys) {
        Y[s * n + i] = acc[s];
        if constexpr (DOT) dot[s] += X[s * n + i] * acc[s];
      }
    }
  }
  if constexpr (DOT)
    acg::block_sum_rows_store<V, kThreads, NB>(dot, nsys, partials, nblocks);
}

// Without the dot: ptxas's own register choice (32-40 a thread).
template <typename V, typename B, bool SCALED, int NB>
__global__ void __launch_bounds__(kThreads)
dia_spmv_batched_kernel(const B* __restrict__ bands,
                        const V* __restrict__ scales,
                        const int64_t* __restrict__ offsets, int64_t ndiags,
                        const V* __restrict__ X, V* __restrict__ Y, int64_t n,
                        int nsys) {
  dia_rows<V, B, SCALED, NB, false>(bands, scales, offsets, ndiags, X, Y,
                                    nullptr, n, nsys, 0);
}

// With the dot: compiled for kDotBlocksPerSm blocks an SM (the note at
// the top says why).
template <typename V, typename B, bool SCALED, int NB>
__global__ void __launch_bounds__(kThreads, kDotBlocksPerSm)
dia_spmv_batched_dot_kernel(const B* __restrict__ bands,
                            const V* __restrict__ scales,
                            const int64_t* __restrict__ offsets,
                            int64_t ndiags, const V* __restrict__ X,
                            V* __restrict__ Y, V* __restrict__ partials,
                            int64_t n, int nsys, int64_t nblocks) {
  dia_rows<V, B, SCALED, NB, true>(bands, scales, offsets, ndiags, X, Y,
                                   partials, n, nsys, nblocks);
}

template <typename V, typename B, bool SCALED, int NB>
cudaError_t launch_chunk(const B* bp, const V* sp, const int64_t* op,
                         int64_t ndiags, const V* x, V* y, V* partials,
                         int64_t n, int nsys, int64_t nblocks, bool dot,
                         cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (dot)
    dia_spmv_batched_dot_kernel<V, B, SCALED, NB><<<grid, kThreads, 0, s>>>(
        bp, sp, op, ndiags, x, y, partials, n, nsys, nblocks);
  else
    dia_spmv_batched_kernel<V, B, SCALED, NB><<<grid, kThreads, 0, s>>>(
        bp, sp, op, ndiags, x, y, n, nsys);
  return cudaGetLastError();
}

template <typename V, typename B, bool SCALED>
int launch(const void* bands, const void* scales, const void* offsets,
           int64_t ndiags, const void* x, void* y, int64_t n, int64_t nsys,
           void* partials, int64_t nblocks, void* dot_out, cudaStream_t s) {
  const B* bp = static_cast<const B*>(bands);
  const V* sp = static_cast<const V*>(scales);
  const int64_t* op = static_cast<const int64_t*>(offsets);
  const bool dot = dot_out != nullptr;
  for (int64_t s0 = 0; s0 < nsys; s0 += acg::kMaxChunk) {
    const int64_t left = nsys - s0;
    const int c = static_cast<int>(left < acg::kMaxChunk ? left
                                                         : acg::kMaxChunk);
    const V* xc = static_cast<const V*>(x) + s0 * n;
    V* yc = static_cast<V*>(y) + s0 * n;
    V* pc = dot ? static_cast<V*>(partials) + s0 * nblocks : nullptr;
    cudaError_t e;
    switch (acg::chunk_width(c)) {
      case 1:
        e = launch_chunk<V, B, SCALED, 1>(bp, sp, op, ndiags, xc, yc, pc, n,
                                          c, nblocks, dot, s);
        break;
      case 2:
        e = launch_chunk<V, B, SCALED, 2>(bp, sp, op, ndiags, xc, yc, pc, n,
                                          c, nblocks, dot, s);
        break;
      case 4:
        e = launch_chunk<V, B, SCALED, 4>(bp, sp, op, ndiags, xc, yc, pc, n,
                                          c, nblocks, dot, s);
        break;
      default:
        e = launch_chunk<V, B, SCALED, 8>(bp, sp, op, ndiags, xc, yc, pc, n,
                                          c, nblocks, dot, s);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!dot) return 0;
  return static_cast<int>(
      acg::launch_sum_partials_rows<V>(partials, nblocks, nsys, dot_out, s));
}

template <typename V>
int dispatch_band(int band_type, const void* bands, const void* scales,
                  const void* offsets, int64_t ndiags, const void* x,
                  void* y, int64_t n, int64_t nsys, void* partials,
                  int64_t nblocks, void* dot_out, cudaStream_t s) {
  switch (band_type) {
    case 0:
      return launch<V, __nv_bfloat16, false>(bands, scales, offsets, ndiags,
                                             x, y, n, nsys, partials, nblocks,
                                             dot_out, s);
    case 1:
      return launch<V, int8_t, true>(bands, scales, offsets, ndiags, x, y, n,
                                     nsys, partials, nblocks, dot_out, s);
    case 2:
      return launch<V, float, false>(bands, scales, offsets, ndiags, x, y, n,
                                     nsys, partials, nblocks, dot_out, s);
    case 3:
      return launch<V, double, false>(bands, scales, offsets, ndiags, x, y,
                                      n, nsys, partials, nblocks, dot_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  x, y: (nsys, n) contiguous.  partials:
// (nsys, nblocks) scratch, dot_out: (nsys,); dot_out == NULL: no fused
// dot.  Returns the CUDA error of the launches (0 on success).
extern "C" int acg_dia_spmv_batched(const void* bands, int band_type,
                                    const void* scales, const void* offsets,
                                    int64_t ndiags, const void* x, void* y,
                                    int vec_type, int64_t n, int64_t nsys,
                                    void* partials, int64_t nblocks,
                                    void* dot_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsys < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (vec_type == 2)
    return dispatch_band<float>(band_type, bands, scales, offsets, ndiags, x,
                                y, n, nsys, partials, nblocks, dot_out, s);
  if (vec_type == 3)
    return dispatch_band<double>(band_type, bands, scales, offsets, ndiags,
                                 x, y, n, nsys, partials, nblocks, dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
