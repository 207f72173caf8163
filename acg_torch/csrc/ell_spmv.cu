// Padded-ELL SpMV:
//
//   y[i] = sum_w vals[i, w] * x[colidx[i, w]]     over the (n, W) rectangle
//
// padding lanes holding column 0 and value 0, so no mask is needed.
//
// Replaces the TPU kernel acg_tpu/ops/pallas_spmv.py ell_matvec_pallas
// (_ell_kernel), which kept the whole x in VMEM and summed (tile, W)
// blocks row by row.  Here x stays in device memory and its gathers go
// through the read-only cache; the kernel serves every ELL matvec of the
// port, at f32 and f64 vectors (where the TPU kernel could not run, the
// JAX package used XLA's gather formulation).
//
// Bound on this card: bytes.  Per call it must read the n*W values at
// their storage width (bf16, f32 or f64) and the n*W int32 columns, read
// x and write y once; it does 2 flops per stored entry.  The design keeps
// the two rectangle streams coalesced although rows are W apart: a group
// of G threads (G the least power of two covering W, at most a warp) owns
// one row and reads it G consecutive entries at a time, and the groups of
// a warp own consecutive rows, so a warp reads one contiguous run of the
// row-major rectangle.  Each thread sums its strided entries in order;
// the group then adds the partial sums in a fixed butterfly of warp
// shuffles, and its first thread writes the row.  No atomics: the bits
// are the same on every run.  Values stay in their storage width and are
// widened in registers.  Load balancing across rows of very different
// lengths (the padding W - rowlen is streamed too) is later work.
#include "common.cuh"

namespace {

using acg::kThreads;

template <typename V, typename M, int G>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const M* __restrict__ vals, const int32_t* __restrict__ cols,
                const V* __restrict__ x, V* __restrict__ y, int64_t n,
                int64_t width) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int g = threadIdx.x % G;
  const int lane = threadIdx.x % 32;
  // the lanes of this thread's group within its warp
  const unsigned mask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane - lane % G));
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  if (i >= n) return;  // a whole group leaves together
  const M* vr = vals + i * width;
  const int32_t* cr = cols + i * width;
  V acc = V(0);
  for (int64_t w = g; w < width; w += G)
    acc += acg::band_value<V>(vr[w]) * __ldg(x + cr[w]);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(mask, acc, o, G);
  if (g == 0) y[i] = acc;
}

template <typename V, typename M, int G>
int launch(const void* vals, const void* cols, const void* x, void* y,
           int64_t n, int64_t width, cudaStream_t s) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ell_spmv_kernel<V, M, G><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const M*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const V*>(x), static_cast<V*>(y), n, width);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename M>
int dispatch_group(int group, const void* vals, const void* cols,
                   const void* x, void* y, int64_t n, int64_t width,
                   cudaStream_t s) {
  switch (group) {
    case 1:
      return launch<V, M, 1>(vals, cols, x, y, n, width, s);
    case 2:
      return launch<V, M, 2>(vals, cols, x, y, n, width, s);
    case 4:
      return launch<V, M, 4>(vals, cols, x, y, n, width, s);
    case 8:
      return launch<V, M, 8>(vals, cols, x, y, n, width, s);
    case 16:
      return launch<V, M, 16>(vals, cols, x, y, n, width, s);
    case 32:
      return launch<V, M, 32>(vals, cols, x, y, n, width, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename V>
int dispatch_val(int val_type, int group, const void* vals,
                 const void* cols, const void* x, void* y, int64_t n,
                 int64_t width, cudaStream_t s) {
  switch (val_type) {
    case 0:
      return dispatch_group<V, __nv_bfloat16>(group, vals, cols, x, y, n,
                                              width, s);
    case 2:
      return dispatch_group<V, float>(group, vals, cols, x, y, n, width, s);
    case 3:
      return dispatch_group<V, double>(group, vals, cols, x, y, n, width, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// val_type: 0 bf16, 2 f32, 3 f64.  vec_type: 2 f32, 3 f64.  group: threads
// per row, a power of two <= 32.  Returns the CUDA error of the launch (0
// on success).
extern "C" int acg_ell_spmv(const void* vals, int val_type, const void* cols,
                            const void* x, void* y, int vec_type, int64_t n,
                            int64_t width, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vec_type == 2)
    return dispatch_val<float>(val_type, group, vals, cols, x, y, n, width,
                               s);
  if (vec_type == 3)
    return dispatch_val<double>(val_type, group, vals, cols, x, y, n, width,
                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}
