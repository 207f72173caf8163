// ELL SpMV on the sliced layout of its rectangle:
//
//   y[i] = sum over w, in lane order, of vals[i, w] * x[colidx[i, w]]
//
// over each row's lanes up to its last nonzero one (acg_torch/ops/sliced.py
// slice_ell); the operator may be rectangular (the distributed solver's
// interface operator: border rows x ghost slots).
//
// Replaces the TPU kernel acg_tpu/ops/pallas_spmv.py:51 ell_matvec_pallas
// (_ell_kernel, :35), which kept the whole x in VMEM and summed (tile, W)
// blocks row by row.  Here x stays in device memory and in L2, and the
// kernel serves every ELL matvec of the port, at f32 and f64 vectors
// (where the TPU kernel could not run, the JAX package used XLA's gather).
// The core, its layout and why it streams no padding to the longest row
// are in sliced_spmv.cuh.
//
// Bound on this card: bytes, stored entries x (value + 4) + x + y.
//
// Each row is summed by one thread in lane order, a product then a sum per
// entry: the bits are the same on every run, equal to the plain
// sliced_matvec's, and within rounding of ell_matvec's row sums.
#include "sliced_spmv.cuh"

namespace {

template <typename V>
int dispatch_val(int val_type, const void* vals, const void* cols,
                 const void* ptr, const void* perm, const void* x, void* y,
                 int64_t nrows, int64_t nslices, cudaStream_t s) {
  switch (val_type) {
    case 0:
      return acg::launch_sliced<V, __nv_bfloat16>(vals, cols, ptr, perm, x, y,
                                                  nrows, nslices, s);
    case 2:
      return acg::launch_sliced<V, float>(vals, cols, ptr, perm, x, y, nrows,
                                          nslices, s);
    case 3:
      return acg::launch_sliced<V, double>(vals, cols, ptr, perm, x, y, nrows,
                                           nslices, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// val_type: 0 bf16, 2 f32, 3 f64.  vec_type: 2 f32, 3 f64.  nslices =
// ceil(nrows / 32).  Returns the CUDA error of the launch (0 on success).
extern "C" int acg_ell_spmv(const void* vals, int val_type, const void* cols,
                            const void* ptr, const void* perm, const void* x,
                            void* y, int vec_type, int64_t nrows,
                            int64_t nslices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return dispatch_val<float>(val_type, vals, cols, ptr, perm, x, y, nrows,
                               nslices, s);
  if (vec_type == 3)
    return dispatch_val<double>(val_type, vals, cols, ptr, perm, x, y, nrows,
                                nslices, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
