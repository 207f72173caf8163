// Segmented-gather ELL (sgell) SpMV on the sliced layout of its pack:
//
//   y[t*1024 + s*128 + l] = sum over the slots k of tile t, in slot order,
//                           of vals[k, s, l] * x[seg[k, s]*128 + idx[k, s, l]]
//
// with the slot positions that hold no entry dropped when the pack was
// sliced (acg_torch/ops/sgell.py slice_pack).
//
// Replaces the TPU kernel acg_tpu/ops/sgell.py:284 sgell_matvec_pallas
// (_sgell_kernel, :262).  The core, its layout and why the TPU's slots are
// not kept on this card are in sliced_spmv.cuh.
//
// Bound on this card: bytes, stored entries x (value + 4) + x + y.
//
// Bits: each row is a product and then a sum per entry, in slot order, from
// +0 (__fmul_rn, __fadd_rn, no fused multiply-add), as on the TPU.  A
// dropped slot position would have added v*x = +-0 (v = 0, x finite) to a
// sum that is never -0 (it starts at +0, and +0 + -0 is +0), which changes
// no bit, so y has the bits of the plain sgell_matvec on the padded pack.
#include "sliced_spmv.cuh"

// val_type: 0 bf16, 2 f32.  vec_type: 2 (f32 vectors only, as the JAX
// tier).  nslices = ceil(nrows / 32).  Returns the CUDA error of the
// launch (0 on success).
extern "C" int acg_sgell_spmv(const void* vals, int val_type,
                              const void* cols, const void* ptr,
                              const void* perm, const void* x, void* y,
                              int vec_type, int64_t nrows, int64_t nslices,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_type != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (val_type == 0)
    return acg::launch_sliced<float, __nv_bfloat16>(vals, cols, ptr, perm, x,
                                                    y, nrows, nslices, s);
  if (val_type == 2)
    return acg::launch_sliced<float, float>(vals, cols, ptr, perm, x, y,
                                            nrows, nslices, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
