// The sliced-ELL SpMV core shared by sgell_spmv.cu and ell_spmv.cu:
//
//   y[perm[p]] = sum over j < w_k, in order, of
//                vals[ptr[k] + j*32 + r] * x[cols[ptr[k] + j*32 + r]]
//
// for slice-row p = 32k + r < nrows, with w_k = (ptr[k+1] - ptr[k]) / 32
// (acg_torch/ops/sliced.py builds the layout once, at upload).  Each term
// is a product and then a sum, rounded apart (no fused multiply-add), from
// +0, so y has the bits of the plain version sliced_matvec.
//
// It replaces two TPU kernels: acg_tpu/ops/sgell.py:284
// sgell_matvec_pallas (_sgell_kernel, :262) and acg_tpu/ops/pallas_spmv.py:51
// ell_matvec_pallas (_ell_kernel, :35).  Both read their host layouts as
// they are: the sgell slot pack, made for the TPU, whose only fast gather
// was a lane gather inside one 128-entry x segment held in VMEM; and the
// ELL rectangle padded to the longest row.  On this card a gather from x
// in the 50 MB L2 costs the same inside a segment as outside it, so the
// slots buy nothing, and their padding does cost: on a 3-D FEM mesh after
// RCM the pack holds ~12 slot entries for each stored one, and the
// rectangle ~3.  The sliced layout keeps only each slice's own padding to
// its longest row, which sorting rows by length in windows of sigma rows
// makes small.
//
// Bound on this card: bytes.  A call must read each stored entry's value
// (bf16, f32 or f64) and int32 column once, read x and write y: stored
// entries x (value + 4) + x + y bytes, 2 flops an entry.  The design:
// - one warp a slice, one thread a row; entry j of the warp's 32 rows is
//   contiguous, so each step is one coalesced read of values and one of
//   columns;
// - the operator streams past once: loaded with __ldcs (evict-first), so
//   it does not push x out of L2; x's gathers carry an L2 evict-last
//   policy and stay resident (a few MB against 50);
// - each thread issues the value and column loads of ACG_SLICED_UNROLL
//   entries, then their gathers, then adds them in order: that many
//   independent load chains in flight a thread;
// - no shared memory, no atomics, no cross-warp reduction.
#pragma once

#include "common.cuh"

#ifndef ACG_SLICED_UNROLL
#define ACG_SLICED_UNROLL 4
#endif
// U, as built (acg_torch/ops/sliced.py unroll reads it).
extern "C" int acg_sliced_unroll() { return ACG_SLICED_UNROLL; }

namespace acg {

constexpr int kSliceRows = 32;  // one warp a slice, one thread a row
constexpr int kSlicedUnroll = ACG_SLICED_UNROLL;
static_assert(kThreads % kSliceRows == 0, "whole warps a block");

// Streaming (evict-first) loads of the operator, read once a call.
__device__ __forceinline__ float ld_stream(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ double ld_stream(const double* p) {
  return __ldcs(p);
}
__device__ __forceinline__ int32_t ld_stream(const int32_t* p) {
  return __ldcs(p);
}
__device__ __forceinline__ __nv_bfloat16 ld_stream(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// An L2 policy that keeps what it tags (x) past the streamed operator.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

// x[j] through the read-only path, under the evict-last policy `pol`.
__device__ __forceinline__ float ld_keep(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v)
               : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ double ld_keep(const double* p, uint64_t pol) {
  double v;
  asm volatile("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
               : "=d"(v)
               : "l"(p), "l"(pol));
  return v;
}

// acc + v * g as a product and then a sum, each rounded to nearest.
__device__ __forceinline__ float mul_add_rn(float acc, float v, float g) {
  return __fadd_rn(acc, __fmul_rn(v, g));
}
__device__ __forceinline__ double mul_add_rn(double acc, double v,
                                             double g) {
  return __dadd_rn(acc, __dmul_rn(v, g));
}

template <typename V, typename M>
__global__ void __launch_bounds__(kThreads)
sliced_spmv_kernel(const M* __restrict__ vals,
                   const int32_t* __restrict__ cols,
                   const int64_t* __restrict__ ptr,
                   const int32_t* __restrict__ perm, const V* __restrict__ x,
                   V* __restrict__ y, int64_t nrows, int64_t nslices) {
  const int64_t k =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) /
      kSliceRows;
  if (k >= nslices) return;  // a whole warp leaves together
  const int r = threadIdx.x % kSliceRows;
  const int64_t base = ptr[k];
  const int64_t width = (ptr[k + 1] - base) / kSliceRows;
  const M* vr = vals + base + r;
  const int32_t* cr = cols + base + r;
  const uint64_t pol = evict_last_policy();
  V acc = V(0);
  int64_t j = 0;
  for (; j + kSlicedUnroll <= width; j += kSlicedUnroll) {
    M v[kSlicedUnroll];
    int32_t c[kSlicedUnroll];
    V g[kSlicedUnroll];
#pragma unroll
    for (int u = 0; u < kSlicedUnroll; ++u) {
      v[u] = ld_stream(vr + (j + u) * kSliceRows);
      c[u] = ld_stream(cr + (j + u) * kSliceRows);
    }
#pragma unroll
    for (int u = 0; u < kSlicedUnroll; ++u) g[u] = ld_keep(x + c[u], pol);
#pragma unroll
    for (int u = 0; u < kSlicedUnroll; ++u)
      acc = mul_add_rn(acc, band_value<V>(v[u]), g[u]);
  }
  for (; j < width; ++j) {
    const M v = ld_stream(vr + j * kSliceRows);
    const int32_t c = ld_stream(cr + j * kSliceRows);
    acc = mul_add_rn(acc, band_value<V>(v), ld_keep(x + c, pol));
  }
  const int64_t p = k * kSliceRows + r;
  if (p < nrows) y[perm[p]] = acc;
}

template <typename V, typename M>
int launch_sliced(const void* vals, const void* cols, const void* ptr,
                  const void* perm, const void* x, void* y, int64_t nrows,
                  int64_t nslices, cudaStream_t s) {
  constexpr int kSlicesPerBlock = kThreads / kSliceRows;
  const int64_t blocks = (nslices + kSlicesPerBlock - 1) / kSlicesPerBlock;
  if (nrows <= 0 || nslices <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  sliced_spmv_kernel<V, M><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const M*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const int64_t*>(ptr), static_cast<const int32_t*>(perm),
      static_cast<const V*>(x), static_cast<V*>(y), nrows, nslices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace acg
