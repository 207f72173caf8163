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
// the bands, against 2*D*n + 12*n + 4*n flops.  On an H100 (700 W) that
// is 0.311 ms at 256^3 with bf16 bands and f32 vectors, 0.0776 ms on a
// 256^3/4 shard.  One thread per row in a grid-stride loop computes its
// row of q, then the update and the two dot partials (acg::pipe_arith)
// while everything is in registers, so q never reaches memory and the
// dot operands are never re-read.  z, p, s, x and r are updated in
// place; w' goes to its own buffer (other threads read w at neighbour
// offsets).  alpha and beta are read from device memory, so the host
// never waits for them.  The vectors keep the DeviceDia layout (no zero
// halo): padding rows carry zero bands and zero vectors in, so they come
// back exactly zero.
//
// The first kernel (dia_pipe_kernel, the generic body) took 0.496 ms a
// call at 256^3 bf16/f32 (25 queued back to back; 0.55-0.61 one call at
// a time) and 0.126 ms on the shard's size: 60-63% of the bound, for
// three reasons.  Its row, acg::dia_row, loops over a band count read at
// run time, with offsets from memory and a bounds test per band, so a
// row issues its band and w loads one band at a time (the same body took
// 0.27-0.30 ms in dia_spmv, where a fixed band count took 0.17-0.19).
// Its eleven single-use streams (the bands, z, p, s, x, r read and
// z, p, s, x, r, w' written) compete in the L2 with the shifted re-reads
// of w (+-65,536 rows at 256^3).  And gamma and delta took a second
// launch, a one-block reduce of the per-block partials.
//
// So, for the band counts the port's operators have (3, 5, 7, 27:
// dia_plan.FIXED_BANDS), dia_pipe_fixed_kernel has D fixed at compile
// time: the offsets and scales go into registers once; a row whose
// every column lies inside [0, n) (one test a row: i + min(off) >= 0
// and i + max(off) < n) has its D band loads, D loads of w and five
// vector loads issued before the first multiply-add, is summed with
// acg::dia_row_interior<D> and takes w[i] from the band at offset 0;
// the first and last rows take acg::dia_row.  A thread loads two rows
// (i and i + stride) before it sums either: 128 registers a thread at
// bf16/f32, two blocks an SM, and faster than one row a step (0.430
// against 0.463 ms at 66 registers, three blocks an SM, and 0.446 with
// the registers capped for four; scripts/torch_dia_ab.py --pipe-only).
// The bands and the five vectors are read streaming (__ldcs) and z', p',
// s', x', r', w' written streaming (__stcs), so they leave the caches
// first and w's lines stay in the L2.  Both kernels end with
// acg::last_block_sum2: the last block to finish sums the partials in
// sum_partials2_kernel's tree, one launch a call.  The rows, their
// owners (one a thread, grid-stride order, grid_blocks(n) blocks), the
// row sums (dia_row_at's arithmetic) and the update (pipe_arith) are
// the same in both kernels, so the six vectors, gamma and delta have the
// same bits whichever runs, and the bits of the two-launch kernel
// before.  On an H100 (700 W) the fixed kernel takes
// 0.429 ms at 256^3 bf16/f32 (72% of the bound), 0.393 at int8/f32
// (70%), 0.116 on the shard's size (67%); at f64 vectors it lost to the
// generic one (0.99 against 0.93 ms at 256^3), which is 82% of its
// bound there.  At f32 vectors the fixed kernel also led at D = 3 in
// every band tier (0.208 against 0.250 ms on a 10^7-row tridiagonal,
// bf16 bands) and at D = 5 with bf16 and int8 bands (not f32), but at
// D = 27 only with int8 bands: with bf16 and f32 bands its 224
// registers a thread leave one block an SM, and it lost (0.152 against
// 0.122 ms at 128^3, bf16 bands).  Which kernel an operator takes is
// its plan's (acg_torch/ops/dia_plan.py pipe_fixed; PERF.md).
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
                V* __restrict__ s, V* __restrict__ x, V* partials,
                unsigned* counter, V* __restrict__ gd, int64_t n) {
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
  acg::last_block_sum2<V, kThreads>(partials, counter, gd);
}

// The operands of one row of the fixed kernel, loaded ahead of its sums:
// the five vectors at i and, for an interior row, its D band values and
// the D values of w it reads.
template <typename V, typename B, int D>
struct PipeRow {
  B bv[D];
  V wv[D];
  V z, r, p, s, x;
  bool interior;
};

// The same iteration with the band count fixed at D, streaming loads and
// stores, and two rows a loop step: a thread issues every load of its
// rows i and i + stride before the first multiply-add of either, then
// finishes row i, then row i + stride, so it takes its rows, and adds
// them into its gamma and delta partials, in dia_pipe_kernel's order.
template <typename V, typename B, bool SCALED, int D>
__global__ void __launch_bounds__(kThreads)
dia_pipe_fixed_kernel(const B* __restrict__ bands,
                      const V* __restrict__ scales,
                      const int64_t* __restrict__ offsets,
                      const V* __restrict__ alpha, const V* __restrict__ beta,
                      const V* __restrict__ w, V* __restrict__ w_out,
                      V* __restrict__ z, V* __restrict__ r,
                      V* __restrict__ p, V* __restrict__ s,
                      V* __restrict__ x, V* partials, unsigned* counter,
                      V* __restrict__ gd, int64_t n) {
  int64_t off[D];
  V sc[D];
  int64_t omin = 0, omax = 0;
  int center = -1;  // the band at offset 0: its w value is w[i]
#pragma unroll
  for (int d = 0; d < D; ++d) {
    off[d] = offsets[d];
    omin = off[d] < omin ? off[d] : omin;
    omax = off[d] > omax ? off[d] : omax;
    if (off[d] == 0) center = d;
    if constexpr (SCALED) sc[d] = scales[d];
    else sc[d] = V(1);
  }
  const V a = *alpha;
  const V b = *beta;
  V gsum = V(0), dsum = V(0);
  auto load = [&](PipeRow<V, B, D>& R, int64_t i) {
    R.z = __ldcs(z + i);
    R.r = __ldcs(r + i);
    R.p = __ldcs(p + i);
    R.s = __ldcs(s + i);
    R.x = __ldcs(x + i);
    R.interior = i + omin >= 0 && i + omax < n;
    if (R.interior) {
#pragma unroll
      for (int d = 0; d < D; ++d) R.bv[d] = __ldcs(bands + d * n + i);
#pragma unroll
      for (int d = 0; d < D; ++d) R.wv[d] = w[i + off[d]];
    }
  };
  auto finish = [&](PipeRow<V, B, D>& R, int64_t i) {
    V q, wi;
    if (R.interior) {
      q = acg::dia_row_interior<V, SCALED, D>(
          sc, D, [&](int d) { return R.bv[d]; },
          [&](int d) { return R.wv[d]; });
      wi = R.wv[0];
#pragma unroll
      for (int d = 1; d < D; ++d)
        if (d == center) wi = R.wv[d];
      if (center < 0) wi = w[i];
    } else {
      q = acg::dia_row<V, B, SCALED>(bands, scales, offsets, D, w, i, n);
      wi = w[i];
    }
    // the update after the branches, one copy of its arithmetic, as in
    // dia_pipe_kernel (a multiply-add in each branch could be contracted
    // differently)
    V zi = R.z, ri = R.r, pi = R.p, si = R.s, xi = R.x;
    acg::pipe_arith<V>(q, a, b, wi, zi, ri, pi, si, xi, gsum, dsum);
    __stcs(z + i, zi);
    __stcs(p + i, pi);
    __stcs(s + i, si);
    __stcs(x + i, xi);
    __stcs(r + i, ri);
    __stcs(w_out + i, wi);
  };
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += 2 * stride) {
    const int64_t j = i + stride;
    PipeRow<V, B, D> first, second;
    load(first, i);
    if (j < n) load(second, j);
    finish(first, i);
    if (j < n) finish(second, j);
  }
  acg::block_sum2_store<V, kThreads>(gsum, dsum, partials,
                                     partials + gridDim.x);
  acg::last_block_sum2<V, kThreads>(partials, counter, gd);
}

struct Args {
  const void* bands;
  const void* scales;
  const void* offsets;
  int64_t ndiags;
  const void* alpha;
  const void* beta;
  const void* w;
  void* w_out;
  void* z;
  void* r;
  void* p;
  void* s;
  void* x;
  int64_t n;
  void* partials;
  unsigned* counter;
  void* gd;
};

template <typename V, typename B, bool SCALED, int D>
void launch_fixed(const Args& g, unsigned grid, cudaStream_t st) {
  dia_pipe_fixed_kernel<V, B, SCALED, D><<<grid, kThreads, 0, st>>>(
      static_cast<const B*>(g.bands), static_cast<const V*>(g.scales),
      static_cast<const int64_t*>(g.offsets), static_cast<const V*>(g.alpha),
      static_cast<const V*>(g.beta), static_cast<const V*>(g.w),
      static_cast<V*>(g.w_out), static_cast<V*>(g.z), static_cast<V*>(g.r),
      static_cast<V*>(g.p), static_cast<V*>(g.s), static_cast<V*>(g.x),
      static_cast<V*>(g.partials), g.counter, static_cast<V*>(g.gd), g.n);
}

// One launch: the fixed kernel when asked for (a band count it is
// compiled for, else cudaErrorInvalidValue), the generic one otherwise.
template <typename V, typename B, bool SCALED>
int launch(const Args& g, bool fixed, unsigned grid, cudaStream_t st) {
  if (!fixed) {
    dia_pipe_kernel<V, B, SCALED><<<grid, kThreads, 0, st>>>(
        static_cast<const B*>(g.bands), static_cast<const V*>(g.scales),
        static_cast<const int64_t*>(g.offsets), g.ndiags,
        static_cast<const V*>(g.alpha), static_cast<const V*>(g.beta),
        static_cast<const V*>(g.w), static_cast<V*>(g.w_out),
        static_cast<V*>(g.z), static_cast<V*>(g.r), static_cast<V*>(g.p),
        static_cast<V*>(g.s), static_cast<V*>(g.x),
        static_cast<V*>(g.partials), g.counter, static_cast<V*>(g.gd), g.n);
  } else {
    switch (g.ndiags) {
      case 3: launch_fixed<V, B, SCALED, 3>(g, grid, st); break;
      case 5: launch_fixed<V, B, SCALED, 5>(g, grid, st); break;
      case 7: launch_fixed<V, B, SCALED, 7>(g, grid, st); break;
      case 27: launch_fixed<V, B, SCALED, 27>(g, grid, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int dispatch_band(int band_type, const Args& g, bool fixed, unsigned grid,
                  cudaStream_t st) {
  switch (band_type) {
    case 0: return launch<V, __nv_bfloat16, false>(g, fixed, grid, st);
    case 1: return launch<V, int8_t, true>(g, fixed, grid, st);
    case 2: return launch<V, float, false>(g, fixed, grid, st);
    case 3: return launch<V, double, false>(g, fixed, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  alpha, beta: device scalars at the vector
// type.  fixed: nonzero for the kernel with the band count fixed
// (ndiags 3, 5, 7 or 27 only, else cudaErrorInvalidValue).  partials:
// 2*nblocks scratch at the vector type; counter: one unsigned int in
// device memory, 0 before the launch and again after it (no two
// launches in flight may share it); gd_out: 2 values, gamma then delta.
// One launch.  Returns its CUDA error (0 on success).
extern "C" int acg_dia_pipe(const void* bands, int band_type,
                            const void* scales, const void* offsets,
                            int64_t ndiags, const void* alpha,
                            const void* beta, const void* w, void* w_out,
                            void* z, void* r, void* p, void* s, void* x,
                            int vec_type, int64_t n, int fixed,
                            void* partials, int64_t nblocks, void* counter,
                            void* gd_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args g{bands, scales, offsets, ndiags, alpha, beta,
               w, w_out, z, r, p, s, x, n, partials,
               static_cast<unsigned*>(counter), gd_out};
  const unsigned grid = static_cast<unsigned>(nblocks);
  if (vec_type == 2) return dispatch_band<float>(band_type, g, fixed != 0,
                                                 grid, st);
  if (vec_type == 3) return dispatch_band<double>(band_type, g, fixed != 0,
                                                  grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
