// The classic-CG update with its reduction, in one pass:
//
//   x' = x + alpha p;   r' = r - alpha t;   rr = <r', r'>   [pp = <p, p>]
//
// for one system, or for B systems of a (B, n) block with a per-system
// alpha and per-system dots (grid row y = system y).
//
// Replaces no TPU kernel: in the JAX package XLA fused these three
// operations into the solver loop (acg_tpu/solvers/loops.py cg_while,
// `x + alpha p`, `r - alpha t`, `dot(r, r)`), so nothing was written in
// Pallas for them.  The port ran them as two torch addcmul_ passes and a
// torch.dot (five vector streams read, two written, plus the dot's
// re-read of r'); this kernel reads x, r, p and t once and writes x' and
// r' once.
//
// Bound on this card: bytes, 6 vector streams (4 read, 2 written) per
// system against 6 flops per element (8 with pp).  One thread per
// element in a grid-stride loop; the dot partials stay in registers.
// x' and r' round as torch's addcmul_ does on this card (measured: of
// 100,003 random elements at f32 and f64, every one equal this way,
// some 28,000 different the other): x + alpha p as one fused
// multiply-add (one rounding), r - alpha t with the product rounded and
// then the difference (the _rn intrinsics keep the compiler from
// contracting the two).  The dots
// sum in a new, fixed order: per-block partials in the tree of
// acg::block_sum2_store, then the last block to take a ticket sums them
// (acg::last_block_sum2, PR 16's epilogue) and sets the ticket counter
// back to 0; no float atomics, the same bits on every run.  Each system
// of a (B, n) call uses the block partition of a one-system call of the
// same n, so each system keeps the bits of its own solve.
#include "common.cuh"

namespace {

using acg::kThreads;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(V* __restrict__ x, V* __restrict__ r,
                 const V* __restrict__ p, const V* __restrict__ t,
                 const V* __restrict__ alpha, int64_t n, int want_pp,
                 V* __restrict__ partials, unsigned* __restrict__ counter,
                 V* __restrict__ out) {
  const int64_t sys = blockIdx.y;
  const int64_t off = sys * n;
  const V a = alpha[sys];
  V rr = V(0), pp = V(0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const V pi = p[off + i];
    const V xi = fma(pi, a, x[off + i]);
    const V ri = sub_rn(r[off + i], mul_rn(t[off + i], a));
    x[off + i] = xi;
    r[off + i] = ri;
    rr += ri * ri;
    if (want_pp) pp += pi * pi;
  }
  const int64_t m = gridDim.x;
  V* part = partials + sys * 2 * m;
  acg::block_sum2_store<V, kThreads>(rr, pp, part, part + m);
  acg::last_block_sum2<V, kThreads>(part, counter + sys, out + 2 * sys);
}

template <typename V>
int launch(void* x, void* r, const void* p, const void* t, const void* alpha,
           int64_t n, int64_t nsys, int want_pp, void* partials,
           int64_t nblocks, void* counter, void* out, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(nblocks),
                  static_cast<unsigned>(nsys));
  cg_update_kernel<V><<<grid, kThreads, 0, st>>>(
      static_cast<V*>(x), static_cast<V*>(r), static_cast<const V*>(p),
      static_cast<const V*>(t), static_cast<const V*>(alpha), n, want_pp,
      static_cast<V*>(partials), static_cast<unsigned*>(counter),
      static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r: (nsys, n) updated in place; p, t: (nsys, n); alpha: nsys device
// scalars at the vector type.  vec_type: 2 f32, 3 f64.  partials:
// 2*nsys*nblocks scratch at the vector type; counter: nsys unsigned
// words, 0 between launches (the kernel leaves them at 0); out: 2*nsys
// values, rr then pp for each system (pp 0 without want_pp).  Returns
// the CUDA error of the launch (0 on success).
extern "C" int acg_cg_update(void* x, void* r, const void* p, const void* t,
                             const void* alpha, int vec_type, int64_t n,
                             int64_t nsys, int want_pp, void* partials,
                             int64_t nblocks, void* counter, void* out,
                             void* stream) {
  if (n < 1 || nsys < 1 || nsys > 65535 || nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return launch<float>(x, r, p, t, alpha, n, nsys, want_pp, partials,
                         nblocks, counter, out, st);
  if (vec_type == 3)
    return launch<double>(x, r, p, t, alpha, n, nsys, want_pp, partials,
                          nblocks, counter, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
