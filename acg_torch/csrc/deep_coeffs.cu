// One depth-l pipelined CG body's scalar chain (p(l)-CG,
// Cornelis/Cools/Vanroose arXiv:1801.04728), for B systems, one thread
// a system, in one launch:
//
//   the banded basis change G shifted one place along its band, in
//   place; column c = t+1 by forward substitution from the l-old dot
//   block and its Cholesky diagonal with the SPD test; gamma_t and
//   delta_t through the shifts while t < l and the gamma/delta rings
//   after; the D-Lanczos lambda, zeta and dd, the commit, the breakdown
//   and guard flags and the exit estimate at check points; the residual
//   estimate, the committed-body count, the per-system counts and the
//   history sample at a device index; and the coefficients the body's
//   vector operations read (the column rolled onto the v ring, lambda,
//   zeta/dd, 1/g_cc, gamma_t, delta_{t-1}, 1/c).
//
// Replaces no TPU kernel: in the JAX package XLA compiles this chain
// into the deep pipeline's lax.while_loop (acg_tpu/solvers/loops.py:
// 1143-1224).  The port ran it as about a hundred torch launches a body
// from the host, which also kept the rings' heads and the history index
// on the host; this kernel is one launch, and a body is a fixed launch
// sequence that a CUDA graph can hold.
//
// Bound on this card: latency.  The chain is O(w^2) dependent scalar
// operations on w = 2l+1 values (a few dozen at l = 2); every system
// runs its chain on one thread of one block, and the counts shared by
// the systems (the committed bodies, the body index, the live bit) come
// from block-wide votes.  Every operation is written with the
// round-to-nearest intrinsics in the order of the plain version
// (ops/deep_coeffs.py, the torch chain), so nothing contracts into an
// FMA and the kernel gives the plain version's bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDepth = 8;
constexpr int kMaxW = 2 * kMaxDepth + 1;
constexpr int kNco = 5;
constexpr int kOK = 0, kBreakdown = 2, kFault = 3;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename V>
__global__ void __launch_bounds__(1024)
deep_coeffs_kernel(const V* __restrict__ D, V* __restrict__ G,
                   const V* __restrict__ shifts, V* __restrict__ gring,
                   V* __restrict__ dring, V* __restrict__ sc,
                   int* __restrict__ flag, bool* __restrict__ est,
                   int* __restrict__ kdev, int* __restrict__ ksys,
                   long long* __restrict__ kit, V* __restrict__ hist,
                   int64_t hstride, V* __restrict__ co,
                   bool* __restrict__ commit_out, bool* __restrict__ act_out,
                   bool* __restrict__ live, int* __restrict__ kmon, int nsys,
                   int l, int t, int hh, int hv, int at_check, int guard,
                   int any_crit, int batched) {
  const int b = threadIdx.x;
  const int w = 2 * l + 1;
  const long long k1 = *kit + 1;
  const int kd = *kdev;
  bool commit = false, lv = false;
  if (b < nsys) {
    const V* Db = D + b * w;
    V* Gb = G + static_cast<int64_t>(b) * w * w;
    // the ring shift: G[i][j] <- G[i+1][j+1] (ascending, so every read
    // precedes the write over it), the last row 0
    for (int i = 0; i < w - 1; ++i)
      for (int j = 0; j < w - 1; ++j) Gb[i * w + j] = Gb[(i + 1) * w + j + 1];
    for (int j = 0; j < w; ++j) Gb[(w - 1) * w + j] = V(0);
    // column c by forward substitution
    V col[kMaxW];
    for (int a = 0; a < w - 1; ++a) {
      V acc = Db[a];
      for (int k = 0; k < a; ++k)
        acc = sub_rn(acc, mul_rn(col[k], Gb[k * w + a]));
      const V gaa = Gb[a * w + a];
      col[a] = gaa != V(0) ? div_rn(acc, gaa) : V(0);
    }
    V gcc2 = Db[w - 1];
    for (int k = 0; k < w - 1; ++k) gcc2 = sub_rn(gcc2, mul_rn(col[k], col[k]));
    const bool good_g = gcc2 > V(0);
    const V gcc = sqrt_rn(gcc2 < V(0) ? V(0) : gcc2);
    for (int a = 0; a < w - 1; ++a) Gb[a * w + w - 1] = col[a];
    Gb[(w - 1) * w + w - 1] = gcc;
    // gamma_t, delta_t
    V base, mult;
    if (t < l) {
      base = shifts[b * l + t];
      mult = V(1);
    } else {
      base = gring[hh * nsys + b];
      mult = dring[hh * nsys + b];
    }
    const V d_tm1 = dring[((hh + l - 1) % l) * nsys + b];
    const V gii = Gb[(w - 2) * w + w - 2];
    const V gii_s = gii != V(0) ? gii : V(1);
    const V gam = add_rn(base, div_rn(sub_rn(mul_rn(col[w - 2], mult),
                                             mul_rn(d_tm1,
                                                    Gb[(w - 3) * w + w - 2])),
                                      gii_s));
    const V del = div_rn(mul_rn(gcc, mult), gii_s);
    const V gcc_s = gcc != V(0) ? gcc : V(1);
    // the D-Lanczos coefficients
    V* s5 = sc + b * 5;
    const V eta = s5[0], d_prev = s5[1], zeta_prev = s5[2], thr = s5[4];
    V lam, zeta;
    if (t == 0) {
      lam = V(0);
      zeta = eta;
    } else {
      lam = div_rn(d_tm1, d_prev != V(0) ? d_prev : V(1));
      zeta = mul_rn(-lam, zeta_prev);
    }
    const V dd = sub_rn(gam, mul_rn(d_tm1, lam));
    const V dd_s = dd != V(0) ? dd : V(1);
    const V zdd = div_rn(zeta, dd_s);
    const V rq = div_rn(mul_rn(del, zeta), dd_s);
    const V rr_new = mul_rn(rq, rq);
    const bool bad = dd <= V(0) || !good_g;
    int fl = flag[b];
    bool es = est[b];
    const bool active = fl == kOK && !es;
    commit = active && !bad;
    if (active && bad) fl = kBreakdown;
    if (guard && at_check && active &&
        !(isfinite(rr_new) && isfinite(gcc2)))
      fl = kFault;
    if (at_check)
      es = es || (commit && (rr_new < thr || (any_crit && rr_new == V(0))));
    V* hb = hist + static_cast<int64_t>(b) * hstride;
    if (batched) {
      hb[k1] = commit ? rr_new : V(NAN);
      if (commit) ksys[b] = static_cast<int>(k1);
    } else if (commit) {
      hb[k1] = rr_new;
    }
    const V c_s = del != V(0) ? del : V(1);
    V* cb = co + b * (w + kNco);
    for (int a = 0; a < w - 1; ++a) cb[(a + hv) % (w - 1)] = col[a];
    cb[w - 1] = lam;
    cb[w] = zdd;
    cb[w + 1] = div_rn(V(1), gcc_s);
    cb[w + 2] = gam;
    cb[w + 3] = d_tm1;
    cb[w + 4] = div_rn(V(1), c_s);
    if (commit) {
      s5[1] = dd;
      s5[2] = zeta;
      s5[3] = rr_new;
    }
    gring[hh * nsys + b] = gam;
    dring[hh * nsys + b] = del;
    flag[b] = fl;
    est[b] = es;
    commit_out[b] = commit;
    act_out[b] = active;
    lv = fl == kOK && !es;
  }
  const int any_commit = __syncthreads_or(commit);
  const int any_live = __syncthreads_or(lv);
  if (b == 0) {
    *kmon = kd + 1;
    *kdev = kd + (any_commit ? 1 : 0);
    *kit = k1;
    *live = any_live != 0;
  }
}

template <typename V>
int launch(const void* D, void* G, const void* shifts, void* gring,
           void* dring, void* sc, void* flag, void* est, void* kdev,
           void* ksys, void* kit, void* hist, void* co, int64_t hstride,
           void* commit, void* act, void* live, void* kmon, int nsys, int l,
           int t, int hh, int hv, int at_check, int guard, int any_crit,
           int batched, cudaStream_t st) {
  const int threads = (nsys + 31) / 32 * 32;
  deep_coeffs_kernel<V><<<1, threads, 0, st>>>(
      static_cast<const V*>(D), static_cast<V*>(G),
      static_cast<const V*>(shifts), static_cast<V*>(gring),
      static_cast<V*>(dring), static_cast<V*>(sc), static_cast<int*>(flag),
      static_cast<bool*>(est), static_cast<int*>(kdev),
      static_cast<int*>(ksys), static_cast<long long*>(kit),
      static_cast<V*>(hist), hstride, static_cast<V*>(co),
      static_cast<bool*>(commit), static_cast<bool*>(act),
      static_cast<bool*>(live), static_cast<int*>(kmon), nsys, l, t, hh, hv,
      at_check, guard, any_crit, batched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D: nsys x w, the dot block this body consumes (w = 2l+1); G: nsys x w
// x w; shifts: nsys x l; gring, dring: l x nsys rings, oldest at hh; sc:
// nsys x 5 (eta, d_prev, zeta_prev, the estimate, the threshold); flag:
// nsys int32; est: nsys bools; kdev: one int32; ksys: nsys int32 (batched
// only, else null); kit: one int64, the bodies run (the history index is
// kit + 1); hist: nsys rows of hstride; co: nsys x (w + 5); commit, act:
// nsys bools; live: one bool; kmon: one int32.  vec_type: 2 f32, 3 f64.
// t: the body's update index in its dispatch; hv: the v ring's head.
// Returns the CUDA error of the launch (0 on success).
extern "C" int acg_deep_coeffs(const void* D, void* G, const void* shifts,
                               void* gring, void* dring, void* sc, void* flag,
                               void* est, void* kdev, void* ksys, void* kit,
                               void* hist, void* co, int64_t hstride,
                               void* commit, void* act, void* live,
                               void* kmon, int vec_type, int nsys, int l,
                               int t, int hh, int hv, int at_check, int guard,
                               int any_crit, int batched, void* stream) {
  if (nsys < 1 || nsys > 1024 || l < 2 || l > kMaxDepth || hh < 0 ||
      hh >= l || hv < 0 || hv >= 2 * l || (batched && ksys == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return launch<float>(D, G, shifts, gring, dring, sc, flag, est, kdev,
                         ksys, kit, hist, co, hstride, commit, act, live,
                         kmon, nsys, l, t, hh, hv, at_check, guard, any_crit,
                         batched, st);
  if (vec_type == 3)
    return launch<double>(D, G, shifts, gring, dring, sc, flag, est, kdev,
                          ksys, kit, hist, co, hstride, commit, act, live,
                          kmon, nsys, l, t, hh, hv, at_check, guard,
                          any_crit, batched, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
