// One s-step block's coefficient work, for B systems, one thread block a
// system:
//
//   the block boundary's true residual G[s+1][s+1], its divergence and
//   non-finite guards and the history sample at the system's cursor;
//   the s inner CG steps on the coefficient vectors (x, r, p in the
//   basis V), with the benign-floor pause and the indefinite test;
//   xc and pc for the combinations x += xc'V, p = pc'V;
//   the Lanczos tridiagonal of the block's (alpha, beta), its
//   eigenvalues by Sturm-sequence bisection, Leja-ordered, as the next
//   block's Newton shifts when they are valid;
//   and the system's row of the status the host reads (whether it can
//   go on, its count at the block's start, and its true |r|^2 there
//   while live, else its last recurred one).
//
// Replaces no TPU kernel: in the JAX package this is scalar work inside
// the s-step lax.while_loop (acg_tpu/solvers/loops.py:419-566), which
// XLA compiles into the loop; the port ran it in NumPy on the host, a
// copy of G down and of the coefficients up each block.  Here it stays
// on the card, so a block replays as one CUDA graph.
//
// Bound on this card: latency.  The work is O(s m^2) operations on
// m = 2s+1 coefficients (a few thousand at s = 4), a chain of dependent
// scalar steps.  G and every coefficient vector live in shared memory
// (sized by the runtime s); the m rows of each G product run on m
// threads, each summing j = 0, 1, ... in order, and the scalar decisions
// on thread 0.  Every operation is written with the round-to-nearest
// intrinsics in the plain version's order (ops/sstep_coeffs.py), so the
// compiler contracts nothing into an FMA and the kernel gives the plain
// version's bits (the Leja order's logs are the library's).  The
// eigenvalues: thread k bisects the Gershgorin interval a fixed number
// of times for eigenvalue k, counting pivots with LAPACK's pivmin rule
// (torch.linalg.eigvalsh reads its status on the host, which a graph
// capture cannot hold).  No atomics: each system writes its own row of
// the status, which the host reduces.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kOK = 0, kConverged = 1, kGramBad = 4;

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
__device__ __forceinline__ float log_of(float a) { return logf(a); }
__device__ __forceinline__ double log_of(double a) { return log(a); }

template <typename V> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float tiny() { return 1.17549435e-38f; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double tiny() {
    return 2.2250738585072014e-308;
  }
};

// sum_i a[i] b[i], i = 0, 1, ..., each product and sum rounded
template <typename V>
__device__ __forceinline__ V seq_dot(const V* a, const V* b, int m) {
  V acc = mul_rn(a[0], b[0]);
  for (int i = 1; i < m; ++i) acc = add_rn(acc, mul_rn(a[i], b[i]));
  return acc;
}

// the LDL' pivots' count of eigenvalues at or below x (LAPACK's pivmin)
template <typename V>
__device__ __forceinline__ int sturm(const V* d, const V* e, int s, V x,
                                     V pivmin) {
  V q = sub_rn(d[0], x);
  if (fabs(q) < pivmin) q = -pivmin;
  int cnt = q <= V(0);
  for (int i = 1; i < s; ++i) {
    const V ee = mul_rn(e[i - 1], e[i - 1]);
    q = sub_rn(sub_rn(d[i], x), div_rn(ee, q));
    if (fabs(q) < pivmin) q = -pivmin;
    cnt += q <= V(0);
  }
  return cnt;
}

// argmax with torch's rules: the first maximum, a NaN above everything
template <typename V>
__device__ __forceinline__ bool beats(V v, V best) {
  return (isnan(v) && !isnan(best)) || v > best;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
sstep_coeffs_kernel(const V* __restrict__ G, V* __restrict__ shifts,
                    V* __restrict__ rr, const V* __restrict__ rr0,
                    const V* __restrict__ thresh2,
                    long long* __restrict__ kiter, int* __restrict__ flag,
                    V* __restrict__ hist, int64_t hstride,
                    V* __restrict__ coef, bool* __restrict__ changed,
                    double* __restrict__ status, int s, long long maxits,
                    int any_crit, V eps, int halvings) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = 2 * s + 1;
  extern __shared__ unsigned char smem_raw[];
  V* sG = reinterpret_cast<V*>(smem_raw);
  V* pc = sG + m * m;
  V* rc = pc + m;
  V* xc = rc + m;
  V* w = xc + m;
  V* tv = w + m;
  V* xc2 = tv + m;
  V* rc2 = xc2 + m;
  V* th = rc2 + m;
  V* al = th + m;
  V* be = al + s;
  V* dg = be + s;
  V* of = dg + s;
  V* ev = of + s;
  V* lp = ev + s;
  V* nw = lp + s;
  __shared__ V part[kThreads];
  __shared__ V sh_alpha, sh_beta, sh_lo, sh_hi, sh_pivmin;
  __shared__ int sh_commit;

  const V* Gb = G + static_cast<int64_t>(b) * m * m;
  bool fin = true;
  V gm = V(0);
  for (int i = tid; i < m * m; i += kThreads) {
    const V g = Gb[i];
    sG[i] = g;
    fin = fin && isfinite(g);
    const V ag = fabs(g);
    if (ag > gm) gm = ag;
  }
  part[tid] = gm;
  for (int i = tid; i < m; i += kThreads) {
    pc[i] = V(i == 0);
    rc[i] = V(i == s + 1);
    xc[i] = V(0);
    th[i] = i < s ? shifts[b * s + i]
          : (i > s && i < 2 * s) ? shifts[b * s + i - s - 1] : V(0);
  }
  const int gfin = __syncthreads_and(fin);

  // thread 0's scalar state
  V gmax = V(0), rr_j = V(0), floor_c = V(0), thr = V(0);
  long long ki = 0, ki0 = 0;
  int fl = 0;
  bool active = false, conv_est = false, bad = false, allok = false;
  bool do_step = false, zerofrozen = false;
  V* hb = hist + static_cast<int64_t>(b) * hstride;
  if (tid == 0) {
    for (int i = 0; i < kThreads; ++i)
      if (part[i] > gmax) gmax = part[i];
    thr = thresh2[b];
    const V rrt = sG[(s + 1) * m + s + 1];
    const bool met_t = rrt < thr || (any_crit && rrt == V(0));
    const bool difn = gfin && !met_t && rrt > mul_rn(rr0[b], V(1e4));
    fl = flag[b];
    ki = kiter[b];
    ki0 = ki;
    const bool active0 = fl == kOK;
    if (active0 && (!gfin || difn)) fl = kGramBad;
    else if (active0 && met_t) fl = kConverged;
    if (active0 && gfin) hb[ki] = rrt;
    status[3 * b + 1] = static_cast<double>(ki);
    status[3 * b + 2] = static_cast<double>(active0 ? rrt : rr[b]);
    active = fl == kOK;
    allok = active;
    rr_j = rrt;
    floor_c = mul_rn(eps, gmax);
  }

  auto is_sub = [s](int i) {
    return (i >= 1 && i <= s) || (i >= s + 2 && i <= 2 * s);
  };
  for (int j = 0; j < s; ++j) {
    __syncthreads();
    for (int i = tid; i < m; i += kThreads) {
      V v = mul_rn(th[i], pc[i]);
      if (is_sub(i)) v = add_rn(v, pc[i - 1]);
      w[i] = v;
    }
    __syncthreads();
    for (int i = tid; i < m; i += kThreads) {
      const V* gi = sG + i * m;
      V acc = mul_rn(gi[0], w[0]);
      for (int k = 1; k < m; ++k) acc = add_rn(acc, mul_rn(gi[k], w[k]));
      tv[i] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      const V denom = seq_dot(pc, tv, m);
      const bool step = active && !bad && !conv_est && ki < maxits;
      zerofrozen = step && rr_j == V(0);
      const bool attempt = step && rr_j > V(0);
      const V floor_p = mul_rn(floor_c, seq_dot(pc, pc, m));
      const bool benign = attempt && denom <= V(0) && isfinite(denom) &&
                          fabs(denom) <= floor_p;
      conv_est = conv_est || benign;
      const bool indef = attempt && !benign &&
                         (denom <= V(0) || !isfinite(denom));
      bad = bad || indef;
      do_step = attempt && !indef && !benign;
      const V alpha = do_step ? div_rn(rr_j, denom) : V(0);
      al[j] = alpha;
      sh_alpha = alpha;
    }
    __syncthreads();
    const V alpha = sh_alpha;
    for (int i = tid; i < m; i += kThreads) {
      xc2[i] = add_rn(xc[i], mul_rn(alpha, pc[i]));
      rc2[i] = sub_rn(rc[i], mul_rn(alpha, w[i]));
    }
    __syncthreads();
    for (int i = tid; i < m; i += kThreads) {
      const V* gi = sG + i * m;
      V acc = mul_rn(gi[0], rc2[0]);
      for (int k = 1; k < m; ++k) acc = add_rn(acc, mul_rn(gi[k], rc2[k]));
      tv[i] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      V rrn = seq_dot(rc2, tv, m);
      const V floor_r = mul_rn(floor_c, seq_dot(rc2, rc2, m));
      if (rrn < V(0) && fabs(rrn) <= floor_r) rrn = V(0);
      const bool ok2 = isfinite(rrn) && rrn >= V(0);
      bad = bad || (do_step && !ok2);
      const bool commit = do_step && ok2;
      if (commit || zerofrozen) {
        ki += 1;
        hb[ki] = commit ? rrn : rr_j;
      }
      conv_est = conv_est ||
                 (commit && (rrn < thr || (any_crit && rrn == V(0))));
      const V beta = commit ? div_rn(rrn, rr_j == V(0) ? V(1) : rr_j) : V(0);
      be[j] = beta;
      allok = allok && commit;
      if (commit) rr_j = rrn;
      sh_commit = commit;
      sh_beta = beta;
    }
    __syncthreads();
    if (sh_commit) {
      const V beta = sh_beta;
      for (int i = tid; i < m; i += kThreads) {
        xc[i] = xc2[i];
        rc[i] = rc2[i];
        pc[i] = add_rn(rc2[i], mul_rn(beta, pc[i]));
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    const bool moved = ki > ki0;
    const bool stalled = active && !moved && ki < maxits;
    if (active && (bad || stalled)) fl = kGramBad;
    // the Lanczos tridiagonal of the block's (alpha, beta)
    for (int i = 0; i < s; ++i) {
      const V a_safe = al[i] > V(0) ? al[i] : V(1);
      dg[i] = div_rn(V(1), a_safe);
    }
    for (int i = 1; i < s; ++i) {
      const V a_safe = al[i - 1] > V(0) ? al[i - 1] : V(1);
      dg[i] = add_rn(dg[i], div_rn(be[i - 1], a_safe));
    }
    bool valid = allok;
    for (int i = 0; i < s - 1; ++i) {
      const V a_safe = al[i] > V(0) ? al[i] : V(1);
      const V bt = be[i] < V(0) ? V(0) : be[i];
      of[i] = div_rn(sqrt_rn(bt), a_safe);
      valid = valid && isfinite(of[i]);
    }
    for (int i = 0; i < s; ++i) valid = valid && isfinite(dg[i]);
    if (!valid) {
      for (int i = 0; i < s; ++i) dg[i] = V(1);
      for (int i = 0; i < s - 1; ++i) of[i] = V(0);
    }
    // Gershgorin interval, widened, and the pivot floor
    V lo = V(0), hi = V(0), maxee = V(0);
    for (int i = 0; i < s; ++i) {
      const V left = i > 0 ? fabs(of[i - 1]) : V(0);
      const V right = i < s - 1 ? fabs(of[i]) : V(0);
      const V r = add_rn(left, right);
      const V l_i = sub_rn(dg[i], r), h_i = add_rn(dg[i], r);
      if (i == 0 || l_i < lo) lo = l_i;
      if (i == 0 || h_i > hi) hi = h_i;
    }
    for (int i = 0; i < s - 1; ++i) {
      const V ee = mul_rn(of[i], of[i]);
      if (ee > maxee) maxee = ee;
    }
    const V pivmin = mul_rn(Lim<V>::tiny(), maxee > V(1) ? maxee : V(1));
    const V tnorm = fabs(lo) > fabs(hi) ? fabs(lo) : fabs(hi);
    const V fudge = V(2) * V(s) * (eps / V(4 * m));  // 2 s eps, exact
    const V pad = add_rn(mul_rn(tnorm, fudge), mul_rn(pivmin, V(2)));
    sh_lo = sub_rn(lo, pad);
    sh_hi = add_rn(hi, pad);
    sh_pivmin = pivmin;
    rr[b] = rr_j;
    kiter[b] = ki;
    flag[b] = fl;
    changed[b] = moved;
    status[3 * b + 0] = (fl == kOK && ki < maxits) ? 1.0 : 0.0;
    sh_commit = valid;
  }
  __syncthreads();
  V* cb = coef + static_cast<int64_t>(b) * 2 * m;
  for (int i = tid; i < m; i += kThreads) {
    cb[i] = xc[i];
    cb[m + i] = pc[i];
  }
  for (int k = tid; k < s; k += kThreads) {
    V a = sh_lo, c = sh_hi;
    for (int h = 0; h < halvings; ++h) {
      const V mid = mul_rn(add_rn(a, c), V(0.5));
      if (sturm(dg, of, s, mid, sh_pivmin) > k) c = mid;
      else a = mid;
    }
    ev[k] = mul_rn(add_rn(a, c), V(0.5));
  }
  __syncthreads();
  if (tid == 0) {
    // Leja order: the largest magnitude first, then the largest sum of
    // log distances to those chosen
    const V tiny = V(1e-30);
    int idx = 0;
    for (int i = 1; i < s; ++i)
      if (beats(fabs(ev[i]), fabs(ev[idx]))) idx = i;
    unsigned long long picked = 1ull << idx;
    nw[0] = ev[idx];
    for (int i = 0; i < s; ++i) lp[i] = V(0);
    for (int o = 1; o < s; ++o) {
      const V last = nw[o - 1];
      for (int i = 0; i < s; ++i)
        lp[i] = add_rn(lp[i], log_of(add_rn(fabs(sub_rn(ev[i], last)), tiny)));
      int best = -1;
      for (int i = 0; i < s; ++i) {
        if (picked >> i & 1ull) continue;
        if (best < 0 || beats(lp[i], lp[best])) best = i;
      }
      picked |= 1ull << best;
      nw[o] = ev[best];
    }
    bool good = sh_commit;
    for (int i = 0; i < s; ++i) good = good && isfinite(nw[i]) && nw[i] > V(0);
    if (good)
      for (int i = 0; i < s; ++i) shifts[b * s + i] = nw[i];
  }
}

template <typename V>
int launch(const void* G, void* shifts, void* rr, const void* rr0,
           const void* thresh2, void* kiter, void* flag, void* hist,
           int64_t hstride, void* coef, void* changed, void* status,
           int nsys, int s, long long maxits,
           int any_crit, double eps, int halvings, int smem,
           cudaStream_t st) {
  sstep_coeffs_kernel<V><<<nsys, kThreads, smem, st>>>(
      static_cast<const V*>(G), static_cast<V*>(shifts), static_cast<V*>(rr),
      static_cast<const V*>(rr0), static_cast<const V*>(thresh2),
      static_cast<long long*>(kiter), static_cast<int*>(flag),
      static_cast<V*>(hist), hstride, static_cast<V*>(coef),
      static_cast<bool*>(changed), static_cast<double*>(status), s, maxits,
      any_crit, static_cast<V>(eps), halvings);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G: nsys (2s+1)^2 Gram matrices; shifts: nsys x s; rr, rr0, thresh2:
// nsys; kiter: nsys int64; flag: nsys int32; hist: nsys rows of hstride;
// coef: nsys x 2 x (2s+1); changed: nsys bools; status: nsys x 3
// doubles.  vec_type: 2 f32, 3 f64.  eps:
// 4 (2s+1) times the dtype's machine epsilon.  smem: the dynamic shared
// memory, (m^2 + 8 m + 7 s) values.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int acg_sstep_coeffs(const void* G, void* shifts, void* rr,
                                const void* rr0, const void* thresh2,
                                void* kiter, void* flag, void* hist,
                                int64_t hstride, void* coef, void* changed,
                                void* status, int vec_type, int nsys, int s,
                                int64_t maxits, int any_crit, double eps,
                                int halvings, int smem, void* stream) {
  if (nsys < 1 || nsys > 65535 || s < 1 || s > 64 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_type == 2)
    return launch<float>(G, shifts, rr, rr0, thresh2, kiter, flag, hist,
                         hstride, coef, changed, status,
                         nsys, s, maxits, any_crit, eps, halvings, smem, st);
  if (vec_type == 3)
    return launch<double>(G, shifts, rr, rr0, thresh2, kiter, flag, hist,
                          hstride, coef, changed, status,
                          nsys, s, maxits, any_crit, eps, halvings, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
