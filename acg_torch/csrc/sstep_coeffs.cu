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
// scalar steps, and inside a graph a launch costs its node's gap plus
// that chain.  The block is one warp a system for the recurrences and
// min(s, 8) warps for the eigenvalues:
//   - the s inner steps run on warp 0 with __syncwarp between phases: G
//     (read from global memory once) and the coefficient vectors in
//     shared memory, the m rows of each G product on lanes, each
//     summing k = 0, 1, ... in order, the scalar decisions and the
//     sequential dots on lane 0, broadcast by shuffles;
//   - eigenvalue k by a speculative bisection tree on one warp: its 31
//     lanes take the 31 nodes of the next five levels of the halvings
//     thread k walked before (each node's interval from its ancestors'
//     midpoints, the same mul_rn(add_rn(a, c), 0.5)), count the Sturm
//     pivots at their midpoints, and a ballot picks the path: 64
//     halvings (f64) take 13 rounds of about one Sturm sequence, 40
//     (f32) 8, and the limit is the sequential halvings' own, bit for
//     bit;
//   - the Leja order: the block takes the s^2 log distances at once
//     (the sequential order took s - 1 rounds of logs one after
//     another), then on warp 0 lane i keeps the log sum of points i and
//     i + 32, adding the picked point's column, and each pick is a
//     shuffle argmax under torch's rules (the first maximum; a NaN above
//     everything).
// Every operation is written with the round-to-nearest intrinsics in
// the plain version's order (ops/sstep_coeffs.py), so the compiler
// contracts nothing into an FMA and the kernel gives the plain
// version's bits (the Leja order's logs are the library's).  The
// eigenvalues count pivots with LAPACK's pivmin rule
// (torch.linalg.eigvalsh reads its status on the host, which a graph
// capture cannot hold).  No atomics: each system writes its own row of
// the status, which the host reduces.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kLevels = 5;                 // bisection levels a round
constexpr unsigned kFull = 0xffffffffu;
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

// row i of the m x m matrix g times v, k = 0, 1, ..., each rounded
template <typename V>
__device__ __forceinline__ V row_dot(const V* g, const V* v, int m, int i) {
  const V* gi = g + i * m;
  V acc = mul_rn(gi[0], v[0]);
  for (int k = 1; k < m; ++k) acc = add_rn(acc, mul_rn(gi[k], v[k]));
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

// whether candidate (va, ia) goes before (vb, ib) in an argmax with
// torch's rules: a NaN above everything, then the larger value, then the
// first index; index -1 is no candidate.  A total order, so a warp's
// butterfly reduction picks what the sequential scan picked.
template <typename V>
__device__ __forceinline__ bool ranks_before(V va, int ia, V vb, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

// the warp's argmax over each lane's two candidates (index -1: none)
template <typename V>
__device__ __forceinline__ int warp_argmax(V v0, int i0, V v1, int i1) {
  V v = v0;
  int i = i0;
  if (ranks_before(v1, i1, v, i)) {
    v = v1;
    i = i1;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const V ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ranks_before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  return i;
}

// eigenvalue k of the tridiagonal (d, e) by ``halvings`` halvings of
// [a, c], the half kept that holds more than k eigenvalues at or below
// its top, kLevels halvings a round on one warp (the file's note); every
// lane returns it
template <typename V>
__device__ V bisect(const V* d, const V* e, int s, int k, V a, V c,
                    V pivmin, int halvings, int lane) {
  for (int h = 0; h < halvings; h += kLevels) {
    const int lev = min(kLevels, halvings - h);
    // lane n takes node n of the round's tree in heap order (0 the root,
    // 2n+1 and 2n+2 its lower and upper halves): the bits of n + 1
    // below the leading one are its path from the root
    V na = a, nc = c;
    bool up = false;
    if (lane < (1 << lev) - 1) {
      const int p = lane + 1;
      for (int bit = 30 - __clz(p); bit >= 0; --bit) {
        const V mid = mul_rn(add_rn(na, nc), V(0.5));
        if (p >> bit & 1) na = mid;
        else nc = mid;
      }
      up = sturm(d, e, s, mul_rn(add_rn(na, nc), V(0.5)), pivmin) > k;
    }
    const unsigned ups = __ballot_sync(kFull, up);
    int node = 0;
    for (int l = 1; l < lev; ++l) node = 2 * node + (ups >> node & 1 ? 1 : 2);
    const V pa = __shfl_sync(kFull, na, node);
    const V pc = __shfl_sync(kFull, nc, node);
    const V mid = mul_rn(add_rn(pa, pc), V(0.5));
    if (ups >> node & 1) {
      a = pa;
      c = mid;
    } else {
      a = mid;
      c = pc;
    }
  }
  return mul_rn(add_rn(a, c), V(0.5));
}

template <typename V>
__global__ void __launch_bounds__(32 * kMaxWarps)
sstep_coeffs_kernel(const V* __restrict__ G, V* __restrict__ shifts,
                    V* __restrict__ rr, const V* __restrict__ rr0,
                    const V* __restrict__ thresh2,
                    long long* __restrict__ kiter, int* __restrict__ flag,
                    V* __restrict__ hist, int64_t hstride,
                    V* __restrict__ coef, bool* __restrict__ changed,
                    double* __restrict__ status, int s, long long maxits,
                    int any_crit, V eps, int halvings) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
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
  __shared__ V sh_lo, sh_hi, sh_pivmin;
  __shared__ int sh_valid;

  if (warp == 0) {
    // lane 0's scalar state, its loads issued with G's
    V rr_j = V(0), floor_c = V(0), thr = V(0), rr0_b = V(0), rr_b = V(0);
    long long ki = 0, ki0 = 0;
    int fl = 0;
    bool active = false, conv_est = false, bad = false, allok = false;
    bool do_step = false, zerofrozen = false;
    if (lane == 0) {
      thr = thresh2[b];
      rr0_b = rr0[b];
      rr_b = rr[b];
      fl = flag[b];
      ki = kiter[b];
    }
    const V* Gb = G + static_cast<int64_t>(b) * m * m;
    bool fin = true;
    V gmax = V(0);
    for (int i = lane; i < m * m; i += 32) {
      const V g = Gb[i];
      sG[i] = g;
      fin = fin && isfinite(g);
      const V ag = fabs(g);
      if (ag > gmax) gmax = ag;
    }
    for (int i = lane; i < m; i += 32) {
      pc[i] = V(i == 0);
      rc[i] = V(i == s + 1);
      xc[i] = V(0);
      th[i] = i < s ? shifts[b * s + i]
            : (i > s && i < 2 * s) ? shifts[b * s + i - s - 1] : V(0);
    }
    const bool gfin = __all_sync(kFull, fin);
    for (int off = 16; off > 0; off >>= 1) {
      const V o = __shfl_xor_sync(kFull, gmax, off);
      if (o > gmax) gmax = o;
    }
    __syncwarp();

    V* hb = hist + static_cast<int64_t>(b) * hstride;
    if (lane == 0) {
      const V rrt = sG[(s + 1) * m + s + 1];
      const bool met_t = rrt < thr || (any_crit && rrt == V(0));
      const bool difn = gfin && !met_t && rrt > mul_rn(rr0_b, V(1e4));
      ki0 = ki;
      const bool active0 = fl == kOK;
      if (active0 && (!gfin || difn)) fl = kGramBad;
      else if (active0 && met_t) fl = kConverged;
      if (active0 && gfin) hb[ki] = rrt;
      status[3 * b + 1] = static_cast<double>(ki);
      status[3 * b + 2] = static_cast<double>(active0 ? rrt : rr_b);
      active = fl == kOK;
      allok = active;
      rr_j = rrt;
      floor_c = mul_rn(eps, gmax);
    }

    auto is_sub = [s](int i) {
      return (i >= 1 && i <= s) || (i >= s + 2 && i <= 2 * s);
    };
    for (int j = 0; j < s; ++j) {
      for (int i = lane; i < m; i += 32) {
        V v = mul_rn(th[i], pc[i]);
        if (is_sub(i)) v = add_rn(v, pc[i - 1]);
        w[i] = v;
      }
      __syncwarp();
      for (int i = lane; i < m; i += 32) tv[i] = row_dot(sG, w, m, i);
      __syncwarp();
      V alpha = V(0);
      if (lane == 0) {
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
        alpha = do_step ? div_rn(rr_j, denom) : V(0);
        al[j] = alpha;
      }
      alpha = __shfl_sync(kFull, alpha, 0);
      for (int i = lane; i < m; i += 32) {
        xc2[i] = add_rn(xc[i], mul_rn(alpha, pc[i]));
        rc2[i] = sub_rn(rc[i], mul_rn(alpha, w[i]));
      }
      __syncwarp();
      for (int i = lane; i < m; i += 32) tv[i] = row_dot(sG, rc2, m, i);
      __syncwarp();
      int commit = 0;
      V beta = V(0);
      if (lane == 0) {
        V rrn = seq_dot(rc2, tv, m);
        const V floor_r = mul_rn(floor_c, seq_dot(rc2, rc2, m));
        if (rrn < V(0) && fabs(rrn) <= floor_r) rrn = V(0);
        const bool ok2 = isfinite(rrn) && rrn >= V(0);
        bad = bad || (do_step && !ok2);
        commit = do_step && ok2;
        if (commit || zerofrozen) {
          ki += 1;
          hb[ki] = commit ? rrn : rr_j;
        }
        conv_est = conv_est ||
                   (commit && (rrn < thr || (any_crit && rrn == V(0))));
        beta = commit ? div_rn(rrn, rr_j == V(0) ? V(1) : rr_j) : V(0);
        be[j] = beta;
        allok = allok && commit;
        if (commit) rr_j = rrn;
      }
      commit = __shfl_sync(kFull, commit, 0);
      beta = __shfl_sync(kFull, beta, 0);
      if (commit)
        for (int i = lane; i < m; i += 32) {
          xc[i] = xc2[i];
          rc[i] = rc2[i];
          pc[i] = add_rn(rc2[i], mul_rn(beta, pc[i]));
        }
      __syncwarp();
    }
    V* cb = coef + static_cast<int64_t>(b) * 2 * m;
    for (int i = lane; i < m; i += 32) {
      cb[i] = xc[i];
      cb[m + i] = pc[i];
    }
    if (lane == 0) {
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
      sh_valid = valid;
      rr[b] = rr_j;
      kiter[b] = ki;
      flag[b] = fl;
      changed[b] = moved;
      status[3 * b + 0] = (fl == kOK && ki < maxits) ? 1.0 : 0.0;
    }
  }
  __syncthreads();
  for (int k = warp; k < s; k += nwarps) {
    const V e = bisect(dg, of, s, k, sh_lo, sh_hi, sh_pivmin, halvings,
                       lane);
    if (lane == 0) ev[k] = e;
  }
  __syncthreads();
  // the Leja order's log distances, every pair at once on the block (G's
  // shared memory is free by now): lg[i s + j] = log(|ev[i] - ev[j]| +
  // 1e-30), the term the order adds to point i when it picks point j
  V* lg = sG;
  for (int p = threadIdx.x; p < s * s; p += blockDim.x)
    lg[p] = log_of(add_rn(fabs(sub_rn(ev[p / s], ev[p % s])), V(1e-30)));
  __syncthreads();
  if (warp == 0) {
    // Leja order: the largest magnitude first, then the largest sum of
    // log distances to those chosen; lane i holds points i and i + 32
    const int i0 = lane < s ? lane : -1;
    const int i1 = lane + 32 < s ? lane + 32 : -1;
    const V e0 = i0 >= 0 ? ev[i0] : V(0);
    const V e1 = i1 >= 0 ? ev[i1] : V(0);
    int idx = warp_argmax(fabs(e0), i0, fabs(e1), i1);
    unsigned long long picked = 1ull << idx;
    // the order's point o, kept on lane o % 32
    V mine0 = lane == 0 ? ev[idx] : V(0), mine1 = V(0);
    V lp0 = V(0), lp1 = V(0);
    for (int o = 1; o < s; ++o) {
      if (i0 >= 0) lp0 = add_rn(lp0, lg[i0 * s + idx]);
      if (i1 >= 0) lp1 = add_rn(lp1, lg[i1 * s + idx]);
      idx = warp_argmax(lp0, i0 >= 0 && !(picked >> i0 & 1ull) ? i0 : -1,
                        lp1, i1 >= 0 && !(picked >> i1 & 1ull) ? i1 : -1);
      picked |= 1ull << idx;
      if (o == lane) mine0 = ev[idx];
      if (o == lane + 32) mine1 = ev[idx];
    }
    const bool ok0 = i0 < 0 || (isfinite(mine0) && mine0 > V(0));
    const bool ok1 = i1 < 0 || (isfinite(mine1) && mine1 > V(0));
    if (__all_sync(kFull, ok0 && ok1) && sh_valid) {
      if (i0 >= 0) shifts[b * s + i0] = mine0;
      if (i1 >= 0) shifts[b * s + i1] = mine1;
    }
  }
}

template <typename V>
int launch(const void* G, void* shifts, void* rr, const void* rr0,
           const void* thresh2, void* kiter, void* flag, void* hist,
           int64_t hstride, void* coef, void* changed, void* status,
           int nsys, int s, long long maxits,
           int any_crit, double eps, int halvings, int smem,
           cudaStream_t st) {
  const int threads = 32 * (s < kMaxWarps ? s : kMaxWarps);
  sstep_coeffs_kernel<V><<<nsys, threads, smem, st>>>(
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
// memory, (m^2 + 8 m + 5 s) values.  Returns the CUDA error of the
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
