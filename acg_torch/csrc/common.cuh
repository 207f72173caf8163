// Shared pieces of the SpMV kernels: the launch geometry, the
// deterministic two-pass reduction behind the fused dots, the row
// bodies of the two operator tiers (DIA bands, matrix-free stencil),
// which the SpMV kernels and the pipelined-iteration kernels share, and
// the bulk-copy pipeline of the HBM-tier DIA kernels.
//
// The TPU kernels sum their per-tile partials in grid order into one
// scalar, because the TPU grid runs in order on one core.  On this card
// blocks run in any order, so each block writes its own partial and a
// second one-block kernel (or the last block of the same kernel,
// last_block_sum2) adds the partials in a fixed tree order.  There are
// no float atomics: the same inputs give the same bits on every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace acg {

constexpr int kThreads = 256;         // threads per SpMV block (a power of 2)
constexpr int kReduceThreads = 1024;  // threads of the partial-sum block
constexpr int kMaxArms = 32;          // stencil arms the kernels take

// Sum v over the block in a fixed tree order; thread 0 writes the total
// to out[blockIdx.x].  blockDim.x must equal N, a power of 2.
template <typename V, int N>
__device__ __forceinline__ void block_sum_store(V v, V* __restrict__ out) {
  __shared__ V buf[N];
  buf[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

// One block: out[0] = sum of partials[0..m), each thread striding over
// the partials in index order, then the fixed tree.
template <typename V>
__global__ void __launch_bounds__(kReduceThreads)
sum_partials_kernel(const V* __restrict__ partials, int64_t m,
                    V* __restrict__ out) {
  V v = V(0);
  for (int64_t k = threadIdx.x; k < m; k += kReduceThreads) v += partials[k];
  block_sum_store<V, kReduceThreads>(v, out);
}

// Launch the partial-sum pass after a dot-producing SpMV.
template <typename V>
inline cudaError_t launch_sum_partials(const void* partials, int64_t m,
                                       void* out, cudaStream_t s) {
  sum_partials_kernel<V><<<1, kReduceThreads, 0, s>>>(
      static_cast<const V*>(partials), m, static_cast<V*>(out));
  return cudaGetLastError();
}

// The B-way form of the multi-RHS kernels: the block's nsys per-system
// partials v[0..nsys) summed one system after another, each in the fixed
// tree of block_sum_store, through one shared buffer; thread 0 writes
// out[s * stride + blockIdx.x].  For each system this is exactly
// block_sum_store.  nsys is the same for every thread of the block, so
// the barriers inside the branch are reached by all of them.
template <typename V, int N, int NB>
__device__ __forceinline__ void block_sum_rows_store(const V (&v)[NB],
                                                     int nsys,
                                                     V* __restrict__ out,
                                                     int64_t stride) {
  __shared__ V buf[N];
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    if (s < nsys) {
      buf[threadIdx.x] = v[s];
      __syncthreads();
#pragma unroll
      for (int h = N / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
        __syncthreads();
      }
      if (threadIdx.x == 0) out[s * stride + blockIdx.x] = buf[0];
      __syncthreads();
    }
  }
}

// B blocks: block s writes out[s] = sum of partials[s*m .. s*m + m), in
// exactly the order of sum_partials_kernel (so a system's dot has the
// bits the one-system kernel gives it).
template <typename V>
__global__ void __launch_bounds__(kReduceThreads)
sum_partials_rows_kernel(const V* __restrict__ partials, int64_t m,
                         V* __restrict__ out) {
  const V* row = partials + static_cast<int64_t>(blockIdx.x) * m;
  V v = V(0);
  for (int64_t k = threadIdx.x; k < m; k += kReduceThreads) v += row[k];
  block_sum_store<V, kReduceThreads>(v, out);
}

template <typename V>
inline cudaError_t launch_sum_partials_rows(const void* partials, int64_t m,
                                            int64_t rows, void* out,
                                            cudaStream_t s) {
  sum_partials_rows_kernel<V><<<static_cast<unsigned>(rows), kReduceThreads,
                                0, s>>>(static_cast<const V*>(partials), m,
                                        static_cast<V*>(out));
  return cudaGetLastError();
}

// Systems per launch of a multi-RHS kernel: chunks of at most
// kMaxChunk systems, each run by the smallest template width NB in
// {1, 2, 4, 8} that holds it, so the per-system accumulators stay in
// registers.
constexpr int kMaxChunk = 8;

inline int chunk_width(int64_t nsys) {
  return nsys <= 1 ? 1 : nsys <= 2 ? 2 : nsys <= 4 ? 4 : 8;
}

// The two-scalar form (the pipelined iteration's gamma and delta): a
// and b summed over the block, both in the fixed tree of
// block_sum_store; the totals are left in a and b of thread 0 only.
template <typename V, int N>
__device__ __forceinline__ void block_sum2(V& a, V& b) {
  __shared__ V buf[2][N];
  buf[0][threadIdx.x] = a;
  buf[1][threadIdx.x] = b;
  __syncthreads();
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      buf[0][threadIdx.x] += buf[0][threadIdx.x + s];
      buf[1][threadIdx.x] += buf[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a = buf[0][0];
    b = buf[1][0];
  }
}

// block_sum2, then thread 0 writes out_a[blockIdx.x] and out_b[blockIdx.x].
template <typename V, int N>
__device__ __forceinline__ void block_sum2_store(V a, V b,
                                                 V* __restrict__ out_a,
                                                 V* __restrict__ out_b) {
  block_sum2<V, N>(a, b);
  if (threadIdx.x == 0) {
    out_a[blockIdx.x] = a;
    out_b[blockIdx.x] = b;
  }
}

// One block: out[0] = sum of partials[0..m), out[1] = sum of
// partials[m..2m), in one launch and one fixed order.
template <typename V>
__global__ void __launch_bounds__(kReduceThreads)
sum_partials2_kernel(const V* __restrict__ partials, int64_t m,
                     V* __restrict__ out) {
  V a = V(0), b = V(0);
  for (int64_t k = threadIdx.x; k < m; k += kReduceThreads) {
    a += partials[k];
    b += partials[m + k];
  }
  block_sum2_store<V, kReduceThreads>(a, b, out, out + 1);
}

template <typename V>
inline cudaError_t launch_sum_partials2(const void* partials, int64_t m,
                                        void* out, cudaStream_t s) {
  sum_partials2_kernel<V><<<1, kReduceThreads, 0, s>>>(
      static_cast<const V*>(partials), m, static_cast<V*>(out));
  return cudaGetLastError();
}

// The same two sums at the end of the kernel that wrote the partials,
// so that one launch does both passes: after block_sum2_store, every
// block takes a ticket from ``counter`` (an integer in device memory,
// 0 between launches) behind a __threadfence(), and the block that
// takes the last one sums partials[0..m) and partials[m..2m), m =
// gridDim.x, into out[0] and out[1] and sets the counter back to 0.
// Its N threads play the kReduceThreads threads of
// sum_partials2_kernel, kReduceThreads / N each: each such thread's
// strided sum, the tree's first levels in registers, then the rest of
// the tree in block_sum2.  Every addition has the operands and order it
// has there, so out holds sum_partials2_kernel's bits; no float atomics.
template <typename V, int N>
__device__ __forceinline__ void last_block_sum2(const V* partials,
                                                unsigned* counter,
                                                V* __restrict__ out) {
  static_assert(kReduceThreads % N == 0, "N must divide kReduceThreads");
  constexpr int W = kReduceThreads / N;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partials before its ticket
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const int64_t m = gridDim.x;
  V a[W], b[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    a[j] = V(0);
    b[j] = V(0);
    // thread threadIdx.x + j*N of sum_partials2_kernel; __ldcg reads the
    // other blocks' partials from the L2, not a stale L1 line
    for (int64_t k = threadIdx.x + j * N; k < m; k += kReduceThreads) {
      a[j] += __ldcg(partials + k);
      b[j] += __ldcg(partials + m + k);
    }
  }
  // the levels s = kReduceThreads/2 .. N of its tree: thread u = t + j*N
  // takes u + s = t + (j + h)*N for u < s, i.e. j < h
#pragma unroll
  for (int h = W / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
      a[j] += a[j + h];
      b[j] += b[j + h];
    }
  }
  block_sum2<V, N>(a[0], b[0]);
  if (threadIdx.x == 0) {
    out[0] = a[0];
    out[1] = b[0];
    *counter = 0u;
  }
}

// ---------------------------------------------------------------------------
// DIA rows: y[i] = sum_d band[d, i] * x[i + off[d]] over 0 <= i + off < n.
// Bands stay in their narrow storage (bf16, or an int8 0/1 mask with
// per-band scales) and are widened in registers; bands are summed in
// ascending-offset order, as on the TPU.

template <typename V>
__device__ __forceinline__ V band_value(__nv_bfloat16 b) {
  return static_cast<V>(__bfloat162float(b));
}
template <typename V>
__device__ __forceinline__ V band_value(int8_t b) {
  return static_cast<V>(b);
}
template <typename V>
__device__ __forceinline__ V band_value(float b) {
  return static_cast<V>(b);
}
template <typename V>
__device__ __forceinline__ V band_value(double b) {
  return static_cast<V>(b);
}

// The one DIA row body of row i, templated on where its operands come
// from: bat(d) returns band d's stored value at row i, xat(d, j)
// returns x[j] for band d (device memory, or copies of them staged in
// shared memory by the HBM kernels).  Every DIA kernel sums a row with
// this arithmetic, so a row has the same bits whichever kernel ran it.
template <typename V, bool SCALED, typename BAt, typename XAt>
__device__ __forceinline__ V dia_row_at(const V* __restrict__ scales,
                                        const int64_t* __restrict__ offsets,
                                        int64_t ndiags, int64_t i, int64_t n,
                                        BAt bat, XAt xat) {
  V acc = V(0);
  for (int64_t d = 0; d < ndiags; ++d) {
    const int64_t j = i + offsets[d];
    if (j >= 0 && j < n) {
      V b = band_value<V>(bat(d));
      if constexpr (SCALED) b *= scales[d];
      acc += b * xat(d, j);
    }
  }
  return acc;
}

// The same row where every band's column i + off[d] lies inside
// [0, n): the bounds test is left out and the arithmetic is
// dia_row_at's, so the row has the same bits.  The HBM kernels take it
// for the tiles where no band leaves the vector (all but the first and
// last few), with xat(d) giving x[i + off[d]].  With D > 0 the band
// count is D, fixed at compile time, and the loop is unrolled: a caller
// that loads the row's band and x values ahead of the sum into arrays
// (bat(d) returning bv[d], xat(d) xv[d]) keeps them, and the scales, in
// registers.
template <typename V, bool SCALED, int D = 0, typename BAt, typename XAt>
__device__ __forceinline__ V dia_row_interior(const V* __restrict__ scales,
                                              int ndiags, BAt bat,
                                              XAt xat) {
  V acc = V(0);
  auto term = [&](int d) {
    V b = band_value<V>(bat(d));
    if constexpr (SCALED) b *= scales[d];
    acc += b * xat(d);
  };
  if constexpr (D > 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) term(d);
  } else {
    for (int d = 0; d < ndiags; ++d) term(d);
  }
  return acc;
}

// The tiles [0, ntiles) of T rows whose every row i has i + off[d] in
// [0, n) for every band: full tiles far enough from both ends.  Returns
// the first and one past the last such tile (empty when a band lies
// wholly outside the vector).
__device__ __forceinline__ void interior_tiles(
    const int64_t* __restrict__ offsets, int64_t ndiags, int64_t n,
    int64_t tile, int64_t& first, int64_t& last) {
  int64_t omin = 0, omax = 0;
  bool live = true;
  for (int64_t d = 0; d < ndiags; ++d) {
    const int64_t o = offsets[d];
    omin = o < omin ? o : omin;
    omax = o > omax ? o : omax;
    live = live && o < n && -o < n;
  }
  first = (-omin + tile - 1) / tile;      // t * tile + omin >= 0
  last = (n - omax) / tile;               // (t + 1) * tile + omax <= n
  if (!live || last < first) first = last = 0;
}

template <typename V, typename B, bool SCALED>
__device__ __forceinline__ V dia_row(const B* __restrict__ bands,
                                     const V* __restrict__ scales,
                                     const int64_t* __restrict__ offsets,
                                     int64_t ndiags, const V* __restrict__ x,
                                     int64_t i, int64_t n) {
  return dia_row_at<V, SCALED>(
      scales, offsets, ndiags, i, n,
      [bands, i, n](int64_t d) { return bands[d * n + i]; },
      [x](int64_t, int64_t j) { return x[j]; });
}

// ---------------------------------------------------------------------------
// The HBM-tier DIA kernels' pipeline: 1-D bulk copies (the TMA's
// cp.async.bulk) from device memory into shared memory, their arrival
// counted on an mbarrier, and the full/empty mbarriers through which a
// producer warp and the consumer warps hand stages to each other.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (the bulk
// copies); then a __syncthreads() before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
// A wait that outlasts ~2^34 clocks (seconds) traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One 1-D bulk copy of ``bytes`` (a multiple of 16; both addresses
// 16-byte aligned) from device memory into shared memory, its arrival
// counted on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The same, the source's lines marked to leave the L2 first (``policy``
// from evict_first_policy).
__device__ __forceinline__ void bulk_load_once(void* dst, const void* src,
                                               unsigned bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// The contiguous run of tiles [t0, t1) that block b of a persistent grid
// of nb blocks walks (acg_torch/ops/dia_plan.py run_bounds).
__device__ __forceinline__ void run_bounds(int64_t ntiles, int64_t& t0,
                                           int64_t& t1) {
  const int64_t b = blockIdx.x, nb = gridDim.x;
  t0 = b * ntiles / nb;
  t1 = (b + 1) * ntiles / nb;
}

// The wave order of a persistent grid (acg_torch/ops/dia_plan.py
// wave_tiles): block b takes tiles b, b + nb, b + 2 nb, ..., so the
// blocks move through the vector together and a tile's far neighbours
// are streamed by other blocks within about one wave.  f(t) runs for
// each of the block's tiles in that order.
template <typename F>
__device__ __forceinline__ void wave_tiles(int64_t ntiles, F&& f) {
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) f(t);
}

// ---------------------------------------------------------------------------
// Stencil rows.  Mirrored field for field by the ctypes Structure in
// acg_torch/ops/stencil.py (_CStencil); passed by value as a kernel
// parameter, so it lives in the constant bank.

struct StencilArgs {
  int32_t narms;
  int32_t dims[3];              // grid, slowest axis first
  int32_t offsets[kMaxArms];    // flat offsets, ascending
  int32_t digits[kMaxArms][3];  // per-arm shift along each axis, in {-1,0,1}
  double coeffs[kMaxArms];
  // Read by the fixed-arm kernel of stencil_spmv.cu only:
  int32_t stride[3];  // the launch's grid stride as grid coordinates
  int32_t lo[3];      // the interior box: an element with lo[a] <= c_a <=
  int32_t hi[3];      // hi[a] on every axis has every arm inside the grid
};

// Row i < n of the stencil action: each band value is made in registers
// as coefficient x boundary test from the element's grid coordinates
// (32-bit: the wrappers admit npad < 2^31); arms in ascending flat-offset
// order, as on the TPU.
template <typename V>
__device__ __forceinline__ V stencil_row(const StencilArgs& a,
                                         const V* __restrict__ x, int e) {
  const int c2 = e % a.dims[2];
  const int r = e / a.dims[2];
  const int c1 = r % a.dims[1];
  const int c0 = r / a.dims[1];
  V acc = V(0);
  for (int k = 0; k < a.narms; ++k) {
    const int n0 = c0 + a.digits[k][0];
    const int n1 = c1 + a.digits[k][1];
    const int n2 = c2 + a.digits[k][2];
    if (n0 >= 0 && n0 < a.dims[0] && n1 >= 0 && n1 < a.dims[1] && n2 >= 0 &&
        n2 < a.dims[2])
      acc += static_cast<V>(a.coeffs[k]) * x[e + a.offsets[k]];
  }
  return acc;
}

// ---------------------------------------------------------------------------
// One element of the pipelined-CG iteration (Ghysels/Vanroose), given
// q = (A w)[i]:
//
//   z' = q + beta z;  p' = r + beta p;  s' = w + beta s
//   x' = x + alpha p';  r' = r - alpha s';  w' = w - alpha z'
//
// and this thread's share of gamma = <r', r'> and delta = <w', r'>.
// z, p, s, x and r are read and written at index i only, so they are
// updated in place; w is read at neighbour offsets by other threads'
// q = A w, so w' goes to a separate buffer.
//
// pipe_arith is the arithmetic on values already loaded (wi = w[i], ...;
// on return zi, pi, si, xi, ri and wi hold z', p', s', x', r', w' at i);
// pipe_update loads and stores around it.
template <typename V>
__device__ __forceinline__ void pipe_arith(V q, V alpha, V beta, V& wi,
                                           V& zi, V& ri, V& pi, V& si,
                                           V& xi, V& gsum, V& dsum) {
  const V z2 = q + beta * zi;
  const V p2 = ri + beta * pi;
  const V s2 = wi + beta * si;
  const V x2 = xi + alpha * p2;
  const V r2 = ri - alpha * s2;
  const V w2 = wi - alpha * z2;
  zi = z2;
  pi = p2;
  si = s2;
  xi = x2;
  ri = r2;
  wi = w2;
  gsum += r2 * r2;
  dsum += w2 * r2;
}

template <typename V>
__device__ __forceinline__ void pipe_update(
    int64_t i, V q, V alpha, V beta, const V* __restrict__ w,
    V* __restrict__ w_out, V* __restrict__ z, V* __restrict__ r,
    V* __restrict__ p, V* __restrict__ s, V* __restrict__ x, V& gsum,
    V& dsum) {
  V wi = w[i], zi = z[i], ri = r[i], pi = p[i], si = s[i], xi = x[i];
  pipe_arith<V>(q, alpha, beta, wi, zi, ri, pi, si, xi, gsum, dsum);
  z[i] = zi;
  p[i] = pi;
  s[i] = si;
  x[i] = xi;
  r[i] = ri;
  w_out[i] = wi;
}

}  // namespace acg
