// DIA SpMV with x streamed once through a shared-memory ring, with an
// optional fused <x, y>:
//
//   y[i] = sum_d band[d, i] * x[i + off[d]]      (0 <= i + off[d] < n)
//   dot  = sum_i x[i] * y[i]                      (with_dot: CG's p'Ap)
//
// Replaces the TPU kernel acg_tpu/ops/pallas_kernels.py
// dia_matvec_pallas_hbm2d_ring (_dia_hbm2d_ring_kernel): the path for x
// too large for the on-chip store, with the ring of consecutive x tiles
// that spans the whole offset reach and one new x tile per step.
//
// Bound on this card: bytes.  Per call the kernel must read D*n band
// values at their storage width, read x once and write y once; its
// 2*D*n flops are far below the card's rate on that traffic.  The TPU
// kernel walks the tiles in grid order with one VMEM ring; here the
// grid is persistent (as many blocks as fit the card at once, the plan
// in acg_torch/ops/dia_plan.py), and each block walks its own
// contiguous run of row tiles in order (acg::run_bounds), its ring
// sliding along the run: a block reads its run of x from device memory
// once, plus one span of overlap, and the D shifted reads of every row
// come from shared memory.
//
// What the design does about the bytes (the machinery of
// dia_hbm_windows.cu, common.cuh's pipeline helpers):
// - Producer and consumers.  Each block has one producer warp and eight
//   consumer warps.  The producer's one thread issues every copy as a
//   1-D bulk copy (the TMA's cp.async.bulk): one an x tile, one a band
//   tile, the bands marked evict-first in the L2.
// - The x ring.  A row tile t reads the x tiles t + lo .. t + hi (the
//   span); the ring holds span + stages - 1 tiles, so the producer can
//   fill ``stages`` row tiles ahead with every one's span resident.  x
//   tile j of the run goes into slot (j - first) mod slots; each slot
//   has a "full" mbarrier (expect_tx of the tile's bytes) and an "empty"
//   one, on which every consumer warp arrives when it has finished row
//   tile j - lo, the last row tile that reads x tile j.  The producer
//   refills a slot only after that.
// - The band tiles sit in ``stages`` buffers of their own on full/empty
//   mbarriers, released per warp the same way.
// - No block-wide barrier inside the loop: each consumer warp waits on
//   the full barriers of what its row tile reads, sums its rows from
//   shared memory, and arrives on the empty barriers; up to ``stages``
//   row tiles are in flight while the warps compute.
// - Tiles the bulk copies cannot take (an x tile of the span reaching
//   outside [0, n), the ragged last tile, x or band rows not 16-byte
//   aligned, a band wholly outside the vector) are summed by the
//   consumers straight from device memory with acg::dia_row, in their
//   turn of the run (before and after its bulk-copied middle), in place
//   of the TPU's zero halo.
// Rows are summed by the row bodies of dia_spmv (acg::dia_row_interior,
// its band count fixed at 5 for the 2-D five-point operators, and
// acg::dia_row), so y has dia_spmv's bits; the dot goes through
// per-block partials and the fixed one-block tree, so its bits depend
// on n and the plan alone.
#include "common.cuh"

namespace {

using acg::kThreads;

constexpr int kWarps = kThreads / 32;  // consumer warps
constexpr int kBlock = kThreads + 32;  // and one producer warp

// lo: the span's first x tile relative to the row tile; span: its x
// tiles; stages: row tiles in flight; bulk: x and the band rows are
// 16-byte aligned.  Dynamic shared memory: a head of the 2 x stages
// band mbarriers, the 2 x slots x-tile mbarriers and each band's offset
// from the start of the span (ndiags ints), rounded up to 128 bytes;
// the ring (slots x tile values of x); then ``stages`` buffers of the
// ndiags band tiles (ndiags x tile stored values, rounded up to 16
// bytes).  D > 0: the band count, fixed at compile time; 0: any.
template <typename V, typename B, bool SCALED, bool DOT, int D>
__global__ void __launch_bounds__(kBlock)
dia_ring_kernel(const B* __restrict__ bands, const V* __restrict__ scales,
                const int64_t* __restrict__ offsets, int64_t ndiags,
                const V* __restrict__ x, V* __restrict__ y,
                V* __restrict__ partials, int64_t n, int tile, int64_t lo,
                int span, int stages, int64_t ntiles, bool bulk) {
  extern __shared__ __align__(128) unsigned char acg_smem[];
  const int slots = span + stages - 1;
  uint64_t* bfull = reinterpret_cast<uint64_t*>(acg_smem);
  uint64_t* bempty = bfull + stages;
  uint64_t* xfull = bempty + stages;
  uint64_t* xempty = xfull + slots;
  int* rel = reinterpret_cast<int*>(xempty + slots);
  const int head = (16 * (stages + slots) + 4 * static_cast<int>(ndiags) +
                    127) / 128 * 128;
  V* ring = reinterpret_cast<V*>(acg_smem + head);
  const int ring_len = slots * tile;
  const int band_bytes =
      (static_cast<int>(ndiags) * tile * static_cast<int>(sizeof(B)) + 15) /
      16 * 16;
  unsigned char* bbuf = reinterpret_cast<unsigned char*>(ring + ring_len);
  auto stage_band = [&](int s) {
    return reinterpret_cast<B*>(bbuf + s * band_bytes);
  };
  // row r of a row tile reads band d's x at r + rel[d] past the start of
  // its span in the ring (bands wholly outside the vector: unused)
  for (int64_t d = threadIdx.x; d < ndiags; d += kBlock) {
    const int64_t o = offsets[d];
    rel[d] = (o < n && -o < n) ? static_cast<int>(o - lo * tile) : 0;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      acg::mbar_init(&bfull[s], 1);
      acg::mbar_init(&bempty[s], kWarps);
    }
    for (int s = 0; s < slots; ++s) {
      acg::mbar_init(&xfull[s], 1);
      acg::mbar_init(&xempty[s], kWarps);
    }
    acg::mbar_fence_init();
  }
  __syncthreads();

  // The block's run [t0, t1) and its bulk-copied middle [c0, c1): row
  // tiles that are whole, whose span lies inside [0, n) and whose rows
  // have every band inside the vector.
  int64_t t0, t1, in0, in1;
  acg::run_bounds(ntiles, t0, t1);
  acg::interior_tiles(offsets, ndiags, n, tile, in0, in1);
  const int64_t hi = lo + span - 1;
  int64_t c0 = -lo > in0 ? -lo : in0;
  int64_t c1 = n / tile - hi < in1 ? n / tile - hi : in1;
  c0 = c0 < t0 ? t0 : c0 > t1 ? t1 : c0;
  c1 = !bulk || c1 < c0 ? c0 : c1 > t1 ? t1 : c1;
  const int64_t npipe = c1 - c0;

  V dot = V(0);
  if (threadIdx.x >= kThreads) {
    // the producer: one thread issues every copy, in the run's order
    if (threadIdx.x == kThreads) {
      const uint64_t once = acg::evict_first_policy();
      const unsigned xbytes = static_cast<unsigned>(tile * sizeof(V));
      const unsigned bbytes = static_cast<unsigned>(tile * sizeof(B));
      const V* xrun = x + (c0 + lo) * tile;  // the run's first x tile
      // x tile k goes into slot xs = k mod slots in the phase xph =
      // (k / slots) mod 2 of its barriers, row tile i's bands into stage
      // bs = i mod stages, phase bph: counted, not divided, in the loop
      int64_t k = 0;                          // x tiles issued
      int xs = 0, bs = 0;
      unsigned xph = 0, bph = 0;
      for (int64_t i = 0; i < npipe; ++i) {
        for (; k < i + span; ++k) {           // row tile c0 + i's span
          if (k >= slots) acg::mbar_wait(&xempty[xs], xph ^ 1u);
          acg::mbar_expect_tx(&xfull[xs], xbytes);
          acg::bulk_load(ring + xs * tile, xrun + k * tile, xbytes,
                         &xfull[xs]);
          if (++xs == slots) {
            xs = 0;
            xph ^= 1u;
          }
        }
        if (i >= stages) acg::mbar_wait(&bempty[bs], bph ^ 1u);
        acg::mbar_expect_tx(&bfull[bs],
                            static_cast<unsigned>(ndiags) * bbytes);
        B* bt = stage_band(bs);
        const int64_t t = c0 + i;
        for (int64_t d = 0; d < ndiags; ++d)
          acg::bulk_load_once(bt + d * tile, bands + d * n + t * tile,
                              bbytes, &bfull[bs], once);
        if (++bs == stages) {
          bs = 0;
          bph ^= 1u;
        }
      }
    }
  } else {
    // the consumers
    auto direct = [&](int64_t t) {        // straight from device memory
      for (int r = threadIdx.x; r < tile; r += kThreads) {
        const int64_t row = t * tile + r;
        if (row >= n) break;
        const V acc = acg::dia_row<V, B, SCALED>(bands, scales, offsets,
                                                 ndiags, x, row, n);
        y[row] = acc;
        if constexpr (DOT) dot += x[row] * acc;
      }
    };
    for (int64_t t = t0; t < c0; ++t) direct(t);
    const int cx = static_cast<int>(-lo * tile);  // x[row] past the span
    constexpr int kD = D > 0 ? D : 1;
    int rl[kD];
    V sc[kD];
    if constexpr (D > 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        rl[d] = rel[d];
        if constexpr (SCALED) sc[d] = scales[d];
        else sc[d] = V(1);
      }
    }
    // as the producer's: the next x tile to wait for (kx) in slot ws,
    // phase wph; row tile i's bands in stage bs, phase bph; its span
    // starting at slot rs = i mod slots
    int64_t kx = 0;
    int ws = 0, bs = 0, rs = 0;
    unsigned wph = 0, bph = 0;
    for (int64_t i = 0; i < npipe; ++i) {
      for (; kx < i + span; ++kx) {
        acg::mbar_wait(&xfull[ws], wph);
        if (++ws == slots) {
          ws = 0;
          wph ^= 1u;
        }
      }
      acg::mbar_wait(&bfull[bs], bph);
      const B* bt = stage_band(bs);
      const int s0 = rs * tile;
      const int64_t base = (c0 + i) * tile;
      auto at = [&](int p) {               // ring position, wrapped once
        return ring[p >= ring_len ? p - ring_len : p];
      };
      if constexpr (D > 0) {
#pragma unroll 2
        for (int r = threadIdx.x; r < tile; r += kThreads) {
          B bv[D];
          V xv[D];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            bv[d] = bt[d * tile + r];
            xv[d] = at(s0 + rl[d] + r);
          }
          const V acc = acg::dia_row_interior<V, SCALED, D>(
              sc, D, [&](int d) { return bv[d]; },
              [&](int d) { return xv[d]; });
          y[base + r] = acc;
          if constexpr (DOT) dot += at(s0 + cx + r) * acc;
        }
      } else {
        const int nd = static_cast<int>(ndiags);
        for (int r = threadIdx.x; r < tile; r += kThreads) {
          const V acc = acg::dia_row_interior<V, SCALED>(
              scales, nd, [&](int d) { return bt[d * tile + r]; },
              [&](int d) { return at(s0 + rel[d] + r); });
          y[base + r] = acc;
          if constexpr (DOT) dot += at(s0 + cx + r) * acc;
        }
      }
      __syncwarp();     // the warp is done with band stage bs and x tile i
      if ((threadIdx.x & 31) == 0) {
        acg::mbar_arrive(&bempty[bs]);
        acg::mbar_arrive(&xempty[rs]);
      }
      if (++bs == stages) {
        bs = 0;
        bph ^= 1u;
      }
      if (++rs == slots) rs = 0;
    }
    for (int64_t t = c1; t < t1; ++t) direct(t);
  }
  if constexpr (DOT) {
    // block_sum_store's tree over the consumers; the producer warp only
    // takes part in the barriers
    __shared__ V red[kThreads];
    if (threadIdx.x < kThreads) red[threadIdx.x] = dot;
    __syncthreads();
#pragma unroll
    for (int h = kThreads / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
  }
}

template <typename V, typename B, bool SCALED, bool DOT, int D>
cudaError_t launch_kernel(const B* bp, const V* sp, const int64_t* op,
                          int64_t ndiags, const V* xp, V* yp, V* pp,
                          int64_t n, int tile, int64_t lo, int span,
                          int stages, int64_t ntiles, bool bulk, int smem,
                          unsigned grid, cudaStream_t s) {
  auto k = dia_ring_kernel<V, B, SCALED, DOT, D>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  k<<<grid, kBlock, smem, s>>>(bp, sp, op, ndiags, xp, yp, pp, n, tile, lo,
                               span, stages, ntiles, bulk);
  return cudaGetLastError();
}

template <typename V, typename B, bool SCALED, bool DOT>
cudaError_t launch_rows(const B* bp, const V* sp, const int64_t* op,
                        int64_t ndiags, const V* xp, V* yp, V* pp, int64_t n,
                        int tile, int64_t lo, int span, int stages,
                        int64_t ntiles, bool bulk, int smem, unsigned grid,
                        cudaStream_t s) {
  if (ndiags == 5)
    return launch_kernel<V, B, SCALED, DOT, 5>(bp, sp, op, ndiags, xp, yp,
                                               pp, n, tile, lo, span, stages,
                                               ntiles, bulk, smem, grid, s);
  return launch_kernel<V, B, SCALED, DOT, 0>(bp, sp, op, ndiags, xp, yp, pp,
                                             n, tile, lo, span, stages,
                                             ntiles, bulk, smem, grid, s);
}

template <typename V, typename B, bool SCALED>
int launch(const void* bands, const void* scales, const void* offsets,
           int64_t ndiags, const void* x, void* y, int64_t n, int tile,
           int64_t lo, int span, int stages, int64_t ntiles, int smem,
           int64_t nblocks, void* partials, void* dot_out, cudaStream_t s) {
  const B* bp = static_cast<const B*>(bands);
  const V* sp = static_cast<const V*>(scales);
  const int64_t* op = static_cast<const int64_t*>(offsets);
  const V* xp = static_cast<const V*>(x);
  V* yp = static_cast<V*>(y);
  const unsigned grid = static_cast<unsigned>(nblocks);
  // the bulk copies need x and every band row 16-byte aligned (a tile
  // is a whole number of 16-byte chunks of either)
  const bool bulk = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(bands) % 16 == 0 &&
                    (n * static_cast<int64_t>(sizeof(B))) % 16 == 0;
  if (dot_out == nullptr)
    return static_cast<int>(launch_rows<V, B, SCALED, false>(
        bp, sp, op, ndiags, xp, yp, nullptr, n, tile, lo, span, stages,
        ntiles, bulk, smem, grid, s));
  cudaError_t e = launch_rows<V, B, SCALED, true>(
      bp, sp, op, ndiags, xp, yp, static_cast<V*>(partials), n, tile, lo,
      span, stages, ntiles, bulk, smem, grid, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      acg::launch_sum_partials<V>(partials, nblocks, dot_out, s));
}

template <typename V>
int dispatch_band(int band_type, const void* bands, const void* scales,
                  const void* offsets, int64_t ndiags, const void* x,
                  void* y, int64_t n, int tile, int64_t lo, int span,
                  int stages, int64_t ntiles, int smem, int64_t nblocks,
                  void* partials, void* dot_out, cudaStream_t s) {
  switch (band_type) {
    case 0:
      return launch<V, __nv_bfloat16, false>(
          bands, scales, offsets, ndiags, x, y, n, tile, lo, span, stages,
          ntiles, smem, nblocks, partials, dot_out, s);
    case 1:
      return launch<V, int8_t, true>(bands, scales, offsets, ndiags, x, y, n,
                                     tile, lo, span, stages, ntiles, smem,
                                     nblocks, partials, dot_out, s);
    case 2:
      return launch<V, float, false>(bands, scales, offsets, ndiags, x, y, n,
                                     tile, lo, span, stages, ntiles, smem,
                                     nblocks, partials, dot_out, s);
    case 3:
      return launch<V, double, false>(bands, scales, offsets, ndiags, x, y,
                                      n, tile, lo, span, stages, ntiles,
                                      smem, nblocks, partials, dot_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// band_type: 0 bf16, 1 int8 mask (scales required), 2 f32, 3 f64.
// vec_type: 2 f32, 3 f64.  tile: rows per tile (a multiple of 16); lo:
// the span's first x tile relative to the row tile; span: its x tiles
// (hi - lo + 1); stages: row tiles in flight, 2, 3 or 4 (the depths the
// plan makes, acg_torch/ops/dia_plan.py RING_STAGES; any other is
// refused); smem: dynamic shared bytes (round128(16 * (stages + slots) +
// 4 * ndiags) + slots * tile * itemsize + stages * round16(ndiags * tile
// * band itemsize), slots = span + stages - 1, acg_torch/ops/dia_plan.py
// ring_bytes); nblocks: the persistent grid of 288-thread blocks.
// dot_out == NULL: no fused dot, else partials holds nblocks values.
// Returns the CUDA error of the launches (0 on success).
extern "C" int acg_dia_spmv_ring(const void* bands, int band_type,
                                 const void* scales, const void* offsets,
                                 int64_t ndiags, const void* x, void* y,
                                 int vec_type, int64_t n, int tile,
                                 int64_t lo, int span, int stages,
                                 int64_t ntiles, int smem, int64_t nblocks,
                                 void* partials, void* dot_out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages < 2 || stages > 4 || span < 1 || tile <= 0 || tile % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_type == 2)
    return dispatch_band<float>(band_type, bands, scales, offsets, ndiags, x,
                                y, n, tile, lo, span, stages, ntiles, smem,
                                nblocks, partials, dot_out, s);
  if (vec_type == 3)
    return dispatch_band<double>(band_type, bands, scales, offsets, ndiags,
                                 x, y, n, tile, lo, span, stages, ntiles,
                                 smem, nblocks, partials, dot_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
