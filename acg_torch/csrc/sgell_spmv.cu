// Segmented-gather ELL (sgell) SpMV:
//
//   y[t*1024 + s*128 + l] = sum over the slots k of tile t, in slot order,
//                           of vals[k, s, l] * x[seg[k, s]*128 + idx[k, s, l]]
//
// a tile with no entries giving 0 (its one slot holds zeros).
//
// Replaces the TPU kernel acg_tpu/ops/sgell.py sgell_matvec_pallas
// (_sgell_kernel).  On the TPU the grid walks the S slots in order and
// revisits each tile's (8, 128) output block, zeroing it on the tile's
// first slot.  Blocks on this card run in no order, so nothing may carry
// over between them: each tile gets its own block, which reads its slot
// range from tile_start (ntiles + 1 int32, made once on the host from
// `first`), sums every row in registers over its slots in slot order and
// writes it once.  There are no atomics, and each row is a product then a
// sum per slot (no fused multiply-add), as on the TPU: the result has the
// bits of the plain version sgell_matvec in acg_torch/ops/sgell.py.
//
// Bound on this card: bytes.  Per call it must read the S*1024 values (f32
// or bf16) and lane indices (int8: every lane index is below 128, a
// quarter of an int32 stream), the per-slot segment ids and the tile
// table, read x and write y once; it does 2 flops per slot entry.  The
// design keeps the streams coalesced: a slot's 1024 values and indices are
// contiguous and thread r of the tile reads entry r, so a warp reads 128
// (f32) and 32 (int8) contiguous bytes per slot; the 32 rows of a warp
// share one sublane and so one x segment, and their gathers fall inside
// those 512 bytes, read through the read-only cache.  256 threads cover
// the tile's 1024 rows, four rows each, so a thread has four independent
// load chains per slot, and the slot loop is unrolled so that the loads of
// several slots are in flight while their sums are still added in slot
// order: a tile walks its ~200 slots one after another, so the kernel is
// bound by memory latency before it is bound by bytes.  Staging the tile's
// segments in shared memory, and splitting long tiles, is later work.
#include "common.cuh"

namespace {

using acg::kThreads;

constexpr int kLanes = 128;
constexpr int kSubl = 8;
constexpr int kTile = kSubl * kLanes;
constexpr int kRows = kTile / kThreads;  // rows per thread
// slots whose loads overlap (62 registers at 4); scripts/torch_sgell_unroll.py
// builds and times other values
#ifndef ACG_SGELL_SLOT_UNROLL
#define ACG_SGELL_SLOT_UNROLL 4
#endif
constexpr int kSlotUnroll = ACG_SGELL_SLOT_UNROLL;
static_assert(kTile % kThreads == 0, "a tile must split evenly");

template <typename VAL>
__global__ void __launch_bounds__(kThreads)
sgell_spmv_kernel(const VAL* __restrict__ vals,
                  const int8_t* __restrict__ idx,
                  const int32_t* __restrict__ seg,
                  const int32_t* __restrict__ tile_start,
                  const float* __restrict__ x, float* __restrict__ y) {
  const int64_t t = blockIdx.x;
  const int32_t k0 = tile_start[t];
  const int32_t k1 = tile_start[t + 1];
  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
#pragma unroll kSlotUnroll
  for (int32_t k = k0; k < k1; ++k) {
    const int64_t base = static_cast<int64_t>(k) * kTile;
    const int32_t* segk = seg + static_cast<int64_t>(k) * kSubl;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = threadIdx.x + j * kThreads;
      const int64_t q = __ldg(segk + r / kLanes);
      const float v = acg::band_value<float>(vals[base + r]);
      const int lane = static_cast<int>(idx[base + r]);
      const float g = __ldg(x + q * kLanes + lane);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(v, g));
    }
  }
  float* yt = y + t * kTile;
#pragma unroll
  for (int j = 0; j < kRows; ++j) yt[threadIdx.x + j * kThreads] = acc[j];
}

template <typename VAL>
int launch(const void* vals, const void* idx, const void* seg,
           const void* tile_start, const void* x, void* y, int64_t ntiles,
           cudaStream_t s) {
  sgell_spmv_kernel<VAL><<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      static_cast<const VAL*>(vals), static_cast<const int8_t*>(idx),
      static_cast<const int32_t*>(seg),
      static_cast<const int32_t*>(tile_start), static_cast<const float*>(x),
      static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// val_type: 0 bf16, 2 f32.  Lane indices are int8, vectors f32.  ntiles
// blocks, one per 1024-row tile.  Returns the CUDA error of the launch (0
// on success).
extern "C" int acg_sgell_spmv(const void* vals, int val_type,
                              const void* idx, const void* seg,
                              const void* tile_start, const void* x,
                              void* y, int64_t ntiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ntiles <= 0 || ntiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (val_type == 0)
    return launch<__nv_bfloat16>(vals, idx, seg, tile_start, x, y, ntiles, s);
  if (val_type == 2)
    return launch<float>(vals, idx, seg, tile_start, x, y, ntiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
