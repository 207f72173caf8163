// Shared pieces of the SpMV kernels: the launch geometry and the
// deterministic two-pass reduction behind the fused dot.
//
// The TPU kernels sum their per-tile <x, y> partials in grid order into
// one scalar, because the TPU grid runs in order on one core.  On this
// card blocks run in any order, so each block writes its own partial and
// a second one-block kernel adds the partials in a fixed tree order.
// There are no float atomics: the same inputs give the same bits on
// every run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace acg {

constexpr int kThreads = 256;         // threads per SpMV block (a power of 2)
constexpr int kReduceThreads = 1024;  // threads of the partial-sum block

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

}  // namespace acg
