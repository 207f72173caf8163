// Device-initiated halo exchange: every shard puts its message blocks
// straight into its partners' receive buffers and signals a flag there,
// then waits on its own flags, all inside one kernel:
//
//   out[p][r] = send[partner[p, r]][r]    (send[p][r] when partner is -1)
//
// for the (R, S) message blocks of the shards p on the launching device,
// in 4- or 8-byte words.  The edge colouring is symmetric, so slot r of
// a shard pairs with slot r of its partner.
//
// Replaces the TPU kernel acg_tpu/parallel/rdma_halo.py rdma_exchange
// (_rdma_kernel), whose slots go out as non-blocking remote DMAs to the
// partner chips and complete on receive semaphores: the TPU analog of
// the reference's NVSHMEM put+signal (acg/cg-kernels-cuda.cu:734-746,
// 876-887).  Here the put is a store into the destination shard's
// buffer, found through a table of device pointers (with shards on
// several cards, peer-mapped addresses, after acg_rdma_enable_peer), and
// the signal is a release add on the destination's flag for that
// message; the receive side spins on its own flag with acquire loads.
// Flags and epochs live in device memory and advance inside the kernel:
// nothing from the host says which exchange this is, so a replay of the
// same launch (a CUDA graph) stays correct.
//
// Protocol of one message m = (slot r, chunk c) of shard p, epoch e (the
// exchanges this message has completed, kept on the device):
//   1. store the chunk into recv[dst][e % 2][r], dst = partner or p;
//   2. __threadfence_system(), so the stores are visible before the flag;
//   3. red.release.sys.add(flags[dst][m], 1);
//   4. wait until flags[p][m] >= e + 1 (ld.acquire.sys), then copy
//      recv[p][e % 2][r] (read through L2, which the remote stores
//      reached) into out[p][r] and set epoch = e + 1.
// Two receive buffers alternate by parity.  A shard can run at most one
// exchange ahead of its partner, because step 4 of exchange k + 1 waits
// for the partner's put of exchange k + 1, which the partner issues only
// after its own exchange k has ended (stream order).  So the exchange
// k + 1 put lands in the other parity while the partner may still be
// reading exchange k, and exchange k + 2 reuses a buffer whose reads
// have ended.  In the solver an allreduce also lies between any two
// exchanges and orders them again.
//
// Co-residency: blocks wait on other blocks' puts, so every block of the
// grid must be resident at once.  The launch is cooperative
// (cudaLaunchCooperativeKernel), which refuses a grid that cannot be
// co-resident instead of hanging; the wrapper raises on that error.
//
// No wait is unbounded.  With shards on several cards the wrapper makes
// one launch per card; if a later launch fails, the grids already
// running wait for puts that never come.  So a wait gives up after
// `timeout_ns` of the card's global timer: the block then sets its
// shard's error word, leaves its epoch as it was and ends.  The wrapper
// reads the error words after a solve (one small read) and raises; the
// state is spoilt from then on.
//
// Bound on this card: bytes.  Per call it must read the P·R·S send words
// and write the P·R·S output words once (plus 8 bytes of flag and epoch
// a message); it does no arithmetic.  The put and the read-back of the
// receive buffer are the transport's own traffic, through the L2 on one
// card.  A slot is cut into C chunks, one block each, so the copy runs
// on P·R·C SMs instead of P·R.
#include "common.cuh"

namespace {

using acg::kThreads;

struct Shard {
  void* recv;          // 2 x R x S words: the receive buffers, by parity
  uint32_t* flags;     // R x C arrival counts
  const void* send;    // R x S words
  void* out;           // R x S words
  uint32_t* epoch;     // R x C completed exchanges
  uint32_t* err;       // 1 word: set when a wait timed out
};
static_assert(sizeof(Shard) == 48, "the wrapper packs 6 pointers a shard");

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(uint32_t* p, uint32_t v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
rdma_kernel(const Shard* __restrict__ shards,
            const int32_t* __restrict__ local,
            const int32_t* __restrict__ partner, int R, int C, int64_t S,
            int64_t chunk, uint64_t timeout_ns) {
  const int m = blockIdx.x % (R * C);  // this block's message
  const int p = local[blockIdx.x / (R * C)];
  const int r = m / C;
  const int c = m % C;
  const int q = partner[p * R + r];
  const Shard me = shards[p];
  const Shard to = shards[q >= 0 ? q : p];
  __shared__ uint32_t s_epoch;
  if (threadIdx.x == 0) s_epoch = me.epoch[m];
  __syncthreads();
  const uint32_t e = s_epoch;
  const int64_t par = e & 1u;
  const int64_t lo = c * chunk;
  const int64_t hi = lo + chunk < S ? lo + chunk : S;
  const W* src = static_cast<const W*>(me.send) + r * S;
  W* dst = static_cast<W*>(to.recv) + (par * R + r) * S;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) dst[i] = src[i];
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    add_release(to.flags + m, 1u);
    const uint32_t want = e + 1u;
    const uint64_t t0 = global_ns();
    bool late = false;
    while (static_cast<int32_t>(load_acquire(me.flags + m) - want) < 0) {
      if (global_ns() - t0 > timeout_ns) {
        late = true;
        break;
      }
      __nanosleep(64);
    }
    __threadfence();
    if (late)
      atomicExch(me.err, 1u);
    else
      me.epoch[m] = want;
  }
  __syncthreads();
  const W* got = static_cast<const W*>(me.recv) + (par * R + r) * S;
  W* out = static_cast<W*>(me.out) + r * S;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
    out[i] = __ldcg(got + i);
}

template <typename W>
int launch(const void* shards, const void* local, int nlocal,
           const void* partner, int R, int C, int64_t S, int64_t chunk,
           uint64_t timeout_ns, cudaStream_t s) {
  const Shard* sh = static_cast<const Shard*>(shards);
  const int32_t* lo = static_cast<const int32_t*>(local);
  const int32_t* pa = static_cast<const int32_t*>(partner);
  void* args[] = {&sh, &lo, &pa, &R, &C, &S, &chunk, &timeout_ns};
  const dim3 grid(static_cast<unsigned>(nlocal) * R * C);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&rdma_kernel<W>), grid, dim3(kThreads),
      args, 0, s));
}

}  // namespace

// shards: P Shard records (device memory); local: the nlocal shard ids
// this launch serves (device int32); partner: P x R (device int32, -1
// none).  word: 4 or 8 bytes.  Each message is cut into C chunks of at
// most `chunk` words.  A wait gives up after `timeout_ns` and sets the
// shard's error word.  Returns the CUDA error of the launch (0 on
// success; cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident).
extern "C" int acg_rdma_exchange(const void* shards, const void* local,
                                 int nlocal, const void* partner, int R,
                                 int C, int64_t S, int64_t chunk, int word,
                                 uint64_t timeout_ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nlocal <= 0 || R <= 0 || C <= 0 || S <= 0 || chunk <= 0 ||
      chunk * C < S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (word == 4)
    return launch<unsigned int>(shards, local, nlocal, partner, R, C, S,
                                chunk, timeout_ns, s);
  if (word == 8)
    return launch<unsigned long long>(shards, local, nlocal, partner, R, C,
                                      S, chunk, timeout_ns, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Let kernels on `device` address the memory of `peer` (the put into a
// shard on another card).  Returns the CUDA error (0 on success or when
// already enabled; cudaErrorPeerAccessUnsupported when the pair has no
// peer path).  Leaves the current device as it found it.
extern "C" int acg_rdma_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // "already enabled" is success: clear it
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : back);
}

// The SMs of `device`, and how many rdma blocks fit on one at once (the
// wrapper sizes C so the cooperative grid fits).
extern "C" int acg_rdma_capacity(int device, int word, int* sms,
                                 int* per_sm) {
  cudaError_t e =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = word == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        per_sm, rdma_kernel<unsigned long long>, kThreads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        per_sm, rdma_kernel<unsigned int>, kThreads, 0);
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : back);
}
