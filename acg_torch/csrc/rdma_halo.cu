// Device-initiated halo exchange: every shard puts its message blocks
// straight into its partners' receive buffers and signals a flag there,
// then waits on its own flags, all inside one kernel.  Two forms, one
// kernel (HALO a template parameter):
//
//   halo:     recv[q][r][i] = x[p][pack[p][r, i]]        (q = partner[p, r])
//             ghost[p][unpack[p][r, i]] = recv[p][r][i]  (unpack >= 0)
//   exchange: out[p][r] = send[partner[p, r]][r]         (send[p][r] when -1)
//
// for the R message slots of S words (4 or 8 bytes) of the shards p on
// the launching device.  The halo gathers each send word from the
// shard's owned vector x through its pack map (the halo tables'
// send_full: the owned row of each slot position, pads at row 0), and
// writes each delivered word straight to its ghost through its unpack
// map (the inverse of ghost_src: each slot position's ghost, -1 for a
// pad); the exchange is the same kernel with identity pack and unpack,
// moving (R, S) blocks.  The edge colouring is symmetric, so slot r of
// a shard pairs with slot r of its partner.
//
// Replaces the TPU kernel acg_tpu/parallel/rdma_halo.py rdma_exchange
// (_rdma_kernel), whose slots go out as non-blocking remote DMAs to the
// partner chips and complete on receive semaphores: the TPU analog of
// the reference's NVSHMEM put+signal (acg/cg-kernels-cuda.cu:734-746,
// 876-887), with the gathers that XLA runs around it there
// (acg_tpu/parallel/rdma_halo.py halo_rdma) fused in.  Here the put is a
// store into the destination shard's buffer, found through a table of
// device pointers (with shards on several cards, peer-mapped addresses,
// after acg_rdma_enable_peer), and the signal is a release add on the
// destination's flag for that message; the receive side spins on its
// own flag with acquire loads.  Flags and epochs live in device memory
// and advance inside the kernel: nothing from the host says which
// exchange this is, so a replay of the same launch (a CUDA graph) stays
// correct.  The vectors a call reads and writes (x and the ghosts, or
// the send and output blocks) come by value in the launch's parameters
// (Launch), so a call copies nothing from the host to the device.
//
// Scope follows placement (SYS, fixed when the state is built from its
// device list): a launch whose shards' partners all live on its own
// card synchronises at GPU scope (one thread's fence.acq_rel.gpu after
// the block's barrier, red.release.gpu, ld.acquire.gpu); a launch with
// a partner on another card keeps system scope (every thread's
// __threadfence_system(), red.release.sys, ld.acquire.sys).
//
// Protocol of one message m = (slot r, chunk c) of shard p, epoch e (the
// exchanges this message has completed, kept on the device):
//   1. store the chunk into recv[dst][e % 2][r], dst = partner or p;
//   2. fence, so the stores are visible before the flag;
//   3. red.release.add(flags[dst][m], 1);
//   4. wait until flags[p][m] >= e + 1 (ld.acquire), then copy
//      recv[p][e % 2][r] (read through L2, which the remote stores
//      reached) to the ghosts (out[p][r]) and set epoch = e + 1.
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
// Bound on this card: bytes.  Per halo it must read the P·R·S send
// words from the owned vectors and the pack and unpack words once each,
// and write every ghost once (the exchange: read the send blocks and
// write the output blocks once); it does no arithmetic.  The put and
// the read-back of the receive buffer are the transport's own traffic,
// through the L2 on one card.  What the design does about it: a slot is
// cut into C chunks, one block each, sized (acg_torch/parallel/
// rdma_halo.py MIN_CHUNK) so that every SM holds several blocks; each
// thread keeps kU independent 16-byte groups of words in flight, stored
// with one 16-byte store each into the receive buffer (its rows padded
// to 16 bytes) and read back with 16-byte loads; and pack, put, signal,
// wait and unpack are one launch a device.
#include "common.cuh"

namespace {

using acg::kThreads;

constexpr int kU = 4;            // 16-byte groups a thread has in flight
constexpr int kMaxLocal = 64;    // shards one launch serves

struct Shard {
  void* recv;              // 2 x R x Sp words: the receive buffers
  uint32_t* flags;         // R x C arrival counts
  uint32_t* epoch;         // R x C completed exchanges
  uint32_t* err;           // 1 word: set when a wait timed out
  const int32_t* pack;     // R x S: owned row of each send word (halo)
  const int32_t* unpack;   // R x S: ghost of each slot position, -1 pad
};
static_assert(sizeof(Shard) == 48, "the wrapper packs 6 pointers a shard");

// The launch's by-value parameters: per local shard k its id and the
// vectors it reads and writes (halo: x and the ghosts; exchange: the
// (R, S) send and output blocks).
struct Launch {
  const void* src[kMaxLocal];
  void* dst[kMaxLocal];
  int32_t shard[kMaxLocal];
};

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool SYS>
__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  if constexpr (SYS)
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
  return v;
}

template <bool SYS>
__device__ __forceinline__ void add_release(uint32_t* p, uint32_t v) {
  if constexpr (SYS)
    asm volatile("red.release.sys.global.add.u32 [%0], %1;" ::"l"(p),
                 "r"(v)
                 : "memory");
  else
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p),
                 "r"(v)
                 : "memory");
}

__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

template <typename W>
union Group {                      // one 16-byte store or load
  uint4 v;
  W w[16 / sizeof(W)];
};

template <typename W, bool HALO, bool SYS>
__global__ void __launch_bounds__(kThreads)
rdma_kernel(const Shard* __restrict__ shards,
            const int32_t* __restrict__ partner, const Launch L, int R,
            int C, int64_t S, int64_t Sp, int64_t chunk,
            uint64_t timeout_ns) {
  constexpr int kVw = 16 / static_cast<int>(sizeof(W));
  const int k = blockIdx.x / (R * C);  // the local shard
  const int m = blockIdx.x % (R * C);  // this block's message
  const int p = L.shard[k];
  const int r = m / C;
  const int c = m % C;
  const int q = partner[p * R + r];
  const Shard me = shards[p];
  const Shard to = shards[q >= 0 ? q : p];
  // every thread reads the epoch itself (thread 0 advances it only after
  // the barrier every thread reaches after its put), so the put's loads
  // start without waiting for a barrier
  const uint32_t e = me.epoch[m];
  const int64_t par = e & 1u;
  const int64_t lo = c * chunk;        // a whole number of groups
  const int64_t hi = lo + chunk < S ? lo + chunk : S;
  const int64_t ngroups = (hi - lo) / kVw;
  const W* src = static_cast<const W*>(L.src[k]);
  const int32_t* pack = HALO ? me.pack + r * S : nullptr;
  auto word = [&](int64_t i) {         // send word i of slot r
    if constexpr (HALO) return src[pack[i]];
    else return src[r * S + i];
  };

  // 1. the put: 16-byte groups, then the slot's last words one by one
  W* dst = static_cast<W*>(to.recv) + (par * R + r) * Sp;
  uint4* dg = reinterpret_cast<uint4*>(dst + lo);
  for (int64_t g0 = threadIdx.x; g0 < ngroups; g0 += kThreads * kU) {
    Group<W> buf[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t g = g0 + u * kThreads;
      if (g < ngroups) {
#pragma unroll
        for (int v = 0; v < kVw; ++v) buf[u].w[v] = word(lo + g * kVw + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t g = g0 + u * kThreads;
      if (g < ngroups) dg[g] = buf[u].v;
    }
  }
  for (int64_t i = lo + ngroups * kVw + threadIdx.x; i < hi; i += kThreads)
    dst[i] = word(i);

  // the unpack map of this thread's first pass, read before the wait
  // (it does not depend on the partner's put)
  const int32_t* unpack = HALO ? me.unpack + r * S : nullptr;
  int32_t gi[kU][kVw];
  auto load_map = [&](int64_t g0) {
    if constexpr (HALO) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int64_t g = g0 + u * kThreads;
#pragma unroll
        for (int v = 0; v < kVw; ++v)
          gi[u][v] = g < ngroups ? unpack[lo + g * kVw + v] : -1;
      }
    }
  };
  load_map(threadIdx.x);

  // 2-4. fence, signal, wait
  if constexpr (SYS) __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    if constexpr (!SYS) fence_gpu();
    add_release<SYS>(to.flags + m, 1u);
    const uint32_t want = e + 1u;
    const uint64_t t0 = global_ns();
    bool late = false;
    while (static_cast<int32_t>(load_acquire<SYS>(me.flags + m) - want) <
           0) {
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

  // the unpack: the delivered chunk, through the L2, to the ghosts (the
  // output blocks)
  const W* got = static_cast<const W*>(me.recv) + (par * R + r) * Sp;
  const uint4* gg = reinterpret_cast<const uint4*>(got + lo);
  W* out = static_cast<W*>(L.dst[k]);
  for (int64_t g0 = threadIdx.x; g0 < ngroups; g0 += kThreads * kU) {
    if (g0 != threadIdx.x) load_map(g0);
    Group<W> buf[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t g = g0 + u * kThreads;
      if (g < ngroups) buf[u].v = __ldcg(gg + g);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t g = g0 + u * kThreads;
      if (g < ngroups) {
#pragma unroll
        for (int v = 0; v < kVw; ++v) {
          if constexpr (HALO) {
            if (gi[u][v] >= 0) out[gi[u][v]] = buf[u].w[v];
          } else {
            out[r * S + lo + g * kVw + v] = buf[u].w[v];
          }
        }
      }
    }
  }
  for (int64_t i = lo + ngroups * kVw + threadIdx.x; i < hi; i += kThreads) {
    const W w = __ldcg(got + i);
    if constexpr (HALO) {
      const int32_t gh = unpack[i];
      if (gh >= 0) out[gh] = w;
    } else {
      out[r * S + i] = w;
    }
  }
}

template <typename W, bool HALO, bool SYS>
int launch_one(const void* shards, const void* partner, const Launch& L,
               int nlocal, int R, int C, int64_t S, int64_t Sp,
               int64_t chunk, uint64_t timeout_ns, cudaStream_t s) {
  const Shard* sh = static_cast<const Shard*>(shards);
  const int32_t* pa = static_cast<const int32_t*>(partner);
  Launch l = L;
  void* args[] = {&sh, &pa, &l, &R, &C, &S, &Sp, &chunk, &timeout_ns};
  const dim3 grid(static_cast<unsigned>(nlocal) * R * C);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&rdma_kernel<W, HALO, SYS>), grid,
      dim3(kThreads), args, 0, s));
}

template <typename W>
int launch(const void* shards, const void* partner, const Launch& L,
           int nlocal, int halo, int sys, int R, int C, int64_t S,
           int64_t Sp, int64_t chunk, uint64_t timeout_ns, cudaStream_t s) {
  if (halo)
    return sys ? launch_one<W, true, true>(shards, partner, L, nlocal, R, C,
                                           S, Sp, chunk, timeout_ns, s)
               : launch_one<W, true, false>(shards, partner, L, nlocal, R,
                                            C, S, Sp, chunk, timeout_ns, s);
  return sys ? launch_one<W, false, true>(shards, partner, L, nlocal, R, C,
                                          S, Sp, chunk, timeout_ns, s)
             : launch_one<W, false, false>(shards, partner, L, nlocal, R, C,
                                           S, Sp, chunk, timeout_ns, s);
}

template <typename W>
cudaError_t per_sm(int* out) {
  int a = 0, b = 0, c = 0, d = 0;
  cudaError_t e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &a, rdma_kernel<W, true, true>, kThreads, 0)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &b, rdma_kernel<W, true, false>, kThreads, 0)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &c, rdma_kernel<W, false, true>, kThreads, 0)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &d, rdma_kernel<W, false, false>, kThreads, 0)) != cudaSuccess)
    return e;
  const int ab = a < b ? a : b, cd = c < d ? c : d;
  *out = ab < cd ? ab : cd;
  return cudaSuccess;
}

}  // namespace

// shards: P Shard records (device memory; pack and unpack may be NULL
// when halo is 0); partner: P x R (device int32, -1 none); local: the
// nlocal shard ids this launch serves and src, dst their vectors (host
// arrays, copied into the launch's parameters; nlocal <= 64).  halo: 1
// the fused halo (src the owned vectors, dst the ghost vectors), 0 the
// exchange (src the (R, S) send blocks, dst the (R, S) output blocks).
// sys: 1 when a partner lives on another card (system scope), else 0
// (GPU scope).  word: 4 or 8 bytes.  Sp: the receive buffers' row
// length (S rounded up to 16 bytes).  Each message is cut into C chunks
// of at most `chunk` words (a whole number of 16 bytes).  A wait gives
// up after `timeout_ns` and sets the shard's error word.  Returns the
// CUDA error of the launch (0 on success;
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident).
extern "C" int acg_rdma_exchange(const void* shards, const void* partner,
                                 int nlocal, const int32_t* local,
                                 const uint64_t* src, const uint64_t* dst,
                                 int halo, int sys, int R, int C, int64_t S,
                                 int64_t Sp, int64_t chunk, int word,
                                 uint64_t timeout_ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nlocal <= 0 || nlocal > kMaxLocal || R <= 0 || C <= 0 || S <= 0 ||
      chunk <= 0 || chunk * C < S || Sp < S || (Sp * word) % 16 != 0 ||
      (chunk * word) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch L{};
  for (int k = 0; k < nlocal; ++k) {
    L.shard[k] = local[k];
    L.src[k] = reinterpret_cast<const void*>(src[k]);
    L.dst[k] = reinterpret_cast<void*>(dst[k]);
  }
  if (word == 4)
    return launch<unsigned int>(shards, partner, L, nlocal, halo, sys, R, C,
                                S, Sp, chunk, timeout_ns, s);
  if (word == 8)
    return launch<unsigned long long>(shards, partner, L, nlocal, halo, sys,
                                      R, C, S, Sp, chunk, timeout_ns, s);
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

// The SMs of `device`, and how many rdma blocks of every form fit on one
// at once (the wrapper sizes C so the cooperative grid fits).
extern "C" int acg_rdma_capacity(int device, int word, int* sms,
                                 int* per_sm_out) {
  cudaError_t e =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = word == 8 ? per_sm<unsigned long long>(per_sm_out)
                  : per_sm<unsigned int>(per_sm_out);
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : back);
}
