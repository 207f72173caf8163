#!/usr/bin/env python3
"""The dependent latency of the scalar operations the coefficient kernels
chain, on one GPU.

    python scripts/torch_f64_latency.py [N]

Builds a small CUDA source (nvcc, into ``build/f64_latency/``) whose one
thread runs N (default 4096) dependent applications of one operation,
timed with ``clock64()`` inside the kernel, and prints one JSON line per
operation: SM cycles an operation, and nanoseconds at the SM clock that
``nvidia-smi`` reads just after (with the card's name and power limit).
The operations are the round-to-nearest intrinsics the kernels use:
``__dadd_rn``, ``__dmul_rn``, ``__fma_rn``, ``__ddiv_rn``,
``__dsqrt_rn``, ``log`` (as x = log(x) + 2), their f32 forms, and
``__shfl_sync`` of a double; and one round of ``sstep_coeffs``'
bisection tree at s = 4 (a Sturm count of three dependent divisions, a
ballot and two shuffles), as that kernel runs it.  It imports nothing of
JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ double add_(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float add_(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double mul_(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float mul_(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double fma_(double x, double y) { return __fma_rn(x, 0.5, y); }
__device__ __forceinline__ float fma_(float x, float y) { return __fmaf_rn(x, 0.5f, y); }
__device__ __forceinline__ double div_(double x, double y) { return __ddiv_rn(y, x); }
__device__ __forceinline__ float div_(float x, float y) { return __fdiv_rn(y, x); }
__device__ __forceinline__ double sqrt_(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float sqrt_(float x) { return __fsqrt_rn(x); }

template <int OP, typename T>
__device__ __forceinline__ T step(T x, T y) {
  if constexpr (OP == 0) return add_(x, y);
  if constexpr (OP == 1) return mul_(x, y);
  if constexpr (OP == 2) return fma_(x, y);
  if constexpr (OP == 3) return div_(x, y);
  if constexpr (OP == 4) return sqrt_(x);
  if constexpr (OP == 5) return add_(log(x), y);
  if constexpr (OP == 6) return add_(__shfl_sync(0xffffffffu, x, 0), y);
  return x;
}

template <int OP, typename T>
__global__ void chain(const T* in, T* out, long long* cycles, int n) {
  T x = in[0];
  const T y = in[1];
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = step<OP>(x, y);
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = x;
    cycles[0] = t1 - t0;
  }
}

// one bisection round of sstep_coeffs at s = 4, n times, as its warp runs
// it: each lane's node from the interval, a Sturm count, a ballot, the
// path and the two shuffles of the chosen node
__global__ void rounds(const double* in, double* out, long long* cycles,
                       int n) {
  const int lane = threadIdx.x & 31;
  const double d0 = in[0], d1 = in[1], d2 = in[2], d3 = in[3];
  const double e0 = in[4] * in[4], e1 = in[5] * in[5], e2 = in[6] * in[6];
  double a = in[7], c = in[8];
  const double pivmin = in[9];
  __syncwarp();
  const long long t0 = clock64();
  for (int r = 0; r < n; ++r) {
    double na = a, nc = c;
    bool up = false;
    if (lane < 31) {
      const int p = lane + 1;
      for (int bit = 30 - __clz(p); bit >= 0; --bit) {
        const double mid = __dmul_rn(__dadd_rn(na, nc), 0.5);
        if (p >> bit & 1) na = mid;
        else nc = mid;
      }
      const double x = __dmul_rn(__dadd_rn(na, nc), 0.5);
      double q = __dsub_rn(d0, x);
      if (fabs(q) < pivmin) q = -pivmin;
      int cnt = q <= 0.0;
      q = __dsub_rn(__dsub_rn(d1, x), __ddiv_rn(e0, q));
      if (fabs(q) < pivmin) q = -pivmin;
      cnt += q <= 0.0;
      q = __dsub_rn(__dsub_rn(d2, x), __ddiv_rn(e1, q));
      if (fabs(q) < pivmin) q = -pivmin;
      cnt += q <= 0.0;
      q = __dsub_rn(__dsub_rn(d3, x), __ddiv_rn(e2, q));
      if (fabs(q) < pivmin) q = -pivmin;
      cnt += q <= 0.0;
      up = cnt > 1;
    }
    const unsigned ups = __ballot_sync(0xffffffffu, up);
    int node = 0;
    for (int l = 1; l < 5; ++l) node = 2 * node + (ups >> node & 1 ? 1 : 2);
    const double pa = __shfl_sync(0xffffffffu, na, node);
    const double pc = __shfl_sync(0xffffffffu, nc, node);
    const double mid = __dmul_rn(__dadd_rn(pa, pc), 0.5);
    const bool keep = ups >> node & 1;
    a = keep ? pa : mid;
    c = keep ? mid : pc;
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = a + c;
    cycles[0] = t1 - t0;
  }
}

#define ACG_CHAIN(NAME, OP, T)                                            \
  extern "C" int NAME(const void* in, void* out, void* cyc, int n,       \
                      int threads) {                                     \
    chain<OP, T><<<1, threads>>>(static_cast<const T*>(in),              \
                                 static_cast<T*>(out),                   \
                                 static_cast<long long*>(cyc), n);       \
    return static_cast<int>(cudaGetLastError());                         \
  }
ACG_CHAIN(add64, 0, double) ACG_CHAIN(mul64, 1, double)
ACG_CHAIN(fma64, 2, double) ACG_CHAIN(div64, 3, double)
ACG_CHAIN(sqrt64, 4, double) ACG_CHAIN(log64, 5, double)
ACG_CHAIN(shfl64, 6, double)
ACG_CHAIN(add32, 0, float) ACG_CHAIN(mul32, 1, float)
ACG_CHAIN(fma32, 2, float) ACG_CHAIN(div32, 3, float)
ACG_CHAIN(sqrt32, 4, float) ACG_CHAIN(log32, 5, float)

extern "C" int round64(const void* in, void* out, void* cyc, int n,
                       int threads) {
  rounds<<<1, threads>>>(static_cast<const double*>(in),
                         static_cast<double*>(out),
                         static_cast<long long*>(cyc), n);
  return static_cast<int>(cudaGetLastError());
}
"""

# (entry point, operation, dtype, the two inputs, threads)
CASES = (("add64", "__dadd_rn", "float64", (1.0, 1e-300), 1),
         ("mul64", "__dmul_rn", "float64", (1.0, 1.0), 1),
         ("fma64", "__fma_rn", "float64", (1.0, 1.0), 1),
         ("div64", "__ddiv_rn", "float64", (1.3, 1.7), 1),
         ("sqrt64", "__dsqrt_rn", "float64", (1.7, 0.0), 1),
         ("log64", "log + add", "float64", (1.7, 2.0), 1),
         ("shfl64", "__shfl_sync + add", "float64", (1.0, 1e-300), 32),
         ("add32", "__fadd_rn", "float32", (1.0, 1e-30), 1),
         ("mul32", "__fmul_rn", "float32", (1.0, 1.0), 1),
         ("fma32", "__fmaf_rn", "float32", (1.0, 1.0), 1),
         ("div32", "__fdiv_rn", "float32", (1.3, 1.7), 1),
         ("sqrt32", "__fsqrt_rn", "float32", (1.7, 0.0), 1),
         ("log32", "logf + add", "float32", (1.7, 2.0), 1))


def _build():
    from acg_torch import _build as b

    out = REPO / "build" / "f64_latency"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "latency.cu", out / "liblatency.so"
    src.write_text(SOURCE)
    subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    n = int(argv[0]) if argv else 4096
    lib = _build()
    gpu = _smi("name,power.limit")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    cases = CASES + (("round64", "sstep_coeffs bisection round, s = 4",
                      "float64", (2.0, 3.0, 4.0, 5.0, 0.5, 0.6, 0.7, 0.0,
                                  8.0, 1e-300), 32),)
    for entry, op, dt, vals, threads in cases:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        x = torch.tensor(vals, dtype=getattr(torch, dt), device="cuda")
        out = torch.zeros(1, dtype=x.dtype, device="cuda")
        best = None
        for reps in (n // 8, n):               # warm, then the timed chain
            if fn(x.data_ptr(), out.data_ptr(), cyc.data_ptr(), reps,
                  threads) != 0:
                raise SystemExit(f"error: {entry} did not launch")
            torch.cuda.synchronize()
            best = int(cyc.item())
        clock = _smi("clocks.sm")
        mhz = float(clock.split()[0])
        per = best / n
        print(json.dumps({"op": op, "dtype": dt, "chain": n,
                          "threads": threads, "cycles_per_op": per,
                          "sm_clock": clock, "ns_per_op": per / mhz * 1e3,
                          "result": float(out.item()), "gpu": gpu}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
