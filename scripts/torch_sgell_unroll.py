"""Time the sgell SpMV kernel (acg_torch/csrc/sgell_spmv.cu) at several
slot unrolls on an NVIDIA GPU.

The kernel's slot loop is unrolled ACG_SGELL_SLOT_UNROLL times (4 unless
the macro is set), so that the loads of several slots are in flight while
their sums are still added in slot order.  This script compiles one library
per unroll, all at once, and times each on the f32 operator that
``fmt="auto"`` builds for ``fem_delaunay_spd(points, dim=3, seed=0)`` (RCM,
then the sgell pack), with CUDA events, median of 25, over interleaved
rounds.  Every unroll must give the bits of the plain version.

Prints the card's name and power limit, one JSON line per (round, unroll)
and a summary line.  Imports nothing of JAX.

Run on the card: python scripts/torch_sgell_unroll.py [points] [unroll ...]
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from acg_torch import _build  # noqa: E402
from acg_torch.ops import sgell  # noqa: E402
from acg_torch.solvers.cg import build_device_operator  # noqa: E402
from acg_torch.sparse.mesh import fem_delaunay_spd  # noqa: E402

ROUNDS = 2
REPS = 25


def _time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[REPS // 2]


def build_variants(unrolls, out_dir: Path) -> dict:
    """{unroll: (library path, registers)}: one nvcc per unroll, started
    together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for u in unrolls:
        out = out_dir / f"libsgell_spmv_u{u}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-DACG_SGELL_SLOT_UNROLL={u}",
               "-o", str(out), str(_build.CSRC / "sgell_spmv.cu")]
        procs[u] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    built = {}
    for u, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"error: nvcc for unroll {u} failed:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        built[u] = (out, max(regs) if regs else None)
    return built


def use_library(path: Path) -> None:
    """Route sgell.sgell_spmv through the library at ``path``."""
    import ctypes

    sgell._lib = None
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(path))
    try:
        sgell._load()
    finally:
        _build.load = load


def main():
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device")
    points = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    unrolls = [int(u) for u in sys.argv[2:]] or [1, 2, 4, 8]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else
          "nvidia-smi: not available", flush=True)
    t0 = time.perf_counter()
    A = fem_delaunay_spd(points, dim=3, seed=0)
    op = build_device_operator(A, dtype=np.float32, device="cuda")
    dev = getattr(op, "dev", op)
    if not isinstance(dev, sgell.DeviceSgell):
        raise SystemExit(f"error: auto built {type(dev).__name__}, not sgell")
    setup = time.perf_counter() - t0
    nslots = np.diff(dev.tile_start.cpu().numpy())
    x = torch.zeros(dev.nrows_padded, dtype=torch.float32)
    x[:dev.nrows] = torch.from_numpy(
        np.random.default_rng(5).standard_normal(dev.nrows))
    x = x.cuda()
    plain = sgell.sgell_matvec(dev.vals, dev.idx, dev.seg, dev.tile_start, x)
    print(json.dumps({"points": points, "setup_s": setup, "S": dev.S,
                      "ntiles": dev.ntiles, "fill": dev.fill,
                      "slots_per_tile_mean": float(nslots.mean()),
                      "slots_per_tile_max": int(nslots.max())}), flush=True)
    built = build_variants(unrolls, Path(_build.BUILD_DIR) / "unroll")

    def run():
        return sgell.sgell_spmv(dev.vals, dev.idx, dev.seg, dev.tile_start, x)

    times = {u: [] for u in unrolls}
    for rnd in range(ROUNDS):
        for u in unrolls:
            use_library(built[u][0])
            same = bool(torch.equal(run(), plain))
            ms = _time_ms(run)
            times[u].append(ms)
            print(json.dumps({"round": rnd, "unroll": u, "ms": ms,
                              "registers": built[u][1],
                              "bits_equal_plain": same}), flush=True)
            if not same:
                raise SystemExit(f"error: unroll {u} differs from plain")
    best = min(unrolls, key=lambda u: min(times[u]))
    print(json.dumps({"best_unroll": best,
                      "ms": {u: min(t) for u, t in times.items()}}))


if __name__ == "__main__":
    main()
