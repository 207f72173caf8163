"""Time the HBM-tier DIA kernels (acg_torch/csrc/dia_hbm_ring.cu,
acg_torch/csrc/dia_hbm_windows.cu) at every tile their plan could take,
beside dia_spmv on the same operator, on an NVIDIA GPU.

For each configuration (the 464^3 and 256^3 7-point Poisson operators
and the 10,000^2 5-point one, bf16 bands with f32 vectors, and f64
vectors) and each kernel and tile of ``acg_torch.ops.dia_plan.TILES``
whose shared memory fits one block of this card, the kernel with the
fused dot is timed with CUDA events (median of 25) in interleaved
rounds, its y checked bit-equal to ``dia_spmv``'s, and the tile the plan
picks is marked.  The bound is the bytes one call must move (bands at
their storage width, x read and y written once) over the data sheet's
3.35 TB/s.

Prints the card's name and power limit, one JSON line per (round,
configuration, kernel, tile) and a summary line.  Imports nothing of JAX.

Run on the card: python scripts/torch_hbm_tiles.py [config ...]
(configs: p3d-464-f32 p3d-464-f64 p3d-256-f32 p2d-10k-f32 p2d-10k-f64)
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from acg_torch.ops import dia_plan  # noqa: E402
from acg_torch.ops.dia import DeviceDia  # noqa: E402
from acg_torch.ops.dia_kernels import (dia_spmv, dia_spmv_ring,  # noqa: E402
                                       dia_spmv_windows)
from acg_torch.sparse.poisson import poisson3d_7pt_dia  # noqa: E402
from chip_smoke import _poisson2d_dia  # noqa: E402

ROUNDS = 2
REPS = 25
MEM_BW = 3.35e12          # H100 SXM data sheet, bytes/s


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


CONFIGS = {
    "p3d-464-f32": (lambda: poisson3d_7pt_dia(464, dtype=np.float32),
                    "float32"),
    "p3d-464-f64": (lambda: poisson3d_7pt_dia(464, dtype=np.float32),
                    "float64"),
    "p3d-256-f32": (lambda: poisson3d_7pt_dia(256, dtype=np.float32),
                    "float32"),
    "p2d-10k-f32": (lambda: _poisson2d_dia(10_000), "float32"),
    "p2d-10k-f64": (lambda: _poisson2d_dia(10_000), "float64"),
}


def _cases(dev, budgets):
    """(kind, tile, plan) for every kernel and tile that fits one block."""
    vdt = getattr(torch, dev.vec_dtype)
    out = []
    for kind in ("hbm-ring", "hbm"):
        for tile in dia_plan.TILES:
            plan = dia_plan.make_plan(kind, tile, dev.nrows_padded,
                                      dev.offsets, vdt, dev.bands.dtype,
                                      budgets, device=dev.device)
            if plan.smem + dia_plan.THREADS * 8 <= budgets.smem_block:
                out.append((kind, tile, plan))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("error: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(CONFIGS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    budgets = dia_plan.device_budgets(torch.device("cuda"))
    summary = {}
    for name in names:
        make, vdt = CONFIGS[name]
        D = make()
        # bf16 bands (exact for both operators) at either vector dtype
        dev = DeviceDia.from_dia(D, dtype="float32")
        if vdt == "float64":
            dev = DeviceDia.from_bands(dev.bands, dev.scales, dev.offsets,
                                       dev.nrows, dev.ncols, dev.nnz,
                                       "float64")
        del D
        n = dev.nrows_padded
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            n)).to(getattr(torch, vdt)).cuda()
        vb = x.element_size()
        bound = (len(dev.offsets) * n * dev.mat_itemsize + 2 * n * vb) \
            / MEM_BW * 1e3
        ref = dia_spmv(dev.bands, dev.scales, dev.offsets_t, x)
        cases = _cases(dev, budgets)
        times = {}
        for rnd in range(ROUNDS):
            t = _time_ms(lambda: dia_spmv(dev.bands, dev.scales,
                                          dev.offsets_t, x, with_dot=True))
            times.setdefault("dia_spmv", []).append(t)
            print(json.dumps({"round": rnd, "config": name,
                              "kernel": "dia_spmv", "ms": t,
                              "bound_ms": bound}), flush=True)
            for kind, tile, plan in cases:
                spmv = dia_spmv_ring if kind == "hbm-ring" else \
                    dia_spmv_windows

                def run(spmv=spmv, plan=plan):
                    return spmv(dev.bands, dev.scales, dev.offsets_t, x,
                                plan, with_dot=True)

                bits = bool(torch.equal(run()[0], ref))
                t = _time_ms(run)
                key = f"{kind}:{tile}"
                times.setdefault(key, []).append(t)
                print(json.dumps({
                    "round": rnd, "config": name, "kernel": kind,
                    "tile": tile, "nblocks": plan.nblocks,
                    "smem": plan.smem, "ms": t, "bound_ms": bound,
                    "bits_equal_dia_spmv": bits,
                    "planned": dev.plan is not None
                    and (dev.plan.kind, dev.plan.tile) == (kind, tile)}),
                    flush=True)
                if not bits:
                    print(f"error: {name} {key} disagrees with dia_spmv",
                          file=sys.stderr)
                    return 1
        summary[name] = {"bound_ms": bound,
                         "plan": [dev.kind, dev.plan.tile if dev.plan
                                  else None],
                         "best_ms": {k: min(v) for k, v in times.items()}}
        del dev, x, ref
        torch.cuda.empty_cache()
    print(json.dumps({"summary": summary, "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
