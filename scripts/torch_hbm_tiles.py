"""Time the one-vector DIA kernels (acg_torch/csrc/dia_spmv.cu,
acg_torch/csrc/dia_hbm_ring.cu, acg_torch/csrc/dia_hbm_windows.cu) on
the operators whose plan chooses between them, on an NVIDIA GPU.

For each configuration (the 464^3, 256^3 and 128^3 7-point Poisson
operators, the 10,000^2 5-point one, in the band and vector tiers
``chip_smoke.py`` drives, and an operator of 31 bands in 16 offset
clusters over +-11,783 on 16,000,000 rows, bf16 bands and f32 vectors:
x alone 64 MB, bands, x and y 1.12 GB, past the 50 MB L2, the shape the
plan sends to the ring) ``dia_spmv`` (its generic kernel, and the one with the band count
fixed where it has one) and each HBM kernel at every tile of
``acg_torch.ops.dia_plan.TILES`` whose shared memory fits one block of
this card are timed with the fused dot with CUDA events in interleaved
rounds: the median of 25 one-call timings (``ms``) and of 5 runs of 25
calls queued back to back (``ms_queued``, a call), y checked bit-equal
to ``dia_spmv``'s, and the kernel, tile and depth the plan picks are
marked.  Each HBM kernel runs at each ring depth (row tiles in flight:
``dia_plan.STAGES`` for the windows, ``dia_plan.RING_STAGES`` for the
ring) that fits: the deepest as this card plans it, a shallower one as
the plan makes it for a block budget that holds it and not the deeper
(one block an SM), and again with as many blocks as fit an SM where
that differs.  The bound is the bytes one call must move (bands at
their storage width, x read and y written once) over the data sheet's
3.35 TB/s.

Prints the card's name and power limit, one JSON line per (round,
configuration, kernel, tile, depth) and a summary line with each
configuration's fastest time per kernel and the plan's choice.  Imports
nothing of JAX.

Run on the card: python scripts/torch_hbm_tiles.py [config ...]
(configs: p3d-464-f32 p3d-464-f64 p3d-256-f32 p3d-256-int8 p3d-256-f64
p3d-128-f32 p2d-10k-f32 p2d-10k-f64 p2d-10k-bf16-f64 ring31-16m-f32)
"""

import dataclasses
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
from chip_smoke import _poisson2d_dia, _queued_ms  # noqa: E402

ROUNDS = 2
REPS = 25
MEM_BW = 3.35e12          # H100 SXM data sheet, bytes/s


def ring_operator(n: int):
    """31 bands in 16 offset clusters over +-11,783 (offsets +-1537 k and
    +-(1537 k + 1024), k = 0..7; tests/test_torch_dia_order.py
    _ring_offsets): no windows ring of 3 stages fits one block, the ring
    does.  Diagonal 2, every other band -1/32 (bf16-exact), zero where a
    band leaves the vector."""
    from acg_torch.ops.dia import DiaMatrix

    offsets = tuple(sorted({s * (1537 * k + e) for k in range(8)
                            for e in (0, 1024) for s in (1, -1)}))
    bands = np.full((len(offsets), n), -1 / 32, dtype=np.float32)
    for d, off in enumerate(offsets):
        if off == 0:
            bands[d] = 2.0
        elif off > 0:
            bands[d, n - off:] = 0.0
        else:
            bands[d, :-off] = 0.0
    return DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))


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


# (operator, vector dtype, band tier: "auto" bf16-exact, "int8" mask with
# scales, None full width)
CONFIGS = {
    "p3d-464-f32": (lambda: poisson3d_7pt_dia(464, dtype=np.float32),
                    "float32", "auto"),
    "p3d-464-f64": (lambda: poisson3d_7pt_dia(464, dtype=np.float32),
                    "float64", "auto"),
    "p3d-256-f32": (lambda: poisson3d_7pt_dia(256, dtype=np.float32),
                    "float32", "auto"),
    "p3d-256-int8": (lambda: poisson3d_7pt_dia(256, dtype=np.float32),
                     "float32", "int8"),
    "p3d-256-f64": (lambda: poisson3d_7pt_dia(256), "float64", None),
    "p3d-128-f32": (lambda: poisson3d_7pt_dia(128, dtype=np.float32),
                    "float32", "auto"),
    "p2d-10k-f32": (lambda: _poisson2d_dia(10_000), "float32", "auto"),
    "p2d-10k-f64": (lambda: _poisson2d_dia(10_000), "float64", None),
    "p2d-10k-bf16-f64": (lambda: _poisson2d_dia(10_000), "float64", "auto"),
    "ring31-16m-f32": (lambda: ring_operator(16_000_000), "float32", "auto"),
}


def _cases(dev, budgets):
    """(kind, tile, stages, plan) for every kernel, tile and ring depth
    that fits one block."""
    vdt = getattr(torch, dev.vec_dtype)
    n = dev.nrows_padded
    live = [o for o in dev.offsets if abs(o) < n]
    vb = torch.empty((), dtype=vdt).element_size()
    out = []
    for kind, depths, nbytes, deepest in (
            ("hbm-ring", dia_plan.RING_STAGES, dia_plan.ring_bytes,
             dia_plan.ring_stages),
            ("hbm", dia_plan.STAGES, dia_plan.windows_bytes,
             dia_plan.windows_stages)):
        for tile in dia_plan.TILES:
            for stages in depths:
                need = nbytes(live, tile, vb, dev.mat_itemsize,
                              len(dev.offsets), stages)
                if need > budgets.smem_block:
                    continue
                b = budgets
                if deepest(n, dev.offsets, vdt, dev.bands.dtype, tile,
                           budgets) != stages:
                    b = dataclasses.replace(budgets, smem_block=need)
                plan = dia_plan.make_plan(kind, tile, n, dev.offsets, vdt,
                                          dev.bands.dtype, b,
                                          device=dev.device)
                out.append((kind, tile, stages, plan))
                # the same depth with as many blocks as fit the card's SM
                # (the plan's own budget keeps one when a deeper ring fits)
                full = min(budgets.sms * dia_plan.blocks_per_sm(
                    need, budgets, dia_plan.WINDOWS_THREADS), plan.ntiles)
                if full != plan.nblocks:
                    out.append((kind, tile, stages,
                                dataclasses.replace(plan, nblocks=full)))
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
        make, vdt, mat = CONFIGS[name]
        D = make()
        if mat == "auto" and vdt == "float64":
            # bf16 bands (exact) with f64 vectors, as dia-100m-f64
            dev = DeviceDia.from_dia(D, dtype="float32")
            dev = DeviceDia.from_bands(dev.bands, dev.scales, dev.offsets,
                                       dev.nrows, dev.ncols, dev.nnz,
                                       "float64")
        else:
            dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat)
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
        fixed = (False,) + ((True,) if vdt == "float32" and len(
            dev.offsets) in dia_plan.FIXED_BANDS else ())
        for rnd in range(ROUNDS):
            for f in fixed:
                def run(f=f):
                    return dia_spmv(dev.bands, dev.scales, dev.offsets_t, x,
                                    with_dot=True, fixed=f)

                t = _time_ms(run)
                key = "dia_spmv:fixed" if f else "dia_spmv"
                times.setdefault(key, []).append(t)
                print(json.dumps({"round": rnd, "config": name,
                                  "kernel": key, "ms": t,
                                  "ms_queued": _queued_ms(run),
                                  "bound_ms": bound,
                                  "planned": dev.plan is None
                                  and dev.fixed == f}), flush=True)
            for kind, tile, stages, plan in cases:
                spmv = dia_spmv_ring if kind == "hbm-ring" else \
                    dia_spmv_windows

                def run(spmv=spmv, plan=plan):
                    return spmv(dev.bands, dev.scales, dev.offsets_t, x,
                                plan, with_dot=True)

                bits = bool(torch.equal(run()[0], ref))
                t = _time_ms(run)
                key = f"{kind}:{tile}:{stages}:{plan.nblocks}"
                times.setdefault(key, []).append(t)
                print(json.dumps({
                    "round": rnd, "config": name, "kernel": kind,
                    "tile": tile, "stages": stages, "nblocks": plan.nblocks,
                    "smem": plan.smem, "ms": t,
                    "ms_queued": _queued_ms(run), "bound_ms": bound,
                    "bits_equal_dia_spmv": bits,
                    "planned": dev.plan is not None
                    and (dev.plan.kind, dev.plan.tile, dev.plan.stages,
                         dev.plan.nblocks) == (kind, tile, stages,
                                               plan.nblocks)}),
                    flush=True)
                if not bits:
                    print(f"error: {name} {key} disagrees with dia_spmv",
                          file=sys.stderr)
                    return 1
        best = {}
        for k, v in times.items():
            kern = k.split(":")[0]
            if kern not in best or min(v) < best[kern][1]:
                best[kern] = (k, min(v), max(v))
        summary[name] = {"bound_ms": bound,
                         "plan": [dev.kind, dev.plan.tile if dev.plan
                                  else None,
                                  dev.plan.stages if dev.plan else None],
                         "fastest_per_kernel": best,
                         "ms": {k: sorted(v) for k, v in times.items()}}
        del dev, x, ref
        torch.cuda.empty_cache()
    print(json.dumps({"summary": summary, "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
