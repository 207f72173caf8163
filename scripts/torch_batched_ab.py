#!/usr/bin/env python3
"""Time the multi-RHS SpMV kernels and the batched solves of one or more
checkouts of the port, each in a process of its own, on one card.

    python scripts/torch_batched_ab.py ROOT [ROOT ...]

ROOT is a checkout's root (the directory that holds ``acg_torch/``).  The
roots run in the order given, so that two versions are compared inside
one run on one card, in turns (parent, change, change, parent).  Each
child builds its own kernels (under ROOT/build/) and prints JSON lines
tagged with its root and turn:

- ``kernel``: ``dia_spmv_batched`` and ``stencil_spmv_batched`` at 256^3
  (B = 8: DIA bf16/f32, int8/f32 and f64/f64, the stencil f32 and f64,
  each with and without the per-system dot; B = 16 DIA bf16/f32 with the
  dot), the median and the range of 25 CUDA-event timings after 3
  warm-up calls;
- ``solve``: batched-stencil (classic CG, 256^3 Poisson f64, B = 8
  normal right-hand sides from seed 0, rtol 1e-8) and batched-dia-bf16
  (bf16 bands, f32 vectors, B = 8, 1000 fixed iterations), each after a
  20-iteration warm-up: iterations per system and µs per
  system-iteration (``tsolve / sum(iterations_per_system)``).

The first line of each child is the card's name and power limit from
``nvidia-smi``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

G, NRHS, REPS, DIA_ITERS = 256, 8, 25, 1000


def _times_ms(fn, reps: int = REPS, warmup: int = 3) -> list:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)


def _child(root: str, turn: int) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from acg_torch import _build
    from acg_torch.config import SolverOptions
    from acg_torch.ops.dia import DeviceDia
    from acg_torch.ops.stencil import recognize_stencil, stencil_spmv_batched
    from acg_torch.solvers.cg import build_device_operator, cg
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    tag = {"root": root, "turn": turn}

    def emit(**kw):
        print(json.dumps({**tag, **kw}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.build()
    emit(card=smi, build_s=time.perf_counter() - t0)
    D = poisson3d_7pt_dia(G)
    gen = torch.Generator(device="cuda").manual_seed(3)
    X64 = torch.randn(16, D.nrows_padded, generator=gen, device="cuda",
                      dtype=torch.float64)

    def kernel(name, tier, nrhs, with_dot, fn):
        ts = _times_ms(fn)
        emit(kernel=name, tier=tier, nrhs=nrhs, with_dot=with_dot,
             ms=ts[len(ts) // 2], ms_min=ts[0], ms_max=ts[-1])

    for tier, vdt, mat in (("bf16/f32", torch.float32, "auto"),
                           ("int8/f32", torch.float32, "int8"),
                           ("f64/f64", torch.float64, None)):
        dev = DeviceDia.from_dia(D, dtype=str(vdt)[6:], mat_dtype=mat)
        for nrhs in ((8, 16) if tier == "bf16/f32" else (8,)):
            X = X64[:nrhs].to(vdt).contiguous()
            for wd in ((False, True) if nrhs == 8 else (True,)):
                # through the operator, as a solve calls it (its host
                # offsets: no read-back from the card)
                kernel("dia_spmv_batched", tier, nrhs, wd,
                       lambda X=X, dev=dev, wd=wd: (
                           dev.matvec_dot(X) if wd else dev.matvec(X)))
        del dev
        torch.cuda.empty_cache()
    for vdt in (torch.float32, torch.float64):
        spec, _ = recognize_stencil(D, dtype=str(vdt)[6:])
        X = X64[:NRHS].to(vdt).contiguous()
        X[:, D.nrows:] = 0
        for wd in (False, True):
            kernel("stencil_spmv_batched", f"matrix-free/{str(vdt)[6:]}",
                   NRHS, wd, lambda X=X, wd=wd: stencil_spmv_batched(
                       spec, X, with_dot=wd))
    del X64, X
    torch.cuda.empty_cache()

    def solve(phase, op, b, opts):
        cg(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
        res = cg(op, b, options=opts)
        its = res.iterations_per_system
        emit(solve=phase, kernel_path=res.kernel,
             iterations_per_system=its.tolist(), tsolve_s=res.stats.tsolve,
             us_per_system_iter=res.stats.tsolve / int(its.sum()) * 1e6)

    rng = np.random.default_rng(0)
    op = build_device_operator(D, dtype=np.float64, fmt="auto")
    solve("batched-stencil", op,
          rng.standard_normal((NRHS, D.nrows)),
          SolverOptions(maxits=20000, residual_rtol=1e-8))
    del op
    D32 = poisson3d_7pt_dia(G, dtype=np.float32)
    op = build_device_operator(D32, dtype=np.float32, fmt="dia")
    solve("batched-dia-bf16", op,
          rng.standard_normal((NRHS, D.nrows)).astype(np.float32),
          SolverOptions(maxits=DIA_ITERS, residual_rtol=0.0))


def main(argv) -> int:
    if len(argv) >= 1 and argv[0] == "--child":
        _child(argv[1], int(argv[2]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for turn, root in enumerate(argv):
        root = str(Path(root).resolve())
        rc |= subprocess.run([sys.executable, __file__, "--child", root,
                              str(turn)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
