#!/usr/bin/env python3
"""Checkouts in turns: the classic and pipelined stencil loops on one GPU.

    python scripts/torch_graph_ab.py ROOT [ROOT ...]

For each ROOT (a checkout of the repository; run from the repo root,
e.g. ``build/parent . . build/parent``), in a process of its own that
imports that checkout's ``acg_torch``: the 256^3 f64 Poisson system of
``chip_smoke.py``'s stencil phase (manufactured solution, seed 1), solved
by classic and pipelined CG to rtol 1e-8 three times each, with every
loop the checkout has (``loop="open"`` and ``"graph"`` where ``cg``
takes a ``loop`` argument, else its one loop), then 100 fixed
iterations of each under ``torch.profiler``: kernels an iteration, the
device's busy µs an iteration and the host's launch calls an iteration
(kernel and graph launches).  One JSON line per (ROOT, solver, loop),
with a hash of x (equal hashes: equal bits), the card's name and power
limit.  It imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import subprocess
import sys


def _child(root: str) -> int:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acg_torch.config import SolverOptions
    from acg_torch.errors import AcgError
    from acg_torch.solvers.cg import build_device_operator, cg, cg_pipelined
    from acg_torch.sparse.csr import manufactured_rhs
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    D = poisson3d_7pt_dia(256)
    xstar, b = manufactured_rhs(D, seed=1)
    op = build_device_operator(D, dtype=np.float64, fmt="auto")
    for name, solve in (("cg", cg), ("cg_pipelined", cg_pipelined)):
        loops = (("open", "graph")
                 if "loop" in inspect.signature(solve).parameters
                 else (None,))
        for loop in loops:
            kw = {} if loop is None else {"loop": loop}
            solve(op, b, options=SolverOptions(maxits=20,
                                               residual_rtol=0.0), **kw)
            us, res = [], None
            for _ in range(3):
                res = solve(op, b, options=SolverOptions(
                    maxits=20000, residual_rtol=1e-8), **kw)
                us.append(res.stats.tsolve / res.niterations * 1e6)
            fixed = SolverOptions(maxits=100, residual_rtol=1e-30)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                try:
                    r = solve(op, b, options=fixed, **kw)
                except AcgError as e:
                    r = e.result
            kernels, busy, host = 0, 0.0, 0
            for e in prof.key_averages():
                if e.key.startswith(("cudaLaunch", "cuLaunch",
                                     "cudaGraphLaunch")):
                    host += e.count
                dev = str(getattr(e, "device_type", "")).endswith("CUDA")
                t = float(getattr(e, "self_device_time_total", 0.0)
                          or getattr(e, "self_cuda_time_total", 0.0))
                if dev and t > 0 and not e.key.startswith(("Memcpy",
                                                           "Memset")):
                    kernels += e.count
                    busy += t
            its = r.niterations
            print(json.dumps({
                "root": root, "solver": name, "loop": loop or "open (only)",
                "gpu": smi, "iterations": res.niterations,
                "us_per_iter": us,
                "x_sha": hashlib.sha256(res.x.tobytes()).hexdigest()[:16],
                "profiled_iterations": its,
                "kernels_per_iter": kernels / its,
                "busy_us_per_iter": busy / its,
                "host_launches_per_iter": host / its,
                "capture_seconds": getattr(r.stats, "tcapture", None)}),
                flush=True)
            torch.cuda.synchronize()
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        return _child(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        run = subprocess.run([sys.executable, __file__, "--child", root],
                             stdout=subprocess.PIPE, text=True)
        sys.stdout.write(run.stdout)
        sys.stdout.flush()
        rc = rc or run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
