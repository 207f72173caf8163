#!/usr/bin/env python3
"""The deep-pipelined loop's CUDA-graph captures at several check_every,
beside the open loop, on the card.

    python scripts/torch_deep_captures.py [--edge N] [--depth L]
        [--replace-every R] [--rtol T] [--reps K] [check_every ...]

On the 7-point Poisson operator of edge^3 (default 256, f64, the
matrix-free stencil tier) with a seeded normal right-hand side, runs
``cg_pipelined_deep`` (depth L, default 2; ``replace_every`` R, default
50; to rtol T, default 1e-8) at each ``check_every`` (default 1 3 16)
under the open and the graph loop, in turns (open, graph, graph, open
... K times each, default 2), after one warm-up solve a loop.  Prints
one JSON line a case: iterations, dispatches (the deep note), µs per
iteration of each run, the graph loop's captures, replays and the host
seconds of its captures (``SolveStats.ncaptures`` / ``nreplays`` /
``tcapture``; a solve makes its captures anew), and whether the two
loops gave the same x, iterations and history bit for bit.  The first
line is the card's name and power limit as ``nvidia-smi`` gives them.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("check_every", nargs="*", type=int, default=[1, 3, 16])
    ap.add_argument("--edge", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--replace-every", type=int, default=50)
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    from acg_torch.config import SolverOptions
    from acg_torch.solvers.base import SolveStats
    from acg_torch.solvers.cg import build_device_operator, cg_pipelined_deep
    from acg_torch.sparse.poisson import poisson3d_7pt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: not available")
    A = poisson3d_7pt(args.edge)
    op = build_device_operator(A, dtype=np.float64)
    b = np.random.default_rng(0).standard_normal(A.nrows)
    del A

    def solve(ce: int, loop: str):
        st = SolveStats()
        res = cg_pipelined_deep(op, b, options=SolverOptions(
            maxits=20000, residual_rtol=args.rtol,
            pipeline_depth=args.depth, replace_every=args.replace_every,
            check_every=ce), stats=st, loop=loop)
        return res, st

    for ce in args.check_every:
        for loop in ("open", "graph"):
            solve(ce, loop)    # warm-up
        runs = {"open": [], "graph": []}
        for i in range(args.reps):
            for loop in (("open", "graph") if i % 2 == 0
                         else ("graph", "open")):
                runs[loop].append(solve(ce, loop))
        ro, _ = runs["open"][0]
        rg, sg = runs["graph"][0]
        same = (np.array_equal(ro.x, rg.x)
                and ro.niterations == rg.niterations
                and np.array_equal(ro.residual_history, rg.residual_history,
                                   equal_nan=True))
        note = rg.kernel_note
        print(json.dumps({
            "check_every": ce, "depth": args.depth,
            "replace_every": args.replace_every, "rtol": args.rtol,
            "edge": args.edge, "iterations": rg.niterations,
            "converged": bool(rg.converged), "note": note,
            "us_per_iter_open": [r.stats.tsolve / r.niterations * 1e6
                                 for r, _ in runs["open"]],
            "us_per_iter_graph": [r.stats.tsolve / r.niterations * 1e6
                                  for r, _ in runs["graph"]],
            "ncaptures": sg.ncaptures, "nreplays": sg.nreplays,
            "tcapture_s": sg.tcapture, "bits_equal_open": bool(same)}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
