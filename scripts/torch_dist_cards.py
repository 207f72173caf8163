#!/usr/bin/env python3
"""Distributed classic, s-step and deep-pipelined CG with the shards
sharing one card and spread over the visible cards, one a card.

    python scripts/torch_dist_cards.py [--grid 256] [--parts 4]

Builds the 7-point Poisson operator on a G^3 grid (f64) in ``--parts``
grid blocks and puts the same partition on ``["cuda:0"] * P`` and on
``["cuda:0", ..., "cuda:P-1"]`` (needs P cards), the ppermute halo on
both.  On each layout it runs, after a short warm-up of each:
``cg_dist``, ``cg_sstep_dist`` (s = 4) and ``cg_pipelined_deep_dist``
(depth 2, ``replace_every=50``), to rtol 1e-8 from b = A x* (x* from
``default_rng(7)``), and prints one JSON line a solve: iterations,
µs/iter, the kernel line, the deep layer's host seconds, and the
residual certified in float64 on the host from the grid (it must be
below 10 x rtol, and each solver's count the same on both layouts
within 1, else the script exits 1).  The last line is ``{"ok": true}``
with the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def solves(ss, b, G: int, rtol: float = 1e-8):
    """The three solvers on the shards ``ss`` from ``b``: one report a
    solver (a dict), each after a short warm-up solve."""
    import numpy as np

    import chip_smoke as cs
    from acg_torch.config import SolverOptions
    from acg_torch.parallel.deep import build_deep_device
    from acg_torch.solvers.cg_dist import (cg_dist, cg_pipelined_deep_dist,
                                           cg_sstep_dist)

    out = []
    for name, solve, kw, depth in (
            ("cg_dist", cg_dist, {}, 0),
            ("cg_sstep_dist", cg_sstep_dist, dict(sstep=4), 4),
            ("cg_pipelined_deep_dist", cg_pipelined_deep_dist,
             dict(pipeline_depth=2, replace_every=50), 2)):
        deep_s = {}
        if depth:
            build_deep_device(ss, depth, timings=deep_s)
        solve(ss, b, options=SolverOptions(maxits=8, residual_rtol=0.0,
                                           **kw))
        t0 = time.perf_counter()
        res = solve(ss, b, options=SolverOptions(maxits=20000,
                                                 residual_rtol=rtol, **kw))
        wall = time.perf_counter() - t0
        cert = cs._poisson7_residual(G, res.x, b)
        out.append({"solver": name,
                    "devices": sorted({str(d) for d in ss.devices}),
                    "iterations": res.niterations,
                    "us_per_iter": res.stats.tsolve / res.niterations * 1e6,
                    "wall_s": wall, "kernel": res.kernel,
                    "kernel_note": res.kernel_note,
                    "deep_host_seconds": deep_s,
                    "certified_relative_residual": cert,
                    "certified": bool(res.converged and cert <= 10 * rtol
                                      and np.all(np.isfinite(res.x)))})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--parts", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from acg_torch.parallel.sharded import ShardedSystem
    from acg_torch.partition.graph import partition_system
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.solvers.cg_dist import build_sharded
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    ctx = cs._context(5)
    if ctx is None:
        return 2
    G, P = args.grid, args.parts
    if torch.cuda.device_count() < P:
        print(f"error: {P} shards one a card need {P} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cs._phase("build", cs._build_phase)
    A = cs._csr_from_dia(poisson3d_7pt_dia(G))
    ps = partition_system(A, partition_graph(A, P), local_order="band")
    xstar = np.random.default_rng(7).standard_normal(A.nrows)
    b = A.matvec(xstar)
    del A
    one = build_sharded(ps, devices=["cuda:0"] * P, dtype=np.float64)
    spread = ShardedSystem.build(ps, one.local_fmt, one.local_ops[0].spec,
                                 devices=[f"cuda:{i}" for i in range(P)],
                                 dtype=np.float64)
    reports = {}
    for label, ss in (("one card", one), ("one card a shard", spread)):
        reports[label] = solves(ss, b, G)
        for rep in reports[label]:
            cs._emit({"layout": label, **rep})
    ok = all(r["certified"] for rs in reports.values() for r in rs) and all(
        abs(a["iterations"] - c["iterations"]) <= 1
        for a, c in zip(*reports.values()))
    cs._emit({"ok": ok, "grid": G, "parts": P,
              "gpu": torch.cuda.get_device_name(0)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
