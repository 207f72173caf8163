#!/usr/bin/env python3
"""Where f32 pipelined CG leaves classic CG's track, on 4 shards and on
one device, on the CPU.

    python scripts/torch_pipe_marks.py [edge] [iterations]

On the 7-point Poisson operator of edge^3 (default 48) in 4 parts on the
CPU, f32 vectors, b = ``default_rng(0).standard_normal``, every criterion
off (``iterations`` fixed iterations, default 600), runs distributed
classic CG, distributed pipelined CG through the folded per-shard
iteration, the same through the open-coded body (``replace_every`` past
the run, so never replacing) and single-device pipelined CG, and prints
one JSON line each: the first iteration whose recurrence residual is at
most 1e-2, 1e-3, 1e-4 and 1e-5 of |b|, the lowest recurrence residual
and where, and the true residual ‖b − A·x‖/‖b‖ at the end, in float64.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import cg_pipelined
    from acg_torch.solvers.cg_dist import (build_sharded, cg_dist,
                                           cg_pipelined_dist)
    from acg_torch.sparse.poisson import poisson3d_7pt

    G = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    its = int(sys.argv[2]) if len(sys.argv) > 2 else 600
    A = poisson3d_7pt(G)
    b = np.random.default_rng(0).standard_normal(A.nrows).astype(np.float32)
    ss = build_sharded(A, nparts=4, devices=["cpu"] * 4, dtype=np.float32,
                       fmt="dia")
    fixed = SolverOptions(maxits=its, residual_rtol=0.0)
    runs = {
        "classic, 4 shards": lambda: cg_dist(ss, b, options=fixed),
        "pipelined folded, 4 shards": lambda: cg_pipelined_dist(
            ss, b, options=fixed),
        "pipelined open-coded, 4 shards": lambda: cg_pipelined_dist(
            ss, b, options=SolverOptions(maxits=its, residual_rtol=0.0,
                                         replace_every=its + 1)),
        "pipelined, one device": lambda: cg_pipelined(
            A, b, options=fixed, dtype=np.float32, fmt="dia",
            device="cpu"),
    }
    for name, run in runs.items():
        res = run()
        rel = np.sqrt(res.residual_history.astype(np.float64)) / res.bnrm2
        marks = {}
        for tau in (1e-2, 1e-3, 1e-4, 1e-5):
            hit = np.nonzero(rel <= tau)[0]
            marks[str(tau)] = int(hit[0]) if len(hit) else None
        x = res.x.astype(np.float64)
        true = float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))
        print(json.dumps({"edge": G, "iterations": its, "run": name,
                          "first_below": marks,
                          "lowest": [int(rel.argmin()), float(rel.min())],
                          "true_relative_residual": true}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
