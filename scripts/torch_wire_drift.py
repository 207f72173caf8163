#!/usr/bin/env python3
"""Distributed CG under a compressed halo wire, the JAX package beside the
port, on the CPU.

    python scripts/torch_wire_drift.py [--wire bf16|int16-delta]
        [--rtol R] [--seeds S] [--maxits N] [edge ...]

For each 3-D Poisson edge (default 16 24 32) and each right-hand side
``default_rng(seed).standard_normal`` (seeds 0..S-1, f32), runs
``cg_dist`` and ``cg_pipelined_dist`` of both packages on the same 4-part
vector with the wire, ``replace_every=10`` and rtol R (the recipe of
``tests/test_halo_wire.py``: bf16 at 1e-3, int16-delta at 1e-4), and
prints one JSON line a case: each solve's count, or its relative
residual where it did not converge in ``--maxits``.  Near the wire's
noise floor the pipelined recurrences part with their rounding, so the
two packages' outcomes can differ case by case.  Needs JAX (the
package's own tests' environment) and runs on the CPU only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("edges", nargs="*", type=int, default=[16, 24, 32])
    ap.add_argument("--wire", default="bf16",
                    choices=["bf16", "int16-delta"])
    ap.add_argument("--rtol", type=float, default=None)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--maxits", type=int, default=1500)
    args = ap.parse_args()
    rtol = args.rtol or (1e-3 if args.wire == "bf16" else 1e-4)

    from acg_tpu.utils.backend import force_cpu_mesh

    force_cpu_mesh(8)
    import numpy as np

    from acg_tpu.config import SolverOptions as JOptions
    from acg_tpu.errors import AcgError as JAcgError
    from acg_tpu.partition import partitioner as jpart
    from acg_tpu.sparse import poisson as jpoisson

    from acg_torch.config import SolverOptions
    from acg_torch.errors import AcgError
    from acg_torch.sparse import poisson as tpoisson

    # the modules, not the package attributes of the same name
    jdist = importlib.import_module("acg_tpu.solvers.cg_dist")
    tdist = importlib.import_module("acg_torch.solvers.cg_dist")
    opts = dict(maxits=args.maxits, residual_rtol=rtol,
                halo_wire=args.wire, replace_every=10)
    for G in args.edges:
        JA, TA = jpoisson.poisson3d_7pt(G), tpoisson.poisson3d_7pt(G)
        part = jpart.partition_graph(JA, 4)
        for seed in range(args.seeds):
            b = np.random.default_rng(seed).standard_normal(
                TA.nrows).astype(np.float32)
            row = {"edge": G, "seed": seed, "wire": args.wire, "rtol": rtol}
            for solver in ("cg_dist", "cg_pipelined_dist"):
                for pkg, fn, opt, err, kw in (
                        ("jax", getattr(jdist, solver), JOptions, JAcgError,
                         {}),
                        ("port", getattr(tdist, solver), SolverOptions,
                         AcgError, {"devices": ["cpu"] * 4})):
                    try:
                        r = fn(JA if pkg == "jax" else TA, b,
                               options=opt(**opts), part=part, fmt="dia",
                               dtype=np.float32, **kw)
                        out = r.niterations
                    except err as e:
                        res = getattr(e, "result", None)
                        out = {"not_converged": None if res is None
                               else res.relative_residual}
                    row[f"{pkg}:{solver}"] = out
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
