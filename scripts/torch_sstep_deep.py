#!/usr/bin/env python3
"""s-step and depth-l pipelined CG of the JAX package beside the port's,
on the CPU.

    python scripts/torch_sstep_deep.py [--sstep S ...] [--depth L ...]
        [--replace-every R ...] [--seeds N] [edge ...]

On the 7-point Poisson operator of each edge^3 (default 32 48), from the
manufactured solution of ``manufactured_rhs(A, seed)`` (seeds 0..N-1,
default 1), at f64 and at f32, runs classic CG (the port's, for the
count), ``cg_sstep`` at each s (default 2 4 8; rtol 1e-8 at f64, 1e-5 at
f32) and ``cg_pipelined_deep`` at each depth l (default 2 3; rtol 1e-6,
1e-8 and 1e-10 at f64, 1e-4 and 1e-5 at f32) and each ``replace_every``
R (default 0, none: a dispatch runs until a claimed exit) in both
packages (``--sstep`` or ``--depth`` with no value leaves a family
out), and
prints one JSON line a case: each package's iterations, dispatches (the
deep note), whether it fell back to classic CG, and its certified
residual ||b - A x|| / ||b|| recomputed here in float64; a solve that
did not converge in 5,000 iterations prints its status instead.  The
last line counts the cases where a package fell back or failed, by
family, precision and tolerance.  Needs JAX (the package's own tests'
environment); the JAX package runs on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_RTOLS = {"sstep": {"float64": [1e-8], "float32": [1e-5]},
          "deep": {"float64": [1e-6, 1e-8, 1e-10],
                   "float32": [1e-4, 1e-5]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("edges", nargs="*", type=int, default=[32, 48])
    ap.add_argument("--sstep", nargs="*", type=int, default=[2, 4, 8])
    ap.add_argument("--depth", nargs="*", type=int, default=[2, 3])
    ap.add_argument("--replace-every", nargs="*", type=int, default=[0])
    ap.add_argument("--seeds", type=int, default=1)
    args = ap.parse_args()

    from acg_tpu.utils.backend import force_cpu_mesh

    force_cpu_mesh(1)
    import jax
    import numpy as np

    jax.config.update("jax_enable_x64", True)
    from acg_tpu.config import SolverOptions as JOptions
    from acg_tpu.errors import AcgError as JAcgError
    from acg_tpu.sparse import poisson as jpoisson

    from acg_torch.config import SolverOptions
    from acg_torch.errors import AcgError
    from acg_torch.sparse import poisson as tpoisson
    from acg_torch.sparse.csr import manufactured_rhs

    # the modules, not the package attributes of the same name
    jcg = importlib.import_module("acg_tpu.solvers.cg")
    tcg = importlib.import_module("acg_torch.solvers.cg")
    tally = {}

    def outcome(res, A, b):
        if isinstance(res, Exception):
            r = getattr(res, "result", None)
            return {"status": str(getattr(res, "status", res)),
                    "iterations": r.niterations if r is not None else None}
        x = np.asarray(res.x, np.float64)
        note = res.kernel_note
        disp = (int(note.split(", ")[1].split()[0])
                if note.startswith("deep pipeline depth") else None)
        return {"iterations": res.niterations, "dispatches": disp,
                "fallback": "fell back to classic cg" in note,
                "certified": float(np.linalg.norm(b - A.matvec(x))
                                   / np.linalg.norm(b))}

    for G in args.edges:
        Aj, At = jpoisson.poisson3d_7pt(G), tpoisson.poisson3d_7pt(G)
        for seed in range(args.seeds):
            _, b = manufactured_rhs(At, seed=seed)
            for dt in ("float64", "float32"):
                dtype = np.dtype(dt)
                for fam, knobs in (("sstep", args.sstep),
                                   ("deep", args.depth)):
                    reps = args.replace_every if fam == "deep" else [0]
                    for knob, R, rtol in ((k, R, t) for k in knobs
                                          for R in reps
                                          for t in _RTOLS[fam][dt]):
                        o = dict(maxits=5000, residual_rtol=rtol,
                                 replace_every=R)
                        o["sstep" if fam == "sstep"
                          else "pipeline_depth"] = knob
                        name = ("cg_sstep" if fam == "sstep"
                                else "cg_pipelined_deep")
                        row = {"edge": G, "seed": seed, "dtype": dt,
                               "solver": name, "s_or_l": knob,
                               "replace_every": R, "rtol": rtol}
                        classic = tcg.cg(At, b, dtype=dtype,
                                         device="cpu",
                                         options=SolverOptions(
                                             maxits=5000,
                                             residual_rtol=rtol))
                        row["classic_iterations"] = classic.niterations
                        for pkg, fn, O, kw in (
                                ("jax", getattr(jcg, name), JOptions,
                                 {}),
                                ("port", getattr(tcg, name),
                                 SolverOptions, {"device": "cpu"})):
                            t0 = time.perf_counter()
                            try:
                                res = fn(Aj if pkg == "jax" else At, b,
                                         dtype=dtype, options=O(**o),
                                         **kw)
                            except (AcgError, JAcgError) as e:
                                res = e
                            row[pkg] = outcome(res, At, b)
                            row[pkg]["host_s"] = round(
                                time.perf_counter() - t0, 2)
                            bad = (row[pkg].get("fallback", True)
                                   or "status" in row[pkg])
                            key = (f"{pkg} {fam} {dt} R {R} "
                                   f"rtol {rtol:g}")
                            tally[key] = tally.get(key, 0) + bad
                        print(json.dumps(row), flush=True)
    print(json.dumps({"fell_back_or_failed": tally}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
