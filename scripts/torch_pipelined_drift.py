"""Measure how many more iterations f32 pipelined CG takes than classic CG
on the FEM mesh family, in the JAX package (the reference) and in the
PyTorch port, both on the CPU.

Near the f32 floor the pipelined recurrences drift from the true residual,
and certification refuses exit candidates, so pipelined CG ends later than
classic CG.  ``chip_smoke.py`` holds the port's f32 pipelined count on the
1 M-point mesh to a limit derived from the ratios this script prints.

Each case is ``fem_delaunay_spd(points, dim=3, seed=seed, shuffle=True)``
at f32, a manufactured solution (seed 1) and rtol 1e-6, as in
``chip_smoke.py``'s fem-sgell phases.  ``--format sgell`` solves through
``fmt="auto"`` (RCM + sgell, the chip's path; the JAX tier runs its Pallas
kernel in interpret mode, which takes minutes from 4,000 points on);
``--format ell`` solves the RCM-ordered matrix through the forced ELL tier
(the JAX package's XLA gather), so that larger meshes fit in minutes.  One
JSON line per case, then a summary line with the largest and mean ratio.

Run: python scripts/torch_pipelined_drift.py [points ...] [--seeds N]
         [--format sgell|ell]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from acg_tpu.utils.backend import force_cpu_mesh  # noqa: E402

force_cpu_mesh(1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from acg_tpu.config import SolverOptions as JOptions  # noqa: E402
from acg_tpu.ops import sgell as jsgell  # noqa: E402
from acg_tpu.solvers.cg import cg as jcg  # noqa: E402
from acg_tpu.solvers.cg import cg_pipelined as jcg_pipelined  # noqa: E402
from acg_tpu.sparse.mesh import fem_delaunay_spd as jfem  # noqa: E402
from acg_tpu.sparse.rcm import permute_symmetric as jpermute  # noqa: E402
from acg_tpu.sparse.rcm import rcm_order as jrcm_order  # noqa: E402
from acg_torch.config import SolverOptions  # noqa: E402
from acg_torch.solvers.cg import cg, cg_pipelined  # noqa: E402
from acg_torch.sparse.csr import manufactured_rhs  # noqa: E402
from acg_torch.sparse.mesh import fem_delaunay_spd  # noqa: E402
from acg_torch.sparse.rcm import permute_symmetric, rcm_order  # noqa: E402

RTOL = 1e-6


def _interpret_sgell():
    """The JAX sgell tier in Pallas interpret mode: its TPU kernel cannot
    run on the CPU, and its builder would otherwise decline the tier."""
    build = jsgell.build_device_sgell

    def interpret_build(A, dtype=None, mat_dtype="auto",
                        min_fill=jsgell.MIN_FILL, interpret=False,
                        _probing=False):
        return build(A, dtype=dtype, mat_dtype=mat_dtype, min_fill=min_fill,
                     interpret=True)

    jsgell.build_device_sgell = interpret_build


def case(points: int, seed: int, fmt: str) -> dict:
    t0 = time.perf_counter()
    Aj = jfem(points, dim=3, seed=seed)
    At = fem_delaunay_spd(points, dim=3, seed=seed)
    if fmt == "ell":
        Aj = jpermute(Aj, jrcm_order(Aj))
        At = permute_symmetric(At, rcm_order(At))
    solve_fmt = "auto" if fmt == "sgell" else "ell"
    _, b = manufactured_rhs(At, seed=1)
    o = dict(maxits=20000, residual_rtol=RTOL)
    jax_runs = [s(Aj, b, options=JOptions(**o), dtype=np.float32,
                  fmt=solve_fmt) for s in (jcg, jcg_pipelined)]
    port_runs = [s(At, b, options=SolverOptions(**o), dtype=np.float32,
                   fmt=solve_fmt, device="cpu") for s in (cg, cg_pipelined)]
    kj = [r.niterations for r in jax_runs]
    kt = [r.niterations for r in port_runs]
    return {"points": points, "seed": seed,
            "format": [r.operator_format for r in jax_runs + port_runs],
            "jax_classic": kj[0], "jax_pipelined": kj[1],
            "jax_ratio": kj[1] / kj[0],
            "port_classic": kt[0], "port_pipelined": kt[1],
            "port_ratio": kt[1] / kt[0],
            "seconds": time.perf_counter() - t0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("points", nargs="*", type=int, default=[2000, 4000])
    ap.add_argument("--seeds", type=int, default=3,
                    help="meshes per size (seeds 0..N-1)")
    ap.add_argument("--format", choices=("sgell", "ell"), default="sgell")
    args = ap.parse_args()
    _interpret_sgell()
    rows = []
    for points in args.points:
        for seed in range(args.seeds):
            rows.append(case(points, seed, args.format))
            print(json.dumps(rows[-1]), flush=True)
    jr = [r["jax_ratio"] for r in rows]
    print(json.dumps({
        "format": args.format, "cases": len(rows),
        "jax_ratio_max": max(jr),
        "jax_ratio_mean": float(np.mean(jr)),
        "jax_ratio_min": min(jr),
        "port_minus_jax_max": max(
            max(abs(r["port_classic"] - r["jax_classic"]),
                abs(r["port_pipelined"] - r["jax_pipelined"]))
            for r in rows)}))


if __name__ == "__main__":
    main()
