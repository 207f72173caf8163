#!/usr/bin/env python3
"""The distributed phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python scripts/torch_dist_solves.py [--kernels] [--no-profile]

Runs, in one process and with the same checks, the phases the
distributed path needs and nothing else: build, dist-setup, the
single-device phases the distributed ones are held against (stencil,
dia-bf16, pipelined-stencil, pipelined-dia-bf16, batched-stencil,
batched-pipelined-stencil), the classic distributed phases
(dist-stencil, -allgather, -rdma, dist-dia-bf16), the pipelined, batched
and compressed-wire ones (dist-pipelined-stencil, -allgather, -rdma,
dist-pipelined-dia-bf16, dist-batched-stencil,
dist-batched-pipelined-stencil, dist-wire) and the profile of their
loops.  ``--kernels`` adds the distributed path's kernel checks (the
shard-shaped stencil, interface ELL, DIA, pipelined and multi-RHS
kernels and the put+signal halo against their plain versions, timed).
Each phase prints one JSON line, as ``chip_smoke.py`` does; a failed
check exits non-zero.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="also check and time the distributed path's "
                         "kernels at its shapes")
    ap.add_argument("--no-profile", action="store_true",
                    help="skip the torch.profiler pass over the loops")
    args = ap.parse_args()
    grid, iters, nrhs, nparts = 256, 1000, 8, 4
    ctx = cs._context(25)
    if ctx is None:
        return 2
    cs._phase("build", cs._build_phase)
    cs._phase("dist-setup", lambda: cs._dist_setup(grid, nparts, ctx))
    if args.kernels:
        cs._phase("dist-kernels",
                  lambda: cs._dist_kernels(nrhs, ctx) or {})
    cs._phase("stencil", lambda: cs._stencil_solve(grid, ctx))
    cs._phase("dia-bf16", lambda: cs._dia_bf16_solve(grid, iters, ctx))
    cs._phase("pipelined-stencil",
              lambda: cs._stencil_solve(grid, ctx, True))
    cs._phase("pipelined-dia-bf16",
              lambda: cs._dia_bf16_solve(grid, iters, ctx, True))
    cs._phase("batched-stencil",
              lambda: cs._batched_stencil(grid, nrhs, ctx))
    cs._phase("batched-pipelined-stencil",
              lambda: cs._batched_stencil(grid, nrhs, ctx, pipelined=True))
    for method in ("ppermute", "allgather", "rdma"):
        suffix = "" if method == "ppermute" else f"-{method}"
        cs._phase("dist-stencil" + suffix,
                  lambda m=method: cs._dist_stencil_solve(ctx, m))
    cs._phase("dist-dia-bf16", lambda: cs._dist_dia_solve(iters, ctx))
    for method in ("ppermute", "allgather", "rdma"):
        suffix = "" if method == "ppermute" else f"-{method}"
        cs._phase("dist-pipelined-stencil" + suffix,
                  lambda m=method: cs._dist_pipelined_stencil(ctx, m))
    cs._phase("dist-pipelined-dia-bf16",
              lambda: cs._dist_pipelined_dia(iters, ctx))
    cs._phase("dist-batched-stencil",
              lambda: cs._dist_batched_stencil(nrhs, ctx))
    cs._phase("dist-batched-pipelined-stencil",
              lambda: cs._dist_batched_stencil(nrhs, ctx, pipelined=True))
    cs._phase("dist-wire", lambda: cs._dist_wire_phase(ctx))
    if not args.no_profile:
        cs._phase("profile", lambda: cs._profile_phase(ctx))
    cs._emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
