#!/usr/bin/env python3
"""Time the stencil SpMV kernels and the stencil solves of one or more
checkouts of the port, each in a process of its own, on one card.

    python scripts/torch_stencil_ab.py [--kernels-only] ROOT [ROOT ...]

ROOT is a checkout's root (the directory that holds ``acg_torch/``).  The
roots run in the order given, so that versions are compared inside one
run on one card, in turns (parent, change, change, parent).  Each child
builds its own kernels (under ROOT/build/) and prints JSON lines tagged
with its root and turn:

- ``build``: the card's name and power limit from ``nvidia-smi``, the
  build seconds, and for every instantiation of ``stencil_spmv``,
  ``stencil_spmv_batched`` and ``cg_pipelined_iter_stencil`` the
  registers and spill bytes that ``-Xptxas -v`` reports and, from
  ``cuobjdump -sass``, its global loads and the longest run of global
  loads with no multiply-add between them (the loads a thread has in
  flight before its first sum);
- ``kernel``: ``stencil_spmv`` as the plan runs it (``route``; a
  checkout without the fixed-arm kernel has one) at 256^3 f32 and f64,
  the 256 x 128 x 128 shard of the distributed cell at f64, the 27-point
  operator on 128^3 and the 2-D 5-point on 4096^2 at f64, each with and
  without the dot, and, where the checkout has it, the generic kernel
  forced on the same x (``route: generic``); ``stencil_spmv_batched`` at
  256^3, B = 8, with the dot; ``cg_pipelined_iter_stencil`` at 256^3:
  the median and range of 25 CUDA-event timings after 3 warm-up calls,
  each around one call (``ms``: the card's time plus whatever of the
  host's time a call the card waits for), the median of 5 timings of 25
  calls queued back to back, a call (``ms_queued``), and the host's time
  a call while queuing them (``host_ms``; where it is below
  ``ms_queued`` the card never waited, and ``ms_queued`` is its time
  alone), a hash of y and the dot's bits (equal hashes across roots: the
  same bits), and for the 256^3 and shard cases with the dot a hash of
  the dots of eight more vectors;
- ``solve`` (without ``--kernels-only``): stencil (256^3 f64 Poisson,
  manufactured solution, rtol 1e-8), pipelined-replace (the same through
  cg_pipelined with replace_every=50), batched-stencil (B = 8) and
  dist-stencil-rdma (4 shards of it on the one card, rdma halo):
  ``chip_smoke.py``'s protocols, kernel path, iterations, µs/iter.

The parent process repeats every child's lines and ends with a summary
of each case's medians by root and turn and whether the y and dot hashes
agree across roots.  Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from torch_dia_ab import _demangle, _ptxas, _sass, _sha, _times_ms

REPO = Path(__file__).resolve().parent.parent

LIBS = ("stencil_spmv", "stencil_spmv_batched", "stencil_pipe")
SOLVE_LIBS = ("ell_spmv", "rdma_halo")


def _smoke():
    """chip_smoke.py of this script's checkout, whatever ROOT is: its spec
    and CSR builders import the package under test (ROOT's) when
    called."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _queued_ms(fn, calls: int = 25, reps: int = 5) -> tuple:
    """(ms a call on the card, ms a call on the host), the medians of
    ``reps`` runs of ``calls`` calls queued back to back between one
    pair of events.  One call is queued before the first event, so the
    card is busy while the host queues the rest."""
    import torch

    card, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        card.append(a.elapsed_time(b) / calls)
        host.append((t1 - t0) * 1e3 / calls)
    return sorted(card)[reps // 2], sorted(host)[reps // 2]


def _child(root: str, turn: int, kernels_only: bool) -> None:
    sys.path.insert(0, root)
    import inspect
    import itertools

    import torch

    from acg_torch import _build
    from acg_torch.ops import stencil as st
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    _grid_stencil = _smoke()._grid_stencil
    tag = {"root": root, "turn": turn}

    def emit(**kw):
        print(json.dumps({**tag, **kw}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    logs = _build.build(LIBS + (() if kernels_only else SOLVE_LIBS))
    build_s = time.perf_counter() - t0
    fns = {}
    for name in LIBS:
        regs = _ptxas(logs.get(name, ""))
        sass = _sass(_build.library_path(name))
        for fn in sorted(set(regs) | set(sass)):
            if "kernel" in fn and "sum_partials" not in fn:
                fns[fn] = {"lib": name, "regs": regs.get(fn, [None])[0],
                           "spill": regs.get(fn, [None, None])[1],
                           "ldg": sass.get(fn, (None, None))[0],
                           "max_ldg_run": sass.get(fn, (None, None))[1]}
    names = list(fns)
    emit(card=smi, build_s=build_s,
         functions={d: fns[m] for d, m in zip(_demangle(names), names)})

    has_fixed = "fixed" in inspect.signature(st.stencil_spmv).parameters
    gen = torch.Generator(device="cuda").manual_seed(1)

    def x_of(n, vdt, npad=None):
        x = torch.zeros(npad or n, dtype=vdt, device="cuda")
        x[:n] = torch.randn(n, generator=gen, device="cuda",
                            dtype=torch.float64).to(vdt)
        return x

    def kernel(name, cell, with_dot, fn, **extra):
        out = fn()
        y, d = out if with_dot else (out, None)
        ts = _times_ms(fn)
        queued, host = _queued_ms(fn)
        emit(kernel=name, cell=cell, with_dot=with_dot,
             ms=ts[len(ts) // 2], ms_min=ts[0], ms_max=ts[-1],
             ms_queued=queued, host_ms=host,
             y_sha=_sha(y),
             dot=None if d is None else d.reshape(-1).tolist(),
             dot_sha=None if d is None else _sha(d), **extra)

    def spmv_cases(spec, cell, vdt, dots=(False, True), more_dots=False):
        n = spec.nrows
        x = x_of(n, vdt, -(-n // 8) * 8)
        routes = [None] + ([False] if has_fixed else [])
        for wd in dots:
            for fixed in routes:
                kw = {} if fixed is None else {"fixed": fixed}
                kernel("stencil_spmv", cell, wd,
                       lambda wd=wd, kw=kw: st.stencil_spmv(
                           spec, x, with_dot=wd, **kw),
                       route=(st.route(spec, fixed) if has_fixed
                              else "generic"))
        if more_dots:
            ds = [st.stencil_spmv(spec, x_of(n, vdt, x.numel()),
                                  with_dot=True)[1] for _ in range(8)]
            emit(kernel_bits="stencil_spmv", cell=cell,
                 dots_sha=_sha(torch.stack(ds)))
        return x

    spec256, _ = st.recognize_stencil(poisson3d_7pt_dia(256))
    for vdt in (torch.float32, torch.float64):
        x = spmv_cases(spec256, f"256^3 {str(vdt)[6:]}", vdt,
                       more_dots=True)
        X = torch.stack([x_of(spec256.nrows, vdt, x.numel())
                         for _ in range(8)])
        kernel("stencil_spmv_batched", f"256^3 {str(vdt)[6:]} B=8", True,
               lambda X=X: st.stencil_spmv_batched(spec256, X,
                                                   with_dot=True))
        del X
        w = [x_of(spec256.nrows, vdt, x.numel()) for _ in range(6)]
        ab = (torch.tensor(0.37, dtype=vdt, device="cuda"),
              torch.tensor(1.21, dtype=vdt, device="cuda"))
        wout = torch.empty_like(x)
        kernel("cg_pipelined_iter_stencil", f"256^3 {str(vdt)[6:]}", None,
               lambda w=w, ab=ab, wout=wout: st.cg_pipelined_iter_stencil(
                   spec256, *w, *ab, w_out=wout)[0])
        del w, x, wout
        torch.cuda.empty_cache()
    shard, _ = st.recognize_stencil(poisson3d_7pt_dia(256, 128, 128))
    spmv_cases(shard, "shard 256x128x128 float64", torch.float64,
               more_dots=True)
    spmv_cases(_grid_stencil((128,) * 3,
                             list(itertools.product((-1, 0, 1), repeat=3)),
                             26.0), "27pt 128^3 float64", torch.float64)
    spmv_cases(_grid_stencil((4096, 4096), [(-1, 0), (0, -1), (0, 0),
                                            (0, 1), (1, 0)], 4.0),
               "2d-5pt 4096^2 float64", torch.float64)
    torch.cuda.empty_cache()
    if not kernels_only:
        solves(emit)


def solves(emit):
    """stencil, pipelined-replace, batched-stencil and dist-stencil-rdma
    (chip_smoke.py's protocols, one warm-up solve each)."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.partition.graph import partition_system
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.solvers.cg import build_device_operator, cg, cg_pipelined
    from acg_torch.solvers.cg_dist import build_sharded, cg_dist
    from acg_torch.sparse.csr import manufactured_rhs
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    _csr_from_dia = _smoke()._csr_from_dia

    def solve(phase, solver, op, b, **kw):
        solver(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
        res = solver(op, b, options=SolverOptions(
            maxits=20000, residual_rtol=1e-8, **kw))
        total = (int(np.sum(res.iterations_per_system)) if res.nrhs > 1
                 else res.niterations)
        emit(solve=phase, kernel_path=res.kernel, iterations=res.niterations,
             tsolve_s=res.stats.tsolve,
             us_per_iter=res.stats.tsolve / res.niterations * 1e6,
             us_per_system_iter=res.stats.tsolve / total * 1e6,
             converged=bool(res.converged))

    D = poisson3d_7pt_dia(256)
    _, b = manufactured_rhs(D, seed=1)
    op = build_device_operator(D, dtype=np.float64, fmt="auto")
    solve("stencil", cg, op, b)
    solve("pipelined-replace", cg_pipelined, op, b, replace_every=50)
    B = np.stack([manufactured_rhs(D, seed=s)[1] for s in range(8)])
    solve("batched-stencil", cg, op, B)
    del B, op
    A = _csr_from_dia(D)
    del D
    ps = partition_system(A, partition_graph(A, 4), local_order="band")
    del A
    ss = build_sharded(ps, devices=["cuda:0"] * 4, dtype=np.float64,
                       method="rdma")
    solve("dist-stencil-rdma", cg_dist, ss, b)


def _summary(lines: list) -> dict:
    """Per case: the medians by root in turn order, and whether every
    root gave the same y (and dot) bits."""
    out = {}
    for ln in lines:
        who = (ln["turn"], Path(ln["root"]).name or ".")
        if ln.get("kernel"):
            key = " | ".join(map(str, (ln["kernel"], ln["cell"],
                                       ln["with_dot"], ln.get("route"))))
            e = out.setdefault(key, {"ms": [], "ms_queued": [],
                                     "y_sha": set(), "dot_sha": set()})
            e["ms"].append((*who, ln["ms"]))
            e["ms_queued"].append((*who, ln["ms_queued"], ln["host_ms"]))
            e["y_sha"].add(ln["y_sha"])
            e["dot_sha"].add(ln["dot_sha"])
        elif ln.get("kernel_bits"):
            e = out.setdefault(f"dots of 8 vectors | {ln['kernel_bits']} | "
                               f"{ln['cell']}", {"dots_sha": set()})
            e["dots_sha"].add(ln["dots_sha"])
        elif ln.get("solve"):
            e = out.setdefault("solve | " + ln["solve"], {"us_per_iter": []})
            e["us_per_iter"].append((*who, ln["us_per_iter"],
                                     ln["iterations"]))
    for e in out.values():
        for k in ("y_sha", "dot_sha", "dots_sha"):
            if k in e:
                e[k] = len(e[k])
    return out


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    argv = [a for a in argv if a != "--kernels-only"]
    if len(argv) >= 1 and argv[0] == "--child":
        _child(argv[1], int(argv[2]), argv[3] == "1")
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc, lines = 0, []
    for turn, root in enumerate(argv):
        root = str(Path(root).resolve())
        run = subprocess.run([sys.executable, __file__, "--child", root,
                              str(turn),
                              "1" if kernels_only else "0"],
                             stdout=subprocess.PIPE, text=True,
                             cwd=str(REPO))
        rc |= run.returncode
        for ln in run.stdout.splitlines():
            print(ln, flush=True)
            if ln.startswith("{"):
                lines.append(json.loads(ln))
    print(json.dumps({"summary": _summary(lines)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
