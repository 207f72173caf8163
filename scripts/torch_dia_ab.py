#!/usr/bin/env python3
"""Time the one-vector DIA SpMV kernels and the DIA solves of one or more
checkouts of the port, each in a process of its own, on one card.

    python scripts/torch_dia_ab.py [--kernels-only | --pipe-only] ROOT ...

ROOT is a checkout's root (the directory that holds ``acg_torch/``).  The
roots run in the order given, so that versions are compared inside one
run on one card, in turns (parent, change, change, parent).  Each child
builds its own kernels (under ROOT/build/) and prints JSON lines tagged
with its root and turn:

- ``build``: the card's name and power limit from ``nvidia-smi``, the
  build seconds, and for every instantiation of ``dia_spmv`` and
  ``dia_spmv_windows`` the registers and spill bytes that ``-Xptxas -v``
  reports and, from ``cuobjdump -sass``, its global loads and the longest
  run of global loads with no multiply-add between them (the loads a
  thread has in flight before its first sum);
- ``kernel``: ``dia_spmv`` as the operator's plan runs it (256^3
  bf16/f32, int8/f32, f64/f64 with and without the dot; 128^3 bf16/f32;
  a 256 x 128 x 128 operator, the size of one dist-dia-bf16 shard; 464^3
  bf16/f32 with the dot; ``fixed``: whether the plan took the kernel with
  the band count fixed, null for a checkout without it), the
  operator's planned HBM kernel (256^3 in the three tiers, 464^3 with f32
  and f64 vectors, 10,000^2 bf16/f32), and ``dia_spmv_batched`` (B = 8)
  at 256^3 bf16/f32: the median and range of 25 CUDA-event timings after
  3 warm-up calls, the plan, and a hash of y and the dot's bits (equal
  hashes across roots: the same bits);
- ``kernel`` rows of ``cg_pipelined_iter`` at 256^3 in the three tiers,
  on the 256 x 128 x 128 operator (bf16/f32), on the varcoef 128^3
  operator of pipelined-dia-f64 (f64/f64), on a 10^6-row tridiagonal,
  rcm-dia-pipelined's band after RCM (bf16/f64), at 64^3 (bf16/f32,
  f64/f64: a call inside the L2), and at f32 vectors on the fixed
  kernel's other band counts (a 10^7-row tridiagonal, the 2-D 5-point
  operator on 2048^2, the 27-point operator on 128^3, each with bf16,
  int8 and f32 bands; the same at 10^5, 256^2 and 32^3, inside the L2,
  with bf16 bands; 256^3 with f32 bands): one row for the operator's plan
  (``plan_fixed``: which kernel it took, null for a checkout without
  the choice) and, where the checkout has the choice, one for each
  kernel forced (``body`` "generic", "fixed"); each one call as above
  and ``ms_queued`` (25 calls back to back between one pair of events,
  median of 5), beside ``bound_ms`` (the bands and 12 vector streams
  over the card's memory rate), the hash of the six vectors, gamma and
  delta after one call from the same inputs (``y_sha``), and of gamma
  and delta (``dot_sha``);
- ``solve`` (without ``--kernels-only``): dia-bf16 (256^3, 1000 fixed
  iterations, planned), dia-bf16-128 (resident), dia-f64 (varcoef 128^3,
  rtol 1e-8), dia-100m (464^3, rtol 1e-4), dia-100m-f64 (rtol 1e-8),
  pipelined-dia-bf16 (256^3, 1000 fixed iterations), pipelined-dia-f64
  (varcoef 128^3, rtol 1e-8), dist-dia-bf16 and dist-pipelined-dia-bf16
  (4 shards of 256^3 on the one card, bf16 bands, rdma, 1000 fixed
  iterations): kernel path, iterations, µs/iter, a hash of x and, for
  the pipelined solves, the kernels an iteration from ``torch.profiler``
  (the kernels of a 100-iteration solve less those of a 50-iteration
  one, over 50).

With ``--pipe-only`` a turn builds and times the ``cg_pipelined_iter``
rows alone.  The parent process repeats every child's lines and ends
with a summary of each case's medians by root, whether the y and dot
hashes agree across roots, and, per pipelined cell, whether every body
of every root gave the same bits.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPS = 25
DIA_ITERS = 1000


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


def _queued_ms(fn, calls: int = REPS, reps: int = 5) -> float:
    """ms a call with ``calls`` calls queued back to back between one pair
    of CUDA events (one call queued before the first), median of
    ``reps``."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return sorted(out)[reps // 2]


def _kernels_in(fn) -> int:
    """Kernels ``fn()`` ran on the card, from ``torch.profiler`` (copies
    and memsets not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = 0
    for e in prof.key_averages():
        dev = str(getattr(e, "device_type", ""))
        if (dev.endswith("CUDA") and not e.key.startswith(("Memcpy",
                                                           "Memset"))):
            n += e.count
    return n


def _sha(t) -> str:
    return hashlib.sha256(t.contiguous().view(-1).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def _demangle(names: list) -> list:
    exe = shutil.which("c++filt")
    if not exe or not names:
        return names
    run = subprocess.run([exe], input="\n".join(names), capture_output=True,
                         text=True)
    out = run.stdout.splitlines()
    return out if len(out) == len(names) else names


def _ptxas(log: str) -> dict:
    """{mangled entry: (registers, spill bytes)} from a -Xptxas -v log."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn:
            out.setdefault(fn, [None, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out.setdefault(fn, [None, 0])[0] = int(m.group(1))
    return out


def _sass(lib: Path) -> dict:
    """{mangled function: (global loads, longest run of global loads with
    no FFMA / DFMA / FMUL-add between them)} from cuobjdump -sass."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    run = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True)
    out, fn, ldg, run_, best = {}, None, 0, 0, 0
    for ln in run.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            if fn:
                out[fn] = (ldg, best)
            fn, ldg, run_, best = m.group(1), 0, 0, 0
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      ln)
        if not m or fn is None:
            continue
        op = m.group(1)
        if op.startswith("LDG"):
            ldg += 1
            run_ += 1
            best = max(best, run_)
        elif op.startswith(("FFMA", "DFMA", "HFMA")):
            run_ = 0
    if fn:
        out[fn] = (ldg, best)
    return out


def _own_dia_plan():
    """``acg_torch/ops/dia_plan.py`` of this script's own checkout, loaded
    by path: the bound of a pipelined iteration comes from its
    ``pipe_bytes`` whatever ROOT is (a parent ROOT may predate it)."""
    import importlib.util

    path = (Path(__file__).resolve().parent.parent / "acg_torch" / "ops"
            / "dia_plan.py")
    spec = importlib.util.spec_from_file_location("_own_dia_plan", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _child(root: str, turn: int, mode: str) -> None:
    """One root's turn; ``mode`` "all", "kernels" (--kernels-only) or
    "pipe" (--pipe-only)."""
    kernels_only, pipe_only = mode != "all", mode == "pipe"
    sys.path.insert(0, root)
    # chip_smoke.py's operator builders, from this checkout (they import
    # the package under test, ROOT's)
    sys.path.append(str(Path(__file__).resolve().parent.parent))
    import numpy as np
    import torch

    from acg_torch import _build
    from acg_torch.config import SolverOptions
    from acg_torch.ops.dia import DeviceDia
    from acg_torch.ops.dia_kernels import dia_spmv, dia_spmv_batched
    from acg_torch.solvers.cg import build_device_operator, cg, cg_pipelined
    from acg_torch.sparse.csr import manufactured_rhs
    from acg_torch.sparse.poisson import (poisson3d_7pt_dia,
                                          poisson3d_7pt_varcoef)

    tag = {"root": root, "turn": turn}

    def emit(**kw):
        print(json.dumps({**tag, **kw}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    logs = _build.build(("dia_pipe",) if pipe_only else _build.SOURCES)
    build_s = time.perf_counter() - t0
    fns = {}
    for name in ("dia_pipe",) if pipe_only else ("dia_spmv", "dia_hbm_windows",
                                                 "dia_pipe"):
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

    def x_of(dev, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        vdt = getattr(torch, dev.vec_dtype)
        x = torch.zeros(dev.nrows_padded, dtype=vdt, device="cuda")
        x[:dev.nrows] = torch.randn(dev.nrows, generator=gen, device="cuda",
                                    dtype=torch.float64).to(vdt)
        return x

    def kernel(name, cell, with_dot, fn, **extra):
        out = fn()
        y, d = out if with_dot else (out, None)
        ts = _times_ms(fn)
        emit(kernel=name, cell=cell, with_dot=with_dot,
             ms=ts[len(ts) // 2], ms_min=ts[0], ms_max=ts[-1],
             y_sha=_sha(y),
             dot=None if d is None else float(d.reshape(-1)[0]),
             dot_sha=None if d is None else _sha(d), **extra)
        return y

    def spmv(dev, x, with_dot=False):
        # dia_spmv as the operator's plan runs it (a checkout whose
        # DeviceDia has no ``fixed`` has one kernel)
        kw = {"fixed": dev.fixed} if hasattr(dev, "fixed") else {}
        return dia_spmv(dev.bands, dev.scales, dev.offsets_t, x,
                        with_dot=with_dot, **kw)

    def resident(dev, cell, x, dots=(True,)):
        y = None
        for wd in dots:
            y = kernel("dia_spmv", cell, wd,
                       lambda wd=wd: spmv(dev, x, wd),
                       fixed=getattr(dev, "fixed", None))
        if True in dots:
            # the dot's bits on eight more vectors (a last-bit difference
            # shows on some vectors and not on others)
            ds = [spmv(dev, x_of(dev, 100 + s), True)[1] for s in range(8)]
            emit(kernel_bits="dia_spmv", cell=cell,
                 dots_sha=_sha(torch.stack(ds)))
        return y

    def planned(dev, cell, x, want_y):
        if dev.plan is None:
            return
        p = dev.plan
        y = kernel(f"hbm:{p.kind}", cell, True,
                   lambda: dev.matvec_dot(x),
                   plan={"tile": p.tile, "nblocks": p.nblocks,
                         "smem": p.smem,
                         "stages": getattr(p, "stages", None)})
        emit(bits_equal_dia_spmv=bool(torch.equal(y, want_y)), cell=cell)

    from acg_torch.ops import dia_kernels
    from chip_smoke import _peaks

    mem_bw = _peaks(torch.cuda.get_device_name(0))[1][0]
    pipe_bytes = _own_dia_plan().pipe_bytes
    takes_fixed = "fixed" in inspect.signature(
        dia_kernels.cg_pipelined_iter).parameters

    def pipe(dev, cell):
        """cg_pipelined_iter as the plan runs it and, where the checkout
        has the choice, with each kernel forced."""
        from acg_torch.ops.dia_plan import FIXED_BANDS

        vdt = getattr(torch, dev.vec_dtype)
        vecs = [x_of(dev, s) for s in range(2, 8)]
        ab = (torch.tensor(0.37, dtype=vdt, device="cuda"),
              torch.tensor(1.21, dtype=vdt, device="cuda"))
        bodies = [("plan", None)]
        if takes_fixed:
            bodies.append(("generic", False))
            if len(dev.offsets) in FIXED_BANDS:
                bodies.append(("fixed", True))
        nbytes = pipe_bytes(dev.nrows, len(dev.offsets), vdt,
                            dev.bands.dtype)
        for body, fixed in bodies:
            def call(state, w_out, fixed=fixed):
                if fixed is None:
                    return dev.pipelined_iter(*state, *ab, w_out=w_out)
                return dia_kernels.cg_pipelined_iter(
                    dev.bands, dev.scales, dev.offsets_t, *state, *ab,
                    w_out=w_out, fixed=fixed)

            out = call([v.clone() for v in vecs], torch.empty_like(vecs[0]))
            gd = torch.stack([out[6], out[7]])
            allbits = torch.cat([t.reshape(-1) for t in out[:6]] + [gd])
            state = [v.clone() for v in vecs]
            w_out = torch.empty_like(vecs[0])
            ts = _times_ms(lambda: call(state, w_out))
            emit(kernel="cg_pipelined_iter", cell=cell, with_dot=None,
                 body=body, plan_fixed=getattr(dev, "pipe_fixed", None),
                 ms=ts[len(ts) // 2], ms_min=ts[0], ms_max=ts[-1],
                 ms_queued=_queued_ms(lambda: call(state, w_out)),
                 bound_ms=nbytes / mem_bw * 1e3, y_sha=_sha(allbits),
                 dot=float(out[6]), dot_sha=_sha(gd))
            del out, state, w_out
        del vecs
        torch.cuda.empty_cache()

    D256 = poisson3d_7pt_dia(256)
    for tier, vdt, mat in (("bf16/f32", "float32", "auto"),
                           ("int8/f32", "float32", "int8"),
                           ("f64/f64", "float64", None)):
        dev = DeviceDia.from_dia(D256, dtype=vdt, mat_dtype=mat)
        if not pipe_only:
            x = x_of(dev, 1)
            y = resident(dev, f"{tier} 256^3", x, (False, True))
            planned(dev, f"{tier} 256^3", x, y)
            del x, y
            torch.cuda.empty_cache()
        pipe(dev, f"{tier} 256^3")
        if tier == "bf16/f32" and not pipe_only:
            X = torch.stack([x_of(dev, s) for s in range(8)])
            kernel("dia_spmv_batched", f"{tier} 256^3 B=8", True,
                   lambda: dia_spmv_batched(dev.bands, dev.scales,
                                            dev.offsets_t, X, with_dot=True))
            del X
        del dev
        torch.cuda.empty_cache()
    del D256
    for cell, D in (("bf16/f32 128^3", poisson3d_7pt_dia(128)),
                    ("bf16/f32 256x128x128",
                     poisson3d_7pt_dia(128, 128, 256))):
        dev = DeviceDia.from_dia(D, dtype="float32")
        if not pipe_only:
            resident(dev, cell, x_of(dev, 1), (False, True))
        if cell == "bf16/f32 256x128x128":
            pipe(dev, cell + " (the 256^3/4 shard's size)")
        del dev
    # the pipelined solves' other operators: pipelined-dia-f64's, the
    # tridiagonal of rcm-dia-pipelined (after RCM: 4 and -1, bf16 bands
    # at f64), and 64^3, whose iteration fits the L2
    A = poisson3d_7pt_varcoef(128)
    pipe(build_device_operator(A, dtype=np.float64, fmt="auto"),
         "f64/f64 varcoef 128^3")
    del A
    pipe(DeviceDia.from_dia(_tridiagonal(10 ** 6, np.float64),
                            dtype="float64"), "bf16/f64 tridiagonal 10^6")
    D64 = poisson3d_7pt_dia(64)
    for tier, vdt in (("bf16/f32", "float32"), ("f64/f64", "float64")):
        pipe(DeviceDia.from_dia(D64, dtype=vdt,
                                mat_dtype="auto" if vdt == "float32"
                                else None), f"{tier} 64^3")
    del D64
    torch.cuda.empty_cache()
    # the fixed kernel's other band counts at f32 vectors, in three band
    # tiers past the L2 and at bf16 inside it, and 256^3 at f32 bands
    from chip_smoke import _poisson2d_dia

    for name, make, tiers in (
            ("tridiagonal 10^7", lambda: _tridiagonal(10 ** 7), _F32_TIERS),
            ("tridiagonal 10^5", lambda: _tridiagonal(10 ** 5),
             _F32_TIERS[:1]),
            ("2-D 2048^2", lambda: _poisson2d_dia(2048), _F32_TIERS),
            ("2-D 256^2", lambda: _poisson2d_dia(256), _F32_TIERS[:1]),
            ("27 bands 128^3", lambda: _poisson27_dia(128), _F32_TIERS),
            ("27 bands 32^3", lambda: _poisson27_dia(32), _F32_TIERS[:1]),
            ("256^3", lambda: poisson3d_7pt_dia(256, dtype=np.float32),
             _F32_TIERS[2:])):
        D = make()
        for tier, mat in tiers:
            pipe(DeviceDia.from_dia(D, dtype="float32", mat_dtype=mat),
                 f"{tier} {name}")
        del D
        torch.cuda.empty_cache()
    if pipe_only:
        return
    D464 = poisson3d_7pt_dia(464, dtype=np.float32)
    big = DeviceDia.from_dia(D464, dtype="float32")
    del D464
    for vdt in ("float32", "float64"):
        dev = big if vdt == "float32" else DeviceDia.from_bands(
            big.bands, big.scales, big.offsets, big.nrows, big.ncols,
            big.nnz, vdt)
        x = x_of(dev, 1)
        cell = f"bf16/f{vdt[5:]} 464^3"
        y = resident(dev, cell, x, (True,) if vdt == "float32" else ())
        if y is None:
            y = spmv(dev, x)
        planned(dev, cell, x, y)
        del x, y
        torch.cuda.empty_cache()
    if not kernels_only:
        solves(emit, big)
    del big
    torch.cuda.empty_cache()
    dev = DeviceDia.from_dia(_poisson2d_dia(10_000), dtype="float32")
    x = x_of(dev, 1)
    planned(dev, "bf16/f32 10000^2", x, spmv(dev, x))
    del dev, x
    torch.cuda.empty_cache()
    if kernels_only:
        return
    rng = np.random.default_rng(0)

    def solve(phase, op, b, opts, solver=cg):
        solver(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
        res = solver(op, b, options=opts)
        extra = {}
        if solver.__name__.startswith("cg_pipelined"):
            # kernels an iteration: a 100-iteration solve less a
            # 50-iteration one (the set-up's kernels cancel)
            k = [_kernels_in(lambda its=its: solver(
                op, b, options=SolverOptions(maxits=its,
                                             residual_rtol=0.0)))
                 for its in (50, 100)]
            extra["kernels_per_iter"] = (k[1] - k[0]) / 50
        first = getattr(op, "local_ops", [op])[0]
        emit(solve=phase, kernel_path=res.kernel,
             plan=getattr(first, "kind", None),
             pipe_fixed=getattr(getattr(first, "dev", first), "pipe_fixed",
                                None),
             iterations=res.niterations, tsolve_s=res.stats.tsolve,
             us_per_iter=res.stats.tsolve / res.niterations * 1e6,
             rnrm2=res.rnrm2,
             x_sha=_sha(torch.from_numpy(np.ascontiguousarray(res.x))),
             **extra)

    for G in (256, 128):
        D = poisson3d_7pt_dia(G, dtype=np.float32)
        op = build_device_operator(D, dtype=np.float32, fmt="dia")
        b = rng.standard_normal(D.nrows).astype(np.float32)
        solve("dia-bf16" + ("" if G == 256 else f"-{G}"), op, b,
              SolverOptions(maxits=DIA_ITERS, residual_rtol=0.0))
        if G == 256:
            # chip_smoke.py's pipelined-dia-bf16: the same b
            solve("pipelined-dia-bf16", op, b,
                  SolverOptions(maxits=DIA_ITERS, residual_rtol=0.0),
                  cg_pipelined)
        del op
    A = poisson3d_7pt_varcoef(128)
    op = build_device_operator(A, dtype=np.float64, fmt="auto")
    b = manufactured_rhs(A, seed=2)[1]
    solve("dia-f64", op, b, SolverOptions(maxits=20000, residual_rtol=1e-8))
    solve("pipelined-dia-f64", op, b,
          SolverOptions(maxits=20000, residual_rtol=1e-8), cg_pipelined)
    del op, A
    torch.cuda.empty_cache()
    dist_solve(emit, solve)


_F32_TIERS = (("bf16/f32", "auto"), ("int8/f32", "int8"), ("f32/f32", None))


def _tridiagonal(m: int, dtype=None):
    """The 1-D operator tridiag(-1, 4, -1) of m rows in band form
    (float32 bands unless ``dtype`` says otherwise)."""
    import numpy as np

    from acg_torch.ops.dia import DiaMatrix

    tri = np.stack([np.r_[0.0, np.full(m - 1, -1.0)], np.full(m, 4.0),
                    np.r_[np.full(m - 1, -1.0), 0.0]]).astype(
                        dtype or np.float32)
    return DiaMatrix(m, m, (-1, 0, 1), tri, 3 * m - 2)


def _poisson27_dia(nx: int):
    """The 27-point 3-D operator on an nx^3 grid (diagonal 26, every
    neighbour in the 3 x 3 x 3 box -1, Dirichlet) built in band form,
    equal to ``DiaMatrix.from_csr(poisson3d_27pt(nx))`` in its
    values."""
    import numpy as np

    from acg_torch.ops.dia import DiaMatrix

    n = nx ** 3
    i = np.arange(n)
    c = (i // (nx * nx), (i // nx) % nx, i % nx)
    del i
    offs, bands = [], np.zeros((27, -(-n // 8) * 8), dtype=np.float32)
    d = 0
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            for e in (-1, 0, 1):
                offs.append(a * nx * nx + b * nx + e)
                if (a, b, e) == (0, 0, 0):
                    bands[d, :n] = 26.0
                else:
                    ok = np.ones(n, dtype=bool)
                    for k, s in zip(c, (a, b, e)):
                        ok &= (k + s >= 0) & (k + s < nx)
                    bands[d, :n] = np.where(ok, -1.0, 0.0)
                d += 1
    return DiaMatrix(n, n, tuple(offs), bands, int(np.count_nonzero(bands)))


def solves(emit, big):
    """dia-100m and dia-100m-f64 (chip_smoke.py's protocol)."""
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.ops.dia import DeviceDia
    from acg_torch.ops.dia_kernels import dia_matvec
    from acg_torch.solvers.cg import cg

    its32 = None
    for vdt in ("float32", "float64"):
        op = big if vdt == "float32" else DeviceDia.from_bands(
            big.bands, big.scales, big.offsets, big.nrows, big.ncols,
            big.nnz, vdt)
        xs = torch.from_numpy(np.random.default_rng(464).standard_normal(
            op.nrows_padded)).cuda()
        b = dia_matvec(op.bands, op.offsets, xs, op.scales).to(
            getattr(torch, vdt))
        del xs
        f64 = vdt == "float64"
        cg(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
        res = cg(op, b, options=SolverOptions(
            maxits=40 * its32 if f64 else 1500,
            residual_rtol=1e-8 if f64 else 1e-4))
        its32 = its32 or res.niterations
        emit(solve="dia-100m" + ("-f64" if f64 else ""),
             kernel_path=res.kernel, plan=op.kind,
             iterations=res.niterations, tsolve_s=res.stats.tsolve,
             us_per_iter=res.stats.tsolve / res.niterations * 1e6,
             rnrm2=res.rnrm2)
        del op, b
        torch.cuda.empty_cache()


def dist_solve(emit, solve):
    """dist-dia-bf16 and dist-pipelined-dia-bf16: chip_smoke.py's shards
    and protocol."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.parallel.sharded import ShardedSystem
    from acg_torch.partition.graph import partition_system
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.solvers.cg_dist import cg_dist, cg_pipelined_dist
    from acg_torch.sparse.poisson import poisson3d_7pt_dia
    from chip_smoke import _csr_from_dia

    A = _csr_from_dia(poisson3d_7pt_dia(256))
    ps = partition_system(A, partition_graph(A, 4), local_order="band")
    del A
    D = poisson3d_7pt_dia(256)
    ss = ShardedSystem.build(ps, "dia", D.offsets, devices=["cuda:0"] * 4,
                             dtype=np.float32, method="rdma", forced=True)
    b = np.random.default_rng(0).standard_normal(ss.nrows).astype(
        np.float32)
    for name, solver in (("dist-dia-bf16", cg_dist),
                         ("dist-pipelined-dia-bf16", cg_pipelined_dist)):
        solve(name, ss, b, SolverOptions(maxits=DIA_ITERS,
                                         residual_rtol=0.0), solver)


def _summary(lines: list) -> dict:
    """Per case: the medians by root in turn order, and whether every
    root gave the same y (and dot) bits."""
    out = {}
    for ln in lines:
        key = (ln.get("kernel"), ln.get("cell"), ln.get("with_dot"))
        if ln.get("body"):
            key += (ln["body"],)
        if ln.get("kernel"):
            root = Path(ln["root"]).name or "."
            e = out.setdefault(" | ".join(map(str, key)),
                               {"ms": [], "y_sha": set(), "dot_sha": set()})
            e["ms"].append((ln["turn"], root, ln["ms"]))
            e["y_sha"].add(ln["y_sha"])
            e["dot_sha"].add(ln["dot_sha"])
            if "ms_queued" in ln:
                e.setdefault("ms_queued", []).append(
                    (ln["turn"], root, ln["ms_queued"]))
                e["bound_ms"] = ln["bound_ms"]
        if ln.get("body"):
            e = out.setdefault(f"bits of every body and root | "
                               f"{ln['kernel']} | {ln['cell']}",
                               {"y_sha": set(), "dot_sha": set()})
            e["y_sha"].add(ln["y_sha"])
            e["dot_sha"].add(ln["dot_sha"])
        elif ln.get("kernel_bits"):
            e = out.setdefault(f"dots of 8 vectors | {ln['kernel_bits']} | "
                               f"{ln['cell']}", {"dots_sha": set()})
            e["dots_sha"].add(ln["dots_sha"])
        elif ln.get("solve"):
            e = out.setdefault("solve | " + ln["solve"], {"us_per_iter": []})
            e["us_per_iter"].append((ln["turn"], Path(ln["root"]).name or
                                     ".", ln["us_per_iter"],
                                     ln["iterations"],
                                     ln.get("kernels_per_iter")))
            e.setdefault("x_sha", set()).add(ln.get("x_sha"))
    for e in out.values():
        for k in ("y_sha", "dot_sha", "dots_sha", "x_sha"):
            if k in e:
                e[k] = len(e[k])
    return out


def main(argv) -> int:
    mode = ("pipe" if "--pipe-only" in argv else
            "kernels" if "--kernels-only" in argv else "all")
    argv = [a for a in argv if a not in ("--kernels-only", "--pipe-only")]
    if len(argv) >= 1 and argv[0] == "--child":
        _child(argv[1], int(argv[2]), argv[3])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc, lines = 0, []
    for turn, root in enumerate(argv):
        root = str(Path(root).resolve())
        run = subprocess.run([sys.executable, __file__, "--child", root,
                              str(turn), mode],
                             stdout=subprocess.PIPE, text=True,
                             cwd=str(Path(__file__).resolve().parent.parent))
        rc |= run.returncode
        for ln in run.stdout.splitlines():
            print(ln, flush=True)
            if ln.startswith("{"):
                lines.append(json.loads(ln))
    print(json.dumps({"summary": _summary(lines)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
