#!/usr/bin/env python3
"""Time the one-vector DIA SpMV kernels and the DIA solves of one or more
checkouts of the port, each in a process of its own, on one card.

    python scripts/torch_dia_ab.py [--kernels-only] ROOT [ROOT ...]

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
  and f64 vectors, 10,000^2 bf16/f32), ``cg_pipelined_iter`` and
  ``dia_spmv_batched`` (B = 8) at 256^3 bf16/f32: the median and range
  of 25 CUDA-event timings after 3 warm-up calls, the plan, and a hash
  of y and the dot's bits (equal hashes across roots: the same bits);
- ``solve`` (without ``--kernels-only``): dia-bf16 (256^3, 1000 fixed
  iterations, planned), dia-bf16-128 (resident), dia-f64 (varcoef 128^3,
  rtol 1e-8), dia-100m (464^3, rtol 1e-4), dia-100m-f64 (rtol 1e-8) and
  dist-dia-bf16 (4 shards of 256^3 on the one card, bf16 bands, rdma,
  1000 fixed iterations): kernel path, iterations, µs/iter.

The parent process repeats every child's lines and ends with a summary
of each case's medians by root and whether the y and dot hashes agree
across roots.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
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


def _child(root: str, turn: int, kernels_only: bool) -> None:
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
    from acg_torch.solvers.cg import build_device_operator, cg
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
    logs = _build.build()
    build_s = time.perf_counter() - t0
    fns = {}
    for name in ("dia_spmv", "dia_hbm_windows"):
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

    D256 = poisson3d_7pt_dia(256)
    for tier, vdt, mat in (("bf16/f32", "float32", "auto"),
                           ("int8/f32", "float32", "int8"),
                           ("f64/f64", "float64", None)):
        dev = DeviceDia.from_dia(D256, dtype=vdt, mat_dtype=mat)
        x = x_of(dev, 1)
        y = resident(dev, f"{tier} 256^3", x, (False, True))
        planned(dev, f"{tier} 256^3", x, y)
        if tier == "bf16/f32":
            w = [x_of(dev, s) for s in range(2, 8)]
            kernel("cg_pipelined_iter", f"{tier} 256^3", None,
                   lambda: dev.pipelined_iter(*w, torch.tensor(
                       0.37, device="cuda"), torch.tensor(1.21,
                                                          device="cuda"))[0])
            X = torch.stack([x_of(dev, s) for s in range(8)])
            kernel("dia_spmv_batched", f"{tier} 256^3 B=8", True,
                   lambda: dia_spmv_batched(dev.bands, dev.scales,
                                            dev.offsets_t, X, with_dot=True))
            del w, X
        del dev, x, y
        torch.cuda.empty_cache()
    del D256
    for cell, D in (("bf16/f32 128^3", poisson3d_7pt_dia(128)),
                    ("bf16/f32 256x128x128",
                     poisson3d_7pt_dia(128, 128, 256))):
        dev = DeviceDia.from_dia(D, dtype="float32")
        resident(dev, cell, x_of(dev, 1), (False, True))
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
    from chip_smoke import _poisson2d_dia

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
        emit(solve=phase, kernel_path=res.kernel, plan=getattr(op, "kind",
                                                               None),
             iterations=res.niterations, tsolve_s=res.stats.tsolve,
             us_per_iter=res.stats.tsolve / res.niterations * 1e6,
             rnrm2=res.rnrm2)

    for G in (256, 128):
        D = poisson3d_7pt_dia(G, dtype=np.float32)
        op = build_device_operator(D, dtype=np.float32, fmt="dia")
        b = rng.standard_normal(D.nrows).astype(np.float32)
        solve("dia-bf16" + ("" if G == 256 else f"-{G}"), op, b,
              SolverOptions(maxits=DIA_ITERS, residual_rtol=0.0))
        del op
    A = poisson3d_7pt_varcoef(128)
    op = build_device_operator(A, dtype=np.float64, fmt="auto")
    b = manufactured_rhs(A, seed=2)[1]
    solve("dia-f64", op, b, SolverOptions(maxits=20000, residual_rtol=1e-8))
    del op, A
    torch.cuda.empty_cache()
    dist_solve(emit, solve)


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
    """dist-dia-bf16: chip_smoke.py's shards and protocol."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.parallel.sharded import ShardedSystem
    from acg_torch.partition.graph import partition_system
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.solvers.cg_dist import cg_dist
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
    solve("dist-dia-bf16", ss, b,
          SolverOptions(maxits=DIA_ITERS, residual_rtol=0.0), cg_dist)


def _summary(lines: list) -> dict:
    """Per case: the medians by root in turn order, and whether every
    root gave the same y (and dot) bits."""
    out = {}
    for ln in lines:
        key = (ln.get("kernel"), ln.get("cell"), ln.get("with_dot"))
        if ln.get("kernel"):
            e = out.setdefault(" | ".join(map(str, key)),
                               {"ms": [], "y_sha": set(), "dot_sha": set()})
            e["ms"].append((ln["turn"], Path(ln["root"]).name or ".",
                            ln["ms"]))
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
                              str(turn), "1" if kernels_only else "0"],
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
