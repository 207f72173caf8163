#!/usr/bin/env python3
"""Time the ring DIA SpMV and the put+signal halo of one or more
checkouts of the port, each in a process of its own, on one card.

    python scripts/torch_ring_halo_ab.py [--kernels-only]
        [--chunks N,N,...] ROOT [ROOT ...]

ROOT is a checkout's root (the directory that holds ``acg_torch/``).  The
roots run in the order given, so that versions are compared inside one
run on one card, in turns (parent, change, change, parent).  Each child
builds its own kernels (under ROOT/build/) and prints JSON lines tagged
with its root and turn:

- ``build``: the card's name and power limit from ``nvidia-smi``, the
  build seconds, and the registers and spill bytes ``-Xptxas -v``
  reports for every instantiation of the ring and halo kernels;
- ``kernel``: ``dia_spmv_ring`` with the fused dot at the tile and depth
  the checkout's ring plan picks on this card (a plan made for it), the
  windows kernel where its plan has one, and ``dia_spmv`` (the kernel
  the plan's fixed-band rule picks), on 10,000^2 (bf16/f32, bf16/f64 and
  f64/f64, 5-point Poisson in band form) and on 31 bands in 16 offset clusters
  over +-11,783 on 16,000,000 rows (bf16/f32: x alone 64 MB, bands, x
  and y 1.12 GB, past the 50 MB L2); then ``rdma_exchange`` on the
  256^3/4 halo tables (f64, the send blocks gathered from the owned
  vectors beforehand) and the three whole halos (rdma, ppermute,
  allgather) on those shards: the median and range of 25 CUDA-event
  timings after 3 warm-up calls, each around one call (``ms``), the
  median of 5 timings of 25 calls queued back to back, a call
  (``ms_queued``), the host's time a call while queuing them
  (``host_ms``), for the halos the device time a call of their kernels
  under ``torch.profiler`` (``device_ms``; of the put+signal kernel for
  the exchange and the rdma halo), the bound (bytes over the data
  sheet's 3.35 TB/s) and a hash of y and the dot's bits (of the ghosts
  for the halos; equal hashes across roots: the same bits);
- ``chunks`` (with ``--chunks``, in a checkout whose state takes the halo
  tables): the exchange and the rdma halo, queued and their kernel's
  device time, with the state built at each ``MIN_CHUNK`` given, and
  (without ``--kernels-only``) the kernel's device time an iteration
  inside 50 iterations of the dist-stencil-rdma loop, where its vectors
  come from device memory;
- ``solve`` (without ``--kernels-only``): p2d-ring (200 fixed iterations
  on 10,000^2 through the ring on a plan made for it) and
  dist-stencil-rdma (the 256^3 f64 stencil cell in 4 shards on the one
  card, rdma halo, rtol 1e-8, ``chip_smoke.py``'s protocol): kernel
  path, iterations, µs/iter, and for dist-stencil-rdma the CUDA kernels
  an iteration under ``torch.profiler`` (50 fixed iterations).

The parent process repeats every child's lines and ends with a summary
of each case's medians by root and turn and whether the hashes agree
across roots.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

from torch_dia_ab import _ptxas, _sha, _times_ms
from torch_stencil_ab import _queued_ms

REPO = Path(__file__).resolve().parent.parent
MEM_BW = 3.35e12          # H100 SXM data sheet, bytes/s
LIBS = ("dia_hbm_ring", "dia_hbm_windows", "dia_spmv", "rdma_halo",
        "stencil_spmv", "ell_spmv")


def _module(path: Path, name: str):
    """A module of this script's checkout, whatever ROOT is: its builders
    import the package under test (ROOT's) when called."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(fn, match: str, calls: int = 25) -> float:
    """ms of device time a call of the kernels whose name holds ``match``,
    over ``calls`` calls under ``torch.profiler`` (the queued timings of
    a call shorter than the host's time a call measure the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if (match in e.key
                and str(getattr(e, "device_type", "")).endswith("CUDA")):
            us += max(float(getattr(e, attr, 0) or 0) for attr in
                      ("self_device_time_total", "self_cuda_time_total"))
    return us / calls / 1e3


def _child(root: str, turn: int, kernels_only: bool, chunks: list) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from acg_torch import _build
    from acg_torch.ops import dia_plan
    from acg_torch.ops.dia import DeviceDia
    from acg_torch.ops.dia_kernels import (dia_spmv, dia_spmv_ring,
                                           dia_spmv_windows)

    smoke = _module(REPO / "chip_smoke.py", "chip_smoke")
    tiles = _module(REPO / "scripts" / "torch_hbm_tiles.py", "hbm_tiles")
    tag = {"root": root, "turn": turn}

    def emit(**kw):
        print(json.dumps({**tag, **kw}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    logs = _build.build(LIBS)
    emit(card=smi, build_s=time.perf_counter() - t0,
         registers={name: _ptxas(logs.get(name, ""))
                    for name in ("dia_hbm_ring", "rdma_halo")})
    budgets = dia_plan.device_budgets(torch.device("cuda"))

    def kernel(name, cell, fn, nbytes, digest, device=None, **extra):
        ts = _times_ms(fn)
        queued, host = _queued_ms(fn)
        if device is not None:
            extra["device_ms"] = _device_ms(fn, device)
        emit(kernel=name, cell=cell, ms=ts[len(ts) // 2], ms_min=ts[0],
             ms_max=ts[-1], ms_queued=queued, host_ms=host,
             bound_ms=nbytes / MEM_BW * 1e3, sha=digest, **extra)

    def plan_info(p):
        return {"tile": p.tile, "nblocks": p.nblocks, "smem": p.smem,
                "stages": getattr(p, "stages", None) or None,
                **({"span": [p.lo, p.hi]} if p.kind == "hbm-ring" else {})}

    cases = (("10000^2 bf16/f32", lambda: smoke._poisson2d_dia(10_000),
              "float32", "auto"),
             ("10000^2 bf16/f64", lambda: smoke._poisson2d_dia(10_000),
              "float64", "auto"),
             ("10000^2 f64/f64", lambda: smoke._poisson2d_dia(10_000),
              "float64", None),
             ("ring31 16M bf16/f32", lambda: tiles.ring_operator(16_000_000),
              "float32", "auto"))
    for cell, make, vdt, mat in cases:
        D = make()
        if mat == "auto" and vdt == "float64":
            # bf16 bands (exact) with f64 vectors, as dia-100m-f64
            dev = DeviceDia.from_dia(D, dtype="float32")
            dev = DeviceDia.from_bands(dev.bands, dev.scales, dev.offsets,
                                       dev.nrows, dev.ncols, dev.nnz,
                                       "float64")
        else:
            dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat)
        del D
        n, vt = dev.nrows_padded, getattr(torch, vdt)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            n)).to(vt).cuda()
        nbytes = (len(dev.offsets) * n * dev.mat_itemsize
                  + 2 * n * x.element_size())
        fixed = dia_plan.resident_fixed(n, len(dev.offsets), vt,
                                        dev.bands.dtype, budgets)
        ref = dia_spmv(dev.bands, dev.scales, dev.offsets_t, x)
        runs = [("dia_spmv", None, lambda: dia_spmv(
            dev.bands, dev.scales, dev.offsets_t, x, with_dot=True,
            fixed=fixed))]
        for kind, pick, spmv in (("hbm-ring", dia_plan.ring_plan,
                                  dia_spmv_ring),
                                 ("hbm", dia_plan.windows_plan,
                                  dia_spmv_windows)):
            tile = pick(n, dev.offsets, vt, dev.bands.dtype, budgets)
            if tile is None:
                continue
            plan = dia_plan.make_plan(kind, tile, n, dev.offsets, vt,
                                      dev.bands.dtype, budgets,
                                      device=x.device)
            runs.append((spmv.__name__, plan,
                         lambda spmv=spmv, plan=plan: spmv(
                             dev.bands, dev.scales, dev.offsets_t, x, plan,
                             with_dot=True)))
        for name, plan, fn in runs:
            y, d = fn()
            kernel(name, cell, fn, nbytes, _sha(y),
                   dot_sha=_sha(d), bits_equal_dia_spmv=bool(
                       torch.equal(y, ref)),
                   planned=(dev.kind if plan is None else
                            dev.plan is not None
                            and dev.plan.kind == plan.kind),
                   **({} if plan is None else {"plan": plan_info(plan)}))
        del dev, x, ref, runs
        torch.cuda.empty_cache()
    halo_cases(emit, kernel, smoke, chunks, kernels_only)


def _in_loop(smoke, ss, b) -> dict:
    """The rdma halo inside the dist-stencil-rdma loop (its vectors out of
    the L2 between exchanges): 50 fixed iterations under
    ``torch.profiler``, the put+signal kernel's device µs an iteration,
    and µs/iter of the same 50 iterations without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from acg_torch.solvers.cg_dist import cg_dist

    res = smoke._fixed_solve(cg_dist, ss, b, 50)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        smoke._fixed_solve(cg_dist, ss, b, 50)
    us = sum(smoke._device_us(e) for e in prof.key_averages()
             if "rdma" in e.key
             and str(getattr(e, "device_type", "")).endswith("CUDA"))
    return {"loop_rdma_device_us_per_iter": us / 50,
            "loop_us_per_iter": res.stats.tsolve / 50 * 1e6}


def halo_cases(emit, kernel, smoke, chunks, kernels_only):
    """rdma_exchange, the three halos and, without kernels_only, the
    dist-stencil-rdma and p2d-ring solves."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acg_torch.config import SolverOptions
    from acg_torch.parallel import rdma_halo
    from acg_torch.parallel.halo import halo_allgather, halo_ppermute
    from acg_torch.partition.graph import partition_system
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.solvers.cg_dist import build_sharded, cg_dist
    from acg_torch.sparse.csr import manufactured_rhs
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    D = poisson3d_7pt_dia(256)
    _, b = manufactured_rhs(D, seed=1)
    A = smoke._csr_from_dia(D)
    del D
    ps = partition_system(A, partition_graph(A, 4), local_order="band")
    del A
    ss = build_sharded(ps, devices=["cuda:0"] * 4, dtype=np.float64,
                       method="rdma")
    st, state = ss.tables, ss.rdma
    P, R, S = ss.nparts, st.partner.shape[1], st.max_msg
    gen = torch.Generator(device="cuda").manual_seed(7)
    xs = [torch.randn(o.nrows_padded, generator=gen, dtype=torch.float64,
                      device="cuda") for o in ss.local_ops]
    word = 8
    nghost = sum(st.nghost)
    if hasattr(state, "send"):          # a state that stages the blocks
        send = state.send
        for xi, idx, buf in zip(xs, st.send_full, send):
            torch.index_select(xi, 0, idx, out=buf.view(-1))
    else:
        send = [xi[idx].view(R, S) for xi, idx in zip(xs, st.send_full)]
    cell = "f64 256^3/4"
    info = {"P": P, "R": R, "S": S, "C": state.C,
            "scope": getattr(state, "scope", "sys")}
    exchange_bytes = 2 * P * R * S * word
    halo_bytes = P * R * S * word + nghost * word + 2 * P * R * S * 4
    out = rdma_halo.rdma_exchange(send, st.partner, state)
    kernel("rdma_exchange", cell,
           lambda: rdma_halo.rdma_exchange(send, st.partner, state),
           exchange_bytes, _sha(torch.stack(out)), device="rdma", **info)
    for method, fn in (("rdma", lambda: rdma_halo.halo_rdma(xs, st, state)),
                       ("ppermute", lambda: halo_ppermute(xs, st)),
                       ("allgather", lambda: halo_allgather(xs, st))):
        kernel(f"halo {method}", cell, fn,
               halo_bytes if method == "rdma" else 0,
               _sha(torch.cat(fn())), device="" if method != "rdma"
               else "rdma", **info)
    state.check()
    fused = "tables" in inspect.signature(rdma_halo.RdmaState).parameters
    if chunks and fused:
        keep = rdma_halo.MIN_CHUNK
        for c in chunks:
            rdma_halo.MIN_CHUNK = c
            s2 = rdma_halo.RdmaState(st.partner, S, torch.float64,
                                     ss.devices, tables=st)
            q_ex, _ = _queued_ms(lambda: rdma_halo.rdma_exchange(
                send, st.partner, s2))
            q_halo, _ = _queued_ms(lambda: rdma_halo.halo_rdma(xs, st, s2))
            one = _times_ms(lambda: rdma_halo.halo_rdma(xs, st, s2))
            dev_ex = _device_ms(lambda: rdma_halo.rdma_exchange(
                send, st.partner, s2), "rdma")
            dev_halo = _device_ms(lambda: rdma_halo.halo_rdma(xs, st, s2),
                                  "rdma")
            loop = {} if kernels_only else _in_loop(
                smoke, dataclasses.replace(ss, rdma=s2), b)
            s2.check()
            emit(chunks=c, C=s2.C, chunk_words=s2.chunk,
                 grid_blocks=P * R * s2.C, exchange_ms_queued=q_ex,
                 halo_ms_queued=q_halo, halo_ms=one[len(one) // 2],
                 exchange_device_ms=dev_ex, halo_device_ms=dev_halo,
                 **loop,
                 halo_sha=_sha(torch.cat(rdma_halo.halo_rdma(xs, st, s2))))
        rdma_halo.MIN_CHUNK = keep
    if kernels_only:
        return
    cg_dist(ss, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    res = cg_dist(ss, b, options=SolverOptions(maxits=20000,
                                               residual_rtol=1e-8))
    smoke._fixed_solve(cg_dist, ss, b, 50)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fixed = smoke._fixed_solve(cg_dist, ss, b, 50)
    nk = sum(e.count for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             and smoke._device_us(e) > 0
             and not e.key.startswith(("Memcpy", "Memset")))
    emit(solve="dist-stencil-rdma", kernel_path=res.kernel,
         iterations=res.niterations,
         us_per_iter=res.stats.tsolve / res.niterations * 1e6,
         kernels_per_iter=nk / fixed.niterations,
         converged=bool(res.converged))
    del ss, xs, send, state
    torch.cuda.empty_cache()
    p2d_ring(emit, smoke)


def p2d_ring(emit, smoke):
    """200 fixed iterations of classic CG on 10,000^2 (bf16/f32) through
    the ring on a plan made for it, b = A x* (chip_smoke.py's p2d-ring)."""
    import dataclasses

    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.ops import dia_plan
    from acg_torch.ops.dia_kernels import dia_matvec
    from acg_torch.solvers.cg import build_device_operator, cg

    op = build_device_operator(smoke._poisson2d_dia(10_000),
                               dtype=np.float32, fmt="dia")
    budgets = dia_plan.device_budgets(op.device)
    n = op.nrows_padded
    tile = dia_plan.ring_plan(n, op.offsets, torch.float32, op.bands.dtype,
                              budgets)
    op = dataclasses.replace(op, plan=dia_plan.make_plan(
        "hbm-ring", tile, n, op.offsets, torch.float32, op.bands.dtype,
        budgets, device=op.device))
    xstar = torch.from_numpy(np.random.default_rng(10_000).standard_normal(
        n)).cuda()
    b = dia_matvec(op.bands, op.offsets, xstar, op.scales).float()
    del xstar
    cg(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    res = cg(op, b, options=SolverOptions(maxits=200, residual_rtol=0.0))
    emit(solve="p2d-ring", kernel_path=res.kernel, iterations=res.niterations,
         us_per_iter=res.stats.tsolve / res.niterations * 1e6,
         rnrm2=float(res.rnrm2))


def _summary(lines: list) -> dict:
    """Per case: the medians by root in turn order, and whether every
    root gave the same bits."""
    out = {}
    for ln in lines:
        who = (ln["turn"], Path(ln["root"]).name or ".")
        if ln.get("kernel"):
            key = f"{ln['kernel']} | {ln['cell']}"
            e = out.setdefault(key, {"ms": [], "ms_queued": [], "sha": set(),
                                     "bound_ms": ln["bound_ms"]})
            e["ms"].append((*who, ln["ms"]))
            e["ms_queued"].append((*who, ln["ms_queued"], ln["host_ms"]))
            if "device_ms" in ln:
                e.setdefault("device_ms", []).append((*who,
                                                      ln["device_ms"]))
            e["sha"].add(ln["sha"])
        elif ln.get("solve"):
            e = out.setdefault("solve | " + ln["solve"], {"us_per_iter": []})
            e["us_per_iter"].append((*who, ln["us_per_iter"],
                                     ln["iterations"],
                                     ln.get("kernels_per_iter")))
    for e in out.values():
        if "sha" in e:
            e["sha"] = len(e["sha"])
    return out


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    argv = [a for a in argv if a != "--kernels-only"]
    chunks = []
    if "--chunks" in argv:
        i = argv.index("--chunks")
        chunks = [int(c) for c in argv[i + 1].split(",")]
        del argv[i: i + 2]
    if len(argv) >= 1 and argv[0] == "--child":
        _child(argv[1], int(argv[2]), argv[3] == "1",
               [int(c) for c in argv[4].split(",") if c])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc, lines = 0, []
    for turn, root in enumerate(argv):
        root = str(Path(root).resolve())
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--child", root,
                              str(turn), "1" if kernels_only else "0",
                              ",".join(map(str, chunks))],
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
