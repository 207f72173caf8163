"""Sweep the sliced SpMV kernels' unroll U and row-sort window sigma on
the fem3d-1m operators, on an NVIDIA GPU.

The kernels (acg_torch/csrc/sgell_spmv.cu and ell_spmv.cu, both on the
core csrc/sliced_spmv.cuh) issue the value and column loads of U entries
of a row before their gathers of x; U is the macro ACG_SLICED_UNROLL (4
unless set).  The layout (acg_torch/ops/sliced.py) sorts rows by length
inside windows of sigma rows (sigma = 1: no sort).  This script compiles
both libraries at every U, all at once, builds the configuration of
``chip_smoke.py``'s fem3d-1m (``fem_delaunay_spd(points, dim=3, seed=0,
shuffle=True)``) and times, at each (U, sigma), with CUDA events, median
of 25, over interleaved rounds:

- sgell_spmv on the sgell pack of the RCM-ordered matrix, f32 values;
- ell_spmv on the ELL rectangle of the shuffled matrix, f64 and f32;
- ell_spmv on the ELL rectangle of the RCM-ordered matrix, f32 (the same
  matrix and ordering as sgell: the fill gate's question);

each beside cuSPARSE CSR x (``torch.sparse``) on the same matrix in the
same ordering, and the bound: stored entries x (value + 4) + x + y bytes
over the card's 3.35 TB/s.  Every configuration must give the bits of
``sliced_matvec``, and sgell those of ``sgell_matvec`` on the pack.

Prints the card's name and power limit, one JSON line per (round, case,
sigma, U) and a summary line.  Imports nothing of JAX.

Run on the card: python scripts/torch_sliced_sweep.py [points] [U ...]
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from acg_torch import _build  # noqa: E402
from acg_torch.ops import sgell, sliced, spmv  # noqa: E402
from acg_torch.sparse.ell import EllMatrix  # noqa: E402
from acg_torch.sparse.mesh import fem_delaunay_spd  # noqa: E402
from acg_torch.sparse.rcm import permute_symmetric, rcm_order  # noqa: E402

ROUNDS = 2
REPS = 25
SIGMAS = (1, 1024)
MEM_BW = 3.35e12            # H100 SXM data sheet, bytes/s


def _time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[REPS // 2]


def build_variants(unrolls, out_dir: Path) -> dict:
    """{(name, U): (library path, registers, spill bytes)}: one nvcc per
    library, started together; each library must report the U it was
    built with."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for u in unrolls:
        for name in ("sgell_spmv", "ell_spmv"):
            out = out_dir / f"lib{name}_u{u}.so"
            cmd = [nvcc, *_build.NVCC_FLAGS, f"-DACG_SLICED_UNROLL={u}",
                   "-o", str(out), str(_build.CSRC / f"{name}.cu")]
            procs[name, u] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    built = {}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"error: nvcc for {key} failed:\n{log}")
        if ctypes.CDLL(str(out)).acg_sliced_unroll() != key[1]:
            raise SystemExit(f"error: {out} was not built with U {key[1]}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", log))
        built[key] = (out, max(regs) if regs else None, spills)
    return built


def use_library(module, name: str, path: Path) -> None:
    """Route ``module``'s wrapper through the library at ``path``."""
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, f"acg_{name}")
    fn.restype, fn.argtypes = sliced.c_signature()
    module._lib = lib


def _csr(A, dtype):
    with warnings.catch_warnings():      # sparse tensors warn they are beta
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(
            torch.from_numpy(A.rowptr.astype(np.int64)),
            torch.from_numpy(A.colidx.astype(np.int64)),
            torch.from_numpy(A.vals).to(dtype), size=(A.nrows, A.ncols)
        ).cuda()


def _ell_case(A, vdt):
    E = EllMatrix.from_csr(A)
    vals = torch.from_numpy(E.vals.astype(vdt)).cuda()
    cols = torch.from_numpy(E.colidx).cuda()
    return vals, cols, E.nrows_padded


def main():
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device")
    points = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    unrolls = [int(a) for a in sys.argv[2:]] or [1, 2, 4, 8]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else
          "nvidia-smi: not available", flush=True)
    built = build_variants(unrolls, Path(_build.BUILD_DIR) / "sweep")
    t0 = time.perf_counter()
    A = fem_delaunay_spd(points, dim=3, seed=0, shuffle=True)
    Ap = permute_symmetric(A, rcm_order(A))
    pack = sgell.build_device_sgell(Ap, dtype=np.float32, device="cuda")
    if pack is None:
        raise SystemExit("error: the RCM-ordered matrix did not pack")
    cases = {}     # name: (module, kernel, {sigma: op}, x, plain, csr)
    for name, M, vdt in (("ell-f64", A, np.float64),
                         ("ell-f32", A, np.float32),
                         ("ell-f32-rcm", Ap, np.float32)):
        vals, cols, npad = _ell_case(M, vdt)
        ops = {s: sliced.slice_ell(vals, cols, M.ncols, sigma=s)
               for s in SIGMAS}
        x = torch.zeros(npad, dtype=getattr(torch, np.dtype(vdt).name))
        x[: M.nrows] = torch.from_numpy(
            np.random.default_rng(6).standard_normal(M.nrows))
        x = x.cuda()
        cases[name] = (spmv, "ell_spmv", ops, x,
                       spmv.ell_matvec(vals, cols, x), _csr(M, x.dtype),
                       M.nrows)
        del vals, cols
    x = torch.zeros(pack.nrows_padded, dtype=torch.float32)
    x[: Ap.nrows] = torch.from_numpy(
        np.random.default_rng(5).standard_normal(Ap.nrows))
    x = x.cuda()
    # the operator keeps its pack on the host: upload it to cut and check
    dpk = [a.cuda() for a in (pack.vals, pack.idx, pack.seg,
                              pack.tile_start)]
    cases["sgell-f32-rcm"] = (
        sgell, "sgell_spmv",
        {s: sgell.slice_pack(*dpk, sigma=s) for s in SIGMAS},
        x, sgell.sgell_matvec(*dpk, x), _csr(Ap, torch.float32), Ap.nrows)
    del dpk
    torch.cuda.synchronize()
    print(json.dumps({"points": points, "nnz": A.nnz,
                      "setup_s": time.perf_counter() - t0,
                      "pack_fill": pack.fill,
                      "layouts": {c: {s: {"fill": op.fill,
                                          "stream_bytes": op.stream_bytes()}
                                      for s, op in v[2].items()}
                                  for c, v in cases.items()},
                      "registers": {f"{k[0]}:U{k[1]}": v[1]
                                    for k, v in built.items()},
                      "spill_bytes": {f"{k[0]}:U{k[1]}": v[2]
                                      for k, v in built.items()}}),
          flush=True)
    times = {}
    library = {}
    for rnd in range(ROUNDS):
        for case, (mod, kname, ops, x, plain, csr, n) in cases.items():
            library.setdefault(case, []).append(_time_ms(lambda: csr @ x[:n]))
            for u in unrolls:
                use_library(mod, kname, built[kname, u][0])
                wrapper = getattr(mod, kname)
                for s, op in ops.items():
                    y = wrapper(op, x)
                    same = bool(torch.equal(y, sliced.sliced_matvec(op, x)))
                    if kname == "sgell_spmv":
                        same = same and bool(torch.equal(y, plain))
                    err = float((y - plain).abs().max()
                                / plain.abs().max())
                    ms = _time_ms(lambda: wrapper(op, x))
                    times.setdefault((case, s, u), []).append(ms)
                    print(json.dumps({"round": rnd, "case": case,
                                      "sigma": s, "unroll": u, "ms": ms,
                                      "bits_equal": same,
                                      "rel_err_plain": err}), flush=True)
                    if not same:
                        raise SystemExit(f"error: {case} sigma {s} {u} "
                                         "differs from its plain version")
    summary = {}
    for case, (mod, kname, ops, x, plain, csr, n) in cases.items():
        op = ops[SIGMAS[0]]
        work = (op.nnz * (op.vals.element_size() + 4)
                + (op.ncols + op.nrows) * x.element_size())
        summary[case] = {
            "bound_ms": work / MEM_BW * 1e3,
            "cusparse_ms": min(library[case]),
            "ms": {f"sigma={s},U={u}": min(times[case, s, u])
                   for s in SIGMAS for u in unrolls}}
        best = min(summary[case]["ms"], key=summary[case]["ms"].get)
        summary[case]["best"] = best
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
