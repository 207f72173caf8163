#!/usr/bin/env python3
"""Does the multi-RHS kernels' register bound pay?  Build
``acg_torch/csrc/dia_spmv_batched.cu`` and ``stencil_spmv_batched.cu``
three ways and time them on one card:

- ``tree``: the sources as they are (the library ``acg_torch`` builds);
- ``unbounded``: every ``__launch_bounds__(kThreads, K)`` of the two
  files made ``__launch_bounds__(kThreads)`` (ptxas's own register
  choice everywhere);
- ``bounded``: every ``__launch_bounds__(kThreads)`` of the two files
  made ``__launch_bounds__(kThreads, 4)`` (at most 64 registers a thread
  everywhere).

    python scripts/torch_batched_bounds.py

Each variant is built from the tree's text with only that line changed,
into ``build/batched_bounds/``, and run through the port's own wrappers
(``dia_spmv_batched`` through ``DeviceDia``, ``stencil_spmv_batched``):
the 7-point Poisson operator at 256^3, B = 8, DIA bf16/f32, int8/f32 and
f64/f64 and the stencil f32 and f64, each with and without the
per-system dot.  Every variant's Y and dots must equal the tree's bit for
bit.  Prints JSON lines: the card's name and power limit (``nvidia-smi``),
``registers`` (per B = 8 instantiation: registers and spill bytes, from
``-Xptxas -v``), then ``kernel`` (median, min and max of 25 CUDA-event
timings after 3 warm-up calls; three rounds, the variants in turn within
each).  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "batched_bounds"
SOURCES = ("dia_spmv_batched", "stencil_spmv_batched")
G, NRHS, REPS, ROUNDS = 256, 8, 25, 3
_BOUND = re.compile(r"__launch_bounds__\(kThreads(, \w+)?\)")


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def _variant(text: str, how: str) -> str:
    if how == "unbounded":
        return _BOUND.sub("__launch_bounds__(kThreads)", text)
    return _BOUND.sub("__launch_bounds__(kThreads, 4)", text)


def _registers(log: str) -> dict:
    """Registers and spill bytes of each B = 8 instantiation."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        name = block.split("'")[1]
        m = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", name)
        if not m or "Li8" not in m.group(2):
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out[f"{m.group(1)}<{m.group(2)}>"] = [
            int(regs.group(1)) if regs else None,
            int(spill.group(1)) if spill else 0]
    return out


def _build_variants() -> dict:
    """{variant: {source: loaded library}}; the tree's from
    ``_build``, the others compiled here, all nvcc processes at once."""
    from acg_torch import _build

    logs = _build.build(SOURCES)
    libs = {"tree": {}}
    for name in SOURCES:
        libs["tree"][name] = _build.load(name)
        if name in logs:
            _emit(registers="tree", source=name, b8=_registers(logs[name]))
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for how in ("unbounded", "bounded"):
        for name in SOURCES:
            src = OUT / f"{name}_{how}.cu"
            src.write_text(_variant((_build.CSRC / f"{name}.cu").read_text(),
                                    how))
            so = OUT / f"lib{name}_{how}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                   str(_build.CSRC), "-o", str(so), str(src)]
            procs.append((how, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for how, name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"error: {name} ({how}) did not build:\n{log}")
        _emit(registers=how, source=name, b8=_registers(log))
        libs.setdefault(how, {})[name] = ctypes.CDLL(str(so))
    return libs


def _times_ms(fn) -> list:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    from acg_torch.ops import dia_kernels
    from acg_torch.ops import stencil as st
    from acg_torch.ops.dia import DeviceDia
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _emit(card=smi, torch=torch.__version__)
    libs = _build_variants()
    for per in libs.values():
        per["dia_spmv_batched"].acg_dia_spmv_batched.argtypes = (
            dia_kernels._load_batched().acg_dia_spmv_batched.argtypes)
        per["stencil_spmv_batched"].acg_stencil_spmv_batched.argtypes = (
            st._load_batched().acg_stencil_spmv_batched.argtypes)

    def use(how):
        dia_kernels._batched_lib = libs[how]["dia_spmv_batched"]
        st._batched_lib = libs[how]["stencil_spmv_batched"]

    D = poisson3d_7pt_dia(G)
    gen = torch.Generator(device="cuda").manual_seed(3)
    X64 = torch.randn(NRHS, D.nrows_padded, generator=gen, device="cuda",
                      dtype=torch.float64)
    cases = []
    for tier, vdt, mat in (("bf16/f32", torch.float32, "auto"),
                           ("int8/f32", torch.float32, "int8"),
                           ("f64/f64", torch.float64, None)):
        dev = DeviceDia.from_dia(D, dtype=str(vdt)[6:], mat_dtype=mat)
        X = X64.to(vdt).contiguous()
        for wd in (True, False):
            cases.append(("dia_spmv_batched", tier, wd,
                          lambda X=X, dev=dev, wd=wd: (
                              dev.matvec_dot(X) if wd else dev.matvec(X))))
    for vdt in (torch.float32, torch.float64):
        spec, _ = st.recognize_stencil(D, dtype=str(vdt)[6:])
        X = X64.to(vdt).contiguous()
        X[:, D.nrows:] = 0
        for wd in (True, False):
            cases.append(("stencil_spmv_batched",
                          f"matrix-free/{str(vdt)[6:]}", wd,
                          lambda X=X, spec=spec, wd=wd:
                          st.stencil_spmv_batched(spec, X, with_dot=wd)))
    for name, tier, wd, fn in cases:
        use("tree")
        ref = fn()
        for how in ("unbounded", "bounded"):
            use(how)
            out = fn()
            same = (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
                    if wd else torch.equal(out, ref))
            if not same:
                raise SystemExit(f"error: {name} {tier} ({how}): bits differ "
                                 f"from the tree's kernel")
    for rnd in range(ROUNDS):
        for name, tier, wd, fn in cases:
            for how in ("tree", "unbounded", "bounded"):
                use(how)
                ts = _times_ms(fn)
                _emit(kernel=name, tier=tier, nrhs=NRHS, with_dot=wd,
                      variant=how, round=rnd, ms=ts[len(ts) // 2],
                      ms_min=ts[0], ms_max=ts[-1])
    use("tree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
