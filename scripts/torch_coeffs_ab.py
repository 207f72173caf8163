#!/usr/bin/env python3
"""Checkouts in turns: the two coefficient kernels on one GPU.

    python scripts/torch_coeffs_ab.py [--kernels-only] ROOT [ROOT ...]

Run from the repository root, e.g. ``build/parent . . build/parent``
(unpack the parent with ``git archive HEAD | tar -x -C build/parent``).
For each ROOT it compiles that checkout's ``acg_torch/csrc/deep_coeffs.cu``
and ``sstep_coeffs.cu`` (nvcc, all at once, into ``build/coeffs_ab/``),
then, in one process and in the order given, runs this checkout's
wrappers on each ROOT's libraries (their C entry points are the same;
the s-step kernel gets the shared memory of the ROOT's own
``smem_bytes``):

- ``deep_coeffs`` at f64, B = 1, l = 2..8 and ``sstep_coeffs`` at
  ``chip_smoke.py``'s kernel rows (f64 s = 4 B = 1 and B = 8, f32 s = 4
  B = 1) on the kernels phase's inputs: ``ms_graph`` (32 launches in one
  CUDA graph, replayed between CUDA events, over 32), ``ms`` one call
  and ``ms_queued``, and the outputs after a fixed sequence of calls
  (ten deep bodies; one s-step block), hashed (equal hashes: equal
  bits across ROOTs);
- the empty kernel's graph node (``graph_node_ms``), the same measure;
- without ``--kernels-only``, the coeffs-small phase's solves (deep and
  s-step CG on the 64^3 f64 Poisson system, rtol 1e-8, the graph loop):
  iterations, µs an iteration, the coefficient kernel's device µs an
  iteration from the profiler, x's hash.

A ROOT needs only ``acg_torch/csrc/`` and ``acg_torch/ops/sstep_coeffs.py``:
a variant of a kernel is such a copy with the source edited, timed as
one more ROOT (``--kernels-only`` where the variant breaks the solves).

One JSON line per (ROOT, kernel or solve), each with the card's name
and power limit, then a summary line that says, per row, whether every
ROOT's hash agrees.  It imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

NAMES = ("deep_coeffs", "sstep_coeffs")
DEPTHS = (2, 3, 4, 5, 6, 7, 8)
SSTEP_ROWS = (("f64", 1), ("f64", 8), ("f32", 1))


def _build(roots) -> dict:
    """{(root, name): library path}, every source compiled at once."""
    from acg_torch import _build as b

    procs = {}
    for i, root in enumerate(roots):
        out = REPO / "build" / "coeffs_ab" / f"{i}"
        out.mkdir(parents=True, exist_ok=True)
        for name in NAMES:
            lib = out / f"lib{name}.so"
            src = Path(root) / "acg_torch" / "csrc" / f"{name}.cu"
            procs[(root, name)] = (lib, subprocess.Popen(
                [b.nvcc_path(), *b.NVCC_FLAGS, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"error: {key} did not build:\n{log}")
        print(json.dumps({"root": key[0], "built": key[1],
                          "functions": cs._ptxas_report(log)}), flush=True)
        libs[key] = lib
    return libs


def _smem_rule(root: str):
    """The ROOT's own ``smem_bytes`` (its ops/sstep_coeffs.py)."""
    path = Path(root) / "acg_torch" / "ops" / "sstep_coeffs.py"
    spec = importlib.util.spec_from_file_location(
        f"_sstep_coeffs_{abs(hash(str(path.resolve())))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.smem_bytes


def _use(root: str, libs: dict, rules: dict) -> None:
    """Point this checkout's two wrappers at ROOT's libraries."""
    from acg_torch.ops import deep_coeffs as dc
    from acg_torch.ops import sstep_coeffs as sc

    dc._lib = dc._lib_of(ctypes.CDLL(str(libs[(root, "deep_coeffs")])))
    sc._lib = sc._lib_of(ctypes.CDLL(str(libs[(root, "sstep_coeffs")])))
    sc.smem_bytes = rules[root]


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _deep_rows(root, reps):
    import torch

    from acg_torch.ops import deep_coeffs as dc

    out = []
    for l in DEPTHS:
        w = 2 * l + 1
        got = cs._deep_inputs(l)
        for t in range(10):
            dc.deep_coeffs(**got, l=l, t=t, hh=t % l, hv=t % (w - 1),
                           at_check=t % 3 == 2, guard=True, any_crit=True)
        torch.cuda.synchronize()
        st = cs._deep_inputs(l)
        kw = dict(l=l, t=l + 1, hh=1, hv=3 % (w - 1), at_check=False,
                  guard=False, any_crit=True)
        out.append({"root": root, "kernel": "deep_coeffs",
                    "tier": f"f64 l={l} B=1",
                    "ms_graph": cs._graph_ms(lambda: dc.deep_coeffs(**st,
                                                                    **kw)),
                    "ms": cs._time_ms(lambda: dc.deep_coeffs(**st, **kw),
                                      reps),
                    "ms_queued": cs._queued_ms(lambda: dc.deep_coeffs(
                        **st, **kw)),
                    "sha": _sha(got.values())})
    return out


def _sstep_rows(root, reps):
    import torch

    from acg_torch.ops import sstep_coeffs as sc

    s, maxits = 4, 100000
    out = []
    for tier, nsys in SSTEP_ROWS:
        dt = torch.float64 if tier == "f64" else torch.float32
        state = cs._sstep_inputs(s, nsys, maxits, dt)
        got = state()
        sc.sstep_coeffs(**got, s=s, maxits=maxits, any_crit=False)
        torch.cuda.synchronize()
        st = state()

        def run():
            sc.sstep_coeffs(**st, s=s, maxits=maxits, any_crit=False)

        out.append({"root": root, "kernel": "sstep_coeffs",
                    "tier": f"{tier} s={s} B={nsys}",
                    "ms_graph": cs._graph_ms(run),
                    "ms": cs._time_ms(run, reps),
                    "ms_queued": cs._queued_ms(run),
                    "sha": _sha(got.values())})
    return out


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    argv = [a for a in argv if a != "--kernels-only"]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    roots = [str(Path(r)) for r in argv]
    libs = _build(list(dict.fromkeys(roots)))
    rules = {r: _smem_rule(r) for r in dict.fromkeys(roots)}
    empty_lib, proc = cs._empty_kernel_build()
    lb = cs._latency_bound(empty_lib, proc, {"rows": [], "reps": 25})
    print(json.dumps({"gpu": smi, "graph_node_ms": lb["graph_node_ms"],
                      "graph_replay_ms_queued":
                          lb["graph_replay_ms_queued"]}), flush=True)
    op, b, edge = (None, None, None) if kernels_only else cs._small_case()
    rows = []
    for root in roots:
        _use(root, libs, rules)
        for row in _deep_rows(root, 25) + _sstep_rows(root, 25):
            row["gpu"] = smi
            print(json.dumps(row), flush=True)
            rows.append(row)
        solves = {} if kernels_only else cs._small_solves(op, b, edge)
        for name, rep in solves.items():
            row = {"root": root, "solve": f"{name} {edge}^3", "gpu": smi,
                   **rep}
            print(json.dumps(row), flush=True)
            rows.append({**row, "sha": rep["x_sha"]})
        torch.cuda.synchronize()
    groups = {}
    for row in rows:
        key = row.get("kernel", row.get("solve")) + " " + row.get("tier", "")
        groups.setdefault(key.strip(), set()).add(row["sha"])
    print(json.dumps({"summary": {k: len(v) == 1 for k, v in
                                  groups.items()},
                      "roots": roots, "gpu": smi,
                      "pid": os.getpid()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
