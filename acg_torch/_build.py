"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ``ctypes``.  Libraries go into
``build/acg_torch_kernels/`` beside the package, named by a hash of the
sources and flags: a changed source builds anew, an unchanged one is
reused.  :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for them together.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from acg_torch.errors import AcgError, Status

SOURCES = ("dia_spmv", "stencil_spmv", "dia_pipe", "stencil_pipe",
           "dia_spmv_batched", "stencil_spmv_batched", "ell_spmv",
           "sgell_spmv", "dia_hbm_ring", "dia_hbm_windows", "rdma_halo",
           "cg_update", "sstep_coeffs", "deep_coeffs")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parent.parent / "build"
             / "acg_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``); raises ``ERR_NOT_SUPPORTED`` when neither
    exists."""
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise AcgError(Status.ERR_NOT_SUPPORTED,
                   "nvcc not found (not on PATH, nor under CUDA_HOME="
                   f"{home!r}): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives, keyed by a hash of
    that source, the shared headers and the compiler flags."""
    h = hashlib.sha256()
    for p in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: compiler log}`` for the sources compiled (the ``-Xptxas -v``
    register and spill report); raises on the first failure."""
    pending = [(n, library_path(n)) for n in names]
    pending = [(n, p) for n, p in pending if not p.exists()]
    if not pending:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in pending:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first when
    needed (cached per process)."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
