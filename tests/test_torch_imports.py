"""The port stands alone: nothing under ``acg_torch/`` (nor
``chip_smoke.py``) imports JAX or the JAX package, the kernels' sources
are in the tree, and the kernel build raises without ``nvcc`` instead of
falling back to the plain versions."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "acg_tpu")


def _port_files():
    files = sorted((REPO / "acg_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(_FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys; import acg_torch, acg_torch.solvers.cg, "
            "acg_torch.solvers.cg_host, acg_torch.solvers.baseline, "
            "acg_torch.solvers.cg_dist, acg_torch.cli, acg_torch.convert, "
            "acg_torch._build, acg_torch.sparse.mesh, acg_torch.sparse.rcm, "
            "acg_torch.parallel.deep, acg_torch.tools.mtxpartition; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", ["dia_spmv", "stencil_spmv", "dia_pipe",
                                  "stencil_pipe", "dia_spmv_batched",
                                  "stencil_spmv_batched", "ell_spmv",
                                  "sgell_spmv", "dia_hbm_ring",
                                  "dia_hbm_windows"])
def test_kernel_sources_exist(name):
    from acg_torch import _build

    assert name in _build.SOURCES
    src = _build.CSRC / f"{name}.cu"
    text = src.read_text()
    assert 'extern "C"' in text
    # the header note: what it replaces and what bounds it
    assert "Replaces the TPU kernel" in text
    assert "Bound on this card" in text


def test_library_path_tracks_the_source(tmp_path, monkeypatch):
    from acg_torch import _build

    before = _build.library_path("dia_spmv")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.library_path("dia_spmv") == before
    (csrc / "dia_spmv.cu").write_text(
        (csrc / "dia_spmv.cu").read_text() + "\n// changed\n")
    assert _build.library_path("dia_spmv") != before


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    from acg_torch import _build
    from acg_torch.errors import AcgError, Status

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(AcgError, match="nvcc not found") as e:
        _build.load("dia_spmv")
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(AcgError):
        _build.build()
