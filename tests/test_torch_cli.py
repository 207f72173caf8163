"""The port's CLI against the JAX package's on the same Matrix Market
file: ``python -m acg_torch.cli A.mtx --device cpu --manufactured-solution
-q`` exits 0 and needs the same iteration count (±1) as ``python -m
acg_tpu.cli``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acg_torch.io.mtxfile import MtxFile, read_mtx, write_mtx
from acg_torch.sparse.poisson import poisson3d_7pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = poisson3d_7pt(16)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("cli") / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def _iterations(stdout):
    lines = [ln for ln in stdout.splitlines()
             if ln.strip().startswith("iterations:")]
    assert len(lines) == 1, stdout
    return int(lines[0].split(":")[1])


def test_cli_matches_jax_cli(matrix_file):
    flags = ["--manufactured-solution", "--max-iterations", "500", "-q"]
    port = _run("acg_torch.cli", matrix_file, "--device", "cpu", *flags)
    assert port.returncode == 0, port.stdout + port.stderr
    ref = _run("acg_tpu.cli", matrix_file, *flags)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert abs(_iterations(port.stdout) - _iterations(ref.stdout)) <= 1
    assert "kernel: torch-plain" in port.stdout
    assert "operator format: stencil" in port.stdout
    assert "floating-point exceptions: none" in port.stdout
    # the same stats block: every line label of the reference's block
    # that the port prints must be spelled the same way
    labels = {ln.split(":")[0].strip() for ln in ref.stdout.splitlines()
              if ":" in ln}
    for ln in port.stdout.splitlines():
        if ":" in ln and not ln.startswith("manufactured"):
            assert ln.split(":")[0].strip() in labels, ln


def test_cli_writes_solution(matrix_file, tmp_path):
    out = str(tmp_path / "x.mtx")
    r = _run("acg_torch.cli", matrix_file, "--device", "cpu",
             "--format", "dia", "--dtype", "float32",
             "--residual-rtol", "1e-5", "--output-solution", out, "-v")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "kernel: torch-plain (format forced: dia)" in r.stdout
    x = read_mtx(out).vals
    assert x.shape == (16 ** 3,) and np.all(np.isfinite(x))
    assert "reading matrix" in r.stderr          # -v logs to stderr
    # plain versions on the CPU: no kernel launched in the timed solve
    assert ("kernel launches in the timed solve: dia_spmv 0, "
            "stencil_spmv 0") in r.stderr


def test_cli_reports_non_convergence(matrix_file):
    r = _run("acg_torch.cli", matrix_file, "--device", "cpu",
             "--max-iterations", "2", "-q")
    assert r.returncode == 1
    assert "did not converge" in r.stderr
    assert _iterations(r.stdout) == 2           # stats of the failed solve


def test_cli_default_device_without_cuda_fails(matrix_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run("acg_torch.cli", matrix_file, "-q")
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr


def _main_iterations(main, argv, capsys):
    """Run a CLI's ``main`` in this process: (exit code, iterations or
    None, stdout, stderr)."""
    rc = main(argv)
    out = capsys.readouterr()
    its = [ln for ln in out.out.splitlines()
           if ln.strip().startswith("iterations:")]
    return (rc, int(its[0].split(":")[1]) if its else None, out.out,
            out.err)


@pytest.mark.parametrize("solver,extra", [
    ("acg-sstep", ["--sstep", "4"]), ("cg-sstep", ["--sstep", "6"]),
    ("acg-pipelined-deep", ["--pipeline-depth", "2"]),
    ("cg-pipelined-deep", ["--pipeline-depth", "3"]),
    ("acg-pipelined-deep", ["--pipeline-depth", "1"])])
def test_cli_sstep_deep_match_jax_cli(matrix_file, solver, extra, capsys):
    from acg_torch import cli
    from acg_tpu import cli as jcli

    flags = [matrix_file, "--solver", solver, *extra,
             "--manufactured-solution", "--max-iterations", "500", "-q"]
    rc, its, out, err = _main_iterations(cli.main,
                                         flags + ["--device", "cpu"], capsys)
    assert rc == 0, out + err
    rcj, itsj, outj, errj = _main_iterations(jcli.main, flags, capsys)
    assert rcj == 0, outj + errj
    assert abs(its - itsj) <= 1
    assert "floating-point exceptions: none" in out
    kernel = [ln.strip() for ln in out.splitlines()
              if ln.strip().startswith("kernel:")][0]
    if "deep" in solver and extra[-1] != "1":
        assert f"(deep pipeline depth {extra[-1]}, " in kernel
    elif "deep" in solver:
        assert kernel == "kernel: torch-plain"


@pytest.mark.parametrize("args,msg", [
    (["--solver", "acg-sstep", "--sstep", "1"], "--sstep 1: "),
    (["--solver", "cg-sstep", "--sstep", "17"], "--sstep 17: "),
    (["--solver", "acg-pipelined-deep", "--pipeline-depth", "0"],
     "--pipeline-depth 0: "),
    (["--solver", "cg-pipelined-deep", "--pipeline-depth", "9"],
     "--pipeline-depth 9: "),
    (["--solver", "acg-sstep", "--nparts", "4"],
     "distributed s-step/deep: not yet ported"),
    (["--solver", "cg-pipelined-deep", "--nparts", "2"],
     "distributed s-step/deep: not yet ported")])
def test_cli_sstep_deep_refusals(matrix_file, args, msg, capsys):
    from acg_torch import cli

    rc, _, _, err = _main_iterations(
        cli.main, [matrix_file, "--device", "cpu", "-q", *args], capsys)
    assert rc == 1
    assert msg in err and "Traceback" not in err


def test_cli_sstep_deep_flags_inert_out_of_mode(matrix_file, capsys):
    """As in the JAX program, the ranges bind only in their modes."""
    from acg_torch import cli

    rc, its, _, _ = _main_iterations(
        cli.main, [matrix_file, "--device", "cpu", "-q", "--sstep", "99",
                   "--pipeline-depth", "99", "--max-iterations", "500"],
        capsys)
    assert rc == 0 and its > 0
