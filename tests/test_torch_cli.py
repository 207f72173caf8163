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
    (["--solver", "acg-sstep", "--nparts", "4", "--halo", "rdma"],
     "takes the ppermute or allgather halo"),
    (["--solver", "cg-pipelined-deep", "--nparts", "2", "--comm",
      "nvshmem"], "takes the ppermute or allgather halo")])
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


@pytest.fixture(scope="module")
def part_files(matrix_file, tmp_path_factory):
    """The 16^3 matrix's kway part vector in 4 parts, as a text and a
    binary Matrix Market file."""
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.sparse.csr import csr_from_mtx

    A = csr_from_mtx(read_mtx(matrix_file))
    part = partition_graph(A, 4, method="kway")
    d = tmp_path_factory.mktemp("parts")
    m = MtxFile(object="vector", format="array", field="integer",
                nrows=len(part), ncols=1, nnz=len(part),
                vals=part.astype(np.float64))
    write_mtx(str(d / "p.mtx"), m)
    write_mtx(str(d / "p.bin.mtx"), m, binary=True)
    return A, part, str(d / "p.mtx"), str(d / "p.bin.mtx"), matrix_file


@pytest.mark.parametrize("binary", [False, True])
def test_cli_partition_file_gives_cg_dist_x(part_files, tmp_path, binary,
                                            capsys):
    """--partition FILE (text, or binary with --binary-partition) runs the
    distributed solve on that part vector: the written solution is the
    library's cg_dist(part=...) solution."""
    from acg_torch import cli
    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg_dist import cg_dist

    A, part, text, binf, path = part_files
    out = str(tmp_path / "x.mtx")
    args = [binf, "--binary-partition"] if binary else [text]
    rc, its, stdout, err = _main_iterations(
        cli.main, [path, "--device", "cpu", "--nparts", "4",
                   "--partition", *args, "--max-iterations", "500",
                   "--output-solution", out, "--numfmt", "%.17g", "-q"],
        capsys)
    assert rc == 0, stdout + err
    res = cg_dist(A, np.ones(A.nrows), options=SolverOptions(
        maxits=500, residual_rtol=1e-9), part=part, devices=["cpu"] * 4)
    assert its == res.niterations
    np.testing.assert_array_equal(read_mtx(out).vals, res.x)


def test_cli_partition_file_refuses_a_wrong_vector(part_files, tmp_path,
                                                   capsys):
    from acg_torch import cli

    A, part, _text, _binf, path = part_files
    bad = str(tmp_path / "bad.mtx")
    write_mtx(bad, MtxFile(object="vector", format="array",
                           field="integer", nrows=A.nrows - 1, ncols=1,
                           nnz=A.nrows - 1,
                           vals=part[:-1].astype(np.float64)))
    rc, _, _, err = _main_iterations(
        cli.main, [path, "--device", "cpu", "--nparts", "4",
                   "--partition", bad, "-q"], capsys)
    assert rc == 1 and "--partition" in err and "Traceback" not in err


@pytest.mark.parametrize("solver,extra", [
    ("acg-sstep", ["--sstep", "4"]),
    ("acg-pipelined-deep", ["--pipeline-depth", "2",
                            "--residual-replacement", "50"])])
@pytest.mark.parametrize("halo", ["ppermute", "allgather"])
def test_cli_sstep_deep_nparts_match_jax_cli(matrix_file, solver, extra,
                                             halo, capsys):
    """The s-step and deep solvers over 4 CPU shards: the JAX program's
    count (±1) on the same part vector (its CPU mesh), the deep-ghost
    path named in the kernel line."""
    from acg_torch import cli
    from acg_tpu import cli as jcli

    flags = [matrix_file, "--solver", solver, *extra, "--nparts", "4",
             "--halo", halo, "--manufactured-solution",
             "--max-iterations", "500", "-q"]
    rc, its, out, err = _main_iterations(cli.main,
                                         flags + ["--device", "cpu"], capsys)
    assert rc == 0, out + err
    rcj, itsj, outj, errj = _main_iterations(jcli.main, flags, capsys)
    assert rcj == 0, outj + errj
    assert abs(its - itsj) <= 1
    kernel = [ln.strip() for ln in out.splitlines()
              if ln.strip().startswith("kernel:")][0]
    assert kernel.startswith(f"kernel: torch-plain+{halo} (")
    assert "deep ghost zones depth" in kernel
