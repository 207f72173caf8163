"""Port parity for distributed classic CG (``acg_torch.solvers.cg_dist``):
whole solves against ``acg_tpu.solvers.cg_dist.cg_dist`` on the CPU, on
the same part vector (and, in one test, literally the same shards through
``partitioned_system_from_arrays``), plus the CLI's distributed flags.

The port's shards share the CPU (``devices=["cpu"] * P``); the JAX side
runs on the root conftest's 8-device CPU mesh.  The JAX package's probes
decline its stencil and sgell tiers on the CPU, so the Poisson cases force
``fmt="dia"`` in both packages, the scattered mesh runs the JAX sgell tier
in Pallas interpret mode (its CPU-test switch), and one case holds the
port's own ``fmt="auto"`` choice (the stencil) against the JAX DIA solve.

Tolerances, each with its reason:
- f64: equal iteration counts, x within 1e-10 of the JAX solution
  relative to its norm (the dots are per-shard partials summed in shard
  order, the JAX package's psum may add them in another order, and the
  DIA shards fuse p'Ap where the JAX CPU path takes the generic split);
- f32: iterations within 1, x within 1e-4 relative;
- every converged solve: the certified residual ‖b − A·x‖/‖b‖, recomputed
  in float64 from the returned x, at most 10 × rtol;
- ppermute and allgather in the port: bit-identical x and equal counts
  (both deliver the same ghost bits).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.partition import graph as jgraph
from acg_tpu.partition import partitioner as jpart
from acg_tpu.solvers.cg_dist import cg_dist as jcg_dist
from acg_tpu.sparse import mesh as jmesh
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import HaloMethod, SolverOptions
from acg_torch.convert import partitioned_system_from_arrays
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, write_mtx
from acg_torch.partition import partitioner as tpartitioner
from acg_torch.solvers.cg_dist import build_sharded, cg_dist
from acg_torch.sparse import mesh as tmesh
from acg_torch.sparse import poisson as tpoisson
from acg_torch.sparse.csr import manufactured_rhs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu(P):
    return ["cpu"] * P


def _pair(kind, *args, **kw):
    return (getattr(jpoisson if kind != "fem" else jmesh,
                    "fem_delaunay_spd" if kind == "fem" else kind)(*args,
                                                                   **kw),
            getattr(tpoisson if kind != "fem" else tmesh,
                    "fem_delaunay_spd" if kind == "fem" else kind)(*args,
                                                                   **kw))


def _certified(A, x, b):
    r = b.astype(np.float64) - A.matvec(x.astype(np.float64))
    return np.linalg.norm(r) / np.linalg.norm(b.astype(np.float64))


def _compare(JA, TA, b, part, opts, *, dtype=np.float64, fmt="dia",
             x0=None, jkw=None, tkw=None, its_tol=0, x_rtol=1e-10):
    """One solve in each package on the same part vector; returns the
    port's result."""
    jres = jcg_dist(JA, b, x0=x0, options=JOptions(**opts), part=part,
                    dtype=dtype, fmt=fmt, **(jkw or {}))
    tres = cg_dist(TA, b, x0=x0, options=SolverOptions(**opts), part=part,
                   devices=_cpu(int(part.max()) + 1), dtype=dtype, fmt=fmt,
                   **(tkw or {}))
    assert tres.converged and jres.converged
    assert abs(tres.niterations - jres.niterations) <= its_tol
    scale = np.linalg.norm(jres.x)
    assert np.linalg.norm(tres.x - jres.x) <= x_rtol * scale
    assert tres.x.dtype == np.dtype(dtype)
    assert _certified(TA, tres.x, b) <= 10 * opts["residual_rtol"]
    return tres


OPTS = dict(maxits=2000, residual_rtol=1e-10)


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_manufactured_matches_jax(nparts):
    JA, TA = _pair("poisson3d_7pt", 8)
    _, b = manufactured_rhs(TA, seed=nparts)
    part = jpart.partition_graph(JA, nparts)
    res = _compare(JA, TA, b, part, OPTS)
    assert (res.operator_format, res.kernel) == ("dia",
                                                 "torch-plain+ppermute")
    assert res.kernel_note == "format forced: dia"


def test_auto_stencil_shards_match_jax_dia():
    """The port's fmt="auto" takes the matrix-free stencil on each box of
    a grid partition (the JAX package's probe declines it on the CPU and
    solves on DIA): the same counts and x within tolerance."""
    JA, TA = _pair("poisson3d_7pt", 8, 8, 12)
    _, b = manufactured_rhs(TA, seed=11)
    part = jpart.partition_graph(JA, 4)
    jres = jcg_dist(JA, b, options=JOptions(**OPTS), part=part)
    tres = cg_dist(TA, b, options=SolverOptions(**OPTS), part=part,
                   devices=_cpu(4))
    assert (tres.operator_format, tres.kernel) == ("stencil",
                                                   "torch-plain+ppermute")
    assert tres.niterations == jres.niterations
    assert np.linalg.norm(tres.x - jres.x) <= 1e-10 * np.linalg.norm(jres.x)


def test_27pt_many_neighbours_matches_jax():
    JA, TA = _pair("poisson3d_27pt", 8)
    part = jpoisson.grid_partition_vector((8, 8, 8), (2, 2, 2))
    ss = build_sharded(TA, part=part, devices=_cpu(8), fmt="dia")
    assert ss.halo.nrounds >= 7
    _, b = manufactured_rhs(TA, seed=25)
    _compare(JA, TA, b, part, OPTS)


def test_varcoef_matches_jax():
    JA, TA = _pair("poisson3d_7pt_varcoef", 8)
    _, b = manufactured_rhs(TA, seed=3)
    part = jpart.partition_graph(JA, 4)
    res = _compare(JA, TA, b, part, OPTS, fmt="auto")
    assert res.operator_format == "dia"


def test_irregular_sizes_match_jax():
    JA, TA = _pair("poisson2d_5pt", 7, 9)       # 63 rows over 4 chunks
    _, b = manufactured_rhs(TA, seed=10)
    part = jpart.partition_graph(JA, 4)
    assert len(set(np.bincount(part))) > 1
    _compare(JA, TA, b, part, OPTS)


def test_single_part_matches_jax():
    JA, TA = _pair("poisson2d_5pt", 9)
    _, b = manufactured_rhs(TA, seed=19)
    part = np.zeros(TA.nrows, dtype=np.int32)
    _compare(JA, TA, b, part, OPTS)


def test_x0_and_f32_match_jax():
    JA, TA = _pair("poisson2d_5pt", 12)
    _, b = manufactured_rhs(TA, seed=7)
    x0 = np.random.default_rng(8).standard_normal(TA.nrows)
    part = jpart.partition_graph(JA, 4)
    _compare(JA, TA, b, part, OPTS, x0=x0)
    JA, TA = _pair("poisson2d_5pt", 16, dtype=np.float32)
    _, b = manufactured_rhs(TA, seed=9)
    part = jpart.partition_graph(JA, 4)
    _compare(JA, TA, b, part, dict(maxits=2000, residual_rtol=1e-5),
             dtype=np.float32, its_tol=1, x_rtol=1e-4)


def test_not_converged_matches_jax():
    JA, TA = _pair("poisson2d_5pt", 12)
    b = np.ones(TA.nrows)
    part = jpart.partition_graph(JA, 4)
    opts = dict(maxits=7, residual_rtol=1e-12)
    with pytest.raises(JAcgError) as je:
        jcg_dist(JA, b, options=JOptions(**opts), part=part, fmt="dia")
    with pytest.raises(AcgError) as te:
        cg_dist(TA, b, options=SolverOptions(**opts), part=part,
                devices=_cpu(4), fmt="dia")
    assert te.value.status == Status.ERR_NOT_CONVERGED
    tres, jres = te.value.result, je.value.result
    assert tres.niterations == jres.niterations == 7
    np.testing.assert_allclose(tres.x, jres.x, rtol=0,
                               atol=1e-12 * np.abs(jres.x).max())
    np.testing.assert_allclose(tres.residual_history,
                               jres.residual_history, rtol=1e-10)


def test_prebuilt_system_reused():
    JA, TA = _pair("poisson2d_5pt", 10)
    part = jpart.partition_graph(JA, 4)
    ss = build_sharded(TA, part=part, devices=_cpu(4))
    for seed in (5, 6):
        xstar, b = manufactured_rhs(TA, seed=seed)
        res = cg_dist(ss, b, options=SolverOptions(**OPTS))
        jres = jcg_dist(JA, b, options=JOptions(**OPTS), part=part)
        assert res.niterations == jres.niterations
        assert res.stats.nsolves == 1
        np.testing.assert_allclose(res.x, xstar, atol=1e-8)


def test_same_shards_through_convert():
    """The JAX package's PartitionedSystem carried across as arrays: both
    packages solve on literally the same shards (interior-first local
    order, the JAX default)."""
    JA, TA = _pair("poisson2d_5pt", 14)
    jps = jgraph.partition_system(JA, jpart.partition_graph(JA, 4))
    tps = partitioned_system_from_arrays(
        jps.nrows, jps.part,
        [dict(owned_global=p.owned_global, ninterior=p.ninterior,
              ghost_global=p.ghost_global, ghost_owner=p.ghost_owner,
              A_local=(p.A_local.rowptr, p.A_local.colidx, p.A_local.vals),
              A_iface=(p.A_iface.rowptr, p.A_iface.colidx, p.A_iface.vals),
              neighbors=p.neighbors, send_counts=p.send_counts,
              send_idx=p.send_idx, recv_counts=p.recv_counts)
         for p in jps.parts])
    x = np.random.default_rng(2).standard_normal(TA.nrows)
    np.testing.assert_array_equal(tps.matvec(x), jps.matvec(x))
    _, b = manufactured_rhs(TA, seed=12)
    jres = jcg_dist(jps, b, options=JOptions(**OPTS), fmt="ell")
    tres = cg_dist(tps, b, options=SolverOptions(**OPTS), fmt="ell",
                   devices=_cpu(4))
    assert tres.operator_format == "ell"
    assert tres.niterations == jres.niterations
    assert np.linalg.norm(tres.x - jres.x) <= 1e-10 * np.linalg.norm(jres.x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scattered_mesh_matches_jax(dtype):
    """A shuffled 3-D Delaunay mesh over 4 rb parts: per-part RCM then
    the sgell packs at f32 (the JAX sgell tier in interpret mode), padded
    ELL at f64."""
    JA, TA = _pair("fem", 1200, dim=3, seed=4, shuffle=True, dtype=dtype)
    _, b = manufactured_rhs(TA, seed=13)
    part = jpart.partition_graph(JA, 4)
    f32 = dtype == np.float32
    opts = dict(maxits=3000, residual_rtol=1e-5 if f32 else 1e-10)
    res = _compare(JA, TA, b, part, opts, dtype=dtype, fmt="auto",
                   jkw=dict(sgell_interpret=True), its_tol=1 if f32 else 0,
                   x_rtol=1e-4 if f32 else 1e-10)
    assert res.operator_format == ("rcm+sgell" if f32 else "ell")


@pytest.mark.parametrize("case", ["p3d", "fem"])
def test_ppermute_allgather_bit_identical(case):
    if case == "p3d":
        A = tpoisson.poisson3d_7pt(9)
    else:
        A = tmesh.fem_delaunay_spd(800, dim=3, seed=1, shuffle=True)
    _, b = manufactured_rhs(A, seed=1)
    ss = build_sharded(A, nparts=4, devices=_cpu(4))
    out = [cg_dist(ss.with_halo(m), b, options=SolverOptions(**OPTS))
           for m in (HaloMethod.PPERMUTE, HaloMethod.ALLGATHER)]
    assert out[0].niterations == out[1].niterations
    assert np.array_equal(out[0].x, out[1].x)
    assert out[1].kernel.endswith("+allgather")


def test_unported_options_raise():
    A = tpoisson.poisson2d_5pt(8)
    _, b = manufactured_rhs(A, seed=0)
    kw = dict(nparts=2, devices=_cpu(2))
    # segment_iters and monitor_every run (since the device-resident
    # loop), and give the plain solve's bits
    plain = cg_dist(A, b, **kw)
    for opts in (SolverOptions(segment_iters=4),
                 SolverOptions(monitor_every=2)):
        got = cg_dist(A, b, options=opts, **kw)
        assert got.niterations == plain.niterations
        np.testing.assert_array_equal(got.x, plain.x)
    # the kway partitioner, refused until it was ported, now partitions
    res = cg_dist(A, b, partition_method="kway", **kw)
    ref = cg_dist(A, b, part=tpartitioner.partition_graph(A, 2, "kway"),
                  **kw)
    assert res.converged and res.niterations == ref.niterations
    np.testing.assert_array_equal(res.x, ref.x)
    # the put+signal halo moves one system at full width: a batch and a
    # compressed wire are refused before the shards are built
    with pytest.raises(AcgError, match="multi-RHS solves support") as e:
        cg_dist(A, np.stack([b, b]), method="rdma", **kw)
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(AcgError, match="halo_wire compression") as e:
        cg_dist(A, b, options=SolverOptions(halo_wire="bf16"),
                method="rdma", **kw)
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(AcgError) as e:
        build_sharded(A, **kw, fmt="sgell")        # f64: the tier refuses
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(AcgError) as e:
        build_sharded(A, **kw, fmt="stencil", dtype=np.float64,
                      partition_method="rb")
    assert e.value.status == Status.ERR_NOT_SUPPORTED


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = tpoisson.poisson3d_7pt(12)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("dist_cli") / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _run(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "acg_torch.cli", *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def _iterations(stdout):
    lines = [ln for ln in stdout.splitlines()
             if ln.strip().startswith("iterations:")]
    assert len(lines) == 1, stdout
    return int(lines[0].split(":")[1])


def test_cli_nparts_matches_jax(matrix_file):
    from acg_tpu.io.mtxfile import read_mtx
    from acg_tpu.sparse.csr import csr_from_mtx
    from acg_tpu.sparse.csr import manufactured_rhs as jrhs

    JA = csr_from_mtx(read_mtx(matrix_file))
    _, b = jrhs(JA, seed=0)
    want = jcg_dist(JA, b, nparts=4,
                    options=JOptions(maxits=500, residual_rtol=1e-9))
    runs = {}
    for halo, comm in (("ppermute", None), ("allgather", None),
                       (None, "nccl")):
        args = [matrix_file, "--device", "cpu", "--nparts", "4",
                "--manufactured-solution", "--max-iterations", "500", "-q"]
        args += ["--halo", halo] if halo else ["--comm", comm]
        out = _run(*args)
        assert out.returncode == 0, out.stdout + out.stderr
        runs[halo or comm] = out.stdout
        assert _iterations(out.stdout) == want.niterations
    assert "kernel: torch-plain+ppermute" in runs["ppermute"]
    assert "kernel: torch-plain+allgather" in runs["allgather"]
    assert "kernel: torch-plain+ppermute" in runs["nccl"]
    assert "operator format: stencil" in runs["ppermute"]


def test_cli_comm_mapping_equals_jax():
    from acg_tpu.cli import resolve_halo as jresolve

    from acg_torch.cli import resolve_halo

    for comm in (None, "none", "mpi", "nccl", "nvshmem", "rccl",
                 "rocshmem"):
        for halo in (None, "ppermute", "allgather", "rdma"):
            assert resolve_halo(comm, halo) == jresolve(comm, halo)


def test_cli_nparts_errors(matrix_file, monkeypatch, capsys):
    from acg_torch import cli

    # the default device with no card, and rdma on the CPU: exit 1
    if not torch.cuda.is_available():
        out = _run(matrix_file, "--nparts", "4", "-q")
        assert out.returncode == 1 and "error:" in out.stderr
    for extra in (["--comm", "nvshmem"], ["--halo", "rdma"],
                  ["--halo", "rdma", "--nrhs", "2"],
                  ["--halo", "rdma", "--halo-wire", "bf16"],
                  ["--solver", "acg-sstep", "--halo", "rdma"],
                  ["--partition-method", "kway", "--halo", "rdma"]):
        assert cli.main([matrix_file, "--device", "cpu", "--nparts", "4",
                         "-q", *extra]) == 1
        err = capsys.readouterr().err
        assert "rdma" in err, err
    # one visible card and the default device list: ERR_MESH, exit 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main([matrix_file, "--nparts", "4", "-q"]) == 1
    err = capsys.readouterr().err
    assert "need 4 devices for 4 parts, have 1" in err
