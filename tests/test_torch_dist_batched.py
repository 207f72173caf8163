"""Port parity for distributed multi-RHS solves: a (B, n) right-hand side
through ``cg_dist`` and ``cg_pipelined_dist``, on the CPU against the JAX
package's batched distributed solves and against the port's own
one-system solves, plus the batched halos and the CLI's ``--nrhs K
--nparts P``.

The port's shards share the CPU (``devices=["cpu"] * P``); the JAX side
runs on the root conftest's 8-device CPU mesh on the same part vector.
Every shard holds (B, n) blocks, the halo moves (B, S) messages in the
same rounds, the stencil and DIA shards run the batched SpMVs (plain
versions here) with per-system p'Ap, ELL and sgell their one-system SpMV
once per system.

Tolerances, each with its reason:
- against the JAX package, f64: equal per-system counts and each
  system's x within 1e-10 of the JAX solution relative to its norm (the
  JAX batched distributed solve itself differs from its sequential
  solves at the rounding floor, ``tests/test_batched.py``);
- against the port's own one-system classic solves: equal counts and
  bit-identical x (a batched solve adds every system's values in the
  order its one-system solve does, and freezes a finished system by
  alpha = 0); pipelined: equal counts and x within 1e-10 (the one-system
  solve runs the folded single-kernel iteration, the batch the
  open-coded body);
- every converged system: the certified residual ‖b − A·x‖/‖b‖, in
  float64, at most 10 × rtol;
- (B, S) ghosts against the JAX transports under ``shard_map``:
  bit-equal (both only copy values).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from acg_tpu.config import HaloMethod as JHaloMethod
from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.parallel.mesh import PARTS_AXIS
from acg_tpu.parallel.sharded import ShardedSystem as JShardedSystem
from acg_tpu.partition import graph as jgraph
from acg_tpu.partition import partitioner as jpart
from acg_tpu.solvers.cg_dist import cg_dist as jcg_dist
from acg_tpu.solvers.cg_dist import cg_pipelined_dist as jcg_pipelined_dist
from acg_tpu.sparse import mesh as jmesh
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, write_mtx
from acg_torch.parallel import halo
from acg_torch.partition import graph
from acg_torch.solvers.cg_dist import (build_sharded, cg_dist,
                                       cg_pipelined_dist)
from acg_torch.sparse import mesh as tmesh
from acg_torch.sparse import poisson as tpoisson
from acg_torch.sparse.csr import manufactured_rhs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = dict(maxits=2000, residual_rtol=1e-10)
SOLVERS = {"classic": (jcg_dist, cg_dist),
           "pipelined": (jcg_pipelined_dist, cg_pipelined_dist)}


def _cpu(P):
    return ["cpu"] * P


def _batch(A, nrhs, seed=0):
    """(x*, b) of ``nrhs`` manufactured systems, (B, n) each."""
    xs, bs = zip(*(manufactured_rhs(A, seed=seed + s) for s in range(nrhs)))
    return np.stack(xs), np.stack(bs)


def _certified(A, x, b):
    r = b.astype(np.float64) - A.matvec(x.astype(np.float64))
    return np.linalg.norm(r) / np.linalg.norm(b.astype(np.float64))


def _close(t, j, rtol):
    for s in range(j.shape[0]):
        assert np.linalg.norm(t[s] - j[s]) <= rtol * np.linalg.norm(j[s])


@pytest.mark.parametrize("method", ["ppermute", "allgather"])
@pytest.mark.parametrize("fmt", ["dia", "auto", "ell"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_matches_jax(solver, fmt, method):
    JA, TA = jpoisson.poisson3d_7pt(8), tpoisson.poisson3d_7pt(8)
    _, b = _batch(TA, 3, seed=len(fmt))
    part = jpart.partition_graph(JA, 4)
    jfn, tfn = SOLVERS[solver]
    jres = jfn(JA, b, options=JOptions(**OPTS), part=part, method=method,
               fmt="dia" if fmt == "auto" else fmt)
    tres = tfn(TA, b, options=SolverOptions(**OPTS), part=part,
               method=method, devices=_cpu(4), fmt=fmt)
    assert tres.converged and all(tres.converged_per_system)
    assert tres.nrhs == 3 and tres.x.shape == b.shape
    np.testing.assert_array_equal(tres.iterations_per_system,
                                  jres.iterations_per_system)
    _close(tres.x, jres.x, 1e-10)
    for s in range(3):
        assert _certified(TA, tres.x[s], b[s]) <= 10 * OPTS["residual_rtol"]
    assert tres.residual_history.shape == (3, tres.niterations + 1)
    tier = {"auto": "stencil"}.get(fmt, fmt)
    assert (tres.operator_format, tres.kernel) == (
        tier, f"torch-plain+{method}")
    want_note = "" if fmt == "auto" else f"format forced: {fmt}"
    if solver == "pipelined" and tier != "ell":
        want_note = "; ".join(n for n in (
            want_note, f"{tier} pipe disengaged: nrhs=3 (the single-kernel "
            "iteration is not batched)") if n)
    assert tres.kernel_note == want_note


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_varcoef_irregular_x0_match_jax(solver):
    """Variable coefficients over parts of unequal sizes, with a (B, n)
    x0, against the JAX package."""
    JA = jpoisson.poisson2d_5pt(7, 9)
    TA = tpoisson.poisson2d_5pt(7, 9)
    _, b = _batch(TA, 2, seed=4)
    x0 = np.random.default_rng(3).standard_normal(b.shape)
    part = jpart.partition_graph(JA, 4)
    assert len(set(np.bincount(part))) > 1
    jfn, tfn = SOLVERS[solver]
    jres = jfn(JA, b, x0=x0, options=JOptions(**OPTS), part=part, fmt="dia")
    tres = tfn(TA, b, x0=x0, options=SolverOptions(**OPTS), part=part,
               devices=_cpu(4), fmt="dia")
    np.testing.assert_array_equal(tres.iterations_per_system,
                                  jres.iterations_per_system)
    _close(tres.x, jres.x, 1e-10)
    JV = jpoisson.poisson3d_7pt_varcoef(8)
    TV = tpoisson.poisson3d_7pt_varcoef(8)
    _, b = _batch(TV, 2, seed=6)
    part = jpart.partition_graph(JV, 4)
    jres = jfn(JV, b, options=JOptions(**OPTS), part=part)
    tres = tfn(TV, b, options=SolverOptions(**OPTS), part=part,
               devices=_cpu(4))
    assert tres.operator_format == "dia"
    np.testing.assert_array_equal(tres.iterations_per_system,
                                  jres.iterations_per_system)
    _close(tres.x, jres.x, 1e-10)


@pytest.mark.parametrize("fmt", ["auto", "dia", "ell"])
def test_batched_classic_bit_equal_own_sequential(fmt):
    """Each system of a (B, n) classic solve has the bits and the count of
    its own one-system solve on the same shards."""
    TA = tpoisson.poisson3d_7pt(9)
    _, b = _batch(TA, 4, seed=11)
    ss = build_sharded(TA, nparts=4, devices=_cpu(4), fmt=fmt)
    res = cg_dist(ss, b, options=SolverOptions(**OPTS))
    for s in range(4):
        one = cg_dist(ss, b[s], options=SolverOptions(**OPTS))
        assert res.iterations_per_system[s] == one.niterations
        assert np.array_equal(res.x[s], one.x)
        assert res.rnrm2_per_system[s] == one.rnrm2


@pytest.mark.parametrize("fmt", ["auto", "dia", "ell"])
def test_batched_pipelined_matches_own_sequential(fmt):
    TA = tpoisson.poisson3d_7pt(9)
    _, b = _batch(TA, 3, seed=13)
    ss = build_sharded(TA, nparts=4, devices=_cpu(4), fmt=fmt)
    res = cg_pipelined_dist(ss, b, options=SolverOptions(**OPTS))
    for s in range(3):
        one = cg_pipelined_dist(ss, b[s], options=SolverOptions(**OPTS))
        assert res.iterations_per_system[s] == one.niterations
        assert np.linalg.norm(res.x[s] - one.x) <= 1e-10 * np.linalg.norm(
            one.x)


def test_batched_sgell_f32_matches_own_sequential():
    """A shuffled 3-D mesh over rb parts at f32: rcm+sgell shards, whose
    SpMV runs once per system; the counts and bits of the one-system
    solves."""
    TA = tmesh.fem_delaunay_spd(800, dim=3, seed=2, shuffle=True,
                                dtype=np.float32)
    b = np.random.default_rng(5).standard_normal((3, TA.nrows)).astype(
        np.float32)
    ss = build_sharded(TA, nparts=4, devices=_cpu(4), dtype=np.float32,
                       partition_method="rb")
    assert ss.local_fmt == "sgell"
    opts = SolverOptions(maxits=3000, residual_rtol=1e-5)
    res = cg_dist(ss, b, options=opts)
    assert res.operator_format == "rcm+sgell"
    for s in range(3):
        one = cg_dist(ss, b[s], options=opts)
        assert res.iterations_per_system[s] == one.niterations
        assert np.array_equal(res.x[s], one.x)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_x0_broadcast(solver):
    """A 1-D x0 against a (B, n) b is every system's guess: the same
    result as the x0 tiled to (B, n); any other shape is refused."""
    TA = tpoisson.poisson2d_5pt(12)
    _, b = _batch(TA, 3, seed=2)
    x0 = np.random.default_rng(9).standard_normal(TA.nrows)
    ss = build_sharded(TA, nparts=4, devices=_cpu(4))
    fn = SOLVERS[solver][1]
    shared = fn(ss, b, x0=x0, options=SolverOptions(**OPTS))
    tiled = fn(ss, b, x0=np.tile(x0, (3, 1)), options=SolverOptions(**OPTS))
    assert np.array_equal(shared.x, tiled.x)
    np.testing.assert_array_equal(shared.iterations_per_system,
                                  tiled.iterations_per_system)
    for bad in (x0[:-1], np.tile(x0, (2, 1))):
        with pytest.raises(AcgError) as e:
            fn(ss, b, x0=bad, options=SolverOptions(**OPTS))
        assert e.value.status == Status.ERR_INVALID_VALUE


def test_batched_diff_criterion_and_fixed_iterations_match_jax():
    JA, TA = jpoisson.poisson2d_5pt(12), tpoisson.poisson2d_5pt(12)
    _, b = _batch(TA, 3, seed=8)
    x0 = np.random.default_rng(1).standard_normal(b.shape)
    part = jpart.partition_graph(JA, 4)
    for opts in (dict(maxits=2000, residual_rtol=0.0, diffrtol=1e-6),
                 dict(maxits=17, residual_rtol=0.0)):
        jres = jcg_dist(JA, b, x0=x0, options=JOptions(**opts), part=part,
                        fmt="dia")
        tres = cg_dist(TA, b, x0=x0, options=SolverOptions(**opts),
                       part=part, devices=_cpu(4), fmt="dia")
        np.testing.assert_array_equal(tres.iterations_per_system,
                                      jres.iterations_per_system)
        _close(tres.x, jres.x, 1e-10)
        # and one system alone, the scalar threshold
        jres = jcg_dist(JA, b[1], x0=x0[1], options=JOptions(**opts),
                        part=part, fmt="dia")
        tres = cg_dist(TA, b[1], x0=x0[1], options=SolverOptions(**opts),
                       part=part, devices=_cpu(4), fmt="dia")
        assert tres.niterations == jres.niterations
        _close(tres.x[None], jres.x[None], 1e-10)


def test_batched_not_converged_carries_per_system_result():
    TA = tpoisson.poisson2d_5pt(12)
    _, b = _batch(TA, 2, seed=3)
    b[1] = 0.0                       # converged at x0 = 0
    for fn in (cg_dist, cg_pipelined_dist):
        with pytest.raises(AcgError) as e:
            fn(TA, b, options=SolverOptions(maxits=5, residual_rtol=1e-12),
               nparts=4, devices=_cpu(4))
        assert e.value.status == Status.ERR_NOT_CONVERGED
        res = e.value.result
        assert res.nrhs == 2
        np.testing.assert_array_equal(res.iterations_per_system, [5, 0])
        np.testing.assert_array_equal(res.converged_per_system,
                                      [False, True])
        assert np.all(res.x[1] == 0.0)


def test_rdma_refuses_a_batch():
    TA = tpoisson.poisson2d_5pt(8)
    _, b = _batch(TA, 2)
    for fn in (cg_dist, cg_pipelined_dist):
        with pytest.raises(AcgError, match="multi-RHS solves support") as e:
            fn(TA, b, nparts=2, devices=_cpu(2), method="rdma")
        assert e.value.status == Status.ERR_NOT_SUPPORTED


def _jax_ghosts(jps, x, method, dtype):
    ss = JShardedSystem.build(jps, method=method, dtype=dtype, fmt="ell")
    halo_fn = ss.shard_halo_fn()

    def shard(x_own, sidx, ridx, ptnr, pidx, gsp, gpp):
        return halo_fn(x_own[0], sidx[0], ridx[0], ptnr[0], pidx[0],
                       gsp[0], gpp[0])[None]

    return np.asarray(jax.jit(jax.shard_map(
        shard, mesh=ss.mesh, in_specs=(JP(PARTS_AXIS),) * 7,
        out_specs=JP(PARTS_AXIS), check_vma=False))(
            ss.to_sharded(x), ss.send_idx, ss.recv_idx, ss.partner,
            ss.pack_idx, ss.ghost_src_part, ss.ghost_src_pos))


@pytest.mark.parametrize("nparts", [2, 4, 8])
@pytest.mark.parametrize("case", ["p2d", "mesh"])
def test_batched_ghosts_bit_equal_jax(case, nparts):
    if case == "p2d":
        JA, TA = jpoisson.poisson2d_5pt(12), tpoisson.poisson2d_5pt(12)
    else:
        JA = jmesh.fem_delaunay_spd(400, dim=3, seed=5, shuffle=True)
        TA = tmesh.fem_delaunay_spd(400, dim=3, seed=5, shuffle=True)
    part = jpart.partition_graph(JA, nparts)
    jps = jgraph.partition_system(JA, part, local_order="band")
    tps = graph.partition_system(TA, part, local_order="band")
    x = np.random.default_rng(nparts).standard_normal((5, TA.nrows))
    G = max(-(-max(p.nghost for p in tps.parts) // 8) * 8, 8)
    st = halo.shard_tables(halo.build_halo_tables(tps, nghost_max=G), tps,
                           [torch.device("cpu")] * nparts)
    xs = [torch.from_numpy(np.ascontiguousarray(x[:, p.owned_global]))
          for p in tps.parts]
    for jm, fn in ((JHaloMethod.PPERMUTE, halo.halo_ppermute),
                   (JHaloMethod.ALLGATHER, halo.halo_allgather)):
        want = _jax_ghosts(jps, x, jm, np.float64)
        got = fn(xs, st)
        for i, p in enumerate(tps.parts):
            assert got[i].shape == (5, p.nghost)
            np.testing.assert_array_equal(got[i].numpy(),
                                          want[i, :, : p.nghost])
            # each system's ghosts are its one-system exchange's
            one = fn([v[2].contiguous() for v in xs], st)[i]
            assert torch.equal(got[i][2], one)


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = tpoisson.poisson3d_7pt(10)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("dist_nrhs_cli") / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "acg_torch.cli", *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


@pytest.mark.parametrize("solver", ["acg", "acg-pipelined"])
def test_cli_nrhs_nparts_matches_jax(matrix_file, solver):
    from acg_tpu.io.mtxfile import read_mtx
    from acg_tpu.sparse.csr import csr_from_mtx
    from acg_tpu.sparse.csr import manufactured_rhs as jrhs

    JA = csr_from_mtx(read_mtx(matrix_file))
    _, b = jrhs(JA, seed=0)
    jfn = jcg_dist if solver == "acg" else jcg_pipelined_dist
    want = jfn(JA, np.tile(b, (3, 1)), nparts=4,
               options=JOptions(maxits=500, residual_rtol=1e-9))
    out = _run(matrix_file, "--device", "cpu", "--nparts", "4", "--nrhs",
               "3", "--solver", solver, "--manufactured-solution",
               "--max-iterations", "500", "-q")
    assert out.returncode == 0, out.stdout + out.stderr
    its = [ln for ln in out.stdout.splitlines()
           if ln.strip().startswith("iterations:")]
    assert int(its[0].split(":")[1]) == int(
        np.max(want.iterations_per_system))
    assert "kernel: torch-plain+ppermute" in out.stdout
    out = _run(matrix_file, "--device", "cpu", "--nparts", "4", "--nrhs",
               "3", "--halo", "rdma", "-q")
    assert out.returncode == 1 and "rdma" in out.stderr
