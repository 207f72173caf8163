"""Port parity for distributed pipelined CG
(``acg_torch.solvers.cg_dist.cg_pipelined_dist``): whole solves against
``acg_tpu.solvers.cg_dist.cg_pipelined_dist`` on the CPU on the same part
vector, the per-shard single-kernel iteration with the interface folded
in against the open-coded body and against one global step, the path
names, the refusals and the CLI's ``--solver acg-pipelined --nparts``.

The port's shards share the CPU (``devices=["cpu"] * P``); the JAX side
runs on the root conftest's 8-device CPU mesh, where its probes decline
its per-shard pipe kernel, so it runs the open-coded body.  The port's
stencil and DIA shards run the folded iteration (the plain version of the
kernel, then the fold), so the two packages add in different orders.

Tolerances, each with its reason:
- f64: equal iteration counts, x within 1e-10 of the JAX solution
  relative to its norm (the folded iteration and the shard-ordered sums
  against the JAX package's open-coded body and psum);
- f32: iterations within 1 (the drift band of
  ``tests/test_torch_pipelined.py``) and x no farther from the JAX
  solution than the JAX solution is from the manufactured one, in the
  max norm (near the f32 floor the two recurrences part by rounding, as
  the port's single-device solve parts from the JAX one);
- every converged solve: the certified residual ‖b − A·x‖/‖b − A·x0‖,
  in float64 from the returned x, at most 10 × rtol;
- the folded iteration against the open-coded body of the same loop on
  the same shards: equal counts, x within 1e-12 (f64);
- one folded step against one global step on the assembled vectors:
  1e-12 relative to each vector's largest entry, gamma and delta 1e-12
  relative to |r'|² and |w'|·|r'|;
- ppermute and allgather: bit-identical x and equal counts.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.partition import partitioner as jpart
from acg_tpu.solvers.cg_dist import cg_pipelined_dist as jcg_pipelined_dist
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import HaloMethod, SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, write_mtx
from acg_torch.ops.blas1 import pipelined_update
from acg_torch.parallel.sharded import ShardVec
from acg_torch.solvers.cg_dist import (build_sharded, cg_dist,
                                       cg_pipelined_dist)
from acg_torch.solvers.loops import cg_pipelined_while
from acg_torch.sparse import poisson as tpoisson
from acg_torch.sparse.csr import manufactured_rhs

tcg_dist = importlib.import_module("acg_torch.solvers.cg_dist")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = dict(maxits=2000, residual_rtol=1e-10)


def _cpu(P):
    return ["cpu"] * P


def _pair(kind, *args, **kw):
    return (getattr(jpoisson, kind)(*args, **kw),
            getattr(tpoisson, kind)(*args, **kw))


def _certified(A, x, b, x0=None):
    """‖b − A·x‖ / ‖b − A·x0‖ in float64: the residual the criterion
    bounds, relative to the initial one."""
    b = b.astype(np.float64)
    r0 = b if x0 is None else b - A.matvec(x0.astype(np.float64))
    r = b - A.matvec(x.astype(np.float64))
    return np.linalg.norm(r) / np.linalg.norm(r0)


def _compare(JA, TA, b, part, opts, *, dtype=np.float64, fmt="dia",
             x0=None, its_tol=0, x_rtol=1e-10, xstar=None):
    jres = jcg_pipelined_dist(JA, b, x0=x0, options=JOptions(**opts),
                              part=part, dtype=dtype,
                              fmt="dia" if fmt == "auto" else fmt)
    tres = cg_pipelined_dist(TA, b, x0=x0, options=SolverOptions(**opts),
                             part=part, devices=_cpu(int(part.max()) + 1),
                             dtype=dtype, fmt=fmt)
    assert tres.converged and jres.converged
    assert abs(tres.niterations - jres.niterations) <= its_tol
    if dtype == np.float32:
        assert np.abs(tres.x - jres.x).max() <= np.abs(jres.x - xstar).max()
    else:
        assert np.linalg.norm(tres.x - jres.x) <= x_rtol * np.linalg.norm(
            jres.x)
    assert tres.x.dtype == np.dtype(dtype)
    assert _certified(TA, tres.x, b, x0) <= 10 * opts["residual_rtol"]
    assert tres.residual_history.shape == (tres.niterations + 1,)
    return tres


# (matrix, parts, the tier the port's fmt="auto" takes)
CASES = {
    "p2d-5pt": (("poisson2d_5pt", 16), 4, "stencil"),
    "p3d-7pt": (("poisson3d_7pt", 8), 4, "stencil"),
    "varcoef": (("poisson3d_7pt_varcoef", 8), 4, "dia"),
    "irregular": (("poisson2d_5pt", 7, 9), 4, "dia"),
    "p3d-8parts": (("poisson3d_7pt", 8), 8, "stencil"),
}


@pytest.mark.parametrize("fmt", ["dia", "auto", "ell"])
@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_matches_jax(case, fmt):
    (kind, *args), nparts, auto = CASES[case]
    JA, TA = _pair(kind, *args)
    _, b = manufactured_rhs(TA, seed=len(case))
    part = jpart.partition_graph(JA, nparts)
    if case == "irregular":
        assert len(set(np.bincount(part))) > 1
    res = _compare(JA, TA, b, part, OPTS, fmt=fmt)
    tier = auto if fmt == "auto" else fmt
    assert (res.operator_format, res.kernel) == (tier,
                                                 "torch-plain+ppermute")
    assert res.kernel_note == ("" if fmt == "auto"
                               else f"format forced: {fmt}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_x0_and_dtypes_match_jax(dtype):
    f32 = dtype == np.float32
    JA, TA = _pair("poisson2d_5pt", 16 if f32 else 12, dtype=dtype)
    xstar, b = manufactured_rhs(TA, seed=7)
    x0 = np.random.default_rng(8).standard_normal(TA.nrows).astype(dtype)
    part = jpart.partition_graph(JA, 4)
    opts = (dict(maxits=2000, residual_rtol=1e-5) if f32 else OPTS)
    kw = dict(dtype=dtype, its_tol=1, xstar=xstar) if f32 else {}
    for fmt in ("dia", "auto"):
        _compare(JA, TA, b, part, opts, fmt=fmt, **kw)
        _compare(JA, TA, b, part, opts, fmt=fmt, x0=x0, **kw)


@pytest.mark.parametrize("fmt", ["dia", "auto", "ell"])
def test_replace_every_matches_jax(fmt):
    """``replace_every`` runs the open-coded body in both packages: the
    distributed SpMV, the six updates and the dots; the replaced samples
    are true residuals."""
    JA, TA = _pair("poisson3d_7pt", 8)
    _, b = manufactured_rhs(TA, seed=4)
    part = jpart.partition_graph(JA, 4)
    opts = dict(OPTS, replace_every=10)
    res = _compare(JA, TA, b, part, opts, fmt=fmt)
    if fmt != "ell":
        tier = "dia" if fmt == "dia" else "stencil"
        want = f"{tier} pipe disengaged: replace_every=10"
        assert res.kernel_note == (want if fmt == "auto"
                                   else f"format forced: dia; {want}")
    jres = jcg_pipelined_dist(JA, b, options=JOptions(**opts), part=part,
                              fmt="dia" if fmt == "auto" else fmt)
    assert res.residual_history[10] == pytest.approx(
        jres.residual_history[10], rel=1e-8)


def test_not_converged_matches_jax():
    JA, TA = _pair("poisson2d_5pt", 12)
    b = np.ones(TA.nrows)
    part = jpart.partition_graph(JA, 4)
    opts = dict(maxits=7, residual_rtol=1e-12)
    with pytest.raises(JAcgError) as je:
        jcg_pipelined_dist(JA, b, options=JOptions(**opts), part=part,
                           fmt="dia")
    with pytest.raises(AcgError) as te:
        cg_pipelined_dist(TA, b, options=SolverOptions(**opts), part=part,
                          devices=_cpu(4), fmt="dia")
    assert te.value.status == Status.ERR_NOT_CONVERGED
    tres, jres = te.value.result, je.value.result
    assert tres.niterations == jres.niterations == 7
    np.testing.assert_allclose(tres.x, jres.x, rtol=0,
                               atol=1e-12 * np.abs(jres.x).max())
    np.testing.assert_allclose(tres.residual_history,
                               jres.residual_history, rtol=1e-10)


def test_fixed_iterations_and_check_every_match_jax():
    JA, TA = _pair("poisson3d_7pt", 8)
    _, b = manufactured_rhs(TA, seed=9)
    part = jpart.partition_graph(JA, 4)
    for opts in (dict(maxits=25, residual_rtol=0.0),
                 dict(maxits=2000, residual_rtol=1e-10, check_every=4)):
        jres = jcg_pipelined_dist(JA, b, options=JOptions(**opts),
                                  part=part, fmt="dia")
        tres = cg_pipelined_dist(TA, b, options=SolverOptions(**opts),
                                 part=part, devices=_cpu(4))
        assert tres.niterations == jres.niterations
        assert np.linalg.norm(tres.x - jres.x) <= 1e-10 * np.linalg.norm(
            jres.x)


@pytest.mark.parametrize("method", ["ppermute", "allgather"])
@pytest.mark.parametrize("fmt", ["auto", "dia"])
def test_folded_iteration_matches_open_coded(fmt, method):
    """The per-shard single-kernel iteration with the interface folded in
    against the open-coded body (``iter_step=None``: the distributed SpMV,
    ``pipelined_update`` and the dots) of the same loop on the same
    shards (the JAX package's ``test_dist_pipelined_iter_kernel_matches_
    generic``), f64."""
    TA = tpoisson.poisson3d_7pt(10)
    _, b = manufactured_rhs(TA, seed=5)
    ss = build_sharded(TA, nparts=4, devices=_cpu(4), fmt=fmt,
                       method=method)
    dev0 = ss.devices[0]
    b_sh = ss.to_sharded(b)
    zero = torch.zeros((), dtype=torch.float64)
    stop2 = (zero, torch.tensor(1e-20, dtype=torch.float64))

    def dot(a, c):
        return tcg_dist.sum_in_order([torch.dot(u, v) for u, v in zip(a, c)],
                                     dev0)

    def dot2(a1, b1, a2, b2):
        return dot(a1, b1), dot(a2, b2)

    runs = []
    for step in (tcg_dist._pipe_step(ss, dev0, "f32"), None):
        runs.append(cg_pipelined_while(
            ss.matvec, dot2, b_sh, ShardVec(torch.zeros_like(v)
                                            for v in b_sh),
            stop2, maxits=500, iter_step=step))
    (xf, kf, gf, flf, _, hf), (xo, ko, go, flo, _, ho) = runs
    assert kf == ko and flf == flo == 1
    xf, xo = ss.from_sharded(xf), ss.from_sharded(xo)
    assert np.abs(xf - xo).max() <= 1e-12 * np.abs(xo).max()
    np.testing.assert_allclose(hf[: kf].numpy(), ho[: ko].numpy(),
                               rtol=1e-9, atol=1e-12 * float(ho[0]))


@pytest.mark.parametrize("fmt", ["auto", "dia"])
@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_one_folded_step_equals_one_global_step(nparts, fmt):
    """One step of the folded iteration on random shard vectors against
    one global step (q = A w on the host matrix, the six updates, both
    dots) on the assembled vectors, f64."""
    TA = tpoisson.poisson3d_7pt(8)
    ss = build_sharded(TA, nparts=nparts, devices=_cpu(nparts), fmt=fmt)
    rng = np.random.default_rng(nparts)
    vecs = [rng.standard_normal(TA.nrows) for _ in range(6)]
    sh = [ss.to_sharded(v) for v in vecs]
    alpha = torch.tensor(0.37, dtype=torch.float64)
    beta = torch.tensor(1.21, dtype=torch.float64)
    w, z, r, p, s, x = sh
    got = tcg_dist._pipe_step(ss, ss.devices[0], "f32")(z, r, p, w, s, x,
                                                        alpha, beta)
    tw, tz, tr, tp, ts, tx = (torch.from_numpy(v) for v in vecs)
    q = torch.from_numpy(TA.matvec(vecs[0]))
    want = pipelined_update(q, tw, tz, tr, tp, ts, tx, alpha, beta)
    for g, wv in zip(got[:6], want):
        g = ss.from_sharded(g)
        assert np.abs(g - wv.numpy()).max() <= 1e-12 * float(
            wv.abs().max())
    r2, w2 = want[4], want[5]
    assert abs(float(got[6]) - float(r2 @ r2)) <= 1e-12 * float(r2 @ r2)
    assert abs(float(got[7]) - float(w2 @ r2)) <= 1e-12 * float(
        torch.linalg.norm(w2) * torch.linalg.norm(r2))
    # padding rows of every shard stay exactly zero
    for v in got[:6]:
        for op, t in zip(ss.local_ops, v):
            assert bool(torch.all(t[op.nrows:] == 0))


def test_ppermute_allgather_bit_identical():
    TA = tpoisson.poisson3d_7pt(9)
    _, b = manufactured_rhs(TA, seed=1)
    for fmt in ("auto", "dia", "ell"):
        ss = build_sharded(TA, nparts=4, devices=_cpu(4), fmt=fmt)
        out = [cg_pipelined_dist(ss.with_halo(m), b,
                                 options=SolverOptions(**OPTS))
               for m in (HaloMethod.PPERMUTE, HaloMethod.ALLGATHER)]
        assert out[0].niterations == out[1].niterations
        assert np.array_equal(out[0].x, out[1].x)
        assert out[1].kernel.endswith("+allgather")


def test_path_names_on_the_card():
    """The names a solve on CUDA shards reports (the same system with
    its devices relabelled, since only the names are read): the folded
    iteration is ``cuda-<tier>-pipe``, the open-coded body
    ``cuda-<tier>-spmv`` with the note the single-device solver words, a
    batch ``cuda-<tier>-batched``; ELL and sgell shards have no pipe and
    no note."""
    TA = tpoisson.poisson3d_7pt(8)
    cuda = (torch.device("cuda", 0),) * 4
    describe = tcg_dist._describe_path
    for fmt, tier in (("auto", "stencil"), ("dia", "dia"), ("ell", "ell")):
        ss = dataclasses.replace(
            build_sharded(TA, nparts=4, devices=_cpu(4), fmt=fmt),
            devices=cuda)
        forced = "" if fmt == "auto" else f"format forced: {fmt}"

        def note(extra):
            return "; ".join(n for n in (forced, extra) if n)

        pipe = "spmv" if tier == "ell" else "pipe"
        assert describe(ss, True) == (tier, f"cuda-{tier}-{pipe}+ppermute",
                                      note(""))
        assert describe(ss, False)[1] == (
            f"cuda-{tier}-{'spmv' if tier == 'ell' else 'fused'}+ppermute")
        assert describe(ss, True, replace_every=5) == (
            tier, f"cuda-{tier}-spmv+ppermute",
            note("" if tier == "ell"
                 else f"{tier} pipe disengaged: replace_every=5"))
        batched = "spmv" if tier == "ell" else "batched"
        assert describe(ss, True, batch=3) == (
            tier, f"cuda-{tier}-{batched}+ppermute",
            note("" if tier == "ell" else
                 f"{tier} pipe disengaged: nrhs=3 (the single-kernel "
                 "iteration is not batched)"))
        assert describe(ss, False, batch=3)[1:] == (
            f"cuda-{tier}-{batched}+ppermute", note(""))


def test_refusals():
    TA = tpoisson.poisson2d_5pt(8)
    _, b = manufactured_rhs(TA, seed=0)
    kw = dict(nparts=2, devices=_cpu(2))
    with pytest.raises(AcgError, match="residual-based stopping") as e:
        cg_pipelined_dist(TA, b, options=SolverOptions(diffatol=1e-3), **kw)
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    # segment_iters and monitor_every run (since the device-resident
    # loop), and give the plain solve's bits
    ref = cg_pipelined_dist(TA, b, **kw)
    for opts in (SolverOptions(segment_iters=4),
                 SolverOptions(monitor_every=2)):
        got = cg_pipelined_dist(TA, b, options=opts, **kw)
        assert got.niterations == ref.niterations
        np.testing.assert_array_equal(got.x, ref.x)
    with pytest.raises(AcgError, match="multi-RHS solves support") as e:
        cg_pipelined_dist(TA, np.stack([b, b]), method="rdma", **kw)
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(AcgError) as e:
        cg_pipelined_dist(TA, b[:-1], **kw)
    assert e.value.status == Status.ERR_INVALID_VALUE
    # the put+signal halo itself needs CUDA shards
    with pytest.raises(AcgError, match="rdma") as e:
        cg_pipelined_dist(TA, b, method="rdma", **kw)
    assert e.value.status == Status.ERR_NOT_SUPPORTED


def test_guard_nan_rhs_raises():
    TA = tpoisson.poisson2d_5pt(8)
    b = np.ones(TA.nrows)
    b[3] = np.nan
    for fn in (cg_dist, cg_pipelined_dist):
        with pytest.raises(AcgError) as e:
            fn(TA, b, options=SolverOptions(guard_nonfinite=True,
                                            maxits=50),
               nparts=4, devices=_cpu(4))
        assert e.value.status == Status.ERR_FAULT_DETECTED


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = tpoisson.poisson3d_7pt(10)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("dist_pipe_cli") / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "acg_torch.cli", *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


@pytest.mark.parametrize("solver", ["acg-pipelined", "acg-device-pipelined"])
def test_cli_pipelined_nparts_matches_jax(matrix_file, solver):
    from acg_tpu.io.mtxfile import read_mtx
    from acg_tpu.sparse.csr import csr_from_mtx
    from acg_tpu.sparse.csr import manufactured_rhs as jrhs

    JA = csr_from_mtx(read_mtx(matrix_file))
    _, b = jrhs(JA, seed=0)
    want = jcg_pipelined_dist(JA, b, nparts=4, options=JOptions(
        maxits=500, residual_rtol=1e-9))
    out = _run(matrix_file, "--device", "cpu", "--nparts", "4",
               "--solver", solver, "--halo", "allgather",
               "--manufactured-solution", "--max-iterations", "500", "-q")
    assert out.returncode == 0, out.stdout + out.stderr
    its = [ln for ln in out.stdout.splitlines()
           if ln.strip().startswith("iterations:")]
    assert int(its[0].split(":")[1]) == want.niterations
    assert "kernel: torch-plain+allgather" in out.stdout
    assert "operator format: stencil" in out.stdout
