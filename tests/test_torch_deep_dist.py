"""Port parity for distributed depth-l pipelined CG
(``acg_torch.solvers.cg_dist.cg_pipelined_deep_dist``) on the CPU: the
port's shards share the CPU (``devices=["cpu"] * 4``), the JAX side runs
on the root conftest's 8-device CPU mesh, both on the same part vector.

Tolerances, each with its reason:
- f64 at ``replace_every=50``: iterations within ±1 of the JAX solve's
  and x within 1e-9 relative (the single-device bound of
  ``tests/test_torch_deep.py``; every dispatch restarts the recurrence
  from the true residual, so the two packages' rounding does not grow
  into a drift);
- depth 1 is ``cg_pipelined_dist``: equal bits;
- the deep fill chain (one depth-l exchange, l extended applications in
  the skin) against l distributed matvecs on the same z_0 and shifts:
  1e-12 relative to each level's largest entry;
- under the bf16 wire the entry residual and the certifier run the
  full-width (f32) exchange, the loop the bf16 one, and the exit is
  certified in float64 on the host below 10 × rtol;
- after ``_DEEP_MAX_BAD`` poisoned dispatches (fill shifts of 1e30 at
  f32) classic ``cg_dist`` at the f32 wire takes over: the note of the
  one-device solve poisoned the same way, certified exits.
"""

import importlib

import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.parallel.deep import build_deep_device
from acg_torch.parallel.sharded import ShardVec
from acg_torch.partition.partitioner import partition_graph
from acg_torch.solvers.cg import _DEEP_MAX_BAD, cg_pipelined_deep
from acg_torch.solvers.cg_dist import (build_sharded, cg_pipelined_deep_dist,
                                       cg_pipelined_dist)
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import poisson as tpoisson

jcg_dist = importlib.import_module("acg_tpu.solvers.cg_dist")
tcg_dist = importlib.import_module("acg_torch.solvers.cg_dist")
CPU4 = ["cpu"] * 4


def _pair(make, seed):
    Aj, At = make(jpoisson), make(tpoisson)
    _, b = tcsr.manufactured_rhs(At, seed=seed)
    np.testing.assert_array_equal(b, jcsr.manufactured_rhs(Aj, seed=seed)[1])
    return Aj, At, b


def _true_rel(A, x, b):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def p3d():
    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(10), 5)
    return Aj, At, b, partition_graph(At, 4)


@pytest.fixture(scope="module")
def shards(p3d):
    return build_sharded(p3d[1], part=p3d[3], devices=CPU4)


@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("method", ["ppermute", "allgather"])
def test_deep_dist_matches_jax_f64(p3d, shards, l, method):
    Aj, At, b, part = p3d
    o = dict(maxits=2000, residual_rtol=1e-10, pipeline_depth=l,
             replace_every=50)
    rj = jcg_dist.cg_pipelined_deep_dist(Aj, b, options=JOptions(**o),
                                         part=part, method=method)
    rt = cg_pipelined_deep_dist(shards.with_halo(method), b,
                                options=SolverOptions(**o))
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    assert _true_rel(At, rt.x, b) <= 10 * 1e-10
    assert rt.kernel == f"torch-plain+{method}"
    assert rt.kernel_note.startswith(f"deep pipeline depth {l}, ")
    assert f"deep ghost zones depth {l} (" in rt.kernel_note


def test_deep_dist_batched_matches_one_device(p3d, shards):
    """A (B, n) solve against the one-device batched solves of both
    packages (the JAX package's own distributed batched loop counts a
    system that finishes early differently from its one-device loop, 27
    against 44 for the second system here; the port's loop is the
    one-device one, recorded in ROADMAP Queue 3)."""
    from acg_tpu.solvers.cg import cg_pipelined_deep as jdeep

    Aj, At, b, _part = p3d
    B = np.stack([b, np.ones_like(b)])
    o = dict(maxits=2000, residual_rtol=1e-9, pipeline_depth=2,
             replace_every=50)
    rj = jdeep(Aj, B, options=JOptions(**o))
    r1 = cg_pipelined_deep(At, B, options=SolverOptions(**o), device="cpu")
    rt = cg_pipelined_deep_dist(shards, B, options=SolverOptions(**o))
    assert np.all(rt.converged_per_system)
    for ref in (rj, r1):
        assert np.all(np.abs(rt.iterations_per_system
                             - ref.iterations_per_system) <= 1)
    for i in range(2):
        assert _true_rel(At, rt.x[i], B[i]) <= 10 * 1e-9


def test_deep_dist_depth_one_is_cg_pipelined_dist(p3d, shards):
    _Aj, _At, b, _part = p3d
    o = SolverOptions(maxits=2000, residual_rtol=1e-10, pipeline_depth=1)
    r1 = cg_pipelined_deep_dist(shards, b, options=o)
    r2 = cg_pipelined_dist(shards, b, options=o)
    assert r1.niterations == r2.niterations
    np.testing.assert_array_equal(r1.x, r2.x)
    assert r1.kernel == r2.kernel


@pytest.mark.parametrize("l", [2, 4])
def test_deep_fill_matches_distributed_matvecs(p3d, shards, l):
    """z_{j+1} = (A - sigma_j) z_j from one depth-l exchange against the
    same chain through l ordinary distributed matvecs."""
    _Aj, At, _b, _part = p3d
    dd = build_deep_device(shards, l)
    z0 = shards.to_sharded(np.random.default_rng(9).standard_normal(
        At.nrows))
    sig = torch.linspace(0.5, 9.0, l, dtype=torch.float64)
    Z = z0.window(l + 1)
    Z[0].copy_(z0)
    tcg_dist._deep_fill(shards, dd, sig, "f32")([Z[j] for j in range(l + 1)])
    want = z0
    for j in range(l):
        want = ShardVec(y - sig[j] * v for y, v in
                        zip(shards.matvec(want), want))
        got = Z[j + 1]
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-12 * scale)


def test_deep_dist_certifier_runs_the_f32_exchange(p3d, monkeypatch):
    """The loop under the bf16 wire; the entry residual and the certifier
    of every dispatch through the full-width exchange."""
    Aj, At, b, part = p3d
    ss = build_sharded(At, part=part, devices=CPU4, dtype=np.float32)
    wires = []
    exchange = ss.exchange

    def counted(xs, wire="f32"):
        wires.append(wire)
        return exchange(xs, wire)

    ss.exchange = counted
    rtol = 1e-3
    res = cg_pipelined_deep_dist(ss, b, options=SolverOptions(
        maxits=2000, residual_rtol=rtol, pipeline_depth=2,
        replace_every=10, halo_wire="bf16"))
    assert res.converged
    ndisp = int(res.kernel_note.split(", ")[1].split()[0])
    assert "wire=bf16" in res.kernel_note
    # two full-width exchanges a dispatch (the entry residual and the
    # certifier), every other one at the wire
    assert wires.count("f32") == 2 * ndisp
    assert wires.count("bf16") > 0
    assert set(wires) == {"f32", "bf16"}
    assert _true_rel(At, res.x, b) <= 10 * rtol


@pytest.mark.parametrize("batch", [0, 2])
def test_deep_dist_fallback_after_poisoned_dispatches(monkeypatch, batch):
    """Fill shifts of 1e30 overflow the f32 basis in every dispatch: each
    ends in breakdown, and after ``_DEEP_MAX_BAD`` of them classic
    cg_dist takes over from the last safe iterate, as on one device."""
    _Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 7)
    B = np.stack([b, -2 * b]) if batch else b
    sh = np.full((batch, 2) if batch else 2, 1e30, dtype=np.float32)
    monkeypatch.setattr(tcg_dist, "_seed_shifts_dist",
                        lambda *a, **k: sh.copy())
    o = SolverOptions(maxits=2000, residual_rtol=1e-5, pipeline_depth=2)
    rt = cg_pipelined_deep_dist(At, B, options=o, nparts=4, devices=CPU4,
                                dtype=np.float32)
    r1 = cg_pipelined_deep(At, B, options=o, dtype=np.float32,
                           shifts0=np.full(2, 1e30), device="cpu")
    assert _DEEP_MAX_BAD == 3
    assert rt.converged
    assert ("cg-pipelined-deep(l=2) fell back to classic cg after "
            "0 iteration(s): indefinite Gram/LDL pivot") in rt.kernel_note
    assert rt.kernel_note.endswith(r1.kernel_note.split("; ")[-1])
    assert rt.kernel.endswith("+ppermute")
    for x, bb in zip(np.atleast_2d(rt.x), np.atleast_2d(B)):
        assert _true_rel(At, x, bb) < 10 * 1e-5


@pytest.mark.parametrize("kw,msg", [
    (dict(method="rdma"), "ppermute/allgather"),
    (dict(options=SolverOptions(pipeline_depth=2, diffatol=1e-8,
                                residual_rtol=0.0)),
     "residual-based stopping only")])
def test_deep_dist_refusals(p3d, kw, msg):
    _Aj, At, b, part = p3d
    kw = dict(kw)
    opts = kw.pop("options", SolverOptions(pipeline_depth=2))
    with pytest.raises(AcgError) as ei:
        cg_pipelined_deep_dist(At, b, options=opts, part=part, devices=CPU4,
                               **kw)
    assert msg in str(ei.value)
    assert ei.value.status == Status.ERR_NOT_SUPPORTED
