"""Port parity for distributed s-step CG
(``acg_torch.solvers.cg_dist.cg_sstep_dist``) on the CPU: the port's
shards share the CPU (``devices=["cpu"] * 4``), the JAX side runs on the
root conftest's 8-device CPU mesh, both on the same part vector.

Tolerances, each with its reason (those of ``tests/test_torch_sstep.py``
for one device):
- f64: iterations within ±1 of the JAX solve's and x within 1e-9
  relative (the shards' Gram sums, in shard order, and the host
  coefficient recurrences round in another order than the JAX psum and
  its traced recurrences);
- f32: iterations within s + 2 of each other, true residual below 5 ×
  rtol in both (the JAX tests' own bounds);
- against the port's classic ``cg_dist``: iterations within s + 2 (the
  JAX package's bound, ``tests/test_cg_sstep.py:42``);
- ppermute and allgather: bit-identical x and equal counts;
- a (B, n) solve: each system's count equal to its one-system solve's,
  x within 1e-12 (a batch's Grams and combinations are per system);
- the fallback on a deterministically poisoned basis (the first block's
  shifts forced to 1e30 at f32 for one system of two): the note, each
  system converged under its own criterion (certified below 10 × rtol),
  counts within 1 of the one-device solve poisoned the same way.
"""

import dataclasses
import importlib

import numpy as np
import pytest

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import poisson as jpoisson
from acg_tpu.sparse.mesh import fem_delaunay_spd as jfem

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.partition.partitioner import partition_graph
from acg_torch.solvers.cg import cg_sstep
from acg_torch.solvers.cg_dist import build_sharded, cg_dist, cg_sstep_dist
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import poisson as tpoisson
from acg_torch.sparse.mesh import fem_delaunay_spd as tfem

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
    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(10), 3)
    return Aj, At, b, partition_graph(At, 4)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_sstep_dist_matches_jax_f64(p3d, s):
    Aj, At, b, part = p3d
    o = dict(maxits=2000, residual_rtol=1e-10, sstep=s)
    rj = jcg_dist.cg_sstep_dist(Aj, b, options=JOptions(**o), part=part)
    rt = cg_sstep_dist(At, b, options=SolverOptions(**o), part=part,
                       devices=CPU4)
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    assert _true_rel(At, rt.x, b) <= 10 * 1e-10
    assert rt.kernel_note.startswith(f"deep ghost zones depth {s} (")
    assert rt.stats.nsstepblocks >= -(-rt.niterations // s)
    rc = cg_dist(At, b, options=SolverOptions(maxits=2000,
                                              residual_rtol=1e-10),
                 part=part, devices=CPU4)
    assert abs(rt.niterations - rc.niterations) <= s + 2


@pytest.mark.parametrize("s", [2, 3, 4])
def test_sstep_dist_matches_jax_f32(p3d, s):
    Aj, At, b, part = p3d
    rtol = 1e-5
    o = dict(maxits=2000, residual_rtol=rtol, sstep=s)
    rj = jcg_dist.cg_sstep_dist(Aj, b, options=JOptions(**o), part=part,
                                dtype=np.float32)
    rt = cg_sstep_dist(At, b, options=SolverOptions(**o), part=part,
                       devices=CPU4, dtype=np.float32)
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= s + 2
    assert rt.x.dtype == np.float32
    assert _true_rel(At, rt.x, b) < 5 * rtol
    assert _true_rel(At, rj.x, b) < 5 * rtol


def test_sstep_dist_halos_bit_identical(p3d):
    _Aj, At, b, part = p3d
    o = SolverOptions(maxits=2000, residual_rtol=1e-10, sstep=4)
    ss = build_sharded(At, part=part, devices=CPU4)
    rp = cg_sstep_dist(ss, b, options=o)
    ra = cg_sstep_dist(ss.with_halo("allgather"), b, options=o)
    assert rp.niterations == ra.niterations
    np.testing.assert_array_equal(rp.x, ra.x)
    assert rp.kernel == "torch-plain+ppermute"
    assert ra.kernel == "torch-plain+allgather"


def test_sstep_dist_batched_counts_equal_one_system(p3d):
    _Aj, At, b, part = p3d
    B = np.stack([b, -0.5 * b + 1.0, np.ones_like(b)])
    o = SolverOptions(maxits=2000, residual_rtol=1e-9, sstep=3)
    ss = build_sharded(At, part=part, devices=CPU4)
    rb = cg_sstep_dist(ss, B, options=o)
    assert np.all(rb.converged_per_system)
    for i in range(3):
        r1 = cg_sstep_dist(ss, B[i], options=o)
        assert rb.iterations_per_system[i] == r1.niterations
        assert np.linalg.norm(rb.x[i] - r1.x) <= 1e-12 * np.linalg.norm(
            r1.x)
    assert rb.niterations == int(np.max(rb.iterations_per_system))


def test_sstep_dist_prebuilt_system_reused(p3d):
    _Aj, At, b, part = p3d
    ss = build_sharded(At, part=part, devices=CPU4)
    o = SolverOptions(maxits=2000, residual_rtol=1e-9, sstep=4)
    r1 = cg_sstep_dist(ss, b, options=o)
    dd = ss.deep_cache[4]
    r2 = cg_sstep_dist(ss, 2 * b, options=o, x0=np.zeros_like(b))
    assert ss.deep_cache[4] is dd
    assert r1.converged and r2.converged
    assert _true_rel(At, r2.x, 2 * b) <= 10 * 1e-9
    r3 = cg_sstep_dist(ss, b, options=dataclasses.replace(o, sstep=2))
    assert sorted(ss.deep_cache) == [2, 4] and r3.converged


@pytest.mark.parametrize("method", ["rb", "kway"])
def test_sstep_dist_ell_shards_on_irregular_parts(method):
    """ELL shards (fmt="ell") on irregular parts of an unstructured
    mesh: the skin reaches across ragged borders."""
    Aj, At = jfem(400, dim=2, seed=4), tfem(400, dim=2, seed=4)
    b = np.random.default_rng(1).standard_normal(At.nrows)
    part = partition_graph(At, 4, method=method)
    o = dict(maxits=3000, residual_rtol=1e-10, sstep=3)
    rj = jcg_dist.cg_sstep_dist(Aj, b, options=JOptions(**o), part=part,
                                fmt="ell")
    rt = cg_sstep_dist(At, b, options=SolverOptions(**o), part=part,
                       devices=CPU4, fmt="ell")
    assert rt.operator_format == "ell" and rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    assert _true_rel(At, rt.x, b) <= 10 * 1e-10


def test_sstep_dist_fallback_per_system_floors(monkeypatch):
    """One system's first-block shifts forced to 1e30 at f32 overflow its
    basis: the Gram goes non-finite, the block rolls back and classic
    cg_dist takes that system over under its own criterion, as the one-
    device solve poisoned the same way does."""
    _Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 7)
    B = np.stack([b, 1e-4 * b])
    rtol = 1e-5
    sh = np.array([[1.0, 2.0, 3.0, 4.0], [1e30] * 4], dtype=np.float32)
    monkeypatch.setattr(tcg_dist, "_seed_shifts_dist",
                        lambda *a, **k: sh.copy())
    o = SolverOptions(maxits=4000, residual_rtol=rtol, sstep=4)
    rt = cg_sstep_dist(At, B, options=o, nparts=4, devices=CPU4,
                       dtype=np.float32)
    r1 = cg_sstep(At, B, options=o, dtype=np.float32, shifts0=sh,
                  device="cpu")
    assert "fell back to classic cg" in rt.kernel_note
    assert rt.kernel_note.endswith(r1.kernel_note.split("; ")[-1])
    assert np.all(rt.converged_per_system)
    for i in range(2):
        assert _true_rel(At, rt.x[i], B[i]) < 10 * rtol
    assert np.all(np.abs(rt.iterations_per_system
                         - r1.iterations_per_system) <= 1)


def test_sstep_dist_indefinite_falls_back_and_diagnoses():
    """A genuinely indefinite operator: the fallback's classic CG
    re-diagnoses it (``tests/test_cg_sstep.py``'s distributed case)."""
    from acg_torch.sparse.csr import coo_to_csr

    n = 256
    i = np.arange(n)
    d = np.where(i % 11 == 5, -2.0, 4.0)
    A = coo_to_csr(np.r_[i, i[:-1], i[:-1] + 1],
                   np.r_[i, i[:-1] + 1, i[:-1]],
                   np.r_[d, np.full(n - 1, -1.0), np.full(n - 1, -1.0)],
                   n, n)
    with pytest.raises(AcgError) as ei:
        cg_sstep_dist(A, np.ones(n), options=SolverOptions(
            maxits=800, residual_rtol=1e-10, sstep=4), nparts=4,
            devices=CPU4)
    assert ei.value.status == Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX
    assert "fell back to classic cg" in ei.value.result.kernel_note


@pytest.mark.parametrize("kw,msg", [
    (dict(method="rdma"), "ppermute/allgather"),
    (dict(recycle=object()), "recycle"),
    (dict(options=SolverOptions(sstep=0)), "sstep >= 2"),
    (dict(options=SolverOptions(sstep=4, diffatol=1e-8)),
     "residual-based stopping only")])
def test_sstep_dist_refusals(p3d, kw, msg):
    _Aj, At, b, part = p3d
    kw = dict(kw)
    opts = kw.pop("options", SolverOptions(sstep=4))
    with pytest.raises(AcgError) as ei:
        cg_sstep_dist(At, b, options=opts, part=part, devices=CPU4, **kw)
    assert msg in str(ei.value)
    assert ei.value.status in (Status.ERR_NOT_SUPPORTED,
                               Status.ERR_INVALID_VALUE)
