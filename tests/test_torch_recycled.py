"""Port parity for recycled (deflated) CG: ``acg_torch.solvers.cg``
``cg_recycled`` / ``_deflate_x0`` and ``acg_torch.solvers.cg_dist``
``cg_recycled_dist`` on the CPU against the JAX package's.

- ``_deflate_x0`` (host float64 in both): 1-D and batched to 1e-12
  relative; a singular W'AW or a non-finite correction returns x0.
- No basis: ``cg_recycled`` IS ``cg``, bit for bit.
- With a basis: iterations within ±1 of the JAX solve, ``x`` within 1e-9
  relative; the distributed solve on ``devices=["cpu"] * P`` against
  ``acg_tpu.solvers.cg_dist.cg_recycled_dist`` on the same part vector.
"""

import numpy as np
import pytest

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.solvers.cg import _deflate_x0 as jdeflate
from acg_tpu.solvers.cg import cg_recycled as jrecycled
from acg_tpu.solvers.cg_dist import cg_recycled_dist as jrecycled_dist
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.partition.partitioner import partition_graph
from acg_torch.solvers.cg import (_deflate_x0, _host_matvec,
                                  build_device_operator, cg, cg_recycled)
from acg_torch.solvers.cg_dist import cg_recycled_dist
from acg_torch.sparse import poisson as tpoisson

OPTS = dict(maxits=400, residual_rtol=1e-10)


def _rhs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, n))


def _basis(A, k=4, seed=11):
    """An orthonormal random block and its exact projection W'AW."""
    rng = np.random.default_rng(seed)
    W, _ = np.linalg.qr(rng.standard_normal((A.nrows, k)))
    AW = np.stack([A.matvec(W[:, j]) for j in range(k)], axis=1)
    return W, W.T @ AW


def _eigvecs(nx, k):
    """The k lowest Dirichlet eigenvectors of the 5-point Laplacian on an
    nx x nx grid, products of sines, and W'AW (diagonal)."""
    i = np.arange(1, nx + 1)
    modes = sorted(((a, b) for a in range(1, nx + 1)
                    for b in range(1, nx + 1)),
                   key=lambda m: np.sin(m[0] * np.pi / (2 * nx + 2)) ** 2
                   + np.sin(m[1] * np.pi / (2 * nx + 2)) ** 2)[:k]
    W = np.stack([np.outer(np.sin(b * i * np.pi / (nx + 1)),
                           np.sin(a * i * np.pi / (nx + 1))).ravel()
                  for a, b in modes], axis=1)
    return W / np.linalg.norm(W, axis=0)


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("with_x0", [False, True])
def test_deflate_x0_matches_jax(batch, with_x0):
    A = tpoisson.poisson2d_5pt(12)
    rng = np.random.default_rng(batch + 2 * with_x0)
    b = rng.standard_normal((batch, A.nrows) if batch else A.nrows)
    x0 = rng.standard_normal(b.shape) if with_x0 else None
    W, WtAW = _basis(A)
    got = _deflate_x0(A.matvec, b, x0, W, WtAW)
    want = jdeflate(jpoisson.poisson2d_5pt(12).matvec, b, x0, W, WtAW)
    assert got.dtype == np.float64 and got.shape == b.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(want)))
    # the deflated residual is orthogonal to the basis
    xd = got.reshape(-1, A.nrows)
    for bi, xi in zip(b.reshape(-1, A.nrows), xd):
        r = bi - A.matvec(xi)
        assert np.max(np.abs(W.T @ r)) < 1e-10 * np.linalg.norm(bi)


def test_deflate_x0_singular_or_nonfinite_returns_x0():
    A = tpoisson.poisson2d_5pt(8)
    b = _rhs(A.nrows, 1)[0]
    W, WtAW = _basis(A)
    x0 = np.full(A.nrows, 0.5)
    singular = np.zeros_like(WtAW)
    np.testing.assert_array_equal(
        _deflate_x0(A.matvec, b, x0, W, singular), x0)
    np.testing.assert_array_equal(
        _deflate_x0(A.matvec, b, None, W, singular), np.zeros(A.nrows))
    nonfinite = WtAW.copy()
    nonfinite[0, 0] = np.inf
    np.testing.assert_array_equal(
        _deflate_x0(A.matvec, b, x0, W, nonfinite),
        jdeflate(A.matvec, b, x0, W, nonfinite))


def test_recycled_without_basis_is_cg():
    A = tpoisson.poisson2d_5pt(16)
    b = _rhs(A.nrows, 1, seed=5)[0]
    o = SolverOptions(**OPTS)
    r1 = cg_recycled(A, b, options=o, device="cpu")
    r2 = cg(A, b, options=o, device="cpu")
    assert r1.niterations == r2.niterations and r1.rnrm2 == r2.rnrm2
    np.testing.assert_array_equal(r1.x, r2.x)
    # a basis without its projection is no basis
    W, _ = _basis(A)
    r3 = cg_recycled(A, b, options=o, device="cpu", W=W)
    np.testing.assert_array_equal(r3.x, r2.x)


@pytest.mark.parametrize("batch", [0, 3])
def test_recycled_matches_jax(batch):
    Aj, At = jpoisson.poisson2d_5pt(16), tpoisson.poisson2d_5pt(16)
    B = _rhs(At.nrows, max(batch, 1), seed=6)
    b = B if batch else B[0]
    W = _eigvecs(16, 8)
    WtAW = W.T @ np.stack([At.matvec(w) for w in W.T], axis=1)
    rj = jrecycled(Aj, b, options=JOptions(**OPTS), W=W, WtAW=WtAW)
    rt = cg_recycled(At, b, options=SolverOptions(**OPTS), device="cpu",
                     W=W, WtAW=WtAW)
    cold = cg(At, b, options=SolverOptions(**OPTS), device="cpu")
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    # deflating the lowest modes cuts the iterations
    assert rt.niterations < cold.niterations
    for xi, bi in zip(np.reshape(rt.x, (-1, At.nrows)),
                      np.reshape(b, (-1, At.nrows))):
        assert (np.linalg.norm(bi - At.matvec(xi))
                / np.linalg.norm(bi)) < 1e-9


def test_recycled_device_operator_deflates_with_its_own_product():
    """A prebuilt operator (its product applied on its device) and an RCM
    ordering give the host matrix's deflation."""
    A = tpoisson.poisson2d_5pt(12)
    b = _rhs(A.nrows, 1, seed=7)[0]
    x0 = _rhs(A.nrows, 1, seed=8)[0]
    W, WtAW = _basis(A)
    want = _deflate_x0(A.matvec, b, x0, W, WtAW)
    op = build_device_operator(A, dtype=np.float64, device="cpu")
    got = _deflate_x0(_host_matvec(op), b, x0, W, WtAW)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    from acg_torch.solvers.cg import PermutedOperator
    perm = np.random.default_rng(1).permutation(A.nrows)
    from acg_torch.sparse.rcm import permute_symmetric
    pop = PermutedOperator(build_device_operator(
        permute_symmetric(A, perm), dtype=np.float64, fmt="dia",
        device="cpu"), perm)
    got = _deflate_x0(_host_matvec(pop), b, x0, W, WtAW)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    r = cg_recycled(op, b, x0=x0, options=SolverOptions(**OPTS), W=W,
                    WtAW=WtAW)
    r2 = cg(op, b, x0=want, options=SolverOptions(**OPTS))
    np.testing.assert_array_equal(r.x, r2.x)


@pytest.mark.parametrize("nparts", [2, 4])
def test_recycled_dist_matches_jax(nparts):
    Aj, At = jpoisson.poisson2d_5pt(16), tpoisson.poisson2d_5pt(16)
    b = _rhs(At.nrows, 1, seed=9)[0]
    W = _eigvecs(16, 8)
    WtAW = W.T @ np.stack([At.matvec(w) for w in W.T], axis=1)
    part = partition_graph(At, nparts)
    rj = jrecycled_dist(Aj, b, options=JOptions(**OPTS), nparts=nparts,
                        part=part, W=W, WtAW=WtAW)
    rt = cg_recycled_dist(At, b, options=SolverOptions(**OPTS),
                          nparts=nparts, part=part,
                          devices=["cpu"] * nparts, W=W, WtAW=WtAW)
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    cold = cg_recycled_dist(At, b, options=SolverOptions(**OPTS),
                            nparts=nparts, part=part,
                            devices=["cpu"] * nparts)
    assert rt.niterations < cold.niterations


def test_recycle_state_not_yet_ported():
    A = tpoisson.poisson2d_5pt(8)
    b = np.ones(A.nrows)
    for fn, kw in ((cg_recycled, {"device": "cpu"}),
                   (cg_recycled_dist, {"nparts": 2,
                                       "devices": ["cpu"] * 2})):
        with pytest.raises(AcgError, match="not yet ported") as e:
            fn(A, b, recycle=object(), **kw)
        assert e.value.status == Status.ERR_NOT_SUPPORTED
