"""Port parity for s-step CG: ``acg_torch.solvers.cg.cg_sstep`` and its
pieces on the CPU against ``acg_tpu.solvers.cg.cg_sstep`` on the same
systems and inputs (numpy ``default_rng`` seeds).

- The Leja orders (``_cheb_leja_nodes``, ``ops/sstep_coeffs.leja_order``)
  choose the same points in the same order, and the coefficient step's
  structured Newton product (``newton_apply``) equals the JAX package's
  change-of-basis matrix applied in full: greedy argmaxes and a 0/1 +
  theta matrix.
- ``gram`` / ``block_dot`` / ``combine``, 2-D and batched, to 1e-12
  (f64) and 1e-5 (f32) relative to the largest entry; one basis block
  (V, G) from the same (x, p, shifts) likewise, its padding rows 0.
- Solves: f64 iterations within ±1 and ``x`` within 1e-9 relative of the
  JAX solve's; f32 within the JAX tests' own bounds (iterations within
  s + 2 of each other, true residual below 5 × rtol in both).  Nothing
  rests on bit identity between the packages: the Gram sums and the
  coefficient recurrences round in another order.
- The protocol and the fallback cases: ``test_torch_sstep_fallback.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.ops import blas1 as jblas1
from acg_tpu.ops import sgell as jsgell
from acg_tpu.solvers import loops as jloops
from acg_tpu.solvers.cg import _cheb_leja_nodes as jcheb
from acg_tpu.solvers.cg import _sstep_block_fn as jblock_fn
from acg_tpu.solvers.cg import build_device_operator as jbuild
from acg_tpu.solvers.cg import cg_sstep as jcg_sstep
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.ops import blas1, sstep_coeffs
from acg_torch.solvers.cg import (_cheb_leja_nodes, _sstep_block_fn,
                                  build_device_operator, cg_sstep)
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import poisson as tpoisson

_TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _pair(make, seed):
    """(JAX matrix, port matrix, b): the same generator in both packages
    and the same manufactured right-hand side."""
    Aj, At = make(jpoisson), make(tpoisson)
    _, b = tcsr.manufactured_rhs(At, seed=seed)
    np.testing.assert_array_equal(b, jcsr.manufactured_rhs(Aj, seed=seed)[1])
    return Aj, At, b


def _true_rel(A, x, b):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert np.max(np.abs(got - want)) <= _TOL[dtype] * scale


@pytest.fixture
def jax_sgell_interpret(monkeypatch):
    """The JAX sgell tier in Pallas interpret mode (its TPU kernel cannot
    run here): the pack's constructor and the forced-tier gate skip the
    probe."""
    build, require = jsgell.build_device_sgell, jsgell.sgell_require_available

    def forced_build(A, dtype=None, mat_dtype="auto",
                     min_fill=jsgell.MIN_FILL, interpret=False,
                     _probing=False):
        return build(A, dtype=dtype, mat_dtype=mat_dtype, min_fill=min_fill,
                     interpret=True)

    monkeypatch.setattr(jsgell, "build_device_sgell", forced_build)
    monkeypatch.setattr(jsgell, "sgell_require_available",
                        lambda vdt, interpret=False: require(vdt, True))


# ---------------------------------------------------------------------------
# the pieces


@pytest.mark.parametrize("s", range(1, 17))
def test_cheb_leja_nodes_equal(s):
    np.testing.assert_array_equal(_cheb_leja_nodes(s), jcheb(s))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(2,), (5,), (16,), (3, 4), (4, 7)])
def test_leja_order_equal(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    v = (rng.random(shape) * 8.0 + 0.01).astype(dtype)
    got = sstep_coeffs.leja_order(torch.from_numpy(
        v.reshape(-1, shape[-1]))).numpy().reshape(shape)
    want = np.asarray(jloops._leja_order(jnp.asarray(v)))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("s", [2, 3, 4, 6])
def test_newton_basis_matrix_exact(s, dtype):
    """The coefficient step's structured Newton product equals the JAX
    package's change-of-basis matrix applied in full (the structure only
    drops products with 0 and 1)."""
    rng = np.random.default_rng(s)
    for nsys in (1, 3):
        th = rng.standard_normal((nsys, s)).astype(dtype)
        pc = rng.standard_normal((nsys, 2 * s + 1)).astype(dtype)
        got = sstep_coeffs.newton_apply(
            sstep_coeffs.newton_theta(torch.from_numpy(th), s),
            torch.from_numpy(pc), s).numpy()
        Bmat = np.asarray(jloops._newton_basis_matrix(jnp.asarray(th), s))
        want = np.einsum("bij,bj->bi", Bmat, pc)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_block_dot_combine(dtype):
    rng = np.random.default_rng(7)
    for shape in ((9, 1000), (9, 3, 1000)):
        V = rng.standard_normal(shape).astype(dtype)
        w = rng.standard_normal(shape[1:]).astype(dtype)
        Vt, wt = torch.from_numpy(V), torch.from_numpy(w)
        _close(blas1.gram(Vt).numpy(), jblas1.gram(jnp.asarray(V)), dtype)
        _close(blas1.block_dot(Vt, wt).numpy(),
               jblas1.block_dot(jnp.asarray(V), jnp.asarray(w)), dtype)
        c = rng.standard_normal(shape[1:-1] + (shape[0],)).astype(dtype)
        want = (np.einsum("bm,mbn->bn", c.astype(np.float64), V)
                if len(shape) == 3 else c.astype(np.float64) @ V)
        _close(blas1.combine(torch.from_numpy(c), Vt).numpy(), want, dtype)


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_block_fn_matches_jax(dtype, batch):
    """One basis block and its Gram from the same (x, p, shifts) on the
    same DIA operator, n not a multiple of 8: the padding rows of every
    basis vector stay exactly 0."""
    s = 4
    Aj, At, _ = _pair(lambda m: m.poisson3d_7pt(7, 6, 5), 0)
    dj = jbuild(Aj, dtype=dtype, fmt="dia")
    dt = build_device_operator(At, dtype=dtype, fmt="dia", device="cpu")
    n = At.nrows
    rng = np.random.default_rng(3)
    lead = (batch,) if batch else ()

    def vec():
        v = rng.standard_normal(lead + (n,)).astype(dtype)
        return v

    b, x, p = vec(), vec(), vec()
    shifts = (rng.random(lead + (s,)) * 10 + 1).astype(dtype)

    def padj(v):
        out = np.zeros(lead + (dj.nrows_padded,), dtype)
        out[..., :n] = v
        return jnp.asarray(out)

    def padt(v):
        out = np.zeros(lead + (dt.nrows_padded,), dtype)
        out[..., :n] = v
        return torch.from_numpy(out)

    Vj, Gj = jblock_fn(dj.matvec, padj(b), s, bool(batch))(
        padj(x), padj(p), jnp.asarray(shifts))
    Vt, Gt = _sstep_block_fn(dt.matvec, padt(b), s)(padt(x), padt(p),
                                                    shifts)
    assert dt.nrows_padded > n
    assert torch.all(Vt[..., n:] == 0)
    _close(Vt[..., :n].numpy(), np.asarray(Vj)[..., :n], dtype)
    _close(Gt.numpy(), Gj, dtype)


# ---------------------------------------------------------------------------
# solves against the JAX package


def _opts(s, **kw):
    base = dict(maxits=2000, residual_rtol=1e-10, sstep=s)
    base.update(kw)
    return base


@pytest.mark.parametrize("s", [2, 3, 4, 6])
def test_sstep_matches_jax_f64(s):
    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(8), 0)
    rj = jcg_sstep(Aj, b, options=JOptions(**_opts(s)))
    rt = cg_sstep(At, b, options=SolverOptions(**_opts(s)), device="cpu")
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    assert rt.relative_residual < 1e-10
    assert _true_rel(At, rt.x, b) < 1e-9
    assert (rt.operator_format, rt.kernel, rt.kernel_note) == (
        "stencil", "torch-plain", "")
    # the residual trajectory, certified at its last sample
    h = rt.residual_history
    assert h.shape == (rt.niterations + 1,) and np.all(np.isfinite(h))
    np.testing.assert_allclose(np.sqrt(h[-1]), rt.rnrm2, rtol=1e-12)
    k = min(rt.niterations, rj.niterations) + 1
    np.testing.assert_allclose(h[:k], rj.residual_history[:k], rtol=1e-6,
                               atol=1e-12 * h[0])


@pytest.mark.parametrize("s", [2, 4])
def test_sstep_matches_jax_f32(s):
    rtol = 1e-5
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(16), 1)
    o = dict(maxits=4000, residual_rtol=rtol, sstep=s)
    rj = jcg_sstep(Aj, b, dtype=np.float32, options=JOptions(**o))
    rt = cg_sstep(At, b, dtype=np.float32, options=SolverOptions(**o),
                  device="cpu")
    assert rt.converged and rj.converged
    assert rt.x.dtype == np.float32
    assert abs(rt.niterations - rj.niterations) <= s + 2
    assert _true_rel(At, rt.x, b) < 5 * rtol
    assert _true_rel(Aj, rj.x, b) < 5 * rtol


def test_sstep_batched_matches_jax_and_one_system():
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 2)
    B = np.stack([b, 2 * b, -0.5 * b])
    rj = jcg_sstep(Aj, B, options=JOptions(**_opts(4)))
    rt = cg_sstep(At, B, options=SolverOptions(**_opts(4)), device="cpu")
    assert rt.nrhs == 3 and np.all(rt.converged_per_system)
    assert np.all(np.abs(rt.iterations_per_system
                         - rj.iterations_per_system) <= 1)
    assert rt.niterations == int(np.max(rt.iterations_per_system))
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    for i, scale in enumerate((1.0, 2.0, -0.5)):
        r1 = cg_sstep(At, scale * b, options=SolverOptions(**_opts(4)),
                      device="cpu")
        np.testing.assert_allclose(rt.x[i], r1.x, atol=1e-9)
        assert rt.iterations_per_system[i] == r1.niterations
    assert rt.residual_history.shape == (3, rt.niterations + 1)


@pytest.mark.parametrize("fmt,dtype", [("stencil", np.float64),
                                       ("dia", np.float64),
                                       ("ell", np.float64),
                                       ("sgell", np.float32)])
def test_sstep_forced_formats(fmt, dtype, request):
    if fmt == "sgell":
        request.getfixturevalue("jax_sgell_interpret")
    rtol = 1e-10 if dtype == np.float64 else 1e-5
    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(6, 5, 7), 4)
    o = dict(maxits=2000, residual_rtol=rtol, sstep=4)
    rj = jcg_sstep(Aj, b, dtype=dtype, fmt=fmt, options=JOptions(**o))
    rt = cg_sstep(At, b, dtype=dtype, fmt=fmt, options=SolverOptions(**o),
                  device="cpu")
    assert rt.converged and rj.converged
    assert rt.operator_format == rj.operator_format == fmt
    assert rt.kernel_note == f"format forced: {fmt}"
    if dtype == np.float64:
        assert abs(rt.niterations - rj.niterations) <= 1
        assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    else:
        assert abs(rt.niterations - rj.niterations) <= 4 + 2
        assert _true_rel(At, rt.x, b) < 5 * rtol


def test_sstep_prebuilt_operator_is_the_same_solve():
    _, At, b = _pair(lambda m: m.poisson3d_7pt(8), 5)
    op = build_device_operator(At, dtype=np.float64, device="cpu")
    o = SolverOptions(**_opts(4))
    r1 = cg_sstep(At, b, options=o, device="cpu")
    r2 = cg_sstep(op, b, options=o)
    assert r1.niterations == r2.niterations
    np.testing.assert_array_equal(r1.x, r2.x)


def test_sstep_shifts0_seed_matches_jax():
    """A given seed skips the power-iteration prelude in both packages."""
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 6)
    sh = np.array([7.5, 0.5, 4.0, 2.0])
    rj = jcg_sstep(Aj, b, options=JOptions(**_opts(4)), shifts0=sh)
    rt = cg_sstep(At, b, options=SolverOptions(**_opts(4)), shifts0=sh,
                  device="cpu")
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
