"""Port parity for the multi-RHS slice: the batched SpMVs' plain versions,
batched ``cg`` / ``cg_pipelined`` on the CPU and ``--nrhs``, against the
JAX package on the same (B, n) systems.

- Kernels: the plain batched DIA matvec against
  ``dia_matvec_pallas_2d_padded_batched(interpret=True)`` over the band
  tiers, and the plain batched stencil matvec against
  ``stencil_matvec_pallas_padded_batched(interpret=True)``, on operands
  padded with JAX's own helpers and sliced back.  Vectors at f64 rtol
  1e-12, f32 rtol/atol 1e-5 (relative to the largest entry); the
  per-system dots at 1e-10 (f64) / 1e-4 (f32) of |x_s|·|y_s| (fused
  multiply-adds and another summation order).  Each row of a batched
  plain version equals the 1-D plain version on that row exactly.
- Solves: per-system iteration counts equal at f64 and within ±1 at f32
  (reduction order can move a system across the threshold at f32), x
  and histories at the ``_hist_close`` tolerances of
  ``tests/test_batched.py``, NaN past each system's own exit, and
  ``converged_per_system``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.ops import blas1 as jblas1
from acg_tpu.ops import dia as jdia
from acg_tpu.ops import pallas_kernels as pk
from acg_tpu.ops import stencil as jst
from acg_tpu.solvers import base as jbase
from acg_tpu.solvers.cg import cg as jcg
from acg_tpu.solvers.cg import cg_pipelined as jcg_pipelined
from acg_tpu.sparse import poisson as jpoisson

from acg_torch import convert
from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, read_mtx, write_mtx
from acg_torch.ops import blas1, dia_kernels
from acg_torch.ops import stencil as tst
from acg_torch.ops.dia import DeviceDia, DiaMatrix
from acg_torch.solvers import base as tbase
from acg_torch.solvers import loops
from acg_torch.solvers.cg import _describe_path, build_device_operator, cg
from acg_torch.solvers.cg import cg_pipelined
from acg_torch.sparse import poisson as tpoisson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS_TILE = 8
B = 3
_TOL = {np.float64: (1e-12, 0.0, 1e-10), np.float32: (1e-5, 1e-5, 1e-4)}
OPTS = dict(maxits=400, residual_rtol=1e-8)
SOLVERS = {"cg": (cg, jcg), "cg_pipelined": (cg_pipelined, jcg_pipelined)}


def _batch(nrows, npad, dtype, nsys=B, seed=11):
    """(nsys, npad) random rows, zero past nrows."""
    X = np.zeros((nsys, npad), dtype=dtype)
    X[:, :nrows] = np.random.default_rng(seed).standard_normal((nsys, nrows))
    return X


def _assert_rows(got, want, dtype):
    rtol, atol, _ = _TOL[dtype]
    assert got.shape == want.shape and got.dtype == dtype
    assert np.max(np.abs(got - want)) <= atol + rtol * np.max(np.abs(want))


def _assert_dots(got, want, X, Y, dtype):
    _, _, dot_rtol = _TOL[dtype]
    assert got.shape == want.shape == (X.shape[0],)
    X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
    scale = np.linalg.norm(X64, axis=-1) * np.linalg.norm(Y64, axis=-1)
    assert np.all(np.abs(got.astype(np.float64) - want) <= dot_rtol * scale)


# ---------------------------------------------------------------------------
# the batched DIA SpMV


def _random_bands(n=2048, seed=7):
    offsets = (-300, -128, -1, 0, 1, 128, 300)
    bands = np.random.default_rng(seed).standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            bands[d, n - off:] = 0.0
        elif off < 0:
            bands[d, :-off] = 0.0
    return jdia.DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))


_OPERATORS = {
    "poisson2d": lambda: jdia.DiaMatrix.from_csr(jpoisson.poisson2d_5pt(32)),
    "poisson3d": lambda: jdia.DiaMatrix.from_csr(jpoisson.poisson3d_7pt(16)),
    "varcoef": lambda: jdia.DiaMatrix.from_csr(
        jpoisson.poisson3d_7pt_varcoef(16)),
    "random": _random_bands,
}
# every band tier the operator has: auto (bf16 where exact), the int8
# mask (two-valued bands only), full width
_CASES = [(op, mat) for op in _OPERATORS for mat in ("auto", "int8", None)
          if not (mat == "int8" and op in ("varcoef", "random"))]


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("op_name,mat_dtype", _CASES)
def test_dia_spmv_batched_matches_pallas_batched(op_name, mat_dtype, vdt):
    """Y and the per-system dots against the JAX batched kernel in
    interpret mode; without the dot the port gives the same Y bits."""
    D = _OPERATORS[op_name]()
    jdev = jdia.DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat_dtype)
    tdev = convert.device_dia_from_arrays(
        np.asarray(jdev.bands),
        None if jdev.scales is None else np.asarray(jdev.scales),
        jdev.offsets, jdev.nrows, jdev.ncols, jdev.nnz, vdt, device="cpu")
    n = jdev.nrows_padded
    X = _batch(jdev.nrows, n, vdt)
    bp, (xp,) = pk.pad_dia_operands(jdev.bands, (jnp.asarray(X),),
                                    ROWS_TILE, jdev.offsets)
    front = pk.padded_halo_rows(jdev.offsets, ROWS_TILE) * pk.LANES
    yj, dj = pk.dia_matvec_pallas_2d_padded_batched(
        bp, jdev.offsets, xp, rows_tile=ROWS_TILE, with_dot=True,
        interpret=True, scales=jdev.scales)
    yj = np.asarray(yj)[:, front: front + n]
    Xt = torch.from_numpy(X)
    before = dia_kernels.batched_launches
    Y, d = dia_kernels.dia_spmv_batched(tdev.bands, tdev.scales,
                                        tdev.offsets_t, Xt, with_dot=True)
    assert dia_kernels.batched_launches == before      # the CPU runs no kernel
    _assert_rows(Y.numpy(), yj, vdt)
    _assert_dots(d.numpy(), np.asarray(dj, dtype=np.float64), X, yj, vdt)
    assert torch.equal(tdev.matvec(Xt), Y)
    assert torch.equal(tdev.matvec_dot(Xt)[1], d)


@pytest.mark.parametrize("mat_dtype", ["auto", "int8", None])
def test_dia_batched_rows_equal_the_1d_plain_version(mat_dtype):
    """Row s of the batched plain SpMV and its dot are the 1-D plain
    version's on row s, bit for bit (the property the card's kernel
    holds against the 1-D kernel)."""
    D = DiaMatrix.from_csr(tpoisson.poisson3d_7pt(9, 10, 11))
    dev = DeviceDia.from_dia(D, dtype=np.float32, mat_dtype=mat_dtype,
                             device="cpu")
    X = torch.from_numpy(_batch(D.nrows, D.nrows_padded, np.float32, 5))
    Y, d = dev.matvec_dot(X)
    for s in range(X.shape[0]):
        y, ds = dev.matvec_dot(X[s].clone())
        assert torch.equal(Y[s], y) and torch.equal(d[s], ds)


def test_dia_spmv_batched_rejects_unknown_device_type():
    D = DiaMatrix.from_csr(tpoisson.poisson2d_5pt(4))
    dev = DeviceDia.from_dia(D, device="cpu")
    X = torch.zeros((2, D.nrows_padded), dtype=torch.float64, device="meta")
    with pytest.raises(AcgError):
        dia_kernels.dia_spmv_batched(dev.bands, dev.scales, dev.offsets_t, X)


# ---------------------------------------------------------------------------
# the batched stencil SpMV

_STENCILS = {
    "poisson2d_5pt": lambda m: m.poisson2d_5pt(32),
    "poisson2d_5pt_rect": lambda m: m.poisson2d_5pt(16, 24),
    "poisson3d_7pt": lambda m: m.poisson3d_7pt(16),
    "poisson3d_7pt_ragged": lambda m: m.poisson3d_7pt(9, 10, 11),
    "poisson3d_27pt": lambda m: m.poisson3d_27pt(8),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(_STENCILS))
def test_stencil_spmv_batched_matches_pallas_batched(name, dtype):
    jdev = jst.DeviceStencil.from_matrix(_STENCILS[name](jpoisson),
                                         dtype=dtype)
    tdev = convert.device_stencil_from_fields(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, jdev.nrows,
        jdev.nnz, dtype, device="cpu")
    n = jdev.nrows
    npad = -(-n // pk.LANES) * pk.LANES
    X = _batch(n, npad, dtype)
    (xp,), front = pk.pad_dia_vectors((jnp.asarray(X),), npad, ROWS_TILE,
                                      jdev.offsets)
    yj, dj = jst.stencil_matvec_pallas_padded_batched(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, xp,
        rows_tile=ROWS_TILE, n=n, with_dot=True, interpret=True)
    yj = np.asarray(yj)[:, front: front + npad]
    Xt = torch.from_numpy(X)
    before = tst.batched_launches
    Y, d = tst.stencil_spmv_batched(tdev.spec, Xt, with_dot=True)
    assert tst.batched_launches == before
    _assert_rows(Y.numpy(), yj, dtype)
    assert np.all(Y.numpy()[:, n:] == 0.0)
    _assert_dots(d.numpy(), np.asarray(dj, dtype=np.float64), X, yj, dtype)
    assert torch.equal(tdev.matvec(Xt), Y)
    # each row, exactly the 1-D plain version on that row
    for s in range(B):
        y, ds = tst.stencil_spmv(tdev.spec, Xt[s].clone(), with_dot=True)
        assert torch.equal(Y[s], y) and torch.equal(d[s], ds)


def test_stencil_spmv_batched_rejects_bad_shapes():
    spec, _ = tst.recognize_stencil(tpoisson.poisson2d_5pt(8))
    with pytest.raises(AcgError):
        tst.stencil_spmv_batched(spec, torch.zeros((2, 64),
                                                   dtype=torch.float64,
                                                   device="meta"))


# ---------------------------------------------------------------------------
# BLAS-1


def test_blas1_batched_matches_jax():
    rng = np.random.default_rng(8)
    X, Y = rng.standard_normal((4, 300)), rng.standard_normal((4, 300))
    got = blas1.batched_dot(torch.from_numpy(X), torch.from_numpy(Y))
    want = np.asarray(jblas1.batched_dot(jnp.asarray(X), jnp.asarray(Y)))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)
    np.testing.assert_allclose(
        blas1.dnrm2(torch.from_numpy(X), 7).numpy(),
        np.asarray(jblas1.dnrm2(jnp.asarray(X), nexclude=7)), rtol=1e-13)
    # 1-D operands: exactly torch.dot
    x, y = torch.from_numpy(X[0]), torch.from_numpy(Y[0])
    assert torch.equal(blas1.batched_dot(x, y), torch.dot(x, y))


def test_pipelined_update_broadcasts_per_system_coefficients():
    rng = np.random.default_rng(2)
    vecs = [torch.from_numpy(rng.standard_normal((3, 40))) for _ in range(7)]
    alpha = torch.tensor([0.5, -1.25, 2.0], dtype=torch.float64)
    beta = torch.tensor([0.0, 0.75, -3.0], dtype=torch.float64)
    got = blas1.pipelined_update(*vecs, alpha, beta)
    for s in range(3):
        want = blas1.pipelined_update(*[v[s] for v in vecs], alpha[s],
                                      beta[s])
        for g, w in zip(got, want):
            assert torch.equal(g[s], w)


# ---------------------------------------------------------------------------
# batched solves against the JAX package


def _hist_close(got, want, rtol, floor_rel):
    """``tests/test_batched.py``'s trajectory check: entrywise down to the
    attainable-accuracy floor, pure rounding noise below it."""
    w0 = float(want[0]) if want[0] > 0 else 1.0
    floor = floor_rel * w0
    big = want > floor
    np.testing.assert_allclose(got[big], want[big], rtol=rtol)
    assert np.all(got[~big] <= np.maximum(1e3 * want[~big], 10 * floor))


def _rhs(A, nsys=B, seed=0):
    """Systems that converge at different counts: ones, a smooth
    right-hand side (A·1), and noise."""
    rng = np.random.default_rng(seed)
    bs = [np.ones(A.nrows), A.matvec(np.ones(A.nrows))]
    bs += [rng.standard_normal(A.nrows) for _ in range(nsys - 2)]
    return np.stack(bs[:nsys])


def _assert_matches_jax(rt, rj, f32=False, x_rtol=1e-6, hist_rtol=1e-5,
                        floor_rel=1e-14):
    assert rt.nrhs == rj.nrhs
    kt = np.asarray(rt.iterations_per_system)
    kj = np.asarray(rj.iterations_per_system)
    if f32:
        assert np.all(np.abs(kt - kj) <= 1)
    else:
        np.testing.assert_array_equal(kt, kj)
    assert rt.niterations == kt.max()
    np.testing.assert_array_equal(rt.converged_per_system,
                                  rj.converged_per_system)
    assert rt.residual_history.shape == (rt.nrhs, rt.niterations + 1)
    for s in range(rt.nrhs):
        np.testing.assert_allclose(rt.x[s], rj.x[s], rtol=x_rtol,
                                   atol=x_rtol * np.abs(rj.x[s]).max())
        k = min(kt[s], kj[s]) + 1
        _hist_close(rt.residual_history[s, :k], rj.residual_history[s, :k],
                    hist_rtol, floor_rel)
        # the freeze: the history stops at this system's own exit
        assert np.all(np.isnan(rt.residual_history[s, kt[s] + 1:]))
        assert np.all(np.isfinite(rt.residual_history[s, : kt[s] + 1]))


@pytest.mark.parametrize("fmt", ["auto", "dia"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_solve_matches_jax_f64(solver, fmt):
    tsolve, jsolve = SOLVERS[solver]
    At, Aj = tpoisson.poisson2d_5pt(16), jpoisson.poisson2d_5pt(16)
    bb = _rhs(At)
    rj = jsolve(Aj, bb, options=JOptions(**OPTS), fmt=fmt)
    rt = tsolve(At, bb, options=SolverOptions(**OPTS), fmt=fmt, device="cpu")
    # the pipelined recurrence amplifies reduction-order noise along the
    # solve (tests/test_batched.py): same exits, looser trajectory tail
    pipelined = solver == "cg_pipelined"
    _assert_matches_jax(rt, rj, hist_rtol=1e-3 if pipelined else 1e-5,
                        floor_rel=1e-12 if pipelined else 1e-14)
    assert rt.converged and all(rt.converged_per_system)
    assert len(set(rt.iterations_per_system)) == B     # three exits
    assert rt.operator_format == ("dia" if fmt == "dia" else "stencil")
    assert rt.kernel == "torch-plain"
    for s in range(B):                                 # certified exits
        true = np.linalg.norm(bb[s] - At.matvec(rt.x[s]))
        assert true <= 10 * OPTS["residual_rtol"] * np.linalg.norm(bb[s])


@pytest.mark.parametrize("mat_dtype", ["auto", None])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_solve_matches_jax_f32(solver, mat_dtype):
    """f32 vectors over bf16 (exact) or full-width f32 bands: counts
    within ±1 (the JAX package's own batched and sequential f32 counts
    differ by one on such systems).  Pipelined at rtol 1e-4: at 1e-5 its
    f32 recurrence reaches its attainable floor on these systems, where
    the JAX package's own batched and sequential counts part by four
    (22 against 18)."""
    tsolve, jsolve = SOLVERS[solver]
    At, Aj = tpoisson.poisson3d_7pt(10), jpoisson.poisson3d_7pt(10)
    bb = _rhs(At)
    o = dict(maxits=400,
             residual_rtol=1e-4 if solver == "cg_pipelined" else 1e-5)
    rj = jsolve(Aj, bb, options=JOptions(**o), dtype=np.float32, fmt="dia",
                mat_dtype=mat_dtype)
    rt = tsolve(At, bb, options=SolverOptions(**o), dtype=np.float32,
                fmt="dia", mat_dtype=mat_dtype, device="cpu")
    assert rt.x.dtype == np.float32
    _assert_matches_jax(rt, rj, f32=True, x_rtol=2e-3,
                        hist_rtol=5e-2 if solver == "cg_pipelined" else 1e-2,
                        floor_rel=1e-6)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_equals_sequential_port_solves(solver):
    """On the CPU a batched solve gives every system exactly the bits of
    its own 1-D solve: the batched SpMV's rows and ``batched_dot`` are
    the 1-D reductions row by row."""
    tsolve, _ = SOLVERS[solver]
    At = tpoisson.poisson3d_7pt_varcoef(8)
    bb = _rhs(At, 4)
    o = SolverOptions(**OPTS)
    rb = tsolve(At, bb, options=o, device="cpu")
    assert rb.operator_format == "dia"
    for s in range(4):
        r1 = tsolve(At, bb[s], options=o, device="cpu")
        assert rb.iterations_per_system[s] == r1.niterations
        np.testing.assert_array_equal(rb.x[s], r1.x)
        np.testing.assert_array_equal(
            rb.residual_history[s, : r1.niterations + 1],
            r1.residual_history)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_zero_rhs_converges_at_zero(solver):
    tsolve, jsolve = SOLVERS[solver]
    At, Aj = tpoisson.poisson2d_5pt(12), jpoisson.poisson2d_5pt(12)
    bb = np.stack([np.ones(At.nrows), np.zeros(At.nrows)])
    rt = tsolve(At, bb, options=SolverOptions(**OPTS), device="cpu")
    rj = jsolve(Aj, bb, options=JOptions(**OPTS))
    r1 = tsolve(At, bb[0], options=SolverOptions(**OPTS), device="cpu")
    assert list(rt.iterations_per_system) == \
        list(rj.iterations_per_system) == [r1.niterations, 0]
    assert rt.residual_history[1, 0] == 0.0
    assert np.all(np.isnan(rt.residual_history[1, 1:]))
    np.testing.assert_array_equal(rt.x[1], np.zeros(At.nrows))
    np.testing.assert_allclose(rt.x[0], r1.x, rtol=1e-9)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_b1_matches_1d_path(solver):
    tsolve, _ = SOLVERS[solver]
    At = tpoisson.poisson2d_5pt(12)
    b = np.ones(At.nrows)
    r = tsolve(At, b, options=SolverOptions(**OPTS), device="cpu")
    rb = tsolve(At, b[None, :], options=SolverOptions(**OPTS), device="cpu")
    assert rb.nrhs == 1 and rb.x.shape == (1, At.nrows)
    assert list(rb.iterations_per_system) == [r.niterations]
    np.testing.assert_allclose(rb.residual_history[0], r.residual_history,
                               rtol=1e-12)
    np.testing.assert_allclose(rb.x[0], r.x, rtol=1e-12)


def test_batched_not_converged_raises_with_per_system_result():
    At, Aj = tpoisson.poisson2d_5pt(16), jpoisson.poisson2d_5pt(16)
    bb = _rhs(At, 2)
    o = dict(maxits=3, residual_rtol=1e-12)
    with pytest.raises(JAcgError) as ej:
        jcg(Aj, bb, options=JOptions(**o))
    with pytest.raises(AcgError) as et:
        cg(At, bb, options=SolverOptions(**o), device="cpu")
    assert int(et.value.status) == int(ej.value.status) == \
        int(Status.ERR_NOT_CONVERGED)
    res = et.value.result
    assert res.nrhs == 2 and res.status == Status.ERR_NOT_CONVERGED
    assert list(res.iterations_per_system) == [3, 3]
    assert not any(res.converged_per_system)
    np.testing.assert_allclose(res.rnrm2_per_system,
                               ej.value.result.rnrm2_per_system, rtol=1e-8)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_relative_residual_pairs_one_system(solver):
    """rnrm2, r0nrm2 and bnrm2 come from ONE system, the worst by
    relative residual, as in the JAX package."""
    tsolve, jsolve = SOLVERS[solver]
    At, Aj = tpoisson.poisson2d_5pt(12), jpoisson.poisson2d_5pt(12)
    rng = np.random.default_rng(7)
    bb = np.stack([1e6 * np.ones(At.nrows), rng.standard_normal(At.nrows)])
    o = dict(maxits=4, residual_rtol=1e-12)
    with pytest.raises(AcgError) as et:
        tsolve(At, bb, options=SolverOptions(**o), device="cpu")
    with pytest.raises(JAcgError) as ej:
        jsolve(Aj, bb, options=JOptions(**o))
    res, jres = et.value.result, ej.value.result
    rel = res.rnrm2_per_system / res.r0nrm2_per_system
    worst = int(np.argmax(rel))
    assert worst == int(np.argmax(jres.rnrm2_per_system
                                  / jres.r0nrm2_per_system))
    assert res.relative_residual == pytest.approx(rel.max(), rel=1e-12)
    assert res.bnrm2 == pytest.approx(res.r0nrm2_per_system[worst],
                                      rel=1e-12)
    assert res.relative_residual == pytest.approx(jres.relative_residual,
                                                  rel=1e-6)


def test_batched_x0_shape_contract():
    At, Aj = tpoisson.poisson2d_5pt(10), jpoisson.poisson2d_5pt(10)
    bb = _rhs(At, 2)
    x0 = 0.5 * bb[0]
    o = SolverOptions(**OPTS)
    res = cg(At, bb, x0=x0, options=o, device="cpu")
    r0 = cg(At, bb[0], x0=x0, options=o, device="cpu")
    rj = jcg(Aj, bb, x0=x0, options=JOptions(**OPTS))
    assert res.iterations_per_system[0] == r0.niterations
    np.testing.assert_array_equal(res.iterations_per_system,
                                  rj.iterations_per_system)
    np.testing.assert_allclose(res.x[0], r0.x, rtol=1e-6)
    res2 = cg(At, bb, x0=np.stack([x0, x0]), options=o, device="cpu")
    np.testing.assert_array_equal(res2.x, res.x)
    for bad in (np.zeros((3, At.nrows)), np.zeros((2, 5))):
        with pytest.raises(AcgError) as e:
            cg(At, bb, x0=bad, options=o, device="cpu")
        assert e.value.status == Status.ERR_INVALID_VALUE
    with pytest.raises(AcgError) as e:               # 2-D x0, 1-D b
        cg(At, bb[0], x0=np.zeros((1, At.nrows)), options=o, device="cpu")
    assert e.value.status == Status.ERR_INVALID_VALUE
    # the contract itself, beside the JAX one
    for xs, bs in (((100,), (2, 100)), ((2, 100), (2, 100)),
                   ((3, 100), (2, 100))):
        tx, jx = np.zeros(xs), np.zeros(xs)
        try:
            want = jbase.conform_x0_batch(jx, bs, lambda v: np.tile(v, (2, 1)))
        except JAcgError:
            with pytest.raises(AcgError):
                tbase.conform_x0_batch(tx, bs, lambda v: np.tile(v, (2, 1)))
        else:
            got = tbase.conform_x0_batch(tx, bs, lambda v: np.tile(v, (2, 1)))
            assert got.shape == want.shape


def test_batched_rhs_shapes_rejected():
    At = tpoisson.poisson2d_5pt(6)
    for bad in (np.zeros((2, 2, At.nrows)), np.zeros((0, At.nrows)),
                np.zeros((2, 7))):
        with pytest.raises(AcgError) as e:
            cg(At, bad, device="cpu")
        assert e.value.status == Status.ERR_INVALID_VALUE


@pytest.mark.parametrize("check_every", [2, 5])
def test_batched_check_every_matches_jax(check_every):
    At, Aj = tpoisson.poisson3d_7pt(8), jpoisson.poisson3d_7pt(8)
    bb = _rhs(At)
    o = dict(OPTS, check_every=check_every)
    for tsolve, jsolve in SOLVERS.values():
        rt = tsolve(At, bb, options=SolverOptions(**o), device="cpu")
        rj = jsolve(Aj, bb, options=JOptions(**o))
        np.testing.assert_array_equal(rt.iterations_per_system,
                                      rj.iterations_per_system)
        assert np.all(rt.iterations_per_system % check_every == 0)


def test_batched_diffrtol_is_per_system():
    """diffrtol scales by each system's own |x0|, as in the JAX package."""
    At, Aj = tpoisson.poisson2d_5pt(12), jpoisson.poisson2d_5pt(12)
    bb = _rhs(At, 2)
    x0 = np.stack([np.ones(At.nrows), 1e-3 * np.ones(At.nrows)])
    o = dict(maxits=400, residual_rtol=0.0, diffrtol=1e-6)
    rt = cg(At, bb, x0=x0, options=SolverOptions(**o), device="cpu")
    rj = jcg(Aj, bb, x0=x0, options=JOptions(**o))
    assert all(rt.converged_per_system)
    np.testing.assert_array_equal(rt.iterations_per_system,
                                  rj.iterations_per_system)
    assert rt.iterations_per_system[0] != rt.iterations_per_system[1]


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_fixed_iteration_protocol(solver):
    tsolve, _ = SOLVERS[solver]
    At = tpoisson.poisson2d_5pt(10)
    res = tsolve(At, _rhs(At, 2), options=SolverOptions(maxits=20,
                                                        residual_rtol=0.0),
                 device="cpu")
    assert list(res.iterations_per_system) == [20, 20]
    assert res.residual_history.shape == (2, 21)
    assert np.all(np.isfinite(res.residual_history))
    assert res.converged and all(res.converged_per_system)
    # flops count every system's iterations
    assert res.stats.nflops == 40 * tbase.cg_flops_per_iter(
        At.nnz, At.nrows, solver == "cg_pipelined")


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_batched_guard_faults_one_system(solver):
    """A non-finite right-hand side in one system: the guard raises
    ERR_FAULT_DETECTED for the batch, and the healthy system still
    converges to its own solve's answer."""
    tsolve, _ = SOLVERS[solver]
    At = tpoisson.poisson2d_5pt(12)
    bb = _rhs(At, 2)
    bb[1, 5] = np.nan
    o = SolverOptions(maxits=400, residual_rtol=1e-8, guard_nonfinite=True)
    with pytest.raises(AcgError) as e:
        tsolve(At, bb, options=o, device="cpu")
    assert e.value.status == Status.ERR_FAULT_DETECTED
    res = e.value.result
    r0 = tsolve(At, bb[0], options=o, device="cpu")
    assert res.iterations_per_system[0] == r0.niterations
    assert res.iterations_per_system[1] <= 1
    np.testing.assert_array_equal(res.x[0], r0.x)
    assert list(res.converged_per_system) == [True, False]


def test_pipelined_batched_replacement_and_refusal():
    """replace_every runs in the batched loop; the single-kernel
    iteration (iter_step) is not batched and is refused."""
    At, Aj = tpoisson.poisson2d_5pt(16), jpoisson.poisson2d_5pt(16)
    bb = _rhs(At)
    o = dict(OPTS, replace_every=10)
    rt = cg_pipelined(At, bb, options=SolverOptions(**o), device="cpu")
    rj = jcg_pipelined(Aj, bb, options=JOptions(**o))
    assert np.all(np.abs(rt.iterations_per_system
                         - rj.iterations_per_system) <= 1)
    assert "pipe disengaged: nrhs=3" in rt.kernel_note
    bt = torch.from_numpy(bb)
    zero = torch.zeros((), dtype=torch.float64)
    with pytest.raises(ValueError, match="not batched"):
        loops.cg_pipelined_while(lambda v: v, None, bt, bt, (zero, zero), 5,
                                 iter_step=lambda *a: a)


def test_batched_path_names():
    op = build_device_operator(tpoisson.poisson2d_5pt(8), device="cpu")
    assert _describe_path(op, "auto", batch=4) == ("stencil", "torch-plain",
                                                   "")
    assert tbase.path_names("stencil", "cuda", "batched") == (
        "stencil", "cuda-stencil-batched")
    assert tbase.path_names("dia", "cuda", "batched") == (
        "dia", "cuda-dia-batched")
    assert tbase.kernel_disengagement_note(
        True, False, 0, stencil=True, batch=8) == (
        "stencil pipe disengaged: nrhs=8 (the single-kernel iteration is "
        "not batched)")
    assert _describe_path(op, "dia", True, 0, 2)[2] == (
        "format forced: dia; stencil pipe disengaged: nrhs=2 (the "
        "single-kernel iteration is not batched)")


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = tpoisson.poisson3d_7pt(8)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("cli") / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "acg_torch.cli", *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


@pytest.mark.parametrize("solver", ["acg", "acg-pipelined"])
def test_cli_nrhs_writes_the_first_system(matrix_file, tmp_path, solver):
    out = str(tmp_path / "x.mtx")
    r = _cli(matrix_file, "--device", "cpu", "--solver", solver, "--nrhs",
             "2", "--manufactured-solution", "--max-iterations", "400",
             "--output-solution", out, "-v")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "right-hand sides (batched): 2" in r.stdout
    assert "note: --nrhs 2: writing the first system's solution" in r.stderr
    assert ("dia_spmv_batched 0, stencil_spmv_batched 0") in r.stderr
    x = read_mtx(out).vals
    assert x.shape == (8 ** 3,) and np.all(np.isfinite(x))
    err = float(r.stdout.split("manufactured solution error: ")[1].split()[0])
    assert err < 1e-6


def test_cli_nrhs_zero_is_rejected(matrix_file):
    r = _cli(matrix_file, "--device", "cpu", "--nrhs", "0", "-q")
    assert r.returncode == 1
    assert "--nrhs must be >= 1" in r.stderr
