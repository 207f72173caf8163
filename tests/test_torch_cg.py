"""Port parity for the slice end to end: ``acg_torch.solvers.cg.cg`` on the
CPU against ``acg_tpu.solvers.cg.cg`` on the same system.

The same generator builds the matrix in both packages and the same numpy
``default_rng(seed)`` makes the manufactured solution, in f64 at rtol
1e-10.  Held: iteration counts within ±1, ‖x_port − x_jax‖/‖x_jax‖ ≤
1e-8, and both certified true residuals ‖b − A·x‖/‖b‖ below rtol (they
are compared against the host matrix, never on bit identity between the
two packages' formulations).
"""

import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.solvers.cg import cg as jcg
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.solvers.cg import build_device_operator, cg
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import poisson as tpoisson

RTOL = 1e-10

_SYSTEMS = {
    "poisson2d_32": lambda m: m.poisson2d_5pt(32),
    "poisson3d_16": lambda m: m.poisson3d_7pt(16),
    "varcoef_12": lambda m: m.poisson3d_7pt_varcoef(12),
}


def _systems(name, seed=4):
    Aj = _SYSTEMS[name](jpoisson)
    At = _SYSTEMS[name](tpoisson)
    xs, b = tcsr.manufactured_rhs(At, seed=seed)
    xsj, bj = jcsr.manufactured_rhs(Aj, seed=seed)
    np.testing.assert_array_equal(b, bj)
    return Aj, At, b


def _true_rel(A, x, b):
    return np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)


@pytest.mark.parametrize("fmt", ["auto", "dia"])
@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_cg_matches_jax(name, fmt):
    Aj, At, b = _systems(name)
    o = dict(maxits=2000, residual_rtol=RTOL)
    rj = jcg(Aj, b, options=JOptions(**o), dtype=np.float64)
    rt = cg(At, b, options=SolverOptions(**o), dtype=np.float64, fmt=fmt,
            device="cpu")
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    assert _true_rel(At, rt.x, b) < RTOL
    assert _true_rel(Aj, rj.x, b) < RTOL
    assert rt.operator_format == (
        "dia" if fmt == "dia" or name.startswith("varcoef") else "stencil")
    assert rt.kernel == "torch-plain"
    assert rt.kernel_note == ("format forced: dia" if fmt == "dia" else "")
    # the residual trajectory rides along like the JAX one
    assert rt.residual_history.shape == (rt.niterations + 1,)
    k = min(rt.niterations, rj.niterations) + 1
    np.testing.assert_allclose(rt.residual_history[:k],
                               rj.residual_history[:k], rtol=1e-6,
                               atol=1e-12 * rj.residual_history[0])


@pytest.mark.parametrize("mat_dtype", ["auto", "int8", None])
def test_cg_band_tiers_f32(mat_dtype):
    """f32 vectors over each band tier: the same iteration count as the
    JAX package within ±1, and the same tier name."""
    Aj, At, b = _systems("poisson3d_16")
    o = dict(maxits=2000, residual_rtol=1e-5)
    rj = jcg(Aj, b, options=JOptions(**o), dtype=np.float32, fmt="dia",
             mat_dtype=mat_dtype)
    rt = cg(At, b, options=SolverOptions(**o), dtype=np.float32, fmt="dia",
            mat_dtype=mat_dtype, device="cpu")
    assert abs(rt.niterations - rj.niterations) <= 1
    assert rt.x.dtype == np.float32
    assert _true_rel(At, rt.x.astype(np.float64), b) < 1e-4


@pytest.mark.parametrize("check_every", [2, 4])
def test_check_every_matches_jax(check_every):
    Aj, At, b = _systems("poisson3d_16")
    o = dict(maxits=2000, residual_rtol=RTOL, check_every=check_every)
    rj = jcg(Aj, b, options=JOptions(**o))
    rt = cg(At, b, options=SolverOptions(**o), device="cpu")
    assert rt.niterations == rj.niterations
    assert rt.niterations % check_every == 0
    assert _true_rel(At, rt.x, b) < RTOL


def test_diff_criterion_matches_jax():
    Aj, At, b = _systems("poisson2d_32")
    o = dict(maxits=2000, residual_rtol=0.0, diffatol=1e-6)
    rj = jcg(Aj, b, options=JOptions(**o))
    rt = cg(At, b, options=SolverOptions(**o), device="cpu")
    assert rt.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert rt.dxnrm2 < 1e-6


def test_maxits_zero_matches_jax():
    Aj, At, b = _systems("poisson2d_32")
    with pytest.raises(JAcgError) as ej:
        jcg(Aj, b, options=JOptions(maxits=0))
    with pytest.raises(AcgError) as et:
        cg(At, b, options=SolverOptions(maxits=0), device="cpu")
    assert int(et.value.status) == int(ej.value.status) == \
        int(Status.ERR_NOT_CONVERGED)
    assert et.value.result.niterations == 0
    assert et.value.result.rnrm2 == pytest.approx(
        ej.value.result.rnrm2, rel=1e-12)


def test_no_criteria_runs_to_maxits():
    """Every criterion off: the fixed-iteration timing protocol."""
    _, At, b = _systems("poisson2d_32")
    rt = cg(At, b, options=SolverOptions(maxits=7, residual_rtol=0.0),
            device="cpu")
    assert rt.converged and rt.niterations == 7


def test_indefinite_raises_like_jax():
    """diag(1, -1, 1, -1, ...) with b = 1: p'Ap = 0 with r != 0 on the
    first iteration — the indefiniteness witness fires in both."""
    n = 64
    d = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    idx = np.arange(n)
    At = tcsr.coo_to_csr(idx, idx, d, n, n)
    Aj = jcsr.coo_to_csr(idx, idx, d, n, n)
    b = np.ones(n)
    with pytest.raises(JAcgError) as ej:
        jcg(Aj, b, options=JOptions(maxits=50))
    with pytest.raises(AcgError) as et:
        cg(At, b, options=SolverOptions(maxits=50), device="cpu")
    assert int(et.value.status) == int(ej.value.status) == \
        int(Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX)
    assert et.value.result.niterations == ej.value.result.niterations


def test_indefinite_with_check_every_freezes_at_breakdown():
    """Between host checks the loop cannot stop; the breakdown iteration
    freezes the state, so the count is the breakdown's, as in JAX."""
    n = 64
    d = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    idx = np.arange(n)
    At = tcsr.coo_to_csr(idx, idx, d, n, n)
    Aj = jcsr.coo_to_csr(idx, idx, d, n, n)
    b = np.ones(n)
    with pytest.raises(JAcgError) as ej:
        jcg(Aj, b, options=JOptions(maxits=50, check_every=8))
    with pytest.raises(AcgError) as et:
        cg(At, b, options=SolverOptions(maxits=50, check_every=8),
           device="cpu")
    assert et.value.result.niterations == ej.value.result.niterations
    assert np.all(np.isfinite(et.value.result.x))


def test_not_converged_attaches_result():
    Aj, At, b = _systems("poisson3d_16")
    with pytest.raises(JAcgError) as ej:
        jcg(Aj, b, options=JOptions(maxits=3))
    with pytest.raises(AcgError) as et:
        cg(At, b, options=SolverOptions(maxits=3), device="cpu")
    assert int(et.value.status) == int(Status.ERR_NOT_CONVERGED)
    res = et.value.result
    assert res.niterations == ej.value.result.niterations == 3
    assert res.status == Status.ERR_NOT_CONVERGED
    assert res.rnrm2 == pytest.approx(ej.value.result.rnrm2, rel=1e-8)


def test_x0_and_zero_rhs():
    Aj, At, b = _systems("poisson2d_32")
    x0 = np.random.default_rng(9).standard_normal(At.nrows)
    o = dict(maxits=2000, residual_rtol=RTOL)
    rj = jcg(Aj, b, x0=x0, options=JOptions(**o))
    rt = cg(At, b, x0=x0, options=SolverOptions(**o), device="cpu")
    assert abs(rt.niterations - rj.niterations) <= 1
    assert rt.r0nrm2 == pytest.approx(rj.r0nrm2, rel=1e-12)
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    # b = 0 with x0 = 0: an exactly-zero residual is convergence
    rz = cg(At, np.zeros_like(b), options=SolverOptions(**o), device="cpu")
    assert rz.converged and rz.niterations == 0


def test_prebuilt_operator_and_tensor_inputs():
    _, At, b = _systems("poisson3d_16")
    op = build_device_operator(At, dtype=np.float64, device="cpu")
    bt = torch.zeros(op.nrows_padded, dtype=torch.float64)
    bt[: At.nrows] = torch.from_numpy(b)
    o = SolverOptions(maxits=2000, residual_rtol=RTOL)
    ra = cg(op, bt, options=o)
    rb = cg(At, b, options=o, device="cpu")
    assert ra.niterations == rb.niterations
    np.testing.assert_array_equal(ra.x, rb.x)


def test_guard_nonfinite_reports_fault():
    """A non-finite right-hand side: the guard ends the solve with
    ERR_FAULT_DETECTED at the first check instead of running to maxits."""
    _, At, b = _systems("poisson2d_32")
    b = b.copy()
    b[3] = np.nan
    with pytest.raises(AcgError) as et:
        cg(At, b, options=SolverOptions(maxits=50, guard_nonfinite=True),
           device="cpu")
    assert et.value.status == Status.ERR_FAULT_DETECTED
    assert et.value.result.niterations == 1


def test_unported_tiers_raise():
    """Every tier of the fmt="auto" ladder is ported now: a random-graph
    matrix (no band, no locality for RCM to recover) routes to ELL as in
    the JAX package, forced ELL runs, and the one refusal left is the JAX
    package's own: forced sgell at f64 vectors is ERR_NOT_SUPPORTED."""
    A = tpoisson.random_spd(400, degree=6)
    Aj = jpoisson.random_spd(400, degree=6)
    b = np.ones(A.nrows)
    o = dict(maxits=200, residual_rtol=RTOL)
    rt = cg(A, b, options=SolverOptions(**o), device="cpu")
    rj = jcg(Aj, b, options=JOptions(**o))
    assert (rt.operator_format, rj.operator_format) == ("ell", "ell")
    assert abs(rt.niterations - rj.niterations) <= 1
    assert _true_rel(A, rt.x, b) < RTOL
    P = tpoisson.poisson2d_5pt(8)
    forced = cg(P, np.ones(64), fmt="ell", device="cpu")
    assert (forced.operator_format, forced.kernel_note) == (
        "ell", "format forced: ell")
    with pytest.raises(AcgError, match="vector dtype float64") as e:
        cg(P, np.ones(64), fmt="sgell", device="cpu")
    assert e.value.status == Status.ERR_NOT_SUPPORTED


def test_default_device_raises_without_cuda():
    """No silent CPU run: the default device is cuda, and without a card
    the entry point raises ERR_NOT_SUPPORTED naming the missing device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, At, b = _systems("poisson2d_32")
    with pytest.raises(AcgError, match="CUDA") as e:
        cg(At, b)
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(AcgError):
        build_device_operator(At)


def test_options_validation_matches_jax():
    for bad in (dict(maxits=-1), dict(check_every=0), dict(sstep=1),
                dict(pipeline_depth=9), dict(halo_wire="x")):
        with pytest.raises(ValueError):
            JOptions(**bad)
        with pytest.raises(ValueError):
            SolverOptions(**bad)
    assert SolverOptions() == SolverOptions(**{
        f: getattr(JOptions(), f) for f in JOptions.__dataclass_fields__})


@pytest.mark.parametrize("nexclude", [0, 5])
def test_blas1_matches_jax(nexclude):
    from acg_tpu.ops import blas1 as jblas1

    from acg_torch.ops import blas1

    rng = np.random.default_rng(8)
    x, y = rng.standard_normal(300), rng.standard_normal(300)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert float(blas1.ddot(tx, ty, nexclude)) == pytest.approx(
        float(jblas1.ddot(x, y, nexclude=nexclude)), rel=1e-13)
    assert float(blas1.dnrm2(tx, nexclude)) == pytest.approx(
        float(jblas1.dnrm2(x, nexclude=nexclude)), rel=1e-13)
