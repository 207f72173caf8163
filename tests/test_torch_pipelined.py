"""Port parity for pipelined CG: the two pipelined-iteration kernels'
plain versions, the loop and ``cg_pipelined`` on the CPU, against the
JAX package on the same operators and inputs.

- Kernels: ``cg_pipelined_iter`` (DIA) against
  ``cg_pipelined_iter_pallas(..., interpret=True)`` over the band tiers,
  and ``cg_pipelined_iter_stencil`` against the JAX matrix-free one, on
  operands padded with JAX's own helpers and sliced back.  Vectors at
  f64 rtol 1e-12, at f32 rtol/atol 1e-5, relative to the largest entry;
  gamma and delta at 1e-10 (f64) / 1e-4 (f32) relative to |r'|² and
  |w'|·|r'| (fused multiply-adds and another summation order).  Padding
  entries come back exactly 0.
- Solves: iterations within ±1, |x_port - x_jax|/|x_jax| <= 1e-8 and
  both true residuals, from the host matrix, below rtol.  Nothing rests
  on bit identity between the two packages' formulations.
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
from acg_tpu.ops import dia as jdia
from acg_tpu.ops import pallas_kernels as pk
from acg_tpu.ops import stencil as jst
from acg_tpu.solvers import base as jbase
from acg_tpu.solvers.cg import cg_pipelined as jcg_pipelined
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import poisson as jpoisson

from acg_torch import convert
from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, write_mtx
from acg_torch.ops import dia_kernels
from acg_torch.ops.blas1 import pipelined_update
from acg_torch.ops import stencil as tst
from acg_torch.ops.dia import DeviceDia, DiaMatrix
from acg_torch.solvers import base as tbase
from acg_torch.solvers import loops
from acg_torch.solvers.cg import (_dot2, _pipe_step, build_device_operator,
                                  cg_pipelined)
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import poisson as tpoisson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS_TILE = 8
RTOL = 1e-8
_TOL = {np.float64: (1e-12, 0.0, 1e-10), np.float32: (1e-5, 1e-5, 1e-4)}
ALPHA, BETA = 0.37, 1.21


def _vectors(n, npad, dtype, seed=1):
    """w, z, r, p, s, x: random on [0, n), zero on [n, npad)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        v = np.zeros(npad, dtype=dtype)
        v[:n] = rng.standard_normal(n)
        out.append(v)
    return out


def _assert_pipe_matches(got, want, dtype, n):
    """got: the port's 8 outputs (tensors); want: JAX's, sliced back."""
    rtol, atol, dot_rtol = _TOL[dtype]
    for g, w in zip(got[:6], want[:6]):
        g = g.numpy()
        assert g.dtype == dtype
        assert np.max(np.abs(g - w)) <= atol + rtol * np.max(np.abs(w))
        assert np.all(g[n:] == 0.0)
    r2, w2 = want[4].astype(np.float64), want[5].astype(np.float64)
    assert abs(float(got[6]) - float(want[6])) <= dot_rtol * (r2 @ r2)
    assert abs(float(got[7]) - float(want[7])) <= (
        dot_rtol * np.linalg.norm(w2) * np.linalg.norm(r2))
    assert got[6].dim() == 0 and got[7].dim() == 0


# ---------------------------------------------------------------------------
# the DIA kernel


def _random_bands(n=2048, seed=7):
    """Offsets with sublane (±128) and lane (±1, ±3, ±300) shifts, as the
    JAX package's pipe2d probe uses; band values are nonzero where the
    column leaves [0, n) too (the JAX kernel reads its zero halo there,
    the port's bounds test skips them)."""
    offsets = (-300, -128, -3, -1, 0, 1, 3, 128, 300)
    bands = np.random.default_rng(seed).standard_normal((len(offsets), n))
    return offsets, bands, n


def _poisson_bands():
    """A 30 x 31 Poisson operator stored with 94 padding rows (930 rows
    in 1024): zero bands and zero vectors there must come back zero."""
    A = tpoisson.poisson2d_5pt(30, 31)
    D = DiaMatrix.from_csr(A, row_align=128)
    return D.offsets, D.bands, A.nrows


_DIA_OPERATORS = {"random": _random_bands, "poisson2d_pad": _poisson_bands}
# tier: (band storage, vector dtype)
_TIERS = {"f32": (np.float32, np.float32), "bf16": ("bfloat16", np.float32),
          "int8": (np.int8, np.float32), "f64": (np.float64, np.float64)}


def _tier_bands(bands, tier):
    """(JAX bands, port bands, JAX scales, port scales) of one tier; the
    int8 tier stores the mask bands > 0 with per-band scales 1..D."""
    store, vdt = _TIERS[tier]
    if tier == "int8":
        mask = (bands > 0).astype(np.int8)
        sc = np.arange(1.0, 1.0 + bands.shape[0], dtype=vdt)
        return (jnp.asarray(mask), torch.from_numpy(mask), jnp.asarray(sc),
                torch.from_numpy(sc))
    if tier == "bf16":
        jb = jnp.asarray(bands.astype(np.float32)).astype(jnp.bfloat16)
        return jb, convert.tensor_from_numpy(np.asarray(jb)), None, None
    b = bands.astype(store)
    return jnp.asarray(b), torch.from_numpy(b), None, None


@pytest.mark.parametrize("tier", list(_TIERS))
@pytest.mark.parametrize("op_name", list(_DIA_OPERATORS))
def test_dia_pipe_matches_pallas(op_name, tier):
    offsets, bands, n = _DIA_OPERATORS[op_name]()
    vdt = _TIERS[tier][1]
    npad = bands.shape[1]
    jb, tb, jsc, tsc = _tier_bands(bands, tier)
    vecs = _vectors(n, npad, vdt)
    bp, padded = pk.pad_dia_operands(jb, tuple(jnp.asarray(v) for v in vecs),
                                     ROWS_TILE, offsets)
    front = pk.padded_halo_rows(offsets, ROWS_TILE) * pk.LANES
    wp, zp, rp, pp, sp, xp = padded
    want = pk.cg_pipelined_iter_pallas(
        bp, offsets, wp, zp, rp, pp, sp, xp, jnp.asarray(ALPHA, vdt),
        jnp.asarray(BETA, vdt), rows_tile=ROWS_TILE, interpret=True,
        scales=jsc)
    want = [np.asarray(v)[front: front + npad] for v in want[:6]] + [
        np.asarray(want[6]), np.asarray(want[7])]
    tv = [torch.from_numpy(v) for v in vecs]
    before = dia_kernels.pipe_launches
    got = dia_kernels.cg_pipelined_iter(
        tb, tsc, torch.tensor(offsets, dtype=torch.int64), *tv,
        torch.tensor(ALPHA, dtype=tv[0].dtype),
        torch.tensor(BETA, dtype=tv[0].dtype))
    assert dia_kernels.pipe_launches == before     # the CPU runs no kernel
    _assert_pipe_matches(got, want, vdt, n)
    # the plain version is functional: the inputs are unchanged
    for t, v in zip(tv, vecs):
        np.testing.assert_array_equal(t.numpy(), v)


def test_dia_pipe_matches_spmv_then_update():
    """The plain iteration is the operator's SpMV, the 6-vector update
    and the two dots, the open-coded body of the loop: the same bits as
    composing them by hand."""
    D = DiaMatrix.from_csr(tpoisson.poisson3d_7pt_varcoef(6))
    dev = DeviceDia.from_dia(D, device="cpu")
    vecs = [torch.from_numpy(v) for v in _vectors(D.nrows, D.nrows_padded,
                                                  np.float64)]
    a = torch.tensor(ALPHA, dtype=torch.float64)
    b = torch.tensor(BETA, dtype=torch.float64)
    got = dev.pipelined_iter(*vecs, a, b)
    w, z, r, p, s, x = vecs
    want = pipelined_update(dev.matvec(w), w, z, r, p, s, x, a, b)
    want = want + _dot2(want[4], want[4], want[5], want[4])
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    # the update itself, element by element
    np.testing.assert_allclose(want[0].numpy(), (dev.matvec(w) + b * z),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(want[5].numpy(), w - a * want[0], rtol=1e-15,
                               atol=1e-15)


# ---------------------------------------------------------------------------
# the stencil kernel

_STENCILS = {
    "poisson2d_5pt": lambda m: m.poisson2d_5pt(32),
    "poisson2d_5pt_ragged": lambda m: m.poisson2d_5pt(30, 31),
    "poisson3d_7pt": lambda m: m.poisson3d_7pt(16),
    "poisson3d_7pt_ragged": lambda m: m.poisson3d_7pt(9, 10, 11),
    "poisson3d_27pt": lambda m: m.poisson3d_27pt(8),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(_STENCILS))
def test_stencil_pipe_matches_pallas(name, dtype):
    jdev = jst.DeviceStencil.from_matrix(_STENCILS[name](jpoisson),
                                         dtype=dtype)
    tdev = convert.device_stencil_from_fields(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, jdev.nrows,
        jdev.nnz, dtype, device="cpu")
    n = jdev.nrows
    npad = -(-n // pk.LANES) * pk.LANES
    vecs = _vectors(n, npad, dtype, seed=3)
    padded, front = pk.pad_dia_vectors(tuple(jnp.asarray(v) for v in vecs),
                                       npad, ROWS_TILE, jdev.offsets)
    wp, zp, rp, pp, sp, xp = padded
    want = jst.cg_pipelined_iter_stencil(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, wp, zp, rp, pp,
        sp, xp, jnp.asarray(ALPHA, dtype), jnp.asarray(BETA, dtype),
        rows_tile=ROWS_TILE, n=n, interpret=True)
    want = [np.asarray(v)[front: front + npad] for v in want[:6]] + [
        np.asarray(want[6]), np.asarray(want[7])]
    tv = [torch.from_numpy(v) for v in vecs]
    a = torch.tensor(ALPHA, dtype=tv[0].dtype)
    b = torch.tensor(BETA, dtype=tv[0].dtype)
    before = tst.pipe_launches
    got = tdev.pipelined_iter(*tv, a, b)
    assert tst.pipe_launches == before
    _assert_pipe_matches(got, want, dtype, n)
    # the same function as the DIA iteration over the stored bands
    D = DiaMatrix.from_csr(_STENCILS[name](tpoisson), row_align=npad)
    dd = DeviceDia.from_dia(D, dtype=dtype, mat_dtype=None, device="cpu")
    ref = dd.pipelined_iter(*tv, a, b)
    rtol, atol, _ = _TOL[dtype]
    for g, e in zip(got[:6], ref[:6]):
        assert float((g - e).abs().max()) <= atol + rtol * float(
            e.abs().max())


def test_pipe_wrappers_reject_unknown_device():
    """A tensor on neither the CPU nor a CUDA device has no kernel and no
    plain fallback: both wrappers raise."""
    spec, _ = tst.recognize_stencil(tpoisson.poisson2d_5pt(4))
    v = [torch.zeros(16, dtype=torch.float64, device="meta")
         for _ in range(6)]
    ab = (torch.zeros((), dtype=torch.float64, device="meta"),) * 2
    with pytest.raises(AcgError):
        tst.cg_pipelined_iter_stencil(spec, *v, *ab)
    bands = torch.zeros(3, 16, dtype=torch.float64, device="meta")
    offs = torch.tensor([-4, 0, 4], device="meta")
    with pytest.raises(AcgError):
        dia_kernels.cg_pipelined_iter(bands, None, offs, *v, *ab)


# ---------------------------------------------------------------------------
# whole solves

_SYSTEMS = {
    "poisson2d_32": lambda m: m.poisson2d_5pt(32),
    "poisson3d_16": lambda m: m.poisson3d_7pt(16),
    "varcoef_12": lambda m: m.poisson3d_7pt_varcoef(12),
}


def _systems(name, seed=4):
    Aj = _SYSTEMS[name](jpoisson)
    At = _SYSTEMS[name](tpoisson)
    _, b = tcsr.manufactured_rhs(At, seed=seed)
    np.testing.assert_array_equal(b, jcsr.manufactured_rhs(Aj, seed=seed)[1])
    return Aj, At, b


def _true_rel(A, x, b):
    x = np.asarray(x, dtype=np.float64)
    return np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)


def _both(name, fmt="auto", dtype=np.float64, **opts):
    Aj, At, b = _systems(name)
    rj = jcg_pipelined(Aj, b, options=JOptions(**opts), dtype=dtype, fmt=fmt)
    rt = cg_pipelined(At, b, options=SolverOptions(**opts), dtype=dtype,
                      fmt=fmt, device="cpu")
    return rj, rt, At, b


@pytest.mark.parametrize("fmt", ["auto", "dia"])
@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_cg_pipelined_matches_jax(name, fmt):
    rj, rt, At, b = _both(name, fmt, maxits=2000, residual_rtol=RTOL)
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    assert _true_rel(At, rt.x, b) < RTOL
    assert _true_rel(At, rj.x, b) < RTOL
    assert rt.operator_format == (
        "dia" if fmt == "dia" or name.startswith("varcoef") else "stencil")
    assert rt.kernel == "torch-plain"
    assert rt.kernel_note == ("format forced: dia" if fmt == "dia" else "")
    # the history: entry 0 is |r0|^2, the last the certified exit value
    assert rt.residual_history.shape == (rt.niterations + 1,)
    k = min(rt.niterations, rj.niterations) + 1
    np.testing.assert_allclose(rt.residual_history[:k - 1],
                               rj.residual_history[:k - 1], rtol=1e-6,
                               atol=1e-12 * rj.residual_history[0])
    assert rt.residual_history[-1] == pytest.approx(rt.rnrm2 ** 2, rel=1e-12)
    assert rt.stats.nflops == rt.niterations * jbase.cg_flops_per_iter(
        At.nnz, At.nrows, pipelined=True)


def test_interpret_megakernel_matches_port():
    """The JAX package's single-kernel stencil iteration (Pallas interpret
    mode, as tests/test_stencil.py runs it) against the port's, f32."""
    A = jpoisson.poisson3d_7pt(16)
    _, b = jcsr.manufactured_rhs(A, seed=3)
    b32 = b.astype(np.float32)
    o = dict(maxits=80, residual_rtol=1e-5)
    dev_i = jst.DeviceStencil.from_matrix(A, dtype=np.float32,
                                          interpret=True)
    rj = jcg_pipelined(dev_i, b32, options=JOptions(**o), dtype=np.float32)
    assert rj.kernel == "pallas-stpipe2d"
    rt = cg_pipelined(tpoisson.poisson3d_7pt(16), b32,
                      options=SolverOptions(**o), dtype=np.float32,
                      fmt="stencil", device="cpu")
    assert rj.converged and rt.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert rt.x.dtype == np.float32
    assert np.abs(rt.x - rj.x).max() < 1e-4 * np.abs(rj.x).max()
    assert rt.kernel_note == "format forced: stencil"


@pytest.mark.parametrize("fmt", ["auto", "dia"])
def test_replace_every_matches_jax(fmt):
    rj, rt, At, b = _both("poisson3d_16", fmt, maxits=2000,
                          residual_rtol=RTOL, replace_every=10)
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    assert _true_rel(At, rt.x, b) < RTOL
    tier = "stencil" if fmt == "auto" else "dia"
    want = f"{tier} pipe disengaged: replace_every=10"
    if fmt == "dia":
        want = "format forced: dia; " + want
    assert rt.kernel_note == want
    # the replaced samples are true residuals
    assert rt.residual_history[10] == pytest.approx(
        rj.residual_history[10], rel=1e-8)


@pytest.mark.parametrize("rtol", [1e-5, 1.5e-6])
def test_f32_check_every_exit_is_certified(rtol):
    """The false-certificate case (acg_tpu/solvers/loops.py): with f32
    and check_every=7 the recurred gamma can pass the test while the true
    residual does not; every exit is certified, so the returned residual
    is the true one.  At 1.5e-6, near the f32 floor of this operator,
    candidates can fail certification before one holds; there the two
    packages' trajectories depend on their rounding, so only 1e-5 is held
    against the JAX package."""
    At = tpoisson.poisson3d_7pt_varcoef(16, seed=0)
    b = At.matvec(np.random.default_rng(0).standard_normal(At.nrows))
    o = dict(maxits=5000, residual_rtol=rtol, check_every=7)
    rt = cg_pipelined(At, b, options=SolverOptions(**o), dtype=np.float32,
                      device="cpu")
    assert rt.converged and rt.niterations % 7 == 0
    true_rel = _true_rel(At, rt.x, b)
    assert true_rel < 1.01 * rtol
    assert abs(rt.relative_residual - true_rel) < 1e-2 * rtol
    if rtol == 1e-5:
        Aj = jpoisson.poisson3d_7pt_varcoef(16, seed=0)
        rj = jcg_pipelined(Aj, b, options=JOptions(**o), dtype=np.float32)
        assert rj.converged and rj.niterations == rt.niterations


@pytest.mark.parametrize("maxits", [60, 200])
def test_fixed_iterations_past_the_floor_restart(maxits):
    """Criteria off, f32.  At 60 iterations the solve sits at its
    attainable floor and the two packages' true residuals agree within a
    factor of 2.  Past it the recurrences drift: the recurred gamma grows,
    the denominator goes non-positive and the loop restarts (alpha = 0 on
    a later step; in the port at iteration 173).  Where each package's
    drift lands depends on its rounding (the port's true residual jumps to
    0.32 at iteration 172, the JAX package's creeps to 4e-3), so at 200
    iterations both are held to the drift band: finite and below |b|."""
    Aj, At, b = _systems("poisson2d_32")
    b32 = b.astype(np.float32)
    op = build_device_operator(At, dtype=np.float32, device="cpu")
    bt = torch.from_numpy(np.pad(b32, (0, op.nrows_padded - At.nrows)))
    alphas = []
    step = _pipe_step(op)

    def recording_step(z, r, p, w, s, x, alpha, beta, w_out):
        alphas.append(float(alpha))
        return step(z, r, p, w, s, x, alpha, beta, w_out)

    zero = torch.zeros((), dtype=torch.float32)
    x, k, gamma, flag, _, hist = loops.cg_pipelined_while(
        op.matvec, _dot2, bt, torch.zeros_like(bt), (zero, zero), maxits,
        certify=False, iter_step=recording_step)
    assert k == maxits and flag == loops._OK
    assert torch.all(torch.isfinite(x)) and torch.isfinite(gamma)
    assert torch.all(torch.isfinite(hist))
    rt = cg_pipelined(At, b32, options=SolverOptions(maxits=maxits,
                                                     residual_rtol=0.0),
                      dtype=np.float32, device="cpu")
    np.testing.assert_array_equal(rt.x, x[: At.nrows].numpy())
    rj = jcg_pipelined(Aj, b32, options=JOptions(maxits=maxits,
                                                 residual_rtol=0.0),
                       dtype=np.float32)
    assert rt.converged and rt.niterations == rj.niterations == maxits
    tp, tj = _true_rel(At, rt.x, b), _true_rel(At, rj.x, b)
    if maxits == 60:
        assert tp < 1e-4 and tj < 1e-4 and 0.5 < tp / tj < 2.0
    else:
        assert 0.0 in alphas[1:]                      # restarted
        assert tp < 1.0 and tj < 1.0


def test_guard_nan_rhs_raises_in_both():
    Aj, At, b = _systems("poisson2d_32")
    b = b.copy()
    b[3] = np.nan
    o = dict(maxits=50, guard_nonfinite=True)
    with pytest.raises(JAcgError) as ej:
        jcg_pipelined(Aj, b, options=JOptions(**o))
    with pytest.raises(AcgError) as et:
        cg_pipelined(At, b, options=SolverOptions(**o), device="cpu")
    assert int(et.value.status) == int(ej.value.status) == \
        int(Status.ERR_FAULT_DETECTED)
    assert et.value.result.niterations == ej.value.result.niterations == 0


@pytest.mark.parametrize("check_every", [1, 4, 8])
def test_guard_freezes_at_the_first_nonfinite_pair(check_every):
    """A non-finite (gamma, delta) at iteration 5 stops the JAX loop
    there; between the port's host checks the state freezes instead, so
    every check_every returns the count, x and history of iteration 5."""
    _, At, b = _systems("poisson2d_32")
    op = build_device_operator(At, dtype=np.float64, device="cpu")
    bt = torch.from_numpy(np.pad(b, (0, op.nrows_padded - At.nrows)))
    step = _pipe_step(op)
    calls = []

    def faulty(z, r, p, w, s, x, alpha, beta, w_out):
        out = list(step(z, r, p, w, s, x, alpha, beta, w_out))
        calls.append(1)
        if len(calls) == 5:
            out[7] = out[7] * float("nan")          # delta
        return tuple(out)

    rtol2 = torch.tensor(1e-20, dtype=torch.float64)
    x, k, gamma, flag, _, hist = loops.cg_pipelined_while(
        op.matvec, _dot2, bt, torch.zeros_like(bt),
        (torch.zeros((), dtype=torch.float64), rtol2), 50,
        check_every=check_every, iter_step=faulty, guard=True)
    assert flag == loops._FAULT and k == 5
    assert torch.isfinite(gamma)
    assert torch.all(torch.isnan(hist[6:])) and torch.isfinite(hist[5])
    calls.clear()
    step = _pipe_step(op)
    ref = loops.cg_pipelined_while(
        op.matvec, _dot2, bt, torch.zeros_like(bt),
        (torch.zeros((), dtype=torch.float64), rtol2), 5,
        iter_step=step, certify=False)
    assert torch.equal(x, ref[0])


def test_refusals():
    Aj, At, b = _systems("poisson2d_32")
    with pytest.raises(JAcgError) as ej:
        jcg_pipelined(Aj, b, options=JOptions(diffatol=1e-6))
    with pytest.raises(AcgError) as et:
        cg_pipelined(At, b, options=SolverOptions(diffatol=1e-6),
                     device="cpu")
    assert int(et.value.status) == int(ej.value.status) == \
        int(Status.ERR_NOT_SUPPORTED)
    with pytest.raises(AcgError) as e:
        cg_pipelined(At, b, options=SolverOptions(diffrtol=1e-3),
                     device="cpu")
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    # segment_iters and monitor_every run (since the device-resident
    # loop), and give the plain solve's bits
    ref = cg_pipelined(At, b, options=SolverOptions(maxits=1000),
                       device="cpu")
    for opts in (dict(segment_iters=10), dict(monitor_every=5)):
        got = cg_pipelined(At, b, options=SolverOptions(maxits=1000, **opts),
                           device="cpu")
        assert got.niterations == ref.niterations
        np.testing.assert_array_equal(got.x, ref.x)
    with pytest.raises(AcgError) as e:       # (B, n) runs; (B, C, n) not
        cg_pipelined(At, np.stack([[b, b]]), device="cpu")
    assert e.value.status == Status.ERR_INVALID_VALUE


def test_maxits_zero_and_not_converged_match_jax():
    Aj, At, b = _systems("poisson3d_16")
    for maxits in (0, 3):
        with pytest.raises(JAcgError) as ej:
            jcg_pipelined(Aj, b, options=JOptions(maxits=maxits))
        with pytest.raises(AcgError) as et:
            cg_pipelined(At, b, options=SolverOptions(maxits=maxits),
                         device="cpu")
        assert int(et.value.status) == int(ej.value.status) == \
            int(Status.ERR_NOT_CONVERGED)
        res = et.value.result
        assert res.niterations == ej.value.result.niterations == maxits
        assert res.rnrm2 == pytest.approx(ej.value.result.rnrm2, rel=1e-8)


def test_x0_and_zero_rhs():
    Aj, At, b = _systems("poisson2d_32")
    x0 = np.random.default_rng(9).standard_normal(At.nrows)
    o = dict(maxits=2000, residual_rtol=RTOL)
    rj = jcg_pipelined(Aj, b, x0=x0, options=JOptions(**o))
    rt = cg_pipelined(At, b, x0=x0, options=SolverOptions(**o), device="cpu")
    assert abs(rt.niterations - rj.niterations) <= 1
    assert rt.r0nrm2 == pytest.approx(rj.r0nrm2, rel=1e-12)
    assert np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x) <= 1e-8
    rz = cg_pipelined(At, np.zeros_like(b), options=SolverOptions(**o),
                      device="cpu")
    assert rz.converged and rz.niterations == 0


def test_prebuilt_operator_leaves_inputs_alone():
    """A prebuilt operator and padded tensors: the solve neither changes
    b nor x0 (the card's kernel updates its vectors in place)."""
    _, At, b = _systems("poisson3d_16")
    op = build_device_operator(At, dtype=np.float64, device="cpu")
    bt = torch.zeros(op.nrows_padded, dtype=torch.float64)
    bt[: At.nrows] = torch.from_numpy(b)
    x0 = torch.zeros_like(bt)
    b_before = bt.clone()
    o = SolverOptions(maxits=2000, residual_rtol=RTOL)
    ra = cg_pipelined(op, bt, x0=x0, options=o)
    rb = cg_pipelined(At, b, options=o, device="cpu")
    assert ra.niterations == rb.niterations
    np.testing.assert_array_equal(ra.x, rb.x)
    assert torch.equal(bt, b_before) and not torch.any(x0)


def test_path_names_and_notes_match_jax_wording():
    assert tbase.path_names("stencil", "cuda", "pipe") == (
        "stencil", "cuda-stencil-pipe")
    assert tbase.path_names("dia", "cuda", "pipe") == ("dia", "cuda-dia-pipe")
    assert tbase.path_names("dia", "cuda", "spmv") == ("dia", "cuda-dia-spmv")
    assert tbase.path_names("dia", "cuda") == ("dia", "cuda-dia-fused")
    assert tbase.path_names("stencil", "cpu", "pipe") == (
        "stencil", "torch-plain")
    assert tbase.kernel_disengagement_note(
        True, False, 50, stencil=True) == "stencil pipe disengaged: " \
        "replace_every=50"
    assert tbase.kernel_disengagement_note(
        True, False, 50, forced_fmt="dia") == "format forced: dia; dia pipe " \
        "disengaged: replace_every=50"
    assert tbase.kernel_disengagement_note(True, True, 0) == ""
    # the JAX wording of the same two conditions
    assert jbase.kernel_disengagement_note(
        True, ("resident", 8), None, 50, None,
        forced_fmt="dia") == "format forced: dia; pipe2d disengaged: " \
        "replace_every=50"
    for nnz, n in ((4960, 1024), (7, 3)):
        assert tbase.cg_flops_per_iter(nnz, n, pipelined=True) == \
            jbase.cg_flops_per_iter(nnz, n, pipelined=True)
        assert tbase.cg_flops_per_iter(nnz, n) == \
            jbase.cg_flops_per_iter(nnz, n)


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = tpoisson.poisson3d_7pt(12)
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


@pytest.mark.parametrize("solver", ["acg-pipelined", "acg-device-pipelined"])
def test_cli_pipelined(matrix_file, solver):
    r = _cli(matrix_file, "--device", "cpu", "--solver", solver,
             "--manufactured-solution", "--max-iterations", "500", "-q",
             "-v")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "kernel: torch-plain\n" in r.stdout
    assert "operator format: stencil" in r.stdout
    assert "floating-point exceptions: none" in r.stdout
    assert ("kernel launches in the timed solve: dia_spmv 0, "
            "stencil_spmv 0, cg_pipelined_iter 0, "
            "cg_pipelined_iter_stencil 0") in r.stderr


def test_cli_residual_replacement(matrix_file):
    r = _cli(matrix_file, "--device", "cpu", "--solver", "acg-pipelined",
             "--residual-replacement", "20", "--manufactured-solution",
             "--max-iterations", "500", "-q")
    assert r.returncode == 0, r.stdout + r.stderr
    assert ("kernel: torch-plain (stencil pipe disengaged: "
            "replace_every=20)") in r.stdout
    r = _cli(matrix_file, "--device", "cpu", "--residual-replacement", "20",
             "--manufactured-solution", "-q")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "applies to pipelined solvers only" in r.stderr


@pytest.mark.parametrize("solver", ["acg-sstep", "cg-pipelined-deep",
                                    "acg-pipelined-deep"])
def test_cli_unported_solver_exits_1(matrix_file, solver):
    """Every --solver runs on one device and over shards; what the s-step
    and deep solvers over shards refuse is the rdma halo (they were
    refused over shards until they were ported)."""
    r = _cli(matrix_file, "--device", "cpu", "--solver", solver,
             "--nparts", "4", "--halo", "rdma", "-q")
    assert r.returncode == 1
    assert (f"--solver {solver} with --nparts 4 takes the ppermute or "
            "allgather halo") in r.stderr
    assert "Traceback" not in r.stderr
