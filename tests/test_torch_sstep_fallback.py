"""Port parity for s-step CG, its protocol and its fallback:
``acg_torch.solvers.cg.cg_sstep`` on the CPU against
``acg_tpu.solvers.cg.cg_sstep`` (the parity of the pieces and of the
converging solves is in ``test_torch_sstep.py``).

- Fixed iterations, maxits, x0, the option refusals.
- The JAX suite's fallback cases (``tests/test_cg_sstep.py``): the same
  flags, the same fallback notes and the same folded counts; the
  divergence guard held deterministically (a poisoned basis in both
  loops), and the JAX suite's f32 recipe held to what both packages
  guarantee there.
- The classic fallback's per-system ``atol2_floor``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.ops import blas1 as jblas1
from acg_tpu.solvers import loops as jloops
from acg_tpu.solvers.cg import _sstep_block_fn as jblock_fn
from acg_tpu.solvers.cg import build_device_operator as jbuild
from acg_tpu.solvers.cg import cg_sstep as jcg_sstep
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.ops import blas1
from acg_torch.solvers import loops
from acg_torch.solvers.cg import (_sstep_block_fn, build_device_operator,
                                  cg, cg_sstep)
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import poisson as tpoisson


def _pair(make, seed):
    Aj, At = make(jpoisson), make(tpoisson)
    _, b = tcsr.manufactured_rhs(At, seed=seed)
    np.testing.assert_array_equal(b, jcsr.manufactured_rhs(Aj, seed=seed)[1])
    return Aj, At, b


def _true_rel(A, x, b):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)


def _opts(s, **kw):
    base = dict(maxits=2000, residual_rtol=1e-10, sstep=s)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# the protocol: fixed iterations, maxits, x0, validation


def test_sstep_fixed_iteration_protocol():
    _, At, b = _pair(lambda m: m.poisson2d_5pt(10), 4)
    res = cg_sstep(At, b, options=SolverOptions(maxits=25, residual_rtol=0.0,
                                                sstep=4), device="cpu")
    assert res.niterations == 25 and res.converged


def test_sstep_maxits_not_converged_matches_jax():
    Aj, At = jpoisson.poisson2d_5pt(12), tpoisson.poisson2d_5pt(12)
    b = np.ones(At.nrows)
    o = dict(maxits=4, residual_rtol=1e-12, sstep=2)
    with pytest.raises(JAcgError) as ej:
        jcg_sstep(Aj, b, options=JOptions(**o))
    with pytest.raises(AcgError) as et:
        cg_sstep(At, b, options=SolverOptions(**o), device="cpu")
    assert et.value.status == Status.ERR_NOT_CONVERGED
    assert int(et.value.status) == int(ej.value.status)
    assert et.value.result.niterations == ej.value.result.niterations
    assert et.value.result.x.shape == (At.nrows,)


def test_sstep_x0_and_exact_guess():
    At = tpoisson.poisson2d_5pt(10)
    xstar, b = tcsr.manufactured_rhs(At, seed=5)
    res = cg_sstep(At, b, x0=xstar, options=SolverOptions(**_opts(3)),
                   device="cpu")
    assert res.converged and res.niterations <= 3
    x0 = np.random.default_rng(6).standard_normal(At.nrows)
    res2 = cg_sstep(At, b, x0=x0, options=SolverOptions(**_opts(3)),
                    device="cpu")
    np.testing.assert_allclose(res2.x, xstar, atol=1e-7)


def test_sstep_option_validation():
    At = tpoisson.poisson2d_5pt(8)
    b = np.ones(At.nrows)
    cases = [(SolverOptions(maxits=10), Status.ERR_INVALID_VALUE, {}),
             (SolverOptions(maxits=10, sstep=2, segment_iters=5),
              Status.ERR_NOT_SUPPORTED, {}),
             (SolverOptions(maxits=10, sstep=2, diffatol=1e-8,
                            residual_rtol=0.0), Status.ERR_NOT_SUPPORTED, {}),
             (SolverOptions(maxits=10, sstep=2), Status.ERR_NOT_SUPPORTED,
              {"recycle": object()})]
    for o, status, kw in cases:
        with pytest.raises(AcgError) as ei:
            cg_sstep(At, b, options=o, device="cpu", **kw)
        assert ei.value.status == status
    for bad in (1, 17):
        with pytest.raises(ValueError):
            SolverOptions(sstep=bad)
    # monitor_every runs (as in the JAX package) and changes no bit
    o = dict(maxits=200, sstep=2, residual_rtol=1e-6)
    ref = cg_sstep(At, b, options=SolverOptions(**o), device="cpu")
    got = cg_sstep(At, b, options=SolverOptions(monitor_every=2, **o),
                   device="cpu")
    assert got.niterations == ref.niterations
    np.testing.assert_array_equal(got.x, ref.x)


# ---------------------------------------------------------------------------
# the fallback to classic CG: the same flags, notes and folded counts


def test_fallback_on_poisoned_shifts_matches_jax():
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 7)
    xstar = tcsr.manufactured_rhs(At, seed=7)[0]
    o = dict(maxits=2000, residual_rtol=1e-5, sstep=4)
    rj = jcg_sstep(Aj, b, dtype=np.float32, options=JOptions(**o),
                   shifts0=np.full(4, 1e30))
    rt = cg_sstep(At, b, dtype=np.float32, options=SolverOptions(**o),
                  shifts0=np.full(4, 1e30), device="cpu")
    assert rt.converged and rj.converged
    assert "fell back to classic cg" in rt.kernel_note
    assert rt.kernel_note == rj.kernel_note
    assert rt.niterations == rj.niterations
    np.testing.assert_allclose(rt.x, xstar, atol=1e-2 * np.abs(xstar).max())


def test_divergence_guard_certified_fallback():
    """The JAX suite's recipe (f32, s = 8, a random SPD operator): at
    f32's attainable floor whether a block trips the guard depends on
    the Gram's rounding, so the two packages need not fall back on the
    same seed (both do on some, neither on others;
    ``scripts/torch_sstep_deep.py``).  Held in both: a converged solve
    whose true residual honours the tolerance, and a fallback said in
    the note when one ran."""
    rtol = 1e-5
    Aj = jpoisson.random_spd(100, degree=3, seed=55)
    At = tpoisson.random_spd(100, degree=3, seed=55)
    b = np.ones(At.nrows)
    o = dict(maxits=5000, residual_rtol=rtol, sstep=8)
    rj = jcg_sstep(Aj, b, dtype=np.float32, options=JOptions(**o))
    rt = cg_sstep(At, b, dtype=np.float32, options=SolverOptions(**o),
                  device="cpu")
    for r in (rt, rj):
        assert r.converged
        assert _true_rel(At, r.x, b) < 10 * rtol
        assert r.kernel_note in ("", ) or r.kernel_note.startswith(
            "cg-sstep(s=8) fell back to classic cg after ")


@pytest.mark.parametrize("batch", [0, 2])
def test_divergence_guard_flags_as_jax(batch):
    """The guard itself, held deterministically: the same basis function
    in both loops, its residual rows scaled by 1e3 from the second block
    on (a true |r|² past 1e4 |r0|²), flags _GRAM_BAD at that block's
    boundary with the same counts and history in both packages."""
    s, n = 4, 64
    Aj, At = jpoisson.poisson2d_5pt(8), tpoisson.poisson2d_5pt(8)
    dj = jbuild(Aj, dtype=np.float64, fmt="dia")
    dt = build_device_operator(At, dtype=np.float64, fmt="dia",
                               device="cpu")
    rng = np.random.default_rng(9)
    bh = rng.standard_normal((batch, n) if batch else (n,))
    lead = bh.shape[:-1]

    def pad(v, npad):
        out = np.zeros(lead + (npad,))
        out[..., :n] = v
        return out

    # x = 0 in the first block only, so the poison depends on the data
    # (the JAX loop body is traced once)
    def poisoned_j(block_fn):
        def fn(x, p, shifts):
            V, _ = block_fn(x, p, shifts)
            f = jnp.where(jnp.any(x != 0), 1e3, 1.0)
            V = V.at[s + 1:].multiply(f)
            return V, jblas1.gram(V)
        return fn

    def poisoned_t(block_fn):
        def fn(x, p, shifts):
            V, _ = block_fn(x, p, shifts)
            V[s + 1:] *= 1e3 if bool((x != 0).any()) else 1.0
            return V, blas1.gram(V)
        return fn

    shifts = np.tile(np.array([7.0, 1.0, 5.0, 3.0]), lead + (1,))
    stop2 = (0.0, 1e-20)
    bj = jnp.asarray(pad(bh, dj.nrows_padded))
    rr0 = np.sum(bh * bh, axis=-1)
    outj = jloops.cg_sstep_while(
        poisoned_j(jblock_fn(dj.matvec, bj, s, bool(batch))), bj,
        jnp.zeros_like(bj), bj, jnp.asarray(rr0), jnp.asarray(shifts),
        (jnp.asarray(stop2[0]), jnp.asarray(stop2[1])), s, 100)
    bt = torch.from_numpy(pad(bh, dt.nrows_padded))
    outt = loops.cg_sstep_while(
        poisoned_t(_sstep_block_fn(dt.matvec, bt, s)), blas1.combine,
        bt, torch.zeros_like(bt), bt.clone(), np.atleast_1d(rr0),
        shifts.reshape(-1, s), stop2, s, 100)
    kj, flagj, histj = (np.atleast_1d(np.asarray(v)) for v in
                        (outj[1], outj[3], outj[4]))
    kt, flagt, histt = outt[1], outt[3], outt[4]
    assert np.all(flagt == loops._GRAM_BAD)
    np.testing.assert_array_equal(flagt, flagj)
    np.testing.assert_array_equal(kt, kj)
    assert np.all(kt == s)
    np.testing.assert_allclose(histt[:, : s + 1],
                               histj.reshape(histt.shape)[:, : s + 1],
                               rtol=1e-9)
    # the rolled-back block left x at the first block's iterate
    xj = np.asarray(outj[0])[..., :n]
    np.testing.assert_allclose(outt[0][..., :n].numpy(), xj, rtol=1e-9,
                               atol=1e-12)


def test_fallback_mixed_scale_per_system_threshold_matches_jax():
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 7)
    B = np.stack([b, 1e-4 * b])
    rtol = 1e-5
    o = dict(maxits=4000, residual_rtol=rtol, sstep=4)
    sh = np.array([[1.0, 2.0, 3.0, 4.0], [1e30] * 4])
    rj = jcg_sstep(Aj, B, dtype=np.float32, options=JOptions(**o),
                   shifts0=sh)
    rt = cg_sstep(At, B, dtype=np.float32, options=SolverOptions(**o),
                  shifts0=sh, device="cpu")
    assert rt.kernel_note == rj.kernel_note
    assert "fell back to classic cg" in rt.kernel_note
    assert np.all(rt.converged_per_system)
    x = np.asarray(rt.x, np.float64)
    for i in range(2):
        assert (np.linalg.norm(B[i] - At.matvec(x[i]))
                / np.linalg.norm(B[i])) < 10 * rtol
    assert np.all(np.abs(rt.iterations_per_system
                         - rj.iterations_per_system) <= 1)


def test_fallback_batched_iteration_accounting_matches_jax():
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 14)
    B = np.stack([b, 2 * b, -b])
    o = dict(maxits=2000, residual_rtol=1e-5, sstep=4)
    rj = jcg_sstep(Aj, B, dtype=np.float32, options=JOptions(**o),
                   shifts0=np.full(4, 1e30))
    rt = cg_sstep(At, B, dtype=np.float32, options=SolverOptions(**o),
                  shifts0=np.full(4, 1e30), device="cpu")
    assert rt.kernel_note == rj.kernel_note
    assert np.all(rt.converged_per_system)
    ips = np.asarray(rt.iterations_per_system)
    assert rt.niterations == int(ips.max())
    np.testing.assert_array_equal(ips, rj.iterations_per_system)
    assert rt.stats.niterations == rt.niterations


def test_fallback_diagnoses_indefinite_matches_jax():
    n = 64
    i = np.arange(n)
    d = np.where(i % 7 == 3, -2.0, 4.0)
    coo = (np.r_[i, i[:-1], i[:-1] + 1], np.r_[i, i[:-1] + 1, i[:-1]],
           np.r_[d, np.full(n - 1, -1.0), np.full(n - 1, -1.0)], n, n)
    b = np.ones(n)
    o = dict(maxits=500, residual_rtol=1e-10, sstep=4)
    with pytest.raises(JAcgError) as ej:
        jcg_sstep(jcsr.coo_to_csr(*coo), b, options=JOptions(**o))
    with pytest.raises(AcgError) as et:
        cg_sstep(tcsr.coo_to_csr(*coo), b, options=SolverOptions(**o),
                 device="cpu")
    assert et.value.status == Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX
    assert int(et.value.status) == int(ej.value.status)
    assert et.value.result.kernel_note == ej.value.result.kernel_note
    assert "fell back to classic cg" in et.value.result.kernel_note
    assert et.value.result.niterations == ej.value.result.niterations


def test_fallback_classic_holds_the_original_floor():
    """The fallback's ``cg(..., atol2_floor=)``: a per-system squared
    absolute floor raises only its own system's threshold."""
    _, At, b = _pair(lambda m: m.poisson2d_5pt(12), 8)
    B = np.stack([b, b])
    o = SolverOptions(maxits=2000, residual_rtol=1e-8)
    plain = cg(At, B, options=o, device="cpu")
    floor = np.array([0.0, 1e-8 * float(b @ b)])
    floored = cg(At, B, options=o, device="cpu", atol2_floor=floor)
    its, its0 = floored.iterations_per_system, plain.iterations_per_system
    assert its[0] == its0[0] and its[1] < its0[1]
    np.testing.assert_array_equal(floored.x[0], plain.x[0])
    assert floored.rnrm2_per_system[1] ** 2 < floor[1]
    assert floored.rnrm2_per_system[0] < 1e-8 * floored.r0nrm2_per_system[0]
