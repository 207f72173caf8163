"""Port parity for depth-l pipelined CG: ``acg_torch.solvers.cg``
``cg_pipelined_deep`` on the CPU against ``acg_tpu.solvers.cg``
``cg_pipelined_deep`` on the same systems and inputs.

- f64: iterations within ±1, ``x`` within 1e-9 relative, the same number
  of dispatches (the note names it), the true residual below the
  tolerance.
- f32: the JAX tests' own bounds (iterations within l + 2 of each other,
  true residual below 5 × rtol in both): past ~1e-4 the f32 recurrences
  of the two packages part ways (``scripts/torch_sstep_deep.py``).
- ``replace_every`` restarts: the same dispatch count.
- The fallback after ``_DEEP_MAX_BAD`` poisoned dispatches: the same
  note, flags and folded count.
- Depth 1 is ``cg_pipelined``, bit for bit.
"""

import numpy as np
import pytest

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.solvers.cg import cg_pipelined_deep as jdeep
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.solvers.cg import (_DEEP_MAX_BAD, build_device_operator,
                                  cg_pipelined, cg_pipelined_deep)
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


def _solve_both(Aj, At, b, o, **kw):
    rj = jdeep(Aj, b, options=JOptions(**o), **kw)
    rt = cg_pipelined_deep(At, b, options=SolverOptions(**o), device="cpu",
                           **kw)
    return rj, rt


@pytest.mark.parametrize("l", [2, 3])
def test_deep_matches_jax_f64(l):
    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(8), 0)
    o = dict(maxits=2000, residual_rtol=1e-10, pipeline_depth=l)
    rj, rt = _solve_both(Aj, At, b, o)
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    assert _true_rel(At, rt.x, b) < 1e-10
    assert rt.kernel_note == rj.kernel_note
    assert rt.kernel_note.startswith(f"deep pipeline depth {l}, ")
    assert (rt.operator_format, rt.kernel) == ("stencil", "torch-plain")
    h = rt.residual_history
    assert h.shape == (rt.niterations + 1,)
    np.testing.assert_allclose(np.sqrt(h[-1]), rt.rnrm2, rtol=1e-12)


def test_deep_matches_jax_f32():
    rtol, l = 1e-5, 2
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(16), 1)
    o = dict(maxits=4000, residual_rtol=rtol, pipeline_depth=l)
    rj, rt = _solve_both(Aj, At, b, o, dtype=np.float32)
    assert rt.converged and rj.converged
    assert rt.x.dtype == np.float32
    assert abs(rt.niterations - rj.niterations) <= l + 2
    assert _true_rel(At, rt.x, b) < 5 * rtol
    assert _true_rel(Aj, rj.x, b) < 5 * rtol


def test_deep_batched_matches_jax():
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 2)
    B = np.stack([b, 2 * b, -0.5 * b])
    o = dict(maxits=2000, residual_rtol=1e-10, pipeline_depth=2)
    rj, rt = _solve_both(Aj, At, B, o)
    assert rt.nrhs == 3 and np.all(rt.converged_per_system)
    assert np.all(np.abs(rt.iterations_per_system
                         - rj.iterations_per_system) <= 1)
    assert rt.niterations == int(np.max(rt.iterations_per_system))
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)
    assert rt.kernel_note == rj.kernel_note
    for i in range(3):
        assert _true_rel(At, rt.x[i], B[i]) < 1e-9


@pytest.mark.parametrize("replace_every", [7, 25])
def test_deep_replace_every_dispatches_match_jax(replace_every):
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(16), 3)
    o = dict(maxits=4000, residual_rtol=1e-10, pipeline_depth=2,
             replace_every=replace_every)
    rj, rt = _solve_both(Aj, At, b, o)
    assert rt.converged
    assert rt.kernel_note == rj.kernel_note
    ndisp = int(rt.kernel_note.split(", ")[1].split()[0])
    assert ndisp >= rt.niterations // replace_every
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)


@pytest.mark.parametrize("batch", [0, 2])
def test_deep_fallback_after_poisoned_dispatches_matches_jax(batch):
    """Absurd fill shifts overflow the f32 basis in every dispatch: each
    ends in breakdown, and after ``_DEEP_MAX_BAD`` of them classic CG
    takes over from the last safe iterate, said in the note."""
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 7)
    B = np.stack([b, -2 * b]) if batch else b
    o = dict(maxits=2000, residual_rtol=1e-5, pipeline_depth=2)
    rj, rt = _solve_both(Aj, At, B, o, dtype=np.float32,
                         shifts0=np.full(2, 1e30))
    assert _DEEP_MAX_BAD == 3
    assert rt.converged and rj.converged
    assert rt.kernel_note == rj.kernel_note
    assert ("cg-pipelined-deep(l=2) fell back to classic cg after "
            "0 iteration(s): indefinite Gram/LDL pivot") in rt.kernel_note
    assert rt.niterations == rj.niterations
    if batch:
        np.testing.assert_array_equal(rt.iterations_per_system,
                                      rj.iterations_per_system)
    for r in (rt, rj):
        x = np.asarray(r.x, np.float64).reshape(-1, At.nrows)
        for xi, bi in zip(x, np.reshape(B, (-1, At.nrows))):
            assert _true_rel(At, xi, bi) < 10 * 1e-5


def test_deep_depth_one_is_cg_pipelined():
    _, At, b = _pair(lambda m: m.poisson3d_7pt(8), 4)
    o = SolverOptions(maxits=2000, residual_rtol=1e-10, pipeline_depth=1)
    op = build_device_operator(At, dtype=np.float64, device="cpu")
    rd = cg_pipelined_deep(op, b, options=o)
    rp = cg_pipelined(op, b, options=o)
    assert rd.niterations == rp.niterations
    assert rd.kernel == rp.kernel and rd.kernel_note == rp.kernel_note
    np.testing.assert_array_equal(rd.x, rp.x)
    np.testing.assert_array_equal(rd.residual_history, rp.residual_history)


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_deep_forced_formats_match_jax(fmt):
    Aj, At, b = _pair(lambda m: m.poisson3d_7pt(6, 5, 7), 5)
    o = dict(maxits=2000, residual_rtol=1e-10, pipeline_depth=2)
    rj, rt = _solve_both(Aj, At, b, o, fmt=fmt)
    assert rt.converged
    assert rt.operator_format == fmt
    assert rt.kernel_note == rj.kernel_note
    assert rt.kernel_note.endswith(f"format forced: {fmt}")
    assert abs(rt.niterations - rj.niterations) <= 1
    assert np.linalg.norm(rt.x - rj.x) <= 1e-9 * np.linalg.norm(rj.x)


def test_deep_check_every_and_maxits_match_jax():
    Aj, At, b = _pair(lambda m: m.poisson2d_5pt(12), 6)
    o = dict(maxits=2000, residual_rtol=1e-10, pipeline_depth=2,
             check_every=4)
    rj, rt = _solve_both(Aj, At, b, o)
    assert rt.converged and abs(rt.niterations - rj.niterations) <= 1
    o = dict(maxits=5, residual_rtol=1e-12, pipeline_depth=3)
    with pytest.raises(JAcgError) as ej:
        jdeep(Aj, b, options=JOptions(**o))
    with pytest.raises(AcgError) as et:
        cg_pipelined_deep(At, b, options=SolverOptions(**o), device="cpu")
    assert et.value.status == Status.ERR_NOT_CONVERGED
    assert et.value.result.niterations == ej.value.result.niterations == 5


@pytest.mark.parametrize("check_every", [1, 4])
def test_deep_reads_the_flag_one_body_late(check_every):
    """The host reads a check point's flag one body late on every device,
    so the CPU runs the card's control flow and the parity tests above
    hold it: a dispatch that ends on a claimed exit runs exactly one body
    past its last update (SpMVs: the entry residual, l fill products,
    k + 1 bodies, the certifier), and that body commits nothing."""
    import torch

    from acg_torch.ops.blas1 import batched_dot, block_dot, combine
    from acg_torch.solvers.cg import _cheb_leja_nodes
    from acg_torch.solvers.loops import _CONVERGED, cg_pipelined_deep_while

    At = tpoisson.poisson3d_7pt(8)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(At.nrows))
    calls = [0]

    def mv(v):
        calls[0] += 1
        return torch.from_numpy(At.matvec(v.numpy()))

    l, f64 = 2, torch.float64
    shifts = torch.from_numpy(12.0 * _cheb_leja_nodes(l))
    x, _kret, rr, flag, _rr0, hist, k, more, drift = cg_pipelined_deep_while(
        mv, block_dot, combine, batched_dot, b, torch.zeros_like(b),
        (torch.tensor(0.0, dtype=f64), torch.tensor(1e-16, dtype=f64)), l,
        shifts, 2000, check_every=check_every)
    assert int(flag) == _CONVERGED and not more and not bool(drift)
    assert k % check_every == 0
    assert calls[0] == 1 + l + (k + 1) + 1
    assert torch.isnan(hist[k + 1])             # the late body's sample
    assert float(rr) < 1e-16 * float(b @ b)


def test_deep_option_validation():
    At = tpoisson.poisson2d_5pt(8)
    b = np.ones(At.nrows)
    for o in (SolverOptions(pipeline_depth=2, diffatol=1e-8,
                            residual_rtol=0.0),
              SolverOptions(pipeline_depth=2, segment_iters=4)):
        with pytest.raises(AcgError) as ei:
            cg_pipelined_deep(At, b, options=o, device="cpu")
        assert ei.value.status == Status.ERR_NOT_SUPPORTED
    # monitor_every runs (as in the JAX package) and changes no bit
    ref = cg_pipelined_deep(At, b, options=SolverOptions(pipeline_depth=2),
                            device="cpu")
    got = cg_pipelined_deep(At, b, options=SolverOptions(
        pipeline_depth=2, monitor_every=2), device="cpu")
    assert got.niterations == ref.niterations
    np.testing.assert_array_equal(got.x, ref.x)
    for bad in (0, 9):
        with pytest.raises(ValueError):
            SolverOptions(pipeline_depth=bad)
