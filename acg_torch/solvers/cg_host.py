"""Host (NumPy) reference conjugate-gradient solver.

Functional twin of the reference CPU solver (reference acg/cg.c:198-380
``acgsolver_solve``): classic CG with the same four stopping criteria
(maxits; ``diffatol``/``diffrtol`` on the solution update; ``residual_atol``/
``residual_rtol`` on the residual, rtol relative to ``|b-Ax0|``), the
indefinite-matrix breakdown error where the reference returns it
(ref acg/cg.c:304,357 — here sharpened to the SPD witness p'Ap < 0, or
== 0 with a nonzero residual; an exactly-zero residual is exactness, not
breakdown, matching the device loops), and the same stats bookkeeping.
Serves as the correctness oracle for the device solvers — the role
acg/cg.c plays for the CUDA/HIP paths (SURVEY §4.3).  The port's copy of
``acg_tpu.solvers.cg_host``: running on the host is what it is for.
"""

from __future__ import annotations

import time

import numpy as np

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.solvers.base import SolveResult, SolveStats


def cg_host(A, b: np.ndarray, x0: np.ndarray | None = None,
            options: SolverOptions = SolverOptions(),
            stats: SolveStats | None = None) -> SolveResult:
    """Solve Ax=b with classic CG on the host.

    ``A`` is anything with ``matvec`` (CsrMatrix, EllMatrix, dense ndarray
    wrapped by ``lambda``-free duck typing).  Raises :class:`AcgError`
    with ``ERR_NOT_CONVERGED`` on criteria unmet at maxits
    (ref acg/cg.c:377) and ``ERR_NOT_CONVERGED_INDEFINITE_MATRIX`` on the
    SPD witness failing (p'Ap < 0, or == 0 with a nonzero residual; ref
    acg/cg.c:304,357 — the reference also errors on a vanished residual,
    which here counts as exact convergence instead).
    """
    o = options
    if o.monitor_every:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "monitor_every: not yet ported")
    matvec = A.matvec if hasattr(A, "matvec") else (lambda v: A @ v)
    b = np.asarray(b)
    if b.ndim != 1:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "cg_host solves one right-hand side at a time "
                       "(multi-RHS batches are a device-solver feature "
                       "— use cg()/cg_dist())")
    x = np.zeros_like(b) if x0 is None else np.array(x0, copy=True)
    st = stats if stats is not None else SolveStats()
    track_diff = o.diffatol > 0 or o.diffrtol > 0

    t0 = time.perf_counter()
    st.nsolves += 1
    bnrm2 = float(np.linalg.norm(b))
    x0nrm2 = float(np.linalg.norm(x)) if track_diff else float("inf")
    diffrtol = o.diffrtol * x0nrm2 if track_diff else 0.0

    r = b - matvec(x)                       # r0 = b - A x0 (ref cg.c:260-292)
    rnrm2sqr = float(r @ r)
    r0nrm2 = np.sqrt(rnrm2sqr)
    rnrm2 = r0nrm2
    dxnrm2 = float("inf")
    residualrtol = o.residual_rtol * r0nrm2
    # per-iteration residual-norm² trajectory — same contract as the
    # device loops' history (acg_torch/solvers/loops.py): entry k
    # holds |r_k|², length niterations+1 on exit
    hist = [rnrm2sqr]

    def _result(converged, niter):
        st.niterations = niter
        st.tsolve += time.perf_counter() - t0
        return SolveResult(x=x, converged=converged, niterations=niter,
                           bnrm2=bnrm2, r0nrm2=r0nrm2, rnrm2=rnrm2,
                           x0nrm2=x0nrm2, dxnrm2=dxnrm2, stats=st,
                           residual_history=np.asarray(hist[: niter + 1]))

    any_crit = (o.diffatol > 0 or o.diffrtol > 0
                or o.residual_atol > 0 or o.residual_rtol > 0)

    # residual may already satisfy the criteria at x0; an exactly-zero
    # residual satisfies any enabled criterion (b = 0 or x0 exact — the
    # relative threshold degenerates to the unreachable strict rnrm2 < 0)
    if ((o.residual_atol > 0 and rnrm2 < o.residual_atol)
            or (o.residual_rtol > 0 and rnrm2 < residualrtol)
            or (any_crit and rnrm2sqr == 0.0)):
        return _result(True, 0)

    p = r.copy()
    for k in range(o.maxits):
        t = matvec(p)                        # t = A p
        ptap = float(p @ t)
        # for SPD A, p'Ap == 0 with r != 0 is impossible (p·r = |r|^2 > 0
        # means p != 0), so <= 0 with a nonzero residual proves
        # indefiniteness; with r == 0 it is exactness — freeze (alpha=0)
        # and keep looping, as the device loop does (fixed-iteration runs)
        if ptap < 0.0 or (ptap == 0.0 and rnrm2sqr > 0.0):
            # the PARTIAL result rides the error (as on the device
            # solvers): the CLI still exports stats for a breakdown,
            # and the resilience supervisor reads the classification
            # off result.status
            res = _result(False, k)
            res.status = Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX
            err = AcgError(Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX)
            err.result = res
            raise err
        if o.guard_nonfinite and not (np.isfinite(ptap)
                                      and np.isfinite(rnrm2sqr)):
            # the host face of the device loops' finiteness guard
            res = _result(False, k)
            res.status = Status.ERR_FAULT_DETECTED
            res.fpexcept = (f"non-finite reduction at iteration {k} "
                            f"(|r|^2 = {rnrm2sqr!r}, p'Ap = {ptap!r})")
            err = AcgError(Status.ERR_FAULT_DETECTED, res.fpexcept)
            err.result = res
            raise err
        alpha = rnrm2sqr / ptap if ptap > 0.0 else 0.0
        if track_diff:
            dx_prev = x.copy()
        x += alpha * p                       # x = x + alpha p
        if track_diff:
            dxnrm2 = float(np.linalg.norm(x - dx_prev))
        r -= alpha * t                       # r = r - alpha t
        rnrm2sqr_prev = rnrm2sqr
        rnrm2sqr = float(r @ r)
        rnrm2 = float(np.sqrt(rnrm2sqr))
        hist.append(rnrm2sqr)
        st.ntotaliterations += 1
        if ((o.diffatol > 0 and dxnrm2 < o.diffatol)
                or (o.diffrtol > 0 and dxnrm2 < diffrtol)
                or (o.residual_atol > 0 and rnrm2 < o.residual_atol)
                or (o.residual_rtol > 0 and rnrm2 < residualrtol)
                or (any_crit and rnrm2sqr == 0.0)):
            return _result(True, k + 1)
        beta = rnrm2sqr / rnrm2sqr_prev if rnrm2sqr_prev > 0.0 else 0.0
        p = r + beta * p                     # p = r + beta p

    # maxits exhausted: success iff no convergence criterion was enabled
    # (ref acg/cg.c:370-378)
    if (o.diffatol == 0 and o.diffrtol == 0
            and o.residual_atol == 0 and o.residual_rtol == 0):
        return _result(True, o.maxits)
    res = _result(False, o.maxits)
    res.status = Status.ERR_NOT_CONVERGED
    err = AcgError(Status.ERR_NOT_CONVERGED,
                   f"CG did not converge in {o.maxits} iterations "
                   f"(|r|/|r0| = {res.relative_residual:.3e})")
    err.result = res
    raise err
