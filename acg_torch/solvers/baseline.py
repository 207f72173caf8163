"""Differential baseline solver: SciPy CG (the PETSc-wrapper analog).

The reference ships PETSc KSPCG / KSPPIPECG wrappers as independent
same-input baselines for differential testing and benchmarking (reference
acg/cgpetsc.{h,c}, ``enum acgpetscksptype`` cgpetsc.h:67-71, the
reference program's integration cuda/acg-cuda.c:2300-2342).  PETSc does
not exist in the TPU stack; the equivalent independent implementation is
``scipy.sparse.linalg.cg`` — a third-party, host-side CG against which
every device solver is differentially checked (SURVEY.md §4.3).

The CLI accepts ``--solver petsc`` / ``--solver petsc-pipelined`` (both map
here — SciPy has one CG; the pipelined distinction is a communication
schedule, meaningless in a serial baseline) and prints the same stats block
as the native solvers.  The port's copy of ``acg_tpu.solvers.baseline``:
a host solver by design, never a fallback.
"""

from __future__ import annotations

import time

import numpy as np

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.solvers.base import SolveResult, SolveStats, cg_flops_per_iter


def cg_scipy(A, b, x0=None, options: SolverOptions = SolverOptions(),
             stats: SolveStats | None = None,
             record_history: bool | None = None) -> SolveResult:
    """Solve Ax=b with scipy.sparse.linalg.cg (ref acgsolverpetsc_solve,
    acg/cgpetsc.h:185-225).

    Stopping: SciPy's criterion is |r| <= max(rtol*|b|, atol); the
    reference's is relative to |r0| = |b - A x0|.  With the default x0=0
    the two coincide; for nonzero x0 the translated rtol is
    rtol*|r0|/|b| (exact, computed here).

    ``record_history`` opts into a per-iteration TRUE-residual
    ``residual_history`` (scipy exposes only the iterate, so each sample
    costs one extra SpMV inside the timed window — this baseline's
    tsolve is a differential comparison number, so it records only when
    asked; the live monitor, ``options.monitor_every``, is not yet
    ported).
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    o = options
    if o.monitor_every:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "monitor_every: not yet ported")
    t0 = time.perf_counter()
    b = np.asarray(b)
    if b.ndim != 1:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "the scipy baseline solves one right-hand side at "
                       "a time (multi-RHS batches are a device-solver "
                       "feature — use cg()/cg_dist())")
    S = sp.csr_matrix((A.vals, A.colidx, A.rowptr), shape=(A.nrows, A.ncols))
    bnrm2 = float(np.linalg.norm(b))
    r0 = b - S @ x0 if x0 is not None else b
    r0nrm2 = float(np.linalg.norm(r0))
    # translate the reference's stopping rule into scipy's
    atol = float(o.residual_atol)
    rtol = 0.0
    if o.residual_rtol > 0:
        if bnrm2 > 0:
            rtol = o.residual_rtol * r0nrm2 / bnrm2
        else:
            atol = max(atol, o.residual_rtol * r0nrm2)
    if o.diffatol > 0 or o.diffrtol > 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "scipy baseline supports residual-based stopping only")

    niters = 0
    # true-residual trajectory, same contract as the native solvers'
    # residual_history (entry k = |r_k|²); opt-in — see docstring
    record = bool(record_history)
    hist = [r0nrm2 ** 2]

    def _count(xk):
        nonlocal niters
        niters += 1
        if record:
            hist.append(float(np.linalg.norm(b - S @ xk) ** 2))

    x, info = spla.cg(S, b, x0=x0, rtol=rtol, atol=atol,
                      maxiter=o.maxits or None, callback=_count)
    tsolve = time.perf_counter() - t0
    rnrm2 = float(np.linalg.norm(b - S @ x))

    st = stats if stats is not None else SolveStats()
    st.nsolves += 1
    st.niterations = niters
    st.ntotaliterations += niters
    st.nflops += niters * cg_flops_per_iter(A.nnz, A.nrows)
    st.tsolve += tsolve
    res = SolveResult(
        x=x, converged=(info == 0), niterations=niters, bnrm2=bnrm2,
        r0nrm2=r0nrm2, rnrm2=rnrm2, stats=st,
        fpexcept=("none" if np.all(np.isfinite(x))
                  else "non-finite values in solution"),
        residual_history=(np.asarray(hist[: niters + 1])
                          if record else None))
    no_criteria = (o.residual_atol == 0 and o.residual_rtol == 0)
    if info > 0 and not no_criteria:
        res.status = Status.ERR_NOT_CONVERGED
        err = AcgError(Status.ERR_NOT_CONVERGED,
                       f"scipy CG did not converge in {info} iterations")
        err.result = res
        raise err
    if info < 0:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"scipy CG illegal input (info={info})")
    if no_criteria:
        res.converged = True
    if res.fpexcept != "none":
        res.status = Status.ERR_NONFINITE
    return res
