"""Classic and pipelined CG on one device.

The port of ``acg_tpu/solvers/cg.py`` for one device: build the device
operator (:func:`build_device_operator`), run the beta-first classic loop
(:func:`acg_torch.solvers.loops.cg_while`) with the SpMV and p'Ap fused
into one kernel pass (:func:`cg`), or the pipelined loop
(:func:`acg_torch.solvers.loops.cg_pipelined_while`) with the whole
iteration in one kernel pass (:func:`cg_pipelined`), and assemble the
result as ``_finish`` does there.  On a CUDA device every operator
application is a hand-written kernel (``ops/dia_kernels.py``,
``ops/stencil.py``); the BLAS-1 updates of the classic loop are ordinary
torch ops, as they were XLA's in the JAX package.

A ``b`` of shape (B, n) solves B systems against the one operator in one
loop (multi-RHS): every operator application goes through the batched
SpMV kernel, which reads the operator once for all systems, and the
result carries per-system counts, residuals and histories.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.ops.blas1 import batched_dot, ddot, dnrm2
from acg_torch.ops.dia import DeviceDia, DiaMatrix, dia_efficiency
from acg_torch.ops.stencil import DeviceStencil, try_device_stencil
from acg_torch.solvers.base import (SolveResult, SolveStats,
                                    cg_flops_per_iter, conform_x0_batch,
                                    kernel_disengagement_note, path_names)
from acg_torch.solvers.loops import (_BREAKDOWN, _CONVERGED, _FAULT, _OK,
                                     cg_pipelined_while, cg_while)
from acg_torch.sparse.csr import CsrMatrix
from acg_torch.utils.backend import resolve_device

_FORMATS = ("auto", "dia", "stencil", "ell", "sgell")


def build_device_operator(A, dtype=None, fmt: str = "auto",
                          mat_dtype="auto", device=None):
    """Build the device operator (the upload half of solver init,
    reference acg/cgcuda.c:138-328).

    ``fmt="auto"`` takes the matrix-free stencil tier when ``A`` is a
    verified constant-coefficient grid stencil, else DIA when the diagonal
    fill is dense enough (``dia_efficiency >= 0.25``).  ``fmt="stencil"``
    recognizes or raises; ``fmt="dia"`` forces stored bands.  A matrix
    that would need the RCM, sgell or ELL tiers raises ERR_NOT_SUPPORTED:
    those tiers are not ported yet.  ``mat_dtype`` sets the band storage
    precision (:meth:`DeviceDia.from_dia`)."""
    if isinstance(A, (DeviceDia, DeviceStencil)):
        return A
    if fmt not in _FORMATS:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"unknown operator format {fmt!r} "
                       "(auto|dia|ell|sgell|stencil)")
    if fmt in ("ell", "sgell"):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"format {fmt!r}: tier not yet ported")
    if not isinstance(A, (DiaMatrix, CsrMatrix)):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"unsupported operator type {type(A).__name__}")
    dev = resolve_device(device)
    host_vals = A.bands if isinstance(A, DiaMatrix) else A.vals
    vdt = np.dtype(dtype) if dtype is not None else np.dtype(host_vals.dtype)
    if fmt == "stencil":
        return DeviceStencil.from_matrix(A, dtype=vdt, device=dev)
    if fmt == "auto":
        st, _why = try_device_stencil(A, dtype=vdt, device=dev)
        if st is not None:
            return st
    if isinstance(A, CsrMatrix):
        if fmt == "auto" and dia_efficiency(A) < 0.25:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "the matrix has too little diagonal structure "
                           "for DIA; its RCM+DIA, sgell and ELL tiers: "
                           "tier not yet ported")
        A = DiaMatrix.from_csr(A)
    return DeviceDia.from_dia(A, dtype=vdt, mat_dtype=mat_dtype, device=dev)


def _prepare(A, b, x0, dtype, fmt: str, mat_dtype, device):
    """(operator, b padded on its device, x0 padded on its device).  A
    (B, n) ``b`` gives (B, nrows_padded) tensors, each row padded; x0 is
    then (B, n), or 1-D and shared by every system."""
    op = build_device_operator(A, dtype=dtype, fmt=fmt, mat_dtype=mat_dtype,
                               device=device)
    vdt = getattr(torch, op.vec_dtype)
    nrp = op.nrows_padded

    def to_dev(v):
        if (isinstance(v, torch.Tensor) and v.dim() in (1, 2)
                and v.shape[-1] == nrp and v.dtype == vdt
                and v.device == op.device and v.is_contiguous()):
            return v
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        v = np.asarray(v)
        if v.ndim not in (1, 2) or v.size == 0:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"vectors are (n,), or (B, n) for B right-hand "
                           f"sides; got shape {v.shape}")
        if v.shape[-1] not in (op.nrows, nrp):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"vector has {v.shape[-1]} entries, operator has "
                           f"{op.nrows} rows")
        out = torch.zeros(v.shape[:-1] + (nrp,), dtype=vdt)
        out[..., : v.shape[-1]] = torch.from_numpy(
            np.ascontiguousarray(v, dtype=np.dtype(op.vec_dtype)))
        return out.to(op.device)

    b_pad = to_dev(b)
    x0_pad = torch.zeros_like(b_pad) if x0 is None else to_dev(x0)
    x0_pad = conform_x0_batch(
        x0_pad, tuple(b_pad.shape),
        lambda v: v.expand(b_pad.shape[0], -1).contiguous())
    return op, b_pad, x0_pad


def _describe_path(op, fmt: str, pipelined: bool = False,
                   replace_every: int = 0,
                   batch: int = 0) -> tuple[str, str, str]:
    """(operator_format, kernel, note) actually in effect.  ``batch`` > 0
    is a (batch, n) multi-RHS solve, whose loop runs the batched SpMV
    kernel.  A pipelined solve runs the single-kernel iteration unless a
    batch or ``replace_every`` disengages it."""
    stencil = isinstance(op, DeviceStencil)
    engaged = replace_every == 0 and not batch
    body = ("batched" if batch else "fused" if not pipelined
            else "pipe" if engaged else "spmv")
    note = kernel_disengagement_note(pipelined, engaged, replace_every,
                                     forced_fmt=fmt, stencil=stencil,
                                     batch=batch)
    return path_names("stencil" if stencil else "dia", op.device.type,
                      body) + (note,)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finish(op, x, k, rr, flag, rr0, options: SolverOptions,
            tsolve: float, bnrm2, dxx=None, stats=None,
            path=("", "", ""), hist=None,
            pipelined: bool = False) -> SolveResult:
    """Assemble the SolveResult and raise the classified errors, as
    ``acg_tpu.solvers.cg._finish`` does.  A multi-RHS solve (``x`` of
    shape (B, n); ``k``, ``flag`` and the norms per system) is summarized
    by its WORST system by relative residual, which supplies rnrm2,
    r0nrm2 and bnrm2 (one system's pair, never a cross-system mix); a
    fault in any system dominates, then a breakdown in any, then "all
    converged"; flops count each system's own iterations."""
    batched = x.dim() == 2
    x_host = x[..., : op.nrows].cpu().numpy()
    bnrm2 = np.asarray(bnrm2, dtype=np.float64)
    if batched:
        ksys = k.cpu().numpy().astype(np.int64)
        flags = flag.cpu().numpy().astype(np.int64)
        rnrm2s = np.sqrt(rr.cpu().numpy().astype(np.float64))
        r0nrm2s = np.sqrt(rr0.cpu().numpy().astype(np.float64))
        k = int(ksys.max())
        flag = (_FAULT if np.any(flags == _FAULT)
                else _BREAKDOWN if np.any(flags == _BREAKDOWN)
                else _CONVERGED if np.all(flags == _CONVERGED) else _OK)
        rel = rnrm2s / np.where(r0nrm2s > 0, r0nrm2s, 1.0)
        worst = int(np.argmax(rel))
        rnrm2, r0nrm2 = float(rnrm2s[worst]), float(r0nrm2s[worst])
        bnrm2 = float(bnrm2[worst])
        niters_total = int(ksys.sum())
    else:
        rnrm2 = float(np.sqrt(float(rr)))
        r0nrm2 = float(np.sqrt(float(rr0)))
        bnrm2 = float(bnrm2)
        niters_total = k
    st = stats if stats is not None else SolveStats()
    st.nsolves += 1
    st.ntotaliterations += k
    st.niterations = k
    # useful flops: each system advances only while it is active
    st.nflops += niters_total * cg_flops_per_iter(op.nnz, op.nrows,
                                                  pipelined)
    st.tsolve += tsolve
    o = options
    res = SolveResult(
        x=x_host, converged=(flag == _CONVERGED), niterations=k,
        bnrm2=bnrm2, r0nrm2=r0nrm2, rnrm2=rnrm2,
        dxnrm2=(float(np.sqrt(float(dxx.max()))) if dxx is not None
                else float("inf")),
        stats=st,
        fpexcept=("none" if (np.isfinite(rnrm2)
                             and np.all(np.isfinite(x_host)))
                  else "non-finite values in solution or residual"),
        operator_format=path[0], kernel=path[1], kernel_note=path[2],
        residual_history=(hist[..., : k + 1].cpu().numpy().astype(np.float64)
                          if hist is not None else None))
    if batched:
        res.nrhs = len(ksys)
        res.iterations_per_system = ksys
        res.rnrm2_per_system = rnrm2s
        res.r0nrm2_per_system = r0nrm2s
        res.converged_per_system = flags == _CONVERGED
    if flag == _FAULT:
        res.status = Status.ERR_FAULT_DETECTED
        res.fpexcept = (
            f"non-finite residual reduction |r|^2 = {rnrm2!r} detected "
            f"by the on-device guard at iteration {k}"
            if not np.isfinite(rnrm2) else
            f"non-finite reduction (p'Ap / delta) detected by the "
            f"on-device guard at iteration {k} (|r|^2 still finite)")
        err = AcgError(Status.ERR_FAULT_DETECTED,
                       f"solve aborted at iteration {k}: {res.fpexcept}")
        err.result = res
        raise err
    if flag == _BREAKDOWN:
        res.status = Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX
        err = AcgError(Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX)
        err.result = res
        raise err
    no_criteria = (o.diffatol == 0 and o.diffrtol == 0
                   and o.residual_atol == 0 and o.residual_rtol == 0)
    if flag != _CONVERGED and not no_criteria:
        res.status = Status.ERR_NOT_CONVERGED
        err = AcgError(Status.ERR_NOT_CONVERGED,
                       f"CG did not converge in {o.maxits} iterations "
                       f"(|r|/|r0| = {res.relative_residual:.3e})")
        err.result = res
        raise err
    if no_criteria:
        res.converged = True
        if batched:
            res.converged_per_system = np.ones(res.nrhs, dtype=bool)
    if res.fpexcept != "none":
        res.status = Status.ERR_NONFINITE
    return res


def cg(A, b, x0=None, options: SolverOptions = SolverOptions(),
       dtype=None, fmt: str = "auto", mat_dtype="auto",
       stats: SolveStats | None = None, device=None) -> SolveResult:
    """Classic CG on one device (``acg_tpu.solvers.cg.cg``).

    ``A`` is a host CsrMatrix or DiaMatrix, or an operator already built
    by :func:`build_device_operator` (then ``fmt`` only labels the path
    report).  ``b`` of shape (B, n) solves B systems in one loop, each
    T = A P with its per-system p'Ap from one pass of the batched SpMV
    kernel (``cuda-stencil-batched`` / ``cuda-dia-batched``); the result
    then carries per-system counts, residuals and histories.
    ``device`` defaults to ``cuda`` and raises when no card is present;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    Raises ``AcgError`` with the partial result attached as ``.result``
    on breakdown or non-convergence, as the JAX solver does."""
    o = options
    if o.segment_iters or o.monitor_every:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "segment_iters / monitor_every: not yet ported")
    op, b_pad, x0_pad = _prepare(A, b, x0, dtype, fmt, mat_dtype, device)
    vdt = b_pad.dtype
    batch = b_pad.shape[0] if b_pad.dim() == 2 else 0

    def scalar(v):
        return torch.tensor(v, dtype=vdt, device=op.device)

    stop2 = (scalar(o.residual_atol ** 2), scalar(o.residual_rtol ** 2))
    track_diff = o.diffatol > 0 or o.diffrtol > 0
    diffstop = o.diffatol ** 2              # diffrtol needs |x0|
    if o.diffrtol > 0:
        if batch:           # per-system |x0| -> per-system threshold
            diffstop = torch.clamp((o.diffrtol * dnrm2(x0_pad)) ** 2,
                                   min=diffstop)
        else:
            x0n = float(dnrm2(x0_pad))
            diffstop = max(diffstop, (o.diffrtol * x0n) ** 2)
    bnrm2 = dnrm2(b_pad).cpu().numpy()

    def coupled(r, p, beta):
        # p = r + beta p, in place (beta per system in a batch)
        torch.addcmul(r, p, beta[:, None] if batch else beta, out=p)
        t, ptap = op.matvec_dot(p)
        return p, t, ptap

    _sync(op.device)
    t0 = time.perf_counter()
    x, k, rr, dxx, flag, rr0, hist = cg_while(
        op.matvec, ddot, b_pad, x0_pad, stop2, diffstop,
        maxits=o.maxits, track_diff=track_diff, check_every=o.check_every,
        coupled_step=coupled, guard=o.guard_nonfinite)
    _sync(op.device)
    tsolve = time.perf_counter() - t0
    return _finish(op, x, k, rr, flag, rr0, o, tsolve, bnrm2,
                   dxx=dxx if track_diff else None, stats=stats,
                   path=_describe_path(op, fmt, batch=batch), hist=hist)


def _dot2(a1, b1, a2, b2):
    """The pipelined loop's one reduction point: both scalars of a single
    conceptual reduction (the reference's one 2-double allreduce,
    acg/cgcuda.c:1697), per system for (B, n) operands."""
    return batched_dot(a1, b1), batched_dot(a2, b2)


def _pipe_step(op):
    """The loop's ``iter_step`` over the operator's single-kernel
    pipelined iteration.  The kernel writes w' beside w, so two w buffers
    alternate: the w a step consumed is the next step's output buffer."""
    spare = [None]

    def step(z, r, p, w, s, x, alpha, beta):
        out = op.pipelined_iter(w, z, r, p, s, x, alpha, beta,
                                w_out=spare[0])
        spare[0] = w
        return out

    return step


def cg_pipelined(A, b, x0=None, options: SolverOptions = SolverOptions(),
                 dtype=None, fmt: str = "auto", mat_dtype="auto",
                 stats: SolveStats | None = None,
                 device=None) -> SolveResult:
    """Pipelined CG on one device (``acg_tpu.solvers.cg.cg_pipelined``):
    one fused (gamma, delta) reduction per iteration, and on the card the
    whole iteration in one hand-written kernel (``cuda-stencil-pipe`` /
    ``cuda-dia-pipe``).

    Arguments and errors as :func:`cg`.  Residual criteria only (the
    diff criteria raise ERR_NOT_SUPPORTED, as in the JAX package).
    ``options.replace_every > 0`` runs the open-coded body (the SpMV
    kernel, torch updates and dots) with residual replacement, and says
    so in ``kernel_note``.  A (B, n) ``b`` runs the open-coded body too,
    its SpMVs through the batched kernel (``cuda-*-batched``; the
    single-kernel iteration is not batched, as in the JAX package)."""
    o = options
    if o.diffatol > 0 or o.diffrtol > 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "pipelined CG supports residual-based stopping only")
    if o.segment_iters or o.monitor_every:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "segment_iters / monitor_every: not yet ported")
    op, b_pad, x0_pad = _prepare(A, b, x0, dtype, fmt, mat_dtype, device)
    vdt = b_pad.dtype
    batch = b_pad.shape[0] if b_pad.dim() == 2 else 0
    stop2 = (torch.tensor(o.residual_atol ** 2, dtype=vdt, device=op.device),
             torch.tensor(o.residual_rtol ** 2, dtype=vdt, device=op.device))
    bnrm2 = dnrm2(b_pad).cpu().numpy()
    # exit certification only where an exit can be claimed
    certify = o.residual_atol > 0 or o.residual_rtol > 0
    iter_step = (_pipe_step(op) if o.replace_every == 0 and not batch
                 else None)
    _sync(op.device)
    t0 = time.perf_counter()
    x, k, rr, flag, rr0, hist = cg_pipelined_while(
        op.matvec, _dot2, b_pad, x0_pad, stop2, maxits=o.maxits,
        check_every=o.check_every, replace_every=o.replace_every,
        certify=certify, iter_step=iter_step, guard=o.guard_nonfinite)
    _sync(op.device)
    tsolve = time.perf_counter() - t0
    return _finish(op, x, k, rr, flag, rr0, o, tsolve, bnrm2, stats=stats,
                   path=_describe_path(op, fmt, True, o.replace_every,
                                       batch),
                   hist=hist, pipelined=True)
