"""Classic and pipelined CG on one device.

The port of ``acg_tpu/solvers/cg.py`` for one device: build the device
operator (:func:`build_device_operator`), run the beta-first classic loop
(:func:`acg_torch.solvers.loops.cg_while`) with the SpMV and p'Ap fused
into one kernel pass (:func:`cg`), or the pipelined loop
(:func:`acg_torch.solvers.loops.cg_pipelined_while`) with the whole
iteration in one kernel pass (:func:`cg_pipelined`), and assemble the
result as ``_finish`` does there.  On a CUDA device every operator
application is a hand-written kernel (``ops/dia_kernels.py``,
``ops/stencil.py``, ``ops/spmv.py``, ``ops/sgell.py``); the BLAS-1
updates of the classic loop are ordinary torch ops, as they were XLA's
in the JAX package.  The unstructured tiers (padded ELL, segmented-gather
ELL) have no fused kernels: their loops run the SpMV kernel and then the
dots, as the JAX package's non-fused loops do.  An operator in an RCM
ordering (:class:`PermutedOperator`) sees b and x0 permuted on entry and
returns x in the caller's ordering.

A ``b`` of shape (B, n) solves B systems against the one operator in one
loop (multi-RHS): every operator application goes through the batched
SpMV kernel, which reads the operator once for all systems (on the ELL
and sgell tiers, the one-system kernel once per system), and the result
carries per-system counts, residuals and histories.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.ops.blas1 import batched_dot, ddot, dnrm2
from acg_torch.ops.dia import DeviceDia, DiaMatrix, dia_efficiency
from acg_torch.ops.sgell import (DeviceSgell, build_device_sgell,
                                 sgell_require_available)
from acg_torch.ops.spmv import DeviceEll, pad_vector
from acg_torch.ops.stencil import DeviceStencil, try_device_stencil
from acg_torch.solvers.base import (SolveResult, SolveStats,
                                    cg_flops_per_iter, conform_x0_batch,
                                    kernel_disengagement_note, path_names)
from acg_torch.solvers.loops import (_BREAKDOWN, _CONVERGED, _FAULT, _OK,
                                     cg_pipelined_while, cg_while)
from acg_torch.sparse.csr import CsrMatrix
from acg_torch.sparse.ell import EllMatrix
from acg_torch.sparse.rcm import permute_symmetric, rcm_order
from acg_torch.utils.backend import resolve_device
from acg_torch.utils.timing import host_step

_FORMATS = ("auto", "dia", "stencil", "ell", "sgell")


class PermutedOperator:
    """A device operator applied in a permuted row/column ordering
    (``acg_tpu.solvers.cg.PermutedOperator``).

    ``dev`` acts on vectors in the permuted space; ``perm`` is new_to_old
    (v_perm = v[perm]).  The solvers permute b and x0 on entry and
    un-permute the solution on exit, so callers never see the
    reordering.  Every other attribute is ``dev``'s."""

    def __init__(self, dev, perm: np.ndarray):
        self.dev = dev
        self.perm = np.asarray(perm)

    def __getattr__(self, name):
        return getattr(self.dev, name)


def build_device_operator(A, dtype=None, fmt: str = "auto",
                          mat_dtype="auto", device=None,
                          timings: dict | None = None):
    """Build the device operator (the upload half of solver init,
    reference acg/cgcuda.c:138-328), with the ladder of
    ``acg_tpu.solvers.cg.build_device_operator``.

    ``fmt="auto"`` takes the matrix-free stencil tier when ``A`` is a
    verified constant-coefficient grid stencil, else DIA when the
    diagonal fill is dense enough (``dia_efficiency >= 0.25``).  A CSR
    matrix with less diagonal structure is reordered by RCM: DIA on the
    permuted matrix when that recovers a band (``rcm+dia``), else the
    segmented-gather ELL pack of the permuted matrix when its fill clears
    ``MIN_FILL`` at f32 vectors (``rcm+sgell``), else padded ELL on the
    original ordering (``ell``).  The RCM tiers come back as a
    :class:`PermutedOperator`.  ``fmt="stencil"`` recognizes or raises;
    ``fmt="dia"`` forces stored bands; ``fmt="ell"`` forces padded ELL
    and ``fmt="sgell"`` the sgell pack with no fill gate (f32 vectors
    only, else ERR_NOT_SUPPORTED), both on the given ordering.  A host
    DiaMatrix always gives DIA (or the stencil), an EllMatrix always ELL.
    ``mat_dtype`` sets the operator's storage precision.  ``timings``
    gathers the host seconds of the build's steps (``rcm``, ``permute``,
    ``dia_check``, ``dia_build``, ``pack``, ``ell_build``, ``upload``,
    ``slice``)."""
    if isinstance(A, (DeviceDia, DeviceStencil, DeviceEll, DeviceSgell,
                      PermutedOperator)):
        return A
    if fmt not in _FORMATS:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"unknown operator format {fmt!r} "
                       "(auto|dia|ell|sgell|stencil)")
    if isinstance(A, EllMatrix):
        return DeviceEll.from_ell(A, dtype=dtype, mat_dtype=mat_dtype,
                                  device=device, timings=timings)
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
    if isinstance(A, DiaMatrix):
        return DeviceDia.from_dia(A, dtype=vdt, mat_dtype=mat_dtype,
                                  device=dev)
    if fmt == "sgell":
        # a forced tier builds or raises, never falls back; its fill gate
        # is lifted (auto applies the break-even economics)
        sgell_require_available(vdt)
        sg = build_device_sgell(A, dtype=vdt, mat_dtype=mat_dtype,
                                min_fill=0.0, device=dev, timings=timings)
        if sg is None:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "format 'sgell' forced but the matrix did not "
                           "pack (degenerate geometry)")
        return sg

    def dia(M):
        with host_step(timings, "dia_build"):
            return DeviceDia.from_dia(DiaMatrix.from_csr(M), dtype=vdt,
                                      mat_dtype=mat_dtype, device=dev)

    if fmt == "auto":
        with host_step(timings, "dia_check"):
            banded = dia_efficiency(A) >= 0.25
        if banded:
            return dia(A)
        # RCM before giving up on the gather-free form: it often recovers
        # a band from a scattered ordering, and its locality is what the
        # sgell pack feeds on (few x segments per 128-row window)
        with host_step(timings, "rcm"):
            perm = rcm_order(A)
        with host_step(timings, "permute"):
            Ap = permute_symmetric(A, perm)
        with host_step(timings, "dia_check"):
            banded = dia_efficiency(Ap) >= 0.25
        if banded:
            return PermutedOperator(dia(Ap), perm)
        sg = build_device_sgell(Ap, dtype=vdt, mat_dtype=mat_dtype,
                                device=dev, timings=timings)
        if sg is not None:
            return PermutedOperator(sg, perm)
        # the permuted ordering has equal or better locality, so a failed
        # pack there decides the sgell question for the original ordering
        # too: padded ELL on the original ordering
        fmt = "ell"
    if fmt == "dia":
        return dia(A)
    with host_step(timings, "ell_build"):
        E = EllMatrix.from_csr(A)
    return DeviceEll.from_ell(E, dtype=vdt, mat_dtype=mat_dtype, device=dev,
                              timings=timings)


def _prepare(A, b, x0, dtype, fmt: str, mat_dtype, device):
    """(operator, b padded on its device, x0 padded on its device, perm).
    A (B, n) ``b`` gives (B, nrows_padded) tensors, each row padded; x0 is
    then (B, n), or 1-D and shared by every system.  When the operator is
    a :class:`PermutedOperator` it is unwrapped, ``perm`` is its
    new_to_old permutation (else None), and b and x0 are permuted here."""
    op = build_device_operator(A, dtype=dtype, fmt=fmt, mat_dtype=mat_dtype,
                               device=device)
    perm = None
    if isinstance(op, PermutedOperator):
        perm, op = op.perm, op.dev
    vdt = getattr(torch, op.vec_dtype)
    nrp = op.nrows_padded

    def to_dev(v):
        if (perm is None and isinstance(v, torch.Tensor)
                and v.dim() in (1, 2) and v.shape[-1] == nrp
                and v.dtype == vdt and v.device == op.device
                and v.is_contiguous()):
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
        if perm is not None:
            v = v[..., perm]
        # a C-ordered copy: the solver shares no memory with the caller's
        # arrays, and a permuted (B, n) batch (numpy may lay v[..., perm]
        # out column-major) gets the row layout of a 1-D solve
        return torch.from_numpy(np.array(pad_vector(v, nrp), order="C",
                                         dtype=np.dtype(op.vec_dtype))
                                ).to(op.device)

    b_pad = to_dev(b)
    x0_pad = torch.zeros_like(b_pad) if x0 is None else to_dev(x0)
    x0_pad = conform_x0_batch(
        x0_pad, tuple(b_pad.shape),
        lambda v: v.expand(b_pad.shape[0], -1).contiguous())
    return op, b_pad, x0_pad, perm


def _describe_path(op, fmt: str, pipelined: bool = False,
                   replace_every: int = 0, batch: int = 0,
                   perm=None) -> tuple[str, str, str]:
    """(operator_format, kernel, note) actually in effect.  ``perm`` is
    not None for an operator in an RCM ordering.  ``batch`` > 0 is a
    (batch, n) multi-RHS solve, whose loop runs the batched SpMV kernel
    (the ELL and sgell tiers: their one-system kernel once per system).
    A pipelined solve runs the single-kernel iteration where the tier has
    one, unless a batch or ``replace_every`` disengages it; the ELL and
    sgell loops run their SpMV kernel in every body.  On the DIA tier
    a loop whose SpMV is a one-vector kernel names the kernel of the
    operator's plan: ``cuda-dia-hbm-ring`` / ``cuda-dia-hbm`` for x past
    the card's L2."""
    tier = ("sgell" if isinstance(op, DeviceSgell)
            else "ell" if isinstance(op, DeviceEll)
            else "stencil" if isinstance(op, DeviceStencil) else "dia")
    has_pipe = hasattr(op, "pipelined_iter")
    engaged = has_pipe and replace_every == 0 and not batch
    body = ("spmv" if not has_pipe else "batched" if batch
            else "fused" if not pipelined else "pipe" if engaged
            else "spmv")
    if tier == "dia" and body in ("fused", "spmv") and op.kind != "resident":
        # the SpMV of the loop body runs the kernel of the operator's plan
        body = op.kind
    note = kernel_disengagement_note(pipelined, engaged, replace_every,
                                     forced_fmt=fmt,
                                     stencil=tier == "stencil", batch=batch,
                                     has_pipe=has_pipe)
    return path_names(tier, op.device.type, body,
                      rcm=perm is not None) + (note,)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finish(op, x, k, rr, flag, rr0, options: SolverOptions,
            tsolve: float, bnrm2, dxx=None, stats=None,
            path=("", "", ""), hist=None, pipelined: bool = False,
            perm=None) -> SolveResult:
    """Assemble the SolveResult and raise the classified errors, as
    ``acg_tpu.solvers.cg._finish`` does.  A multi-RHS solve (``x`` of
    shape (B, n); ``k``, ``flag`` and the norms per system) is summarized
    by its WORST system by relative residual, which supplies rnrm2,
    r0nrm2 and bnrm2 (one system's pair, never a cross-system mix); a
    fault in any system dominates, then a breakdown in any, then "all
    converged"; flops count each system's own iterations.  ``perm``
    (new_to_old) un-permutes the solution into the caller's ordering."""
    batched = x.dim() == 2
    x_host = x[..., : op.nrows].cpu().numpy()
    if perm is not None:
        xp, x_host = x_host, np.empty_like(x_host)
        x_host[..., perm] = xp
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

    ``A`` is a host CsrMatrix, DiaMatrix or EllMatrix, or an operator
    already built by :func:`build_device_operator` (then ``fmt`` only
    labels the path report); ``x`` comes back in ``A``'s ordering, RCM
    or not.  On the DIA and stencil tiers each iteration's t = A p and
    p'Ap are one kernel pass (``cuda-dia-fused``, ``cuda-stencil-fused``);
    on ELL and sgell the SpMV kernel and then the dot (``cuda-ell-spmv``,
    ``cuda-sgell-spmv``).  ``b`` of shape (B, n) solves B systems in one
    loop, each T = A P with its per-system p'Ap from one pass of the
    batched SpMV kernel (``cuda-stencil-batched`` / ``cuda-dia-batched``;
    ELL and sgell launch their kernel once per system); the result then
    carries per-system counts, residuals and histories.
    ``device`` defaults to ``cuda`` and raises when no card is present;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    Raises ``AcgError`` with the partial result attached as ``.result``
    on breakdown or non-convergence, as the JAX solver does."""
    o = options
    if o.segment_iters or o.monitor_every:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "segment_iters / monitor_every: not yet ported")
    op, b_pad, x0_pad, perm = _prepare(A, b, x0, dtype, fmt, mat_dtype,
                                       device)
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
                   path=_describe_path(op, fmt, batch=batch, perm=perm),
                   hist=hist, perm=perm)


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
    ``cuda-dia-pipe``) where the tier has one.  The ELL and sgell tiers
    have none: their iterations run the open-coded body (the SpMV kernel,
    torch updates and dots), with no note, as in the JAX package.

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
    op, b_pad, x0_pad, perm = _prepare(A, b, x0, dtype, fmt, mat_dtype,
                                       device)
    vdt = b_pad.dtype
    batch = b_pad.shape[0] if b_pad.dim() == 2 else 0
    stop2 = (torch.tensor(o.residual_atol ** 2, dtype=vdt, device=op.device),
             torch.tensor(o.residual_rtol ** 2, dtype=vdt, device=op.device))
    bnrm2 = dnrm2(b_pad).cpu().numpy()
    # exit certification only where an exit can be claimed
    certify = o.residual_atol > 0 or o.residual_rtol > 0
    iter_step = (_pipe_step(op) if hasattr(op, "pipelined_iter")
                 and o.replace_every == 0 and not batch else None)
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
                                       batch, perm=perm),
                   hist=hist, pipelined=True, perm=perm)
