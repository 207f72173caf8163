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

import dataclasses
import time

import numpy as np
import torch

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.obs.metrics import observe_solve_result
from acg_torch.obs.monitor import LoopMonitor
from acg_torch.ops.blas1 import (batched_dot, block_dot, combine, ddot,
                                 dnrm2, gram)
from acg_torch.ops.cg_update import cg_update
from acg_torch.ops.dia import DeviceDia, DiaMatrix, dia_efficiency
from acg_torch.ops.sgell import (DeviceSgell, build_device_sgell,
                                 sgell_require_available)
from acg_torch.ops.spmv import DeviceEll, pad_vector
from acg_torch.ops.stencil import DeviceStencil, try_device_stencil
from acg_torch.solvers.base import (SolveResult, SolveStats,
                                    cg_flops_per_iter, conform_x0_batch,
                                    kernel_disengagement_note, path_names)
from acg_torch.solvers.loops import (_BREAKDOWN, _CONVERGED, _FAULT,
                                     _GRAM_BAD, _OK, _keep,
                                     cg_loop, cg_pipelined_deep_while,
                                     cg_pipelined_loop, cg_sstep_while,
                                     deep_buffers)
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
                   perm=None, open_coded: bool = False) -> tuple[str, str,
                                                                str]:
    """(operator_format, kernel, note) actually in effect.  ``perm`` is
    not None for an operator in an RCM ordering.  ``batch`` > 0 is a
    (batch, n) multi-RHS solve, whose loop runs the batched SpMV kernel
    (the ELL and sgell tiers: their one-system kernel once per system).
    A pipelined solve runs the single-kernel iteration where the tier has
    one, unless a batch or ``replace_every`` disengages it; the ELL and
    sgell loops run their SpMV kernel in every body.  On the DIA tier
    a loop whose SpMV is a one-vector kernel names the kernel of the
    operator's plan: ``cuda-dia-hbm-ring`` / ``cuda-dia-hbm`` for x past
    the card's L2.  ``open_coded``: a loop of its own around the plain
    SpMV kernel (the s-step and deep-pipelined solvers), whose only note
    is a forced format."""
    tier = ("sgell" if isinstance(op, DeviceSgell)
            else "ell" if isinstance(op, DeviceEll)
            else "stencil" if isinstance(op, DeviceStencil) else "dia")
    has_pipe = hasattr(op, "pipelined_iter")
    engaged = has_pipe and replace_every == 0 and not batch
    body = ("spmv" if not has_pipe else "batched" if batch
            else "spmv" if open_coded
            else "fused" if not pipelined else "pipe" if engaged
            else "spmv")
    if tier == "dia" and body in ("fused", "spmv") and op.kind != "resident":
        # the SpMV of the loop body runs the kernel of the operator's plan
        body = op.kind
    note = kernel_disengagement_note(pipelined and not open_coded, engaged,
                                     replace_every,
                                     forced_fmt=fmt,
                                     stencil=tier == "stencil", batch=batch,
                                     has_pipe=has_pipe)
    return path_names(tier, op.device.type, body,
                      rcm=perm is not None) + (note,)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_loop(loop, devices) -> bool:
    """Whether a solver's loop runs its blocks as CUDA graphs
    (``solvers/graphs.py``): ``loop`` "graph" or "open", None for the
    default, the graph loop when every vector lies on one CUDA device.
    Shards on several cards keep the open loop (a capture is one
    device's); "graph" there, or off CUDA, raises."""
    devs = {torch.device(d) for d in devices}
    can = len(devs) == 1 and next(iter(devs)).type == "cuda"
    if loop is None:
        return can
    if loop not in ("graph", "open"):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"loop must be 'graph' or 'open', not {loop!r}")
    if loop == "graph" and not can:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "the graph loop captures one CUDA device's work; "
                       f"these vectors lie on {sorted(map(str, devs))}")
    return loop == "graph"


def open_loop_note(why: str, device_type: str) -> str:
    """The path report's word for a loop on the card that launches every
    kernel from the host: ``open loop (<why>)``; nothing off the card."""
    return f"open loop ({why})" if device_type == "cuda" else ""


def _join_note(*notes) -> str:
    return "; ".join(n for n in notes if n)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _host_x(op, x, perm) -> np.ndarray:
    """The solution on the host in the caller's ordering (``perm``
    new_to_old un-permutes it), padding dropped: a copy, never a view of
    the loop's buffer (a resident solve rewrites it)."""
    x_host = x[..., : op.nrows].to("cpu", copy=True).numpy()
    if perm is not None:
        xp, x_host = x_host, np.empty_like(x_host)
        x_host[..., perm] = xp
    return x_host


def _finish(op, x, k, rr, flag, rr0, options: SolverOptions,
            tsolve: float, bnrm2, dxx=None, stats=None,
            path=("", "", ""), hist=None, pipelined: bool = False,
            perm=None, sstep: int = 0,
            solver: str | None = None, loop: str = "") -> SolveResult:
    """Assemble the SolveResult and raise the classified errors, as
    ``acg_tpu.solvers.cg._finish`` does.  A multi-RHS solve (``x`` of
    shape (B, n); ``k``, ``flag`` and the norms per system) is summarized
    by its WORST system by relative residual, which supplies rnrm2,
    r0nrm2 and bnrm2 (one system's pair, never a cross-system mix); a
    fault in any system dominates, then a breakdown in any, then "all
    converged"; flops count each system's own iterations.  ``perm``
    (new_to_old) un-permutes the solution into the caller's ordering.
    ``sstep`` prices the iterations with the s-step block model;
    ``solver`` names the solver in the non-convergence message; ``loop``
    says how the loop ran ("graph" or "open").  ``k``,
    ``flag`` and the norms may be tensors or host arrays."""
    batched = x.dim() == 2
    x_host = _host_x(op, x, perm)
    bnrm2 = np.asarray(bnrm2, dtype=np.float64)
    if batched:
        ksys = _host(k).astype(np.int64)
        flags = _host(flag).astype(np.int64)
        rnrm2s = np.sqrt(_host(rr).astype(np.float64))
        r0nrm2s = np.sqrt(_host(rr0).astype(np.float64))
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
                                                  pipelined, sstep)
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
        loop=loop,
        residual_history=(_host(hist)[..., : k + 1].astype(np.float64)
                          if hist is not None else None))
    if batched:
        res.nrhs = len(ksys)
        res.iterations_per_system = ksys
        res.rnrm2_per_system = rnrm2s
        res.r0nrm2_per_system = r0nrm2s
        res.converged_per_system = flags == _CONVERGED
    def _observed(r):
        # runtime telemetry (acg_torch/obs/metrics.py; a no-op unless
        # enable_metrics()): every terminal path below, raised or
        # returned, records once with the final status, on the host
        observe_solve_result(r, solver=(solver if solver
                                        else "cg-sstep" if sstep
                                        else "cg-pipelined" if pipelined
                                        else "cg"))
        return r

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
        err.result = _observed(res)
        raise err
    if flag == _BREAKDOWN:
        res.status = Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX
        err = AcgError(Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX)
        err.result = _observed(res)
        raise err
    no_criteria = (o.diffatol == 0 and o.diffrtol == 0
                   and o.residual_atol == 0 and o.residual_rtol == 0)
    if flag != _CONVERGED and not no_criteria:
        res.status = Status.ERR_NOT_CONVERGED
        err = AcgError(Status.ERR_NOT_CONVERGED,
                       f"{solver or 'CG'} did not converge in {o.maxits} "
                       "iterations "
                       f"(|r|/|r0| = {res.relative_residual:.3e})")
        err.result = _observed(res)
        raise err
    if no_criteria:
        res.converged = True
        if batched:
            res.converged_per_system = np.ones(res.nrhs, dtype=bool)
    if res.fpexcept != "none":
        res.status = Status.ERR_NONFINITE
    return _observed(res)


def cg(A, b, x0=None, options: SolverOptions = SolverOptions(),
       dtype=None, fmt: str = "auto", mat_dtype="auto",
       stats: SolveStats | None = None, device=None,
       atol2_floor=None, loop: str | None = None) -> SolveResult:
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
    on breakdown or non-convergence, as the JAX solver does.
    ``atol2_floor`` (the s-step and deep fallbacks) is a squared absolute
    threshold, a scalar or per system (B,), folded into the atol term, so
    each system keeps its own original criterion.

    Each iteration's x and r updates and |r|² (and |p|² for the diff
    criteria) are one kernel pass (``acg_torch/ops/cg_update.py``).  On
    the card the loop's blocks run as CUDA graphs (``loop="graph"``, the
    default there; ``"open"`` launches every kernel from the host, with
    the same bits; ``SolveStats.tcapture`` holds the captures' host
    seconds, inside ``tsolve``).  ``options.segment_iters`` ends a block
    every that many iterations (the same bits); ``options.monitor_every``
    streams ``iteration k: rnrm2`` lines (``acg_torch/obs/monitor.py``)."""
    op, b_pad, x0_pad, perm = _prepare(A, b, x0, dtype, fmt, mat_dtype,
                                       device)
    graph = resolve_loop(loop, [op.device])
    return _classic_solve(_classic_loop(op, b_pad, options, graph), op,
                          x0_pad, options, stats, fmt, perm, graph,
                          atol2_floor)


def _classic_loop(op, b_pad, o: SolverOptions, graph: bool,
                  capture_first: bool = False):
    """The classic loop over ``op`` for right-hand sides shaped like
    ``b_pad`` (its buffer): the fused beta-first step and the one-pass
    update (``loops.cg_loop``)."""
    batch = b_pad.shape[0] if b_pad.dim() == 2 else 0
    track_diff = o.diffatol > 0 or o.diffrtol > 0

    def coupled(r, p, beta):
        # p = r + beta p, in place (beta per system in a batch)
        torch.addcmul(r, p, beta[:, None] if batch else beta, out=p)
        t, ptap = op.matvec_dot(p)
        return p, t, ptap

    def update(x, r, p, t, alpha):
        return cg_update(x, r, p, t, alpha, track_diff)

    return cg_loop(op.matvec, ddot, b_pad, o.maxits, track_diff,
                   check_every=o.check_every, coupled_step=coupled,
                   guard=o.guard_nonfinite, update=update,
                   segment=o.segment_iters, monitor_every=o.monitor_every,
                   graph=graph, capture_first=capture_first)


def _classic_solve(L, op, x0_pad, o: SolverOptions, stats, fmt: str, perm,
                   graph: bool, atol2_floor=None) -> SolveResult:
    """One classic solve on the loop ``L`` (:func:`_classic_loop`) from
    the right-hand side in ``L.b``: the tolerances and the diff threshold
    of this solve, the loop, the result."""
    b_pad = L.b
    vdt = b_pad.dtype
    batch = b_pad.shape[0] if b_pad.dim() == 2 else 0

    def scalar(v):
        return torch.tensor(v, dtype=vdt, device=op.device)

    atol2 = (o.residual_atol ** 2 if atol2_floor is None
             else np.maximum(o.residual_atol ** 2, atol2_floor))
    stop2 = (scalar(atol2), scalar(o.residual_rtol ** 2))
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
    st = stats if stats is not None else SolveStats()
    _sync(op.device)
    t0 = time.perf_counter()
    x, k, rr, dxx, flag, rr0, hist = L.run(x0_pad, stop2, diffstop, st)
    _sync(op.device)
    tsolve = time.perf_counter() - t0
    return _finish(op, x, k, rr, flag, rr0, o, tsolve, bnrm2,
                   dxx=dxx if track_diff else None, stats=st,
                   path=_describe_path(op, fmt, batch=batch, perm=perm),
                   hist=hist, perm=perm, loop="graph" if graph else "open")


def _dot2(a1, b1, a2, b2):
    """The pipelined loop's one reduction point: both scalars of a single
    conceptual reduction (the reference's one 2-double allreduce,
    acg/cgcuda.c:1697), per system for (B, n) operands."""
    return batched_dot(a1, b1), batched_dot(a2, b2)


def _pipe_step(op):
    """The loop's ``iter_step`` over the operator's single-kernel
    pipelined iteration.  The kernel writes w' beside w, into the buffer
    the loop hands it (the loop alternates two; None: a new one)."""
    def step(z, r, p, w, s, x, alpha, beta, w_out=None):
        return op.pipelined_iter(w, z, r, p, s, x, alpha, beta, w_out=w_out)

    return step


def cg_pipelined(A, b, x0=None, options: SolverOptions = SolverOptions(),
                 dtype=None, fmt: str = "auto", mat_dtype="auto",
                 stats: SolveStats | None = None,
                 device=None, loop: str | None = None) -> SolveResult:
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
    single-kernel iteration is not batched, as in the JAX package).
    ``loop``, ``segment_iters`` and ``monitor_every`` as :func:`cg`."""
    _refuse_diff(options)
    op, b_pad, x0_pad, perm = _prepare(A, b, x0, dtype, fmt, mat_dtype,
                                       device)
    graph = resolve_loop(loop, [op.device])
    return _pipelined_solve(_pipelined_loop(op, b_pad, options, graph), op,
                            x0_pad, options, stats, fmt, perm, graph)


def _refuse_diff(o: SolverOptions) -> None:
    if o.diffatol > 0 or o.diffrtol > 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "pipelined CG supports residual-based stopping only")


def _certifies(o: SolverOptions) -> bool:
    """Exit certification runs only where an exit can be claimed."""
    return o.residual_atol > 0 or o.residual_rtol > 0


def _pipelined_loop(op, b_pad, o: SolverOptions, graph: bool,
                    capture_first: bool = False):
    """The pipelined loop over ``op`` for right-hand sides shaped like
    ``b_pad`` (its buffer), with the single-kernel iteration where the
    tier has one and neither a batch nor ``replace_every`` disengages it
    (``loops.cg_pipelined_loop``)."""
    batch = b_pad.dim() == 2
    iter_step = (_pipe_step(op) if hasattr(op, "pipelined_iter")
                 and o.replace_every == 0 and not batch else None)
    return cg_pipelined_loop(
        op.matvec, _dot2, b_pad, o.maxits, check_every=o.check_every,
        replace_every=o.replace_every, certify=_certifies(o),
        iter_step=iter_step, guard=o.guard_nonfinite,
        segment=o.segment_iters, monitor_every=o.monitor_every,
        graph=graph, any_crit=_any_crit(o, b_pad.dtype),
        capture_first=capture_first)


def _any_crit(o: SolverOptions, vdt) -> bool:
    """Whether the squared tolerances, in the vector dtype, enable a
    criterion (what the pipelined and deep loops decide statically)."""
    return any(float(torch.tensor(v ** 2, dtype=vdt)) > 0
               for v in (o.residual_atol, o.residual_rtol))


def _stop2(o: SolverOptions, vdt, device) -> tuple:
    return (torch.tensor(o.residual_atol ** 2, dtype=vdt, device=device),
            torch.tensor(o.residual_rtol ** 2, dtype=vdt, device=device))


def _pipelined_solve(L, op, x0_pad, o: SolverOptions, stats, fmt: str,
                     perm, graph: bool) -> SolveResult:
    """One pipelined solve on the loop ``L`` (:func:`_pipelined_loop`)
    from the right-hand side in ``L.b``."""
    b_pad = L.b
    batch = b_pad.shape[0] if b_pad.dim() == 2 else 0
    stop2 = _stop2(o, b_pad.dtype, op.device)
    bnrm2 = dnrm2(b_pad).cpu().numpy()
    st = stats if stats is not None else SolveStats()
    _sync(op.device)
    t0 = time.perf_counter()
    x, k, rr, flag, rr0, hist = L.run(x0_pad, stop2, st)
    _sync(op.device)
    tsolve = time.perf_counter() - t0
    return _finish(op, x, k, rr, flag, rr0, o, tsolve, bnrm2, stats=st,
                   path=_describe_path(op, fmt, True, o.replace_every,
                                       batch, perm=perm),
                   hist=hist, pipelined=True, perm=perm,
                   loop="graph" if graph else "open")


# ---------------------------------------------------------------------------
# s-step CG


def _cheb_leja_nodes(s: int) -> np.ndarray:
    """Leja-ordered Chebyshev nodes of (0, 1) (``acg_tpu.solvers.cg``
    ``_cheb_leja_nodes``): scaled by the estimated largest eigenvalue they
    seed the first s-step block's Newton shifts (and the deep pipeline's
    fill shifts); Leja order is scale-invariant, so the unit nodes are
    ordered once, here by products of distances."""
    j = np.arange(s)
    v = 0.5 * (1.0 + np.cos((2 * j + 1) * np.pi / (2 * s)))
    order = [int(np.argmax(np.abs(v)))]
    for _ in range(s - 1):
        prod = np.ones(s)
        for i in order:
            prod *= np.abs(v - v[i])
        prod[order] = -1.0
        order.append(int(np.argmax(prod)))
    return v[order]


def _sstep_block_fn(mv, b, s: int):
    """The s-step basis of :func:`cg_sstep_while`, built a block: residual
    replacement r = b - A x, the Newton-shifted P and R blocks through
    the operator's SpMV kernel (without the dot), and the Gram matrix in
    one product (:func:`gram`).  The (2s+1, [B,] n) basis is allocated
    once and rewritten every block; its padding rows stay 0, as every
    SpMV kernel returns them (the Gram reduces over them)."""
    batched = b.dim() == 2
    m = 2 * s + 1
    V = torch.empty((m,) + tuple(b.shape), dtype=b.dtype, device=b.device)

    def block_fn(x, p, shifts):
        # the loop's device shifts as they are (a host array is uploaded)
        th = torch.as_tensor(shifts, device=b.device)
        if batched:
            th = th[:, None, :]
        torch.sub(b, mv(x), out=V[s + 1])
        V[0].copy_(p)
        for j in range(s):
            torch.addcmul(mv(V[j]), th[..., j], V[j], value=-1,
                          out=V[j + 1])
        for j in range(s - 1):
            torch.addcmul(mv(V[s + 1 + j]), th[..., j], V[s + 1 + j],
                          value=-1, out=V[s + 2 + j])
        return V, gram(V)

    return block_fn


def _power_lmax(mv, dot, b, iters: int = 6):
    """A crude largest-eigenvalue estimate by power iteration from b (six
    operator applications before the loop; ``acg_tpu.solvers.cg``
    ``_power_lmax``): it scales the Chebyshev shift seeds, and the Ritz
    refinement replaces them after the first block."""
    bc = (lambda v: v[:, None]) if b.dim() == 2 else (lambda v: v)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    v = b
    lam = None                  # iters >= 1 sets it
    for _ in range(iters):
        nv = torch.sqrt(dot(v, v))
        v = v / bc(torch.where(nv == 0, one, nv))
        v = mv(v)
        lam = torch.sqrt(dot(v, v))
    return lam


def _seed_shifts(op, b, n: int, shifts0):
    """The first block's shifts, ([B,] n): ``shifts0`` as given (a shared
    (n,) seed tiled over a batch), else the Leja-ordered Chebyshev nodes
    scaled by the power-iteration estimate."""
    vdt = np.dtype(op.vec_dtype)
    if shifts0 is None:
        lam = _host(_power_lmax(op.matvec, batched_dot, b))
        shifts0 = lam[..., None] * _cheb_leja_nodes(n).astype(vdt)
    shifts0 = np.asarray(shifts0, dtype=vdt)
    if b.dim() == 2 and shifts0.ndim == 1:
        shifts0 = np.tile(shifts0, (b.shape[0], 1))
    return shifts0


def _cg_sstep_device(op, b, x0, stop2, s: int, maxits: int, shifts0=None,
                     stats=None, monitor_every: int = 0, graph: bool = False):
    """s-step CG on the device operator (``acg_tpu.solvers.cg``
    ``_cg_sstep_device``): the entry residual, the shift seeds, the loop
    (its blocks as CUDA graphs with ``graph``), and the certification of
    every exit by a fresh |b - A x|².  Host arrays of leading axis B (1
    for one system) come back beside x: ``(x, kiter, rr_true, flag, rr0,
    hist)``; ``stats`` gets the loop's block times."""
    r0 = b - op.matvec(x0)
    rr0 = np.atleast_1d(_host(batched_dot(r0, r0)))
    shifts0 = _seed_shifts(op, b, s, shifts0).reshape(rr0.shape[0], s)
    x, kiter, _rr, flag, hist, _shifts = cg_sstep_while(
        _sstep_block_fn(op.matvec, b, s), combine, b, x0, r0, rr0, shifts0,
        stop2, s, maxits, stats=stats, monitor_every=monitor_every,
        graph=graph)
    rT = b - op.matvec(x)
    rrT = np.atleast_1d(_host(batched_dot(rT, rT)))
    flag, hist = _sstep_certify(rrT, kiter, flag, hist, stop2, rr0)
    return x, kiter, rrT, flag, rr0, hist


def _sstep_certify(rrT, kiter, flag, hist, stop2, rr0):
    """The s-step exit certification (host arrays of leading axis B): the
    freshly reduced true |r|² decides convergence in both directions (a
    block-boundary _CONVERGED it refutes is demoted), and each system's
    last history sample becomes that certified value."""
    atol2, rtol2 = stop2
    thresh2 = np.maximum(atol2, rtol2 * rr0)
    any_crit = bool(atol2 > 0 or rtol2 > 0)
    met = (rrT < thresh2) | (any_crit & (rrT == 0))
    flag = np.where(met, _CONVERGED,
                    np.where(flag == _CONVERGED, _OK, flag))
    hist[np.arange(rrT.shape[0]), kiter] = rrT
    return flag, hist


def _refuse_unsupported(o: SolverOptions, name: str) -> None:
    """What the s-step and deep wrappers refuse, as the JAX package
    does: the diff criteria and ``segment_iters`` (their own dispatches
    already bound a program: a block, a pipeline segment)."""
    if o.diffatol > 0 or o.diffrtol > 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"{name} CG supports residual-based stopping only")
    if o.segment_iters > 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "segment_iters is supported by the classic and "
                       f"pipelined solvers, not by {name} CG")


def _sstep_validate(o: SolverOptions) -> int:
    """The rejections of the s-step wrapper; returns the block size."""
    if o.sstep < 2:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "cg_sstep requires SolverOptions.sstep >= 2 "
                       "(the s-step block size; --sstep on the CLI)")
    _refuse_unsupported(o, "s-step")
    return o.sstep


def _sstep_fallback_stop(o: SolverOptions, rr0) -> np.ndarray:
    """The classic fallback's ``atol2_floor``: each system's ORIGINAL
    squared threshold max(atol², rtol²·|r0|²).  The fallback's rtol is
    relative to its own start, which :func:`_sstep_fallback_x0` keeps no
    worse than |r0| but can make arbitrarily tighter; the floor restores
    every system's own criterion."""
    return np.maximum(o.residual_atol ** 2,
                      o.residual_rtol ** 2 * np.asarray(rr0, np.float64))


def _sstep_fallback_x0(x_part, x0, rrT, rr0):
    """The fallback's starting iterate: each system's s-step iterate only
    where its CERTIFIED true residual is finite and no worse than |r0|²,
    else the caller's x0 (zeros when None): a poisoned start drives the
    classic recurrence away from the truth."""
    rrT_h = np.atleast_1d(np.asarray(rrT, np.float64))
    rr0_h = np.atleast_1d(np.asarray(rr0, np.float64))
    keep = np.isfinite(rrT_h) & (rrT_h <= rr0_h)
    if np.all(keep):
        return x_part
    xp = np.asarray(x_part, dtype=np.float64)
    if xp.ndim == 2:
        x0o = (np.zeros_like(xp) if x0 is None
               else np.broadcast_to(np.asarray(x0, dtype=np.float64),
                                    xp.shape))
        return np.where(keep[:, None], xp, x0o)
    return np.zeros_like(xp) if x0 is None else np.asarray(x0, np.float64)


def _sstep_fallback(solve_classic, k_done, ksys, s: int, why: str,
                    spent_flops: int = 0, label: str | None = None):
    """Run the classic-CG fallback (never silently wrong) and fold the
    iterations already spent into its result: the note joins
    ``kernel_note``, per-system counts add the s-step counts (the batch
    summary is the max of the per-system totals), and the stats carry
    the spent work.  ``label`` names the solver in the note (the deep
    wrapper's fallback)."""
    note = (f"{label or f'cg-sstep(s={s})'} fell back to classic cg "
            f"after {k_done} iteration(s): {why}")

    def _fold(res):
        res.kernel_note = (res.kernel_note + "; " + note
                           if res.kernel_note else note)
        if ksys is not None and res.iterations_per_system is not None:
            res.iterations_per_system = (
                np.asarray(res.iterations_per_system) + ksys)
            folded = int(np.max(res.iterations_per_system))
        else:
            folded = res.niterations + int(k_done)
        delta = folded - res.niterations
        res.niterations = folded
        if res.stats is not None:
            res.stats.niterations += delta
            res.stats.ntotaliterations += delta
            res.stats.nflops += int(spent_flops)
        return res

    try:
        return _fold(solve_classic())
    except AcgError as e:
        if getattr(e, "result", None) is not None:
            _fold(e.result)
        raise


def cg_sstep(A, b, x0=None, options: SolverOptions = SolverOptions(),
             dtype=None, fmt: str = "auto", mat_dtype="auto",
             stats: SolveStats | None = None, device=None, shifts0=None,
             recycle=None, loop: str | None = None) -> SolveResult:
    """s-step (communication-reduced) CG on one device
    (``acg_tpu.solvers.cg.cg_sstep``): one Gram reduction per
    ``options.sstep`` iterations (the loop contract is
    :func:`acg_torch.solvers.loops.cg_sstep_while`).  Residual
    replacement every block and certification of every exit are built
    in; an indefinite or non-finite Gram falls back to classic CG from
    the last good iterate, said in ``kernel_note``.  Each block's 2s
    SpMVs run the operator's kernel without the dot (``cuda-*-spmv``,
    ``cuda-dia-hbm*`` past the L2, ``cuda-*-batched`` for a (B, n) b).
    A block is a fixed launch sequence: the basis, the Gram, one launch of
    the coefficient kernel (``acg_torch/ops/sstep_coeffs.py``) and the
    gated combinations; the host reads its status rows once a block.  On
    the card the block runs as a CUDA graph (``loop="graph"``, the
    default there; ``"open"`` launches every kernel from the host, with
    the same bits).

    ``shifts0`` ((s,) or (B, s)) overrides the power-iteration /
    Chebyshev Newton-shift seeds.  ``recycle`` (the serve stack's
    spectral recycling) is not yet ported.  Other arguments and errors as
    :func:`cg`; residual criteria only."""
    o = options
    s = _sstep_validate(o)
    if recycle is not None:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "recycle (a RecycleState): not yet ported")
    op, b_pad, x0_pad, perm = _prepare(A, b, x0, dtype, fmt, mat_dtype,
                                       device)
    graph = resolve_loop(loop, [op.device])
    batched = b_pad.dim() == 2
    vdt = np.dtype(op.vec_dtype)
    stop2 = (vdt.type(o.residual_atol ** 2), vdt.type(o.residual_rtol ** 2))
    bnrm2 = dnrm2(b_pad).cpu().numpy()
    st = stats if stats is not None else SolveStats()
    _sync(op.device)
    t0 = time.perf_counter()
    x, k, rr, flag, rr0, hist = _cg_sstep_device(
        op, b_pad, x0_pad, stop2, s, o.maxits, shifts0, stats=st,
        monitor_every=o.monitor_every, graph=graph)
    _sync(op.device)
    tsolve = time.perf_counter() - t0
    if not batched:
        k, rr, flag, rr0, hist = int(k[0]), rr[0], int(flag[0]), rr0[0], \
            hist[0]
    if np.any(np.atleast_1d(flag) == _GRAM_BAD):
        # classic CG re-solves from the last good iterate, and re-diagnoses:
        # a truly indefinite operator raises its breakdown there
        k_done = int(np.max(k))
        x_part = _sstep_fallback_x0(_host_x(op, x, perm), x0, rr, rr0)
        o2 = dataclasses.replace(o, sstep=0,
                                 maxits=max(o.maxits - k_done, 0))
        return _sstep_fallback(
            lambda: cg(A, b, x0=x_part, options=o2, dtype=dtype, fmt=fmt,
                       mat_dtype=mat_dtype, stats=st, device=device,
                       atol2_floor=_sstep_fallback_stop(o, rr0), loop=loop),
            k_done, k if batched else None, s,
            "indefinite/non-finite Gram matrix",
            spent_flops=k_done * cg_flops_per_iter(op.nnz, op.nrows,
                                                   sstep=s))
    name, kernel, note = _describe_path(op, fmt, batch=len(k) if batched
                                        else 0, perm=perm, open_coded=True)
    if not graph:
        note = _join_note(note, open_loop_note("asked", op.device.type))
    return _finish(op, x, k, rr, flag, rr0, o, tsolve, bnrm2, stats=st,
                   path=(name, kernel, note), hist=hist, perm=perm, sstep=s,
                   solver="cg-sstep", loop="graph" if graph else "open")


# ---------------------------------------------------------------------------
# depth-l pipelined CG

# consecutive dispatches ending in breakdown or certified-exit drift
# before the deep solver falls back to classic CG (each re-dispatch
# already is a residual replacement, so three failed restarts mean the
# basis itself is the problem)
_DEEP_MAX_BAD = 3


def _deep_validate(o: SolverOptions) -> int:
    """The rejections of the deep-pipelined wrapper; returns the depth
    (>= 2: depth 1 is dispatched to :func:`cg_pipelined` first)."""
    _refuse_unsupported(o, "deep-pipelined")
    return o.pipeline_depth


def _cg_pipelined_deep_device(op, b, x0, stop2, depth: int, maxits: int,
                              check_every: int, replace_every: int,
                              certify: bool, shifts, k_start: int = 0,
                              rr0_in=None, flags_in=None, hist_in=None,
                              ksys_in=None, guard: bool = False,
                              monitor=None, graph: bool = False,
                              buffers=None, stats=None):
    """One deep-pipelined dispatch (pipeline segment) on the device
    operator: the fill chain, the bodies and the true-residual
    certification (:func:`acg_torch.solvers.loops.cg_pipelined_deep_while`),
    the dot block as one matrix-vector product over the z ring;
    ``buffers`` (``loops.deep_buffers``) carry the solve's vectors and
    block runner across dispatches."""
    return cg_pipelined_deep_while(
        op.matvec, block_dot, combine, batched_dot, b, x0, stop2, depth,
        shifts, maxits, check_every=check_every,
        replace_every=replace_every, certify=certify, k_start=k_start,
        rr0_in=rr0_in, flags_in=flags_in, hist_in=hist_in, ksys_in=ksys_in,
        guard=guard, monitor=monitor, graph=graph, buffers=buffers,
        stats=stats)


def _deep_dispatches(segment, x0, batched: bool, maxits: int):
    """The host re-dispatch of deep-pipelined segments, shared by the
    one-device and distributed wrappers: ``segment(x, k_start, rr0_in,
    flags_in, hist_in, ksys_in)`` runs one dispatch
    (``cg_pipelined_deep_while``'s results), re-entered from its own
    results until no system is live or ``maxits`` is reached, a guard
    fault surfaces, or ``_DEEP_MAX_BAD`` consecutive dispatches end in a
    breakdown or a refuted exit.  Returns ``(x, kret, rr, flag, rr0,
    hist, k, ndisp, why)``: the last dispatch's state, the host update
    count, the dispatches run, and the reason to fall back to classic CG
    (None when the solve stands)."""
    x, k, rr0, flags, hist, ksys = x0, 0, None, None, None, None
    fails = ndisp = 0
    while True:
        (x, kret, rr, flag, rr0, hist, k, _more, drift) = segment(
            x, k, rr0, flags, hist, ksys)
        ndisp += 1
        if batched:
            ksys = kret
        flags_h = np.atleast_1d(_host(flag))
        if np.any(flags_h == _FAULT):
            break    # the finiteness guard fired: surface it, no restart
        brk = bool(np.any(flags_h == _BREAKDOWN))
        fails = fails + 1 if brk or bool(drift.any()) else 0
        if fails >= _DEEP_MAX_BAD:
            why = ("indefinite Gram/LDL pivot" if brk
                   else "certified-exit drift")
            return x, kret, rr, flag, rr0, hist, k, ndisp, why
        # restart: a breakdown gets another chance on a fresh basis (the
        # re-dispatch replaces its residual); drift is still _OK
        live = bool(np.any((flags_h == _OK) | (flags_h == _BREAKDOWN)))
        flags = torch.where(flag == _BREAKDOWN, _OK, flag).to(torch.int32)
        if not (live and k < maxits):
            break
    return x, kret, rr, flag, rr0, hist, k, ndisp, None


def cg_pipelined_deep(A, b, x0=None,
                      options: SolverOptions = SolverOptions(),
                      dtype=None, fmt: str = "auto", mat_dtype="auto",
                      stats: SolveStats | None = None, device=None,
                      shifts0=None, loop: str | None = None) -> SolveResult:
    """Depth-l pipelined CG on one device, l = ``options.pipeline_depth``
    reductions in flight (``acg_tpu.solvers.cg.cg_pipelined_deep``; the
    loop contract is
    :func:`acg_torch.solvers.loops.cg_pipelined_deep_while`).  Each body
    runs the operator's SpMV kernel once, without the dot.

    The host re-dispatches the pipeline segment until the solve finishes:
    every re-entry recomputes r = b - A x, every claimed exit is
    certified against a fresh true residual, and ``_DEEP_MAX_BAD``
    consecutive dispatches ending in breakdown or certified drift fall
    back to classic CG from the last safe iterate (said in
    ``kernel_note``).  A body's scalar chain is one kernel launch
    (``acg_torch/ops/deep_coeffs.py``); on the card the bodies between two
    host reads run as a CUDA graph, one set of captures for every
    dispatch (``loop="graph"``, the default there; ``"open"`` launches
    every kernel from the host, with the same bits).  The shift seeds
    (six SpMVs of power iteration, or ``shifts0`` ((l,) or (B, l))) are
    formed once and serve every dispatch.  ``pipeline_depth == 1`` is
    :func:`cg_pipelined`, unchanged.  Other arguments and errors as
    :func:`cg`; residual criteria only."""
    o = options
    if o.pipeline_depth == 1:
        return cg_pipelined(A, b, x0, options=o, dtype=dtype, fmt=fmt,
                            mat_dtype=mat_dtype, stats=stats, device=device,
                            loop=loop)
    l = _deep_validate(o)
    op, b_pad, x0_pad, perm = _prepare(A, b, x0, dtype, fmt, mat_dtype,
                                       device)
    graph = resolve_loop(loop, [op.device])
    st = stats if stats is not None else SolveStats()
    return _deep_solve(
        op, b_pad, x0_pad, o, deep_buffers(b_pad, l, o.maxits, graph),
        _deep_monitor(o, b_pad.dtype, op.device), shifts0, graph, st, fmt,
        perm, x0,
        lambda x_part, o2, floor: cg(
            A, b, x0=x_part, options=o2, dtype=dtype, fmt=fmt,
            mat_dtype=mat_dtype, stats=st, device=device, atol2_floor=floor,
            loop=loop))


def _deep_monitor(o: SolverOptions, vdt, device):
    return (LoopMonitor(o.monitor_every, o.maxits, vdt, device)
            if o.monitor_every > 0 else None)


def _deep_solve(op, b_pad, x0_pad, o: SolverOptions, bufs, mon, shifts0,
                graph: bool, st, fmt: str, perm, x0_caller,
                fallback) -> SolveResult:
    """One deep-pipelined solve on the buffers ``bufs``
    (``loops.deep_buffers``, their runner and rings; ``mon`` the solve's
    monitor or None): the shift seeds into ``bufs.shifts``, the host
    re-dispatches, the result.  ``fallback(x_part, options, atol2_floor)``
    runs the classic fallback; ``x0_caller`` is the caller's x0 (None:
    zeros), where a poisoned iterate restarts."""
    l = o.pipeline_depth
    batched = b_pad.dim() == 2
    stop2 = _stop2(o, b_pad.dtype, op.device)
    bnrm2 = dnrm2(b_pad).cpu().numpy()
    certify = _certifies(o)
    bufs.runner.stats = st
    if mon is not None:
        mon.reset()
    _sync(op.device)
    t0 = time.perf_counter()
    bufs.shifts.copy_(torch.from_numpy(_seed_shifts(op, b_pad, l, shifts0)))
    (x_op, kret, rr, flag, rr0_op, hist_op, k_op, ndisp,
     why) = _deep_dispatches(
        lambda x, *restart: _cg_pipelined_deep_device(
            op, b_pad, x, stop2, l, o.maxits, o.check_every,
            o.replace_every, certify, bufs.shifts, *restart,
            guard=o.guard_nonfinite, monitor=mon, graph=graph,
            buffers=bufs, stats=st), x0_pad, batched,
        o.maxits)
    if why is not None:
        # never silently wrong: classic CG re-solves from the last safe
        # iterate
        rr_h, rr0_h = _host(rr), _host(rr0_op)
        x_part = _sstep_fallback_x0(_host_x(op, x_op, perm), x0_caller,
                                    rr_h, rr0_h)
        o2 = dataclasses.replace(o, pipeline_depth=1,
                                 maxits=max(o.maxits - k_op, 0))
        return _sstep_fallback(
            lambda: fallback(x_part, o2, _sstep_fallback_stop(o, rr0_h)),
            k_op, _host(kret) if batched else None, l, why,
            spent_flops=k_op * cg_flops_per_iter(op.nnz, op.nrows,
                                                 pipelined=True),
            label=f"cg-pipelined-deep(l={l})")
    _sync(op.device)
    tsolve = time.perf_counter() - t0
    name, kernel, note = _describe_path(op, fmt, batch=b_pad.shape[0]
                                        if batched else 0, perm=perm,
                                        open_coded=True)
    note = _join_note(f"deep pipeline depth {l}, {ndisp} dispatch(es)",
                      note, "" if graph
                      else open_loop_note("asked", op.device.type))
    return _finish(op, x_op, kret, rr, flag if batched else int(flag), rr0_op,
                   o, tsolve, bnrm2, stats=st, path=(name, kernel, note),
                   hist=hist_op, pipelined=True, perm=perm,
                   solver="cg-pipelined-deep",
                   loop="graph" if graph else "open")


# ---------------------------------------------------------------------------
# resident solves (the serve layer's cache entries)


class AotSolve:
    """A resident solve: one prepared operator, one static signature
    (the solver kind, the padded shape of b with its batch, the vector
    dtype, the static :class:`SolverOptions` fields), and the loop's
    state made once for them (the port's counterpart of the JAX
    package's AOT executable, ``acg_tpu.solvers.cg.AotSolve``).

    :func:`aot_step` builds it; :meth:`solve` copies a new right-hand
    side (and x0) into the state's buffers, rebinds the tolerance VALUES
    on the device, and runs the same blocks the ordinary solver runs: on
    the card their CUDA graphs outlive a solve, so a dispatch that runs
    the blocks an earlier one ran captures nothing and runs no warm-up
    block (``SolveStats.ncaptures == nloopopen == 0``).  Its result is
    bit for bit the ordinary solver's on the same b.  ``path`` is the
    (operator_format, kernel, note) the ordinary solver reports;
    ``runners`` the block runners whose captures it keeps."""

    def __init__(self, dispatch, *, kind: str, shape: tuple, vec_dtype,
                 path: tuple, options: SolverOptions, runners: tuple):
        self._dispatch = dispatch
        self.kind = kind
        self.shape = tuple(shape)       # padded device operand shape
        self.vec_dtype = vec_dtype
        self.path = path
        self.options = options
        self.runners = runners

    def solve(self, b, x0=None, stats: SolveStats | None = None,
              options: SolverOptions | None = None) -> SolveResult:
        """Dispatch one request.  ``options`` may differ from the build's
        in the tolerance values only (:func:`check_aot_options`)."""
        if self._dispatch is None:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "this resident solve was closed")
        oo = (self.options if options is None
              else check_aot_options(self.options, options))
        return self._dispatch(b, x0, stats, oo)

    @property
    def ncaptures(self) -> int:
        """CUDA graphs captured over the solve's life."""
        return sum(r.ncaptures for r in self.runners)

    def close(self) -> None:
        """Drop the state: its buffers and its captures go with the last
        reference (idempotent)."""
        self._dispatch = None
        self.runners = ()


def check_aot_options(compiled_o: SolverOptions,
                      o: SolverOptions) -> SolverOptions:
    """Reject a per-dispatch options override whose STATIC fields differ
    from the resident solve's signature (``acg_tpu.solvers.cg``
    ``check_aot_options``): tolerance VALUES are the only legal per-call
    variation, and their non-zero-ness, which decides static branches
    (certification, the diff criteria), must match."""
    static = ("maxits", "check_every", "replace_every", "monitor_every",
              "guard_nonfinite", "segment_iters", "sstep",
              "pipeline_depth", "halo_wire")
    for f in static:
        if getattr(o, f) != getattr(compiled_o, f):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"AOT signature mismatch: options.{f}="
                           f"{getattr(o, f)} vs the executable's "
                           f"{getattr(compiled_o, f)} (static field)")
    for f in ("residual_atol", "residual_rtol", "diffatol", "diffrtol"):
        if (getattr(o, f) > 0) != (getattr(compiled_o, f) > 0):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"AOT signature mismatch: options.{f} "
                           "non-zero-ness differs from the executable's "
                           "(it gates a static branch; recompile)")
    return o


def _aot_kind(solver, pipelined: bool, o: SolverOptions) -> str:
    """The loop kind a resident solve runs, with the refusals both the
    one-device and the distributed :func:`aot_step` make."""
    if solver == "cg-pipelined-deep" and o.pipeline_depth <= 1:
        solver = "cg-pipelined"     # depth 1 IS the pipelined program
    if solver not in (None, "cg", "cg-pipelined", "cg-pipelined-deep"):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"aot_step builds the classic/pipelined/"
                       f"deep-pipelined loops (solver {solver!r})")
    kind = solver or ("cg-pipelined" if pipelined else "cg")
    if o.segment_iters > 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "segment_iters re-dispatches per segment; use the "
                       "ordinary solver functions")
    if kind == "cg-pipelined-deep":
        _deep_validate(o)
    if kind != "cg":
        _refuse_diff(o)
    return kind


def _aot_check(b_new, shape: tuple, vdt, o: SolverOptions, crit: bool,
               kind: str) -> None:
    """A dispatch's b against the signature; the pipelined and deep loops
    also fix whether a criterion is on in the vector dtype."""
    if tuple(b_new.shape) != shape or b_new.dtype != vdt:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"AOT signature mismatch: executable was built for "
                       f"shape {shape} dtype {vdt}, got "
                       f"{tuple(b_new.shape)} {b_new.dtype}")
    if kind != "cg" and _any_crit(o, vdt) != crit:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "AOT signature mismatch: the squared tolerances' "
                       "non-zero-ness in the vector dtype differs from the "
                       "executable's")


def aot_step(A, b, x0=None, options: SolverOptions = SolverOptions(),
             dtype=None, fmt: str = "auto", mat_dtype="auto",
             pipelined: bool = False, solver: str | None = None,
             device=None, loop: str | None = None) -> AotSolve:
    """Build the resident solve for single-device classic, pipelined or
    deep-pipelined CG at this static signature (``acg_tpu.solvers.cg``
    ``aot_step``): the operator (built once, or given built), the loop's
    state for b's shape (``b`` sets the shape; its values are not
    solved), on the card its block runner capturing each block at its
    first run.  Tolerance VALUES stay per dispatch.  ``solver`` is
    "cg", "cg-pipelined" or "cg-pipelined-deep" (depth 1: pipelined);
    ``segment_iters`` and every other kind raise ``ERR_NOT_SUPPORTED``:
    callers route those through the ordinary solver functions.  A deep
    solve that falls back to classic CG runs the ordinary :func:`cg`, as
    :func:`cg_pipelined_deep` does.  ``device`` and ``loop`` as
    :func:`cg`."""
    o = options
    kind = _aot_kind(solver, pipelined, o)
    op, b_pad, _x0, perm = _prepare(A, b, x0, dtype, fmt, mat_dtype, device)
    # requests re-enter through the ALREADY-BUILT operator
    A_res = PermutedOperator(op, perm) if perm is not None else op
    graph = resolve_loop(loop, [op.device])
    b_own = b_pad.clone()
    shape, vdt = tuple(b_own.shape), b_own.dtype
    batch = shape[0] if len(shape) == 2 else 0
    crit = _any_crit(o, vdt)
    if kind == "cg":
        L = _classic_loop(op, b_own, o, graph, capture_first=True)
        runners = (L.runner,)
        path = _describe_path(op, fmt, batch=batch, perm=perm)
    elif kind == "cg-pipelined":
        L = _pipelined_loop(op, b_own, o, graph, capture_first=True)
        runners = (L.runner,)
        path = _describe_path(op, fmt, True, o.replace_every, batch,
                              perm=perm)
    else:
        bufs = deep_buffers(b_own, o.pipeline_depth, o.maxits, graph,
                            capture_first=True)
        mon = _deep_monitor(o, vdt, op.device)
        runners = (bufs.runner,)
        path = _describe_path(op, fmt, batch=batch, perm=perm,
                              open_coded=True)

    def dispatch(b, x0, stats, oo):
        _, b_new, x0_new, _ = _prepare(A_res, b, x0, dtype, fmt, mat_dtype,
                                       device)
        _aot_check(b_new, shape, vdt, oo, crit, kind)
        _keep(b_own, b_new)
        if kind == "cg":
            return _classic_solve(L, op, x0_new, oo, stats, fmt, perm, graph)
        if kind == "cg-pipelined":
            return _pipelined_solve(L, op, x0_new, oo, stats, fmt, perm,
                                    graph)
        st = stats if stats is not None else SolveStats()
        return _deep_solve(
            op, b_own, x0_new, oo, bufs, mon, None, graph, st, fmt, perm, x0,
            lambda x_part, o2, floor: cg(
                A_res, b, x0=x_part, options=o2, dtype=dtype, fmt=fmt,
                mat_dtype=mat_dtype, stats=st, device=device,
                atol2_floor=floor, loop=loop))

    return AotSolve(dispatch, kind=kind, shape=shape, vec_dtype=vdt,
                    path=path, options=o, runners=runners)


# ---------------------------------------------------------------------------
# recycled (deflated) CG


def _deflate_x0(matvec, b, x0, W, WtAW):
    """Galerkin-project the retained basis out of the initial residual,
    x0' = x0 + W (W'AW)^{-1} W' r0 with r0 = b - A x0, on the host in
    float64 (``acg_tpu.solvers.cg._deflate_x0``; set-up work, the solve
    afterwards is :func:`cg`'s).  Returns the deflated x0, or the
    undeflated one when the projection cannot be applied soundly
    (singular W'AW, a non-finite correction).  ``matvec`` maps a host
    vector to A times it."""
    b64 = np.asarray(b, np.float64)
    if x0 is None:
        x064 = np.zeros_like(b64)
        r0 = b64
    else:
        x064 = np.asarray(x0, np.float64)
        ax0 = (np.stack([np.asarray(matvec(row), np.float64)
                         for row in x064])
               if b64.ndim == 2 else np.asarray(matvec(x064), np.float64))
        r0 = b64 - ax0
    W = np.asarray(W, np.float64)
    WtAW = np.asarray(WtAW, np.float64)
    try:
        if b64.ndim == 2:               # per-system correction, (B, k)
            coef = np.linalg.solve(WtAW, (r0 @ W).T).T
            x0d = x064 + coef @ W.T
        else:
            x0d = x064 + W @ np.linalg.solve(WtAW, W.T @ r0)
    except np.linalg.LinAlgError:
        return x064
    return x0d if np.all(np.isfinite(x0d)) else x064


def _host_matvec(A):
    """A's product on host vectors in the caller's ordering: a host
    matrix's own ``matvec``, or a device operator applied on its device;
    None for anything else."""
    if isinstance(A, PermutedOperator):
        inner, perm = _host_matvec(A.dev), A.perm

        def mv_perm(v):
            y = np.empty_like(np.asarray(v, np.float64))
            y[perm] = inner(np.asarray(v)[perm])
            return y
        return mv_perm
    if isinstance(A, (DeviceDia, DeviceStencil, DeviceEll, DeviceSgell)):
        vdt = getattr(torch, A.vec_dtype)

        def mv_dev(v):
            t = torch.zeros(A.nrows_padded, dtype=vdt, device=A.device)
            t[: A.nrows] = torch.from_numpy(np.asarray(v)).to(t)
            return A.matvec(t)[: A.nrows].cpu().numpy()
        return mv_dev
    return getattr(A, "matvec", None)


def cg_recycled(A, b, x0=None, options: SolverOptions = SolverOptions(),
                dtype=None, fmt: str = "auto", mat_dtype="auto",
                stats: SolveStats | None = None, device=None, W=None,
                WtAW=None, recycle=None, matvec=None) -> SolveResult:
    """Deflated CG (``acg_tpu.solvers.cg.cg_recycled``): project the k
    retained directions ``W`` (n, k), with ``WtAW`` = W'AW (k, k), out of
    the initial residual at set-up (:func:`_deflate_x0`, on the host),
    then run :func:`cg` unchanged: nothing is added to an iteration.
    Without a basis it IS :func:`cg`.  ``matvec`` (host vector -> A
    times it) overrides A's own for the deflation; ``recycle`` (the
    serve stack's retained basis) is not yet ported."""
    if recycle is not None:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "recycle (a RecycleState): not yet ported")
    mv = matvec if matvec is not None else _host_matvec(A)
    if W is not None and WtAW is not None and mv is not None:
        x0 = _deflate_x0(mv, b, x0, W, WtAW)
    return cg(A, b, x0, options, dtype, fmt, mat_dtype, stats=stats,
              device=device)
