"""Solver statistics reporting.

Renders the same stats block as ``acg_tpu.utils.stats`` (the reference's
``acgsolver_fwrite``, acg/cg.c:665-828): unknowns, solves, iterations,
Gflop, Gflop/s, the per-op table, the stopping criteria and the norms of
the last solve, then the operator format and kernel that ran.  The
per-op table holds what ``--per-op-stats`` fills (``utils/profile.py``,
each op class timed alone by :func:`time_op`), zeros otherwise, as in
the JAX CLI.  The cross-process reduction is not ported (one process
drives every shard).
"""

from __future__ import annotations

import time

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.solvers.base import OpCounters, SolveResult, SolveStats


def _first_tensor(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, (list, tuple)):
        for v in obj:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def time_op(fn, *args, warmup: int = 3, reps: int = 10,
            device=None) -> float:
    """Median seconds of ``fn(*args)`` after ``warmup`` calls (the
    reference's per-op warm-up loops, acg/cgcuda.c:607-705).

    On a CUDA device (``device``, else the first tensor in ``args``):
    each call between two CUDA events, the median of their elapsed times.
    On the CPU, only when that is where the tensors lie or the caller
    names it: ``perf_counter`` around each call.  Neither falls back to
    the other; with no device to go by it raises ``ERR_INVALID_VALUE``."""
    import torch

    if device is None:
        t = _first_tensor(args)
        if t is None:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "time_op: no tensor among the arguments and no "
                           "device given: nothing says where to time")
        device = t.device
    device = torch.device(device)
    for _ in range(max(warmup, 0)):
        fn(*args)
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        with torch.cuda.device(device):
            for _ in range(max(reps, 1)):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(*args)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) * 1e-3)
    elif device.type == "cpu":
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    else:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"time_op: cannot time on {device}")
    times.sort()
    return times[len(times) // 2]


def _opline(name: str, c: OpCounters, per_proc: bool = False) -> str:
    suf = "/proc" if per_proc else ""
    gbps = 1.0e-9 * c.bytes / c.t if c.t > 0 else 0.0
    return (f"  {name}: {c.t:.6f} seconds{suf} {c.n} times{suf} "
            f"{c.bytes} B{suf} {gbps:.3f} GB/s{suf}")


def format_solver_stats(st: SolveStats, res: SolveResult | None = None,
                        options: SolverOptions | None = None,
                        nunknowns: int | None = None,
                        nprocs: int = 1, indent: int = 0) -> str:
    """Render the reference's stats block (ref acg/cg.c:673-709)."""
    lines = []
    if nunknowns is not None:
        lines.append(f"unknowns: {nunknowns}")
    lines.append(f"solves: {st.nsolves}")
    lines.append(f"total iterations: {st.ntotaliterations}")
    lines.append(f"total flops: {1.0e-9 * st.nflops:.3f} Gflop")
    rate = 1.0e-9 * st.nflops / st.tsolve if st.tsolve > 0 else 0.0
    lines.append(f"total flop rate: {rate:.3f} Gflop/s")
    lines.append(f"total solver time: {st.tsolve:.6f} seconds")
    lines.append("performance breakdown:")
    per_proc = nprocs > 1
    ops = (("gemv", st.gemv), ("dot", st.dot), ("nrm2", st.nrm2),
           ("axpy", st.axpy), ("copy", st.copy),
           ("Allreduce", st.allreduce), ("HaloExchange", st.halo))
    for name, c in ops:
        lines.append(_opline(name, c, per_proc))
    # clamped at 0: per-op times measured in isolation may sum past tsolve
    tother = max(0.0, st.tsolve - sum(c.t for _, c in ops))
    lines.append(f"  other: {tother:.6f} seconds")
    if res is not None and options is not None:
        o = options
        lines.append("last solve:")
        lines.append("  stopping criterion:")
        lines.append(f"    maximum iterations: {o.maxits}")
        lines.append(f"    tolerance for residual: {o.residual_atol:.17g}")
        lines.append(
            f"    tolerance for relative residual: {o.residual_rtol:.17g}")
        lines.append(
            "    tolerance for difference in solution iterates: "
            f"{o.diffatol:.17g}")
        lines.append(
            "    tolerance for relative difference in solution iterates: "
            f"{o.diffrtol:.17g}")
        lines.append(f"  iterations: {res.niterations}")
        if res.nrhs > 1:
            # a multi-RHS batch: the norms below are the worst system's
            lines.append(f"  right-hand sides (batched): {res.nrhs}")
            its = ", ".join(str(int(v)) for v in res.iterations_per_system)
            lines.append(f"  per-system iterations: [{its}]")
            rn = ", ".join(f"{float(v):.3e}" for v in res.rnrm2_per_system)
            lines.append(f"  per-system residual 2-norms: [{rn}]")
        lines.append(f"  right-hand side 2-norm: {res.bnrm2:.17g}")
        lines.append(f"  initial guess 2-norm: {res.x0nrm2:.17g}")
        lines.append(f"  initial residual 2-norm: {res.r0nrm2:.17g}")
        lines.append(f"  residual 2-norm: {res.rnrm2:.17g}")
        lines.append(
            f"  difference in solution iterates 2-norm: {res.dxnrm2:.17g}")
        lines.append(f"  floating-point exceptions: {res.fpexcept}")
        if res.operator_format:
            lines.append(f"  operator format: {res.operator_format}")
            note = res.kernel_note
            lines.append(f"  kernel: {res.kernel}"
                         + (f" ({note})" if note else ""))
    pad = " " * indent
    return "\n".join(pad + ln for ln in lines)
