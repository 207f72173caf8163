"""Solver statistics reporting.

Renders the same stats block as ``acg_tpu.utils.stats`` (the reference's
``acgsolver_fwrite``, acg/cg.c:665-828): unknowns, solves, iterations,
Gflop, Gflop/s, the per-op table, the stopping criteria and the norms of
the last solve, then the operator format and kernel that ran.  Per-op
timing and the cross-process reduction are not ported yet, so the per-op
table prints zeros, as the JAX CLI does without ``--per-op-stats``.
"""

from __future__ import annotations

from acg_torch.config import SolverOptions
from acg_torch.solvers.base import OpCounters, SolveResult, SolveStats


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
