"""The counted communication audit of one solver configuration.

The port's counterpart of ``acg_tpu/obs/hlo.py``'s :class:`CommAudit`.
The JAX package compiles a solve into one program and parses its HLO:
collectives inside the while body are per-iteration, the rest is the
prelude.  The port has no HLO.  It counts what its loop actually does,
with the counters the loop keeps (``acg_torch/solvers/graphs.py``
``COUNTERS``, which a replayed CUDA-graph block adds as a launched one):

- halo exchanges by transport: ppermute rounds (one a round with a
  partner, as XLA compiles one collective-permute a round), allgathers
  and rdma put+signal exchanges, with the bytes their messages carry at
  the wire's itemsize (``parallel/halo.py``, ``parallel/rdma_halo.py``);
- reduction points, the shard-ordered sums of the distributed loops
  (``solvers/cg_dist.py`` ``_reduce``: one a point however many scalars
  it adds, as the JAX package's one psum of a stacked payload), with the
  bytes of one shard's partials;
- kernel launches by wrapper (on the CPU the wrappers run their plain
  versions and launch nothing);
- host reads: the loop's blocks (``SolveStats.nreplays + nloopopen``),
  each of which ends in the loop's one read of the device.

:func:`audit_solver` runs the configured solver twice on the real
operator, for k1 and k2 fixed iterations (every tolerance that is on made
too small to end the run), and reads the counters around each run.  The
per-iteration figure is the difference over k2 - k1, so the prelude
(initial residual, norms, the s-step seed shifts) cancels; the totals are
the longer run's.  An s-step body advances s iterations: ``per_iteration``
counts a BODY and ``per_solver_iteration`` divides by s, the JAX
package's ``iterations_per_body`` accounting.
"""

from __future__ import annotations

import dataclasses
import importlib
from fractions import Fraction

import numpy as np

from acg_torch.config import SolverOptions

# the kernel wrapper each launch counter belongs to (solvers/graphs.py)
WRAPPERS = {
    ("acg_torch.ops.dia_kernels", "launches"): "dia_spmv",
    ("acg_torch.ops.dia_kernels", "pipe_launches"): "cg_pipelined_iter",
    ("acg_torch.ops.dia_kernels", "batched_launches"): "dia_spmv_batched",
    ("acg_torch.ops.dia_kernels", "ring_launches"): "dia_spmv_ring",
    ("acg_torch.ops.dia_kernels", "windows_launches"): "dia_spmv_windows",
    ("acg_torch.ops.stencil", "launches"): "stencil_spmv",
    ("acg_torch.ops.stencil", "pipe_launches"): "cg_pipelined_iter_stencil",
    ("acg_torch.ops.stencil", "batched_launches"): "stencil_spmv_batched",
    ("acg_torch.ops.spmv", "launches"): "ell_spmv",
    ("acg_torch.ops.sgell", "launches"): "sgell_spmv",
    ("acg_torch.parallel.rdma_halo", "launches"): "rdma_exchange",
    ("acg_torch.ops.cg_update", "launches"): "cg_update",
    ("acg_torch.ops.sstep_coeffs", "launches"): "sstep_coeffs",
    ("acg_torch.ops.deep_coeffs", "launches"): "deep_coeffs",
}

# (count counter, bytes counter) of each communication class
_COMM = {
    "ppermute": (("acg_torch.parallel.halo", "ppermute_rounds"),
                 ("acg_torch.parallel.halo", "ppermute_bytes")),
    "allgather": (("acg_torch.parallel.halo", "allgathers"),
                  ("acg_torch.parallel.halo", "allgather_bytes")),
    "rdma": (("acg_torch.parallel.rdma_halo", "exchanges"),
             ("acg_torch.parallel.rdma_halo", "exchange_bytes")),
    "allreduce": (("acg_torch.solvers.cg_dist", "reductions"),
                  ("acg_torch.solvers.cg_dist", "reduction_bytes")),
}

# the classes of the JAX package's CommAudit the port has, then its rdma
CLASSES = ("ppermute", "allreduce", "allgather", "rdma")

_SOLVERS = ("cg", "cg-pipelined", "cg-sstep", "cg-pipelined-deep")


def read_counters() -> dict:
    """Every counter the loop keeps, by (module, attribute)."""
    from acg_torch.solvers import graphs

    return {(m, a): getattr(importlib.import_module(m), a)
            for m, a in graphs.COUNTERS}


def _num(q: Fraction):
    """An exact count as an int, else a float."""
    return int(q) if q.denominator == 1 else float(q)


@dataclasses.dataclass
class CommAudit:
    """Counted audit of one solver configuration.  ``per_iteration``
    maps each class of :data:`CLASSES` to ``(count, bytes)`` a loop body
    (exact fractions), ``total`` to the longer run's ints; ``launches``
    and ``launches_total`` map wrapper names the same way; ``host_reads``
    is a body's blocks, ``host_reads_total`` the longer run's.
    ``iters_per_body`` is s for the s-step loop, else 1; ``k`` the two
    fixed iteration counts the figures came from."""

    per_iteration: dict
    total: dict
    launches: dict
    launches_total: dict
    host_reads: Fraction
    host_reads_total: int
    iters_per_body: int = 1
    k: tuple = (0, 0)

    def count(self, cls: str) -> Fraction:
        """A body's count of one class."""
        return self.per_iteration[cls][0]

    def as_dict(self) -> dict:
        """The JAX package's ``CommAudit.as_dict`` keys (schema
        ``acg-tpu-stats/5``: per body, per solver iteration as exact
        rationals, totals; the backend cost fields null, the compiled
        program's fusion, loop and instruction counts 0: the port
        compiles none) and the port's own: launches by wrapper, host
        reads, the two fixed iteration counts."""
        ipb = int(self.iters_per_body)
        per, psi = {}, {}
        for cls in CLASSES:
            c, b = self.per_iteration[cls]
            per[cls] = {"count": _num(c), "bytes": _num(b)}
            q = c / ipb
            psi[cls] = {"count": float(q),
                        "count_rational": f"{q.numerator}/{q.denominator}"
                        if ipb == 1 else f"{_num(c)}/{ipb}",
                        "bytes": float(b / ipb)}
        return {
            "per_iteration": per,
            "iterations_per_body": ipb,
            "per_solver_iteration": psi,
            "total": {cls: {"count": int(c), "bytes": int(b)}
                      for cls, (c, b) in self.total.items()},
            "nfusions": 0, "nwhiles": 0, "ninstructions": 0,
            "flops": None, "bytes_accessed": None, "peak_hbm_bytes": None,
            "argument_bytes": None, "output_bytes": None,
            "temp_bytes": None, "generated_code_bytes": None,
            "counted": True,
            "fixed_iterations": [int(v) for v in self.k],
            "launches": {"per_iteration": {k: _num(v) for k, v in
                                           self.launches.items()},
                         "total": dict(self.launches_total)},
            "host_reads": {"per_iteration": _num(self.host_reads),
                           "total": int(self.host_reads_total)},
        }


def _fixed(o: SolverOptions, k: int) -> SolverOptions:
    """``o`` run for exactly ``k`` iterations: every tolerance that is on
    stays on (the loop keeps its criteria's code path) but too small to
    end the run (1e-18, whose square an f32 threshold still holds)."""
    tiny = 1e-18
    return dataclasses.replace(
        o, maxits=int(k), warmup=0,
        residual_atol=tiny if o.residual_atol > 0 else 0.0,
        residual_rtol=tiny if o.residual_rtol > 0 else 0.0,
        diffatol=tiny if o.diffatol > 0 else 0.0,
        diffrtol=tiny if o.diffrtol > 0 else 0.0)


def _solve_fn(solver: str, dist: bool):
    mod = importlib.import_module("acg_torch.solvers."
                                  + ("cg_dist" if dist else "cg"))
    names = {"cg": "cg", "cg-pipelined": "cg_pipelined",
             "cg-sstep": "cg_sstep",
             "cg-pipelined-deep": "cg_pipelined_deep"}
    return getattr(mod, names[solver] + ("_dist" if dist else ""))


def default_iterations(solver: str, options: SolverOptions) -> tuple:
    """(k1, k2): two and four whole blocks, a block being s iterations
    for the s-step loop, ``check_every`` otherwise."""
    unit = (options.sstep if solver == "cg-sstep"
            else max(int(options.check_every), 1))
    return 2 * unit, 4 * unit


def audit_solver(op, b=None, *, solver: str = "cg", nrhs: int = 1,
                 options: SolverOptions = SolverOptions(),
                 k: tuple | None = None, x0=None) -> CommAudit:
    """The counted audit of ``solver`` ("cg", "cg-pipelined",
    "cg-sstep", "cg-pipelined-deep") on ``op``, a built single-device
    operator or :class:`~acg_torch.parallel.sharded.ShardedSystem`, with
    ``options`` run for ``k`` = (k1, k2) fixed iterations
    (:func:`default_iterations` when None).  ``b`` defaults to ones,
    ``nrhs`` copies when ``nrhs`` > 1."""
    from acg_torch.errors import AcgError, Status
    from acg_torch.parallel.sharded import ShardedSystem

    if solver not in _SOLVERS:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"audit: the loops audited are "
                       f"{'|'.join(_SOLVERS)}, not {solver!r}")
    dist = isinstance(op, ShardedSystem)
    if b is None:
        b = np.ones(op.nrows, dtype=np.dtype(op.vec_dtype))
        if nrhs > 1:
            b = np.tile(b[None, :], (nrhs, 1))
    k1, k2 = k if k is not None else default_iterations(solver, options)
    if not 0 <= k1 < k2:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"audit: want 0 <= k1 < k2, got {(k1, k2)}")
    fn = _solve_fn(solver, dist)
    runs = []
    for kk in (k1, k2):
        before = read_counters()
        kw = {} if dist else {"device": op.device}
        try:
            res = fn(op, b, x0=x0, options=_fixed(options, kk), **kw)
        except AcgError as e:
            # the fixed run ends unconverged by construction
            res = getattr(e, "result", None)
            if e.status != Status.ERR_NOT_CONVERGED or res is None:
                raise
        after = read_counters()
        if res.niterations != kk:
            raise AcgError(Status.ERR_NOT_CONVERGED,
                           f"audit: the {solver} solve stopped after "
                           f"{res.niterations} of {kk} fixed iterations "
                           f"({res.status.name})")
        d = {key: after[key] - before[key] for key in after}
        d["host_reads"] = res.stats.nreplays + res.stats.nloopopen
        runs.append(d)
    short, long_ = runs
    ipb = options.sstep if solver == "cg-sstep" else 1
    scale = Fraction(ipb, k2 - k1)

    def per(key):
        return (long_[key] - short[key]) * scale

    per_it, total = {}, {}
    for cls in CLASSES:
        ck, bk = _COMM[cls]
        per_it[cls] = (per(ck), per(bk))
        total[cls] = (long_[ck], long_[bk])
    launches = {name: per(key) for key, name in WRAPPERS.items()}
    return CommAudit(
        per_iteration=per_it, total=total, launches=launches,
        launches_total={name: int(long_[key])
                        for key, name in WRAPPERS.items()},
        host_reads=per("host_reads"),
        host_reads_total=int(long_["host_reads"]), iters_per_body=ipb,
        k=(k1, k2))


def _fmt_bytes(n) -> str:
    v = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return f"{int(v)} B" if unit == "B" else f"{v:.1f} {unit}"
        v /= 1024
    return f"{v:.1f} GiB"


def _q(v: Fraction) -> str:
    return str(v.numerator) if v.denominator == 1 else \
        f"{v.numerator}/{v.denominator}"


def format_comm_audit(a: CommAudit, title: str = "solve") -> str:
    """The ``--explain`` report of a counted audit."""
    ipb = a.iters_per_body
    lines = [f"CommAudit ({title}; counted over {a.k[0]} and {a.k[1]} "
             "fixed iterations):"]
    if ipb > 1:
        lines.append(f"  per-BLOCK counts (one body = {ipb} iterations; "
                     f"per-iteration = count/{ipb}):")
    else:
        lines.append("  per-iteration counts:")
    for cls in CLASSES:
        c, b = a.per_iteration[cls]
        tc, tb = a.total[cls]
        per = (f"  = {_q(c)}/{ipb} per iter" if ipb > 1 and c else "")
        lines.append(f"    {cls:<14} {_q(c):>5}x  {_fmt_bytes(b):>10}"
                     f"   (whole solve: {tc}x {_fmt_bytes(tb)})" + per)
    ran = {k: v for k, v in a.launches.items() if v}
    lines.append("  kernel launches: " + (", ".join(
        f"{k} {_q(v)}" for k, v in sorted(ran.items()))
        if ran else "none (the plain versions ran)"))
    lines.append(f"  host reads: {_q(a.host_reads)} "
                 f"(whole solve: {a.host_reads_total})")
    return "\n".join(lines)
