"""Solver result and statistics containers.

The port's copy of ``acg_tpu.solvers.base`` (reference acg/cg.h:60-98
``struct acgsolver``): norms, the stopping outcome, the per-system
results of a multi-RHS solve, the op counters of the stats block, the
flop model, the multi-RHS x0 shape contract, and the one place the
operator-format / kernel names are minted.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from acg_torch.errors import AcgError, Status


@dataclasses.dataclass
class OpCounters:
    """time/count/bytes/flops for one op class (ref acg/cg.h:88-97)."""

    t: float = 0.0
    n: int = 0
    bytes: int = 0
    flops: int = 0


@dataclasses.dataclass
class SolveStats:
    """Aggregate statistics for one or more solves."""

    nsolves: int = 0
    ntotaliterations: int = 0
    niterations: int = 0
    nflops: int = 0
    tsolve: float = 0.0
    gemv: OpCounters = dataclasses.field(default_factory=OpCounters)
    dot: OpCounters = dataclasses.field(default_factory=OpCounters)
    nrm2: OpCounters = dataclasses.field(default_factory=OpCounters)
    axpy: OpCounters = dataclasses.field(default_factory=OpCounters)
    copy: OpCounters = dataclasses.field(default_factory=OpCounters)
    allreduce: OpCounters = dataclasses.field(default_factory=OpCounters)
    halo: OpCounters = dataclasses.field(default_factory=OpCounters)
    nhalomsgs: int = 0
    # s-step blocks, the host seconds of each block's one status read
    # (the wait for the card to finish the block) and of the rest of the
    # block on the host: its replay or launches and the monitor (cg_sstep)
    nsstepblocks: int = 0
    tsstepwait: float = 0.0
    tsstephost: float = 0.0
    # the loop's blocks (solvers/graphs.py): CUDA graphs captured, their
    # replays, blocks run as Python (open, or a graph's warm-up block),
    # and the host seconds of the captures (inside tsolve)
    ncaptures: int = 0
    nreplays: int = 0
    nloopopen: int = 0
    tcapture: float = 0.0

    def iterations_per_sec(self) -> float:
        if self.tsolve <= 0:
            return float("nan")
        return self.niterations / self.tsolve


@dataclasses.dataclass
class SolveResult:
    """Outcome of a CG solve (norms as in ref acg/cg.h:80-86)."""

    x: np.ndarray
    converged: bool
    niterations: int
    bnrm2: float
    r0nrm2: float
    rnrm2: float
    x0nrm2: float = float("inf")
    dxnrm2: float = float("inf")
    stats: SolveStats | None = None
    # "none" or a description of non-finite values found (ref acg/cg.c:708)
    fpexcept: str = "none"
    status: Status = Status.SUCCESS
    # which operator format and kernel actually ran, e.g. ("stencil",
    # "cuda-stencil-fused") on the card or ("dia", "torch-plain") on the CPU
    operator_format: str = ""
    kernel: str = ""
    # why the tier is what it is when the caller constrained it, else ""
    kernel_note: str = ""
    # how the loop ran: "graph" (its blocks replayed as CUDA graphs),
    # "open" (every kernel launched from the host)
    loop: str = ""
    # |r_k|^2 for k = 0..niterations (entry 0 = |r0|^2); a multi-RHS solve
    # records a (nrhs, niterations+1) row per system, NaN past each
    # system's own exit
    residual_history: np.ndarray | None = None
    # multi-RHS (batched) solves, B systems against one operator
    # (acg_tpu/solvers/base.py:115-126): nrhs=1 keeps every field above as
    # for one system; nrhs>1 makes x (nrhs, n), rnrm2/r0nrm2/bnrm2 the
    # worst system's BY RELATIVE RESIDUAL (so relative_residual is one
    # system's ratio), niterations the largest per-system count, and
    # fills the per-system arrays below (length nrhs)
    nrhs: int = 1
    iterations_per_system: np.ndarray | None = None
    rnrm2_per_system: np.ndarray | None = None
    r0nrm2_per_system: np.ndarray | None = None
    converged_per_system: np.ndarray | None = None

    @property
    def relative_residual(self) -> float:
        return self.rnrm2 / self.r0nrm2 if self.r0nrm2 > 0 else 0.0


def path_names(fmt: str, device_type: str, body: str = "fused",
               rcm: bool = False) -> tuple[str, str]:
    """The one place operator-format / kernel names are minted: the
    in-loop kernel of the tier on a CUDA device, and the plain PyTorch
    versions on the CPU.  ``body`` names what runs the loop body on the
    card: "fused" the SpMV + p'Ap kernel of classic CG
    (``cuda-stencil-fused``), "pipe" the single-kernel pipelined
    iteration (``cuda-stencil-pipe``, ``acg_tpu``'s pallas-stpipe2d /
    pallas-pipe2d), "spmv" the plain SpMV kernel of an open-coded
    pipelined body (``cuda-stencil-spmv``; ``cuda-ell-spmv`` /
    ``cuda-sgell-spmv`` in every loop of the unstructured tiers, whose
    kernels fuse nothing), "batched" the multi-RHS SpMV of a (B, n)
    solve, with the per-system p'Ap fused in classic CG
    (``cuda-stencil-batched`` / ``cuda-dia-batched``), "hbm-ring" and
    "hbm" the DIA SpMV kernels for x past the card's L2, x staged through
    a shared-memory ring or clustered windows (``cuda-dia-hbm-ring``,
    ``cuda-dia-hbm``; ``acg_tpu``'s pallas-hbm-ring and pallas-hbm).
    ``rcm``: the operator acts in an RCM ordering (``rcm+dia``,
    ``rcm+sgell``)."""
    name = "rcm+" + fmt if rcm else fmt
    if device_type != "cuda":
        return name, "torch-plain"
    return name, f"cuda-{fmt}-{body}"


def kernel_disengagement_note(pipelined: bool, pipe_engaged: bool,
                              replace_every: int, forced_fmt: str = "auto",
                              stencil: bool = False, batch: int = 0,
                              has_pipe: bool = True) -> str:
    """The one place disengagement reasons are worded: why the in-loop
    kernel differs from the unconstrained auto choice, or "" (the port of
    ``acg_tpu.solvers.base.kernel_disengagement_note`` for the
    conditions the port has).  A pipelined solve on a tier with a
    single-kernel pipelined iteration (``has_pipe``: DIA and the stencil)
    takes it unless a (batch, n) multi-RHS solve (the kernel is not
    batched) or ``replace_every`` (it has no replacement path) disengages
    it; the ELL and sgell tiers have none and get no note, as in the JAX
    package."""
    notes = []
    if forced_fmt not in ("auto", "", None):
        notes.append(f"format forced: {forced_fmt}")
    if pipelined and has_pipe and not pipe_engaged:
        tier = "stencil" if stencil else "dia"
        why = (f"nrhs={batch} (the single-kernel iteration is not batched)"
               if batch else f"replace_every={replace_every}")
        notes.append(f"{tier} pipe disengaged: {why}")
    return "; ".join(notes)


def conform_x0_batch(x0, b_shape, tile):
    """The multi-RHS x0 shape contract (``acg_tpu.solvers.base``
    ``conform_x0_batch``): a 1-D x0 against a (B, n) b is shared by every
    system via ``tile``; any other mismatch raises ERR_INVALID_VALUE."""
    if len(b_shape) == 2 and x0.ndim == 1:
        return tile(x0)
    if tuple(x0.shape) != tuple(b_shape):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"initial guess shape {tuple(x0.shape)} does not "
                       f"match right-hand side shape {tuple(b_shape)} "
                       "(multi-RHS solves take x0 of shape (B, n), or "
                       "1-D to share one guess)")
    return x0


def cg_flops_per_iter(nnz: int, nrows: int, pipelined: bool = False,
                      sstep: int = 0) -> int:
    """Flop model per CG iteration (ref acg/cgcuda.c:885): SpMV 2
    flops/nnz and 2 dots at 2 flops/row each, plus 3 axpys at 2 flops/row
    (classic) or the fused 6-vector update at 12 flops/row (pipelined,
    ref acg/cgcuda.c:1783).  ``sstep`` = s prices an s-step block divided
    by s (``acg_tpu.solvers.base.cg_flops_per_iter``): 2s operator
    applications, the (m, n) x (n, m) Gram (m = 2s+1), 2s-1 shifted-basis
    axpys and the two m-coefficient combinations rebuilding x and p."""
    if sstep:
        s, m = sstep, 2 * sstep + 1
        block = (2 * s * 2 * nnz + m * m * 2 * nrows
                 + (2 * s - 1) * 2 * nrows + 2 * m * 2 * nrows)
        return block // s
    if not pipelined:
        return 2 * nnz + 2 * (2 * nrows) + 3 * (2 * nrows)
    return 2 * nnz + 2 * (2 * nrows) + 12 * nrows
