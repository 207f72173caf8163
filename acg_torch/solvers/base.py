"""Solver result and statistics containers.

The port's copy of ``acg_tpu.solvers.base`` for one right-hand side
(reference acg/cg.h:60-98 ``struct acgsolver``): norms, the stopping
outcome, the op counters of the stats block, the flop model, and the one
place the operator-format / kernel names are minted.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from acg_torch.errors import Status


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
    # |r_k|^2 for k = 0..niterations (entry 0 = |r0|^2)
    residual_history: np.ndarray | None = None

    @property
    def relative_residual(self) -> float:
        return self.rnrm2 / self.r0nrm2 if self.r0nrm2 > 0 else 0.0


def path_names(fmt: str, device_type: str) -> tuple[str, str]:
    """The one place operator-format / kernel names are minted: the
    in-loop kernel is the hand-written fused SpMV + p'Ap kernel of the
    tier on a CUDA device, and the plain PyTorch version on the CPU."""
    if device_type != "cuda":
        return fmt, "torch-plain"
    return fmt, f"cuda-{fmt}-fused"


def cg_flops_per_iter(nnz: int, nrows: int) -> int:
    """Flop model per classic CG iteration (ref acg/cgcuda.c:885): SpMV
    2 flops/nnz, 2 dots and 3 axpys at 2 flops/row each."""
    return 2 * nnz + 2 * (2 * nrows) + 3 * (2 * nrows)
