"""Typed solver configuration.

The stopping criteria and loop knobs of ``acg_tpu.config.SolverOptions``
with the same fields, defaults and validation, so one options object
means the same solve in both packages.  PyTorch needs no 64-bit switch:
a float64 tensor is float64 on every device.
"""

from __future__ import annotations

import dataclasses
import enum


class HaloMethod(str, enum.Enum):
    """Halo-exchange transports of the distributed solver (the
    reference's comm backends, ref acg/comm.h:84-92)."""

    PPERMUTE = "ppermute"   # edge-coloured rounds of neighbour copies
    ALLGATHER = "allgather"  # every part's packed border values, once
    RDMA = "rdma"           # device-initiated put+signal kernel (the
    #                         NVSHMEM analog; CUDA devices only)


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Stopping criteria and measurement knobs (ref acg/cg.c:198-208,
    cuda/acg-cuda.c:507-511 defaults).  A tolerance of 0 disables that
    criterion.  Convergence iff any enabled criterion holds:

      ``|dx| < diffatol``, ``|dx| < diffrtol*|x0|``,
      ``|b-Ax| < residual_atol``, ``|b-Ax| < residual_rtol*|b-Ax0|``.

    Fields the port's loops do not run yet (``segment_iters``,
    ``monitor_every``) are kept and validated so options objects carry
    over unchanged; the solvers refuse them.  ``replace_every`` is run
    by the pipelined and deep-pipelined solvers (classic CG has no
    recurrence to replace); ``sstep`` by ``cg_sstep``; ``pipeline_depth``
    by ``cg_pipelined_deep``; ``halo_wire`` by the distributed solvers
    (``solvers/cg_dist.py``; one device has no halo).
    """

    maxits: int = 100
    diffatol: float = 0.0
    diffrtol: float = 0.0
    residual_atol: float = 0.0
    residual_rtol: float = 1e-9
    warmup: int = 0
    # the host reads the loop's flag every `check_every` iterations and
    # convergence is tested only there; breakdown is detected every
    # iteration (1 = exact parity with the reference)
    check_every: int = 1
    replace_every: int = 0
    segment_iters: int = 0
    monitor_every: int = 0
    sstep: int = 0
    pipeline_depth: int = 1
    halo_wire: str = "f32"
    # test |r|^2 and p'Ap for finiteness at the check points and end the
    # solve with ERR_FAULT_DETECTED instead of running to maxits on NaN
    guard_nonfinite: bool = False

    def __post_init__(self):
        if self.maxits < 0:
            raise ValueError("maxits must be >= 0")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.replace_every < 0:
            raise ValueError("replace_every must be >= 0")
        if self.segment_iters < 0:
            raise ValueError("segment_iters must be >= 0")
        if self.monitor_every < 0:
            raise ValueError("monitor_every must be >= 0")
        if self.sstep != 0 and not 2 <= self.sstep <= 16:
            raise ValueError("sstep must be 0 (not an s-step solve) or "
                             "in [2, 16]")
        if not 1 <= self.pipeline_depth <= 8:
            raise ValueError("pipeline_depth must be in [1, 8]")
        if self.halo_wire not in ("f32", "bf16", "int16-delta"):
            raise ValueError("halo_wire must be one of 'f32', 'bf16', "
                             "'int16-delta'")
