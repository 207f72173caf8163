"""Solver-as-a-service for one replica (the port of ``acg_tpu.serve``).

- :class:`~acg_torch.serve.session.Session` — prepares an operator ONCE
  and holds it on the device, with a cache of resident solves keyed by
  static signature (``acg_torch.solvers.cg.aot_step``: the loop's
  buffers and block runner, whose CUDA graphs outlive a solve), so a
  warm request copies its right-hand side in and replays;
- :class:`~acg_torch.serve.queue.CoalescingQueue` — coalesces concurrent
  right-hand sides into the batched (B, n) path, pads to bucket sizes
  and demuxes per-request results;
- :class:`~acg_torch.serve.service.SolverService` — the per-request
  supervisor: tickets, audit documents, trace IDs and the flight
  recorder (``acg_torch/obs/events.py``), the metrics registry
  (``acg_torch/obs/metrics.py``, default-off);
- :mod:`~acg_torch.serve.admission` — deadlines, bounded retry, the
  per-signature circuit breaker, load shedding, degradation onto
  classic CG (all default-off).

Not ported (ROADMAP Queue 1 item 6): the recycle state and warm start,
the replica fleet, the autoscaler, the observability plane, resilient
serving.
"""

from acg_torch.serve.admission import AdmissionPolicy
from acg_torch.serve.queue import CoalescingQueue, QueuePolicy
from acg_torch.serve.service import ServeResponse, SolverService
from acg_torch.serve.session import Session

__all__ = ["AdmissionPolicy", "CoalescingQueue", "QueuePolicy",
           "ServeResponse", "Session", "SolverService"]
