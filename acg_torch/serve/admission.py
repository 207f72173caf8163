"""Admission robustness for the serve stack: deadlines, bounded retry,
a per-signature circuit breaker, load shedding, graceful degradation
(the port of ``acg_tpu.serve.admission``).

- **deadlines** — every request carries a total budget split into a
  queue budget and a solve budget.  A request whose queue deadline
  expires before dispatch is SHED from the queue with a classified
  ``ERR_TIMEOUT`` response and a complete audit document; a request
  whose total deadline expires mid-solve gets the same classification
  at the deadline (the device work cannot be preempted, but the
  CLIENT's contract — a classified terminal response within the
  deadline, never a hang — holds regardless, and the late result stays
  re-pollable);
- **bounded retry with backoff** — driven by the failure
  classification (:func:`classify_failure`): transient statuses
  (``ERR_NONFINITE``, ``ERR_FAULT_DETECTED`` — corrupted executions)
  retry up to ``max_retries`` times with seeded, jittered exponential
  backoff; deterministic statuses (breakdown, invalid value, honest
  non-convergence) fail fast — re-running the identical request buys
  nothing;
- **a per-signature circuit breaker** — ``breaker_threshold``
  consecutive failures on one ``(solver, bucket, dtype)`` signature
  trip the breaker OPEN: further requests on that solver either
  fast-fail with ``ERR_OVERLOADED`` or (for the pipelined families)
  DEGRADE onto classic CG.  After a cooldown the breaker HALF-OPENs and
  admits exactly one probe at the original solver; a successful probe
  CLOSEs it, a failed one re-opens it.  Every transition lands in an
  ordered audit trail;
- **load shedding** — a bounded queue depth rejects at admission
  (``ERR_OVERLOADED``) instead of backlogging, so queue wait stays
  bounded for the requests that ARE admitted.

Everything here is host-side bookkeeping around the unchanged dispatch:
with the features at their defaults (no deadline, no breaker, zero
retries, unbounded depth) the dispatched solves and the per-request
results are bit-identical to the plain serve layer.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from acg_torch.errors import AcgError, Status
from acg_torch.obs import metrics as _metrics

# breaker states, in increasing severity (the board's aggregate state
# for a solver is the most severe across its bucket signatures)
CLOSED, HALF_OPEN, OPEN = "CLOSED", "HALF_OPEN", "OPEN"
_SEVERITY = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

# runtime telemetry (acg_torch/obs/metrics.py; no-ops until
# enable_metrics()): every breaker transition by destination state —
# the counter twin of the ordered transition trail
_M_BREAKER = _metrics.counter(
    "acg_serve_breaker_transitions_total",
    "Circuit-breaker state transitions by destination state",
    ("to",))


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The serving safety-net knobs.  EVERY default is "off": a
    default-constructed policy admits everything, never retries, never
    trips, never sheds — the zero-overhead clause (the dispatched
    program and per-request results are then bit-identical to the plain
    serve layer)."""

    # total per-request deadline in ms (0 = no deadline).  Split:
    # queue_deadline_ms bounds time IN QUEUE before dispatch (0 =
    # inherit the total), the remainder is the solve budget.
    deadline_ms: float = 0.0
    queue_deadline_ms: float = 0.0
    # bounded retry: transient failures re-run ALONE up to max_retries
    # times, sleeping backoff_ms * 2^(attempt-1), jittered by a seeded
    # ±jitter fraction (seeded => a drill's exact sleep schedule is
    # reproducible from its seed)
    max_retries: int = 0
    backoff_ms: float = 25.0
    jitter: float = 0.5
    seed: int = 0
    # circuit breaker: threshold consecutive failures on one (solver,
    # bucket, dtype) signature trip it OPEN (0 = no breaker);
    # cooldown_ms later it half-opens for one probe.  "Failure" is ANY
    # unconverged dispatch — deliberately including deterministic
    # statuses the retry ladder refuses to retry (honest
    # ERR_NOT_CONVERGED included): the breaker quarantines a
    # persistently-failing SIGNATURE, whatever the root cause; the transition trail records the count and the per-request
    # audits name the statuses, so a trip from ill-conditioned traffic
    # is distinguishable from one caused by faults
    breaker_threshold: int = 0
    breaker_cooldown_ms: float = 1000.0
    # load shedding: reject at admission once the queue backlog reaches
    # max_queue_depth pending requests (0 = unbounded)
    max_queue_depth: int = 0
    # graceful degradation: while the breaker for a pipelined/s-step
    # solver is open, route its traffic onto classic CG instead of
    # fast-failing
    degrade: bool = True
    # rolling-window length for health()'s failure rate / percentiles
    window: int = 256

    def __post_init__(self):
        for f in ("deadline_ms", "queue_deadline_ms", "backoff_ms",
                  "breaker_cooldown_ms"):
            if getattr(self, f) < 0:
                raise AcgError(Status.ERR_INVALID_VALUE,
                               f"AdmissionPolicy.{f} must be >= 0")
        for f in ("max_retries", "breaker_threshold", "max_queue_depth"):
            if getattr(self, f) < 0:
                raise AcgError(Status.ERR_INVALID_VALUE,
                               f"AdmissionPolicy.{f} must be >= 0")
        if not 0 <= self.jitter <= 1:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "AdmissionPolicy.jitter must be in [0, 1]")
        if self.window < 1:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "AdmissionPolicy.window must be >= 1")

    @property
    def deadline_s(self) -> float | None:
        return self.deadline_ms / 1e3 if self.deadline_ms > 0 else None

    @property
    def queue_deadline_s(self) -> float | None:
        """The in-queue budget in seconds (None = no queue deadline):
        an explicit split, else the whole deadline."""
        if self.queue_deadline_ms > 0:
            return self.queue_deadline_ms / 1e3
        return self.deadline_s

    def backoff_s(self, attempt: int, rng) -> float:
        """Seeded jittered exponential backoff for retry ``attempt``
        (1-based): ``backoff_ms * 2^(attempt-1)``, jittered by a
        ±``jitter`` fraction drawn from ``rng``."""
        base = (self.backoff_ms / 1e3) * (2.0 ** (attempt - 1))
        if self.jitter > 0:
            base *= 1.0 + self.jitter * float(rng.uniform(-1.0, 1.0))
        return max(base, 0.0)

    def as_dict(self) -> dict:
        return {"deadline_ms": float(self.deadline_ms),
                "queue_deadline_ms": float(self.queue_deadline_ms),
                "max_retries": int(self.max_retries),
                "backoff_ms": float(self.backoff_ms),
                "breaker_threshold": int(self.breaker_threshold),
                "breaker_cooldown_ms": float(self.breaker_cooldown_ms),
                "max_queue_depth": int(self.max_queue_depth),
                "degrade": bool(self.degrade)}


# the failure classification the retry ladder keys on (the JAX
# package's acg_tpu/robust/supervisor.py:83-93, copied)
TRANSIENT_STATUSES = (Status.ERR_FAULT_DETECTED, Status.ERR_NONFINITE)


def classify_failure(status: Status) -> str:
    """``"transient"`` (a clean retry may clear it) or
    ``"deterministic"`` (same request => same outcome; fail fast)."""
    return ("transient" if Status(status) in TRANSIENT_STATUSES
            else "deterministic")


def breaker_signature(solver: str, bucket: int, dtype) -> str:
    """The breaker key: one dispatched program class.  ``bucket`` is the
    PADDED batch size actually dispatched (the executable-cache
    signature's B), so the breaker isolates exactly one cached
    executable's traffic."""
    return f"{solver}/b{int(bucket)}/{np.dtype(dtype).name}"


class _Breaker:
    """One signature's breaker (state machine only; the board owns the
    lock and the transition trail)."""

    def __init__(self, signature: str):
        self.signature = signature
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.trips = 0
        self.probe_inflight = False


class BreakerBoard:
    """Every signature's breaker plus the ordered transition trail.

    All mutation happens under one lock; the transition trail is the
    certifiable artifact."""

    def __init__(self, policy: AdmissionPolicy, clock=time.perf_counter):
        self.policy = policy
        self.clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[str, _Breaker] = {}
        self.transitions: list[dict] = []

    def _transition(self, br: _Breaker, to: str, reason: str) -> None:
        self.transitions.append(
            {"signature": br.signature, "from": br.state, "to": to,
             "reason": reason, "seq": len(self.transitions)})
        br.state = to
        _M_BREAKER.labels(to=to).inc()

    def _get(self, signature: str) -> _Breaker:
        br = self._breakers.get(signature)
        if br is None:
            br = self._breakers[signature] = _Breaker(signature)
        return br

    def _tick(self, br: _Breaker) -> None:
        """Cooldown expiry: OPEN -> HALF_OPEN (arming one probe)."""
        if br.state == OPEN and (self.clock() - br.opened_at) * 1e3 \
                >= self.policy.breaker_cooldown_ms:
            self._transition(br, HALF_OPEN, "cooldown elapsed")

    def _worst(self, solver: str, dtype) -> _Breaker | None:
        """Most severe breaker across this solver's bucket signatures
        (caller holds the lock); ticks cooldowns on the way."""
        prefix = f"{solver}/b"
        suffix = f"/{np.dtype(dtype).name}"
        worst: _Breaker | None = None
        for sig, br in self._breakers.items():
            if not (sig.startswith(prefix) and sig.endswith(suffix)):
                continue
            self._tick(br)
            if worst is None or _SEVERITY[br.state] \
                    > _SEVERITY[worst.state]:
                worst = br
        return worst

    def peek(self, solver: str, dtype) -> tuple[bool, str, str | None]:
        """:meth:`admit` without arming the half-open probe — the
        SUBMIT-time check (only the dispatch should consume the one
        probe slot, or an admission burst would exhaust it before any
        dispatch ran)."""
        with self._lock:
            worst = self._worst(solver, dtype)
            if worst is None or worst.state == CLOSED:
                return True, CLOSED, None
            if worst.state == HALF_OPEN:
                return (not worst.probe_inflight, HALF_OPEN,
                        worst.signature)
            return False, OPEN, worst.signature

    def admit(self, solver: str, dtype) -> tuple[bool, str, str | None]:
        """Admission verdict for a request on ``solver``: ``(admit,
        state, signature)`` where ``state`` is the most severe breaker
        state across this solver's bucket signatures (``signature`` the
        breaker that carries it, None when every breaker is closed).

        OPEN denies; HALF_OPEN admits exactly ONE probe (the first
        admit after cooldown) and denies the rest until the probe
        resolves at :meth:`record`.  Whether a denial becomes an
        ``ERR_OVERLOADED`` fast-fail or a degraded classic-CG dispatch
        is the service's call (the degradation ladder)."""
        with self._lock:
            worst = self._worst(solver, dtype)
            if worst is None or worst.state == CLOSED:
                return True, CLOSED, None
            if worst.state == HALF_OPEN:
                # one probe per half-open period: the flag arms at the
                # OPEN->HALF_OPEN transition and disarms here
                if not worst.probe_inflight:
                    worst.probe_inflight = True
                    return True, HALF_OPEN, worst.signature
                return False, HALF_OPEN, worst.signature
            return False, OPEN, worst.signature

    def record(self, solver: str, bucket: int, dtype, ok: bool) -> None:
        """One dispatch outcome on its exact signature.  A HALF_OPEN
        breaker for the same solver+dtype resolves on ANY bucket's
        outcome (the probe may coalesce into a different bucket than
        the one that tripped)."""
        if self.policy.breaker_threshold <= 0:
            return
        sig = breaker_signature(solver, bucket, dtype)
        prefix = f"{solver}/b"
        suffix = f"/{np.dtype(dtype).name}"
        with self._lock:
            br = self._get(sig)
            if ok:
                br.consecutive_failures = 0
                if br.state != CLOSED:
                    self._transition(br, CLOSED, "probe succeeded")
                    br.probe_inflight = False
            else:
                br.consecutive_failures += 1
                if br.state == HALF_OPEN:
                    self._transition(br, OPEN, "probe failed")
                    br.opened_at = self.clock()
                    br.trips += 1
                    br.probe_inflight = False
                elif br.state == CLOSED and br.consecutive_failures \
                        >= self.policy.breaker_threshold:
                    self._transition(
                        br, OPEN,
                        f"{br.consecutive_failures} consecutive "
                        "failures")
                    br.opened_at = self.clock()
                    br.trips += 1
            # resolve sibling half-open breakers (probe rode another
            # bucket's signature)
            for osig, obr in self._breakers.items():
                if osig == sig or obr.state != HALF_OPEN:
                    continue
                if osig.startswith(prefix) and osig.endswith(suffix):
                    if ok:
                        self._transition(obr, CLOSED, "probe succeeded")
                    else:
                        self._transition(obr, OPEN, "probe failed")
                        obr.opened_at = self.clock()
                        obr.trips += 1
                    obr.probe_inflight = False
                    obr.consecutive_failures = 0

    def states(self) -> dict:
        with self._lock:
            for br in self._breakers.values():
                self._tick(br)
            return {sig: {"state": br.state, "trips": int(br.trips),
                          "consecutive_failures":
                              int(br.consecutive_failures)}
                    for sig, br in self._breakers.items()}

    @property
    def trips(self) -> int:
        with self._lock:
            return sum(br.trips for br in self._breakers.values())


class RollingWindow:
    """Last-N request outcomes for health(): failure rate plus
    p50/p99 of queue wait and dispatch wall.

    The summary is CACHED and invalidated by :meth:`record`: the
    percentile sort is O(N log N), and a health poller hitting
    ``summary()`` at some rate must not re-sort an unchanged window on
    every call (under load-shedding the window freezes while pollers
    spin — exactly when re-sorting per poll was pure waste).  Repeated
    summaries of an unchanged window return the same dict object;
    callers must treat it as read-only.

    Latency samples are OPTIONAL per record: a request shed at
    admission (or timed out before dispatch) counts toward the failure
    rate but contributes no queue-wait/dispatch-wall sample — zeros
    from refused requests would drag the percentiles toward zero at
    exactly the moment the service is drowning, inverting the tail-
    latency signal the window exists to report."""

    def __init__(self, maxlen: int = 256):
        self.maxlen = int(maxlen)
        self._lock = threading.Lock()
        self._ok = collections.deque(maxlen=self.maxlen)
        self._wait = collections.deque(maxlen=self.maxlen)
        self._wall = collections.deque(maxlen=self.maxlen)
        self._summary: dict | None = None

    def record(self, ok: bool, queue_wait: float | None = None,
               wall: float | None = None) -> None:
        with self._lock:
            self._ok.append(bool(ok))
            if queue_wait is not None:
                self._wait.append(float(queue_wait))
            if wall is not None:
                self._wall.append(float(wall))
            self._summary = None        # invalidate the cached summary

    @staticmethod
    def _pcts(vals) -> dict:
        if not vals:
            return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
        a = np.asarray(vals, np.float64) * 1e3
        return {"p50_ms": float(np.percentile(a, 50)),
                "p99_ms": float(np.percentile(a, 99)),
                "mean_ms": float(a.mean())}

    def summary(self) -> dict:
        with self._lock:
            if self._summary is None:
                n = len(self._ok)
                nfail = n - sum(self._ok)
                self._summary = {
                    "n": n,
                    "failure_rate": (nfail / n) if n else None,
                    "queue_wait": self._pcts(self._wait),
                    "dispatch_wall": self._pcts(self._wall)}
            return self._summary


@dataclasses.dataclass
class AdmissionRecord:
    """Per-request admission telemetry, accumulated along the request's
    path and exported as the audit's ``admission`` block."""

    policy: AdmissionPolicy
    deadline_s: float | None = None     # absolute (monotonic) or None
    queue_deadline_s: float | None = None
    admitted_at: float = 0.0
    # the request's end-to-end trace ID (acg_torch/obs/events.py),
    # minted at submit and cross-linked into the flight-recorder
    # timeline — the admission block carries it so an audit document
    # joins to its timeline by ID
    trace_id: str | None = None
    retries_used: int = 0
    backoffs_ms: list = dataclasses.field(default_factory=list)
    breaker_state: str = CLOSED
    breaker_signature: str | None = None
    shed: bool = False
    degraded: bool = False
    degraded_from: str | None = None
    expired: bool = False

    def remaining_s(self, now: float | None = None) -> float | None:
        if self.deadline_s is None:
            return None
        return self.deadline_s - (time.perf_counter() if now is None
                                  else now)

    def as_dict(self, trips: int = 0) -> dict:
        p = self.policy
        deadline = None
        if p.deadline_ms > 0 or p.queue_deadline_ms > 0:
            # a queue-deadline-only policy (deadline_ms=0) still sheds:
            # its document must say which budget killed the request,
            # not "no deadline was configured" (budget_ms=0 = the total
            # is unbounded, only the queue slice is)
            rem = self.remaining_s()
            deadline = {
                "budget_ms": float(p.deadline_ms),
                "queue_ms": (float(p.queue_deadline_ms)
                             if p.queue_deadline_ms > 0 else None),
                "remaining_ms": (None if rem is None
                                 else float(rem * 1e3)),
                "expired": bool(self.expired),
            }
        breaker = None
        if p.breaker_threshold > 0:
            breaker = {"state": str(self.breaker_state),
                       "signature": self.breaker_signature,
                       "trips": int(trips)}
        return {"deadline": deadline,
                "retries": {"used": int(self.retries_used),
                            "max": int(p.max_retries),
                            "backoff_ms": [float(v)
                                           for v in self.backoffs_ms]},
                "breaker": breaker,
                "shed": bool(self.shed),
                "degraded": bool(self.degraded),
                "degraded_from": self.degraded_from,
                "trace_id": self.trace_id}
