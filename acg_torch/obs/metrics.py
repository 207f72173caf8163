"""Process-wide runtime metrics registry (the port of
``acg_tpu.obs.metrics``, the serving instrument panel).

A thread-safe registry of

- **counters** — monotone totals (requests by status, cache hits/misses,
  sheds, retries, breaker transitions, kernel disengagements);
- **gauges** — instantaneous values (queue depth);
- **histograms** — bounded-bucket distributions (queue wait, dispatch
  wall, batch occupancy, iterations per solve) with cumulative bucket
  counts in the Prometheus style, so p50/p99 are recoverable from any
  scrape without the registry keeping raw samples.

Exports: :meth:`MetricsRegistry.prometheus_text` (the ``text/plain``
exposition format a Prometheus scrape consumes) and
:meth:`MetricsRegistry.snapshot` (one JSON-ready dict).  Metric names
are the JAX package's, letter for letter, so a dashboard reads either.

**The zero-overhead clause**: the process registry defaults DISABLED —
every ``inc`` / ``set`` / ``observe`` is a flag-check no-op, nothing
accumulates, and every instrument is HOST-side bookkeeping around an
unchanged dispatch: enabling metrics changes no launch and no bit of a
result (instruments record from Python code that already runs on the
host: submit paths, cache lookups, the post-solve ``_finish``), and
none records from inside a captured block.

Instrument families are **get-or-create** by name (the
prometheus_client convention): every module-level ``counter(...)``
declaration with the same name returns the same family.
"""

from __future__ import annotations

import bisect
import threading

__all__ = [
    "MetricsRegistry", "registry", "counter", "gauge", "histogram",
    "enable_metrics", "disable_metrics", "metrics_enabled",
    "reset_metrics", "LATENCY_BUCKETS", "ITERATION_BUCKETS",
    "RATIO_BUCKETS",
]

# default bucket ladders (upper bounds, seconds / iterations / [0,1]);
# every histogram is BOUNDED: a fixed bucket vector plus sum+count, so
# memory is O(len(buckets)) per label set no matter how many samples
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
ITERATION_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                     5000, 10000)
RATIO_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

_INF = float("inf")


def _label_key(family, labels: dict) -> tuple:
    names = family.labelnames
    if set(labels) != set(names):
        raise ValueError(
            f"metric {family.name!r} takes labels {names}, got "
            f"{tuple(sorted(labels))}")
    return tuple(str(labels[n]) for n in names)


class _Child:
    """One label-set's value cell.  Mutation is a no-op while the
    owning registry is disabled (the zero-overhead clause)."""

    def __init__(self, family, key: tuple):
        self._family = family
        self._key = key

    @property
    def _on(self) -> bool:
        return self._family._reg.enabled


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if not self._on:
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._family._lock:
            self._family._values[self._key] = (
                self._family._values.get(self._key, 0.0) + amount)


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        if not self._on:
            return
        with self._family._lock:
            self._family._values[self._key] = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._on:
            return
        with self._family._lock:
            self._family._values[self._key] = (
                self._family._values.get(self._key, 0.0) + amount)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild(_Child):
    def observe(self, value: float) -> None:
        if not self._on:
            return
        fam = self._family
        with fam._lock:
            cell = fam._values.get(self._key)
            if cell is None:
                # one count slot per finite bound + the +Inf overflow
                cell = fam._values[self._key] = {
                    "counts": [0] * (len(fam.buckets) + 1),
                    "sum": 0.0, "count": 0}
            v = float(value)
            cell["counts"][bisect.bisect_left(fam.buckets, v)] += 1
            cell["sum"] += v
            cell["count"] += 1


_CHILD = {"counter": _CounterChild, "gauge": _GaugeChild,
          "histogram": _HistogramChild}


class _Family:
    """One named metric (all its label sets).  ``labels()`` returns the
    per-label-set child; label-free metrics mutate through the family
    itself (it doubles as the ``()`` child)."""

    def __init__(self, reg: "MetricsRegistry", kind: str, name: str,
                 help: str, labelnames: tuple, buckets=None):
        self._reg = reg
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        if kind == "histogram":
            bs = tuple(float(b) for b in (buckets or LATENCY_BUCKETS))
            if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
                raise ValueError(f"histogram {name!r}: buckets must be "
                                 "strictly increasing")
            self.buckets = bs
        else:
            self.buckets = None
        self._lock = threading.Lock()
        self._values: dict = {}
        self._nolabel = (_CHILD[kind](self, ())
                         if not self.labelnames else None)

    def labels(self, **labels) -> _Child:
        return _CHILD[self.kind](self, _label_key(self, labels))

    # label-free convenience: family IS the () child
    def inc(self, amount: float = 1.0) -> None:
        self._require_nolabel().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._require_nolabel().dec(amount)

    def set(self, value: float) -> None:
        self._require_nolabel().set(value)

    def observe(self, value: float) -> None:
        self._require_nolabel().observe(value)

    def _require_nolabel(self):
        if self._nolabel is None:
            raise ValueError(f"metric {self.name!r} takes labels "
                             f"{self.labelnames}; use .labels(...)")
        return self._nolabel

    def value(self, **labels) -> float:
        """Introspection (tests, the serve REPL): the current scalar for
        a counter/gauge label set (0.0 when never recorded)."""
        key = _label_key(self, labels) if labels else ()
        with self._lock:
            v = self._values.get(key, 0.0)
        if self.kind == "histogram":
            raise ValueError("histograms have no scalar value; use "
                             "snapshot()")
        return float(v)

    def _snapshot_values(self) -> list:
        out = []
        with self._lock:
            items = sorted(self._values.items())
            for key, v in items:
                labels = dict(zip(self.labelnames, key))
                if self.kind == "histogram":
                    buckets = {}
                    cum = 0
                    for bound, c in zip(self.buckets, v["counts"]):
                        cum += c
                        buckets[repr(bound)] = cum
                    buckets["+Inf"] = cum + v["counts"][-1]
                    out.append({"labels": labels, "buckets": buckets,
                                "sum": v["sum"], "count": v["count"]})
                else:
                    out.append({"labels": labels, "value": v})
        return out


class MetricsRegistry:
    """Thread-safe named-metric registry.  The process default
    (:func:`registry`) starts DISABLED; tests may construct private
    enabled registries directly."""

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # -- declaration (get-or-create, idempotent) ------------------------

    def _family(self, kind: str, name: str, help: str,
                labelnames: tuple, buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-declared as {kind} with "
                        f"labels {tuple(labelnames)} (existing: "
                        f"{fam.kind}, {fam.labelnames})")
                return fam
            fam = _Family(self, kind, name, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> _Family:
        return self._family("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> _Family:
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple = (), buckets=None) -> _Family:
        return self._family("histogram", name, help, labelnames, buckets)

    def get(self, name: str) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    # -- lifecycle ------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop every recorded value (declarations survive) — test
        isolation, and the SLO harness's per-run baseline."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            with fam._lock:
                fam._values.clear()

    # -- export ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready snapshot: the ``metrics`` block of the serve
        layer's audit documents and the REPL's ``metrics`` command."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        out = {"enabled": bool(self.enabled),
               "counters": {}, "gauges": {}, "histograms": {}}
        for fam in fams:
            block = {"help": fam.help, "values": fam._snapshot_values()}
            if fam.kind == "histogram":
                block["buckets"] = [repr(b) for b in fam.buckets]
                out["histograms"][fam.name] = block
            elif fam.kind == "gauge":
                out["gauges"][fam.name] = block
            else:
                out["counters"][fam.name] = block
        return out

    def prometheus_text(self) -> str:
        """The Prometheus ``text/plain; version=0.0.4`` exposition of
        every family (cumulative ``le`` buckets + ``_sum``/``_count``
        for histograms) — what a ``/metrics`` scrape endpoint or the
        serve REPL's ``metrics prom`` command returns."""
        lines = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} "
                             f"{_prom_help_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for v in fam._snapshot_values():
                base = dict(v["labels"])
                if fam.kind == "histogram":
                    for le, c in v["buckets"].items():
                        lines.append(_prom_line(
                            fam.name + "_bucket",
                            {**base, "le": le}, c))
                    lines.append(_prom_line(fam.name + "_sum", base,
                                            v["sum"]))
                    lines.append(_prom_line(fam.name + "_count", base,
                                            v["count"]))
                else:
                    lines.append(_prom_line(fam.name, base, v["value"]))
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_line(name: str, labels: dict, value) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_prom_escape(str(v))}"'
            for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_prom_num(value)}"
    return f"{name} {_prom_num(value)}"


def _prom_escape(s: str) -> str:
    # label VALUES escape backslash, double-quote and newline
    # (exposition format 0.0.4)
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n",
                                                              r"\n")


def _prom_help_escape(s: str) -> str:
    # HELP text escapes only backslash and newline (a double quote is
    # legal there — escaping it would corrupt the docstring)
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _prom_num(v) -> str:
    if isinstance(v, float):
        if v == _INF:
            return "+Inf"
        if v != v:
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
    return str(v)


# ---------------------------------------------------------------------------
# the process-wide default registry (disabled until enable_metrics())

_REGISTRY = MetricsRegistry(enabled=False)


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str, help: str = "", labelnames: tuple = ()) -> _Family:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: tuple = ()) -> _Family:
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: tuple = (),
              buckets=None) -> _Family:
    return _REGISTRY.histogram(name, help, labelnames, buckets)


def enable_metrics() -> None:
    """Turn the process registry ON (the CLI's ``--metrics``, tests).
    Host-side only: the dispatched solve is bit-identical either way."""
    _REGISTRY.enable()


def disable_metrics() -> None:
    _REGISTRY.disable()


def metrics_enabled() -> bool:
    return _REGISTRY.enabled


def reset_metrics() -> None:
    _REGISTRY.reset()


# ---------------------------------------------------------------------------
# solver-layer telemetry (the host-side post-solve chokepoint)


def observe_solve_result(res, solver: str) -> None:
    """Record one completed solve's telemetry — called from the
    solvers' ``_finish`` (acg_torch/solvers/cg.py), the SINGLE host-side
    point every solve, one device or shards, ordinary or resident, flows
    through, AFTER the device loop has returned and its scalars are on
    the host: iterations, outcome status, kernel-disengagement reasons
    (``SolveResult.kernel_note``), and — for the s-step family, whose
    every exit is true-residual certified by construction — the
    certification counter."""
    if not _REGISTRY.enabled:
        return
    status = getattr(getattr(res, "status", None), "name", None) \
        or ("SUCCESS" if getattr(res, "converged", False)
            else "ERR_NOT_CONVERGED")
    _REGISTRY.counter(
        "acg_solver_solves_total",
        "Completed solves by solver kind and outcome status",
        ("solver", "status")).labels(solver=solver, status=status).inc()
    _REGISTRY.histogram(
        "acg_solver_iterations", "Iterations per completed solve",
        ("solver",), ITERATION_BUCKETS).labels(solver=solver).observe(
        int(getattr(res, "niterations", 0)))
    note = getattr(res, "kernel_note", "") or ""
    if note:
        # bounded label cardinality: count each clause by its HEAD
        # ("pipe2d disengaged: replace_every=50" -> "pipe2d
        # disengaged"), not the full parameterized message
        fam = _REGISTRY.counter(
            "acg_solver_kernel_disengaged_total",
            "Kernel-tier disengagements/overrides by reason "
            "(SolveResult.kernel_note clause heads)", ("reason",))
        for clause in note.split(";"):
            reason = clause.split(":", 1)[0].strip()
            if reason:
                fam.labels(reason=reason).inc()
    if solver == "cg-sstep":
        observe_certification("sstep-exit")


def observe_certification(kind: str) -> None:
    """Count one true-residual certification: ``"sstep-exit"`` (every
    s-step exit certifies against a fresh true residual) or ``"host"``
    (a supervisor's host-operator certification)."""
    if not _REGISTRY.enabled:
        return
    _REGISTRY.counter(
        "acg_solver_true_residual_certifications_total",
        "True-residual certifications of claimed exits by kind",
        ("kind",)).labels(kind=kind).inc()
