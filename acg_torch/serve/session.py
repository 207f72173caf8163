"""Persistent solver session: prepared operator + resident-solve cache.

The port of ``acg_tpu.serve.session``.  A :class:`Session` is the
residency layer between the solvers and traffic: the operator pipeline
(read → partition → tier resolution → device placement) runs ONCE,
through the phase seams the CLI names (``SpanTracer`` spans "read",
"partition", "operator-build", "compile", "solve"), and every later
solve dispatches into a **resident solve** cached by static signature

    (solver kind, nparts, padded b shape incl. B, vector dtype,
     operator tier, static SolverOptions fields, whether x0 rides)

built by the solvers' ``aot_step`` (``acg_torch/solvers/cg.py``,
``cg_dist.py``).  Where the JAX package keeps an AOT-compiled executable
a signature, the port keeps the loop's state: its buffers (b, x, r, p,
the pipelined and deep vectors and rings, the history, the flags and
counts, the thresholds and 0-d constants) and its block runner, whose
CUDA graphs outlive a solve.  A cache hit skips read, partition,
operator build and the state's allocation, and on the card a dispatch
that runs the blocks an earlier one ran captures nothing: it copies the
new right-hand side in and replays.  The "compile" span times the
state's build; the captures, made by the first dispatch of a
signature, fall in its "solve" span (``SolveStats.ncaptures``).

The **prepared-operator cache** (process-level, keyed by the graph
content hash of ``acg_torch/partition/cache.py`` and the build
parameters, devices included) hands a second Session on the same matrix
the already-uploaded operator.  The partition prep cache below it is not
ported: ``prep_cache`` takes None or "auto", both meaning none.

Sessions are thread-compatible: :meth:`solve` serializes dispatch under
a lock, and every device call of a dispatch (the upload of b, the loop,
its captures, the copies back) runs on the dispatching thread inside it:
a capture in progress sees no other thread's CUDA call.

:meth:`Session.audit` is the counted CommAudit (``obs/audit.py``) of a
configuration on the prepared operator.  Refused here, with
``ERR_NOT_SUPPORTED``: ``recycle=True`` and the recycle state (spectral
recycling and warm-start donors), ``fault=`` (``robust/faults.py``), a
prep-cache directory.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np

from acg_torch.config import HaloMethod, SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.obs import metrics as _metrics
from acg_torch.obs.trace import SpanTracer

# runtime telemetry (acg_torch/obs/metrics.py; no-ops until
# enable_metrics()): the resident-solve / prepared-operator cache
# traffic and the build wall, recorded host-side around the dispatch
_M_EXEC = _metrics.counter(
    "acg_serve_executable_cache_total",
    "AOT-executable cache lookups by outcome", ("outcome",))
_M_PREPARED = _metrics.counter(
    "acg_serve_prepared_operator_total",
    "Prepared-operator cache lookups by outcome", ("outcome",))
_M_COMPILE = _metrics.histogram(
    "acg_serve_compile_seconds",
    "Wall seconds per executable-cache-miss compile")
_M_SOLVES = _metrics.counter(
    "acg_serve_session_solves_total",
    "Session dispatches by path", ("path",))

# solver-name normalization: the CLI spellings all collapse onto the
# device loop kinds
_KINDS = {
    "cg": "cg", "acg": "cg", "acg-device": "cg", "cg-device": "cg",
    "cg-pipelined": "cg-pipelined", "acg-pipelined": "cg-pipelined",
    "acg-device-pipelined": "cg-pipelined",
    "cg-device-pipelined": "cg-pipelined",
    "cg-sstep": "cg-sstep", "acg-sstep": "cg-sstep",
    "cg-pipelined-deep": "cg-pipelined-deep",
    "acg-pipelined-deep": "cg-pipelined-deep",
    "cg-recycled": "cg-recycled", "acg-recycled": "cg-recycled",
}

# the prepared-operator cache: graph hash + build params -> (dev, ss).
# Process-level and unbounded by design: a serving process holds a
# handful of operators, each already resident in device memory anyway.
_PREPARED: dict = {}
_PREPARED_LOCK = threading.Lock()


def _normalize_solver(solver: str) -> str:
    kind = _KINDS.get(solver)
    if kind is None:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"Session serves the device solvers "
                       f"(cg, cg-pipelined, cg-pipelined-deep, "
                       f"cg-sstep, cg-recycled); got {solver!r}")
    return kind


def _tier_name(op) -> str:
    """The device operator's tier ("stencil", "dia", "sgell", "ell"; an
    RCM ordering prefixed "rcm+")."""
    from acg_torch.ops.dia import DeviceDia
    from acg_torch.ops.sgell import DeviceSgell
    from acg_torch.ops.spmv import DeviceEll
    from acg_torch.ops.stencil import DeviceStencil
    from acg_torch.solvers.cg import PermutedOperator

    if isinstance(op, PermutedOperator):
        return "rcm+" + _tier_name(op.dev)
    for cls, name in ((DeviceStencil, "stencil"), (DeviceDia, "dia"),
                      (DeviceSgell, "sgell"), (DeviceEll, "ell")):
        if isinstance(op, cls):
            return name
    return type(op).__name__


class Session:
    """A prepared, device-resident linear operator plus its resident-solve
    cache: solve many right-hand sides against one matrix without paying
    preprocessing or the loop's set-up again.

    ``A`` is a host matrix (CsrMatrix, DiaMatrix, EllMatrix), a device
    operator or a :class:`~acg_torch.parallel.sharded.ShardedSystem`
    already built (its parts, devices and halo are then the session's),
    or a path is given via ``path=`` (Matrix Market, read in the "read"
    span).  ``nparts > 1`` prepares the sharded
    operator on ``devices`` (default: the visible cards, one a shard;
    ``["cuda:0"] * P`` puts every shard on one card, ``["cpu"] * P`` runs
    the plain versions); 1 the single-device operator on ``device``
    (default ``cuda``, an error without a card).  ``loop`` as
    :func:`acg_torch.solvers.cg.cg` ("graph" by default on one card).
    ``prep_cache`` is None or "auto" (no prep cache in this port);
    ``share_prepared=False`` opts out of the process-level
    prepared-operator cache (tests use this to measure cold builds).
    ``recycle=True`` raises ``ERR_NOT_SUPPORTED``."""

    def __init__(self, A=None, *, path: str | None = None, nparts: int = 1,
                 part=None,
                 dtype=np.float64, fmt: str = "auto", mat_dtype="auto",
                 halo: HaloMethod = HaloMethod.PPERMUTE,
                 partition_method: str = "auto", seed: int = 0,
                 epsilon: float = 0.0, binary=None,
                 options: SolverOptions = SolverOptions(),
                 tracer: SpanTracer | None = None, log=None,
                 prep_cache="auto", share_prepared: bool = True,
                 recycle: bool = False, device=None, devices=None,
                 loop: str | None = None):
        from acg_torch.partition.cache import resolve_prep_cache
        from acg_torch.utils.backend import resolve_device

        if (A is None) == (path is None):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           "Session needs exactly one of A or path")
        if recycle:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "recycle=True (RecycleState: warm-start donors, "
                           "refined s-step shifts, the deflation basis) is "
                           "not ported")
        self.prep_cache = resolve_prep_cache(prep_cache)
        self.tracer = tracer if tracer is not None else SpanTracer(log=log)
        self.nparts = int(nparts)
        # an explicit part vector pins the partitioning; it bypasses the
        # partitioner AND the prepared-operator cache (whose key does not
        # cover it)
        self.part = None if part is None else np.asarray(part,
                                                         dtype=np.int32)
        self.dtype = np.dtype(dtype)
        self.fmt = fmt
        self.mat_dtype = mat_dtype
        self.halo = HaloMethod(halo)
        self.partition_method = partition_method
        self.seed = int(seed)
        self.default_options = options
        self.loop = loop
        self.devices = None if devices is None else tuple(devices)
        from acg_torch.parallel.sharded import ShardedSystem

        if isinstance(A, ShardedSystem):
            # a built system: its parts, devices and halo are the
            # session's
            self.nparts, self.devices = len(A.devices), tuple(A.devices)
            self.halo = A.method
        self.device = (resolve_device(device) if self.nparts == 1
                       else None)
        self._share_prepared = bool(share_prepared)

        if path is not None:
            from acg_torch.io.mtxfile import read_mtx
            from acg_torch.sparse.csr import csr_from_mtx

            with self.tracer.span("read"):
                m = read_mtx(path, binary=binary)
                A = csr_from_mtx(m, val_dtype=self.dtype)
        if epsilon:
            from acg_torch.sparse.csr import CsrMatrix

            if not isinstance(A, CsrMatrix):
                raise AcgError(Status.ERR_NOT_SUPPORTED,
                               "epsilon shifts the diagonal of a host CSR "
                               f"matrix, not of a built {type(A).__name__}")
            A = A.shift_diagonal(epsilon)
        self.A = A

        # counters surfaced by stats() and the audit's session block:
        # resident-solve cache traffic, prepared-operator traffic,
        # dispatch volume
        self.counters = {
            "executable": {"hits": 0, "misses": 0, "compile_seconds": 0.0},
            "prepared": {"hits": 0, "misses": 0},
            "solves": 0, "uncached_solves": 0, "requests": 0,
        }
        self._exec: dict = {}
        self._lock = threading.RLock()
        # a dead session fails every dispatch with a transient-classified
        # ERR_FAULT_DETECTED (what a replica whose devices stopped
        # answering looks like from the host); set by kill(), never
        # cleared
        self.dead = False
        self._closed = False
        self._prepare()

    # -- preparation ----------------------------------------------------

    def _graph_hash(self):
        """The operator's content hashes (GraphHashes), computed AT MOST
        ONCE per Session (an O(nnz) pass); None for an operator that is
        not a host CSR matrix."""
        if not hasattr(self, "_ghash"):
            from acg_torch.partition.cache import graph_hashes
            from acg_torch.sparse.csr import CsrMatrix

            self._ghash = (graph_hashes(self.A)
                           if isinstance(self.A, CsrMatrix) else None)
        return self._ghash

    def _prepare_key(self):
        if self.part is not None:
            return None     # a pinned part vector is outside the key
        ghash = self._graph_hash()
        if ghash is None:
            return None
        return (ghash.full, self.nparts, self.dtype.name, self.fmt,
                str(self.mat_dtype), self.halo.value,
                self.partition_method, self.seed, str(self.device),
                None if self.devices is None
                else tuple(map(str, self.devices)))

    def _prepare(self):
        """Partition + tier resolution + device placement, once — or a
        prepared-operator cache hit (same graph hash + build params)."""
        key = self._prepare_key() if self._share_prepared else None
        if key is not None:
            with _PREPARED_LOCK:
                hit = _PREPARED.get(key)
            if hit is not None:
                self._dev, self._ss = hit
                self.counters["prepared"]["hits"] += 1
                _M_PREPARED.labels(outcome="hit").inc()
                return
        self._dev = self._ss = None
        if self.nparts > 1:
            from acg_torch.partition.partitioner import partition_graph
            from acg_torch.solvers.cg_dist import build_sharded

            from acg_torch.parallel.sharded import ShardedSystem

            part = self.part
            if part is None and not isinstance(self.A, ShardedSystem):
                with self.tracer.span("partition"):
                    part = partition_graph(self.A, self.nparts,
                                           method=self.partition_method,
                                           seed=self.seed)
            with self.tracer.span("operator-build"):
                self._ss = build_sharded(
                    self.A, part=part, devices=self.devices,
                    dtype=self.dtype, method=self.halo,
                    partition_method=self.partition_method,
                    seed=self.seed, mat_dtype=self.mat_dtype,
                    fmt=self.fmt)
        else:
            from acg_torch.solvers.cg import build_device_operator

            with self.tracer.span("operator-build"):
                self._dev = build_device_operator(
                    self.A, dtype=self.dtype, fmt=self.fmt,
                    mat_dtype=self.mat_dtype, device=self.device)
        self.counters["prepared"]["misses"] += 1
        _M_PREPARED.labels(outcome="miss").inc()
        if key is not None:
            with _PREPARED_LOCK:
                _PREPARED[key] = (self._dev, self._ss)

    @property
    def operator(self):
        """The prepared operator: a ShardedSystem (nparts > 1) or a
        single-device operator."""
        return self._ss if self._ss is not None else self._dev

    @property
    def recycle_state(self):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "the recycle state (RecycleState) is not ported")

    @property
    def nrows(self) -> int:
        return (self._ss.nrows if self._ss is not None
                else self.A.nrows if hasattr(self.A, "nrows")
                else self._dev.nrows)

    # -- the resident-solve cache ---------------------------------------

    def _tier(self) -> str:
        """The prepared operator's tier, part of every signature: a
        resident solve never crosses tiers."""
        if self._ss is not None:
            return self._ss.local_fmt
        return _tier_name(self._dev)

    def _signature(self, kind: str, nrhs: int, o: SolverOptions,
                   has_x0: bool = False) -> tuple:
        """The static signature a resident solve serves (the JAX
        package's fields).  Tolerance VALUES are per dispatch; only their
        non-zero-ness is part of the key, and so is whether an initial
        guess rides the dispatch."""
        return (kind, self.nparts, int(nrhs), self.dtype.name,
                self._tier(),
                o.maxits, o.check_every, o.replace_every,
                o.monitor_every, o.guard_nonfinite, o.sstep,
                o.pipeline_depth, o.halo_wire,
                o.residual_atol > 0, o.residual_rtol > 0,
                o.diffatol > 0, o.diffrtol > 0, bool(has_x0))

    def _resident(self, kind: str, o: SolverOptions) -> bool:
        """Whether this kind and these options have a resident solve:
        classic, pipelined and deep-pipelined on one device, classic and
        pipelined over shards (the deep loop over shards, the s-step and
        recycled families and segmented solves run the ordinary solver
        functions)."""
        if kind not in ("cg", "cg-pipelined", "cg-pipelined-deep") \
                or o.segment_iters > 0:
            return False
        return not (self._ss is not None and kind == "cg-pipelined-deep"
                    and o.pipeline_depth > 1)

    def _get_executable(self, kind: str, b, x0, o: SolverOptions):
        nrhs = b.shape[0] if np.ndim(b) == 2 else 1
        sig = self._signature(kind, nrhs, o, has_x0=x0 is not None)
        entry = self._exec.get(sig)
        if entry is not None:
            self.counters["executable"]["hits"] += 1
            _M_EXEC.labels(outcome="hit").inc()
            return entry
        with self.tracer.span("compile"):
            t0 = time.perf_counter()
            if self._ss is not None:
                from acg_torch.solvers.cg_dist import aot_step as dist_aot

                entry = dist_aot(self._ss, b=np.asarray(b), x0=x0,
                                 options=o, solver=kind, loop=self.loop)
            else:
                from acg_torch.solvers.cg import aot_step

                entry = aot_step(self._dev, b, x0=x0, options=o,
                                 dtype=self.dtype, fmt=self.fmt,
                                 mat_dtype=self.mat_dtype, solver=kind,
                                 device=self.device, loop=self.loop)
            compile_s = time.perf_counter() - t0
            self.counters["executable"]["compile_seconds"] += compile_s
            _M_COMPILE.observe(compile_s)
        self.counters["executable"]["misses"] += 1
        _M_EXEC.labels(outcome="miss").inc()
        self._exec[sig] = entry
        return entry

    def has_executable(self, solver: str, nrhs: int,
                       options: SolverOptions | None = None,
                       has_x0: bool = False) -> bool:
        """Whether this signature is already resident (no state would be
        built).  The service layer records this per dispatch as the
        authoritative cache_hit bit."""
        o = options if options is not None else self.default_options
        kind = _normalize_solver(solver)
        if not self._resident(kind, o):
            return False
        return self._signature(kind, nrhs, o, has_x0=has_x0) in self._exec

    def executable(self, *, solver: str = "cg", nrhs: int = 1,
                   options: SolverOptions | None = None):
        """The cached :class:`~acg_torch.solvers.cg.AotSolve` for this
        signature, built on first use."""
        o = options if options is not None else self.default_options
        kind = _normalize_solver(solver)
        if not self._resident(kind, o):
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           f"{kind} with these options dispatches through "
                           "the ordinary solver functions (no resident "
                           "solve)")
        n = self.nrows
        b = np.zeros((nrhs, n) if nrhs > 1 else (n,), dtype=self.dtype)
        with self._lock:
            return self._get_executable(kind, b, None, o)

    def audit(self, *, solver: str = "cg", nrhs: int = 1,
              options: SolverOptions | None = None):
        """The counted CommAudit (``acg_torch/obs/audit.py``) of
        ``solver`` with ``options`` on the prepared operator: halo
        exchanges, reduction points, kernel launches and host reads an
        iteration, counted over two short fixed-iteration solves of the
        ordinary solver functions (the resident-solve cache is keyed by
        ``maxits``, so the audit leaves it alone)."""
        from acg_torch.obs.audit import audit_solver

        o = options if options is not None else self.default_options
        with self._lock:
            return audit_solver(self.operator, solver=_normalize_solver(
                solver), nrhs=nrhs, options=o)

    # -- solving --------------------------------------------------------

    def solve(self, b, *, solver: str = "cg",
              options: SolverOptions | None = None, x0=None,
              stats=None, fault=None):
        """Solve against the prepared operator.  ``b`` of shape ``(n,)``
        or ``(B, n)`` (the coalesced batch).  Classic, pipelined and
        deep-pipelined solves (the deep one over shards excepted)
        dispatch through the cached resident solve; the s-step family,
        the recycled kind, the deep loop over shards and segmented solves
        take the ordinary solver functions and are counted as
        ``uncached_solves``.  ``fault`` (an injection plan) raises
        ``ERR_NOT_SUPPORTED``."""
        o = options if options is not None else self.default_options
        kind = _normalize_solver(solver)
        if fault is not None:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "fault injection (robust/faults.py) is not "
                           "ported")
        with self._lock:
            if self.dead:
                raise AcgError(
                    Status.ERR_FAULT_DETECTED,
                    "replica session is dead: dispatch failed")
            if self._closed:
                raise AcgError(Status.ERR_OVERLOADED,
                               "session is closed: dispatch refused")
            self.counters["solves"] += 1
            if not self._resident(kind, o):
                _M_SOLVES.labels(path="uncached").inc()
                return self._solve_uncached(kind, b, x0, o, stats)
            _M_SOLVES.labels(path="aot").inc()
            entry = self._get_executable(kind, b, x0, o)
            with self.tracer.span("solve"):
                # o rides along per dispatch: tolerance VALUES are
                # rebound on the device (only the static fields are
                # fixed with the resident solve)
                return entry.solve(b, x0=x0, stats=stats, options=o)

    def _solve_uncached(self, kind, b, x0, o, stats):
        self.counters["uncached_solves"] += 1
        extra = {}
        if kind == "cg-recycled":
            # the HOST operator's matvec (unpadded, unpermuted)
            extra["matvec"] = (self.A.matvec
                               if hasattr(self.A, "matvec") else None)
        with self.tracer.span("solve"):
            if self._ss is not None:
                from acg_torch.solvers.cg_dist import (
                    cg_dist, cg_pipelined_deep_dist, cg_pipelined_dist,
                    cg_recycled_dist, cg_sstep_dist)

                fn = {"cg": cg_dist, "cg-pipelined": cg_pipelined_dist,
                      "cg-pipelined-deep": cg_pipelined_deep_dist,
                      "cg-sstep": cg_sstep_dist,
                      "cg-recycled": cg_recycled_dist}[kind]
                if kind != "cg-recycled":
                    extra["loop"] = self.loop
                return fn(self._ss, b, x0=x0, options=o, stats=stats,
                          **extra)
            from acg_torch.solvers.cg import (cg, cg_pipelined,
                                              cg_pipelined_deep,
                                              cg_recycled, cg_sstep)

            fn = {"cg": cg, "cg-pipelined": cg_pipelined,
                  "cg-pipelined-deep": cg_pipelined_deep,
                  "cg-sstep": cg_sstep, "cg-recycled": cg_recycled}[kind]
            if kind != "cg-recycled":
                extra["loop"] = self.loop
            return fn(self._dev, b, x0=x0, options=o, dtype=self.dtype,
                      fmt=self.fmt, mat_dtype=self.mat_dtype,
                      stats=stats, device=self.device, **extra)

    # -- lifecycle ------------------------------------------------------

    def kill(self) -> None:
        """Mark this session DEAD (idempotent): every later dispatch
        fails with a transient-classified ``ERR_FAULT_DETECTED``."""
        self.dead = True

    def close(self) -> None:
        """Release this session's resident solves (idempotent): their
        buffers and captures are freed.  The prepared operator itself may
        be shared through the process-level cache (``share_prepared``)
        and is left to it; a closed session refuses further dispatches
        with a deterministic ``ERR_OVERLOADED``."""
        with self._lock:
            for entry in self._exec.values():
                entry.close()
            self._exec.clear()
            self._closed = True
        gc.collect()

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        """Session counters snapshot: cache traffic, build/solve walls
        (from the span timeline), cached signatures (the JAX package's
        keys; ``prep`` and ``recycle`` are null in this port)."""
        tr = self.tracer
        return {
            "nrows": int(self.nrows),
            "nparts": int(self.nparts),
            "dtype": self.dtype.name,
            "cache": {
                "executable": dict(self.counters["executable"]),
                "prepared": dict(self.counters["prepared"]),
                "prep": None,
            },
            "signatures": len(self._exec),
            "solves": self.counters["solves"],
            "uncached_solves": self.counters["uncached_solves"],
            "recycle": None,
            "walls": {name: tr.total(name)
                      for name in ("read", "partition", "operator-build",
                                   "compile", "solve")},
        }


def clear_prepared_cache() -> None:
    """Drop every prepared operator (tests; also frees device buffers the
    cache pins)."""
    with _PREPARED_LOCK:
        _PREPARED.clear()
