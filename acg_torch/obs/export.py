"""Machine-readable solver stats (``--output-stats-json``; the port of
``acg_tpu.obs.export``).

One JSON document a solve: everything the printed stats block holds
(ref acg/cg.c:665-828 ``acgsolver_fwrite``), the convergence history,
the host phase spans, the capability matrix ``--version`` prints, and the
``--explain`` introspection (the counted CommAudit of
``acg_torch/obs/audit.py`` and the roofline of ``obs/roofline.py``, with
the measured rate priced against it).  The serve layer's per-request
audit documents are the same document with its ``session`` and
``admission`` blocks filled.

The schema is ``acg-torch-stats/1``: the top-level keys of the JAX
package's ``acg-tpu-stats/13``.  Its blocks the port does not fill,
``resilience``, ``contract`` and ``fleet``, are null; ``warmstart`` is
null but for a serve request that carried its own initial guess.  The
result and stats blocks add the port's loop fields (``loop``; captures,
replays, blocks run open, the s-step blocks).  :func:`validate_stats_document`
is the one definition of the schema: the CLI's writer, the serve layer
and the tests call it.  Non-finite floats (the ``inf`` of a disabled
criterion) serialize as null.
"""

from __future__ import annotations

import dataclasses
import json

SCHEMA = "acg-torch-stats/1"

# the seven per-op counter blocks of the reference's breakdown table
OP_NAMES = ("gemv", "dot", "nrm2", "axpy", "copy", "allreduce", "halo")

# the blocks of the JAX document the port never fills
NULL_BLOCKS = ("resilience", "contract", "fleet")


def _finite(v):
    """Non-finite floats become None (strict JSON)."""
    if isinstance(v, float) and not (v == v and abs(v) != float("inf")):
        return None
    return v


def sanitize_tree(obj):
    """Map non-finite floats to None through dicts and lists."""
    if isinstance(obj, dict):
        return {k: sanitize_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_tree(v) for v in obj]
    return _finite(obj)


def op_counters_to_dict(c) -> dict:
    return {"t": _finite(float(c.t)), "n": int(c.n),
            "bytes": int(c.bytes), "flops": int(c.flops)}


def stats_to_dict(st) -> dict:
    """A :class:`~acg_torch.solvers.base.SolveStats`: the JAX package's
    fields and the loop's (CUDA-graph captures, replays, blocks run
    open, capture seconds, s-step blocks)."""
    return {"nsolves": int(st.nsolves),
            "ntotaliterations": int(st.ntotaliterations),
            "niterations": int(st.niterations),
            "nflops": int(st.nflops),
            "tsolve": _finite(float(st.tsolve)),
            "nhalomsgs": int(st.nhalomsgs),
            "iterations_per_sec": _finite(float(st.iterations_per_sec())),
            "per_op": {nm: op_counters_to_dict(getattr(st, nm))
                       for nm in OP_NAMES},
            "ncaptures": int(st.ncaptures), "nreplays": int(st.nreplays),
            "nloopopen": int(st.nloopopen),
            "tcapture": _finite(float(st.tcapture)),
            "nsstepblocks": int(st.nsstepblocks)}


def result_to_dict(res) -> dict:
    """A :class:`~acg_torch.solvers.base.SolveResult` without its
    solution vector.  A multi-RHS result (``nrhs`` > 1) adds the
    per-system arrays and one history a system, each trimmed to that
    system's own iterations + 1."""
    hist = res.residual_history
    nrhs = int(res.nrhs or 1)
    d = {"converged": bool(res.converged),
         "niterations": int(res.niterations),
         "bnrm2": _finite(float(res.bnrm2)),
         "r0nrm2": _finite(float(res.r0nrm2)),
         "rnrm2": _finite(float(res.rnrm2)),
         "x0nrm2": _finite(float(res.x0nrm2)),
         "dxnrm2": _finite(float(res.dxnrm2)),
         "relative_residual": _finite(float(res.relative_residual)),
         "fpexcept": str(res.fpexcept),
         "status": getattr(res.status, "name", None)
         or ("SUCCESS" if res.converged else "ERR_NOT_CONVERGED"),
         "operator_format": str(res.operator_format),
         "kernel": str(res.kernel), "loop": str(res.loop),
         "nrhs": nrhs}
    if res.kernel_note:
        d["kernel_note"] = str(res.kernel_note)
    if nrhs > 1:
        iters = [int(v) for v in res.iterations_per_system]
        d["iterations_per_system"] = iters
        d["rnrm2_per_system"] = [_finite(float(v))
                                 for v in res.rnrm2_per_system]
        if res.r0nrm2_per_system is not None:
            d["r0nrm2_per_system"] = [_finite(float(v))
                                      for v in res.r0nrm2_per_system]
        d["converged_per_system"] = [bool(v)
                                     for v in res.converged_per_system]
        d["residual_history"] = (
            None if hist is None
            else [[_finite(float(v)) for v in hist[i][: iters[i] + 1]]
                  for i in range(nrhs)])
    else:
        if hist is not None and getattr(hist, "ndim", 1) == 2:
            hist = hist[0]
        d["residual_history"] = (None if hist is None
                                 else [_finite(float(v)) for v in hist])
    return d


def options_to_dict(options) -> dict:
    return {k: _finite(v) for k, v in dataclasses.asdict(options).items()}


def capability_info() -> dict:
    """The capability matrix ``--version`` prints (the reference's
    feature report, cuda/acg-cuda.c:382-440), as data: the port's
    version, torch and its CUDA, the devices, no native host library,
    scipy.  Every probe degrades to None rather than raising."""
    from acg_torch import __version__

    info: dict = {"version": __version__, "torch": None, "cuda": None,
                  "platforms": [], "device_kinds": [], "ndevices": 0,
                  "processes": 1, "native_host_library": False,
                  "scipy": None}
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        info["platforms"] = ["cpu"]
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            info["platforms"].append("cuda")
            info["ndevices"] = n
            info["device_kinds"] = sorted({torch.cuda.get_device_name(i)
                                           for i in range(n)})
    except (ImportError, RuntimeError) as e:
        info["backend_error"] = str(e)
    try:
        import scipy

        info["scipy"] = scipy.__version__
    except ImportError:
        pass
    return info


def build_stats_document(*, solver: str, options, res, stats,
                         nunknowns: int | None = None, nparts: int = 1,
                         phases: list[dict] | None = None,
                         capabilities: dict | None = None,
                         introspection: dict | None = None,
                         session: dict | None = None,
                         admission: dict | None = None,
                         metrics: dict | None = None,
                         warmstart: dict | None = None) -> dict:
    """The whole ``acg-torch-stats/1`` document of one solve.
    ``introspection``: the ``--explain`` payload (``comm_audit``,
    ``roofline``, ``halo_wire``, each null when not asked for);
    ``session`` / ``admission``: a serve request's blocks; ``metrics``:
    the metrics registry's snapshot (null when it is off);
    ``warmstart``: a serve request's initial-guess provenance."""
    intro = introspection or {}
    return {
        "schema": SCHEMA,
        "solver": str(solver),
        "nunknowns": None if nunknowns is None else int(nunknowns),
        "nparts": int(nparts),
        "options": options_to_dict(options),
        "result": result_to_dict(res),
        "stats": stats_to_dict(stats),
        "phases": list(phases) if phases is not None else [],
        "capabilities": (capability_info() if capabilities is None
                         else capabilities),
        "introspection": sanitize_tree(
            {k: intro.get(k) for k in ("comm_audit", "roofline",
                                       "halo_wire")}),
        "resilience": None,
        "session": sanitize_tree(session),
        "contract": None,
        "admission": sanitize_tree(admission),
        "metrics": sanitize_tree(metrics),
        "fleet": None,
        "warmstart": sanitize_tree(warmstart),
    }


def write_stats_json(path: str, doc: dict) -> None:
    """Write ``doc`` to ``path``, after checking it: a document this
    module writes always passes its own validator."""
    problems = validate_stats_document(doc)
    if problems:
        raise ValueError("refusing to write non-conforming stats "
                         "document: " + "; ".join(problems))
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, allow_nan=False)
        f.write("\n")


def load_stats_document(path: str) -> dict:
    """Read and check a ``--output-stats-json`` file; ``ValueError``
    names every problem."""
    with open(path) as f:
        doc = json.load(f)
    problems = validate_stats_document(doc)
    if problems:
        raise ValueError(f"{path}: " + "; ".join(problems))
    return doc


def _check(problems, cond: bool, msg: str) -> None:
    if not cond:
        problems.append(msg)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def validate_stats_document(doc) -> list[str]:
    """The problems of a stats document (empty: it conforms)."""
    p: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    _check(p, doc.get("schema") == SCHEMA,
           f"schema is {doc.get('schema')!r}, expected {SCHEMA!r}")
    for key, typ in (("solver", str), ("nparts", int), ("options", dict),
                     ("result", dict), ("stats", dict), ("phases", list)):
        _check(p, isinstance(doc.get(key), typ),
               f"missing or mistyped top-level key {key!r}")
    if p:
        return p
    opts = doc["options"]
    for key in ("maxits", "diffatol", "diffrtol", "residual_atol",
                "residual_rtol", "check_every", "sstep"):
        _check(p, _is_num(opts.get(key)),
               f"options.{key} missing or not numeric")
    _validate_result(p, doc["result"])
    _validate_stats(p, doc["stats"])
    for i, sp in enumerate(doc["phases"]):
        if not isinstance(sp, dict):
            p.append(f"phases[{i}] is not an object")
            continue
        _check(p, isinstance(sp.get("name"), str),
               f"phases[{i}].name missing")
        for f in ("start", "duration"):
            v = sp.get(f, "missing")
            _check(p, v is None or _is_num(v),
                   f"phases[{i}].{f} missing or not numeric")
    cap = doc.get("capabilities", "missing")
    _check(p, isinstance(cap, dict)
           and isinstance(cap.get("version"), str),
           "capabilities missing or without its version")
    _validate_introspection(p, doc.get("introspection", "missing"))
    for key in NULL_BLOCKS:
        _check(p, key in doc and doc[key] is None,
               f"{key} missing or not null (the port fills no {key} "
               "block)")
    _validate_session(p, doc.get("session", "missing"))
    _validate_admission(p, doc.get("admission", "missing"),
                        doc.get("session"))
    _validate_metrics(p, doc.get("metrics", "missing"))
    _validate_warmstart(p, doc.get("warmstart", "missing"))
    return p


def _validate_result(p: list, res: dict) -> None:
    _check(p, isinstance(res.get("converged"), bool),
           "result.converged missing or not bool")
    _check(p, _is_int(res.get("niterations")),
           "result.niterations missing or not int")
    for key in ("bnrm2", "r0nrm2", "rnrm2"):
        v = res.get(key, "missing")
        _check(p, v is None or _is_num(v),
               f"result.{key} missing or not numeric")
    _check(p, isinstance(res.get("status"), str),
           "result.status missing or not a string")
    nrhs = res.get("nrhs", "missing")
    _check(p, _is_int(nrhs) and nrhs >= 1,
           "result.nrhs missing or not a positive int")
    nrhs = nrhs if _is_int(nrhs) else 1
    hist = res.get("residual_history", "missing")
    _check(p, hist is None or isinstance(hist, list),
           "result.residual_history missing or not a list/null")
    if nrhs > 1:
        iters = res.get("iterations_per_system")
        for key, ok in (("iterations_per_system", _is_int),
                        ("rnrm2_per_system",
                         lambda x: x is None or _is_num(x)),
                        ("converged_per_system",
                         lambda x: isinstance(x, bool))):
            arr = res.get(key)
            if not isinstance(arr, list) or len(arr) != nrhs:
                p.append(f"result.{key} missing or not a length-nrhs "
                         "list")
            else:
                _check(p, all(ok(x) for x in arr),
                       f"result.{key} has mistyped entries")
        good = (isinstance(iters, list) and len(iters) == nrhs
                and all(_is_int(x) for x in iters))
        if good:
            _check(p, res.get("niterations") == max(iters),
                   "result.niterations != max(iterations_per_system)")
        if isinstance(hist, list):
            _check(p, len(hist) == nrhs,
                   f"residual_history has {len(hist)} rows, expected "
                   f"nrhs = {nrhs}")
            for i, row in enumerate(hist):
                if not isinstance(row, list):
                    p.append(f"residual_history[{i}] is not a list")
                    continue
                _check(p, all(x is None or _is_num(x) for x in row),
                       f"residual_history[{i}] has non-numeric entries")
                if good and i < nrhs:
                    _check(p, len(row) == iters[i] + 1,
                           f"residual_history[{i}] has {len(row)} "
                           f"entries, expected {iters[i] + 1}")
    elif isinstance(hist, list):
        _check(p, all(v is None or _is_num(v) for v in hist),
               "result.residual_history has non-numeric entries")
        if _is_int(res.get("niterations")):
            _check(p, len(hist) == res["niterations"] + 1,
                   f"residual_history has {len(hist)} entries, expected "
                   f"niterations+1 = {res['niterations'] + 1}")


def _validate_stats(p: list, st: dict) -> None:
    for key in ("nsolves", "ntotaliterations", "niterations", "nflops",
                "ncaptures", "nreplays", "nloopopen"):
        _check(p, _is_int(st.get(key)), f"stats.{key} missing or not int")
    per_op = st.get("per_op")
    if not isinstance(per_op, dict):
        p.append("stats.per_op missing")
        return
    for nm in OP_NAMES:
        blk = per_op.get(nm)
        if not isinstance(blk, dict):
            p.append(f"stats.per_op.{nm} missing")
            continue
        for f in ("t", "n", "bytes", "flops"):
            v = blk.get(f, "missing")
            _check(p, v is None or _is_num(v),
                   f"stats.per_op.{nm}.{f} missing or not numeric")


def _validate_introspection(p: list, intro) -> None:
    """``comm_audit`` (``obs/audit.py`` ``CommAudit.as_dict``),
    ``roofline`` (``obs/roofline.py`` ``RooflineModel.as_dict`` with,
    after a solve, ``measured_iters_per_sec`` and ``roofline_frac``) and
    ``halo_wire``: each required, each null or an object."""
    if not isinstance(intro, dict):
        p.append("introspection missing or not an object")
        return
    for key in ("comm_audit", "roofline", "halo_wire"):
        _check(p, key in intro, f"introspection.{key} missing")
        v = intro.get(key)
        _check(p, v is None or isinstance(v, dict),
               f"introspection.{key} is neither null nor an object")
    audit = intro.get("comm_audit")
    if isinstance(audit, dict):
        ipb = audit.get("iterations_per_body")
        _check(p, _is_int(ipb) and ipb >= 1,
               "comm_audit.iterations_per_body missing or not a positive "
               "int")
        for part in ("per_iteration", "per_solver_iteration", "total"):
            blk = audit.get(part)
            if not isinstance(blk, dict):
                p.append(f"comm_audit.{part} missing")
                continue
            for cls in ("ppermute", "allreduce", "allgather", "rdma"):
                c = blk.get(cls)
                _check(p, isinstance(c, dict)
                       and _is_num(c.get("count", "missing"))
                       and _is_num(c.get("bytes", "missing")),
                       f"comm_audit.{part}.{cls} missing its count or "
                       "bytes")
        for part in ("launches", "host_reads"):
            _check(p, isinstance(audit.get(part), dict),
                   f"comm_audit.{part} missing")
    roof = intro.get("roofline")
    if isinstance(roof, dict):
        for f in ("operator_bytes", "vector_bytes", "bytes_per_iter",
                  "hbm_gbps", "predicted_iters_per_sec"):
            _check(p, _is_num(roof.get(f, "missing")),
                   f"roofline.{f} missing or not numeric")
        _check(p, _is_int(roof.get("nrhs")),
               "roofline.nrhs missing or not int")
        for f in ("measured_iters_per_sec", "roofline_frac"):
            if f in roof:
                _check(p, roof[f] is None or _is_num(roof[f]),
                       f"roofline.{f} not numeric/null")
    hw = intro.get("halo_wire")
    if isinstance(hw, dict):
        for f in ("wire", "dtype"):
            _check(p, isinstance(hw.get(f), str),
                   f"introspection.halo_wire.{f} missing or not a string")
        _check(p, _is_int(hw.get("itemsize")),
               "introspection.halo_wire.itemsize missing or not int")


def _validate_session(p: list, sess) -> None:
    """A serve request's context (``serve/service.py``
    ``SolverService.session_block``), or null."""
    if sess == "missing":
        p.append("session missing (null for a plain solve)")
        return
    if sess is None:
        return
    if not isinstance(sess, dict):
        p.append("session is neither null nor an object")
        return
    for key in ("request_id", "trace_id"):
        v = sess.get(key, "missing")
        _check(p, v is None or isinstance(v, str),
               f"session.{key} missing or not a string/null")
    cache = sess.get("cache")
    if not isinstance(cache, dict):
        p.append("session.cache missing or not an object")
    else:
        _check(p, isinstance(cache.get("executable_hit"), bool),
               "session.cache.executable_hit missing or not bool")
        for fam in ("executable", "prepared"):
            blk = cache.get(fam)
            _check(p, isinstance(blk, dict)
                   and _is_int(blk.get("hits"))
                   and _is_int(blk.get("misses")),
                   f"session.cache.{fam} missing its hits/misses")
    queue = sess.get("queue")
    _check(p, isinstance(queue, dict)
           and _is_num(queue.get("wait_seconds", "missing"))
           and _is_int(queue.get("depth")),
           "session.queue missing its wait_seconds/depth")
    batch = sess.get("batch")
    if not isinstance(batch, dict):
        p.append("session.batch missing or not an object")
    else:
        for f in ("size", "bucket"):
            _check(p, _is_int(batch.get(f)) and batch[f] >= 0,
                   f"session.batch.{f} missing or not a count")
        occ = batch.get("occupancy", "missing")
        _check(p, _is_num(occ) and 0 <= occ <= 1,
               "session.batch.occupancy missing or not in [0, 1]")


_BREAKER_STATES = ("CLOSED", "HALF_OPEN", "OPEN")


def _validate_admission(p: list, adm, session=None) -> None:
    """A serve request's admission path (``serve/admission.py``
    ``AdmissionRecord.as_dict``), or null for a plain solve: a document
    with a session block must carry one."""
    if adm == "missing":
        p.append("admission missing (null for a plain solve)")
        return
    if adm is None:
        _check(p, session is None,
               "admission is null but session is not")
        return
    if not isinstance(adm, dict):
        p.append("admission is neither null nor an object")
        return
    for f in ("shed", "degraded"):
        _check(p, isinstance(adm.get(f), bool),
               f"admission.{f} missing or not bool")
    for f in ("trace_id", "degraded_from"):
        v = adm.get(f, "missing")
        _check(p, v is None or isinstance(v, str),
               f"admission.{f} missing or not a string/null")
    retries = adm.get("retries")
    _check(p, isinstance(retries, dict)
           and _is_int(retries.get("used")) and _is_int(retries.get("max"))
           and isinstance(retries.get("backoff_ms"), list),
           "admission.retries missing its used/max/backoff_ms")
    deadline = adm.get("deadline", "missing")
    _check(p, deadline is None or (
        isinstance(deadline, dict)
        and _is_num(deadline.get("budget_ms", "missing"))
        and isinstance(deadline.get("expired"), bool)),
        "admission.deadline missing or without budget_ms/expired")
    breaker = adm.get("breaker", "missing")
    _check(p, breaker is None or (
        isinstance(breaker, dict)
        and breaker.get("state") in _BREAKER_STATES
        and _is_int(breaker.get("trips"))),
        "admission.breaker missing or without its state/trips")


def _validate_metrics(p: list, m) -> None:
    """The metrics registry's snapshot (``obs/metrics.py``), or null
    when it is off."""
    if m == "missing":
        p.append("metrics missing (null when the registry is off)")
        return
    if m is None:
        return
    if not isinstance(m, dict):
        p.append("metrics is neither null nor an object")
        return
    _check(p, isinstance(m.get("enabled"), bool),
           "metrics.enabled missing or not bool")
    for fam in ("counters", "gauges", "histograms"):
        blk = m.get(fam)
        if not isinstance(blk, dict):
            p.append(f"metrics.{fam} missing or not an object")
            continue
        for name, entry in blk.items():
            _check(p, isinstance(entry, dict)
                   and isinstance(entry.get("values"), list),
                   f"metrics.{fam}.{name} missing its values list")


def _validate_warmstart(p: list, ws) -> None:
    """A serve request's initial-guess provenance, or null."""
    if ws == "missing":
        p.append("warmstart missing (null without a warm start)")
        return
    if ws is None:
        return
    _check(p, isinstance(ws, dict)
           and isinstance(ws.get("enabled"), bool)
           and ws.get("source") in ("client", "recycled", "none")
           and isinstance(ws.get("rejected"), bool),
           "warmstart is neither null nor a provenance block")
