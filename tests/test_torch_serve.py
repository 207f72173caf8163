"""The serve path of the port (``acg_torch/serve/``, the resident solves
of ``acg_torch.solvers.cg.aot_step`` and ``cg_dist.aot_step``) against
the JAX package's (``acg_tpu.serve``) and against the port's ordinary
solvers, on the CPU.

Held against ``acg_tpu.serve`` on ``poisson2d_5pt(12)``,
``poisson2d_5pt(16)`` in 4 parts and ``random_spd(200)``, f64, rtol
1e-10, right-hand sides from ``default_rng``: iteration counts equal
(the deep-pipelined solver on ``random_spd(200)``: within one, as the
port's deep parity tests hold it, ``tests/test_torch_deep.py``), and x
within the port's parity tolerances: relative 1e-8 for classic and
pipelined CG (``tests/test_torch_cg.py``, ``test_torch_pipelined.py``),
1e-9 for the deep solver (``tests/test_torch_deep.py``).  Within the
port, bit for bit: a warm resident solve against the ordinary solver,
rebound tolerances, coalesced against sequential through the same
bucket.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.serve import Session as JSession
from acg_tpu.serve import SolverService as JService
from acg_tpu.sparse import poisson as jpoisson
from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.serve import Session, SolverService
from acg_torch.solvers.cg import (aot_step, build_device_operator, cg,
                                  cg_pipelined, cg_pipelined_deep)
from acg_torch.solvers.cg_dist import aot_step as dist_aot_step
from acg_torch.solvers.cg_dist import (build_sharded, cg_dist,
                                       cg_pipelined_dist)
from acg_torch.sparse import poisson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RTOL = 1e-10
DEEP = dict(pipeline_depth=2, replace_every=50)
KINDS = {"cg": {}, "cg-pipelined": {}, "cg-pipelined-deep": DEEP}
# x against acg_tpu, relative (the port's parity tests' tolerances)
X_TOL = {"cg": 1e-8, "cg-pipelined": 1e-8, "cg-pipelined-deep": 1e-9}
SYSTEMS = {"p2d-12": ("poisson2d_5pt", (12,), 1),
           "p2d-16-x4": ("poisson2d_5pt", (16,), 4),
           "spd-200": ("random_spd", (200,), 1)}


def _rhs(n, k, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n) for _ in range(k)]


def _bits(r1, r2):
    assert r1.niterations == r2.niterations
    assert r1.converged == r2.converged
    assert r1.rnrm2 == r2.rnrm2
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))
    np.testing.assert_array_equal(np.asarray(r1.residual_history),
                                  np.asarray(r2.residual_history))


def _port_session(A, nparts=1, **kw):
    kw.setdefault("share_prepared", False)
    place = (dict(devices=["cpu"] * nparts) if nparts > 1
             else dict(device="cpu"))
    return Session(A, nparts=nparts, **place, **kw)


# ---------------------------------------------------------------------------
# against acg_tpu.serve


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_session_and_service_match_acg_tpu(system, kind):
    """One request through each package's Session, then four coalesced
    through each package's SolverService (bucket 4): the same counts
    and x within the stated tolerance."""
    fn, args, nparts = SYSTEMS[system]
    Aj = getattr(jpoisson, fn)(*args)
    At = getattr(poisson, fn)(*args)
    o = dict(maxits=2000, residual_rtol=RTOL, **KINDS[kind])
    js = JSession(Aj, nparts=nparts, options=JOptions(**o), prep_cache=None,
                  share_prepared=False)
    ts = _port_session(At, nparts, options=SolverOptions(**o))
    bs = _rhs(At.nrows, 4)
    slack = 1 if (kind == "cg-pipelined-deep"
                  and system == "spd-200") else 0
    pairs = [(js.solve(bs[0], solver=kind), ts.solve(bs[0], solver=kind))]
    jsv = JService(js, solver=kind, max_batch=4, buckets=(4,))
    tsv = SolverService(ts, solver=kind, max_batch=4, buckets=(4,))
    jr = [r.response() for r in [jsv.submit(b) for b in bs]]
    tr = [r.response() for r in [tsv.submit(b) for b in bs]]
    assert all(r.ok and r.batch_size == 4 for r in jr + tr)
    pairs += [(a.result, c.result) for a, c in zip(jr, tr)]
    for rj, rt in pairs:
        assert abs(rj.niterations - rt.niterations) <= slack
        err = np.linalg.norm(rt.x - rj.x) / np.linalg.norm(rj.x)
        assert err <= X_TOL[kind]
    assert ts.counters["executable"]["misses"] == (
        2 if kind != "cg-pipelined-deep" or nparts == 1 else 0)


def test_summary_stats_and_health_keys_match_acg_tpu():
    """ServeResponse.summary(), SolverService.stats() (with the session's
    stats) and health() carry the JAX package's keys."""
    o = dict(maxits=400, residual_rtol=1e-8)
    js = JSession(jpoisson.poisson2d_5pt(8), options=JOptions(**o),
                  prep_cache=None, share_prepared=False)
    ts = _port_session(poisson.poisson2d_5pt(8), options=SolverOptions(**o))
    jsv, tsv = JService(js, max_batch=2), SolverService(ts, max_batch=2)
    b = np.ones(64)
    jr, tr = jsv.solve(b), tsv.solve(b)
    assert set(tr.summary()) == set(jr.summary())
    jst, tst = jsv.stats(), tsv.stats()
    assert set(tst) == set(jst)
    assert set(tst["session"]) == set(jst["session"])
    assert set(tst["session"]["walls"]) == set(jst["session"]["walls"])
    assert set(tst["admission"]) == set(jst["admission"])
    assert set(tsv.health()) == set(jsv.health())
    assert set(tr.audit) == set(jr.audit)
    assert set(tr.audit["session"]) == set(jr.audit["session"])
    assert set(tr.audit["admission"]) == set(jr.audit["admission"])
    # the blocks this port cannot fill are null; the document is the
    # port's one stats schema, capabilities filled
    for block in ("resilience", "contract", "fleet"):
        assert tr.audit[block] is None
    assert tr.audit["introspection"] == {
        "comm_audit": None, "roofline": None, "halo_wire": None}
    assert tr.audit["capabilities"]["version"]
    from acg_torch.obs.export import SCHEMA, validate_stats_document
    assert tr.audit["schema"] == SCHEMA
    assert validate_stats_document(tr.audit) == []
    json.dumps(tr.audit, allow_nan=False)


def test_graph_hashes_match_acg_tpu():
    from acg_tpu.partition.cache import graph_hashes as jhashes
    from acg_torch.partition.cache import graph_hashes

    for n in (8, 12):
        assert tuple(graph_hashes(poisson.poisson2d_5pt(n))) == \
            tuple(jhashes(jpoisson.poisson2d_5pt(n)))


def test_serve_metric_names_match_acg_tpu():
    """Every acg_serve_* family the port declares is the JAX package's,
    with the same kind and labels."""
    import acg_tpu.serve  # noqa: F401  (declares the JAX families)
    from acg_tpu.obs.metrics import registry as jregistry
    from acg_torch.obs.metrics import registry

    names = [n for n in registry()._families if n.startswith("acg_serve")]
    assert {"acg_serve_executable_cache_total",
            "acg_serve_prepared_operator_total",
            "acg_serve_compile_seconds",
            "acg_serve_session_solves_total", "acg_serve_queue_depth",
            "acg_serve_batches_total", "acg_serve_requests_total",
            "acg_serve_breaker_transitions_total"} <= set(names)
    for name in names:
        mine, theirs = registry().get(name), jregistry().get(name)
        assert theirs is not None, name
        assert (mine.kind, mine.labelnames) == (theirs.kind,
                                                theirs.labelnames)


def test_cli_serve_matches_acg_tpu_cli(tmp_path):
    """``--serve`` in both CLIs on one file of commands: the same JSON
    lines' keys, the same iteration counts and buckets, the same refused
    line for a right-hand side of the wrong length, exit 1 (a request
    failed)."""
    from acg_torch.io.mtxfile import MtxFile, vector_to_mtx, write_mtx

    A = poisson.poisson2d_5pt(12)
    r, c, v = A.to_coo()
    path = str(tmp_path / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    write_mtx(str(tmp_path / "short.mtx"), vector_to_mtx(np.ones(5)))
    cmds = tmp_path / "cmds.txt"
    cmds.write_text(f"solve\nbatch 3\nsolve {tmp_path / 'short.mtx'}\n"
                    "stats\nhealth\nquit\nsolve\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    runs = {}
    for module, extra in (("acg_torch.cli", ["--device", "cpu"]),
                          ("acg_tpu.cli", [])):
        out = subprocess.run(
            [sys.executable, "-m", module, path, "--serve", str(cmds),
             "--manufactured-solution", "--max-iterations", "500",
             *extra], capture_output=True, text=True, env=env,
            timeout=300, cwd=REPO)
        assert out.returncode == 1, out.stdout + out.stderr
        runs[module] = [json.loads(ln) for ln in out.stdout.splitlines()
                        if ln.startswith("{")]
    port, ref = runs["acg_torch.cli"], runs["acg_tpu.cli"]
    assert len(port) == len(ref) == 7
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        for key in ("ok", "status", "iterations", "batched", "bucket",
                    "cache_hit", "line"):
            assert p.get(key) == r.get(key), key
    assert [d.get("bucket") for d in port[:4]] == [1, 4, 4, 4]


# ---------------------------------------------------------------------------
# within the port, bit for bit


_RESIDENT = [(k, B) for k in sorted(KINDS) for B in (0, 3)]


@pytest.mark.parametrize("kind, B", _RESIDENT)
def test_warm_resident_solve_equals_ordinary(kind, B):
    """A resident solve, dispatch after dispatch on new right-hand sides
    (each system of a batch its own), gives the ordinary solver's bits."""
    A = poisson.poisson2d_5pt(12)
    o = SolverOptions(maxits=400, residual_rtol=RTOL, check_every=3,
                      **KINDS[kind])
    plain = {"cg": cg, "cg-pipelined": cg_pipelined,
             "cg-pipelined-deep": cg_pipelined_deep}[kind]
    shape = (B, A.nrows) if B else (A.nrows,)
    rng = np.random.default_rng(11)
    ex = aot_step(A, np.zeros(shape), options=o, solver=kind, device="cpu")
    assert ex.kind == kind and ex.shape == shape
    for _ in range(3):
        b = rng.standard_normal(shape)
        _bits(ex.solve(b), plain(A, b, options=o, device="cpu"))


@pytest.mark.parametrize("B", [0, 3])
def test_resident_diff_threshold_rebinds_with_x0(B):
    """The diff criterion's threshold follows each dispatch's |x0| (per
    system for a batch): a device buffer, not a value frozen at the
    first dispatch; and an x0 of zero turns it off, as in the ordinary
    solver."""
    A = poisson.poisson2d_5pt(12)
    o = SolverOptions(maxits=400, residual_rtol=0.0, diffrtol=1e-6,
                      check_every=2)
    shape = (B, A.nrows) if B else (A.nrows,)
    rng = np.random.default_rng(13)
    ex = aot_step(A, np.zeros(shape), x0=np.zeros(shape), options=o,
                  device="cpu")
    def outcome(solve):
        # x0 = 0 leaves no criterion: the solve runs to maxits and raises
        try:
            return solve()
        except AcgError as e:
            assert e.status == Status.ERR_NOT_CONVERGED
            return e.result

    for scale in (1.0, 1e-3, 0.0):
        b, x0 = rng.standard_normal(shape), scale * rng.standard_normal(shape)
        got = outcome(lambda: ex.solve(b, x0=x0))
        _bits(got, outcome(lambda: cg(A, b, x0=x0, options=o,
                                      device="cpu")))
        assert got.niterations < o.maxits or scale == 0.0


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("B", [0, 3])
def test_warm_resident_solve_on_shards_equals_ordinary(pipelined, B):
    A = poisson.poisson2d_5pt(16)
    ss = build_sharded(A, nparts=4, devices=["cpu"] * 4)
    o = SolverOptions(maxits=400, residual_rtol=RTOL, check_every=2)
    kind = "cg-pipelined" if pipelined else "cg"
    plain = cg_pipelined_dist if pipelined else cg_dist
    shape = (B, A.nrows) if B else (A.nrows,)
    rng = np.random.default_rng(12)
    ex = dist_aot_step(ss, np.zeros(shape), options=o, solver=kind)
    for _ in range(3):
        b = rng.standard_normal(shape)
        _bits(ex.solve(b), plain(ss, b, options=o))


@pytest.mark.parametrize("kind", ["cg", "cg-pipelined"])
def test_tolerance_values_rebind(kind):
    """A loose rtol and then a tight one on the same resident solve: the
    tight one equals the ordinary solve at that rtol, and both ran on
    one cache entry."""
    A = poisson.poisson2d_5pt(12)
    b = np.ones(A.nrows)
    s = _port_session(A, options=SolverOptions(maxits=400))
    plain = cg if kind == "cg" else cg_pipelined
    loose = s.solve(b, solver=kind,
                    options=SolverOptions(maxits=400, residual_rtol=1e-2))
    o = SolverOptions(maxits=400, residual_rtol=1e-12)
    tight = s.solve(b, solver=kind, options=o)
    assert s.counters["executable"] == {
        "hits": 1, "misses": 1,
        "compile_seconds": s.counters["executable"]["compile_seconds"]}
    assert loose.niterations < tight.niterations
    _bits(tight, plain(A, b, options=o, device="cpu"))
    # maxits is static: a new entry
    s.solve(b, solver=kind,
            options=SolverOptions(maxits=300, residual_rtol=1e-8))
    assert s.counters["executable"]["misses"] == 2


def test_static_field_mismatch_raises():
    A = poisson.poisson2d_5pt(8)
    o = SolverOptions(maxits=200, residual_rtol=1e-8)
    ex = aot_step(A, np.zeros(A.nrows), options=o, device="cpu")
    for bad in (SolverOptions(maxits=201, residual_rtol=1e-8),
                SolverOptions(maxits=200, residual_rtol=1e-8,
                              check_every=2),
                SolverOptions(maxits=200, residual_rtol=0.0),
                SolverOptions(maxits=200, residual_rtol=1e-8,
                              residual_atol=1e-3)):
        with pytest.raises(AcgError) as ei:
            ex.solve(np.ones(A.nrows), options=bad)
        assert ei.value.status == Status.ERR_INVALID_VALUE
    with pytest.raises(AcgError) as ei:
        ex.solve(np.ones((2, A.nrows)))
    assert ei.value.status == Status.ERR_INVALID_VALUE


def test_x0_and_no_x0_are_distinct_entries():
    A = poisson.poisson2d_5pt(12)
    o = SolverOptions(maxits=400, residual_rtol=RTOL)
    s = _port_session(A, options=o)
    b = np.ones(A.nrows)
    x0 = np.random.default_rng(1).standard_normal(A.nrows)
    s.solve(b)
    r = s.solve(b, x0=x0)
    assert s.counters["executable"]["misses"] == 2
    assert s.has_executable("cg", 1, o, has_x0=True)
    _bits(r, cg(A, b, x0=x0, options=o, device="cpu"))
    s.solve(b, x0=x0)
    assert s.counters["executable"]["hits"] == 1


def test_warm_session_opens_only_a_solve_span():
    A = poisson.poisson2d_5pt(12)
    s = _port_session(A, options=SolverOptions(maxits=400))
    s.solve(np.ones(A.nrows))
    n = len(s.tracer.spans)
    s.solve(np.ones(A.nrows))
    assert [sp.name for sp in s.tracer.spans[n:]] == ["solve"]
    assert set(s.stats()["walls"]) == {"read", "partition",
                                       "operator-build", "compile",
                                       "solve"}


@pytest.mark.parametrize("kind, nparts", [
    ("cg", 1), ("cg-pipelined", 1), ("cg-pipelined-deep", 1), ("cg", 4),
    ("cg-pipelined", 4)])
def test_coalesced_equals_sequential(kind, nparts):
    """K submitted together through the queue == K submitted one at a
    time through the SAME bucket, bit for bit, in ONE dispatch; each
    demuxed history ends at its own exit."""
    A = poisson.poisson2d_5pt(16 if nparts > 1 else 12)
    o = SolverOptions(maxits=400, residual_rtol=1e-8, **KINDS[kind])
    s = _port_session(A, nparts, options=o)
    svc = SolverService(s, solver=kind, max_batch=4, buckets=(4,))
    bs = _rhs(A.nrows, 4, seed=3)
    seq = [svc.solve(b).result for b in bs]
    batches0 = svc.queue.counters["batches"]
    resps = [r.response() for r in [svc.submit(b) for b in bs]]
    assert svc.queue.counters["batches"] == batches0 + 1
    for resp, r_seq in zip(resps, seq):
        assert resp.ok and resp.batch_size == 4
        _bits(resp.result, r_seq)
        assert len(resp.result.residual_history) == \
            resp.result.niterations + 1


def test_session_routes_uncached_kinds():
    """s-step, recycled, the deep loop over shards and segmented solves
    run the ordinary functions, counted as uncached."""
    A = poisson.poisson2d_5pt(12)
    s = _port_session(A, options=SolverOptions(maxits=400))
    r = s.solve(np.ones(A.nrows), solver="cg-sstep",
                options=SolverOptions(maxits=400, sstep=2))
    assert r.converged
    s.solve(np.ones(A.nrows), solver="acg-recycled")
    seg = SolverOptions(maxits=400, segment_iters=7)
    _bits(s.solve(np.ones(A.nrows), options=seg),
          cg(A, np.ones(A.nrows), options=seg, device="cpu"))
    assert s.counters["uncached_solves"] == 3
    assert s.counters["executable"]["misses"] == 0
    sd = _port_session(poisson.poisson2d_5pt(16), 4,
                       options=SolverOptions(maxits=400, **DEEP))
    sd.solve(np.ones(256), solver="cg-pipelined-deep")
    assert sd.counters["uncached_solves"] == 1


def test_prepared_operator_cache_shares_across_sessions():
    from acg_torch.serve.session import clear_prepared_cache

    clear_prepared_cache()
    try:
        A = poisson.poisson2d_5pt(12)
        s1 = Session(A, device="cpu")
        s2 = Session(A, device="cpu")
        assert s2.counters["prepared"] == {"hits": 1, "misses": 0}
        assert s2.operator is s1.operator
        A2 = poisson.poisson2d_5pt(12)
        A2.vals = A2.vals * 2.0
        assert Session(A2, device="cpu").counters["prepared"]["misses"] == 1
    finally:
        clear_prepared_cache()


def test_closed_session_refuses_and_frees():
    A = poisson.poisson2d_5pt(8)
    s = _port_session(A)
    s.solve(np.ones(A.nrows))
    ex = s.executable(solver="cg", nrhs=1)
    s.close()
    assert s.stats()["signatures"] == 0
    with pytest.raises(AcgError) as ei:
        s.solve(np.ones(A.nrows))
    assert ei.value.status == Status.ERR_OVERLOADED
    with pytest.raises(AcgError):
        ex.solve(np.ones(A.nrows))


# ---------------------------------------------------------------------------
# refusals: each raises ERR_NOT_SUPPORTED


def _refusals():
    A = poisson.poisson2d_5pt(8)
    o = SolverOptions(maxits=100)

    def session(**kw):
        return Session(A, device="cpu", share_prepared=False, **kw)

    def service(**kw):
        return SolverService(session(), **kw)

    return {
        "recycle": lambda: session(recycle=True),
        "recycle-state": lambda: session().recycle_state,
        "prep-cache-dir": lambda: session(prep_cache="/nonexistent"),
        # epsilon shifts a host CSR matrix: a built operator takes none
        "epsilon": lambda: Session(
            build_device_operator(A, device="cpu"), device="cpu",
            share_prepared=False, epsilon=1e-3),
        # the counted audit covers the loops, not the recycled solver's
        # host deflation
        "audit": lambda: session().audit(solver="cg-recycled"),
        "fault": lambda: session().solve(np.ones(64), fault=object()),
        "resilient": lambda: service(resilient=True),
        "warm-start": lambda: service(warm_start=True),
        "inject-fault": lambda: service().inject_fault(object()),
        "fleet": lambda: service(replica_id="r0"),
        "fleet-meta": lambda: service().submit(np.ones(64),
                                               fleet_meta={"hops": 1}),
        "host-solver": lambda: session().solve(np.ones(64),
                                               solver="petsc"),
        "aot-segment": lambda: aot_step(
            A, np.ones(64), options=SolverOptions(segment_iters=5),
            device="cpu"),
        "aot-sstep": lambda: aot_step(A, np.ones(64), options=o,
                                      solver="cg-sstep", device="cpu"),
        "aot-deep-shards": lambda: dist_aot_step(
            build_sharded(A, nparts=4, devices=["cpu"] * 4), np.ones(64),
            options=SolverOptions(pipeline_depth=2),
            solver="cg-pipelined-deep"),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_refusals_raise_not_supported(name):
    with pytest.raises(AcgError) as ei:
        _refusals()[name]()
    assert ei.value.status == Status.ERR_NOT_SUPPORTED


@pytest.mark.parametrize("flags", [
    ["--replicas", "2"], ["--elastic"], ["--min-replicas", "1"],
    ["--max-replicas", "3"], ["--slo-p99-ms", "50"], ["--obs-port", "0"],
    ["--resilient"]])
def test_cli_refuses_unported_serve_flags(tmp_path, flags, capsys):
    from acg_torch import cli
    from acg_torch.io.mtxfile import MtxFile, write_mtx

    A = poisson.poisson2d_5pt(8)
    r, c, v = A.to_coo()
    path = str(tmp_path / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    cmds = tmp_path / "cmds.txt"
    cmds.write_text("solve\n")
    rc = cli.main([path, "--device", "cpu", "--serve", str(cmds), *flags])
    assert rc == 1
    assert "not ported" in capsys.readouterr().err
