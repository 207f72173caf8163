"""The coalescing queue, the admission layer and the service's laws, run
on both packages' classes (``acg_tpu.serve`` and ``acg_torch.serve``)
as cases of one parametrised test each: padding with replicas of the
last request, close with drain or shed, a dispatch that crashes never
strands a ticket, threaded submissions coalescing into one batch, no
thread left behind, the circuit breaker's transitions, deadlines and
load shedding.  The two packages must give the same outcomes, counters
and keys.  The queue-level scenarios use a dispatcher that solves
nothing (each system's "result" is a function of its right-hand side),
so they hold the queue's law apart from any solver."""

import threading
import time

import numpy as np
import pytest

import acg_tpu.serve.admission as jadmission
import acg_tpu.serve.queue as jqueue
import acg_torch.serve.admission as tadmission
import acg_torch.serve.queue as tqueue
from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JError
from acg_tpu.serve import Session as JSession
from acg_tpu.serve import SolverService as JService
from acg_tpu.solvers.base import SolveResult as JResult
from acg_tpu.solvers.base import SolveStats as JStats
from acg_tpu.sparse import poisson as jpoisson
from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError
from acg_torch.serve import Session, SolverService
from acg_torch.solvers.base import SolveResult, SolveStats
from acg_torch.sparse import poisson

PKGS = {
    "acg_tpu": dict(queue=jqueue, admission=jadmission, Result=JResult,
                    Stats=JStats, Error=JError),
    "acg_torch": dict(queue=tqueue, admission=tadmission,
                      Result=SolveResult, Stats=SolveStats, Error=AcgError),
}


def _fake_dispatch(pkg, log):
    """A dispatcher that records each batch it gets and returns a batched
    result whose system i 'solved' to x = 2 b_i in i + 1 iterations."""
    P = PKGS[pkg]

    def dispatch(bb):
        log.append(np.array(bb, copy=True))
        bb = np.atleast_2d(bb)
        B = bb.shape[0]
        its = np.arange(1, B + 1)
        res = P["Result"](
            x=2.0 * bb, converged=True, niterations=int(its.max()),
            bnrm2=1.0, r0nrm2=1.0, rnrm2=0.0, stats=P["Stats"](niterations=1),
            residual_history=np.ones((B, B + 1)), nrhs=B,
            iterations_per_system=its, rnrm2_per_system=np.zeros(B),
            r0nrm2_per_system=np.ones(B),
            converged_per_system=np.ones(B, bool))
        if B == 1:
            res.x = res.x[0]
            res.nrhs = 1
        return res

    return dispatch


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_padding_replicates_the_last_request(pkg):
    q = PKGS[pkg]["queue"]
    log = []
    queue = q.CoalescingQueue(_fake_dispatch(pkg, log),
                              q.QueuePolicy(max_batch=4, buckets=(1, 4)))
    bs = [np.full(5, float(i + 1)) for i in range(3)]
    ts = [queue.submit(b, request_id=i) for i, b in enumerate(bs)]
    queue.flush()
    assert len(log) == 1 and log[0].shape == (4, 5)
    np.testing.assert_array_equal(log[0][3], bs[2])
    for i, t in enumerate(ts):
        r = t.result()
        np.testing.assert_array_equal(r.x, 2 * bs[i])
        assert r.niterations == i + 1
        assert len(r.residual_history) == i + 2
        assert (t.batch_size, t.bucket, t.index) == (3, 4, i)
    st = queue.stats()
    assert st["padded_systems"] == 1 and st["batches"] == 1
    assert st["mean_occupancy"] == pytest.approx(0.75)
    # a lone request takes bucket 1: the 1-D path
    t = queue.submit(bs[0])
    queue.flush()
    assert log[-1].shape == (5,) and t.bucket == 1


@pytest.mark.parametrize("drain", [True, False])
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_close_drains_or_sheds_and_then_refuses(pkg, drain):
    P = PKGS[pkg]
    q = P["queue"]
    log = []
    queue = q.CoalescingQueue(_fake_dispatch(pkg, log),
                              q.QueuePolicy(max_batch=8))
    ts = [queue.submit(np.ones(3) * i) for i in range(3)]
    queue.close(drain=drain)
    assert all(t.done for t in ts)
    if drain:
        assert len(log) == 1 and all(t.error is None for t in ts)
    else:
        assert not log and all(t.shed for t in ts)
        assert {t.error.status.name for t in ts} == {"ERR_OVERLOADED"}
    with pytest.raises(P["Error"]) as ei:
        queue.submit(np.ones(3))
    assert ei.value.status.name == "ERR_OVERLOADED"
    st = queue.stats()
    assert st["closed"] and st["depth"] == 0 and st["inflight"] == 0
    queue.close()       # idempotent


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_a_crashing_dispatch_strands_no_ticket(pkg):
    q = PKGS[pkg]["queue"]

    def crash(bb):
        raise RuntimeError("device lost")

    queue = q.CoalescingQueue(crash, q.QueuePolicy(max_batch=2))
    ts = [queue.submit(np.ones(3)) for _ in range(2)]
    for t in ts:
        assert t.done
        with pytest.raises(PKGS[pkg]["Error"]) as ei:
            t.result()
        assert ei.value.status.name == "ERR_INVALID_VALUE"
        assert "device lost" in str(ei.value)
    assert queue.inflight == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_threaded_submissions_coalesce_and_leave_no_thread(pkg):
    q = PKGS[pkg]["queue"]
    log = []
    queue = q.CoalescingQueue(_fake_dispatch(pkg, log),
                              q.QueuePolicy(max_batch=4, max_wait=30.0))
    before = threading.active_count()
    gate = threading.Barrier(4)
    got = [None] * 4

    def client(i):
        gate.wait()
        got[i] = queue.submit(np.full(3, float(i))).result()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(log) == 1 and log[0].shape == (4, 3)
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.x, np.full(3, 2.0 * i))
    queue.close()
    assert threading.active_count() == before


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_queue_deadline_sheds_pending_tickets(pkg):
    q = PKGS[pkg]["queue"]
    log = []
    queue = q.CoalescingQueue(_fake_dispatch(pkg, log),
                              q.QueuePolicy(max_batch=8, max_wait=10.0))
    t = queue.submit(np.ones(3), queue_deadline=time.perf_counter() + 0.05)
    with pytest.raises(PKGS[pkg]["Error"]) as ei:
        t.result(timeout=5.0)
    assert ei.value.status.name == "ERR_TIMEOUT" and t.shed
    assert not log and queue.stats()["shed"] == 1


def _trail(pkg):
    """A breaker through closed -> open -> half-open -> (probe fails)
    open -> half-open -> (probe succeeds) closed, on a fake clock."""
    A = PKGS[pkg]["admission"]
    now = [0.0]
    board = A.BreakerBoard(A.AdmissionPolicy(breaker_threshold=2,
                                             breaker_cooldown_ms=100.0),
                           clock=lambda: now[0])
    verdicts = []
    for ok in (False, False):
        board.record("cg-pipelined", 4, np.float64, ok)
    verdicts.append(board.admit("cg-pipelined", np.float64))
    now[0] = 0.2
    verdicts.append(board.peek("cg-pipelined", np.float64))
    verdicts.append(board.admit("cg-pipelined", np.float64))
    verdicts.append(board.admit("cg-pipelined", np.float64))
    board.record("cg-pipelined", 1, np.float64, False)
    now[0] = 0.4
    verdicts.append(board.admit("cg-pipelined", np.float64))
    board.record("cg-pipelined", 1, np.float64, True)
    verdicts.append(board.admit("cg-pipelined", np.float64))
    return board.transitions, verdicts, board.states(), board.trips


def test_breaker_transitions_match_acg_tpu():
    trail, verdicts, states, trips = _trail("acg_torch")
    assert (trail, verdicts, states, trips) == _trail("acg_tpu")
    # the probes ride bucket 1: its outcomes resolve bucket 4's breaker
    assert [t["to"] for t in trail] == ["OPEN", "HALF_OPEN", "OPEN",
                                         "HALF_OPEN", "CLOSED"]
    assert verdicts[0] == (False, "OPEN", "cg-pipelined/b4/float64")
    assert trips == 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_rolling_window_and_backoff(pkg):
    A = PKGS[pkg]["admission"]
    w = A.RollingWindow(4)
    for ok, wait in ((True, 0.001), (False, None), (True, 0.003),
                     (True, 0.002), (False, 0.004)):
        w.record(ok, wait, wait)
    s = w.summary()
    assert s["n"] == 4 and s["failure_rate"] == 0.5
    assert s is w.summary()                 # cached until the next record
    pol = A.AdmissionPolicy(backoff_ms=10.0, jitter=0.5, seed=3)
    rng = np.random.default_rng(pol.seed)
    assert [round(pol.backoff_s(k, rng), 12) for k in (1, 2, 3)] == \
        _backoffs("acg_tpu")
    with pytest.raises(PKGS[pkg]["Error"]):
        A.AdmissionPolicy(max_retries=-1)


def _backoffs(pkg):
    A = PKGS[pkg]["admission"]
    pol = A.AdmissionPolicy(backoff_ms=10.0, jitter=0.5, seed=3)
    rng = np.random.default_rng(pol.seed)
    return [round(pol.backoff_s(k, rng), 12) for k in (1, 2, 3)]


# ---------------------------------------------------------------------------
# the service's laws, with real solves


def _service(pkg, **kw):
    o = dict(maxits=400, residual_rtol=1e-8)
    if pkg == "acg_tpu":
        s = JSession(jpoisson.poisson2d_5pt(8), options=JOptions(**o),
                     prep_cache=None, share_prepared=False)
        return JService(s, **kw)
    s = Session(poisson.poisson2d_5pt(8), options=SolverOptions(**o),
                device="cpu", share_prepared=False)
    return SolverService(s, **kw)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_service_sheds_at_depth_and_after_close(pkg):
    A = PKGS[pkg]["admission"]
    svc = _service(pkg, max_batch=8, max_wait_ms=10_000.0,
                   admission=A.AdmissionPolicy(max_queue_depth=2))
    reqs = [svc.submit(np.ones(64)) for _ in range(3)]
    shed = reqs[2].response()
    assert (shed.ok, shed.status, shed.shed) == (False, "ERR_OVERLOADED",
                                                 True)
    assert shed.summary()["shed"] is True
    svc.close()                   # drains the two pending
    assert all(r.response().ok for r in reqs[:2])
    late = svc.solve(np.ones(64))
    assert late.status == "ERR_OVERLOADED" and late.audit is not None
    h = svc.health()
    assert h["shed"] == 2 and h["ready"] is False
    assert svc.stats()["admission"]["shed"] == 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_service_refuses_a_poisoned_rhs_at_the_door(pkg):
    svc = _service(pkg)
    b = np.ones(64)
    b[5] = np.nan
    with pytest.raises(PKGS[pkg]["Error"]) as ei:
        svc.submit(b)
    assert ei.value.status.name == "ERR_INVALID_VALUE"
    with pytest.raises(PKGS[pkg]["Error"]):
        svc.submit(np.ones((2, 64)))
    assert svc.solve(np.ones(64)).ok


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_service_breaker_fast_fails_then_recovers(pkg):
    """Non-convergence trips the breaker on classic CG (no degradation
    target): requests fast-fail with ERR_OVERLOADED until the cooldown
    passes and a probe closes it."""
    A = PKGS[pkg]["admission"]
    svc = _service(pkg, admission=A.AdmissionPolicy(
        breaker_threshold=2, breaker_cooldown_ms=50.0))
    opts = svc.options
    svc.options = type(opts)(maxits=2, residual_rtol=1e-12)
    statuses = [svc.solve(np.ones(64)).status for _ in range(3)]
    assert statuses == ["ERR_NOT_CONVERGED", "ERR_NOT_CONVERGED",
                        "ERR_OVERLOADED"]
    assert svc.health()["status"] == "overloaded"
    svc.options = opts
    time.sleep(0.08)
    assert svc.solve(np.ones(64)).ok
    assert [t["to"] for t in svc.health()["breaker_transitions"]] == \
        ["OPEN", "HALF_OPEN", "CLOSED"]
    assert svc.stats()["admission"]["breaker_trips"] == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_service_degrades_pipelined_onto_classic(pkg):
    A = PKGS[pkg]["admission"]
    svc = _service(pkg, solver="cg-pipelined", admission=A.AdmissionPolicy(
        breaker_threshold=1, breaker_cooldown_ms=60_000.0))
    opts = svc.options
    svc.options = type(opts)(maxits=2, residual_rtol=1e-12)
    assert svc.solve(np.ones(64)).status == "ERR_NOT_CONVERGED"
    svc.options = opts
    r = svc.solve(np.ones(64))
    assert r.ok and r.degraded and r.degraded_from == "cg-pipelined"
    assert r.audit["solver"] == "cg"
    assert r.summary()["degraded"] is True


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_flight_recorder_timeline(pkg):
    svc = _service(pkg)
    r = svc.solve(np.ones(64))
    tl = svc.flightrec.dump()[-1]
    assert [e["event"] for e in tl["events"]] == [
        "submit", "coalesced", "dispatch", "demux", "response"]
    assert tl["trace_id"] == r.audit["session"]["trace_id"] \
        == r.audit["admission"]["trace_id"]
