"""The counted CommAudit (``acg_torch.obs.audit``) against the JAX
package's compiled-HLO audit (``acg_tpu.obs.hlo.audit_compiled``, run
as ``tests/test_hlo_audit.py`` runs it, on the root conftest's CPU mesh).

On P = 4 slab parts of a 2-D Poisson (the same part vector in both
packages), a loop body's halo rounds (ppermute), allgathers and
reduction points (allreduce) equal the collective-permutes, all-gathers
and all-reduces of the JAX while body, for classic, pipelined, s-step
(s = 3: one body is 3 iterations, the 1/s accounting) and deep-pipelined
(l = 2) CG under the ppermute and allgather halos; on one device every
count is 0.  The bytes differ by meaning (the port counts what every
part sends, the JAX audit one device's padded message) and are pinned
separately.
"""

import numpy as np
import pytest

from acg_tpu.config import HaloMethod as JHalo
from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.obs.hlo import audit_compiled
from acg_tpu.solvers.cg import compile_step as jcompile
from acg_tpu.solvers.cg_dist import compile_step as jcompile_dist
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.obs.audit import CLASSES, audit_solver, format_comm_audit
from acg_torch.solvers.cg import build_device_operator
from acg_torch.solvers.cg_dist import build_sharded
from acg_torch.sparse import poisson as tpoisson

N = 16
CASES = {"cg": {}, "cg-pipelined": {},
         "cg-sstep": {"sstep": 3}, "cg-pipelined-deep": {"pipeline_depth": 2}}


def _part():
    return np.repeat(np.arange(4), N * N // 4).astype(np.int32)


def _jax_audit(solver, method, nparts=4):
    o = JOptions(maxits=12, residual_rtol=1e-9, **CASES[solver])
    A = jpoisson.poisson2d_5pt(N)
    if nparts == 1:
        return audit_compiled(jcompile(A, np.ones(A.nrows), options=o,
                                       solver=solver))
    return audit_compiled(jcompile_dist(
        A, np.ones(A.nrows), options=o, solver=solver, part=_part(),
        method=JHalo(method)))


@pytest.mark.parametrize("method", ["ppermute", "allgather"])
@pytest.mark.parametrize("solver", sorted(CASES))
def test_per_iteration_counts_equal_audit_compiled(solver, method):
    j = _jax_audit(solver, method)
    ss = build_sharded(tpoisson.poisson2d_5pt(N), part=_part(),
                       devices=["cpu"] * 4, method=method)
    t = audit_solver(ss, solver=solver, options=SolverOptions(
        residual_rtol=1e-9, **CASES[solver]))
    for cls in ("ppermute", "allgather", "allreduce"):
        assert t.count(cls) == getattr(j, cls).count, cls
    assert t.count("rdma") == 0
    ipb = CASES[solver].get("sstep", 1)
    assert t.iters_per_body == ipb
    d, jd = t.as_dict(), j.as_dict(iters_per_body=ipb)
    for cls in ("ppermute", "allgather", "allreduce"):
        assert (d["per_solver_iteration"][cls]["count_rational"]
                == jd["per_solver_iteration"][cls]["count_rational"])
    # one block a check point: one host read an iteration (a block an
    # s-step body)
    assert t.host_reads == 1
    # no kernel launches on the CPU: the plain versions ran
    assert not any(t.launches.values())


@pytest.mark.parametrize("solver", ["cg", "cg-sstep"])
def test_one_device_counts_zero(solver):
    j = _jax_audit(solver, "ppermute", nparts=1)
    op = build_device_operator(tpoisson.poisson2d_5pt(N), device="cpu")
    t = audit_solver(op, solver=solver, options=SolverOptions(
        residual_rtol=1e-9, **CASES[solver]))
    for cls in CLASSES:
        assert t.count(cls) == 0 and t.total[cls] == (0, 0)
    assert j.total_ppermute.count == j.total_allreduce.count == 0


def test_message_bytes_and_totals():
    """The port's bytes: every part's messages at the wire's itemsize
    (f64: 8 B a value; bf16: 2 B, the encoded pads included), one shard's
    partials a reduction point; totals are the longer run's counts."""
    A = tpoisson.poisson2d_5pt(N)
    o = SolverOptions(residual_rtol=1e-9)
    ss = build_sharded(A, part=_part(), devices=["cpu"] * 4)
    t = audit_solver(ss, options=o, k=(3, 7))
    sent = ss.halo.total_send_values
    assert t.per_iteration["ppermute"] == (2, sent * 8)
    assert t.per_iteration["allreduce"] == (2, 16)
    assert t.k == (3, 7) and t.total["allreduce"][0] >= 2 * 7
    w = audit_solver(ss, options=SolverOptions(residual_rtol=1e-9,
                                               halo_wire="bf16"))
    assert w.count("ppermute") == 2
    assert w.per_iteration["ppermute"][1] == sum(
        2 * ss.tables.max_msg for p in ss.ps.parts for _ in p.neighbors)
    # (B, n): the same collectives, the payload x B
    b3 = audit_solver(ss, options=o, nrhs=3)
    assert b3.count("ppermute") == 2 and b3.count("allreduce") == 2
    assert b3.per_iteration["ppermute"][1] == 3 * sent * 8
    rep = format_comm_audit(t, "classic")
    assert "ppermute" in rep and "host reads" in rep


def test_session_audit_is_the_counted_audit():
    from acg_torch.serve import Session

    s = Session(tpoisson.poisson2d_5pt(N), nparts=4, part=_part(),
                devices=["cpu"] * 4, share_prepared=False)
    a = s.audit(solver="acg-pipelined")
    assert a.count("ppermute") == 2 and a.count("allreduce") == 1
    assert s.counters["solves"] == 0
