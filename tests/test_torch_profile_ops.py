"""``--per-op-stats`` (``acg_torch.utils.profile``) against the JAX
package's ``acg_tpu.utils.profile`` on the same operators and iteration
counts: every op class's count, bytes and flops are the JAX package's
(the reference's cadence and byte models); only the times are the
port's own, and they must be positive and finite.

Over shards the SpMV's bytes differ on purpose (ROADMAP Queue 3): the
port's shards are not padded to one length and its interface is an ELL
on the border rows, where the JAX package streams padded (P, NOWN, L)
stacks; the test pins the port's figure.  The JAX package has no model
for the matrix-free stencil (its profile reads ``vals``): the port's is
x + y, pinned.
"""

import math

import numpy as np
import pytest

from acg_tpu.solvers.base import SolveStats as JStats
from acg_tpu.solvers.cg import build_device_operator as jbuild
from acg_tpu.solvers.cg_dist import build_sharded as jsharded
from acg_tpu.sparse import poisson as jpoisson
from acg_tpu.utils import profile as jprofile

from acg_torch.solvers.base import SolveStats
from acg_torch.solvers.cg import build_device_operator as tbuild
from acg_torch.solvers.cg_dist import build_sharded as tsharded
from acg_torch.sparse import poisson as tpoisson
from acg_torch.utils import profile as tprofile
from acg_torch.utils.stats import time_op

OPS = ("gemv", "dot", "nrm2", "axpy", "copy", "allreduce", "halo")
CADENCES = {"classic": dict(pipelined=False),
            "pipelined": dict(pipelined=True),
            "pipelined-replace": dict(pipelined=True, replace_every=4)}


def _same(j, t, names, bytes_too=True):
    for nm in names:
        jc, tc = getattr(j, nm), getattr(t, nm)
        assert (tc.n, tc.flops) == (jc.n, jc.flops), nm
        if bytes_too:
            assert tc.bytes == jc.bytes, nm
        assert math.isfinite(tc.t) and (tc.t > 0) == (tc.n > 0), nm


@pytest.mark.parametrize("cadence", sorted(CADENCES))
@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_profile_ops_equals_acg_tpu(fmt, cadence):
    kw = CADENCES[cadence]
    jd = jbuild(jpoisson.poisson2d_5pt(16), dtype=np.float64, fmt=fmt)
    td = tbuild(tpoisson.poisson2d_5pt(16), dtype=np.float64, fmt=fmt,
                device="cpu")
    j = jprofile.profile_ops(jd, JStats(), 10, **kw)
    t = tprofile.profile_ops(td, SolveStats(), 10, **kw)
    _same(j, t, OPS)


def test_profile_ops_stencil_is_x_and_y():
    td = tbuild(tpoisson.poisson3d_7pt(8), dtype=np.float64, fmt="stencil",
                device="cpu")
    t = tprofile.profile_ops(td, SolveStats(), 7)
    n = td.nrows_padded
    assert t.gemv.n == 8 and t.gemv.bytes == 8 * 2 * n * 8
    assert t.gemv.flops == 8 * 2 * td.nnz and t.gemv.t > 0


@pytest.mark.parametrize("cadence", sorted(CADENCES))
@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_profile_dist_ops_equals_acg_tpu(fmt, cadence):
    kw = CADENCES[cadence]
    A = tpoisson.poisson2d_5pt(16)
    part = np.repeat(np.arange(4), A.nrows // 4).astype(np.int32)
    jss = jsharded(jpoisson.poisson2d_5pt(16), part=part, fmt=fmt)
    tss = tsharded(A, part=part, devices=["cpu"] * 4, fmt=fmt)
    j = jprofile.profile_dist_ops(jss, JStats(), 10, **kw)
    t = tprofile.profile_dist_ops(tss, SolveStats(), 10, **kw)
    _same(j, t, ("dot", "axpy", "halo", "allreduce"))
    _same(j, t, ("gemv",), bytes_too=False)
    assert t.nhalomsgs == j.nhalomsgs > 0
    # the port's SpMV stream: its shards' local operators and border-row
    # interface as stored, with x read, gathered and y written
    n = sum(op.nrows_padded for op in tss.local_ops)
    iface = sum(it[0].stream_bytes() for it in tss.iface if it is not None)
    assert t.gemv.bytes == t.gemv.n * (tprofile._local_bytes(tss) + iface
                                       + 3 * n * 8)
    assert t.gemv.bytes > 0 and j.gemv.bytes > 0


def test_time_op_cpu_and_no_device():
    import torch

    from acg_torch.errors import AcgError

    x = torch.ones(1000, dtype=torch.float64)
    t = time_op(torch.dot, x, x, warmup=1, reps=3)
    assert t > 0 and math.isfinite(t)
    assert time_op(lambda: None, device="cpu", warmup=0, reps=1) >= 0
    with pytest.raises(AcgError):
        time_op(lambda: None)
