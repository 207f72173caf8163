"""The port's roofline model (``acg_torch.obs.roofline``) against the JAX
package's (``acg_tpu.obs.roofline``) on the same operators, built from
the same host matrices on the CPU.

What must be equal: the operator stream a DIA (bf16 and f64 bands) or
stencil operator streams, with one or four right-hand sides and the
s-step factor 2; the rows; the s-step vector table; over four shards,
the halo payload and the wire's itemsize under every wire.  What differs
on purpose (ROADMAP Queue 3) is pinned: the classic and pipelined vector
streams (11 and 12 against the JAX package's 15 and 19), the sharded
ceiling's factor (distinct cards, not shards) and the sharded rows and
operator (the port's unpadded shards and border-row interface).
"""

import numpy as np
import pytest

from acg_tpu.obs import roofline as jroof
from acg_tpu.solvers.cg import build_device_operator as jbuild
from acg_tpu.solvers.cg_dist import build_sharded as jsharded
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.obs import roofline as troof
from acg_torch.solvers.cg import build_device_operator as tbuild
from acg_torch.solvers.cg_dist import build_sharded as tsharded
from acg_torch.sparse import poisson as tpoisson

TIERS = {"dia-bf16": ("dia", "auto", np.float32),
         "dia-f64": ("dia", None, np.float64),
         "stencil": ("stencil", "auto", np.float64)}
SHAPES = {"nrhs1": {}, "nrhs4": {"nrhs": 4}, "sstep4": {"sstep": 4}}


def _ops(tier):
    fmt, mdt, dt = TIERS[tier]
    jd = jbuild(jpoisson.poisson3d_7pt(8), dtype=dt, fmt=fmt,
                mat_dtype=mdt)
    td = tbuild(tpoisson.poisson3d_7pt(8), dtype=dt, fmt=fmt,
                mat_dtype=mdt, device="cpu")
    return jd, td


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_operator_bytes_equal_acg_tpu(tier, shape):
    jd, td = _ops(tier)
    kw = SHAPES[shape]
    for solver in ("cg", "cg-pipelined"):
        j = jroof.roofline_for_operator(jd, solver=solver, device_kind="x",
                                        **kw)
        t = troof.roofline_for_operator(td, solver=solver,
                                        device_kind="x", **kw)
        assert t.operator_bytes == j.operator_bytes
        assert t.nrows == j.nrows and t.nrhs == j.nrhs
        assert t.operator_format == j.operator_format
        if kw.get("sstep"):
            # the s-step block table is the JAX package's
            assert t.vector_bytes == j.vector_bytes
        if tier.startswith("dia"):
            assert t.operator_bytes == td.operator_stream_bytes() * (
                2 if kw.get("sstep") else 1) > 0
        else:
            assert t.operator_bytes == 0


@pytest.mark.parametrize("solver,streams", [("cg", 11),
                                            ("cg-pipelined", 12),
                                            ("cg-pipelined-deep", 12)])
def test_vector_streams_are_the_fixed_table(solver, streams):
    """A difference on purpose: the least one iteration of the family
    must move, not the JAX package's 15 / 19."""
    _, td = _ops("stencil")
    for nrhs in (1, 4):
        t = troof.roofline_for_operator(td, solver=solver, nrhs=nrhs,
                                        device_kind="x")
        assert t.vector_bytes == nrhs * streams * td.nrows_padded * 8
    j = jroof.roofline_for_operator(_ops("stencil")[0], solver=solver,
                                    device_kind="x")
    assert j.vector_bytes > troof.roofline_for_operator(
        td, solver=solver, device_kind="x").vector_bytes


def test_ceiling_and_frac():
    _, td = _ops("dia-f64")
    m = troof.roofline_for_operator(td, device_kind="NVIDIA H100 80GB HBM3")
    assert m.hbm_gbps == 3350.0
    assert m.predicted_iters_per_sec == pytest.approx(
        3350e9 / m.bytes_per_iter)
    assert m.bound_us_per_iter == pytest.approx(
        1e6 * m.bytes_per_iter / 3350e9)
    assert m.frac(m.predicted_iters_per_sec / 2) == pytest.approx(0.5)
    assert np.isnan(m.frac(float("nan")))
    assert troof.hbm_gbps_for("x", 1234.0) == 1234.0
    assert troof.hbm_gbps_for(None) == troof.DEFAULT_HBM_GBPS
    assert troof.hbm_gbps_for("NVIDIA H100 PCIe") == 2000.0
    d = m.as_dict()
    assert d["bytes_per_iter"] == m.bytes_per_iter and d["ncards"] == 1
    assert "predicted ceiling" in m.report()
    # no TPU row is kept
    assert not any("TPU" in k for k in troof.CHIP_HBM_GBPS)


def _slabs(A, P=4):
    return np.repeat(np.arange(P), A.nrows // P).astype(np.int32)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int16-delta"])
@pytest.mark.parametrize("nrhs", [1, 4])
def test_sharded_halo_bytes_equal_acg_tpu(wire, nrhs):
    A = tpoisson.poisson2d_5pt(16)
    part = _slabs(A)
    jss = jsharded(jpoisson.poisson2d_5pt(16), part=part, fmt="dia")
    tss = tsharded(A, part=part, devices=["cpu"] * 4, fmt="dia")
    j = jroof.roofline_for_sharded(jss, nrhs=nrhs, halo_wire=wire,
                                   device_kind="x")
    t = troof.roofline_for_sharded(tss, nrhs=nrhs, halo_wire=wire,
                                   device_kind="x")
    assert t.halo_bytes == j.halo_bytes > 0
    assert t.halo_wire_itemsize == j.halo_wire_itemsize
    assert t.halo_base_itemsize == j.halo_base_itemsize
    assert t.nparts == j.nparts == 4
    # differences on purpose: shards that share a device stream at one
    # device's rate; rows are the shards' own lengths; the operator is
    # what the shards store (no padded stack, border-row interface)
    assert t.ncards == 1
    assert t.predicted_iters_per_sec == pytest.approx(
        t.hbm_gbps * 1e9 / t.bytes_per_iter)
    assert t.nrows == sum(op.nrows_padded for op in tss.local_ops)
    assert t.operator_bytes == troof.sharded_operator_bytes(tss)
    assert 0 < t.operator_bytes <= j.operator_bytes
