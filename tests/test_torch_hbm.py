"""Port parity: the DIA SpMV for x past the card's L2 (the HBM tier).

``acg_torch.ops.dia_plan`` against the JAX package's plan functions
(``_ring_span``, ``_cluster_windows``: pure host code), the plan's
routing at the H100's budgets (50 MB L2, 232,448 B of shared memory per
block, 233,472 per SM, 132 SMs, passed in as numbers), the plain
versions of the ring and clustered-window kernels bit for bit against
``dia_matvec`` and against the Pallas kernels ``dia_matvec_pallas_hbm2d_ring``
and ``dia_matvec_pallas_hbm2d`` in interpret mode (y at 1e-5·max|y|, the
dot at 1e-4 relative: the JAX tests' own tolerances), and whole classic
solves routed through each plain version on the CPU by small budgets
against ``acg_tpu.solvers.cg.cg`` (iterations within 1 at f32, equal at
f64; certified residual at most 10 × rtol).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.ops import pallas_kernels as pk
from acg_tpu.ops.dia import DiaMatrix as JDiaMatrix
from acg_tpu.solvers.cg import cg as jcg
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.ops import dia_plan as dp
from acg_torch.ops.dia import DeviceDia, DiaMatrix
from acg_torch.ops.dia_kernels import (dia_matvec, dia_matvec_ring_plain,
                                       dia_matvec_windows_plain,
                                       dia_spmv_ring, dia_spmv_windows)
from acg_torch.solvers.base import path_names
from acg_torch.solvers.cg import _describe_path, cg
from acg_torch.sparse import poisson as tpoisson

LANES = 128
H100 = dp.Budgets(l2_bytes=50 * 2**20, smem_block=232_448,
                  smem_sm=233_472, sms=132)
# a card small enough that 12^3 and 32^2 operators leave its L2 and ring
SMALL = dp.Budgets(l2_bytes=1024, smem_block=232_448 // 4,
                   smem_sm=233_472 // 4, sms=3)
BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64

O464 = (-215296, -464, -1, 0, 1, 464, 215296)
_LANE_OFFSETS = [
    (-215296, -128, 0, 128, 215296),
    (-16384, -1024, -128, 0, 128, 1024, 16384),
    (-2048, -256, 0, 256, 2048),
    (-128 * 40, -128, 0, 128, 128 * 40),
]


@pytest.mark.parametrize("rt", [8, 16, 256, 512, 1024])
@pytest.mark.parametrize("offsets", _LANE_OFFSETS + [O464])
def test_ring_span_matches_jax(offsets, rt):
    assert dp.ring_span(offsets, rt * LANES) == pk._ring_span(offsets, rt)


@pytest.mark.parametrize("offsets", _LANE_OFFSETS)
def test_cluster_windows_match_jax_on_lane_multiples(offsets):
    """(lo, ext) in elements equal JAX's (qmin, extra_rows) in rows of
    128, and every window holds the same bands."""
    want = pk._cluster_windows(offsets)
    got = dp.cluster_windows(offsets)
    assert len(got) == len(want)
    for (lo, ext, bands), (qmin, ext_rows, diags) in zip(got, want):
        assert (lo, ext) == (qmin * LANES, ext_rows * LANES)
        assert [d for d, _ in bands] == [d for d, _, _ in diags]


@pytest.mark.parametrize("offsets", [O464, (-10000, -1, 0, 1, 10000),
                                     (-2100, -130, -1, 0, 1, 130, 2100)])
def test_cluster_partition_matches_jax(offsets):
    """Off lane multiples the extents differ (JAX rounds to whole rows),
    the partition of the bands into windows does not."""
    got = [tuple(d for d, _ in w[2]) for w in dp.cluster_windows(offsets)]
    want = [tuple(d for d, _, _ in w[2])
            for w in pk._cluster_windows(offsets)]
    assert got == want


O256 = (-65536, -256, -1, 0, 1, 256, 65536)
O2D = (-10000, -1, 0, 1, 10000)
O128 = (-16384, -128, -1, 0, 1, 128, 16384)


@pytest.mark.parametrize("case", [
    # (n, offsets, vector dtype, band dtype, kind): the configurations
    # chip_smoke.py drives, on the card's own budgets; the ring before the
    # windows (the JAX plan's order, measured again: ROADMAP Queue 3),
    # and f64 bands resident past the L2 (a difference on purpose)
    (464 ** 3, O464, F32, BF16, "hbm"),
    (464 ** 3, O464, F64, BF16, "hbm"),
    (256 ** 3, O256, F32, BF16, "hbm"),
    (256 ** 3, O256, F32, torch.int8, "hbm"),
    (256 ** 3, O256, F64, F64, "resident"),
    (10 ** 8, O2D, F32, BF16, "hbm-ring"),
    (10 ** 8, O2D, F64, BF16, "hbm-ring"),
    (10 ** 8, O2D, F64, F64, "resident"),
    (128 ** 3, O128, F32, BF16, "resident"),
    (128 ** 3, O128, F64, F64, "resident"),
    (10 ** 6, (-1, 0, 1), F64, F64, "resident"),
])
def test_plan_routing_at_h100_budgets(case):
    n, offsets, vdt, bdt, kind = case
    got, tile = dp.fused_plan_for(n, offsets, vdt, bdt, H100)
    assert got == kind
    assert (tile is None) == (kind == "resident")


def test_plan_geometry_at_h100_budgets():
    # 10,000^2 at f32 with bf16 bands: T = 1024, the largest tile of
    # WINDOW_TILES at which two blocks of 288 threads fit an SM, with 2
    # row tiles in flight; span -10 .. 10, 21 + 1 = 22 slots = 88 KB, 2
    # stages of the 5 band tiles, behind a head of 2 x (2 + 22)
    # mbarriers and 5 positions (512 bytes)
    p = dp.make_plan("hbm-ring", 1024, 10 ** 8, O2D, F32, BF16, H100)
    assert (p.lo, p.hi) == (-10, 10) and p.stages == 2
    assert p.smem == 512 + 22 * 1024 * 4 + 2 * 5 * 1024 * 2
    assert p.nblocks == 2 * 132 and p.ntiles == -(-10 ** 8 // 1024)
    assert dp.ring_plan(10 ** 8, O2D, F32, BF16, H100) == 1024
    # 464^3: the ring would need 214 slots (1.7 MB): windows, three
    # clusters; at T = 1024 a ring of 4 stages, each the three windows
    # (1028 + 1956 + 1028 f32) and the 7 bf16 band tiles, behind a head
    # of 8 mbarriers and 7 positions (128 bytes): 121,664 bytes, one
    # block of 288 threads an SM
    assert dp.ring_plan(464 ** 3, O464, F32, BF16, H100) is None
    assert dp.windows_plan(464 ** 3, O464, F32, BF16, H100) == 1024
    p = dp.make_plan("hbm", 1024, 464 ** 3, O464, F32, BF16, H100)
    assert p.nclusters == 3 and p.tile == 1024 and p.stages == 4
    assert p.buflen == 1028 + 1956 + 1028
    assert p.smem == 128 + 4 * (p.buflen * 4 + 7 * 1024 * 2)
    assert p.nblocks == 132
    assert p.table.tolist()[9:] == [0, 1, 1, 1, 1, 1, 2]
    # at T = 2048 the same ring (4 stages, 229,184 bytes with the dot's
    # tree) still fits one block; two blocks of 3 stages would fit at 1024
    p = dp.make_plan("hbm", 2048, 464 ** 3, O464, F32, BF16, H100)
    assert p.stages == 4 and p.buflen == 2052 + 2980 + 2052
    assert p.smem == 128 + 4 * (p.buflen * 4 + 7 * 2048 * 2)
    three = dp.windows_bytes(O464, 1024, 4, 2, 7, 3)
    assert three == 128 + 3 * (4012 * 4 + 7 * 1024 * 2) + 256 * 4
    assert dp.blocks_per_sm(three, H100, dp.WINDOWS_THREADS) == 2
    # f64 vectors are admitted (the JAX plans reject itemsize > 4)
    assert dp.windows_plan(464 ** 3, O464, F64, BF16, H100) == 1024
    assert dp.make_plan("hbm", 1024, 464 ** 3, O464, F64, BF16,
                        H100).stages == 4


def test_plan_leaves_bands_past_the_vector_out():
    # a band at |offset| >= n touches nothing: no span, cluster -1
    p = dp.make_plan("hbm-ring", 256, 64, (-1000, 0, 1), F32, F32, SMALL)
    assert (p.lo, p.hi) == (0, 1)
    p = dp.make_plan("hbm", 256, 64, (-1000, 0, 1), F32, F32, SMALL)
    assert p.table.tolist()[3 * p.nclusters:] == [-1, 0, 0]
    assert dp.fused_plan_for(64, (-1000, 1000), F32, F32,
                             SMALL) == ("resident", None)


# ---------------------------------------------------------------------------
# the plain versions


def _random_dia(n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            bands[d, max(n - off, 0):] = 0.0
        elif off < 0:
            bands[d, : min(-off, n)] = 0.0
    return DiaMatrix(n, n, tuple(offsets), bands, int((bands != 0).sum()))


def _tier(D, mat):
    """Bands that the tier ``mat`` stores (bf16-exact for "auto",
    two-valued for "int8")."""
    if mat in ("auto", "int8"):
        D = DiaMatrix(D.nrows, D.ncols, D.offsets, np.sign(D.bands) * 0.5,
                      D.nnz)
    if mat == "int8":
        D = DiaMatrix(D.nrows, D.ncols, D.offsets, np.abs(D.bands), D.nnz)
    return D


_GEOMETRIES = [
    # (n, offsets, tile): ragged n, spans of one to many tiles, and bands
    # whose offset reaches past the whole vector
    (1000, (-300, -1, 0, 1, 299), 256),
    (4099, (-2048, -129, -1, 0, 1, 129, 2048, 5000), 256),
    (3001, (-1500, -33, 0, 33, 1500), 512),
    (37, (-40, -3, 0, 3, 36), 256),
]


@pytest.mark.parametrize("kind", ["hbm-ring", "hbm"])
@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("mat", ["auto", "int8", "float32", None])
@pytest.mark.parametrize("geom", _GEOMETRIES)
def test_plain_versions_equal_dia_matvec_bit_for_bit(geom, mat, vdt, kind):
    n, offsets, tile = geom
    D = _tier(_random_dia(n, offsets), mat)
    dev = DeviceDia.from_dia(D, dtype=str(vdt)[6:], mat_dtype=mat,
                             device="cpu")
    plan = dp.make_plan(kind, tile, dev.nrows_padded, dev.offsets, vdt,
                        dev.bands.dtype, SMALL)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        dev.nrows_padded)).to(vdt)
    plain = (dia_matvec_ring_plain if kind == "hbm-ring"
             else dia_matvec_windows_plain)
    want = dia_matvec(dev.bands, dev.offsets, x, dev.scales)
    got = plain(dev.bands, dev.offsets, x, dev.scales, plan)
    assert torch.equal(got, want)
    # through the wrapper (a CPU tensor takes the plain version), dot too
    spmv = dia_spmv_ring if kind == "hbm-ring" else dia_spmv_windows
    y, dot = spmv(dev.bands, dev.scales, dev.offsets_t, x, plan,
                  with_dot=True)
    assert torch.equal(y, want) and torch.equal(dot, torch.dot(x, want))


def test_windows_plain_reads_through_a_misaligned_window():
    """x at an address 4 bytes past a 16-byte boundary shifts every
    window's start; the rows are the same."""
    D = _random_dia(2000, (-700, -5, 0, 5, 700))
    dev = DeviceDia.from_dia(D, dtype="float32", mat_dtype=None,
                             device="cpu")
    buf = torch.from_numpy(np.random.default_rng(2).standard_normal(
        2001).astype(np.float32))
    x = buf[1:] if buf.data_ptr() % 16 == 0 else buf[:-1]
    plan = dp.make_plan("hbm", 256, 2000, dev.offsets, F32, F32, SMALL)
    got = dia_matvec_windows_plain(dev.bands, dev.offsets, x, None, plan,
                                   chunk=3)
    assert torch.equal(got, dia_matvec(dev.bands, dev.offsets, x))


def test_ring_plain_follows_the_slot_mapping():
    """A plan whose span is one tile short makes the plain ring read the
    wrong tiles: the geometry, not x itself, is what it reads through."""
    D = _random_dia(3000, (-600, 0, 600))
    dev = DeviceDia.from_dia(D, dtype="float64", mat_dtype=None,
                             device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(3000))
    plan = dp.make_plan("hbm-ring", 256, 3000, dev.offsets, F64, F64, SMALL)
    want = dia_matvec(dev.bands, dev.offsets, x)
    assert torch.equal(dia_matvec_ring_plain(dev.bands, dev.offsets, x,
                                             None, plan), want)
    short = dataclasses.replace(plan, hi=plan.hi - 1)
    assert not torch.equal(dia_matvec_ring_plain(dev.bands, dev.offsets, x,
                                                 None, short), want)


def test_wrappers_check_the_plan():
    D = _random_dia(600, (-1, 0, 1))
    dev = DeviceDia.from_dia(D, mat_dtype=None, device="cpu")
    x = torch.zeros(600, dtype=torch.float64)
    ring = dp.make_plan("hbm-ring", 256, 600, dev.offsets, F64, F64, SMALL)
    with pytest.raises(AcgError):                   # a plan of another kind
        dia_spmv_windows(dev.bands, None, dev.offsets_t, x, ring)
    with pytest.raises(AcgError):                   # a plan for other rows
        dia_spmv_ring(dev.bands, None, dev.offsets_t, torch.zeros(
            1200, dtype=torch.float64), ring)
    with pytest.raises(AcgError) as e:              # no kernel off the card
        dia_spmv_ring(dev.bands.to("meta"), None, dev.offsets_t.to("meta"),
                      x.to("meta"), ring)
    assert e.value.status == Status.ERR_NOT_SUPPORTED


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode


_JAX_CASES = [   # tests/test_pallas.py's ring geometries (n, offsets, rt)
    (520 * 128, (-16384, -464, -1, 0, 1, 464, 16384), 256),
    (24 * 128, (-128, -3, 0, 3, 128), 8),
    (40 * 128, (-2100, -130, -1, 0, 1, 130, 2100), 16),
]


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("kind", ["hbm-ring", "hbm"])
@pytest.mark.parametrize("case", _JAX_CASES)
def test_plain_versions_match_pallas_interpret(case, kind, scaled):
    n, offsets, rt = case
    D = len(offsets)
    rng = np.random.default_rng(3)
    bands = rng.standard_normal((D, n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    sc = None
    if scaled:                                      # the int8 mask tier
        sc = np.arange(1.0, 1.0 + D, dtype=np.float32)
        bands = (bands > 0).astype(np.int8)
    kernel = (pk.dia_matvec_pallas_hbm2d_ring if kind == "hbm-ring"
              else pk.dia_matvec_pallas_hbm2d)
    bp, (xp,) = pk.pad_dia_operands(jnp.asarray(bands), (jnp.asarray(x),),
                                    rt, offsets)
    hp = pk.padded_halo_rows(offsets, rt) * LANES
    y_j, dot_j = kernel(bp, offsets, xp, rows_tile=rt, with_dot=True,
                        interpret=True,
                        scales=None if sc is None else jnp.asarray(sc))
    y_j = np.asarray(y_j[hp: hp + n])
    plan = dp.make_plan(kind, rt * LANES, n, offsets, F32,
                        torch.int8 if scaled else F32, SMALL)
    spmv = dia_spmv_ring if kind == "hbm-ring" else dia_spmv_windows
    y_t, dot_t = spmv(torch.from_numpy(bands),
                      None if sc is None else torch.from_numpy(sc),
                      torch.tensor(offsets), torch.from_numpy(x), plan,
                      with_dot=True)
    scale = float(np.abs(y_j).max())
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-5 * scale)
    assert abs(float(dot_t) - float(dot_j)) <= 1e-4 * max(abs(float(dot_j)),
                                                          1.0)


# ---------------------------------------------------------------------------
# whole solves through the plain versions


_SOLVES = {
    "poisson3d_12": (lambda m: m.poisson3d_7pt_dia(12),
                     lambda m: m.poisson3d_7pt_dia(12)),
    "poisson2d_32": (lambda m: JDiaMatrix.from_csr(m.poisson2d_5pt(32)),
                     lambda m: DiaMatrix.from_csr(m.poisson2d_5pt(32))),
}
_RTOL = {np.float32: 1e-5, np.float64: 1e-10}


def _routed(D, dtype, kind):
    """The port's DeviceDia on the CPU, planned by SMALL (onto the ring
    kernel), or given a windows plan at the smallest tile."""
    dev = DeviceDia.from_dia(D, dtype=dtype, device="cpu", budgets=SMALL)
    assert dev.kind == "hbm-ring"
    if kind == "hbm":
        dev = dataclasses.replace(dev, plan=dp.make_plan(
            "hbm", 256, dev.nrows_padded, dev.offsets,
            getattr(torch, np.dtype(dtype).name), dev.bands.dtype, SMALL))
    return dev


@pytest.mark.parametrize("kind", ["hbm-ring", "hbm"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(_SOLVES))
def test_cg_through_the_plain_versions_matches_jax(name, dtype, kind):
    jgen, tgen = _SOLVES[name]
    Dj, Dt = jgen(jpoisson), tgen(tpoisson)
    n = Dt.nrows
    xstar = np.random.default_rng(5).standard_normal(n)
    b = Dt.matvec(xstar)
    rtol = _RTOL[dtype]
    o = dict(maxits=2000, residual_rtol=rtol)
    rj = jcg(Dj, b, options=JOptions(**o), dtype=dtype, fmt="dia")
    dev = _routed(Dt, dtype, kind)
    rt = cg(dev, b, options=SolverOptions(**o), dtype=dtype, device="cpu")
    assert rt.converged and rj.converged
    if dtype == np.float64:
        assert rt.niterations == rj.niterations
    else:
        assert abs(rt.niterations - rj.niterations) <= 1
    xt = rt.x.astype(np.float64)
    assert (np.linalg.norm(b - Dt.matvec(xt)) / np.linalg.norm(b)
            <= 10 * rtol)
    # the same solve on the resident plan gives the same bits: the
    # planned SpMV changes where x is read from, not the arithmetic
    res = cg(DeviceDia.from_dia(Dt, dtype=dtype, device="cpu"), b,
             options=SolverOptions(**o), dtype=dtype, device="cpu")
    assert res.niterations == rt.niterations
    np.testing.assert_array_equal(res.x, rt.x)


class _OnCard:
    """The operator as the path report sees it on a card."""

    device = torch.device("cuda")

    def __init__(self, dev):
        self.dev = dev

    def __getattr__(self, name):
        return getattr(self.dev, name)


def test_path_names_the_planned_kernel():
    assert path_names("dia", "cuda", "hbm-ring") == ("dia",
                                                     "cuda-dia-hbm-ring")
    assert path_names("dia", "cuda", "hbm", rcm=True) == ("rcm+dia",
                                                          "cuda-dia-hbm")
    D = tpoisson.poisson3d_7pt_dia(6)
    for kind in ("hbm-ring", "hbm"):
        dev = _routed(D, np.float64, kind)
        # the loop body and the open-coded pipelined body name the plan;
        # the single-kernel pipelined iteration and a batch keep theirs
        card = _OnCard(dev)
        assert _describe_path(card, "dia")[1] == f"cuda-dia-{kind}"
        assert _describe_path(card, "dia", True, 50)[1] == \
            f"cuda-dia-{kind}"
        assert _describe_path(card, "dia", True)[1] == "cuda-dia-pipe"
        assert _describe_path(card, "dia", batch=2)[1] == "cuda-dia-batched"
        assert _describe_path(dev, "dia")[1] == "torch-plain"
