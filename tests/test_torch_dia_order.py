"""Port parity: the one-vector DIA kernels' geometry and plan.

The windows kernel (``csrc/dia_hbm_windows.cu``) walks its tiles in the
wave order of ``dia_plan.wave_tiles`` through a ring of 3 or 4 stages
(``dia_plan.windows_stages``); ``dia_spmv`` (``csrc/dia_spmv.cu``) has a
second kernel with the band count fixed at 3, 5, 7 or 27, which the plan
takes past the L2 (``dia_plan.resident_fixed``).  Neither changes what a
row computes, and on the CPU the wrappers run the plain versions, so
these check the geometry, the plan and the plain versions; the kernels'
own row split and ring are held to the same bits on the card
(``tests/test_torch_cuda.py``):

- the wave order visits every tile exactly once, whatever the number of
  tiles against the number of blocks;
- the windows plan's ring depths and shared memory, written out, and
  both depths reached through the budgets;
- when ``dia_spmv`` takes its fixed kernel, at the H100's budgets;
- the operator shape the plan still sends to the ring kernel;
- the plain windows version bit for bit against ``dia_matvec`` with x
  on and off a 16-byte boundary, and against the Pallas HBM kernel in
  interpret mode;
- the plain ``dia_matvec`` (what ``dia_spmv`` runs on the CPU) on the
  shapes of the card kernels' split (each band count the fixed kernel
  is compiled for and one it is not; n below the band reach; a band
  past the vector) against ``acg_tpu``'s ``dia_matvec`` and its Pallas
  kernels in interpret mode (f64 rtol 1e-12, f32 1e-5, the dot 1e-10 /
  1e-4 relative to |x|·|y|: the tolerances of ``tests/test_torch_dia.py``).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from acg_tpu.ops import dia as jdia
from acg_tpu.ops import pallas_kernels as pk

from acg_torch.ops import dia_plan as dp
from acg_torch.ops.dia import DeviceDia, DiaMatrix
from acg_torch.ops.dia_kernels import (_ring_geometry, dia_matvec,
                                       dia_matvec_ring_plain,
                                       dia_matvec_windows_plain, dia_spmv,
                                       dia_spmv_ring, dia_spmv_windows)

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
H100 = dp.Budgets(l2_bytes=50 * 2**20, smem_block=232_448,
                  smem_sm=233_472, sms=132)
SMALL = dp.Budgets(l2_bytes=1024, smem_block=232_448 // 4,
                   smem_sm=233_472 // 4, sms=3)
ROWS_TILE = 8
_TOL = {np.float64: (1e-12, 0.0, 1e-10), np.float32: (1e-5, 1e-5, 1e-4)}


# ---------------------------------------------------------------------------
# the wave order


@pytest.mark.parametrize("ntiles,nblocks", [
    (5, 12), (12, 12), (13, 12), (264, 264), (48_778, 264), (1000, 7),
    (1, 1), (7, 1)])
def test_wave_order_visits_every_tile_once(ntiles, nblocks):
    seen = [t for b in range(nblocks)
            for t in dp.wave_tiles(b, nblocks, ntiles)]
    assert sorted(seen) == list(range(ntiles))
    # every block walks upward by the grid, one tile a wave
    for b in range(nblocks):
        tiles = list(dp.wave_tiles(b, nblocks, ntiles))
        assert tiles == list(range(b, ntiles, nblocks))
        assert all(t // nblocks == k for k, t in enumerate(tiles))


def test_wave_order_keeps_the_far_windows_within_the_l2():
    """At 464^3 on the H100's plan an x tile is read as a far window
    (+nx*ny), as the centre and as the other far window (-nx*ny) by row
    tiles 2 far apart.  In the wave order every block streams one tile a
    step in tile order, so the card streams about 2 far tiles between the
    first and the last read, a fifth of the L2; in contiguous runs the
    block reaches the third read after far steps of its own, while every
    block streams a tile a step: far x nblocks tiles, a dozen L2s."""
    t = dp.windows_plan(464 ** 3, O464, F32, BF16, H100)
    p = dp.make_plan("hbm", t, 464 ** 3, O464, F32, BF16, H100)
    far = -(-215_296 // p.tile)                     # tiles to the far band
    row_bytes = 7 * 2 + 2 * 4                       # bands, x, y
    wave = 2 * far * p.tile * row_bytes
    runs = far * p.nblocks * p.tile * row_bytes
    assert wave < 50 * 2**20 / 4 and runs > 10 * 50 * 2**20
    t0, t1 = dp.run_bounds(0, p.nblocks, p.ntiles)
    assert t1 - t0 > far                            # inside one run


# ---------------------------------------------------------------------------
# the windows plan's ring


O464 = (-215296, -464, -1, 0, 1, 464, 215296)
O256 = (-65536, -256, -1, 0, 1, 256, 65536)


@pytest.mark.parametrize("stages", dp.STAGES)
def test_windows_bytes_written_out(stages):
    # 464^3, T = 1024, f32 vectors, bf16 bands: windows 1028 + 1956 +
    # 1028 elements (each a whole number of 16-byte chunks), 7 band tiles
    lay = dp.window_layout(O464, 1024, 4)
    assert [ln for _, ln, _ in lay] == [1028, 1956, 1028]
    head = -(-(16 * stages + 4 * 7) // 128) * 128
    stage = 4012 * 4 + 7 * 1024 * 2
    assert dp.windows_bytes(O464, 1024, 4, 2, 7, stages) == \
        head + stages * stage + 256 * 4


def test_windows_stages_follow_the_budget():
    # the deepest ring of 4 or 3 stages that fits one block (232,448
    # bytes), else none
    for tile in (2048, 1024, 512, 256):
        assert dp.windows_stages(464 ** 3, O464, F32, BF16, tile,
                                 H100) == 4
    assert dp.windows_stages(464 ** 3, O464, F64, BF16, 2048, H100) is None
    assert dp.windows_stages(464 ** 3, O464, F64, BF16, 1024, H100) == 4
    assert dp.windows_stages(256 ** 3, O256, F64, F64, 1024, H100) is None
    assert dp.windows_stages(256 ** 3, O256, F64, F64, 512, H100) == 4
    o2d = (-10_000, -1, 0, 1, 10_000)               # 5 f64 band tiles
    assert dp.windows_stages(10 ** 8, o2d, F64, F64, 1024, H100) == 3
    # the plan's tile: the largest of 1024, 512, 256 with such a ring
    assert dp.windows_plan(464 ** 3, O464, F32, BF16, H100) == 1024
    assert dp.windows_plan(256 ** 3, O256, F64, F64, H100) == 512


@pytest.mark.parametrize("stages", dp.STAGES)
def test_plan_depth_follows_the_block_budget(stages):
    """A block budget that holds a ring of ``stages`` and not a deeper
    one plans that depth: 464^3 at T = 1024, f32 vectors and bf16 bands,
    a head of 128 bytes and per stage 4012 * 4 + 7 * 1024 * 2 = 30,384,
    and the dot's 1,024: 4 stages 122,688 bytes, 3 stages 92,304; one
    block an SM when the block budget is the SM's less the card's 1 KB
    reserve."""
    need = dp.windows_bytes(O464, 1024, 4, 2, 7, stages)
    assert need == 128 + stages * 30_384 + 1024
    assert need == {4: 122_688, 3: 92_304}[stages]
    budgets = dp.Budgets(l2_bytes=H100.l2_bytes, smem_block=need,
                         smem_sm=need + 1024, sms=132)
    p = dp.make_plan("hbm", 1024, 464 ** 3, O464, F32, BF16, budgets)
    assert p.stages == stages and p.smem == need - 1024
    assert p.nblocks == 132
    # the card's own budget takes the deepest
    assert dp.make_plan("hbm", 1024, 464 ** 3, O464, F32, BF16,
                        H100).stages == 4


# ---------------------------------------------------------------------------
# the ring plan's slots and depth

O2D = (-10_000, -1, 0, 1, 10_000)


@pytest.mark.parametrize("stages", dp.RING_STAGES)
def test_ring_bytes_written_out(stages):
    # 10,000^2, T = 1024, f32 vectors, bf16 bands: span -10 .. 10 (21 x
    # tiles) and one slot more for each further row tile in flight; a
    # head of 2 x (stages + slots) mbarriers and 5 positions
    slots = 21 + stages - 1
    assert dp.ring_slots(O2D, 1024, stages) == slots
    head = -(-(16 * (stages + slots) + 4 * 5) // 128) * 128
    assert dp.ring_bytes(O2D, 1024, 4, 2, 5, stages) == \
        head + slots * 1024 * 4 + stages * 5 * 1024 * 2 + 256 * 4
    # int8 bands, a span of 3 tiles: the head grows with the slots
    head = -(-(16 * (2 * stages + 2) + 4 * 3) // 128) * 128
    assert head == {4: 256, 3: 256, 2: 128}[stages]
    assert dp.ring_bytes((-1, 0, 1), 256, 4, 1, 3, stages) == \
        head + (2 + stages) * 256 * 4 + stages * 3 * 256 + 256 * 4


def test_ring_stages_follow_the_budget():
    # two blocks an SM first: at 10,000^2 bf16/f32 and T = 1024 a ring of
    # 2 row tiles in flight (111,104 bytes and the dot's 1,024) lets two
    # blocks share an SM's 233,472, 3 (125,440) and 4 (139,776) do not
    assert dp.ring_bytes(O2D, 1024, 4, 2, 5, 2) == 112_128
    assert dp.blocks_per_sm(112_128, H100, dp.WINDOWS_THREADS) == 2
    assert dp.blocks_per_sm(dp.ring_bytes(O2D, 1024, 4, 2, 5, 3), H100,
                            dp.WINDOWS_THREADS) == 1
    assert dp.ring_stages(10 ** 8, O2D, F32, BF16, 1024, H100) == 2
    p = dp.make_plan("hbm-ring", 1024, 10 ** 8, O2D, F32, BF16, H100)
    assert (p.stages, p.nblocks) == (2, 264)
    # else the deepest of 4, 3, 2 that fits one block (232,448 bytes), at
    # the largest of 1024, 512, 256 that has one
    assert dp.ring_stages(10 ** 8, O2D, F64, BF16, 1024, H100) == 3
    assert dp.ring_stages(10 ** 8, O2D, F64, F64, 1024, H100) is None
    assert dp.ring_stages(10 ** 8, O2D, F64, F64, 512, H100) == 2
    assert dp.ring_stages(10 ** 8, O2D, F64, F64, 256, H100) == 4
    assert dp.ring_plan(10 ** 8, O2D, F32, BF16, H100) == 1024
    assert dp.ring_plan(10 ** 8, O2D, F64, F64, H100) == 512
    p = dp.make_plan("hbm-ring", 512, 10 ** 8, O2D, F64, F64, H100)
    assert (p.lo, p.hi, p.stages, p.nblocks) == (-20, 20, 2, 132)
    assert p.smem == dp.ring_bytes(O2D, 512, 8, 8, 5, 2) - 256 * 8
    # a 3-D operator's +-nx*ny span holds no ring at any tile or depth
    assert dp.ring_plan(464 ** 3, O464, F32, BF16, H100) is None


@pytest.mark.parametrize("stages", dp.RING_STAGES)
def test_ring_plan_depth_follows_the_block_budget(stages):
    """A block budget that holds a ring of ``stages`` row tiles and not a
    deeper one plans that depth (one block an SM when the block budget is
    the SM's less the card's 1 KB reserve: no depth lets two blocks share
    it); the card's own budget takes the depth at which two blocks do."""
    need = dp.ring_bytes(O2D, 1024, 4, 2, 5, stages)
    budgets = dp.Budgets(l2_bytes=H100.l2_bytes, smem_block=need,
                         smem_sm=need + 1024, sms=132)
    assert dp.ring_plan(10 ** 8, O2D, F32, BF16, budgets) == 1024
    p = dp.make_plan("hbm-ring", 1024, 10 ** 8, O2D, F32, BF16, budgets)
    assert p.stages == stages and p.smem == need - 1024
    assert p.nblocks == 132
    p = dp.make_plan("hbm-ring", 1024, 10 ** 8, O2D, F32, BF16, H100)
    assert (p.stages, p.nblocks) == (2, 264)


# ---------------------------------------------------------------------------
# dia_spmv's fixed kernel and the ring: what the plan takes


@pytest.mark.parametrize("case", [
    # (n, band count, vector dtype, band dtype, fixed): past the L2
    # (52,428,800 bytes) with f32 vectors and 3, 5, 7 or 27 bands.
    # 128^3 bf16/f32: 7 * 2,097,152 * 2 + 2 * 2,097,152 * 4 = 46,137,344
    (128 ** 3, 7, F32, BF16, False),
    # int8 at 256^3: 7 * 16,777,216 + 8 * 16,777,216 = 251,658,240
    (256 ** 3, 7, F32, torch.int8, True),
    (256 ** 3, 7, F32, BF16, True),
    # the 256 x 128 x 128 shard: 7 * 4,194,304 * 2 + 8 * 4,194,304 =
    # 92,274,688
    (256 * 128 * 128, 7, F32, BF16, True),
    (464 ** 3, 7, F32, BF16, True),
    (10 ** 8, 5, F32, BF16, True),
    (10 ** 6, 3, F32, F32, False),                  # 20,000,000
    (10 ** 7, 3, F32, F32, True),                   # 200,000,000
    (256 ** 3, 27, F32, BF16, True),
    (256 ** 3, 7, F64, F64, False),                 # f64 vectors
    (256 ** 3, 4, F32, BF16, False),                # no fixed kernel
    (256 ** 3, 9, F32, BF16, False),
])
def test_resident_fixed_at_h100_budgets(case):
    n, nd, vdt, bdt, want = case
    H = dp.Budgets(l2_bytes=52_428_800, smem_block=232_448,
                   smem_sm=233_472, sms=132)
    assert dp.resident_fixed(n, nd, vdt, bdt, H) is want
    assert dp.resident_fixed(n, nd, vdt, bdt, None) is False   # the CPU


def _ring_offsets():
    """31 bands in 16 offset clusters over +-11,783: +-1537 k and
    +-(1537 k + 1024), k = 0..7."""
    return tuple(sorted({s * (1537 * k + e) for k in range(8)
                         for e in (0, 1024) for s in (1, -1)}))


def test_ring_is_planned_only_for_many_clusters_over_a_short_span():
    """Where its span fits one block the ring comes first (the JAX plan's
    order); where it does not, the windows.  An operator of many offset
    clusters over a short span holds no windows ring at all: at 16
    clusters the windows of 3 stages at T = 256 need 240,128 bytes (a
    head of 6 mbarriers and 31 positions, 256 bytes; a stage eight
    windows of 1284 f32 elements, seven of 772, one of 260, and 31 bf16
    band tiles; the dot's tree), past the block's 232,448.  The ring at T
    = 512 and 3 row tiles in flight holds 2 x 24 + 3 slots of x and three
    sets of band tiles behind a head of 2 x (3 + 51) mbarriers and 31
    positions (1,024 bytes): 201,728 bytes; 4 in flight (235,520) and T =
    1024 at any depth do not fit.  At f64 vectors only T = 256 with 2 in
    flight fits (232,192 bytes: 96 slots of 2 KB), so the ring's depths
    go down to 2."""
    o = _ring_offsets()
    assert len(o) == 31 and len(dp.cluster_windows(o)) == 16
    assert dp.windows_bytes(o, 256, 4, 2, 31, 3) == \
        256 + 3 * ((8 * 1284 + 7 * 772 + 260) * 4 + 31 * 256 * 2) + 1024
    assert dp.windows_bytes(o, 256, 4, 2, 31, 3) == 240_128
    assert dp.windows_plan(10 ** 8, o, F32, BF16, H100) is None
    assert dp.fused_plan_for(10 ** 8, o, F32, BF16, H100) == ("hbm-ring",
                                                               512)
    assert dp.ring_span(o, 512) == (-24, 24)
    assert dp.ring_slots(o, 512, 3) == 51
    assert dp.ring_bytes(o, 512, 4, 2, stages=3) == \
        1024 + 51 * 512 * 4 + 3 * 31 * 512 * 2 + 256 * 4
    assert dp.ring_bytes(o, 512, 4, 2, stages=3) == 201_728
    assert dp.ring_bytes(o, 512, 4, 2, stages=4) == 235_520
    assert dp.ring_stages(10 ** 8, o, F32, BF16, 512, H100) == 3
    assert dp.ring_stages(10 ** 8, o, F32, BF16, 1024, H100) is None
    assert dp.fused_plan_for(10 ** 8, o, F64, BF16, H100) == ("hbm-ring",
                                                               256)
    assert dp.ring_bytes(o, 256, 8, 2, stages=2) == \
        1792 + 96 * 256 * 8 + 2 * 31 * 256 * 2 + 256 * 8
    assert dp.ring_bytes(o, 256, 8, 2, stages=2) == 232_192
    assert dp.ring_stages(10 ** 8, o, F64, BF16, 256, H100) == 2
    # the 7-band 3-D operators chip_smoke.py drives span more than a ring
    # holds (+-nx*ny): the windows; the 5-band 2-D one takes the ring
    for n, offsets in ((464 ** 3, O464), (256 ** 3, O256)):
        assert dp.ring_plan(n, offsets, F32, BF16, H100) is None
        assert dp.fused_plan_for(n, offsets, F32, BF16, H100)[0] == "hbm"
    assert dp.fused_plan_for(10 ** 8, O2D, F32, BF16, H100) == ("hbm-ring",
                                                                1024)


# ---------------------------------------------------------------------------
# the plain windows version


def _random_dia(n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            bands[d, max(n - off, 0):] = 0.0
        elif off < 0:
            bands[d, : min(-off, n)] = 0.0
    return DiaMatrix(n, n, tuple(offsets), bands, int((bands != 0).sum()))


def _shifted(v, shift):
    """``v`` as a view ``shift`` elements into a larger buffer: x off a
    16-byte boundary moves every window's alignment shift."""
    buf = torch.zeros(v.shape[0] + shift, dtype=v.dtype)
    buf[shift:] = v
    return buf[shift:]


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("vdt", [F32, F64])
@pytest.mark.parametrize("n,offsets,tile", [
    (30_007, (-4000, -150, -1, 0, 1, 150, 4000), 512),   # 7 bands
    (20_000, (-3000, -31, 0, 31, 3000), 256),            # 5 bands
    (700, (-900, -1, 0, 1, 299), 256),                   # a band past x
])
def test_windows_plain_on_and_off_a_16_byte_boundary(n, offsets, tile, vdt,
                                                     shift):
    dev = DeviceDia.from_dia(_random_dia(n, offsets), dtype=str(vdt)[6:],
                             mat_dtype=None, device="cpu")
    plan = dp.make_plan("hbm", tile, dev.nrows_padded, dev.offsets, vdt,
                        dev.bands.dtype, SMALL)
    x = _shifted(torch.from_numpy(np.random.default_rng(1).standard_normal(
        dev.nrows_padded)).to(vdt), shift)
    assert x.data_ptr() % 16 // x.element_size() == shift % (
        16 // x.element_size())
    want = dia_matvec(dev.bands, dev.offsets, x)
    assert torch.equal(dia_matvec_windows_plain(dev.bands, dev.offsets, x,
                                                None, plan), want)
    y, dot = dia_spmv_windows(dev.bands, None, dev.offsets_t, x, plan,
                              with_dot=True)
    assert torch.equal(y, want) and torch.equal(dot, torch.dot(x, want))


# (n, offsets, whether the ring is read): spans of 7 and 13 tiles at T =
# 256 with bulk-copied tiles in the middle of the runs and a ragged last
# tile; band rows off a 16-byte boundary (n * 4 bytes), and a band
# reaching past the vector: every row straight from x
_RING_PLAIN = [(20_000, (-700, -1, 0, 1, 700), True),
               (9_008, (-1300, -257, 0, 257, 1300), True),
               (9_001, (-1300, -257, 0, 257, 1300), False),
               (3_000, (-3500, 0, 600), False)]


@pytest.mark.parametrize("nblocks", [1, 3, "per tile"])
@pytest.mark.parametrize("stages", dp.RING_STAGES)
@pytest.mark.parametrize("tile", [256, 512])
@pytest.mark.parametrize("n,offsets,bulk", _RING_PLAIN)
def test_ring_plain_follows_the_new_slot_mapping(n, offsets, bulk, tile,
                                                 stages, nblocks):
    """The plain ring reads every bulk-copied row through its ring of
    hi - lo + stages slots, filled as the producer may have filled it
    ``stages`` row tiles ahead, and the rest straight from x: bit-equal
    to dia_matvec at every tile, depth and grid, down to one row tile a
    block (a run shorter than the span); the dot through the wrapper too;
    x off a 16-byte boundary sends every row to the straight path."""
    D = _random_dia(n, offsets, seed=tile + stages)
    dev = DeviceDia.from_dia(D, dtype="float32", mat_dtype="float32",
                             device="cpu")
    plan = dp.make_plan("hbm-ring", tile, dev.nrows_padded, dev.offsets,
                        F32, dev.bands.dtype, SMALL)
    nb = plan.ntiles if nblocks == "per tile" else nblocks
    plan = dataclasses.replace(plan, stages=stages, nblocks=nb)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        dev.nrows_padded).astype(np.float32))
    want = dia_matvec(dev.bands, dev.offsets, x)
    for xx in (x, _shifted(x, 1)):
        got = dia_matvec_ring_plain(dev.bands, dev.offsets, xx, None, plan)
        assert torch.equal(got, want)
    t0, t1, c0, c1 = _ring_geometry(dev.bands, list(dev.offsets), x, plan)
    assert (int((c1 - c0).sum()) > 0) == bulk   # the ring was read
    assert bool(torch.all((t0 <= c0) & (c0 <= c1) & (c1 <= t1)))
    y, dot = dia_spmv_ring(dev.bands, None, dev.offsets_t, x, plan,
                           with_dot=True)
    assert torch.equal(y, want) and torch.equal(dot, torch.dot(x, want))


def test_ring_plain_poisons_what_the_ring_does_not_hold():
    """One slot too few (a plan whose span is a tile short) reads x tiles
    the ring does not hold for that row tile: NaN, not x."""
    D = _random_dia(20_000, (-700, 0, 700))
    dev = DeviceDia.from_dia(D, dtype="float64", mat_dtype=None,
                             device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(20_000))
    plan = dp.make_plan("hbm-ring", 256, 20_000, dev.offsets, F64, F64,
                        SMALL)
    short = dataclasses.replace(plan, hi=plan.hi - 1)
    got = dia_matvec_ring_plain(dev.bands, dev.offsets, x, None, short)
    assert bool(torch.isnan(got).any())


@pytest.mark.parametrize("shift", [0, 1])
def test_windows_plain_matches_pallas_hbm_interpret(shift):
    n, offsets, rt = 40 * 128, (-2100, -130, -1, 0, 1, 130, 2100), 16
    rng = np.random.default_rng(4)
    bands = rng.standard_normal((len(offsets), n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    bp, (xp,) = pk.pad_dia_operands(jnp.asarray(bands), (jnp.asarray(x),),
                                    rt, offsets)
    hp = pk.padded_halo_rows(offsets, rt) * 128
    y_j, dot_j = pk.dia_matvec_pallas_hbm2d(bp, offsets, xp, rows_tile=rt,
                                            with_dot=True, interpret=True)
    y_j = np.asarray(y_j[hp: hp + n])
    plan = dp.make_plan("hbm", rt * 128, n, offsets, F32, F32, SMALL)
    y_t, dot_t = dia_spmv_windows(torch.from_numpy(bands), None,
                                  torch.tensor(offsets),
                                  _shifted(torch.from_numpy(x), shift),
                                  plan, with_dot=True)
    scale = float(np.abs(y_j).max())
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-5 * scale)
    assert abs(float(dot_t) - float(dot_j)) <= 1e-4 * max(abs(float(dot_j)),
                                                          1.0)


# ---------------------------------------------------------------------------
# dia_spmv's plain version on the shapes of the card kernel's split


_O27 = tuple(sorted(a * 100 + b * 10 + c for a in (-1, 0, 1)
                    for b in (-1, 0, 1) for c in (-1, 0, 1)))
_SPLIT = [
    # (n, offsets): each band count the fixed kernel is compiled for (3,
    # 5, 7, 27), one it is not (4), n below the band reach (no row has
    # every column inside [0, n)), a band past the vector; n a multiple
    # of the Pallas kernels' 8 x 128 tile.  On the CPU dia_spmv is the
    # plain dia_matvec, which has no split: these hold the plain version
    # on those shapes; the split itself is held to the same bits on the
    # card (tests/test_torch_cuda.py test_dia_spmv_fixed_bands_equal_batched)
    (1024, (-1, 0, 1)),
    (1024, (-33, -1, 0, 1, 33)),
    (2048, (-300, -128, -1, 0, 1, 128, 300)),
    (2048, _O27),
    (1024, (-2, 0, 1, 5)),
    (1024, (-600, -1, 0, 1, 600)),
    (1024, (-1, 0, 1, 1030)),
]


def _pair(n, offsets, vdt, mat):
    bands = _random_dia(n, offsets, seed=len(offsets)).bands
    if mat == "auto":
        bands = np.sign(bands) * 0.5
    Dj = jdia.DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))
    jdev = jdia.DeviceDia.from_dia(Dj, dtype=vdt, mat_dtype=mat)
    Dt = DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))
    tdev = DeviceDia.from_dia(Dt, dtype=vdt, mat_dtype=mat, device="cpu")
    x = np.zeros(tdev.nrows_padded, dtype=vdt)
    x[:n] = np.random.default_rng(11).standard_normal(n)
    return Dj, jdev, tdev, x


@pytest.mark.parametrize("mat", ["auto", None])
@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("n,offsets", _SPLIT)
def test_plain_on_split_shapes_matches_jax_dia_matvec(n, offsets, vdt, mat):
    rtol, atol, _ = _TOL[vdt]
    Dj, jdev, tdev, x = _pair(n, offsets, vdt, mat)
    # acg_tpu's dia_matvec refuses a band past the vector, which adds
    # nothing (a difference on purpose, ROADMAP Queue 3): leave it out
    live = [d for d, o in enumerate(offsets) if abs(o) < n]
    want = np.asarray(jdia.dia_matvec(
        jdev.bands[jnp.asarray(live)], tuple(offsets[d] for d in live),
        jnp.asarray(x),
        scales=None if jdev.scales is None else jdev.scales[
            jnp.asarray(live)]))
    got = dia_spmv(tdev.bands, tdev.scales, tdev.offsets_t,
                   torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    # and the host oracle on the rows it defines
    if all(abs(o) < n for o in offsets):
        np.testing.assert_allclose(got.numpy()[:n],
                                   Dj.matvec(x[:n].astype(np.float64)),
                                   rtol=max(rtol, 1e-6), atol=1e-5)


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("n,offsets", _SPLIT)
def test_plain_on_split_shapes_matches_pallas_interpret(n, offsets, vdt):
    """with_dot against dia_matvec_pallas_2d_padded in interpret mode, on
    operands padded by JAX's pad_dia_operands and sliced back out."""
    rtol, atol, dot_rtol = _TOL[vdt]
    _, jdev, tdev, x = _pair(n, offsets, vdt, None)
    npad = x.shape[0]
    bp, (xp,) = pk.pad_dia_operands(jdev.bands, (jnp.asarray(x),),
                                    ROWS_TILE, jdev.offsets)
    front = pk.padded_halo_rows(jdev.offsets, ROWS_TILE) * pk.LANES
    yj, dj = pk.dia_matvec_pallas_2d_padded(bp, jdev.offsets, xp,
                                            rows_tile=ROWS_TILE,
                                            with_dot=True, interpret=True,
                                            scales=jdev.scales)
    yj = np.asarray(yj)[front: front + npad]
    y, d = dia_spmv(tdev.bands, tdev.scales, tdev.offsets_t,
                    torch.from_numpy(x), with_dot=True)
    np.testing.assert_allclose(y.numpy(), yj, rtol=rtol, atol=atol)
    scale = np.linalg.norm(x) * np.linalg.norm(yj)
    assert abs(float(d) - float(dj)) <= dot_rtol * scale
