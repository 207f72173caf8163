"""Which DIA SpMV kernel a one-vector operator application takes.

The port of the planning half of ``acg_tpu/ops/pallas_kernels.py``
(``_cluster_windows``, ``_ring_span``, ``pallas_hbm2d_ring_plan``,
``pallas_hbm2d_plan``, ``hbm_kernel_plan``, ``fused_plan_for``), with
the card's own budgets in place of the TPU's VMEM budget:

- **resident** (``dia_spmv``): while the vector x fits the device's L2
  cache, the on-chip store that kernel leans on for x, as the TPU's
  resident kernel leans on VMEM; and past it for full-width f64 bands;
- **hbm-ring** (``dia_spmv_ring``): past it, while one block's ring of
  consecutive x tiles spanning the whole offset reach, two to four row
  tiles deep, and as many stages of band tiles fit one block's opt-in
  shared memory; x then streams once;
- **hbm** (``dia_spmv_windows``): else while a ring of three or four
  stages, each one x window per offset cluster and the band tiles of one
  tile, fits the same budget;
- **resident** again when neither fits, as the JAX package falls back
  to its non-HBM path.

The order is the JAX package's: on an H100 the ring took 0.651 ms a call
(queued back to back) on 10,000^2 bf16/f32 against the windows' 0.678-
0.682, and 0.969 against 1.294-1.304 with f64 vectors (PERF.md).
One choice differs from the JAX package's, on measurements on the same
card: f64 bands stay on ``dia_spmv`` past the L2 (on 10,000^2 f64/f64
1.93-2.01 ms against the windows' 2.08-2.26; the ring, redesigned, ties
it at 1.92-1.93 queued; at 256^3 f64/f64 0.46-0.50 against 0.50-0.52):
with 8-byte bands the band stream, which no staging shortens, is most of
the traffic.  The port has no (rows, 128) layout, so everything here
is in elements: a tile is ``T`` elements and the cluster slack is 1024
elements (JAX's 8 rows of 128 lanes); for offsets that are multiples of
128 and ``T = rt * 128`` the spans and clusters equal the JAX
package's.  Unlike the JAX plans, f64 vectors and bands are admitted.
Bands whose offset reaches past the whole vector (|offset| >= n)
contribute nothing and are left out of the geometry.  The plan
functions take the budgets as arguments
(:class:`Budgets`); :func:`device_budgets` reads them from the card.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Budgets", "HbmPlan", "SLACK", "STAGES", "RING_STAGES", "TILES",
           "THREADS", "WINDOWS_THREADS", "WINDOW_TILES", "FIXED_BANDS",
           "blocks_per_sm", "cluster_windows", "device_budgets",
           "fused_plan_for", "hbm_kernel_plan", "make_plan", "pipe_bytes",
           "PIPE_FIXED", "pipe_fixed", "resident_fixed", "ring_bytes",
           "ring_plan", "ring_span", "ring_slots", "ring_stages", "run_bounds",
           "wave_tiles", "window_layout", "windows_bytes", "windows_plan",
           "windows_stages"]

SLACK = 1024                    # JAX's 8 rows x 128 lanes, in elements
TILES = (2048, 1024, 512, 256)  # x tiles (elements) the tile sweeps try
#                                 (scripts/torch_hbm_tiles.py)
THREADS = 256                   # threads per block (acg::kThreads)
WINDOWS_THREADS = THREADS + 32  # a block of either HBM kernel: its
#                                 consumers and its producer warp
STAGES = (4, 3)                 # ring depths the windows plan tries,
#                                 deepest first
RING_STAGES = (4, 3, 2)         # row tiles in flight the ring plan tries,
#                                 deepest first (2: the depth at which the
#                                 widest spans still fit, PERF.md)
WINDOW_TILES = (1024, 512, 256)  # both HBM plans' tiles, largest first
#                                  (2048 ran slower than 1024 at every
#                                  depth of the windows, PERF.md)
FIXED_BANDS = (3, 5, 7, 27)     # the band counts the fixed kernels of
#                                 dia_spmv and cg_pipelined_iter are
#                                 compiled for
MAX_THREADS_PER_SM = 2048
_COPY_BYTES = 16                # one cp.async chunk


@dataclasses.dataclass(frozen=True)
class Budgets:
    """The card's budgets: L2 bytes, the opt-in shared memory of one
    block, the shared memory of one SM, and the SM count."""

    l2_bytes: int
    smem_block: int
    smem_sm: int
    sms: int


def device_budgets(device: torch.device) -> Budgets | None:
    """The budgets of a CUDA device, read from
    ``torch.cuda.get_device_properties``; None for the CPU, where every
    operator takes the resident plan unless the caller passes budgets."""
    if device.type != "cuda":
        return None
    p = torch.cuda.get_device_properties(device)
    return Budgets(l2_bytes=int(p.L2_cache_size),
                   smem_block=int(p.shared_memory_per_block_optin),
                   smem_sm=int(p.shared_memory_per_multiprocessor),
                   sms=int(p.multi_processor_count))


def _live(offsets, n: int) -> tuple:
    """The offsets of bands that can touch the vector (|offset| < n)."""
    return tuple(int(o) for o in offsets if abs(int(o)) < n)


def cluster_windows(offsets, slack: int = SLACK) -> tuple:
    """Group diagonals into x windows by offset (``_cluster_windows``):
    offsets within ``slack`` elements of a cluster's smallest share one
    window.  Returns a tuple of ``(lo, ext, bands)``: a tile of T rows at
    ``base`` reads x[base + lo, base + T + lo + ext) through the window,
    and ``bands`` is a tuple of ``(band_index, offset)`` in ascending
    offset order."""
    items = sorted((int(off), d) for d, off in enumerate(offsets))
    windows = []
    for off, d in items:
        if windows and off - windows[-1][0] <= slack:
            lo, _, bands = windows[-1]
            windows[-1] = (lo, off - lo, bands + ((d, off),))
        else:
            windows.append((off, 0, ((d, off),)))
    return tuple(windows)


def ring_span(offsets, tile: int) -> tuple[int, int]:
    """(lo, hi): the x tiles, relative to the row tile, that a row tile's
    diagonals reach (``_ring_span``): row i of tile t reads element
    t*T + i + off, so tiles t + off // T .. t + (off + T - 1) // T."""
    lo = hi = 0
    for off in offsets:
        lo = min(lo, int(off) // tile)
        hi = max(hi, (int(off) + tile - 1) // tile)
    return lo, hi


def _static_bytes(itemsize: int) -> int:
    """Static shared memory of either kernel: the fused dot's tree."""
    return THREADS * itemsize


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def ring_slots(offsets, tile: int, stages: int) -> int:
    """x tiles in the ring kernel's ring: the span ``hi - lo + 1`` of one
    row tile and one more tile for each further row tile in flight, so
    that every one of the ``stages`` row tiles the producer may have
    filled ahead has its whole span resident."""
    lo, hi = ring_span(offsets, tile)
    return hi - lo + stages


def ring_bytes(offsets, tile: int, itemsize: int, band_itemsize: int,
               ndiags: int | None = None,
               stages: int = RING_STAGES[-1]) -> int:
    """Shared memory of the ring kernel (``dia_hbm_ring.cu``): a head of
    the 2 x ``stages`` band mbarriers, the 2 x slots x-tile mbarriers (8
    bytes each) and each band's position in the ring (int32), rounded up
    to 128 bytes; the ring of :func:`ring_slots` x tiles; ``stages``
    buffers of the ``ndiags`` band tiles (by default one band per
    offset), each rounded up to 16 bytes; and the dot's tree."""
    nd = len(offsets) if ndiags is None else ndiags
    slots = ring_slots(offsets, tile, stages)
    return (_round(16 * (stages + slots) + 4 * nd, 128)
            + slots * tile * itemsize
            + stages * _round(nd * tile * band_itemsize, 16)
            + _static_bytes(itemsize))


def window_layout(offsets, tile: int, itemsize: int) -> tuple:
    """One buffer of the windows kernel: ``(lo, length, base)`` per
    cluster, in elements.  A window starts up to one 16-byte chunk early
    so that its copies are aligned, and its length is a whole number of
    chunks, so every window starts 16-byte aligned."""
    ve = _COPY_BYTES // itemsize
    out, base = [], 0
    for lo, ext, _ in cluster_windows(offsets):
        length = -(-(tile + ext + ve - 1) // ve) * ve
        out.append((lo, length, base))
        base += length
    return tuple(out)


def _round(nbytes: int, to: int) -> int:
    return -(-nbytes // to) * to


def windows_bytes(offsets, tile: int, itemsize: int, band_itemsize: int,
                  ndiags: int | None = None, stages: int = STAGES[-1]) -> int:
    """Shared memory of the windows kernel (``dia_hbm_windows.cu``): a
    head of the 2 x ``stages`` mbarriers (8 bytes each) and each band's
    window position (int32), rounded up to 128 bytes; ``stages`` buffers,
    each every cluster's window and the ``ndiags`` band tiles (by default
    one band per offset), each part rounded up to 16 bytes; and the
    dot's tree."""
    buf = sum(length for _, length, _ in window_layout(offsets, tile,
                                                       itemsize))
    nd = len(offsets) if ndiags is None else ndiags
    stage = _round(buf * itemsize, 16) + _round(nd * tile * band_itemsize,
                                                16)
    return (_round(16 * stages + 4 * nd, 128) + stages * stage
            + _static_bytes(itemsize))


def blocks_per_sm(smem: int, budgets: Budgets,
                  threads: int = THREADS) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory
    that fit one SM, at most the thread limit's; the SM reserves what its
    total exceeds one block's opt-in for every block."""
    reserve = budgets.smem_sm - budgets.smem_block
    return min(MAX_THREADS_PER_SM // threads,
               budgets.smem_sm // (smem + reserve))


def ring_stages(n: int, offsets, vec_dtype, band_dtype, tile: int,
                budgets: Budgets) -> int | None:
    """The ring kernel's depth at ``tile``: the deepest of
    ``RING_STAGES`` whose ring fits one block; None when none does."""
    live = _live(offsets, n)
    vb, mb = _itemsize(vec_dtype), _itemsize(band_dtype)
    for s in RING_STAGES:
        if ring_bytes(live, tile, vb, mb, len(offsets),
                      s) <= budgets.smem_block:
            return s
    return None


def _ring_fits(n: int, offsets, vec_dtype, band_dtype, budgets: Budgets,
               blocks: int) -> tuple | None:
    """``(tile, stages)``: the largest of ``WINDOW_TILES`` with a ring
    depth of ``RING_STAGES`` of which ``blocks`` blocks fit one SM, at
    the deepest such depth; None when none does."""
    live = _live(offsets, n)
    vb, mb = _itemsize(vec_dtype), _itemsize(band_dtype)
    for t in WINDOW_TILES:
        for s in RING_STAGES:
            need = ring_bytes(live, t, vb, mb, len(offsets), s)
            if need <= budgets.smem_block and blocks_per_sm(
                    need, budgets, WINDOWS_THREADS) >= blocks:
                return t, s
    return None


def ring_stages(n: int, offsets, vec_dtype, band_dtype, tile: int,
                budgets: Budgets) -> int | None:
    """The ring kernel's depth at ``tile``: the deepest of
    ``RING_STAGES`` at which two blocks fit an SM when the plan's tile
    holds two there, else the deepest whose ring fits one block; None
    when none does."""
    live = _live(offsets, n)
    vb, mb = _itemsize(vec_dtype), _itemsize(band_dtype)
    fits = [s for s in RING_STAGES
            if ring_bytes(live, tile, vb, mb, len(offsets),
                          s) <= budgets.smem_block]
    two = _ring_fits(n, offsets, vec_dtype, band_dtype, budgets, 2)
    if two is not None and two[0] == tile:
        return two[1]
    return fits[0] if fits else None


def ring_plan(n: int, offsets, vec_dtype, band_dtype,
              budgets: Budgets) -> int | None:
    """Tile of the ring kernel, or None when no ring fits one block
    (``pallas_hbm2d_ring_plan``): the largest of ``WINDOW_TILES`` at
    which two blocks of some depth of ``RING_STAGES`` fit an SM, else the
    largest at which one block fits (:func:`ring_stages` then gives the
    depth).  On an H100 two blocks a ring ran ahead of one deeper block
    at every tile (10,000^2 bf16/f32 at T = 1024: 2 row tiles in flight
    and two blocks an SM 0.650 ms a call queued against 0.694 for 4 in
    flight and one block, PERF.md)."""
    if not _live(offsets, n):
        return None
    for blocks in (2, 1):
        fit = _ring_fits(n, offsets, vec_dtype, band_dtype, budgets, blocks)
        if fit is not None:
            return fit[0]
    return None


def windows_stages(n: int, offsets, vec_dtype, band_dtype, tile: int,
                   budgets: Budgets) -> int | None:
    """The windows kernel's ring depth at ``tile``: the deepest of
    ``STAGES`` whose ring fits one block; None when none does."""
    live = _live(offsets, n)
    vb, mb = _itemsize(vec_dtype), _itemsize(band_dtype)
    for s in STAGES:
        if windows_bytes(live, tile, vb, mb, len(offsets),
                         s) <= budgets.smem_block:
            return s
    return None


def windows_plan(n: int, offsets, vec_dtype, band_dtype,
                 budgets: Budgets) -> int | None:
    """Tile of the clustered-window kernel, or None when no ring of its
    windows fits one block (``pallas_hbm2d_plan``): the largest of
    ``WINDOW_TILES`` at which a ring of ``STAGES`` depth fits one block
    (on the card the deepest ring at 1024 was fastest or within the
    spread of the fastest in every cell, PERF.md)."""
    if not _live(offsets, n):
        return None
    return next((t for t in WINDOW_TILES
                 if windows_stages(n, offsets, vec_dtype, band_dtype, t,
                                   budgets) is not None), None)


def hbm_kernel_plan(n: int, offsets, vec_dtype, band_dtype,
                    budgets: Budgets):
    """``(kind, tile)`` for x past the L2, the ring before the windows
    (the one owner of that priority, the JAX package's
    ``hbm_kernel_plan`` order), or ``(None, None)``."""
    tile = ring_plan(n, offsets, vec_dtype, band_dtype, budgets)
    if tile is not None:
        return "hbm-ring", tile
    tile = windows_plan(n, offsets, vec_dtype, band_dtype, budgets)
    if tile is not None:
        return "hbm", tile
    return None, None


def fused_plan_for(n: int, offsets, vec_dtype, band_dtype,
                   budgets: Budgets | None) -> tuple[str, int | None]:
    """``("resident" | "hbm-ring" | "hbm", tile)`` for a one-vector DIA
    SpMV of ``n`` rows (``fused_plan_for``); the resident kernel has no
    tile (None).  ``budgets`` None (the CPU) is always resident, and so
    are full-width f64 bands (module docstring)."""
    if budgets is None:
        return "resident", None
    if (n * _itemsize(vec_dtype) <= budgets.l2_bytes
            or _itemsize(band_dtype) >= 8):
        return "resident", None
    kind, tile = hbm_kernel_plan(n, offsets, vec_dtype, band_dtype, budgets)
    return (kind, tile) if kind is not None else ("resident", None)


def resident_fixed(n: int, ndiags: int, vec_dtype, band_dtype,
                   budgets: Budgets | None) -> bool:
    """Whether the resident kernel ``dia_spmv`` runs with the band count
    fixed at compile time and streaming band loads (``dia_spmv.cu``): for
    f32 vectors, a band count of ``FIXED_BANDS``, and a call whose bands,
    x and y exceed the L2.  There it measured ahead of the generic kernel
    on an H100 (256^3 and 464^3); inside the L2 the generic kernel was
    faster (128^3 bf16/f32), and at f64 vectors too (PERF.md).  None
    budgets (the CPU): False."""
    if (budgets is None or vec_dtype != torch.float32
            or ndiags not in FIXED_BANDS):
        return False
    nbytes = (ndiags * n * _itemsize(band_dtype)
              + 2 * n * _itemsize(vec_dtype))
    return nbytes > budgets.l2_bytes


def pipe_bytes(n: int, ndiags: int, vec_dtype, band_dtype) -> int:
    """Bytes one pipelined iteration must move (``dia_pipe.cu``): the
    bands once at their storage width, six vectors read and six
    written."""
    return (ndiags * n * _itemsize(band_dtype)
            + 12 * n * _itemsize(vec_dtype))


# (band count, band type) at f32 vectors past the L2 where the pipelined
# iteration's fixed kernel measured no slower than the generic one
# (pipe_fixed's docstring)
PIPE_FIXED = frozenset({(3, torch.bfloat16), (3, torch.int8),
                        (3, torch.float32), (5, torch.bfloat16),
                        (5, torch.int8), (7, torch.bfloat16),
                        (7, torch.int8), (7, torch.float32),
                        (27, torch.int8)})


def pipe_fixed(n: int, ndiags: int, vec_dtype, band_dtype,
               budgets: Budgets | None) -> bool:
    """Whether the pipelined iteration ``cg_pipelined_iter`` runs the
    kernel with the band count fixed at compile time, streaming loads
    and stores and two rows a loop step (``dia_pipe.cu``): at f32
    vectors, for a band count and band type of ``PIPE_FIXED``, and a
    call whose bytes (:func:`pipe_bytes`) exceed the L2.  On an H100
    (80GB HBM3, 700 W; ms a call, 25 queued back to back, fixed against
    generic, ``scripts/torch_dia_ab.py``) it measured:

    - D = 7: 256^3 bf16 bands 0.422-0.429 against 0.492-0.501, int8
      0.388-0.393 against 0.557-0.560, f32 0.485 against 0.527; the
      256^3/4 shard's size, bf16, 0.114-0.116 against 0.129-0.130;
    - D = 3, a 10^7-row tridiagonal: bf16 0.208 against 0.250, int8
      0.198 against 0.238, f32 0.225 against 0.259;
    - D = 5, the 2-D 5-point operator on 2048^2: bf16 0.1057-0.1059
      against 0.1085-0.1087, int8 0.100 against 0.127; f32 bands
      0.1173-0.1180 against 0.1153-0.1165, so the generic kernel there;
    - D = 27, the 27-point operator on 128^3: int8 0.155 against 0.203;
      bf16 0.152 against 0.122 and f32 0.168 against 0.141 (224
      registers, one block an SM), so the generic kernel there.

    At f64 vectors the generic kernel was faster (256^3 f64/f64
    0.904-0.926 against 0.965-0.993, the varcoef 128^3 operator 0.120-
    0.122 against 0.139-0.141); on rcm-dia-pipelined's 10^6-row
    tridiagonal (bf16/f64) the fixed kernel took 0.060-0.071 against
    0.065-0.077, both the host's time a call, so the f64 rule keeps the
    generic kernel there too.  Inside the L2 (64^3, a 10^5-row
    tridiagonal, 256^2, 32^3 at 27 bands) both took the host's time,
    0.04-0.09 ms, with neither ahead in every turn, so the generic
    kernel stays (PERF.md).  None budgets (the CPU): False."""
    if (budgets is None or vec_dtype != torch.float32
            or (ndiags, band_dtype) not in PIPE_FIXED):
        return False
    return pipe_bytes(n, ndiags, vec_dtype, band_dtype) > budgets.l2_bytes


def run_bounds(b: int, nblocks: int, ntiles: int) -> tuple[int, int]:
    """The contiguous run of tiles [t0, t1) that block ``b`` of a
    persistent grid of ``nblocks`` walks, in order (the ring kernel: its
    ring slides along one run)."""
    return b * ntiles // nblocks, (b + 1) * ntiles // nblocks


def wave_tiles(b: int, nblocks: int, ntiles: int) -> range:
    """The tiles that block ``b`` of a persistent grid of ``nblocks``
    walks in the wave order of the windows kernel (``acg::wave_tiles``):
    b, b + nblocks, b + 2 nblocks, ...  All blocks move through the
    vector together, so a tile's far windows were streamed by other
    blocks within about one wave."""
    return range(b, ntiles, nblocks)


@dataclasses.dataclass(frozen=True)
class HbmPlan:
    """Launch geometry of an HBM kernel for one operator on one device.

    ``kind`` "hbm-ring" or "hbm"; ``tile`` x tile in elements; ``ntiles``
    row tiles; ``nblocks`` the persistent grid; ``smem`` its dynamic
    shared memory in bytes; ``stages`` the row tiles in flight (the
    buffers of band tiles, and of windows).  Ring: ``lo`` and ``hi`` the
    span in tiles (``hi - lo + stages`` slots of x).  Windows: ``table``
    an int64 tensor on the device, per cluster (lo, length, base) then
    per band its cluster (-1 for a band wholly outside), ``nclusters``
    and ``buflen`` (the elements of one stage's windows)."""

    kind: str
    tile: int
    ntiles: int
    nblocks: int
    smem: int
    lo: int = 0
    hi: int = 0
    table: torch.Tensor | None = None
    nclusters: int = 0
    buflen: int = 0
    stages: int = 0


def make_plan(kind: str, tile: int, n: int, offsets, vec_dtype, band_dtype,
              budgets: Budgets, device=None) -> HbmPlan:
    """The :class:`HbmPlan` of ``kind`` at ``tile`` for ``n`` rows.  The
    grid is as many blocks as fit the card (``budgets``) at once, at most
    one a tile.  The ring depth is :func:`ring_stages`' or
    :func:`windows_stages`' (the shallowest of ``RING_STAGES`` or
    ``STAGES`` when none fits, which the card then refuses)."""
    vb, mb = _itemsize(vec_dtype), _itemsize(band_dtype)
    live = _live(offsets, n)
    ntiles = -(-n // tile)
    if kind == "hbm-ring":
        lo, hi = ring_span(live, tile)
        stages = (ring_stages(n, offsets, vec_dtype, band_dtype, tile,
                              budgets) or RING_STAGES[-1])
        smem = ring_bytes(live, tile, vb, mb, len(offsets), stages)
    elif kind == "hbm":
        lo = hi = 0
        stages = (windows_stages(n, offsets, vec_dtype, band_dtype, tile,
                                 budgets) or STAGES[-1])
        smem = windows_bytes(live, tile, vb, mb, len(offsets), stages)
    else:
        raise ValueError(f"no HBM kernel of kind {kind!r}")
    nblocks = min(budgets.sms * max(1, blocks_per_sm(smem, budgets,
                                                     WINDOWS_THREADS)),
                  ntiles)
    # dynamic shared memory only: the dot's tree is static
    dyn = smem - _static_bytes(vb)
    if kind == "hbm-ring":
        return HbmPlan(kind, tile, ntiles, nblocks, dyn, lo=lo, hi=hi,
                       stages=stages)
    layout = window_layout(live, tile, vb)
    member = {}
    for c, (_, _, bands) in enumerate(cluster_windows(live)):
        for off in (o for _, o in bands):
            member[off] = c
    rows = [v for entry in layout for v in entry]
    rows += [member.get(int(o), -1) if abs(int(o)) < n else -1
             for o in offsets]
    table = torch.tensor(rows, dtype=torch.int64, device=device)
    return HbmPlan(kind, tile, ntiles, nblocks, dyn, table=table,
                   nclusters=len(layout),
                   buflen=sum(length for _, length, _ in layout),
                   stages=stages)
