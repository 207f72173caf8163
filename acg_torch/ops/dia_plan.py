"""Which DIA SpMV kernel a one-vector operator application takes.

The port of the planning half of ``acg_tpu/ops/pallas_kernels.py``
(``_cluster_windows``, ``_ring_span``, ``pallas_hbm2d_ring_plan``,
``pallas_hbm2d_plan``, ``hbm_kernel_plan``, ``fused_plan_for``), with
the card's own budgets in place of the TPU's VMEM budget:

- **resident** (``dia_spmv``): while the vector x fits the device's L2
  cache, the on-chip store that kernel leans on for x, as the TPU's
  resident kernel leans on VMEM;
- **hbm-ring** (``dia_spmv_ring``): past it, while one block's ring of
  consecutive x tiles spanning the whole offset reach (and the kernel's
  double-buffered band tiles) fits its opt-in shared memory; x then
  streams once;
- **hbm** (``dia_spmv_windows``): else while one double-buffered x
  window per offset cluster (and the band tiles) fits the same budget;
- **resident** again when neither fits, as the JAX package falls back
  to its non-HBM path.

The ring comes before the windows, as in ``hbm_kernel_plan``.  The port
has no (rows, 128) layout, so everything here is in elements: a tile is
``T`` elements and the cluster slack is 1024 elements (JAX's 8 rows of
128 lanes); for offsets that are multiples of 128 and ``T = rt * 128``
the spans and clusters equal the JAX package's.  Unlike the JAX plans,
f64 vectors and bands are admitted.  Bands whose offset reaches past
the whole vector (|offset| >= n) contribute nothing and are left out of
the geometry.  The plan functions take the budgets as arguments
(:class:`Budgets`); :func:`device_budgets` reads them from the card.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Budgets", "HbmPlan", "SLACK", "TILES", "THREADS",
           "blocks_per_sm", "cluster_windows", "device_budgets",
           "fused_plan_for", "hbm_kernel_plan", "make_plan", "ring_bytes",
           "ring_plan", "ring_span", "run_bounds", "window_layout",
           "windows_bytes", "windows_plan"]

SLACK = 1024                    # JAX's 8 rows x 128 lanes, in elements
TILES = (2048, 1024, 512, 256)  # x tiles (elements) the plans try, largest
#                                 first
THREADS = 256                   # threads per block (acg::kThreads)
MAX_BLOCKS_PER_SM = 8           # 2048 resident threads / THREADS
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


def _band_buffers(tile: int, band_itemsize: int, ndiags: int) -> int:
    """Both kernels stage every band's tile, double-buffered."""
    return 2 * ndiags * tile * band_itemsize


def ring_bytes(offsets, tile: int, itemsize: int, band_itemsize: int,
               ndiags: int | None = None) -> int:
    """Shared memory of the ring kernel: T_ring + 1 slots of ``tile``
    elements (one extra slot takes the next tile while this one
    computes), two buffers of the ``ndiags`` band tiles (by default one
    band per offset), each band's position in the ring (int32) and the
    dot's tree."""
    lo, hi = ring_span(offsets, tile)
    nd = len(offsets) if ndiags is None else ndiags
    return ((hi - lo + 2) * tile * itemsize
            + _band_buffers(tile, band_itemsize, nd) + 4 * nd
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


def windows_bytes(offsets, tile: int, itemsize: int, band_itemsize: int,
                  ndiags: int | None = None) -> int:
    """Shared memory of the windows kernel: two buffers of every
    cluster's window, two buffers of the ``ndiags`` band tiles (by
    default one band per offset), each band's window position (int32)
    and the dot's tree."""
    buf = sum(length for _, length, _ in window_layout(offsets, tile,
                                                       itemsize))
    nd = len(offsets) if ndiags is None else ndiags
    return (2 * buf * itemsize + _band_buffers(tile, band_itemsize, nd)
            + 4 * nd + _static_bytes(itemsize))


def blocks_per_sm(smem: int, budgets: Budgets) -> int:
    """Blocks of ``smem`` bytes of shared memory that fit one SM, at most
    the thread limit's; the SM reserves what its total exceeds one
    block's opt-in for every block."""
    reserve = budgets.smem_sm - budgets.smem_block
    return min(MAX_BLOCKS_PER_SM, budgets.smem_sm // (smem + reserve))


def _pick_tile(footprint, budgets: Budgets) -> int | None:
    """The largest tile at which two blocks fit an SM, else the largest
    at which one block fits, else None."""
    fits = [t for t in TILES if footprint(t) <= budgets.smem_block]
    two = [t for t in fits if blocks_per_sm(footprint(t), budgets) >= 2]
    return (two or fits or [None])[0]


def ring_plan(n: int, offsets, vec_dtype, band_dtype,
              budgets: Budgets) -> int | None:
    """Tile of the ring kernel, or None when no ring fits one block
    (``pallas_hbm2d_ring_plan``)."""
    live = _live(offsets, n)
    if not live:
        return None
    vb, mb = _itemsize(vec_dtype), _itemsize(band_dtype)
    return _pick_tile(lambda t: ring_bytes(live, t, vb, mb, len(offsets)),
                      budgets)


def windows_plan(n: int, offsets, vec_dtype, band_dtype,
                 budgets: Budgets) -> int | None:
    """Tile of the clustered-window kernel, or None when its windows do
    not fit one block (``pallas_hbm2d_plan``)."""
    live = _live(offsets, n)
    if not live:
        return None
    vb, mb = _itemsize(vec_dtype), _itemsize(band_dtype)
    return _pick_tile(
        lambda t: windows_bytes(live, t, vb, mb, len(offsets)), budgets)


def hbm_kernel_plan(n: int, offsets, vec_dtype, band_dtype,
                    budgets: Budgets):
    """``(kind, tile)`` for x past the L2, ring before windows (the one
    owner of that priority, as ``hbm_kernel_plan`` is in the JAX
    package), or ``(None, None)``."""
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
    tile (None).  ``budgets`` None (the CPU) is always resident."""
    if budgets is None:
        return "resident", None
    if n * _itemsize(vec_dtype) <= budgets.l2_bytes:
        return "resident", None
    kind, tile = hbm_kernel_plan(n, offsets, vec_dtype, band_dtype, budgets)
    return (kind, tile) if kind is not None else ("resident", None)


def run_bounds(b: int, nblocks: int, ntiles: int) -> tuple[int, int]:
    """The contiguous run of tiles [t0, t1) that block ``b`` of a
    persistent grid of ``nblocks`` walks, in order."""
    return b * ntiles // nblocks, (b + 1) * ntiles // nblocks


@dataclasses.dataclass(frozen=True)
class HbmPlan:
    """Launch geometry of an HBM kernel for one operator on one device.

    ``kind`` "hbm-ring" or "hbm"; ``tile`` x tile in elements; ``ntiles``
    row tiles; ``nblocks`` the persistent grid; ``smem`` its dynamic
    shared memory in bytes.  Ring: ``lo`` and ``hi`` the span in tiles.
    Windows: ``table`` an int64 tensor on the device, per cluster (lo,
    length, base) then per band its cluster (-1 for a band wholly
    outside), ``nclusters`` and ``buflen`` (the elements of one
    buffer)."""

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


def make_plan(kind: str, tile: int, n: int, offsets, vec_dtype, band_dtype,
              budgets: Budgets, device=None) -> HbmPlan:
    """The :class:`HbmPlan` of ``kind`` at ``tile`` for ``n`` rows.  The
    grid is as many blocks as fit the card (``budgets``) at once, at most
    one a tile."""
    vb, mb = _itemsize(vec_dtype), _itemsize(band_dtype)
    live = _live(offsets, n)
    ntiles = -(-n // tile)
    if kind == "hbm-ring":
        lo, hi = ring_span(live, tile)
        smem = ring_bytes(live, tile, vb, mb, len(offsets))
    elif kind == "hbm":
        lo = hi = 0
        smem = windows_bytes(live, tile, vb, mb, len(offsets))
    else:
        raise ValueError(f"no HBM kernel of kind {kind!r}")
    nblocks = min(budgets.sms * max(1, blocks_per_sm(smem, budgets)), ntiles)
    # dynamic shared memory only: the dot's tree is static
    dyn = smem - _static_bytes(vb)
    if kind == "hbm-ring":
        return HbmPlan(kind, tile, ntiles, nblocks, dyn, lo=lo, hi=hi)
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
                   buflen=sum(length for _, length, _ in layout))
