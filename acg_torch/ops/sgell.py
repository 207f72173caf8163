"""Segmented-gather ELL (sgell): the fast tier for unstructured SpMV.

The port of ``acg_tpu/ops/sgell.py``: the host pack (:func:`pack_sgell`,
:func:`pack_csr`), array for array; the device operator
(:class:`DeviceSgell`); the tier gates; and the TPU kernel
``sgell_matvec_pallas``, whose counterpart here is :func:`sgell_spmv`
(``acg_torch/csrc/sgell_spmv.cu`` on a CUDA tensor, the plain PyTorch
``sliced_matvec`` on a CPU tensor; a CUDA call that cannot launch
raises).

The layout, as the JAX package packs it:

- Output rows are tiled 1024 at a time, viewed as an (8, 128) block: row
  i sits at sublane ``(i // 128) % 8``, lane ``i % 128``.
- x is viewed as 128-element SEGMENTS (``x[128q : 128q + 128]``).
- A **slot** is one (8, 128) pair of value/index blocks for a tile, where
  all entries of sublane ``s`` read from ONE segment ``seg[slot, s]``, at
  lane ``idx``.
- The pack buckets each row's entries by (segment, rank within the row)
  and numbers the distinct buckets per (tile, sublane); a tile's slot
  count is the largest over its sublanes, at least 1.

Efficiency is ``nnz / (S * 1024)``, the **fill**: high for a matrix whose
128-row windows touch few x segments (FEM meshes after RCM), low for
uniformly random sparsity, where ``build_device_sgell`` declines the tier
below :data:`MIN_FILL`.

The pack is the TPU's layout, and the fill is what the TPU kernel
streams.  The card's kernel streams only the stored entries:
:func:`slice_pack` cuts the pack once, at upload, into the sliced layout
of ``ops/sliced.py``, whose rows keep their slot order, and only that
layout stays on the device.  The operator keeps the pack on the host
(lane indices as int8, a quarter of the int32 stream), where the plain
:func:`sgell_matvec` anchors parity with the JAX package.
The kernel sums each row over it in that order, a product then a sum,
so its y has the bits of :func:`sgell_matvec` on the pack.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_torch.errors import AcgError, Status
from acg_torch.ops.blas1 import batched_dot
from acg_torch.ops import sliced
from acg_torch.ops.dia import resolve_mat_dtype, torch_dtype
from acg_torch.utils.timing import host_step

LANES = 128
SUBL = 8
TILE = SUBL * LANES          # 1024 output rows per tile

# the JAX package's fill gate below which fmt="auto" declines the tier
MIN_FILL = 0.02

# kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0

_VAL_DTYPES = (torch.bfloat16, torch.float32)

_lib = None


def pack_sgell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               nrows: int, min_fill: float = 0.0) -> dict:
    """Pack COO entries (unique (row, col) pairs, any order) into the
    slot layout.  Returns a dict of numpy arrays:

    - ``vals``  (S*8, 128): entry values (slot-major)
    - ``idx``   (S*8, 128) int32: lane index of each entry within its
      sublane's segment
    - ``seg``   (S, 8) int32: x-segment id per (slot, sublane)
    - ``tile``  (S,) int32: output tile of each slot (non-decreasing)
    - ``first`` (S,) int32: 1 on the first slot of each tile
    - ``S``, ``ntiles``, ``n_pad``, ``fill``

    Every tile owns >= 1 slot even when empty, so every output block is
    visited and zeroed.  When the fill lands below ``min_fill`` the slot
    arrays are not materialized (``vals=None`` and the metadata)."""
    nnz = len(vals)
    n_pad = -(-max(nrows, 1) // TILE) * TILE
    ntiles = n_pad // TILE
    t = rows // TILE
    s = (rows // LANES) % SUBL
    lane = rows % LANES
    q = cols // LANES
    r = cols % LANES
    # rank of each entry within its (row, segment) group: same-row entries
    # hitting the same segment must land in different slots
    order = np.lexsort((r, q, rows))
    rows_o = rows[order]
    q_o = q[order]
    new_grp = np.r_[True, (rows_o[1:] != rows_o[:-1]) | (q_o[1:] != q_o[:-1])]
    grp_start_of = np.flatnonzero(new_grp)[np.cumsum(new_grp) - 1]
    rank_o = np.arange(nnz) - grp_start_of
    rank = np.empty(nnz, dtype=np.int64)
    rank[order] = rank_o
    # slot numbering per (tile, sublane): the distinct (segment, rank)
    # pairs in sorted order ARE the slots of that sublane
    key = np.lexsort((lane, rank, q, s, t))
    t_k, s_k, l_k, q_k, r_k, v_k, rank_k = (
        a[key] for a in (t, s, lane, q, r, vals, rank))
    new_slot = np.r_[True, (t_k[1:] != t_k[:-1]) | (s_k[1:] != s_k[:-1])
                     | (q_k[1:] != q_k[:-1]) | (rank_k[1:] != rank_k[:-1])]
    new_ts = np.r_[True, (t_k[1:] != t_k[:-1]) | (s_k[1:] != s_k[:-1])]
    slot_counter = np.cumsum(new_slot) - 1
    ts_first_slot = slot_counter[np.flatnonzero(new_ts)]
    ts_id = np.cumsum(new_ts) - 1
    slot_in_ts = slot_counter - ts_first_slot[ts_id]
    # per-tile slot count = max over its sublanes, min 1 (an empty tile
    # still needs its output block zeroed)
    nslots_ts = np.zeros((ntiles, SUBL), dtype=np.int64)
    if nnz:
        np.maximum.at(nslots_ts, (t_k, s_k), slot_in_ts + 1)
    nslots_t = np.maximum(nslots_ts.max(axis=1), 1)
    tile_slot0 = np.concatenate(([0], np.cumsum(nslots_t)))
    S = int(tile_slot0[-1])
    fill = nnz / (S * TILE)
    if fill < min_fill:
        return dict(vals=None, idx=None, seg=None, tile=None, first=None,
                    S=S, ntiles=ntiles, n_pad=n_pad, fill=fill)
    pv = np.zeros((S, SUBL, LANES), dtype=vals.dtype)
    pidx = np.zeros((S, SUBL, LANES), dtype=np.int32)
    seg = np.zeros((S, SUBL), dtype=np.int32)
    if nnz:
        gslot = tile_slot0[t_k] + slot_in_ts
        pv[gslot, s_k, l_k] = v_k
        pidx[gslot, s_k, l_k] = r_k
        seg[gslot, s_k] = q_k
    tile_of_slot = np.repeat(np.arange(ntiles, dtype=np.int32),
                             nslots_t).astype(np.int32)
    first = np.zeros(S, dtype=np.int32)
    first[tile_slot0[:-1]] = 1
    return dict(vals=pv.reshape(S * SUBL, LANES),
                idx=pidx.reshape(S * SUBL, LANES),
                seg=seg, tile=tile_of_slot, first=first,
                S=S, ntiles=ntiles, n_pad=n_pad, fill=fill)


def pack_csr(A, vec_dtype, nrows: int | None = None,
             min_fill: float = 0.0) -> dict:
    """Pack a CsrMatrix: the row-id expansion, the cast of the values to
    the vector dtype, and :func:`pack_sgell`.  ``nrows`` overrides the
    padded row count."""
    rowids = np.repeat(np.arange(A.nrows), A.rowlens)
    return pack_sgell(rowids, A.colidx.astype(np.int64),
                      A.vals.astype(np.dtype(vec_dtype)),
                      A.nrows if nrows is None else nrows,
                      min_fill=min_fill)


def tile_starts(first: np.ndarray) -> np.ndarray:
    """(ntiles + 1,) int32: tile t owns slots [start[t], start[t + 1]).
    Slots are tile-ordered and every tile has at least one, so the starts
    are exactly the slots flagged ``first``."""
    return np.append(np.flatnonzero(first), len(first)).astype(np.int32)


def sgell_matvec(vals: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor,
                 tile_start: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the sgell SpMV: every slot's entries
    gathered from x by (segment, lane), multiplied by their values, then
    added into each tile's 1024 rows one slot after another, in slot
    order, starting from zero (the TPU kernel's order and roundings: a
    product, then a sum).  ``x``: (ntiles * 1024,) f32, or (B, n) one
    system at a time.  Returns y of x's shape."""
    if x.dim() == 2:
        return torch.stack([sgell_matvec(vals, idx, seg, tile_start, xi)
                            for xi in x])
    S = seg.shape[0]
    cols = (seg.long() * LANES)[:, :, None] + idx.view(S, SUBL, LANES).long()
    contrib = vals.view(S, TILE).to(x.dtype) * x[cols.view(S, TILE)]
    start = tile_start.long()
    nslots = start[1:] - start[:-1]
    y = torch.zeros(len(nslots), TILE, dtype=x.dtype, device=x.device)
    for k in range(int(nslots.max()) if len(nslots) else 0):
        t = torch.nonzero(nslots > k).squeeze(1)
        y[t] = y[t] + contrib[start[t] + k]
    return y.view(-1)


def slice_pack(vals: torch.Tensor, idx: torch.Tensor, seg: torch.Tensor,
               tile_start: torch.Tensor,
               sigma: int = sliced.SIGMA) -> sliced.SlicedEll:
    """The sliced layout of a device pack (``vals`` (S*8, 128), ``idx``
    (S*8, 128), ``seg`` (S, 8), ``tile_start``): row ``t * 1024 + s * 128
    + l`` of slot k takes column ``seg[k, s] * 128 + idx[k, s, l]``, each
    row's entries in slot order.  Slot positions holding no entry (value
    0) are dropped: one added ±0 to a row sum that is never -0 (sums start
    at +0, and +0 + -0 is +0), so for finite x the product keeps every bit
    of :func:`sgell_matvec` on the pack."""
    dev = vals.device
    ntiles = tile_start.numel() - 1
    tile = torch.repeat_interleave(
        torch.arange(ntiles, device=dev),
        (tile_start[1:] - tile_start[:-1]).long())
    keep = torch.nonzero(vals.reshape(-1) != 0).squeeze(1)
    slot, e = keep // TILE, keep % TILE
    cols = (seg.reshape(-1)[slot * SUBL + e // LANES].long() * LANES
            + idx.reshape(-1)[keep].long())
    n = ntiles * TILE
    return sliced.slice_entries(tile[slot] * TILE + e, cols,
                                vals.reshape(-1)[keep], n, n, sigma)


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("sgell_spmv")
        lib.acg_sgell_spmv.restype, lib.acg_sgell_spmv.argtypes = (
            sliced.c_signature())
        _lib = lib
    return _lib


def sgell_spmv(op: sliced.SlicedEll, x: torch.Tensor) -> torch.Tensor:
    """y = A x for one system, ``op`` the sliced layout of an sgell pack
    (:func:`slice_pack`), ``x`` (ncols,) f32, values f32 or bf16.  CUDA
    tensors launch the kernel of ``csrc/sgell_spmv.cu`` (a warp a slice, a
    thread a row, each row a product then a sum per entry in slot order,
    no atomics: the bits of :func:`sgell_matvec` on the pack); CPU tensors
    take :func:`~acg_torch.ops.sliced.sliced_matvec`."""
    global launches
    if x.device.type == "cpu":
        return sliced.sliced_matvec(op, x)
    if x.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"sgell_spmv: no kernel for device {x.device}")
    sliced.check_operands("sgell_spmv", op, x, (torch.float32,),
                          _VAL_DTYPES)
    y = sliced.launch("sgell_spmv", _load().acg_sgell_spmv, op, x)
    launches += 1
    return y


@dataclasses.dataclass(frozen=True)
class DeviceSgell:
    """Device-resident segmented-gather ELL operator
    (``acg_tpu.ops.sgell.DeviceSgell``): ``sliced``, the layout the
    kernel reads (:func:`slice_pack`), on the device; and on the host the
    pack it was cut from, the JAX package's values, lane indices (stored
    as int8) and segments, with ``tile_start``, the slot range of each
    tile, in place of its per-slot ``tile`` and ``first``.  Built by
    :func:`build_device_sgell`."""

    vals: torch.Tensor
    idx: torch.Tensor
    seg: torch.Tensor
    tile_start: torch.Tensor
    sliced: sliced.SlicedEll
    S: int
    ntiles: int
    nrows: int
    ncols: int
    nnz: int
    vec_dtype: str = "float32"

    @property
    def device(self) -> torch.device:
        return self.sliced.device

    @property
    def nrows_padded(self) -> int:
        return self.ntiles * TILE

    @property
    def mat_itemsize(self) -> int:
        return self.vals.element_size()

    @property
    def fill(self) -> float:
        return self.nnz / (self.S * TILE)

    def operator_stream_bytes(self) -> int:
        """Bytes of the operator stream per SpMV: the sliced layout's."""
        return self.sliced.stream_bytes()

    def padded_bytes(self) -> int:
        """Bytes of the pack as the TPU kernel streams it (the JAX
        package's ``operator_stream_bytes``, with int8 lane indices): the
        values and lane indices of every slot, the segment ids and the
        tile table."""
        return sum(a.numel() * a.element_size()
                   for a in (self.vals, self.idx, self.seg, self.tile_start))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x; a (B, n) batch runs the one-system kernel once per system,
        as the JAX package's ``vmap`` does."""
        if x.dim() == 2:
            return torch.stack([self.matvec(xi) for xi in x])
        return sgell_spmv(self.sliced, x)

    def matvec_dot(self, x: torch.Tensor):
        """(A x, <x, A x>), per system for a (B, n) batch: the SpMV, then
        the dot (the TPU kernel fuses none)."""
        y = self.matvec(x)
        return y, batched_dot(x, y)


def sgell_supported(vec_dtype) -> bool:
    """The tier runs at f32 vectors only, as in the JAX package (whose
    TPU lane gather takes f32 alone)."""
    return np.dtype(vec_dtype) == np.float32


def sgell_require_available(vec_dtype) -> None:
    """The forced-tier gate: ERR_NOT_SUPPORTED when the tier cannot run
    at ``vec_dtype``."""
    vdt = np.dtype(vec_dtype)
    if not sgell_supported(vdt):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"format 'sgell' does not support vector dtype "
                       f"{vdt.name}")


def build_device_sgell(A, dtype=None, mat_dtype="auto",
                       min_fill: float = MIN_FILL, device=None,
                       timings: dict | None = None) -> DeviceSgell | None:
    """Pack a CsrMatrix and upload the operator, or None when the tier
    does not apply (vector dtype unsupported, fill below ``min_fill``).
    ``timings`` gathers the host seconds of steps ``"pack"``,
    ``"upload"`` and ``"slice"``."""
    from acg_torch.utils.backend import resolve_device

    dev = resolve_device(device)
    vdt = np.dtype(dtype if dtype is not None else A.vals.dtype)
    if not sgell_supported(vdt):
        return None
    with host_step(timings, "pack"):
        packed = pack_csr(A, vdt, min_fill=min_fill)
    if packed["vals"] is None:
        return None
    mdt = resolve_mat_dtype(packed["vals"], mat_dtype, vdt)
    return device_sgell_from_pack(packed, A.nrows, A.ncols, A.nnz, vdt, mdt,
                                  dev, timings=timings)


def device_sgell_from_pack(packed: dict, nrows: int, ncols: int, nnz: int,
                           vec_dtype, mat_dtype: torch.dtype,
                           device: torch.device,
                           timings: dict | None = None) -> DeviceSgell:
    """Upload a :func:`pack_sgell` result, its values stored at
    ``mat_dtype``, and slice it on the device (:func:`slice_pack`); the
    pack itself stays on the host.  ``timings`` gathers the host seconds
    of steps ``"upload"`` and ``"slice"``."""
    vals = torch.from_numpy(np.ascontiguousarray(packed["vals"])).to(
        mat_dtype)
    idx = torch.from_numpy(packed["idx"].astype(np.int8))
    seg = torch.from_numpy(np.ascontiguousarray(packed["seg"]))
    tile_start = torch.from_numpy(tile_starts(packed["first"]))
    with host_step(timings, "upload"):
        on_dev = [a.to(device) for a in (vals, idx, seg, tile_start)]
    with host_step(timings, "slice"):
        op = slice_pack(*on_dev)
    del on_dev
    return DeviceSgell(
        vals=vals, idx=idx, seg=seg, tile_start=tile_start, sliced=op,
        S=packed["S"], ntiles=packed["ntiles"], nrows=int(nrows),
        ncols=int(ncols), nnz=int(nnz),
        vec_dtype=str(torch_dtype(vec_dtype)).removeprefix("torch."))
