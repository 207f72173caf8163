"""The sliced-ELL layout that both unstructured SpMV kernels read.

``sgell_spmv`` (``ops/sgell.py``) and ``ell_spmv`` (``ops/spmv.py``)
compute y = A x over a few stored entries a row.  Their host layouts are
the JAX package's: the sgell slot pack, built for the TPU's lane gather,
and the ELL rectangle, padded to the longest row.  Both stream padding:
on a 3-D FEM mesh after RCM the slot pack holds ~12 slot entries for
every stored one, the rectangle ~3.  On this card a gather from x in L2
costs the same inside a 128-entry segment as outside it, so the kernels
read neither.  Each operator is cut once, when it is uploaded, into
:class:`SlicedEll`:

- rows go in slices of ``WARP`` (32), one warp a slice and one thread a
  row; slice k is as wide as its longest row, ``w_k``;
- entry j of slice-row r is stored at ``ptr[k] + j * 32 + r``, so each
  step of a warp reads 32 consecutive values and 32 consecutive columns;
  lanes past a row's end hold value 0 and column 0;
- slice-row p is matrix row ``perm[p]``: inside windows of ``sigma`` rows
  the rows are sorted by length, longest first (``sigma = 1`` keeps the
  given order), so the rows sharing a slice have about the same length;
- a row's entries keep the order in which its source sums them (the
  sgell slots in slot order, the rectangle's lanes in lane order), and
  the kernel adds them in that order, each a product then a sum.

The layout is built with torch ops on the operator's device
(:func:`slice_entries`, fed by :func:`slice_ell` for a rectangle and
by ``ops/sgell.py``'s ``slice_pack`` for a slot pack);
:func:`sliced_matvec` is the plain PyTorch version of the product, the
CPU path of both operators and the version the card checks hold the
kernels to; :func:`launch` is the wrappers' shared ctypes call, and :func:`unroll`
reads a built kernel's unroll.
"""

from __future__ import annotations

import dataclasses

import torch

from acg_torch.errors import AcgError, Status
from acg_torch.utils.backend import kernel_device

WARP = 32                    # rows a slice: one warp, one thread a row
# rows sorted by length inside windows of SIGMA rows (1: no sort)
SIGMA = 1024

VAL_CODES = {torch.bfloat16: 0, torch.float32: 2, torch.float64: 3}
VEC_CODES = {torch.float32: 2, torch.float64: 3}


@dataclasses.dataclass(frozen=True)
class SlicedEll:
    """A sliced-ELL operator of ``nrows`` rows over ``ncols`` columns.

    ``vals`` (L,) at the storage dtype and ``cols`` (L,) int32, slice k
    in ``[ptr[k], ptr[k + 1])``; ``ptr`` (nslices + 1,) int64; ``perm``
    (nrows,) int32.  Every column lies in ``[0, ncols)`` (checked when
    built).  ``nnz`` counts the entries the layout stores."""

    vals: torch.Tensor
    cols: torch.Tensor
    ptr: torch.Tensor
    perm: torch.Tensor
    nrows: int
    ncols: int
    nnz: int
    sigma: int

    def __post_init__(self):
        """Refuse arrays the kernels cannot read as this layout
        (ERR_INVALID_VALUE): the dtypes and shapes above, all contiguous
        and on one device."""
        arrays = (self.vals, self.cols, self.ptr, self.perm)
        if (self.cols.dtype != torch.int32 or self.perm.dtype != torch.int32
                or self.ptr.dtype != torch.int64 or self.ncols < 1
                or self.cols.shape != self.vals.shape
                or self.vals.dim() != 1
                or self.perm.shape != (self.nrows,)
                or self.ptr.shape != (-(-self.nrows // WARP) + 1,)
                or any(a.device != self.vals.device or not a.is_contiguous()
                       for a in arrays)):
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"not a sliced layout of {self.nrows} x "
                           f"{self.ncols}: " + ", ".join(
                               f"{a.dtype} {tuple(a.shape)} on {a.device}"
                               for a in arrays))

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nslices(self) -> int:
        return self.ptr.numel() - 1

    @property
    def fill(self) -> float:
        """Stored entries over the slots the layout streams."""
        return self.nnz / max(self.vals.numel(), 1)

    def stream_bytes(self) -> int:
        """Bytes of the operator a kernel call reads: values at their
        storage width, int32 columns, the slice offsets and the row
        order, each once."""
        return sum(a.numel() * a.element_size()
                   for a in (self.vals, self.cols, self.ptr, self.perm))


def row_order(lens: torch.Tensor, sigma: int) -> torch.Tensor:
    """(n,) int64: the rows sorted by length, longest first, inside
    consecutive windows of ``sigma`` rows, ties in row order."""
    n = lens.numel()
    rows = torch.arange(n, device=lens.device)
    if sigma <= 1 or n == 0:
        return rows
    top = int(lens.max())
    key = (rows // sigma) * (top + 1) + (top - lens)
    return torch.sort(key, stable=True).indices


def slice_entries(rows: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor, nrows: int, ncols: int,
                  sigma: int = SIGMA) -> SlicedEll:
    """The sliced layout of the entries (rows[e], cols[e], vals[e]), each
    row's entries kept in the order given; all three on one device,
    ``vals`` at its storage dtype.  Raises ERR_INDEX_OUT_OF_BOUNDS for a
    column outside [0, ncols) or a row outside [0, nrows)."""
    dev = vals.device
    rows = rows.long()
    nnz = rows.numel()
    if nnz and (int(cols.min()) < 0 or int(cols.max()) >= ncols
                or int(rows.min()) < 0 or int(rows.max()) >= nrows):
        raise AcgError(Status.ERR_INDEX_OUT_OF_BOUNDS,
                       f"sliced operator: an entry outside the {nrows} x "
                       f"{ncols} matrix")
    lens = torch.bincount(rows, minlength=nrows)
    start = torch.cumsum(lens, 0) - lens
    # rank of each entry within its row: a stable sort by row keeps the
    # given order inside every row
    by_row = torch.sort(rows, stable=True).indices
    rank = torch.empty_like(rows)
    rank[by_row] = (torch.arange(nnz, device=dev)
                    - start[rows[by_row]])
    perm = row_order(lens, sigma)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(nrows, device=dev)
    nslices = -(-nrows // WARP)
    plen = torch.zeros(nslices * WARP, dtype=torch.long, device=dev)
    plen[:nrows] = lens[perm]
    width = plen.view(nslices, WARP).amax(1)
    ptr = torch.zeros(nslices + 1, dtype=torch.long, device=dev)
    torch.cumsum(width * WARP, 0, out=ptr[1:])
    p = pos[rows]
    dest = ptr[p // WARP] + rank * WARP + p % WARP
    size = int(ptr[-1])
    out_vals = torch.zeros(size, dtype=vals.dtype, device=dev)
    out_cols = torch.zeros(size, dtype=torch.int32, device=dev)
    out_vals[dest] = vals
    out_cols[dest] = cols.int()
    return SlicedEll(vals=out_vals, cols=out_cols, ptr=ptr,
                     perm=perm.int(), nrows=int(nrows), ncols=int(ncols),
                     nnz=nnz, sigma=int(sigma))


def slice_ell(vals: torch.Tensor, cols: torch.Tensor, ncols: int,
              sigma: int = SIGMA) -> SlicedEll:
    """The sliced layout of an (n, W) ELL rectangle over ``ncols``
    columns: each row's lanes in lane order, up to and including its last
    lane with a nonzero value (padding lanes hold 0)."""
    n, width = vals.shape
    lane = torch.arange(1, width + 1, device=vals.device)
    rowlen = ((vals != 0) * lane).amax(1)
    keep = torch.nonzero((lane <= rowlen[:, None]).reshape(-1)).squeeze(1)
    return slice_entries(keep // width, cols.reshape(-1)[keep],
                         vals.reshape(-1)[keep], n, ncols, sigma)


def sliced_matvec(op: SlicedEll, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the sliced product: every row summed
    from +0 over its stored entries in order, each a product (the value
    widened to x's dtype) and then a sum, rounded apart.  ``x``: (m,)
    with m >= ncols.  Returns y of ``nrows`` entries.

    Step j adds entry j of every slice at least j + 1 wide: the slices
    sorted by width, those still going are a prefix, so the memory stays
    that of one step's slices, whatever the longest row."""
    width = (op.ptr[1:] - op.ptr[:-1]) // WARP
    by_width = torch.sort(width, descending=True, stable=True)
    lane = torch.arange(WARP, device=x.device)
    acc = torch.zeros(op.nslices, WARP, dtype=x.dtype, device=x.device)
    steps = int(by_width.values[0]) if op.nslices else 0
    # going[j]: the slices at least j + 1 wide
    going = torch.searchsorted(-by_width.values,
                               -torch.arange(1, steps + 1, device=x.device),
                               right=True).tolist()
    for j, live in enumerate(going):
        k = by_width.indices[:live]
        at = (op.ptr[k] + j * WARP)[:, None] + lane
        acc[k] = acc[k] + (op.vals[at].to(x.dtype)
                           * x[op.cols[at].long()])
    y = torch.empty(op.nrows, dtype=x.dtype, device=x.device)
    y[op.perm.long()] = acc.view(-1)[: op.nrows]
    return y


def check_operands(name: str, op: SlicedEll, x: torch.Tensor,
                   vec_dtypes: tuple, val_dtypes: tuple) -> None:
    """Raise ERR_INVALID_VALUE for what the kernel ``name`` cannot take
    with this x: a vector dtype outside ``vec_dtypes``, values outside
    ``val_dtypes``, an empty operator, an x that is not one contiguous
    vector of at least ``ncols`` entries on the operator's device.  The
    layout's own arrays were checked when it was made."""
    def bad(msg):
        raise AcgError(Status.ERR_INVALID_VALUE, f"{name}: {msg}")

    def names(dts):
        return "|".join(str(d).removeprefix("torch.") for d in dts)

    if x.dtype not in vec_dtypes:
        bad(f"vector dtype {x.dtype} ({names(vec_dtypes)})")
    if op.vals.dtype not in val_dtypes:
        bad(f"value dtype {op.vals.dtype} ({names(val_dtypes)})")
    if x.dim() != 1 or x.shape[0] < op.ncols or op.nrows < 1:
        bad(f"operator {op.nrows} x {op.ncols} with x {tuple(x.shape)}: "
            "want rows, and a vector of at least ncols entries")
    if x.device != op.vals.device or not x.is_contiguous():
        bad("x must be contiguous and on the operator's device")


def launch(name: str, fn, op: SlicedEll, x: torch.Tensor) -> torch.Tensor:
    """Run the C entry point ``fn`` of a sliced kernel on ``op`` and x
    (checked by the caller): y of ``nrows`` entries, on x's stream.
    Raises ERR_NOT_SUPPORTED when the launch fails."""
    y = torch.empty(op.nrows, dtype=x.dtype, device=x.device)
    with kernel_device(x):
        rc = fn(op.vals.data_ptr(), VAL_CODES[op.vals.dtype],
                op.cols.data_ptr(), op.ptr.data_ptr(), op.perm.data_ptr(),
                x.data_ptr(), y.data_ptr(), VEC_CODES[x.dtype], op.nrows,
                op.nslices, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"{name}: kernel launch failed (CUDA error {rc})")
    return y


def unroll(name: str) -> int:
    """U of the kernel library ``name`` (``sgell_spmv`` or ``ell_spmv``)
    as it was built: the entries a thread loads ahead of their gathers
    (``ACG_SLICED_UNROLL`` in ``csrc/sliced_spmv.cuh``)."""
    from acg_torch import _build

    return int(_build.load(name).acg_sliced_unroll())


def c_signature():
    """ctypes (restype, argtypes) of both kernels' C entry points."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    return ctypes.c_int, [p, i, p, p, p, p, p, i, ctypes.c_int64,
                          ctypes.c_int64, p]
