"""Host-side sparse matrices in CSR form.

The reference stores the packed upper triangle of a symmetric matrix and
derives a *full* CSR (both triangles) for SpMV at solver init
(reference acg/symcsrmatrix.h:249-292, acg/symcsrmatrix.c:760-845
``_dsymv_init``).  We keep the same model: symmetric inputs (Matrix Market
``symmetric`` files store one triangle) are mirrored into a full CSR once on
the host, because the device SpMV wants a plain row-major operator.  All
construction is vectorized NumPy (the reference's radix sorts,
acg/sort.c, become ``np.lexsort``; its OpenMP prefix sums, acg/prefixsum.c,
become ``np.cumsum``).  The port's own copy of ``acg_tpu.sparse.csr``,
without the native-library fast path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from acg_torch.errors import AcgError, Status


@dataclasses.dataclass
class CsrMatrix:
    """Compressed sparse row matrix.

    ``rowptr`` has length nrows+1; ``colidx``/``vals`` have length nnz.
    Rows are sorted by column.  Analog of the derived full CSR
    (``frowptr/fcolidx/fa``) in reference acg/symcsrmatrix.h:249-264.
    """

    nrows: int
    ncols: int
    rowptr: np.ndarray
    colidx: np.ndarray
    vals: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.rowptr[-1])

    @property
    def rowlens(self) -> np.ndarray:
        return np.diff(self.rowptr)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A x, host reference SpMV (ref acg/symcsrmatrix.c:863-1003
        ``acgsymcsrmatrix_dsymv``; the 4x-unrolled row loop becomes a
        vectorized weighted bincount over cached row ids)."""
        x = np.asarray(x)
        prod = self.vals * x[self.colidx]
        return np.bincount(self._rowids(), weights=prod,
                           minlength=self.nrows).astype(prod.dtype)

    def _rowids(self) -> np.ndarray:
        ids = getattr(self, "_rowids_cache", None)
        if ids is None or ids.shape[0] != self.nnz:
            ids = np.repeat(np.arange(self.nrows), self.rowlens)
            object.__setattr__(self, "_rowids_cache", ids)
        return ids

    def to_coo(self):
        return self._rowids(), self.colidx.copy(), self.vals.copy()


def coo_to_csr(rowidx, colidx, vals, nrows: int, ncols: int,
               symmetrize: bool = False, sum_duplicates: bool = True,
               idx_dtype=np.int32) -> CsrMatrix:
    """Build a CSR matrix from COO triplets.

    ``symmetrize=True`` mirrors off-diagonal entries (i,j)->(j,i), turning a
    one-triangle symmetric Matrix Market file into a full operator
    (ref acg/symcsrmatrix.c:66-200 init-from-COO + :760-845 full-CSR build).
    """
    rowidx = np.asarray(rowidx, dtype=np.int64)
    colidx = np.asarray(colidx, dtype=np.int64)
    vals = np.asarray(vals)
    if rowidx.size and (rowidx.min() < 0 or rowidx.max() >= nrows
                        or colidx.min() < 0 or colidx.max() >= ncols):
        raise AcgError(Status.ERR_INDEX_OUT_OF_BOUNDS, "COO index out of bounds")
    if symmetrize:
        off = rowidx != colidx
        orig_rows, orig_cols, orig_vals = rowidx, colidx, vals
        rowidx = np.concatenate([orig_rows, orig_cols[off]])
        colidx = np.concatenate([orig_cols, orig_rows[off]])
        vals = np.concatenate([orig_vals, orig_vals[off]])
    order = np.lexsort((colidx, rowidx))
    rowidx, colidx, vals = rowidx[order], colidx[order], vals[order]
    if sum_duplicates and rowidx.size:
        keep = np.ones(rowidx.size, dtype=bool)
        keep[1:] = (rowidx[1:] != rowidx[:-1]) | (colidx[1:] != colidx[:-1])
        if not keep.all():
            seg = np.cumsum(keep) - 1
            out_vals = np.zeros(int(seg[-1]) + 1, dtype=vals.dtype)
            np.add.at(out_vals, seg, vals)
            rowidx, colidx, vals = rowidx[keep], colidx[keep], out_vals
    counts = np.bincount(rowidx, minlength=nrows)
    rowptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(counts, out=rowptr[1:])
    return CsrMatrix(nrows, ncols, rowptr,
                     colidx.astype(idx_dtype), vals)


def csr_from_mtx(m, symmetrize: bool = True, val_dtype=None,
                 idx_dtype=np.int32) -> CsrMatrix:
    """Build a full CSR operator from an MtxFile (ref cuda/acg-cuda.c:1448
    ``acgsymcsrmatrix_init_real_double`` from mtxfile).  ``idx_dtype``
    is the acgidx_t analog (ref acg/config.h:59-94): int64 for >2B-nnz
    operators (rowptr is always int64)."""
    vals = m.vals if val_dtype is None else m.vals.astype(val_dtype)
    return coo_to_csr(m.rowidx, m.colidx, vals, m.nrows, m.ncols,
                      symmetrize=symmetrize and m.is_symmetric,
                      idx_dtype=idx_dtype)


def manufactured_rhs(A, seed: int = 0):
    """Random normalized x*, b = A x* (ref --manufactured-solution,
    cuda/acg-cuda.c:1969-1980).  Returns (xstar, b).  ``A`` is a
    CsrMatrix or a host DiaMatrix (its ``matvec`` is the host oracle), so
    a grid too large for CSR assembly still gets a manufactured system."""
    rng = np.random.default_rng(seed)
    dtype = A.vals.dtype if hasattr(A, "vals") else A.bands.dtype
    xstar = rng.standard_normal(A.ncols).astype(dtype)
    xstar /= np.linalg.norm(xstar)
    return xstar, A.matvec(xstar)
