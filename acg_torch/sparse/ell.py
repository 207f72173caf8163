"""Padded ELL sparse format: the host layout of the gather tier.

The port's copy of ``acg_tpu/sparse/ell.py``.  The reference
load-balances irregular CSR rows inside its SpMV kernel (merge-path,
reference acg/cg-kernels-cuda.cu:312-441 ``csrgemv_merge``); here, as in
the JAX package, the balancing happens on the host: rows are padded to a
common width W, so the device SpMV is a rectangle of gathers, multiplies
and row sums (``acg_torch/ops/spmv.py``).

Padding entries point at column ``pad_col`` (default 0) with value 0,
which is exact for matvec.  The row count is padded to a multiple of
``row_align`` with all-zero rows.  ``rowlens`` records the true number of
stored entries per row so structural zeros survive a CSR round trip.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from acg_torch.sparse.csr import CsrMatrix


@dataclasses.dataclass
class EllMatrix:
    """ELL matrix: ``vals[nrows_padded, width]``, ``colidx`` same shape.

    ``nrows`` is the logical row count; rows >= nrows are zero padding.
    ``colidx`` entries of padding lanes are ``pad_col`` and vals are 0.
    """

    nrows: int
    ncols: int
    vals: np.ndarray
    colidx: np.ndarray
    nnz: int
    rowlens: np.ndarray | None = None  # true stored entries per logical row

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def nrows_padded(self) -> int:
        return self.vals.shape[0]

    @classmethod
    def from_csr(cls, A: CsrMatrix, row_align: int = 8, pad_col: int = 0,
                 idx_dtype=np.int32, min_width: int = 1) -> "EllMatrix":
        rowlens = A.rowlens
        width = max(int(rowlens.max()) if A.nrows else 0, min_width)
        nrp = -(-max(A.nrows, 1) // row_align) * row_align
        vals = np.zeros((nrp, width), dtype=A.vals.dtype)
        cols = np.full((nrp, width), pad_col, dtype=idx_dtype)
        # scatter: lane position of each nonzero within its row
        rowids = np.repeat(np.arange(A.nrows), rowlens)
        lane = np.arange(A.nnz) - np.repeat(A.rowptr[:-1], rowlens)
        vals[rowids, lane] = A.vals
        cols[rowids, lane] = A.colidx
        return cls(A.nrows, A.ncols, vals, cols, A.nnz,
                   rowlens=rowlens.astype(np.int64))

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host ELL SpMV (oracle for the device kernels)."""
        y = (self.vals * x[self.colidx]).sum(axis=1)
        return y[: self.nrows]

    def to_csr(self) -> CsrMatrix:
        if self.rowlens is not None:
            # exact structure: the first rowlens[i] lanes of row i are
            # stored entries (structural zeros included), the rest padding
            rmask = (np.arange(self.width)[None, :]
                     < self.rowlens[:, None])
            rowlens = self.rowlens
        else:
            rmask = (self.vals != 0)[: self.nrows]
            rowlens = rmask.sum(axis=1)
        rowptr = np.zeros(self.nrows + 1, dtype=np.int64)
        np.cumsum(rowlens, out=rowptr[1:])
        return CsrMatrix(self.nrows, self.ncols, rowptr,
                         self.colidx[: self.nrows][rmask],
                         self.vals[: self.nrows][rmask])
