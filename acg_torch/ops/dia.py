"""DIA (diagonal) sparse format on the device.

A matrix with D distinct nonzero diagonals multiplies as
``y = sum_d band_d * shift(x, offset_d)``.  Storage: ``bands[D, n]``
aligned so ``bands[d, i] = A[i, i + offset[d]]``; entries whose column
falls outside [0, n) are 0.  The port of ``acg_tpu/ops/dia.py``: the
same host matrix, the same storage tiers chosen in the same order, and
an operator whose ``matvec`` runs a hand-written kernel on the card:
:func:`acg_torch.ops.dia_kernels.dia_spmv` while x fits the card's L2
(and for full-width f64 bands), past it the clustered-window or
shared-memory ring kernel (``dia_spmv_windows``, ``dia_spmv_ring``) by
the plan of :mod:`acg_torch.ops.dia_plan`, made once per operator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_torch.errors import AcgError, Status
from acg_torch.ops.dia_kernels import (cg_pipelined_iter, dia_matvec,
                                       dia_spmv, dia_spmv_batched,
                                       dia_spmv_ring, dia_spmv_windows)
from acg_torch.ops.dia_plan import (Budgets, HbmPlan, device_budgets,
                                    fused_plan_for, make_plan, pipe_fixed,
                                    resident_fixed)
from acg_torch.sparse.csr import CsrMatrix

__all__ = ["DiaMatrix", "DeviceDia", "dia_efficiency", "dia_matvec",
           "lossless_cast", "resolve_mat_dtype", "torch_dtype",
           "two_value_scales"]


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Host-side DIA matrix; see module docstring for layout."""

    nrows: int
    ncols: int
    offsets: tuple          # python ints, sorted
    bands: np.ndarray       # (D, nrows_padded)
    nnz: int

    @property
    def nrows_padded(self) -> int:
        return self.bands.shape[1]

    @classmethod
    def from_csr(cls, A: CsrMatrix, row_align: int = 8) -> "DiaMatrix":
        r, c, v = A.to_coo()
        offs = np.unique(c - r)
        nrp = -(-max(A.nrows, 1) // row_align) * row_align
        bands = np.zeros((len(offs), nrp), dtype=A.vals.dtype)
        d = np.searchsorted(offs, c - r)
        bands[d, r] = v
        return cls(A.nrows, A.ncols, tuple(int(o) for o in offs), bands,
                   A.nnz)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host oracle."""
        n = self.nrows_padded
        xp = np.zeros(n, dtype=x.dtype)
        xp[: len(x)] = x
        y = np.zeros(n, dtype=np.result_type(self.bands, x))
        for d, off in enumerate(self.offsets):
            if abs(off) >= n:
                continue            # the band lies wholly outside
            if off >= 0:
                y[: n - off] += self.bands[d, : n - off] * xp[off:]
            else:
                y[-off:] += self.bands[d, -off:] * xp[: n + off]
        return y[: self.nrows]


def torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or name."""
    if isinstance(dt, torch.dtype):
        return dt
    name = str(dt) if not isinstance(dt, str) else dt
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    return {"float16": torch.float16, "float32": torch.float32,
            "float64": torch.float64, "int8": torch.int8
            }[np.dtype(dt).name]


def lossless_cast(a: np.ndarray, dtype, chunk: int = 1 << 22) -> bool:
    """True iff every value of ``a`` round-trips exactly through
    ``dtype`` (a torch dtype or name), checked with a torch round trip in
    bounded chunks with early exit.  The ``mat_dtype="auto"`` policy:
    integer or dyadic stencil coefficients (the 7-pt Poisson bands, -1
    and 6) are exact in bfloat16, so half-width storage changes the
    memory traffic and not one bit of the arithmetic."""
    tdt = torch_dtype(dtype)
    flat = torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    for s in range(0, flat.numel(), chunk):
        piece = flat[s: s + chunk]
        if not torch.equal(piece.to(tdt).to(piece.dtype), piece):
            return False
    return True


def resolve_mat_dtype(vals: np.ndarray, mat_dtype, vec_dtype) -> torch.dtype:
    """Operator-storage dtype: None → the vector dtype; "auto" → bfloat16
    when the cast is exact, else the vector dtype; "int8" → rejected here
    (the two-value mask tier exists only for DIA bands, in
    :meth:`DeviceDia.from_dia`); any other dtype is taken literally (a
    lossy narrowing the caller opted into)."""
    vdt = torch_dtype(vec_dtype)
    if mat_dtype is None:
        return vdt
    if mat_dtype == "auto":
        if vdt.itemsize > 2 and lossless_cast(vals, torch.bfloat16):
            return torch.bfloat16
        return vdt
    if mat_dtype == "int8":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "mat_dtype='int8' (the exact two-value mask tier) "
                       "exists only for DIA band storage; use "
                       "mat_dtype='auto' to get it where applicable")
    return torch_dtype(mat_dtype)


def two_value_scales(bands: np.ndarray):
    """Per-band scale vector when every band is {0, c_d}-valued, else
    None: such bands compress exactly to an int8 0/1 mask times a scalar."""
    scales = np.zeros(bands.shape[0], dtype=bands.dtype)
    for d in range(bands.shape[0]):
        nz = bands[d][bands[d] != 0]
        if nz.size == 0:
            continue
        c = nz[0]
        if not np.all(nz == c):
            return None
        scales[d] = c
    return scales


@dataclasses.dataclass(frozen=True)
class DeviceDia:
    """Device-resident DIA operator.

    ``bands`` may be stored narrower than ``vec_dtype`` (bf16, or an int8
    0/1 mask with ``scales``); all arithmetic runs at ``vec_dtype``.
    ``offsets`` is the python tuple, ``offsets_t`` the same values as an
    int64 tensor beside the bands (the kernel reads them on the card).
    ``plan`` is the HBM-tier launch geometry of a one-vector SpMV, or
    None for the resident kernel (:func:`acg_torch.ops.dia_plan.
    fused_plan_for` on the device's budgets, made once here); ``fixed``
    whether the resident kernel runs with its band count fixed
    (:func:`acg_torch.ops.dia_plan.resident_fixed`, on the same
    budgets); ``pipe_fixed`` whether the pipelined iteration does
    (:func:`acg_torch.ops.dia_plan.pipe_fixed`)."""

    bands: torch.Tensor
    scales: torch.Tensor | None
    offsets: tuple
    offsets_t: torch.Tensor
    nrows: int
    ncols: int
    nnz: int
    vec_dtype: str
    plan: HbmPlan | None = None
    fixed: bool = False
    pipe_fixed: bool = False

    @classmethod
    def from_bands(cls, bands: torch.Tensor, scales, offsets, nrows: int,
                   ncols: int, nnz: int, vec_dtype,
                   budgets: Budgets | None = None) -> "DeviceDia":
        """``budgets`` None plans by the bands' device
        (:func:`~acg_torch.ops.dia_plan.device_budgets`: resident on the
        CPU); given budgets plan as on a card with those budgets (the
        CPU then runs the planned kernel's plain version)."""
        offsets = tuple(int(o) for o in offsets)
        vdt = torch_dtype(vec_dtype)
        dev = bands.device
        if budgets is None:
            budgets = device_budgets(dev)
        n = bands.shape[1]
        kind, tile = fused_plan_for(n, offsets, vdt, bands.dtype, budgets)
        plan = (None if kind == "resident" else
                make_plan(kind, tile, n, offsets, vdt, bands.dtype, budgets,
                          device=dev))
        return cls(bands=bands.contiguous(),
                   scales=(None if scales is None
                           else scales.to(device=dev, dtype=vdt)),
                   offsets=offsets,
                   offsets_t=torch.tensor(offsets, dtype=torch.int64,
                                          device=dev),
                   nrows=int(nrows), ncols=int(ncols), nnz=int(nnz),
                   vec_dtype=str(vdt).removeprefix("torch."), plan=plan,
                   fixed=resident_fixed(n, len(offsets), vdt, bands.dtype,
                                        budgets),
                   pipe_fixed=pipe_fixed(n, len(offsets), vdt, bands.dtype,
                                         budgets))

    @classmethod
    def from_dia(cls, D: DiaMatrix, dtype=None, mat_dtype="auto",
                 device=None, budgets: Budgets | None = None) -> "DeviceDia":
        """Tier order under ``mat_dtype="auto"`` (``acg_tpu/ops/dia.py``
        ``DeviceDia.from_dia``): lossless bf16 first, then the exact
        two-value int8 mask with per-band scales, then full width.
        ``mat_dtype="int8"`` forces the mask tier (an error when the bands
        are not two-valued, never a lossy truncation); any other concrete
        dtype is a narrowing the caller opted into.  ``budgets`` as in
        :meth:`from_bands`."""
        from acg_torch.utils.backend import resolve_device

        dev = resolve_device(device)
        vdt = np.dtype(dtype if dtype is not None else D.bands.dtype)
        # every tier decision looks at the vdt-cast bands, so a value that
        # underflows in the cast becomes a mask zero / a bf16 zero
        cast = np.ascontiguousarray(D.bands, dtype=vdt)

        def make(bands_host: torch.Tensor, scales=None):
            return cls.from_bands(bands_host.to(dev), scales, D.offsets,
                                  D.nrows, D.ncols, D.nnz, vdt.name,
                                  budgets=budgets)

        def int8_tier():
            sc = two_value_scales(cast)
            if sc is None:
                return None
            return make(torch.from_numpy((cast != 0).astype(np.int8)),
                        torch.from_numpy(sc))

        if mat_dtype == "int8":
            out = int8_tier()
            if out is None:
                raise AcgError(Status.ERR_INVALID_VALUE,
                               "mat_dtype='int8' requires two-valued "
                               "bands (the exact mask tier)")
            return out
        if mat_dtype == "auto":
            if vdt.itemsize > 2 and lossless_cast(cast, torch.bfloat16):
                mdt = torch.bfloat16
            else:
                out = int8_tier()
                if out is not None:
                    return out
                mdt = torch_dtype(vdt)
        else:
            mdt = resolve_mat_dtype(cast, mat_dtype, vdt)
        # narrow on the host before upload: half the transfer, and no
        # transient full-width device copy
        return make(torch.from_numpy(cast).to(mdt))

    @property
    def device(self) -> torch.device:
        return self.bands.device

    @property
    def nrows_padded(self) -> int:
        return self.bands.shape[1]

    @property
    def mat_itemsize(self) -> int:
        return self.bands.element_size()

    def operator_stream_bytes(self) -> int:
        """Bytes of the operator stream per SpMV at its storage width."""
        nbytes = self.bands.numel() * self.mat_itemsize
        if self.scales is not None:
            nbytes += self.scales.numel() * self.scales.element_size()
        return nbytes

    @property
    def kind(self) -> str:
        """The one-vector SpMV kernel's plan: "resident", "hbm-ring" or
        "hbm" (``acg_tpu``'s fused-plan kinds)."""
        return "resident" if self.plan is None else self.plan.kind

    def _spmv(self, x: torch.Tensor, with_dot: bool):
        """A (B, n) batch of systems takes the multi-RHS kernel, a 1-D
        vector the kernel of the operator's plan (``acg_tpu``'s
        dia_matvec_best and fused plan)."""
        if x.dim() == 2:
            return dia_spmv_batched(self.bands, self.scales, self.offsets_t,
                                    x, with_dot=with_dot)
        if self.plan is None:
            return dia_spmv(self.bands, self.scales, self.offsets_t, x,
                            with_dot=with_dot, fixed=self.fixed)
        spmv = dia_spmv_ring if self.plan.kind == "hbm-ring" else \
            dia_spmv_windows
        return spmv(self.bands, self.scales, self.offsets_t, x, self.plan,
                    with_dot=with_dot)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._spmv(x, False)

    def matvec_dot(self, x: torch.Tensor):
        """(A x, <x, A x>) in one pass; per system for a (B, n) batch."""
        return self._spmv(x, True)

    def pipelined_iter(self, w, z, r, p, s, x, alpha, beta, w_out=None):
        """One pipelined-CG iteration (:func:`cg_pipelined_iter`), on the
        kernel the plan chose (``pipe_fixed``)."""
        return cg_pipelined_iter(self.bands, self.scales, self.offsets_t, w,
                                 z, r, p, s, x, alpha, beta, w_out=w_out,
                                 fixed=self.pipe_fixed)


def dia_efficiency(A: CsrMatrix, offsets=None) -> float:
    """nnz / (ndiags * n): fraction of DIA storage that is real nonzeros
    (DIA pays off above ~0.25)."""
    if offsets is None:
        r, c, _ = A.to_coo()
        offsets = np.unique(c - r)
    ndiags = len(offsets)
    if not A.nrows or not ndiags:
        return 0.0
    return A.nnz / (ndiags * A.nrows)
