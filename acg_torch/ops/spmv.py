"""Padded-ELL SpMV on the device: the gather tier for unstructured
operators.

The port of ``acg_tpu/ops/spmv.py`` (``DeviceEll``, the XLA gather
formulation ``ell_matvec``, ``pad_vector``) and of the TPU kernel
``acg_tpu/ops/pallas_spmv.py`` ``ell_matvec_pallas``.  The operator cuts
the JAX package's (n, W) rectangle once, at upload, into the sliced
layout of ``ops/sliced.py``, which streams the stored entries and not
the padding to the longest row; only that layout stays on the device,
and the rectangle, on which the plain :func:`ell_matvec` anchors parity,
stays on the host.  On a CUDA tensor :func:`ell_spmv`
launches the hand-written kernel of ``acg_torch/csrc/ell_spmv.cu`` on
that layout; on a CPU tensor it runs ``sliced_matvec``, its plain
PyTorch version.  There is no fallback between the two: a CUDA call that
cannot launch raises.  On the card the kernel serves every ELL matvec at
both vector precisions, where the JAX package used XLA's gather wherever
its TPU kernel could not run (f64, batched vectors, x outgrowing VMEM).

Neither the TPU kernel nor this one fuses a dot: ``matvec_dot`` is the
SpMV and then ``batched_dot``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_torch.errors import AcgError, Status
from acg_torch.ops import sliced
from acg_torch.ops.blas1 import batched_dot
from acg_torch.ops.dia import resolve_mat_dtype, torch_dtype
from acg_torch.utils.timing import host_step

# kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0

_VAL_DTYPES = (torch.bfloat16, torch.float32, torch.float64)
_VEC_DTYPES = (torch.float32, torch.float64)

_lib = None


def ell_matvec(vals: torch.Tensor, colidx: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_w vals[i, w] * x[colidx[i, w]], the plain PyTorch
    version (``acg_tpu.ops.spmv.ell_matvec``): values upcast to the
    vector dtype, a (rows, W) gather, a multiply and a row sum.  ``x`` is
    ``(n,)`` or ``(B, n)``; padding lanes (value 0, column 0) add 0."""
    return (vals.to(x.dtype) * x[..., colidx]).sum(-1)


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("ell_spmv")
        lib.acg_ell_spmv.restype, lib.acg_ell_spmv.argtypes = (
            sliced.c_signature())
        _lib = lib
    return _lib


def ell_spmv(op: sliced.SlicedEll, x: torch.Tensor) -> torch.Tensor:
    """y = A x for one system, ``op`` the sliced layout of an ELL
    rectangle (``sliced.slice_ell``): y has ``op.nrows`` entries.

    Values bf16, f32 or f64; ``x`` f32 or f64 with at least ``op.ncols``
    entries, so the operator may be rectangular (the distributed solver's
    interface operator, border rows × ghost slots); its columns were
    checked below ``ncols`` once, when it was sliced.  CUDA tensors
    launch the kernel (a warp a slice, a thread a row summed in lane
    order, so the bits are the same on every run and equal to
    ``sliced_matvec``'s); CPU tensors take ``sliced_matvec``."""
    global launches
    if x.device.type == "cpu":
        return sliced.sliced_matvec(op, x)
    if x.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"ell_spmv: no kernel for device {x.device}")
    sliced.check_operands("ell_spmv", op, x, _VEC_DTYPES, _VAL_DTYPES)
    y = sliced.launch("ell_spmv", _load().acg_ell_spmv, op, x)
    launches += 1
    return y


@dataclasses.dataclass(frozen=True)
class DeviceEll:
    """Device-resident ELL operator (``acg_tpu.ops.spmv.DeviceEll``).

    ``sliced`` is the layout the kernel reads, on the device.
    ``vals``/``colidx``, the rectangle it was cut from, stay on the host:
    shape (nrows_padded, width), padding lanes with value 0 and column 0,
    so :func:`ell_matvec` needs no masking.  ``vals`` may be stored
    narrower than ``vec_dtype`` (bf16 when exact); all arithmetic runs at
    ``vec_dtype``."""

    vals: torch.Tensor
    colidx: torch.Tensor
    sliced: sliced.SlicedEll
    nrows: int
    ncols: int
    nnz: int
    vec_dtype: str

    @classmethod
    def from_ell(cls, E, dtype=None, mat_dtype="auto", device=None,
                 timings: dict | None = None) -> "DeviceEll":
        """Upload a host :class:`~acg_torch.sparse.ell.EllMatrix`, values
        stored at ``resolve_mat_dtype`` (bf16 when the cast is exact under
        ``"auto"``), and slice it on the device (``sliced.slice_ell``,
        which raises ERR_INDEX_OUT_OF_BOUNDS for a column outside
        ``[0, ncols)``); the rectangle stays on the host.  ``timings``
        gathers the host seconds of steps ``"upload"`` and ``"slice"``."""
        from acg_torch.utils.backend import resolve_device

        dev = resolve_device(device)
        vdt = np.dtype(dtype if dtype is not None else E.vals.dtype)
        mdt = resolve_mat_dtype(E.vals, mat_dtype, vdt)
        host = E.vals if E.vals.dtype == vdt else E.vals.astype(vdt)
        vals = torch.from_numpy(np.ascontiguousarray(host)).to(mdt)
        cols = torch.from_numpy(np.ascontiguousarray(E.colidx,
                                                     dtype=np.int32))
        with host_step(timings, "upload"):
            dvals, dcols = vals.to(dev), cols.to(dev)
        with host_step(timings, "slice"):
            op = sliced.slice_ell(dvals, dcols, E.ncols)
        del dvals, dcols
        return cls(vals=vals, colidx=cols, sliced=op, nrows=int(E.nrows),
                   ncols=int(E.ncols), nnz=int(E.nnz),
                   vec_dtype=str(torch_dtype(vdt)).removeprefix("torch."))

    @property
    def device(self) -> torch.device:
        return self.sliced.device

    @property
    def mat_itemsize(self) -> int:
        return self.vals.element_size()

    def operator_stream_bytes(self) -> int:
        """Bytes of the operator stream per SpMV: the sliced layout's."""
        return self.sliced.stream_bytes()

    def padded_bytes(self) -> int:
        """Bytes of the padded value rectangle at its storage width plus
        the column rectangle (the JAX package's
        ``operator_stream_bytes``)."""
        return (self.vals.numel() * self.mat_itemsize
                + self.colidx.numel() * self.colidx.element_size())

    @property
    def nrows_padded(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x; a (B, n) batch runs the one-system kernel once per system
        (every system's row is then exactly its one-system SpMV)."""
        if x.dim() == 2:
            return torch.stack([ell_spmv(self.sliced, xi) for xi in x])
        return ell_spmv(self.sliced, x)

    def matvec_dot(self, x: torch.Tensor):
        """(A x, <x, A x>), per system for a (B, n) batch: the SpMV, then
        the dot (no kernel fuses them)."""
        y = self.matvec(x)
        return y, batched_dot(x, y)


def pad_vector(x: np.ndarray, nrows_padded: int) -> np.ndarray:
    """Zero-pad a host vector (last axis; a leading batch axis passes
    through) to the operator's padded row count."""
    x = np.asarray(x)
    if x.shape[-1] == nrows_padded:
        return x
    out = np.zeros(x.shape[:-1] + (nrows_padded,), dtype=x.dtype)
    out[..., : x.shape[-1]] = x
    return out
