"""Padded-ELL SpMV on the device: the gather tier for unstructured
operators.

The port of ``acg_tpu/ops/spmv.py`` (``DeviceEll``, the XLA gather
formulation ``ell_matvec``, ``pad_vector``) and of the TPU kernel
``acg_tpu/ops/pallas_spmv.py`` ``ell_matvec_pallas``.  On a CUDA tensor
:func:`ell_spmv` launches the hand-written kernel of
``acg_torch/csrc/ell_spmv.cu``; on a CPU tensor it runs
:func:`ell_matvec`, the plain PyTorch version of the same function.
There is no fallback between the two: a CUDA call that cannot launch
raises.  On the card the kernel serves every ELL matvec at both vector
precisions, where the JAX package used XLA's gather wherever its TPU
kernel could not run (f64, batched vectors, x outgrowing VMEM).

Neither the TPU kernel nor this one fuses a dot: ``matvec_dot`` is the
SpMV and then ``batched_dot``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from acg_torch.errors import AcgError, Status
from acg_torch.ops.blas1 import batched_dot
from acg_torch.ops.dia import resolve_mat_dtype, torch_dtype
from acg_torch.utils.backend import kernel_device
from acg_torch.utils.timing import host_step

# kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0

THREADS = 256          # acg::kThreads in csrc/common.cuh

_VAL_CODES = {torch.bfloat16: 0, torch.float32: 2, torch.float64: 3}
_VEC_CODES = {torch.float32: 2, torch.float64: 3}

_lib = None


def ell_matvec(vals: torch.Tensor, colidx: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_w vals[i, w] * x[colidx[i, w]], the plain PyTorch
    version (``acg_tpu.ops.spmv.ell_matvec``): values upcast to the
    vector dtype, a (rows, W) gather, a multiply and a row sum.  ``x`` is
    ``(n,)`` or ``(B, n)``; padding lanes (value 0, column 0) add 0."""
    return (vals.to(x.dtype) * x[..., colidx]).sum(-1)


def group_size(width: int) -> int:
    """Threads that share one row in the kernel: the least power of two
    covering the row, at most a warp (``kGroup`` of the launch)."""
    g = 1
    while g < min(width, 32):
        g *= 2
    return g


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("ell_spmv")
        lib.acg_ell_spmv.restype = ctypes.c_int
        lib.acg_ell_spmv.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(vals, colidx, x):
    def bad(msg):
        raise AcgError(Status.ERR_INVALID_VALUE, f"ell_spmv: {msg}")

    if x.dtype not in _VEC_CODES:
        bad(f"vector dtype {x.dtype} (float32|float64)")
    if vals.dtype not in _VAL_CODES:
        bad(f"value dtype {vals.dtype} (bfloat16|float32|float64)")
    if colidx.dtype != torch.int32:
        bad(f"column dtype {colidx.dtype} (int32)")
    if (vals.dim() != 2 or colidx.shape != vals.shape or x.dim() != 1
            or vals.shape[0] == 0 or vals.shape[1] == 0 or x.numel() == 0):
        bad(f"shapes vals {tuple(vals.shape)}, colidx "
            f"{tuple(colidx.shape)}, x {tuple(x.shape)}: want (n, W), "
            "(n, W) and (m,) with n, W, m > 0")
    for t in (vals, colidx, x):
        if t.device != x.device:
            bad("all operands must be on the vector's device")
        if not t.is_contiguous():
            bad("operands must be contiguous")


def ell_spmv(vals: torch.Tensor, colidx: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = ELL(vals, colidx) @ x for one system: y has n entries.

    ``vals``: (n, W) bf16, f32 or f64; ``colidx``: (n, W) int32 in [0, m),
    padding lanes pointing at column 0 with value 0; ``x``: (m,) f32 or
    f64 of any length m > 0, so the operator may be rectangular (the
    distributed solver's interface operator, owned rows × ghost slots).
    ``colidx < m`` is the caller's contract: the wrapper does not check
    the columns on each call, the builders of the operators do once
    (:meth:`DeviceEll.from_ell`, the distributed interface operator).
    A column out of range reads outside ``x``.  CUDA tensors launch the kernel (a
    group of ``group_size(W)`` threads per row, its partial sums added in
    a fixed tree, so the bits are the same on every run); CPU tensors
    take :func:`ell_matvec`."""
    global launches
    if x.device.type == "cpu":
        return ell_matvec(vals, colidx, x)
    if x.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"ell_spmv: no kernel for device {x.device}")
    _check(vals, colidx, x)
    lib = _load()
    n, width = vals.shape
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    with kernel_device(x):
        rc = lib.acg_ell_spmv(
            vals.data_ptr(), _VAL_CODES[vals.dtype], colidx.data_ptr(),
            x.data_ptr(), y.data_ptr(), _VEC_CODES[x.dtype], n, width,
            group_size(width), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"ell_spmv: kernel launch failed (CUDA error {rc})")
    launches += 1
    return y


@dataclasses.dataclass(frozen=True)
class DeviceEll:
    """Device-resident ELL operator (``acg_tpu.ops.spmv.DeviceEll``).

    ``vals``/``colidx`` have shape (nrows_padded, width); padding lanes
    have value 0 and column 0, so matvec needs no masking.  ``vals`` may
    be stored narrower than ``vec_dtype`` (bf16 when exact); all
    arithmetic runs at ``vec_dtype``."""

    vals: torch.Tensor
    colidx: torch.Tensor
    nrows: int
    ncols: int
    nnz: int
    vec_dtype: str

    @classmethod
    def from_ell(cls, E, dtype=None, mat_dtype="auto", device=None,
                 timings: dict | None = None) -> "DeviceEll":
        """Upload a host :class:`~acg_torch.sparse.ell.EllMatrix`, values
        stored at ``resolve_mat_dtype`` (bf16 when the cast is exact under
        ``"auto"``).  ``timings`` gathers the host seconds of the upload
        (step ``"upload"``)."""
        from acg_torch.utils.backend import resolve_device

        dev = resolve_device(device)
        if E.colidx.size and (E.colidx.min() < 0
                              or E.colidx.max() >= E.ncols):
            raise AcgError(Status.ERR_INDEX_OUT_OF_BOUNDS,
                           f"ELL columns outside [0, {E.ncols})")
        vdt = np.dtype(dtype if dtype is not None else E.vals.dtype)
        mdt = resolve_mat_dtype(E.vals, mat_dtype, vdt)
        host = E.vals if E.vals.dtype == vdt else E.vals.astype(vdt)
        with host_step(timings, "upload"):
            vals = torch.from_numpy(np.ascontiguousarray(host)).to(mdt)
            cols = torch.from_numpy(np.ascontiguousarray(E.colidx,
                                                         dtype=np.int32))
            return cls(vals=vals.to(dev), colidx=cols.to(dev),
                       nrows=int(E.nrows), ncols=int(E.ncols),
                       nnz=int(E.nnz),
                       vec_dtype=str(torch_dtype(vdt)).removeprefix(
                           "torch."))

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def mat_itemsize(self) -> int:
        return self.vals.element_size()

    def operator_stream_bytes(self) -> int:
        """Bytes of the operator stream per SpMV: the padded value
        rectangle at its storage width plus the column rectangle."""
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
            return torch.stack([ell_spmv(self.vals, self.colidx, xi)
                                for xi in x])
        return ell_spmv(self.vals, self.colidx, x)

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
