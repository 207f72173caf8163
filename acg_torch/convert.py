"""Build the port's operators from another implementation's arrays.

The JAX package's ``DeviceDia`` / ``DeviceStencil`` reduce to numpy
arrays plus static fields; these constructors take exactly those, so a
test can apply literally the same operator in both packages.  bfloat16
arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses: they cross as their raw ``uint16`` bits,
re-viewed as ``torch.bfloat16`` (no ``ml_dtypes`` needed).
"""

from __future__ import annotations

import numpy as np
import torch

from acg_torch.ops.dia import DeviceDia
from acg_torch.ops.stencil import DeviceStencil, StencilSpec
from acg_torch.utils.backend import resolve_device


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor of ``a``; a 2-byte bfloat16 array crosses bit-exact
    through a ``uint16`` view."""
    a = np.array(a, copy=True, order="C")      # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def device_dia_from_arrays(bands, scales, offsets, nrows: int, ncols: int,
                           nnz: int, vec_dtype, device=None) -> DeviceDia:
    """A ``DeviceDia`` holding ``bands`` (D, n) at their own storage dtype
    (bf16, int8 mask, f32 or f64), ``scales`` (D,) or None, on
    ``device``."""
    dev = resolve_device(device)
    return DeviceDia.from_bands(
        tensor_from_numpy(bands).to(dev),
        None if scales is None else tensor_from_numpy(scales),
        offsets, nrows, ncols, nnz, np.dtype(vec_dtype).name)


def device_stencil_from_fields(grid, offsets, digits, coeffs, nrows: int,
                               nnz: int, vec_dtype,
                               device=None) -> DeviceStencil:
    """A ``DeviceStencil`` from a stencil's static fields."""
    spec = StencilSpec(grid=tuple(int(d) for d in grid),
                       offsets=tuple(int(o) for o in offsets),
                       digits=tuple(tuple(int(g) for g in dg)
                                    for dg in digits),
                       coeffs=tuple(float(c) for c in coeffs), nnz=int(nnz))
    if spec.nrows != int(nrows):
        raise ValueError(f"grid {spec.grid} has {spec.nrows} rows, "
                         f"not {nrows}")
    return DeviceStencil.from_spec(spec, dtype=vec_dtype, device=device)
