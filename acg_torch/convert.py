"""Build the port's operators from another implementation's arrays.

The JAX package's ``DeviceDia`` / ``DeviceStencil`` reduce to numpy
arrays plus static fields, and its ``PartitionedSystem`` to numpy arrays
per part; these constructors take exactly those, so a test can apply
literally the same operator, or solve on literally the same shards, in
both packages.  bfloat16
arrays arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses: they cross as their raw ``uint16`` bits,
re-viewed as ``torch.bfloat16`` (no ``ml_dtypes`` needed).
"""

from __future__ import annotations

import numpy as np
import torch

from acg_torch.ops.dia import DeviceDia
from acg_torch.ops.stencil import DeviceStencil, StencilSpec
from acg_torch.partition.graph import LocalPartition, PartitionedSystem
from acg_torch.sparse.csr import CsrMatrix
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


def partitioned_system_from_arrays(nrows: int, part, parts,
                                   rcm_localized: bool = False
                                   ) -> PartitionedSystem:
    """A ``PartitionedSystem`` from the JAX package's fields as numpy
    arrays: the global ``part`` vector and, per part, a mapping with
    ``owned_global``, ``ninterior``, ``ghost_global``, ``ghost_owner``,
    ``A_local`` and ``A_iface`` as (rowptr, colidx, vals) triples (nown ×
    nown and nown × max(nghost, 1)), ``neighbors``, ``send_counts``,
    ``send_idx`` and ``recv_counts``, in part order."""
    def arr(a, dtype=None):
        return np.array(a, dtype=dtype, copy=True)

    out = []
    for i, d in enumerate(parts):
        own = arr(d["owned_global"], np.int64)
        gho = arr(d["ghost_global"], np.int64)
        nown, nghost = len(own), len(gho)
        csr = [CsrMatrix(nown, ncols, arr(rp, np.int64), arr(ci),
                         arr(vv))
               for (rp, ci, vv), ncols in ((d["A_local"], nown),
                                           (d["A_iface"], max(nghost, 1)))]
        out.append(LocalPartition(
            part=i, owned_global=own, ninterior=int(d["ninterior"]),
            ghost_global=gho, ghost_owner=arr(d["ghost_owner"]),
            A_local=csr[0], A_iface=csr[1],
            neighbors=arr(d["neighbors"], np.int32),
            send_counts=arr(d["send_counts"], np.int64),
            send_idx=arr(d["send_idx"], np.int64),
            recv_counts=arr(d["recv_counts"], np.int64)))
    part = arr(part, np.int32)
    return PartitionedSystem(nrows=int(nrows), nparts=len(out), part=part,
                             parts=out, rcm_localized=rcm_localized)
