"""Matrix-free constant-coefficient stencil operator.

The port of ``acg_tpu/ops/stencil.py``.  A stored matrix that is EXACTLY
a constant-coefficient nearest-neighbour stencil on a regular grid with
Dirichlet truncation (the Poisson family) needs no band storage: its
action is regenerated from (grid, arm offsets, arm digits, coefficients).

- **Recognition** (:func:`recognize_stencil`): per-diagonal coefficient
  uniformity, grid hypotheses from the offsets, a unique balanced-digit
  decomposition of every offset, and an exact match of every band's zero
  pattern against the predicted boundary mask.  Only a verified match
  engages the tier.
- **:class:`DeviceStencil`**: the device operator, holding no tensors.
- **:func:`stencil_spmv`**: the kernel wrapper (``csrc/stencil_spmv.cu``
  on a CUDA tensor, the plain grid-shift :func:`stencil_matvec` on a CPU
  tensor), with an optional fused <x, y>.  The kernel has a generic form
  and one with the arm count fixed at 5, 7 or 27 (:func:`fixed_arms`,
  :func:`interior_box`, :func:`stride_coords`: its plan and geometry).
- **:func:`stencil_spmv_batched`**: the multi-RHS wrapper over B systems
  (``csrc/stencil_spmv_batched.cu`` on a CUDA tensor, the same
  :func:`stencil_matvec` on a CPU ``(B, npad)`` tensor).
- **:func:`cg_pipelined_iter_stencil`**: one whole pipelined-CG iteration
  over the stencil (``csrc/stencil_pipe.cu`` on a CUDA tensor,
  :func:`cg_pipelined_iter_stencil_plain` on a CPU tensor).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import itertools

import numpy as np
import torch

from acg_torch.errors import AcgError, Status
from acg_torch.ops.blas1 import batched_dot, pipelined_update
from acg_torch.ops.dia_kernels import (THREADS, check_pipe_operands,
                                       grid_blocks)
from acg_torch.utils.backend import kernel_device

# a "stencil" with more arms than the densest supported family (27-pt box)
# is not one
_MAX_ARMS = 32

# kernel launches so far (each wrapper adds one per launch, nowhere else):
# stencil_spmv, cg_pipelined_iter_stencil, and stencil_spmv_batched (one
# per call, which runs ceil(B/8) chunk launches)
launches = 0
pipe_launches = 0
batched_launches = 0

_VEC_CODES = {torch.float32: 2, torch.float64: 3}


# ---------------------------------------------------------------------------
# recognition


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A verified constant-coefficient stencil: ``grid`` (row-major, last
    axis fastest), sorted flat diagonal ``offsets``, per-offset per-axis
    ``digits`` in {-1, 0, 1} (``sum(digits * strides) == offset``), and
    the per-arm ``coeffs`` (python floats, exact images of the stored
    band values at the recognition dtype)."""

    grid: tuple
    offsets: tuple
    digits: tuple
    coeffs: tuple
    nnz: int

    @property
    def nrows(self) -> int:
        n = 1
        for d in self.grid:
            n *= int(d)
        return n

    def spec_hash(self) -> str:
        """Structure hash (grid + arms + coefficient bytes at f64)."""
        h = hashlib.sha256()
        h.update(repr((self.grid, self.offsets, self.digits)).encode())
        h.update(np.asarray(self.coeffs, dtype=np.float64).tobytes())
        return h.hexdigest()[:16]


def _grid_hypotheses(n: int, offsets: tuple) -> list:
    """Candidate grid shapes implied by the positive diagonal offsets:
    the inner stride must be 1, outer strides are positive offsets
    dividing n.  Wrong hypotheses are harmless — the exact pattern
    verification rejects them."""
    pos = [int(o) for o in offsets if o > 0]
    hyps: list = []
    if not pos:
        return [(n,)]               # pure-diagonal operator: 1-D grid
    if pos[0] != 1:
        return []
    hyps.append((n,))
    for a in pos:
        if a > 1 and n % a == 0:
            hyps.append((n // a, a))
            for b in pos:
                if b > a and b % a == 0 and n % b == 0:
                    hyps.append((n // b, b // a, a))
    return hyps


def _decompose_offsets(offsets: tuple, grid: tuple):
    """Per-offset balanced digits in {-1, 0, 1}^k with
    ``dot(digits, strides) == offset`` — or None when any offset has no
    (or no unique) decomposition."""
    k = len(grid)
    strides = [1] * k
    for i in range(k - 2, -1, -1):
        strides[i] = strides[i + 1] * int(grid[i + 1])
    out = []
    for off in offsets:
        sols = [g for g in itertools.product((-1, 0, 1), repeat=k)
                if sum(gi * si for gi, si in zip(g, strides)) == off]
        if len(sols) != 1:
            return None
        out.append(sols[0])
    return tuple(out)


def _verify_pattern(bands: np.ndarray, n: int, grid: tuple,
                    digits: tuple, chunk: int = 1 << 20) -> bool:
    """Every band's zero pattern must EXACTLY equal the predicted
    Dirichlet boundary mask of its arm (chunked O(D·n) host sweep)."""
    nrp = bands.shape[1]
    for s in range(0, nrp, chunk):
        e = np.arange(s, min(s + chunk, nrp), dtype=np.int64)
        inb = e < n
        coords = np.unravel_index(np.minimum(e, max(n - 1, 0)), grid)
        for d, dg in enumerate(digits):
            ok = inb.copy()
            for ax, g in enumerate(dg):
                if g:
                    nc = coords[ax] + g
                    ok &= (nc >= 0) & (nc < grid[ax])
            if not np.array_equal(bands[d, s: s + len(e)] != 0, ok):
                return False
    return True


def recognize_stencil(A, dtype=None, offsets=None):
    """(StencilSpec, "") when ``A`` (a host CsrMatrix or DiaMatrix) is
    EXACTLY a constant-coefficient nearest-neighbour stencil on a regular
    grid, else (None, reason).  Coefficients are read from the bands cast
    to ``dtype``, the vector dtype of the solve."""
    from acg_torch.ops.dia import DiaMatrix, two_value_scales
    from acg_torch.sparse.csr import CsrMatrix

    if isinstance(A, DiaMatrix):
        D = A
    elif isinstance(A, CsrMatrix):
        if A.nrows != A.ncols:
            return None, "matrix is not square"
        if A.nrows == 0 or A.nnz == 0:
            return None, "empty matrix"
        # the arm bound BEFORE materializing bands: an unstructured matrix
        # has O(nnz) distinct diagonals and its band array would be huge
        ndiags = (len(offsets) if offsets is not None else
                  len(np.unique(A.colidx.astype(np.int64) - A._rowids())))
        if ndiags > _MAX_ARMS:
            return None, (f"{ndiags} diagonals exceed the "
                          f"{_MAX_ARMS}-arm stencil family bound")
        D = DiaMatrix.from_csr(A)
    else:
        return None, f"unsupported operator type {type(A).__name__}"
    if D.nrows != D.ncols:
        return None, "matrix is not square"
    if len(D.offsets) > _MAX_ARMS:
        return None, (f"{len(D.offsets)} diagonals exceed the "
                      f"{_MAX_ARMS}-arm stencil family bound")
    vdt = np.dtype(dtype if dtype is not None else D.bands.dtype)
    cast = np.asarray(D.bands, dtype=vdt)
    scales = two_value_scales(cast)
    if scales is None:
        return None, ("coefficients are not uniform per diagonal "
                      "(variable-coefficient operator)")
    n = D.nrows
    hyps = _grid_hypotheses(n, D.offsets)
    if not hyps:
        return None, ("diagonal offsets do not include the unit stride "
                      "(not a nearest-neighbour grid stencil)")
    for grid in hyps:
        digits = _decompose_offsets(D.offsets, grid)
        if digits is None:
            continue
        if _verify_pattern(cast, n, grid, digits):
            coeffs = tuple(float(s) for s in scales)
            return (StencilSpec(grid=tuple(int(d) for d in grid),
                                offsets=tuple(int(o) for o in D.offsets),
                                digits=digits, coeffs=coeffs,
                                nnz=int(D.nnz)), "")
    return None, ("no grid hypothesis reproduces the boundary zero "
                  "pattern of the stored bands")


# ---------------------------------------------------------------------------
# the plain version: grid shifts


def _grid_shift(t: torch.Tensor, axis: int, g: int) -> torch.Tensor:
    """out[..., j, ...] = t[..., j+g, ...] where in bounds, else 0."""
    d = t.shape[axis]
    out = torch.zeros_like(t)
    if g > 0:
        out.narrow(axis, 0, d - 1).copy_(t.narrow(axis, 1, d - 1))
    else:
        out.narrow(axis, 1, d - 1).copy_(t.narrow(axis, 0, d - 1))
    return out


def stencil_matvec(x: torch.Tensor, grid: tuple, digits: tuple,
                   coeffs: tuple) -> torch.Tensor:
    """y = stencil @ x through grid shifts, the plain PyTorch version
    (``acg_tpu.ops.stencil.stencil_matvec``): the boundary truncation IS
    the zero fill of each axis shift.  ``x`` is ``(..., npad)`` with
    ``npad >= prod(grid)`` (leading axes are a batch of systems, each
    given exactly the arithmetic of a 1-D ``x``); entries past the grid
    come back exactly 0.  Arms are applied in sorted flat-offset order."""
    n = 1
    for d in grid:
        n *= int(d)
    lead = tuple(x.shape[:-1])
    npad = x.shape[-1]
    xg = x[..., :n].reshape(lead + tuple(grid))
    y = torch.zeros_like(xg)
    for dg, c in zip(digits, coeffs):
        t = xg
        for ax, g in enumerate(dg):
            if g:
                t = _grid_shift(t, len(lead) + ax, g)
        y = y + torch.tensor(c, dtype=x.dtype) * t
    y = y.reshape(lead + (n,))
    if npad != n:
        y = torch.cat([y, torch.zeros(lead + (npad - n,), dtype=x.dtype,
                                      device=x.device)], dim=-1)
    return y


# ---------------------------------------------------------------------------
# the fixed-arm kernel's plan and geometry (csrc/stencil_spmv.cu)

FIXED_ARMS = (5, 7, 27)     # the arm counts of stencil_spmv's fixed-arm
#                             kernel: 2-D 5-point, 3-D 7- and 27-point


def fixed_arms(spec: StencilSpec) -> bool:
    """Whether :func:`stencil_spmv` runs the fixed-arm kernel for
    ``spec`` unless told otherwise (the plan): every arm count that
    kernel is compiled for.  The same bits either way."""
    return len(spec.offsets) in FIXED_ARMS


def route(spec: StencilSpec, fixed=None) -> str:
    """The kernel a CUDA :func:`stencil_spmv` call with ``fixed`` runs:
    ``"fixed-<arms>"`` or ``"generic"``."""
    if fixed is None:
        fixed = fixed_arms(spec)
    return f"fixed-{len(spec.offsets)}" if fixed else "generic"


def interior_box(dims: tuple, digits) -> tuple:
    """(lo, hi) per axis: an element whose coordinate c_a lies in
    [lo_a, hi_a] on every axis has every arm inside the grid.  lo_a is 1
    when an arm steps -1 along axis a, hi_a is dims_a - 1 less 1 when one
    steps +1; the box is empty (hi_a < lo_a) on an axis too short for
    its arms.  The fixed-arm kernel sums a row inside the box on the
    first two axes with its loads issued up front, masking off the arms
    that step past [lo_2, hi_2] on the last."""
    lo = tuple(int(any(dg[a] < 0 for dg in digits)) for a in range(3))
    hi = tuple(dims[a] - 1 - int(any(dg[a] > 0 for dg in digits))
               for a in range(3))
    return lo, hi


def stride_coords(step: int, dims: tuple) -> tuple:
    """The grid coordinates (s0, s1, s2) of the flat step ``step`` (the
    launch's grid stride); s0 may exceed dims[0]."""
    r, s2 = divmod(step, dims[2])
    s0, s1 = divmod(r, dims[1])
    return s0, s1, s2


# ---------------------------------------------------------------------------
# the kernel wrappers


class _CStencil(ctypes.Structure):
    """The ``acg::StencilArgs`` struct of csrc/common.cuh."""

    _fields_ = [("narms", ctypes.c_int32),
                ("dims", ctypes.c_int32 * 3),
                ("offsets", ctypes.c_int32 * _MAX_ARMS),
                ("digits", (ctypes.c_int32 * 3) * _MAX_ARMS),
                ("coeffs", ctypes.c_double * _MAX_ARMS),
                ("stride", ctypes.c_int32 * 3),
                ("lo", ctypes.c_int32 * 3),
                ("hi", ctypes.c_int32 * 3)]


@functools.lru_cache(maxsize=64)
def _c_spec(spec: StencilSpec, nblocks: int = 1) -> _CStencil:
    """The spec as the kernel's struct for a launch of ``nblocks`` blocks:
    the grid padded with leading unit axes to 3-D (digits padded with
    leading zeros), the launch stride's coordinates, the interior box."""
    lead = 3 - len(spec.grid)
    dims = (1,) * lead + tuple(int(d) for d in spec.grid)
    digits = tuple((0,) * lead + tuple(int(g) for g in dg)
                   for dg in spec.digits)
    a = _CStencil()
    a.narms = len(spec.offsets)
    for ax in range(3):
        a.dims[ax] = dims[ax]
    for i, (off, dg, c) in enumerate(zip(spec.offsets, digits,
                                         spec.coeffs)):
        a.offsets[i] = int(off)
        for ax in range(3):
            a.digits[i][ax] = dg[ax]
        a.coeffs[i] = float(c)
    lo, hi = interior_box(dims, digits)
    for ax, v in enumerate(stride_coords(nblocks * THREADS, dims)):
        a.stride[ax] = v
        a.lo[ax], a.hi[ax] = lo[ax], hi[ax]
    return a


_lib = None
_pipe_lib = None
_batched_lib = None


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("stencil_spmv")
        lib.acg_stencil_spmv.restype = ctypes.c_int
        lib.acg_stencil_spmv.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check_spec(name: str, spec: StencilSpec, x: torch.Tensor,
                batched: bool = False) -> None:
    n, npad = spec.nrows, x.shape[-1]
    if x.dtype not in _VEC_CODES:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"{name}: vector dtype {x.dtype} (float32|float64)")
    shape = "(B, npad) batch" if batched else "(npad,) vector"
    if (x.dim() != (2 if batched else 1) or not x.is_contiguous()
            or not 0 < n <= npad or x.numel() == 0):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"{name}: x must be a contiguous {shape} "
                       f"with npad >= {n}, got {tuple(x.shape)}")
    if npad >= 2**31 or len(spec.grid) > 3 or len(spec.offsets) > _MAX_ARMS:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"{name}: the kernel takes npad < 2^31, grids "
                       f"of at most 3 axes and {_MAX_ARMS} arms")


def stencil_spmv(spec: StencilSpec, x: torch.Tensor, with_dot: bool = False,
                 fixed=None):
    """y = stencil @ x, plus the scalar <x, y> when ``with_dot``.

    ``x``: (npad,) f32 or f64 with ``npad >= prod(spec.grid)``; entries
    past the grid come back exactly 0.  ``fixed``: None (every caller of
    the solvers) as the plan says (:func:`fixed_arms`); True or False
    force the fixed-arm kernel (an arm count in ``FIXED_ARMS``, else the
    launch raises) or the generic one, for holding one against the
    other.  The same bits either way.  Returns ``y`` or
    ``(y, dot)`` with ``dot`` a 0-d tensor.  CUDA tensors launch the
    kernel; CPU tensors take :func:`stencil_matvec`."""
    global launches
    if x.device.type == "cpu":
        y = stencil_matvec(x, spec.grid, spec.digits, spec.coeffs)
        return (y, torch.dot(x, y)) if with_dot else y
    if x.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"stencil_spmv: no kernel for device {x.device}")
    _check_spec("stencil_spmv", spec, x)
    n, npad = spec.nrows, x.shape[-1]
    lib = _load()
    nblocks = grid_blocks(npad)
    y = torch.empty_like(x)
    partials = dot = None
    if with_dot:
        partials = torch.empty(nblocks, dtype=x.dtype, device=x.device)
        dot = torch.empty((), dtype=x.dtype, device=x.device)
    if fixed is None:
        fixed = fixed_arms(spec)
    with kernel_device(x):
        rc = lib.acg_stencil_spmv(
            ctypes.addressof(_c_spec(spec, nblocks)), x.data_ptr(),
            y.data_ptr(), _VEC_CODES[x.dtype], npad, n, int(fixed),
            partials.data_ptr() if with_dot else None, nblocks,
            dot.data_ptr() if with_dot else None,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"stencil_spmv: kernel launch failed (CUDA error {rc})")
    launches += 1
    return (y, dot) if with_dot else y


def _load_batched():
    global _batched_lib
    if _batched_lib is None:
        from acg_torch import _build

        lib = _build.load("stencil_spmv_batched")
        lib.acg_stencil_spmv_batched.restype = ctypes.c_int
        lib.acg_stencil_spmv_batched.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        _batched_lib = lib
    return _batched_lib


def stencil_spmv_batched(spec: StencilSpec, X: torch.Tensor,
                         with_dot: bool = False):
    """Y = stencil @ X for B systems, plus the per-system
    ``dots[s] = <X[s], Y[s]>`` when ``with_dot``.

    ``X``: contiguous ``(B, npad)`` f32 or f64 with ``npad >=
    prod(spec.grid)``; entries past the grid come back exactly 0.
    Returns ``Y`` or ``(Y, dots)`` with ``dots`` of shape ``(B,)``.  CUDA
    tensors launch the kernel, which derives each element's grid
    coordinates once for up to 8 systems and gives each system the bits
    :func:`stencil_spmv` gives it; CPU tensors take
    :func:`stencil_matvec` and one ``torch.dot`` per system."""
    global batched_launches
    if X.device.type == "cpu":
        Y = stencil_matvec(X, spec.grid, spec.digits, spec.coeffs)
        return (Y, batched_dot(X, Y)) if with_dot else Y
    if X.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"stencil_spmv_batched: no kernel for device "
                       f"{X.device}")
    _check_spec("stencil_spmv_batched", spec, X, batched=True)
    nsys, npad = X.shape
    lib = _load_batched()
    nblocks = grid_blocks(npad)
    Y = torch.empty_like(X)
    partials = dots = None
    if with_dot:
        partials = torch.empty((nsys, nblocks), dtype=X.dtype,
                               device=X.device)
        dots = torch.empty(nsys, dtype=X.dtype, device=X.device)
    with kernel_device(X):
        rc = lib.acg_stencil_spmv_batched(
            ctypes.addressof(_c_spec(spec, nblocks)), X.data_ptr(),
            Y.data_ptr(), _VEC_CODES[X.dtype], npad, spec.nrows, nsys,
            partials.data_ptr() if with_dot else None, nblocks,
            dots.data_ptr() if with_dot else None,
            torch.cuda.current_stream(X.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"stencil_spmv_batched: kernel launch failed (CUDA "
                       f"error {rc})")
    batched_launches += 1
    return (Y, dots) if with_dot else Y


def cg_pipelined_iter_stencil_plain(spec: StencilSpec, w, z, r, p, s, x,
                                    alpha, beta):
    """One pipelined-CG iteration over the stencil, the plain PyTorch
    version: q = stencil @ w (:func:`stencil_matvec`), the 6-vector
    update, then gamma = <r', r'> and delta = <w', r'>.  Returns new
    tensors ``(z', p', s', x', r', w', gamma, delta)`` (the contract of
    ``acg_tpu``'s ``cg_pipelined_iter_stencil``)."""
    q = stencil_matvec(w, spec.grid, spec.digits, spec.coeffs)
    z2, p2, s2, x2, r2, w2 = pipelined_update(q, w, z, r, p, s, x, alpha,
                                              beta)
    return z2, p2, s2, x2, r2, w2, torch.dot(r2, r2), torch.dot(w2, r2)


def _load_pipe():
    global _pipe_lib
    if _pipe_lib is None:
        from acg_torch import _build

        lib = _build.load("stencil_pipe")
        lib.acg_stencil_pipe.restype = ctypes.c_int
        lib.acg_stencil_pipe.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])
        _pipe_lib = lib
    return _pipe_lib


def cg_pipelined_iter_stencil(spec: StencilSpec, w, z, r, p, s, x, alpha,
                              beta, w_out=None):
    """One whole pipelined-CG iteration over the stencil
    (``acg_tpu``'s ``cg_pipelined_iter_stencil``): q = stencil @ w, the
    6-vector update and (gamma, delta) in one pass, with no band operand.
    Returns ``(z', p', s', x', r', w', gamma, delta)``, gamma and delta
    0-d tensors.

    Vectors are (npad,) with ``npad >= prod(spec.grid)``, zero past the
    grid (and so zero there on return); ``alpha``/``beta`` are 0-d
    tensors at the vector dtype, read by the kernel from device memory.
    On a CUDA tensor the kernel updates z, p, s, x and r IN PLACE and
    writes w' into ``w_out`` (allocated when None; it must not share
    memory with w or the other vectors).  CPU tensors take
    :func:`cg_pipelined_iter_stencil_plain`, which returns new tensors."""
    global pipe_launches
    if w.device.type == "cpu":
        return cg_pipelined_iter_stencil_plain(spec, w, z, r, p, s, x, alpha,
                                               beta)
    if w.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"cg_pipelined_iter_stencil: no kernel for device "
                       f"{w.device}")
    if w_out is None:
        w_out = torch.empty_like(w)
    check_pipe_operands("cg_pipelined_iter_stencil", w, z, r, p, s, x, alpha,
                        beta, w_out)
    _check_spec("cg_pipelined_iter_stencil", spec, w)
    lib = _load_pipe()
    npad = w.shape[0]
    nblocks = grid_blocks(npad)
    partials = torch.empty(2 * nblocks, dtype=w.dtype, device=w.device)
    gd = torch.empty(2, dtype=w.dtype, device=w.device)
    with kernel_device(w):
        rc = lib.acg_stencil_pipe(
            ctypes.addressof(_c_spec(spec, nblocks)), alpha.data_ptr(),
            beta.data_ptr(), w.data_ptr(), w_out.data_ptr(), z.data_ptr(),
            r.data_ptr(),
            p.data_ptr(), s.data_ptr(), x.data_ptr(), _VEC_CODES[w.dtype],
            npad,
            spec.nrows, partials.data_ptr(), nblocks, gd.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"cg_pipelined_iter_stencil: kernel launch failed "
                       f"(CUDA error {rc})")
    pipe_launches += 1
    return z, p, s, x, r, w_out, gd[0], gd[1]


# ---------------------------------------------------------------------------
# the device operator


@dataclasses.dataclass(frozen=True)
class DeviceStencil:
    """Matrix-free device operator: the operator IS its spec, so nothing
    is uploaded and ``operator_stream_bytes() == 0``.  ``device`` is where
    its vectors live."""

    spec: StencilSpec
    nrows: int
    ncols: int
    nnz: int
    vec_dtype: str
    device: torch.device

    @classmethod
    def from_spec(cls, spec: StencilSpec, dtype=None,
                  device=None) -> "DeviceStencil":
        from acg_torch.utils.backend import resolve_device

        vdt = np.dtype(dtype if dtype is not None else np.float64)
        return cls(spec=spec, nrows=spec.nrows, ncols=spec.nrows,
                   nnz=spec.nnz, vec_dtype=vdt.name,
                   device=resolve_device(device))

    @classmethod
    def from_matrix(cls, A, dtype=None, device=None) -> "DeviceStencil":
        """Recognize-or-raise: the forced fmt="stencil" entry."""
        vdt = np.dtype(dtype) if dtype is not None else None
        spec, why = recognize_stencil(A, dtype=vdt)
        if spec is None:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           "format 'stencil' forced but the matrix is "
                           "not a recognized constant-coefficient "
                           f"stencil: {why}")
        return cls.from_spec(
            spec, dtype=vdt if vdt is not None else _host_dtype(A),
            device=device)

    @property
    def nrows_padded(self) -> int:
        # the same row_align=8 padding as DiaMatrix.from_csr, so padded
        # right-hand sides fit both tiers
        return max(-(-self.nrows // 8) * 8, 8)

    @property
    def mat_itemsize(self) -> int:
        return 0

    def operator_stream_bytes(self) -> int:
        return 0

    def _spmv(self, x: torch.Tensor, with_dot: bool):
        """A (B, npad) batch of systems takes the multi-RHS kernel, a 1-D
        vector the one-system kernel (``acg_tpu``'s stencil_matvec_any)."""
        spmv = stencil_spmv_batched if x.dim() == 2 else stencil_spmv
        return spmv(self.spec, x, with_dot=with_dot)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._spmv(x, False)

    def matvec_dot(self, x: torch.Tensor):
        """(A x, <x, A x>) in one pass; per system for a (B, npad)
        batch."""
        return self._spmv(x, True)

    def pipelined_iter(self, w, z, r, p, s, x, alpha, beta, w_out=None):
        """One pipelined-CG iteration (:func:`cg_pipelined_iter_stencil`)."""
        return cg_pipelined_iter_stencil(self.spec, w, z, r, p, s, x, alpha,
                                         beta, w_out=w_out)


def _host_dtype(A) -> np.dtype:
    vals = getattr(A, "vals", getattr(A, "bands", None))
    return np.dtype(vals.dtype if vals is not None else np.float64)


def try_device_stencil(A, dtype=None, device=None):
    """(DeviceStencil, "") when ``A`` recognizes, else (None, reason) —
    the fmt="auto" entry (never raises on a non-stencil)."""
    vdt = np.dtype(dtype) if dtype is not None else None
    spec, why = recognize_stencil(A, dtype=vdt)
    if spec is None:
        return None, why
    return (DeviceStencil.from_spec(
        spec, dtype=vdt if vdt is not None else _host_dtype(A),
        device=device), "")
