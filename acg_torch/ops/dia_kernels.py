"""The DIA kernel wrappers and their plain versions.

:func:`dia_spmv` is the port of the two TPU DIA kernels on the classic-CG
path, ``acg_tpu/ops/pallas_kernels.py`` ``dia_matvec_pallas_2d`` (the
eager matvec) and ``dia_matvec_pallas_2d_padded`` (the SpMV with p'Ap
fused in).  On a CUDA tensor it launches the hand-written kernel of
``acg_torch/csrc/dia_spmv.cu``; on a CPU tensor it runs
:func:`dia_matvec`, the plain PyTorch version of the same function.
:func:`cg_pipelined_iter` is the port of ``cg_pipelined_iter_pallas``
(one whole pipelined-CG iteration in one launch,
``acg_torch/csrc/dia_pipe.cu``), with :func:`cg_pipelined_iter_plain`
beside it.  :func:`dia_spmv_batched` is the port of
``dia_matvec_pallas_2d_padded_batched`` (B systems against one
operator, ``acg_torch/csrc/dia_spmv_batched.cu``), whose plain version
is :func:`dia_matvec` on a ``(B, n)`` tensor.
:func:`dia_spmv_ring` and :func:`dia_spmv_windows` are the ports of
``dia_matvec_pallas_hbm2d_ring`` and ``dia_matvec_pallas_hbm2d`` (the
SpMV for x past the on-chip store, x staged through shared memory:
``acg_torch/csrc/dia_hbm_ring.cu``, ``acg_torch/csrc/dia_hbm_windows.cu``),
with :func:`dia_matvec_ring_plain` and :func:`dia_matvec_windows_plain`
beside them, which read x only through the kernels' geometry
(``acg_torch/ops/dia_plan.py``).  There is no
fallback between a kernel and its plain version: a CUDA call that cannot
launch raises.

Vectors keep the ``DeviceDia`` layout (length ``nrows_padded``, no halo):
the kernel tests ``0 <= i + off < n`` per band instead of reading the
TPU kernels' zero halo.
"""

from __future__ import annotations

import ctypes

import torch

from acg_torch.errors import AcgError, Status
from acg_torch.ops.blas1 import batched_dot, pipelined_update
from acg_torch.ops.dia_plan import run_bounds
from acg_torch.utils.backend import kernel_device

# kernel launches so far (each wrapper adds one per launch, nowhere else):
# dia_spmv, cg_pipelined_iter, dia_spmv_batched (one per call, which
# runs ceil(B/8) chunk launches), dia_spmv_ring and dia_spmv_windows
launches = 0
pipe_launches = 0
batched_launches = 0
# the HBM tier: dia_spmv_ring and dia_spmv_windows
ring_launches = 0
windows_launches = 0

THREADS = 256          # acg::kThreads in csrc/common.cuh
MAX_BLOCKS = 4096      # fixed grid cap: the fused dot's partial count, and
#                        so its bits, depend on n alone

_BAND_CODES = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2,
               torch.float64: 3}
_VEC_CODES = {torch.float32: 2, torch.float64: 3}

_lib = None
_pipe_lib = None
_batched_lib = None
_ring_lib = None
_windows_lib = None


def grid_blocks(n: int) -> int:
    """Blocks of a grid-stride SpMV launch over ``n`` rows."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


def _shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """out[..., i] = x[..., i + off] with zero fill (along the last
    axis)."""
    if off == 0:
        return x
    n = x.shape[-1]
    out = torch.zeros_like(x)
    if abs(off) >= n:
        return out
    if off > 0:
        out[..., : n - off] = x[..., off:]
    else:
        out[..., -off:] = x[..., : n + off]
    return out


def dia_matvec(bands: torch.Tensor, offsets, x: torch.Tensor,
               scales: torch.Tensor | None = None) -> torch.Tensor:
    """y[i] = sum_d bands[d, i] * x[i + offsets[d]], the plain PyTorch
    version (``acg_tpu.ops.dia.dia_matvec``): one shifted multiply-add
    per band in ascending-offset order, bands upcast to the vector dtype.
    With ``scales`` the bands are an int8 0/1 mask and the true band is
    ``scales[d] * mask``.  ``x`` may carry leading batch axes (the system
    axis is last): each row gets exactly the arithmetic of a 1-D ``x``."""
    if scales is None and not bands.dtype.is_floating_point:
        raise TypeError("bands are a compressed int mask; pass the scales "
                        "from DeviceDia (or call DeviceDia.matvec)")
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        b = bands[d].to(x.dtype)
        if scales is not None:
            b = b * scales[d].to(x.dtype)
        y = y + b * _shift(x, int(off))
    return y


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("dia_spmv")
        lib.acg_dia_spmv.restype = ctypes.c_int
        lib.acg_dia_spmv.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(bands, scales, offsets, x, name="dia_spmv", batched=False):
    def bad(msg):
        raise AcgError(Status.ERR_INVALID_VALUE, f"{name}: {msg}")

    if x.dtype not in _VEC_CODES:
        bad(f"vector dtype {x.dtype} (float32|float64)")
    if bands.dtype not in _BAND_CODES:
        bad(f"band dtype {bands.dtype} (bfloat16|int8|float32|float64)")
    if (x.dim() != (2 if batched else 1) or bands.dim() != 2
            or bands.shape[1] != x.shape[-1]):
        bad(f"shapes bands {tuple(bands.shape)}, x {tuple(x.shape)}: want "
            f"(D, n) and {'(B, n)' if batched else '(n,)'}")
    if x.numel() == 0:
        bad("empty vector")
    if offsets.dtype != torch.int64 or offsets.shape != (bands.shape[0],):
        bad("offsets must be an int64 tensor of length D")
    if (bands.dtype == torch.int8) != (scales is not None):
        bad("an int8 band mask needs per-band scales, and only it takes them")
    if scales is not None and (scales.dtype != x.dtype
                               or scales.shape != (bands.shape[0],)):
        bad("scales must be (D,) at the vector dtype")
    for t in (bands, offsets, x) + ((scales,) if scales is not None else ()):
        if t.device != x.device:
            bad("all operands must be on the vector's device")
        if not t.is_contiguous():
            bad("operands must be contiguous")


def dia_spmv(bands: torch.Tensor, scales: torch.Tensor | None,
             offsets: torch.Tensor, x: torch.Tensor, with_dot: bool = False,
             fixed: bool = False):
    """y = DIA(bands, offsets) @ x, plus the scalar <x, y> when
    ``with_dot`` (for CG's t = A p that is p'Ap).

    ``bands``: (D, n) bf16, int8 0/1 mask (with ``scales``), f32 or f64;
    ``scales``: (D,) at the vector dtype or None; ``offsets``: (D,) int64
    tensor on the vector's device, ascending; ``x``: (n,) f32 or f64.
    ``fixed``: launch the kernel with the band count fixed (f32 vectors,
    D in ``dia_plan.FIXED_BANDS``; ``DeviceDia.fixed`` says when the plan
    takes it); the same bits either way.  Returns ``y`` or ``(y, dot)``
    with ``dot`` a 0-d tensor.  CUDA tensors launch the kernel; CPU
    tensors take :func:`dia_matvec`."""
    global launches
    if x.device.type == "cpu":
        y = dia_matvec(bands, offsets.tolist(), x, scales)
        return (y, torch.dot(x, y)) if with_dot else y
    if x.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"dia_spmv: no kernel for device {x.device}")
    _check(bands, scales, offsets, x)
    lib = _load()
    n = x.shape[0]
    nblocks = grid_blocks(n)
    y = torch.empty_like(x)
    partials = dot = None
    if with_dot:
        partials = torch.empty(nblocks, dtype=x.dtype, device=x.device)
        dot = torch.empty((), dtype=x.dtype, device=x.device)
    with kernel_device(x):
        rc = lib.acg_dia_spmv(
            bands.data_ptr(), _BAND_CODES[bands.dtype],
            scales.data_ptr() if scales is not None else None,
            offsets.data_ptr(), bands.shape[0], x.data_ptr(), y.data_ptr(),
            _VEC_CODES[x.dtype], n, int(fixed),
            partials.data_ptr() if with_dot else None, nblocks,
            dot.data_ptr() if with_dot else None,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"dia_spmv: kernel launch failed (CUDA error {rc})")
    launches += 1
    return (y, dot) if with_dot else y


# ---------------------------------------------------------------------------
# the multi-RHS SpMV


def _load_batched():
    global _batched_lib
    if _batched_lib is None:
        from acg_torch import _build

        lib = _build.load("dia_spmv_batched")
        lib.acg_dia_spmv_batched.restype = ctypes.c_int
        lib.acg_dia_spmv_batched.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        _batched_lib = lib
    return _batched_lib


def dia_spmv_batched(bands: torch.Tensor, scales: torch.Tensor | None,
                     offsets: torch.Tensor, X: torch.Tensor,
                     with_dot: bool = False):
    """Y = DIA(bands, offsets) @ X for B systems, plus the per-system
    ``dots[s] = <X[s], Y[s]>`` when ``with_dot`` (for CG's T = A P the
    p'Ap of every system).

    Operands as :func:`dia_spmv`, with ``X`` a contiguous ``(B, n)``
    tensor.  Returns ``Y`` (``(B, n)``) or ``(Y, dots)`` with ``dots`` of
    shape ``(B,)``.  CUDA tensors launch the kernel, which reads the band
    stream once per chunk of up to 8 systems and gives each system the
    bits :func:`dia_spmv` gives it; CPU tensors take :func:`dia_matvec`
    and one ``torch.dot`` per system."""
    global batched_launches
    if X.device.type == "cpu":
        Y = dia_matvec(bands, offsets.tolist(), X, scales)
        return (Y, batched_dot(X, Y)) if with_dot else Y
    if X.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"dia_spmv_batched: no kernel for device {X.device}")
    _check(bands, scales, offsets, X, name="dia_spmv_batched", batched=True)
    lib = _load_batched()
    nsys, n = X.shape
    nblocks = grid_blocks(n)
    Y = torch.empty_like(X)
    partials = dots = None
    if with_dot:
        partials = torch.empty((nsys, nblocks), dtype=X.dtype,
                               device=X.device)
        dots = torch.empty(nsys, dtype=X.dtype, device=X.device)
    with kernel_device(X):
        rc = lib.acg_dia_spmv_batched(
            bands.data_ptr(), _BAND_CODES[bands.dtype],
            scales.data_ptr() if scales is not None else None,
            offsets.data_ptr(), bands.shape[0], X.data_ptr(), Y.data_ptr(),
            _VEC_CODES[X.dtype], n, nsys,
            partials.data_ptr() if with_dot else None, nblocks,
            dots.data_ptr() if with_dot else None,
            torch.cuda.current_stream(X.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"dia_spmv_batched: kernel launch failed (CUDA error "
                       f"{rc})")
    batched_launches += 1
    return (Y, dots) if with_dot else Y


# ---------------------------------------------------------------------------
# the pipelined iteration


def cg_pipelined_iter_plain(bands, scales, offsets, w, z, r, p, s, x, alpha,
                            beta):
    """One pipelined-CG iteration over a DIA operator, the plain PyTorch
    version: q = DIA @ w (:func:`dia_matvec`), the 6-vector update, then
    gamma = <r', r'> and delta = <w', r'>.  ``offsets`` is a sequence of
    ints.  Returns new tensors ``(z', p', s', x', r', w', gamma, delta)``
    (the contract of ``acg_tpu``'s ``cg_pipelined_iter_pallas``)."""
    q = dia_matvec(bands, offsets, w, scales)
    z2, p2, s2, x2, r2, w2 = pipelined_update(q, w, z, r, p, s, x, alpha,
                                              beta)
    return z2, p2, s2, x2, r2, w2, torch.dot(r2, r2), torch.dot(w2, r2)


def check_pipe_operands(name, w, z, r, p, s, x, alpha, beta, w_out):
    """The argument checks shared by both pipelined-iteration wrappers:
    six contiguous (n,) vectors (and ``w_out``) of one float dtype on one
    device, in pairwise disjoint memory (the kernel updates z, p, s, x
    and r in place and writes w' while other threads read w), and alpha,
    beta one-element tensors of that dtype on that device."""
    def bad(msg):
        raise AcgError(Status.ERR_INVALID_VALUE, f"{name}: {msg}")

    vecs = (w, z, r, p, s, x, w_out)
    if w.dtype not in _VEC_CODES:
        bad(f"vector dtype {w.dtype} (float32|float64)")
    if w.dim() != 1 or w.shape[0] == 0:
        bad(f"w must be a non-empty (n,) vector, got {tuple(w.shape)}")
    for v in vecs:
        if (v.dtype != w.dtype or v.shape != w.shape or v.device != w.device
                or not v.is_contiguous()):
            bad("the vectors must be contiguous (n,) tensors of one dtype "
                "on one device")
    for t in (alpha, beta):
        if t.dtype != w.dtype or t.numel() != 1 or t.device != w.device:
            bad("alpha and beta must be one-element tensors at the vector "
                "dtype on the vectors' device")
    spans = sorted((v.data_ptr(), v.data_ptr() + v.numel() * v.element_size())
                   for v in vecs)
    if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
        bad("w_out and the six vectors must not share memory (w' cannot "
            "overwrite w while q = A w still reads it)")


def _load_pipe():
    global _pipe_lib
    if _pipe_lib is None:
        from acg_torch import _build

        lib = _build.load("dia_pipe")
        lib.acg_dia_pipe.restype = ctypes.c_int
        lib.acg_dia_pipe.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64] + [ctypes.c_void_p] * 9
            + [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p])
        _pipe_lib = lib
    return _pipe_lib


# (device index, stream handle) -> (ticket counter, partials): the
# pipelined kernel's scratch, made once per stream (the counter zeroed
# then; the kernel leaves it at 0), so a call launches nothing else
_pipe_scratch: dict = {}


def _pipe_scratch_for(device: torch.device, stream: int):
    key = (device.index, stream)
    got = _pipe_scratch.get(key)
    if got is None:
        counter = torch.zeros(1, dtype=torch.int32, device=device)
        partials = torch.empty(2 * MAX_BLOCKS, dtype=torch.float64,
                               device=device)
        got = _pipe_scratch[key] = (counter, partials)
    return got


def cg_pipelined_iter(bands, scales, offsets, w, z, r, p, s, x, alpha, beta,
                      w_out=None, fixed: bool = False):
    """One whole pipelined-CG iteration (``cg_pipelined_iter_pallas``):
    q = DIA(bands, offsets) @ w, the 6-vector update and (gamma, delta)
    in one pass.  Returns ``(z', p', s', x', r', w', gamma, delta)``,
    gamma and delta 0-d tensors.

    Operands as :func:`dia_spmv` (``offsets`` the int64 tensor); ``alpha``
    and ``beta`` are 0-d tensors at the vector dtype, read by the kernel
    from device memory.  On a CUDA tensor the kernel updates z, p, s, x
    and r IN PLACE (the returned tensors are those) and writes w' into
    ``w_out`` (allocated when None; it must not share memory with w or
    the other vectors), in one launch.  ``fixed``: launch the kernel with
    the band count fixed (D in ``dia_plan.FIXED_BANDS``, else it raises;
    ``DeviceDia.pipe_fixed`` says when the plan takes it); the same bits
    either way.  CPU tensors take :func:`cg_pipelined_iter_plain`, which
    returns new tensors."""
    global pipe_launches
    if w.device.type == "cpu":
        return cg_pipelined_iter_plain(bands, scales, offsets.tolist(), w, z,
                                       r, p, s, x, alpha, beta)
    if w.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"cg_pipelined_iter: no kernel for device {w.device}")
    if w_out is None:
        w_out = torch.empty_like(w)
    check_pipe_operands("cg_pipelined_iter", w, z, r, p, s, x, alpha, beta,
                        w_out)
    _check(bands, scales, offsets, w, name="cg_pipelined_iter")
    lib = _load_pipe()
    n = w.shape[0]
    nblocks = grid_blocks(n)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    counter, partials = _pipe_scratch_for(w.device, stream)
    gd = torch.empty(2, dtype=w.dtype, device=w.device)
    with kernel_device(w):
        rc = lib.acg_dia_pipe(
            bands.data_ptr(), _BAND_CODES[bands.dtype],
            scales.data_ptr() if scales is not None else None,
            offsets.data_ptr(), bands.shape[0], alpha.data_ptr(),
            beta.data_ptr(), w.data_ptr(), w_out.data_ptr(), z.data_ptr(),
            r.data_ptr(), p.data_ptr(), s.data_ptr(), x.data_ptr(),
            _VEC_CODES[w.dtype], n, int(fixed), partials.data_ptr(), nblocks,
            counter.data_ptr(), gd.data_ptr(), stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"cg_pipelined_iter: kernel launch failed (CUDA error "
                       f"{rc}{', fixed band count' if fixed else ''})")
    pipe_launches += 1
    return z, p, s, x, r, w_out, gd[0], gd[1]


# ---------------------------------------------------------------------------
# the HBM tier: x staged through shared memory (a ring, or windows)


def _check_plan(plan, kind: str, x: torch.Tensor, name: str):
    if plan is None or plan.kind != kind:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"{name}: needs a plan of kind {kind!r} "
                       "(acg_torch.ops.dia_plan.make_plan)")
    if plan.ntiles != -(-x.shape[-1] // plan.tile):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"{name}: the plan is for {plan.ntiles} tiles of "
                       f"{plan.tile}, the vector has {x.shape[-1]} rows")


def _tile_rows(plan, t: torch.Tensor, n: int):
    """(rows of tiles ``t``, the same clamped to the vector): (k, T)."""
    rows = t[:, None] * plan.tile + torch.arange(plan.tile, device=t.device)
    return rows, rows.clamp(max=n - 1)


def _band(bands, scales, d: int, rows, dtype):
    """Band d at ``rows``, at the vector dtype, as :func:`dia_matvec`
    makes it."""
    b = bands[d][rows].to(dtype)
    if scales is not None:
        b = b * scales[d].to(dtype)
    return b


def _ring_geometry(bands, offsets, x, plan):
    """The ring kernel's split of every block's run (``run_bounds``) into
    row tiles summed straight from device memory and its bulk-copied
    middle ``[c0, c1)``: the row tiles that are whole, whose span lies
    inside the vector and whose rows keep every band inside it, when x
    and the band rows are 16-byte aligned (``dia_hbm_ring.cu``).
    Returns ``(t0, t1, c0, c1)``, tensors of one entry a block."""
    n, T, nt, nb = x.shape[-1], plan.tile, plan.ntiles, plan.nblocks
    hi = plan.hi
    live = all(abs(o) < n for o in offsets)
    omin, omax = min(0, *offsets), max(0, *offsets)
    in0, in1 = -(-(-omin) // T), (n - omax) // T
    if not live or in1 < in0:
        in0 = in1 = 0
    bulk = (x.data_ptr() % 16 == 0 and bands.data_ptr() % 16 == 0
            and n * bands.element_size() % 16 == 0)
    t0, t1 = run_bounds(torch.arange(nb, device=x.device), nb, nt)
    c0 = torch.minimum(torch.maximum(t0.new_tensor(max(-plan.lo, in0)), t0),
                       t1)
    c1 = torch.minimum(torch.maximum(t0.new_tensor(min(n // T - hi, in1)),
                                     c0), t1)
    return t0, t1, c0, (c1 if bulk else c0)


def dia_matvec_ring_plain(bands: torch.Tensor, offsets, x: torch.Tensor,
                          scales: torch.Tensor | None, plan):
    """y = DIA(bands, offsets) @ x read through the ring kernel's
    geometry, the plain PyTorch version of :func:`dia_spmv_ring`.  Every
    block of the persistent grid walks its run of row tiles
    (``dia_plan.run_bounds``); the tiles outside its bulk-copied middle
    read x straight (:func:`_ring_geometry`), the middle reads it
    through a ring of ``hi - lo + stages`` x tiles, x tile k of the
    middle (counted from the first tile's span) in slot ``k mod slots``.
    The blocks advance together, one row tile each per step, and the
    ring is filled as the kernel's producer may have filled it at the
    latest: ``stages`` row tiles ahead, each with its span.  A row reads
    only the x tiles its row tile waits for (its span); a position whose
    slot holds another tile, because the plan's span or slots are too
    few, reads NaN.  A row sums its bands as :func:`dia_matvec` does, so
    y has its bits."""
    n, T, nt, nb = x.shape[-1], plan.tile, plan.ntiles, plan.nblocks
    offs = [int(o) for o in offsets]
    span = plan.hi - plan.lo + 1
    slots = span + plan.stages - 1
    ring_len = slots * T
    dev, dt = x.device, x.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    nan = torch.full((), float("nan"), dtype=dt, device=dev)
    t0, t1, c0, c1 = _ring_geometry(bands, offs, x, plan)
    y = torch.zeros(nt * T, dtype=dt, device=dev)
    # the rows summed straight from device memory
    tiles = torch.arange(nt, device=dev)
    owner = torch.searchsorted(t1, tiles, right=True)
    direct = (tiles < c0[owner]) | (tiles >= c1[owner])
    rows = (tiles[direct][:, None] * T
            + torch.arange(T, device=dev)).reshape(-1)
    rows = rows[rows < n]
    acc = torch.zeros(rows.shape, dtype=dt, device=dev)
    for d, off in enumerate(offs):
        j = rows + off
        valid = (j >= 0) & (j < n)
        xd = torch.where(valid, x[j.clamp(0, n - 1)], zero)
        acc = acc + _band(bands, scales, d, rows, dt) * xd
    y[rows] = acc
    # the bulk-copied middles, through the ring
    npipe = c1 - c0
    ring = torch.zeros(nb, ring_len, dtype=dt, device=dev)
    held = torch.full((nb, slots), -1, dtype=torch.int64, device=dev)
    filled = torch.zeros(nb, dtype=torch.int64, device=dev)
    xt = torch.zeros(nt * T, dtype=dt, device=dev)
    xt[:n] = x
    xt = xt.view(nt, T)
    first = c0 + plan.lo                     # the first x tile of a middle
    r = torch.arange(T, device=dev)
    for i in range(int(npipe.max())):
        # the producer at its furthest: row tile i + stages - 1's span
        last = torch.clamp(npipe - 1, max=i + plan.stages - 1)
        want = torch.where(npipe > 0, last + span, 0)
        while True:
            who = (filled < want).nonzero().squeeze(1)
            if who.numel() == 0:
                break
            k = filled[who]
            ring.view(nb, slots, T)[who, k % slots] = xt[first[who] + k]
            held[who, k % slots] = k
            filled[who] += 1
        who = (npipe > i).nonzero().squeeze(1)
        rw, hw = ring[who], held[who]
        rows = (c0[who, None] + i) * T + r
        acc = torch.zeros(rows.shape, dtype=dt, device=dev)
        for d, off in enumerate(offs):
            p = (i % slots) * T + off - plan.lo * T + r
            p = torch.where(p >= ring_len, p - ring_len, p)
            tile_of = hw[:, p // T]
            ok = (tile_of >= i) & (tile_of < i + span)
            xd = torch.where(ok, rw[:, p], nan)
            acc = acc + _band(bands, scales, d, rows, dt) * xd
        y[rows.reshape(-1)] = acc.reshape(-1)
    return y[:n]


def _window_table(plan):
    """The windows plan's table as ((lo, length) per cluster, cluster per
    band)."""
    tab = plan.table.tolist()
    c = plan.nclusters
    return ([(tab[3 * k], tab[3 * k + 1]) for k in range(c)], tab[3 * c:])


def dia_matvec_windows_plain(bands: torch.Tensor, offsets, x: torch.Tensor,
                             scales: torch.Tensor | None, plan,
                             chunk: int = 1024):
    """y = DIA(bands, offsets) @ x read through the windows kernel's
    geometry, the plain PyTorch version of :func:`dia_spmv_windows`: each
    tile's rows are built from its clusters' windows alone, each window
    the zero-filled slice of x the kernel stages (starting at the
    cluster's lowest offset less the kernel's 16-byte alignment shift,
    for x's own address), and each band a static slice of its cluster's
    window.  Tiles go ``chunk`` at a time.  A row sums its bands as
    :func:`dia_matvec` does, so y has its bits."""
    n, T, nt = x.shape[-1], plan.tile, plan.ntiles
    dev, dt = x.device, x.dtype
    zero = torch.zeros((), dtype=dt, device=dev)
    ve = 16 // x.element_size()
    mis = x.data_ptr() % 16 // x.element_size()
    clusters, member = _window_table(plan)
    shifts = [(lo + mis) % ve for lo, _ in clusters]
    offs = [int(o) for o in offsets]
    y = torch.zeros(nt * T, dtype=dt, device=dev)
    for c0 in range(0, nt, chunk):
        ts = torch.arange(c0, min(nt, c0 + chunk), device=dev)
        wins = []
        for (lo, length), sh in zip(clusters, shifts):
            idx = ((ts * T + lo - sh)[:, None]
                   + torch.arange(length, device=dev))
            valid = (idx >= 0) & (idx < n)
            wins.append(torch.where(valid, x[idx.clamp(0, n - 1)], zero))
        rows, rc = _tile_rows(plan, ts, n)
        acc = torch.zeros(rows.shape, dtype=dt, device=dev)
        for d, off in enumerate(offs):
            c = member[d]
            if c < 0:
                xd = torch.zeros(rows.shape, dtype=dt, device=dev)
            else:
                p = off - clusters[c][0] + shifts[c]
                xd = wins[c][:, p: p + T]
            acc = acc + _band(bands, scales, d, rc, dt) * xd
        y.view(nt, T)[ts] = acc
    return y[:n]


def _load_ring():
    global _ring_lib
    if _ring_lib is None:
        from acg_torch import _build

        lib = _build.load("dia_hbm_ring")
        lib.acg_dia_spmv_ring.restype = ctypes.c_int
        lib.acg_dia_spmv_ring.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _ring_lib = lib
    return _ring_lib


def _load_windows():
    global _windows_lib
    if _windows_lib is None:
        from acg_torch import _build

        lib = _build.load("dia_hbm_windows")
        lib.acg_dia_spmv_windows.restype = ctypes.c_int
        lib.acg_dia_spmv_windows.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        _windows_lib = lib
    return _windows_lib


def _dot_buffers(x, nblocks: int, with_dot: bool):
    if not with_dot:
        return None, None
    return (torch.empty(nblocks, dtype=x.dtype, device=x.device),
            torch.empty((), dtype=x.dtype, device=x.device))


def dia_spmv_ring(bands: torch.Tensor, scales: torch.Tensor | None,
                  offsets: torch.Tensor, x: torch.Tensor, plan,
                  with_dot: bool = False):
    """:func:`dia_spmv` with x streamed once through a shared-memory ring
    (``dia_matvec_pallas_hbm2d_ring``), by the geometry of ``plan`` (an
    ``HbmPlan`` of kind "hbm-ring", ``dia_plan.make_plan``).  Operands,
    results and bits of y as :func:`dia_spmv`; the dot sums per-block
    partials in a fixed order.  CUDA tensors launch the kernel
    (``acg_torch/csrc/dia_hbm_ring.cu``); CPU tensors take
    :func:`dia_matvec_ring_plain`."""
    global ring_launches
    _check_plan(plan, "hbm-ring", x, "dia_spmv_ring")
    if x.device.type == "cpu":
        y = dia_matvec_ring_plain(bands, offsets.tolist(), x, scales, plan)
        return (y, torch.dot(x, y)) if with_dot else y
    if x.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"dia_spmv_ring: no kernel for device {x.device}")
    _check(bands, scales, offsets, x, name="dia_spmv_ring")
    lib = _load_ring()
    y = torch.empty_like(x)
    partials, dot = _dot_buffers(x, plan.nblocks, with_dot)
    with kernel_device(x):
        rc = lib.acg_dia_spmv_ring(
            bands.data_ptr(), _BAND_CODES[bands.dtype],
            scales.data_ptr() if scales is not None else None,
            offsets.data_ptr(), bands.shape[0], x.data_ptr(), y.data_ptr(),
            _VEC_CODES[x.dtype], x.shape[0], plan.tile, plan.lo,
            plan.hi - plan.lo + 1, plan.stages, plan.ntiles, plan.smem,
            plan.nblocks,
            partials.data_ptr() if with_dot else None,
            dot.data_ptr() if with_dot else None,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"dia_spmv_ring: kernel launch failed (CUDA error "
                       f"{rc})")
    ring_launches += 1
    return (y, dot) if with_dot else y


def dia_spmv_windows(bands: torch.Tensor, scales: torch.Tensor | None,
                     offsets: torch.Tensor, x: torch.Tensor, plan,
                     with_dot: bool = False):
    """:func:`dia_spmv` with x staged through one shared-memory window
    per offset cluster (``dia_matvec_pallas_hbm2d``), by the geometry of
    ``plan`` (an ``HbmPlan`` of kind "hbm", ``dia_plan.make_plan``, its
    table on x's device).  Operands, results and bits of y as
    :func:`dia_spmv`; the dot sums per-block partials in a fixed order.
    CUDA tensors launch the kernel (``acg_torch/csrc/dia_hbm_windows.cu``);
    CPU tensors take :func:`dia_matvec_windows_plain`."""
    global windows_launches
    _check_plan(plan, "hbm", x, "dia_spmv_windows")
    if x.device.type == "cpu":
        y = dia_matvec_windows_plain(bands, offsets.tolist(), x, scales,
                                     plan)
        return (y, torch.dot(x, y)) if with_dot else y
    if x.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"dia_spmv_windows: no kernel for device {x.device}")
    _check(bands, scales, offsets, x, name="dia_spmv_windows")
    if (plan.table.device != x.device or plan.table.dtype != torch.int64
            or plan.table.numel() != 3 * plan.nclusters + bands.shape[0]):
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "dia_spmv_windows: the plan's table must be an int64 "
                       "tensor on the vector's device, 3 per cluster and "
                       "one per band")
    lib = _load_windows()
    y = torch.empty_like(x)
    partials, dot = _dot_buffers(x, plan.nblocks, with_dot)
    with kernel_device(x):
        rc = lib.acg_dia_spmv_windows(
            bands.data_ptr(), _BAND_CODES[bands.dtype],
            scales.data_ptr() if scales is not None else None,
            offsets.data_ptr(), bands.shape[0], x.data_ptr(), y.data_ptr(),
            _VEC_CODES[x.dtype], x.shape[0], plan.tile, plan.table.data_ptr(),
            plan.nclusters, plan.buflen, plan.ntiles,
            x.data_ptr() % 16 // x.element_size(), plan.stages, plan.smem,
            plan.nblocks,
            partials.data_ptr() if with_dot else None,
            dot.data_ptr() if with_dot else None,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"dia_spmv_windows: kernel launch failed (CUDA error "
                       f"{rc})")
    windows_launches += 1
    return (y, dot) if with_dot else y
