"""The classic-CG update with its reduction: x += alpha p, r -= alpha t
and <r, r> (and <p, p> when the diff criteria need it) in one pass.

:func:`cg_update` launches the hand-written kernel of
``acg_torch/csrc/cg_update.cu`` on CUDA tensors and runs
:func:`cg_update_plain` on CPU tensors: two ``addcmul_`` and the dots,
exactly the operations of the classic loop before the kernel existed.
It replaces no TPU kernel: XLA fused these into the JAX package's loop.
There is no fallback between the two: a CUDA call that cannot launch
raises.
"""

from __future__ import annotations

import ctypes

import torch

from acg_torch.errors import AcgError, Status
from acg_torch.ops.blas1 import batched_dot
from acg_torch.utils.backend import kernel_device

# kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0

THREADS = 256          # acg::kThreads in csrc/common.cuh
MAX_BLOCKS = 4096      # grid cap: the dots' partial count, and so their
#                        bits, depend on n alone

_VEC_CODES = {torch.float32: 2, torch.float64: 3}

_lib = None

# (device index, stream handle, systems) -> (ticket counters, partials):
# made once per stream and width (the counters zeroed then; the kernel
# leaves them at 0), so a call launches nothing else
_scratch: dict = {}


def grid_blocks(n: int) -> int:
    """Blocks of one system's grid-stride launch over ``n`` rows."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


def cg_update_plain(x, r, p, t, alpha, want_pp: bool = False):
    """The plain PyTorch version: x += alpha p and r -= alpha t in place
    (``alpha`` 0-d, or (B,) per system of (B, n) vectors), then <r, r>
    per system and, with ``want_pp``, <p, p> (taken before r moves, as
    the classic loop took it).  Returns ``(rr, pp)``, pp None without
    ``want_pp``."""
    a = alpha[:, None] if x.dim() == 2 else alpha
    x.addcmul_(p, a)
    pp = batched_dot(p, p) if want_pp else None
    r.addcmul_(t, a, value=-1)
    return batched_dot(r, r), pp


def _load():
    global _lib
    if _lib is None:
        from acg_torch import _build

        lib = _build.load("cg_update")
        lib.acg_cg_update.restype = ctypes.c_int
        lib.acg_cg_update.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p])
        _lib = lib
    return _lib


def _scratch_for(device: torch.device, stream: int, nsys: int, dtype):
    key = (device.index, stream, nsys, dtype)
    got = _scratch.get(key)
    if got is None:
        counter = torch.zeros(nsys, dtype=torch.int32, device=device)
        partials = torch.empty(2 * nsys * MAX_BLOCKS, dtype=dtype,
                               device=device)
        got = _scratch[key] = (counter, partials)
    return got


def cg_update(x, r, p, t, alpha, want_pp: bool = False):
    """x += alpha p, r -= alpha t, and <r', r'> (with ``want_pp`` also
    <p, p>) per system, in one launch on CUDA tensors.

    ``x``, ``r``, ``p``, ``t``: contiguous (n,) or (B, n) tensors of one
    float dtype (f32 or f64) on one device; ``alpha`` a 0-d tensor, or
    (B,) for (B, n) vectors, at that dtype there.  x and r are updated in
    place.  Returns ``(rr, pp)``: 0-d tensors, or (B,) per system; pp
    None without ``want_pp``.  CPU tensors take :func:`cg_update_plain`;
    a CUDA call with other operands raises."""
    global launches
    if x.device.type == "cpu":
        return cg_update_plain(x, r, p, t, alpha, want_pp)
    if x.device.type != "cuda":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"cg_update: no kernel for device {x.device}")
    nsys = x.shape[0] if x.dim() == 2 else 1
    ok = (x.dtype in _VEC_CODES and x.dim() in (1, 2)
          and all(v.shape == x.shape and v.dtype == x.dtype
                  and v.device == x.device and v.is_contiguous()
                  for v in (x, r, p, t))
          and alpha.dtype == x.dtype and alpha.device == x.device
          and alpha.numel() == nsys and alpha.is_contiguous()
          and alpha.dim() == x.dim() - 1 and 1 <= nsys <= 65535)
    if not ok:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "cg_update: x, r, p, t must be contiguous (n,) or "
                       "(B, n) f32/f64 tensors of one shape, dtype and "
                       "device, alpha 0-d or (B,) at that dtype there")
    spans = sorted((v.data_ptr(), v.data_ptr() + v.numel() * v.element_size())
                   for v in (x, r))
    if spans[0][1] > spans[1][0]:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "cg_update: x and r must not share memory")
    n = x.shape[-1]
    nblocks = grid_blocks(n)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counter, partials = _scratch_for(x.device, stream, nsys, x.dtype)
    out = torch.empty(2 * nsys, dtype=x.dtype, device=x.device)
    with kernel_device(x):
        rc = _load().acg_cg_update(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), t.data_ptr(),
            alpha.data_ptr(), _VEC_CODES[x.dtype], n, nsys, int(want_pp),
            partials.data_ptr(), nblocks, counter.data_ptr(),
            out.data_ptr(), stream)
    if rc != 0:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"cg_update: kernel launch failed (CUDA error {rc})")
    launches += 1
    pair = out.view(nsys, 2)
    if x.dim() == 1:
        return pair[0, 0], (pair[0, 1] if want_pp else None)
    return pair[:, 0], (pair[:, 1] if want_pp else None)
