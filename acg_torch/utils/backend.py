"""Device resolution.

The port's entry points run on the GPU unless the caller asks for the
CPU.  Without a CUDA device the default raises: a solve never moves to
the CPU on its own, so a timing or a kernel launch count always belongs
to the device it names.
"""

from __future__ import annotations

import contextlib

import torch

from acg_torch.errors import AcgError, Status


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``: ``None`` means ``cuda``; ``"cpu"``
    only when asked.  Raises ``AcgError(ERR_NOT_SUPPORTED)`` when a CUDA
    device is requested (or defaulted to) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "no CUDA device available (torch.cuda.is_available() "
                       "is False); pass device='cpu' to run the plain "
                       "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"device {str(dev)!r} is not supported (cuda|cpu)")
    return dev


def kernel_device(t: torch.Tensor):
    """The context in which a hand-written kernel for ``t`` launches:
    ``t``'s card made current.  The CUDA runtime launches a kernel loaded
    through ctypes on the current device, and the handle of a default
    stream (0) names no device, so a shard's kernel on another card would
    otherwise run on the current one, through peer access and unordered
    with the shard's own stream."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
