"""The device list a distributed solve runs on.

The port of ``acg_tpu/parallel/mesh.py``.  The reference binds one MPI
rank to one GPU (cuda/acg-cuda.c:1014-1041); the JAX package builds a
1-D mesh over its chips.  Here a mesh is the tuple of devices that hold
the shards: shard p lives on ``devices[p]``.  A device may
appear more than once, so several shards can share one card (or the
CPU): the oversubscribed layout the JAX package tests with
``--xla_force_host_platform_device_count`` and the reference with
``mpirun -np N`` on one GPU.
"""

from __future__ import annotations

import torch

from acg_torch.errors import AcgError, Status


def make_mesh(nparts: int, devices=None) -> tuple:
    """The devices of ``nparts`` shards, a tuple of ``torch.device``.
    ``devices=None`` takes the visible CUDA devices in order and raises
    ``ERR_MESH`` when there are fewer than ``nparts`` (the JAX package's
    contract; with no CUDA device at all, ``ERR_NOT_SUPPORTED`` as for
    every entry point of the port).  An explicit list (``["cuda:0"] *
    4``, ``["cpu"] * 2``) gives each shard its device; it must hold
    ``nparts`` entries."""
    from acg_torch.utils.backend import resolve_device

    if nparts < 1:
        raise AcgError(Status.ERR_INVALID_VALUE, "nparts must be >= 1")
    if devices is None:
        resolve_device("cuda")
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if nparts > len(visible):
            raise AcgError(
                Status.ERR_MESH,
                f"need {nparts} devices for {nparts} parts, have "
                f"{len(visible)} (an explicit device list may repeat a "
                "device)")
        return tuple(visible[:nparts])
    devs = [resolve_device(d) for d in devices]
    if len(devs) != nparts:
        raise AcgError(Status.ERR_MESH,
                       f"need {nparts} devices for {nparts} parts, the "
                       f"device list has {len(devs)}")
    # "cuda" means the current card: pin its index, so equal devices
    # compare equal
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    return tuple(devs)
