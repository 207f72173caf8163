"""Solvers: ``acg_torch.solvers.cg`` (classic and pipelined CG on one
device) and ``cg_dist`` (distributed classic CG over shards), with
``loops`` (the iterations) and ``base`` (results and stats).  The
function exports below run after the submodule imports, so
``acg_torch.solvers.cg_dist`` is the function, as in the JAX package."""

from acg_torch.solvers.cg import build_device_operator, cg, cg_pipelined
from acg_torch.solvers.cg_dist import build_sharded, cg_dist

__all__ = ["build_device_operator", "build_sharded", "cg", "cg_dist",
           "cg_pipelined"]
