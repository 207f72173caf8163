"""Solvers: ``acg_torch.solvers.cg`` (classic, pipelined, s-step,
depth-l pipelined and recycled CG on one device), ``cg_dist``
(distributed classic and pipelined CG over shards, and recycled CG on
them), ``cg_host`` and ``baseline`` (the host oracle and the SciPy
baseline), with ``loops`` (the iterations) and ``base`` (results and
stats).  The function exports below run after the submodule imports, so
``acg_torch.solvers.cg_dist`` is the function, as in the JAX package."""

from acg_torch.solvers.baseline import cg_scipy
from acg_torch.solvers.cg import (build_device_operator, cg, cg_pipelined,
                                  cg_pipelined_deep, cg_recycled, cg_sstep)
from acg_torch.solvers.cg_dist import (build_sharded, cg_dist,
                                       cg_pipelined_dist, cg_recycled_dist)
from acg_torch.solvers.cg_host import cg_host

__all__ = ["build_device_operator", "build_sharded", "cg", "cg_dist",
           "cg_host", "cg_pipelined", "cg_pipelined_deep",
           "cg_pipelined_dist", "cg_recycled", "cg_recycled_dist",
           "cg_scipy", "cg_sstep"]
