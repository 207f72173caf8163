"""Solvers: ``acg_torch.solvers.cg`` (classic and pipelined CG on one
device), with ``loops`` (the iterations) and ``base`` (results and
stats)."""

from acg_torch.solvers.cg import build_device_operator, cg, cg_pipelined

__all__ = ["build_device_operator", "cg", "cg_pipelined"]
