"""Solvers: ``acg_torch.solvers.cg`` (classic CG on one device), with
``loops`` (the iteration) and ``base`` (results and stats)."""
