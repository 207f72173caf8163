"""Reverse Cuthill-McKee bandwidth reduction.

The port's copy of ``acg_tpu/sparse/rcm.py``, its NumPy versions (the
JAX package's native versions give the same permutation and the same
matrix).  A matrix that arrives in an arbitrary ordering has no band
structure; RCM reorders it so that neighbours sit close together, which
either recovers a band (the DIA tier) or makes each 128-row window touch
few 128-column x segments (the sgell pack).  A host pass before the
solve, like the reference's graph reorderings (acg/metis.c:546,839).
"""

from __future__ import annotations

import numpy as np

from acg_torch.sparse.csr import CsrMatrix, coo_to_csr


def rcm_order(A: CsrMatrix, seed: int = 0) -> np.ndarray:
    """Permutation ``perm`` such that A[perm][:, perm] has small bandwidth.

    Classic RCM: BFS from a pseudo-peripheral node, visiting neighbours in
    increasing-degree order, then reverse.  Returns the old index of each
    new position (``new_to_old``).
    """
    n = A.nrows
    deg = A.rowlens
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # component starts: a cursor over the (degree asc, id asc) order is the
    # lowest-degree unvisited node with the smallest id, O(n) amortized
    # over all components
    bydeg = np.argsort(deg, kind="stable")
    cursor = 0
    while pos < n:
        # the next component's start, then one BFS to a peripheral node
        while cursor < n and visited[bydeg[cursor]]:
            cursor += 1
        start = int(bydeg[cursor])
        for _ in range(2):
            comp_seen = {int(start)}
            frontier = [int(start)]
            last = int(start)
            while frontier:
                nxt = []
                for u in frontier:
                    for v in A.colidx[A.rowptr[u]: A.rowptr[u + 1]]:
                        v = int(v)
                        if v not in comp_seen and not visited[v]:
                            comp_seen.add(v)
                            nxt.append(v)
                if nxt:
                    last = min(nxt, key=lambda u: int(deg[u]))
                frontier = nxt
            start = last
        # the RCM BFS from the peripheral start
        visited[start] = True
        order[pos] = start
        pos += 1
        head = pos - 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = A.colidx[A.rowptr[u]: A.rowptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            for v in nbrs:
                if not visited[v]:
                    visited[v] = True
                    order[pos] = v
                    pos += 1
    return order[::-1].copy()


def permute_symmetric(A: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """P A P' where ``perm`` is new_to_old: new row i is old row
    perm[i], with its columns renumbered and sorted."""
    old_to_new = np.empty_like(perm)
    old_to_new[perm] = np.arange(len(perm))
    r, c, v = A.to_coo()
    return coo_to_csr(old_to_new[r], old_to_new[c], v, A.nrows, A.ncols)


def bandwidth(A: CsrMatrix) -> int:
    r, c, _ = A.to_coo()
    return int(np.abs(r - c).max()) if A.nnz else 0
