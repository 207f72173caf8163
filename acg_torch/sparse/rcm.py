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


# a BFS level of at least this many nodes is expanded with array
# operations, a smaller one node by node: the two give the same order
# (a level's nodes take their unvisited neighbours in turn), and on a
# mesh of a million rows the arrays take the levels of thousands of
# nodes in milliseconds, where the node-by-node loop takes seconds
_LEVEL_VECTOR = 32


def _row_ranges(A: CsrMatrix, nodes: np.ndarray):
    """(the concatenated column indices of ``nodes``' rows, in node order
    then row order; the position in ``nodes`` of each entry's row)."""
    starts = A.rowptr[nodes]
    lens = A.rowptr[nodes + 1] - starts
    total = int(lens.sum())
    grp = np.repeat(np.arange(len(nodes)), lens)
    first = np.cumsum(lens) - lens
    idx = starts[grp] + (np.arange(total) - first[grp])
    return A.colidx[idx].astype(np.int64), grp


def _first_unseen(cols: np.ndarray, grp: np.ndarray, blocked: np.ndarray):
    """The entries whose column is not ``blocked``, each column once, at
    its first entry (the one a node-by-node pass would take): (columns,
    their rows' positions), in entry order."""
    keep = ~blocked[cols]
    cols, grp = cols[keep], grp[keep]
    _, first = np.unique(cols, return_index=True)
    first.sort()
    return cols[first], grp[first]


def _peripheral(A: CsrMatrix, start: int, visited: np.ndarray,
                seen: np.ndarray, deg: np.ndarray) -> int:
    """One BFS sweep of ``start``'s component (``visited`` nodes excluded)
    to its last level's lowest-degree node, the first such in discovery
    order.  ``seen`` is all False on entry and on return."""
    rowptr, colidx = A.rowptr, A.colidx
    seen[start] = True
    small, large = [start], []          # what to clear from ``seen``
    frontier = [start]
    last = int(start)
    while len(frontier):
        if len(frontier) >= _LEVEL_VECTOR:
            cols, grp = _row_ranges(A, np.asarray(frontier, dtype=np.int64))
            nxt, _ = _first_unseen(cols, grp, seen | visited)
            seen[nxt] = True
            large.append(nxt)
            if len(nxt):
                last = int(nxt[np.argmin(deg[nxt])])
        else:
            nxt = []
            for u in frontier:
                for v in colidx[rowptr[u]: rowptr[u + 1]]:
                    v = int(v)
                    if not seen[v] and not visited[v]:
                        seen[v] = True
                        nxt.append(v)
            small.extend(nxt)
            if nxt:
                last = min(nxt, key=lambda u: int(deg[u]))
        frontier = nxt
    seen[small] = False
    for t in large:
        seen[t] = False
    return last


def rcm_order(A: CsrMatrix, seed: int = 0) -> np.ndarray:
    """Permutation ``perm`` such that A[perm][:, perm] has small bandwidth.

    Classic RCM: BFS from a pseudo-peripheral node, visiting neighbours in
    increasing-degree order, then reverse.  Returns the old index of each
    new position (``new_to_old``).  A BFS level of ``_LEVEL_VECTOR`` nodes
    or more is expanded with array operations, in the same order."""
    n = A.nrows
    deg = A.rowlens
    visited = np.zeros(n, dtype=bool)
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # component starts: a cursor over the (degree asc, id asc) order is the
    # lowest-degree unvisited node with the smallest id, O(n) amortized
    # over all components
    bydeg = np.argsort(deg, kind="stable")
    cursor = 0
    maxdeg = int(deg.max()) + 1 if n else 1
    while pos < n:
        # the next component's start, then one BFS to a peripheral node
        while cursor < n and visited[bydeg[cursor]]:
            cursor += 1
        start = int(bydeg[cursor])
        for _ in range(2):
            start = _peripheral(A, start, visited, seen, deg)
        # the RCM BFS from the peripheral start: each node of a level, in
        # order, takes its unvisited neighbours in increasing degree (ties
        # in row order); a large level all at once, with arrays
        visited[start] = True
        order[pos] = start
        pos += 1
        head = level_end = pos - 1
        while head < pos:
            if head == level_end:
                level_end = pos
                if level_end - head >= _LEVEL_VECTOR:
                    cols, grp = _row_ranges(A, order[head:level_end])
                    nxt, g = _first_unseen(cols, grp, visited)
                    nxt = nxt[np.argsort(g * maxdeg + deg[nxt],
                                         kind="stable")]
                    visited[nxt] = True
                    order[pos: pos + len(nxt)] = nxt
                    pos += len(nxt)
                    head = level_end
                    continue
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
