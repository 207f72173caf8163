"""Graph partitioners: the METIS-role component, in NumPy.

The port's copy of ``acg_tpu/partition/partitioner.py`` for the methods
the distributed slice runs (reference acg/metis.c:80-435
``metis_partgraphsym``, whose part-vector contract every method keeps):

- :func:`partition_graph` with ``method="auto"``: a detected stencil grid
  gets exact block partitions (``grid_partition_vector``), other banded
  orderings contiguous slabs (:func:`partition_chunk`), scattered ones
  recursive bisection (:func:`partition_rb`) then boundary refinement
  (:func:`refine_partition`);
- ``"chunk"`` and ``"rb"`` directly.

``"bfs"``, ``"kway"``, ``"multilevel"`` and :func:`nd_order` raise
``ERR_NOT_SUPPORTED`` ("not yet ported").  The BFS is the JAX package's
NumPy fallback (its native library gives the same order), so part
vectors equal the JAX package's for the same seed.
"""

from __future__ import annotations

import numpy as np

from acg_torch.errors import AcgError, Status
from acg_torch.sparse.csr import CsrMatrix


def _csr_edges(A: CsrMatrix, nodes: np.ndarray):
    """All entries of the given rows as (row, col) arrays."""
    lens = A.rowptr[nodes + 1] - A.rowptr[nodes]
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0,
                                                     dtype=A.colidx.dtype)
    flat = np.repeat(A.rowptr[nodes], lens) + (
        np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens))
    return np.repeat(nodes, lens), A.colidx[flat]


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """np.unique of an already sorted array, without the sort."""
    if a.size == 0:
        return a
    return a[np.r_[True, a[1:] != a[:-1]]]


def _neighbors_of(A: CsrMatrix, frontier: np.ndarray) -> np.ndarray:
    """All columns adjacent to the frontier rows."""
    return _csr_edges(A, frontier)[1]


def _bfs_order(A: CsrMatrix, nodes: np.ndarray, seed: int) -> np.ndarray:
    """Breadth-first ordering of ``nodes`` (a subset of rows) from
    ``seed``, level by level with each new level sorted by id, restarting
    from the first unvisited node for disconnected subgraphs."""
    allowed = np.zeros(A.nrows, dtype=bool)
    allowed[nodes] = True
    visited = np.zeros(A.nrows, dtype=bool)
    order = np.empty(len(nodes), dtype=np.int64)
    pos = 0
    frontier = np.array([seed], dtype=np.int64)
    visited[seed] = True
    cursor = 0          # visited only grows, so the restart scan only
    #                     moves forward
    while pos < len(nodes):
        if frontier.size == 0:
            while cursor < len(nodes) and visited[nodes[cursor]]:
                cursor += 1
            frontier = nodes[cursor: cursor + 1]
            visited[frontier] = True
        order[pos: pos + frontier.size] = frontier
        pos += frontier.size
        nbrs = _neighbors_of(A, frontier)
        nbrs = nbrs[allowed[nbrs] & ~visited[nbrs]]
        nbrs = np.unique(nbrs)
        visited[nbrs] = True
        frontier = nbrs
    return order


def _pseudo_peripheral(A: CsrMatrix, nodes: np.ndarray, seed: int) -> int:
    """Two BFS sweeps: the last node a BFS visits is (nearly) peripheral,
    and bisection that starts there keeps the level sets narrow."""
    start = int(nodes[seed % len(nodes)])
    order = _bfs_order(A, nodes, start)
    far = int(order[-1])
    order = _bfs_order(A, nodes, far)
    return int(order[-1])


def partition_rb(A: CsrMatrix, nparts: int, seed: int = 0) -> np.ndarray:
    """Recursive bisection by BFS level sets (METIS-recursive analog)."""
    part = np.zeros(A.nrows, dtype=np.int32)

    def bisect(nodes: np.ndarray, k: int, offset: int):
        if k == 1:
            part[nodes] = offset
            return
        k1 = k // 2
        target = (len(nodes) * k1) // k
        p = _pseudo_peripheral(A, nodes, seed)
        order = _bfs_order(A, nodes, p)
        bisect(np.sort(order[:target]), k1, offset)
        bisect(np.sort(order[target:]), k - k1, offset + k1)

    bisect(np.arange(A.nrows, dtype=np.int64), nparts, 0)
    return part


def detect_grid_stencil(A: CsrMatrix, offsets=None):
    """The row-major grid shape a stencil matrix's diagonal offsets imply,
    or None: {0, ±1} is 1-D, {0, ±1, ±ny} a (n/ny, ny) grid, {0, ±1, ±nz,
    ±ny·nz} an (n/(ny·nz), ny, nz) grid.  ``offsets`` are precomputed
    unique offsets (else one O(nnz) sweep)."""
    if offsets is None:
        r, c, _ = A.to_coo()
        offsets = np.unique(c - r)
    offsets = np.asarray(offsets)
    offs = tuple(int(o) for o in offsets[offsets > 0])
    n = A.nrows
    if offs == (1,):
        return (n,)
    if len(offs) == 2 and offs[0] == 1:
        p = offs[1]
        if p > 1 and n % p == 0:
            return (n // p, p)
    if len(offs) == 3 and offs[0] == 1:
        p, q = offs[1], offs[2]
        if p > 1 and q % p == 0 and q // p > 1 and n % q == 0:
            return (n // q, q // p, p)
    return None


def grid_dims_for_parts(shape, nparts: int, imbalance: float = 1.05):
    """The cut-minimizing factorization of ``nparts`` into per-axis block
    counts, or None when none keeps every axis at most as many blocks as
    points and the largest block within ``imbalance`` of the mean.  Cut
    model: sum over axes of (blocks - 1) · n / points."""
    ndim = len(shape)
    n = 1
    for s in shape:
        n *= s
    best = None
    best_cut = None

    def enum(axis: int, remaining: int, grid: list):
        nonlocal best, best_cut
        if axis == ndim - 1:
            grid = grid + [remaining]
            if any(g > s for g, s in zip(grid, shape)):
                return
            biggest = 1
            for s, g in zip(shape, grid):
                biggest *= -(-s // g)
            if biggest * nparts > imbalance * n:
                return
            cut = sum((g - 1) * (n // s) for g, s in zip(grid, shape))
            if best_cut is None or cut < best_cut:
                best, best_cut = tuple(grid), cut
            return
        d = 1
        while d * d <= remaining:
            if remaining % d == 0:
                enum(axis + 1, remaining // d, grid + [d])
                if d != remaining // d:
                    enum(axis + 1, d, grid + [remaining // d])
            d += 1

    enum(0, nparts, [])
    return best


def partition_chunk(A: CsrMatrix, nparts: int) -> np.ndarray:
    """Contiguous balanced row chunks: rows [i·n/k, (i+1)·n/k) -> part i,
    the slab decomposition that keeps a banded ordering's local blocks
    banded."""
    n = A.nrows
    return ((np.arange(n, dtype=np.int64) * nparts) // n).astype(np.int32)


def refine_partition(A: CsrMatrix, part: np.ndarray, nparts: int,
                     sweeps: int = 2, imbalance: float = 1.05,
                     max_boundary: int = 200_000) -> np.ndarray:
    """Greedy boundary refinement (one-node moves): each sweep moves a
    boundary node to the neighbouring part holding most of its edges when
    that strictly cuts fewer edges and keeps every part inside
    [n/nparts/imbalance, ceil(n/nparts·imbalance)].  Boundaries up to
    ``max_boundary`` nodes take the sequential sweep (moves cascade);
    larger ones the batched sweep (gains on the frozen partition, moves
    applied together, reverted when the cut got worse).  Stops when a
    sweep moves nothing."""
    part = np.asarray(part, dtype=np.int32).copy()
    n = A.nrows
    cap = int(np.ceil(n / nparts * imbalance))
    sizes = np.bincount(part, minlength=nparts)
    floor_ = max(int(n / nparts / imbalance), 1)
    rowids = A._rowids()
    for _ in range(max(sweeps, 1)):
        cross = part[rowids] != part[A.colidx]
        boundary = _sorted_unique(rowids[cross])
        moved = 0
        if boundary.size > max_boundary:
            moved = _refine_sweep_batch(A, part, sizes, boundary, nparts,
                                        cap, floor_,
                                        cut=int(cross.sum()) // 2)
        else:
            for u in boundary:
                nbrs = A.colidx[A.rowptr[u]: A.rowptr[u + 1]]
                nbrs = nbrs[nbrs != u]
                if nbrs.size == 0:
                    continue
                pu = part[u]
                cnt = np.bincount(part[nbrs], minlength=nparts)
                cnt_u = int(cnt[pu])
                cnt[pu] = -1
                q = int(np.argmax(cnt))
                if (cnt[q] > cnt_u and sizes[pu] > floor_
                        and sizes[q] < cap):
                    part[u] = q
                    sizes[pu] -= 1
                    sizes[q] += 1
                    moved += 1
        if moved == 0:
            break
    return part


def _grouped_rank(g: np.ndarray) -> np.ndarray:
    """Rank of each element within its value group, in array order."""
    order = np.argsort(g, kind="stable")
    gs = g[order]
    starts = np.r_[0, np.nonzero(np.diff(gs))[0] + 1]
    group_start = np.repeat(starts, np.diff(np.r_[starts, len(gs)]))
    ranks = np.empty(len(g), dtype=np.int64)
    ranks[order] = np.arange(len(gs)) - group_start
    return ranks


def _refine_sweep_batch(A: CsrMatrix, part: np.ndarray, sizes: np.ndarray,
                        boundary: np.ndarray, nparts: int, cap: int,
                        floor_: int, cut: int) -> int:
    """One batched refinement sweep: per boundary node its edge counts to
    every adjacent part in one groupby, the positive-gain moves (within
    the part-size budgets, best gains first) applied together, and
    reverted when the batch did not lower the edge ``cut``.  Returns the
    moves kept."""
    rows, cols = _csr_edges(A, boundary)
    keep = cols != rows
    rows, cols = rows[keep], cols[keep]
    key = rows.astype(np.int64) * nparts + part[cols]
    uk, counts = np.unique(key, return_counts=True)
    krow = uk // nparts
    kpart = (uk % nparts).astype(np.int32)
    row_starts = np.searchsorted(krow, boundary)
    row_ends = np.searchsorted(krow, boundary, side="right")
    seg = np.repeat(np.arange(len(boundary)), row_ends - row_starts)

    own_cnt = np.zeros(len(boundary), dtype=np.int64)
    own_mask = kpart == part[krow]
    own_cnt[seg[own_mask]] = counts[own_mask]
    foreign = np.where(own_mask, 0, counts)
    best_gain = np.zeros(len(boundary), dtype=np.int64)
    np.maximum.at(best_gain, seg, foreign)
    best_part = np.full(len(boundary), -1, dtype=np.int32)
    is_max = (foreign == best_gain[seg]) & ~own_mask & (foreign > 0)
    # written in reverse, so the first maximum wins
    best_part[seg[is_max][::-1]] = kpart[is_max][::-1]

    gain = best_gain - own_cnt
    cand = (gain > 0) & (best_part >= 0)
    if not cand.any():
        return 0
    nodes = boundary[cand]
    new_part = best_part[cand]
    gorder = np.argsort(-gain[cand], kind="stable")
    nodes, new_part = nodes[gorder], new_part[gorder]
    old_part = part[nodes]
    ok = ((_grouped_rank(new_part) < (cap - sizes)[new_part])
          & (_grouped_rank(old_part) < (sizes - floor_)[old_part]))
    if not ok.any():
        return 0
    nodes, new_part, old_part = nodes[ok], new_part[ok], old_part[ok]
    sizes_before = sizes.copy()
    part[nodes] = new_part
    np.subtract.at(sizes, old_part, 1)
    np.add.at(sizes, new_part, 1)
    if edge_cut(A, part) >= cut:
        part[nodes] = old_part
        sizes[:] = sizes_before
        return 0
    return len(nodes)


def _not_ported(name: str):
    raise AcgError(Status.ERR_NOT_SUPPORTED,
                   f"partition method {name!r}: not yet ported "
                   "(auto, chunk and rb are)")


def nd_order(A: CsrMatrix, cutoff: int = 32, seed: int = 0):
    """Nested-dissection ordering: not yet ported."""
    _not_ported("nd_order")


def partition_graph(A: CsrMatrix, nparts: int, method: str = "auto",
                    seed: int = 0) -> np.ndarray:
    """Partition the adjacency of A into ``nparts`` (the part-vector
    contract of ref acg/metis.c:80 ``metis_partgraphsym``)."""
    if nparts < 1:
        raise AcgError(Status.ERR_INVALID_VALUE, "nparts must be >= 1")
    if nparts == 1:
        return np.zeros(A.nrows, dtype=np.int32)
    if nparts > A.nrows:
        raise AcgError(Status.ERR_PARTITION,
                       f"nparts={nparts} exceeds nrows={A.nrows}")
    if method == "auto":
        # one offsets sweep serves the band test and the grid detection
        from acg_torch.ops.dia import dia_efficiency

        r, c, _ = A.to_coo()
        offs = np.unique(c - r)
        del r, c
        if dia_efficiency(A, offsets=offs) >= 0.25:
            shape = detect_grid_stencil(A, offsets=offs)
            if shape is not None and len(shape) > 1:
                dims = grid_dims_for_parts(shape, nparts)
                if dims is not None:
                    from acg_torch.sparse.poisson import \
                        grid_partition_vector

                    return grid_partition_vector(shape, dims)
            method = "chunk"
        else:
            method = "rb"
    if method == "chunk":
        return partition_chunk(A, nparts)
    if method == "rb":
        return refine_partition(A, partition_rb(A, nparts, seed), nparts)
    if method in ("bfs", "kway", "multilevel", "ml"):
        _not_ported(method)
    raise AcgError(Status.ERR_INVALID_VALUE,
                   f"unknown partition method {method!r}")


def edge_cut(A: CsrMatrix, part: np.ndarray) -> int:
    """Number of cut edges (the METIS objval analog)."""
    cross = part[A._rowids()] != part[A.colidx]
    return int(cross.sum()) // 2
