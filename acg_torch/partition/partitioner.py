"""Graph partitioners: the METIS-role component, in NumPy.

The port's copy of ``acg_tpu/partition/partitioner.py`` (reference
acg/metis.c:80-435 ``metis_partgraphsym``, whose part-vector contract
every method keeps):

- :func:`partition_graph` with ``method="auto"``: a detected stencil grid
  gets exact block partitions (``grid_partition_vector``), other banded
  orderings contiguous slabs (:func:`partition_chunk`), scattered ones
  recursive bisection (:func:`partition_rb`) then boundary refinement
  (:func:`refine_partition`);
- ``"chunk"``, ``"rb"``, ``"bfs"`` (greedy BFS growing,
  :func:`partition_bfs`), ``"kway"`` (k seeds grown together,
  :func:`partition_kway`) and ``"multilevel"`` / ``"ml"`` (the METIS
  V-cycle: heavy-edge matching, contraction, a weighted bisection of the
  coarsest graph, refinement at every level,
  :func:`partition_multilevel`);
- :func:`nd_order`, the nested-dissection ordering.

These are the JAX package's NumPy paths.  Its native host library
(``acg_tpu/native.py``) computes the same part vectors bit for bit, so
part vectors equal the JAX package's for the same seed; the port's own
host library is still to come.
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


def partition_bfs(A: CsrMatrix, nparts: int, seed: int = 0) -> np.ndarray:
    """Greedy BFS growing: n/k nodes at a time in the BFS order from a
    pseudo-peripheral node."""
    nodes = np.arange(A.nrows, dtype=np.int64)
    p = _pseudo_peripheral(A, nodes, seed)
    order = _bfs_order(A, nodes, p)
    part = np.zeros(A.nrows, dtype=np.int32)
    bounds = (np.arange(1, nparts) * A.nrows) // nparts
    for i, chunk in enumerate(np.split(order, bounds)):
        part[chunk] = i
    return part


def partition_kway(A: CsrMatrix, nparts: int, seed: int = 0) -> np.ndarray:
    """Direct k-way partitioning (the METIS_PartGraphKway analog, ref
    acg/metis.h:39): k seeds spread along a global BFS order grow
    together, the smallest part claiming its next BFS layer each round,
    under a hard cap of ceil(n/k) a part; a part whose frontier dies
    restarts from the next unassigned node of the global order."""
    n = A.nrows
    part = np.full(n, -1, dtype=np.int32)
    cap = -(-n // nparts)
    p0 = _pseudo_peripheral(A, np.arange(n, dtype=np.int64), seed)
    order = _bfs_order(A, np.arange(n, dtype=np.int64), p0)
    seeds = order[(np.arange(nparts) * n) // nparts + n // (2 * nparts)]
    sizes = np.zeros(nparts, dtype=np.int64)
    frontiers: list = []
    for i, s in enumerate(seeds):
        if part[s] < 0:
            part[s] = i
            sizes[i] = 1
            frontiers.append(np.array([s], dtype=np.int64))
        else:           # a duplicate seed (tiny graph): empty frontier
            frontiers.append(np.empty(0, dtype=np.int64))
    nassigned = int((part >= 0).sum())
    cursor = 0          # the restart scan walks the global order once

    def next_unassigned() -> int:
        nonlocal cursor
        while cursor < n and part[order[cursor]] >= 0:
            cursor += 1
        return int(order[cursor]) if cursor < n else -1

    while nassigned < n:
        grew = False
        for i in np.argsort(sizes, kind="stable"):
            if sizes[i] >= cap:
                continue
            f = frontiers[i]
            if f.size == 0:
                s = next_unassigned()
                if s < 0:
                    break
                f = np.array([s], dtype=np.int64)
                part[s] = i
                sizes[i] += 1
                nassigned += 1
            nbrs = np.unique(_neighbors_of(A, f))
            nbrs = nbrs[part[nbrs] < 0]
            nbrs = nbrs[: cap - sizes[i]]
            part[nbrs] = i
            sizes[i] += len(nbrs)
            nassigned += len(nbrs)
            frontiers[i] = nbrs
            if len(nbrs) or f.size:
                grew = True
            break
        # cap · nparts >= n: a part below its cap grows or restarts
        assert grew or nassigned >= n, "kway growth stalled"
    return part


def _extract_submatrix(A: CsrMatrix, nodes: np.ndarray,
                       glob2loc: np.ndarray) -> CsrMatrix:
    """The structure of A[nodes][:, nodes], renumbered.  ``glob2loc`` is
    a reusable scratch array of -1s, restored on return."""
    glob2loc[nodes] = np.arange(len(nodes))
    grows, cols = _csr_edges(A, nodes)
    keep = glob2loc[cols] >= 0
    sub_rows, sub_cols = glob2loc[grows[keep]], glob2loc[cols[keep]]
    rowptr = np.zeros(len(nodes) + 1, dtype=A.rowptr.dtype)
    np.add.at(rowptr, sub_rows + 1, 1)
    np.cumsum(rowptr, out=rowptr)
    glob2loc[nodes] = -1
    return CsrMatrix(nrows=len(nodes), ncols=len(nodes), rowptr=rowptr,
                     colidx=sub_cols.astype(A.colidx.dtype),
                     vals=np.ones(len(sub_cols)))


def nd_order(A: CsrMatrix, cutoff: int = 32, seed: int = 0) -> np.ndarray:
    """Nested-dissection ordering (the METIS_NodeND analog, ref
    acg/metis.c:546 ``metis_ndsym``): a permutation ``perm`` with
    ``A[perm][:, perm]`` ordering each half before its vertex separator,
    recursively ([left, right, separator]), each level on an extracted
    renumbered submatrix."""
    out: list = []
    glob2loc = np.full(A.nrows, -1, dtype=np.int64)

    def dissect(S: CsrMatrix, gids: np.ndarray):
        if S.nrows <= cutoff:
            out.append(gids)
            return
        local = np.arange(S.nrows, dtype=np.int64)
        p = _pseudo_peripheral(S, local, seed)
        order = _bfs_order(S, local, p)
        half = len(order) // 2
        left, right = order[:half], order[half:]
        inleft = np.zeros(S.nrows, dtype=bool)
        inleft[left] = True
        # the separator: right-side nodes adjacent to the left side
        sep_mask = np.zeros(S.nrows, dtype=bool)
        nbrs = _neighbors_of(S, np.sort(left))
        sep_mask[nbrs[~inleft[nbrs]]] = True
        sep = right[sep_mask[right]]
        rest = right[~sep_mask[right]]
        if len(sep) == 0 or len(rest) == 0:   # disconnected or degenerate
            out.append(gids)
            return
        left, rest, sep = np.sort(left), np.sort(rest), np.sort(sep)
        dissect(_extract_submatrix(S, left, glob2loc[: S.nrows]), gids[left])
        dissect(_extract_submatrix(S, rest, glob2loc[: S.nrows]), gids[rest])
        out.append(gids[sep])

    dissect(A, np.arange(A.nrows, dtype=np.int64))
    return np.concatenate(out) if out else np.empty(0, dtype=np.int64)


def _hem_match(rowids, cols, w, nw, maxw, rng, rounds: int = 4):
    """Heavy-edge matching: each unmatched node proposes its heaviest
    still-unmatched neighbour, ties broken by a random jitter drawn anew
    every round (a fixed tie order lets proposal cycles persist); mutual
    proposals match.  A pair whose weight would exceed ``maxw`` never
    matches.  The proposal is the per-row lexicographic argmax of
    (weight, jitter, column), one jitter draw a live edge a round."""
    n = len(nw)
    match = np.full(n, -1, dtype=np.int64)
    if 2 * int(nw.max(initial=0)) > maxw:
        capped = nw[rowids] + nw[cols] <= maxw
        rowids, cols, w = rowids[capped], cols[capped], w[capped]
    ar = np.arange(n)
    for _ in range(rounds):
        if len(rowids) == 0:
            break
        jit = rng.integers(0, 1 << 20, len(w), dtype=np.uint32)
        # jitter and column in one int64 (20 + 43 bits): a 3-key sort
        key2 = (jit.astype(np.int64) << np.int64(43)) | cols
        order = np.lexsort((key2, w, rowids))
        r_o = rowids[order]
        last = np.r_[r_o[1:] != r_o[:-1], True]
        prop = np.full(n, -1, dtype=np.int64)
        prop[r_o[last]] = cols[order][last]
        has = prop >= 0
        mutual = has & (prop[prop] == ar) & (prop != ar)
        lo = ar[mutual & (ar < prop)]
        match[lo] = prop[lo]
        match[prop[lo]] = lo
        # the edges still live for the next round, order kept
        un = match < 0
        live = un[rowids] & un[cols]
        if not live.any():
            break
        rowids, cols, w = rowids[live], cols[live], w[live]
    return match


def _contract(rowids, cols, w, nw, match):
    """Contract the matched pairs: (rowids', cols', w', nw', cmap), the
    coarse edges (row, col)-sorted with their weights summed edge by
    edge in order, the coarse node weights, and each fine node's coarse
    id."""
    n = len(nw)
    ar = np.arange(n)
    rep = np.where(match >= 0, np.minimum(ar, match), ar)
    is_rep = rep == ar
    cmap = (np.cumsum(is_rep) - 1)[rep]
    nc = int(is_rep.sum())
    cnw = np.zeros(nc, dtype=nw.dtype)
    np.add.at(cnw, cmap, nw)
    cr, cc = cmap[rowids], cmap[cols]
    keep = cr != cc
    cr, cc, cw = cr[keep], cc[keep], w[keep]
    key = cr * np.int64(nc) + cc
    if len(key) == 0:
        # a perfect matching of disjoint edge pairs leaves no edge
        empty = np.empty(0, dtype=np.int64)
        return empty, empty, cw, cnw, cmap
    order = np.argsort(key, kind="stable")
    key, cw = key[order], cw[order]
    newk = np.r_[True, key[1:] != key[:-1]]
    # unbuffered sequential sums (reduceat's pairwise tree rounds
    # differently on long runs)
    seg = np.cumsum(newk) - 1
    agg = np.zeros(int(seg[-1]) + 1, dtype=cw.dtype)
    np.add.at(agg, seg, cw)
    return key[newk] // nc, key[newk] % nc, agg, cnw, cmap


def _level_adj(rowids, cols, w, n):
    """The CSR-sliced adjacency (ptr, cols, w) of a level's edge list,
    sorting it by row only when it is not already."""
    if rowids.size == 0 or np.all(rowids[1:] >= rowids[:-1]):
        ptr = np.searchsorted(rowids, np.arange(n + 1))
        return ptr, cols, w
    order = np.argsort(rowids, kind="stable")
    r, c, ww = rowids[order], cols[order], w[order]
    ptr = np.searchsorted(r, np.arange(n + 1))
    return ptr, c, ww


def _refine_weighted(rowids, cols, w, nw, part, nparts, cap,
                     sweeps: int = 4, max_boundary: int = 30_000):
    """Edge- and node-weighted boundary refinement for the coarse levels
    of the V-cycle: sequential cascading moves to the neighbouring part
    with the heaviest edges (first maximum wins) within ``cap``, on at
    most ``max_boundary`` boundary nodes a sweep (a random subset beyond
    that), then a balance pass moving boundary nodes out of parts over
    ``cap``."""
    n = len(nw)
    rng = np.random.default_rng(0)
    ptr, adj_c, adj_w = _level_adj(rowids, cols, w, n)
    nw = np.ascontiguousarray(nw, dtype=np.int64)
    part = np.ascontiguousarray(part, dtype=np.int32)
    sizes = np.zeros(nparts, dtype=np.int64)
    np.add.at(sizes, part, nw)

    def _sweep(boundary, mode: int) -> int:
        moved = 0
        for u in boundary:
            pu = part[u]
            if mode == 1 and sizes[pu] <= cap:
                continue
            lo, hi = ptr[u], ptr[u + 1]
            cnt = np.zeros(nparts)
            np.add.at(cnt, part[adj_c[lo:hi]], adj_w[lo:hi])
            here = cnt[pu]
            cnt[pu] = -1
            if mode == 1:
                ok = sizes + nw[u] <= cap
                ok[pu] = False
                if not ok.any():
                    continue
                cnt[~ok] = -1
            q = int(np.argmax(cnt))
            if mode == 1:
                if cnt[q] < 0:
                    continue
            elif not (cnt[q] > here and sizes[q] + nw[u] <= cap):
                continue
            part[u] = q
            sizes[pu] -= nw[u]
            sizes[q] += nw[u]
            moved += 1
        return moved

    sorted_rows = bool(rowids.size == 0
                       or np.all(rowids[1:] >= rowids[:-1]))
    uniq = _sorted_unique if sorted_rows else np.unique
    for _ in range(sweeps):
        cross = part[rowids] != part[cols]
        boundary = uniq(rowids[cross])
        if boundary.size > max_boundary:
            boundary = rng.choice(boundary, max_boundary, replace=False)
        if _sweep(boundary, 0) == 0:
            break
    for _ in range(4):
        over = np.flatnonzero(sizes > cap)
        if over.size == 0:
            break
        cross = part[rowids] != part[cols]
        boundary = uniq(rowids[cross])
        boundary = boundary[np.isin(part[boundary], over)]
        if boundary.size > max_boundary:
            boundary = rng.choice(boundary, max_boundary, replace=False)
        if _sweep(boundary, 1) == 0:
            break
    return part


def _fm_refine(A: CsrMatrix, part: np.ndarray, nparts: int,
               sweeps: int = 4, imbalance: float = 1.05,
               max_boundary: int = 150_000,
               max_moves: int = 4000) -> np.ndarray:
    """Fiduccia-Mattheyses-style k-way hill-climbing on unit weights (the
    V-cycle's finest level): moves of negative gain are allowed from a
    lazy max-heap of gains, and the move trail is rolled back to the
    best cut seen, which straightens a boundary that one-node positive
    moves cannot."""
    import heapq

    n = A.nrows
    ptr, adj = A.rowptr, A.colidx
    cap = int(np.ceil(n / nparts * imbalance))
    floor_ = max(int(n / nparts / imbalance), 1)
    part = np.asarray(part, dtype=np.int32).copy()
    NEG = np.int64(-1 << 40)
    rowids = A._rowids()
    for _ in range(max(sweeps, 1)):
        cross = part[rowids] != part[adj]
        cut = int(cross.sum()) // 2
        boundary = _sorted_unique(rowids[cross])
        if boundary.size == 0 or boundary.size > max_boundary:
            break
        gain = np.full(n, NEG, dtype=np.int64)
        best_q = np.zeros(n, dtype=np.int32)

        def recompute(u):
            nb = adj[ptr[u]: ptr[u + 1]]
            nb = nb[nb != u]
            if nb.size == 0:
                gain[u] = NEG
                return
            pu = part[u]
            cnt = np.bincount(part[nb], minlength=nparts)
            here = cnt[pu]
            cnt[pu] = -1
            q = int(np.argmax(cnt))
            gain[u] = cnt[q] - here
            best_q[u] = q

        # the whole boundary's gains at once: (node, neighbour part)
        # histograms of its adjacency, then a row-wise argmax
        B = boundary.size
        lens = (ptr[boundary + 1] - ptr[boundary]).astype(np.int64)
        tot = int(lens.sum())
        starts = ptr[boundary].astype(np.int64)
        flat = (np.repeat(starts - np.r_[0, np.cumsum(lens)[:-1]], lens)
                + np.arange(tot))
        nb_all = adj[flat]
        bidx = np.repeat(np.arange(B, dtype=np.int64), lens)
        nonself = nb_all != np.repeat(boundary, lens)
        keys = bidx[nonself] * np.int64(nparts) + part[nb_all[nonself]]
        cnt = np.bincount(keys, minlength=B * nparts).astype(np.int64)
        cnt = cnt.reshape(B, nparts)
        rows = np.arange(B)
        pu_b = part[boundary]
        here = cnt[rows, pu_b].copy()
        cnt[rows, pu_b] = -1
        qb = cnt.argmax(axis=1)
        deg_eff = np.bincount(bidx[nonself], minlength=B)
        gain[boundary] = np.where(deg_eff > 0, cnt[rows, qb] - here, NEG)
        best_q[boundary] = qb.astype(best_q.dtype)
        locked = np.zeros(n, dtype=bool)
        sizes = np.bincount(part, minlength=nparts).astype(np.int64)
        trail = []
        best_at, best_cut, cur = 0, cut, cut
        heap = [(-int(gain[u]), int(u)) for u in boundary if gain[u] > NEG]
        heapq.heapify(heap)
        # pops blocked by balance wait for the one part whose size change
        # can unblock them: a full destination until it shrinks, a source
        # at its floor until it grows
        blocked_dest: dict = {}
        blocked_src: dict = {}
        for _step in range(min(boundary.size, max_moves)):
            u = -1
            while heap:
                negg, v = heapq.heappop(heap)
                if locked[v] or gain[v] != -negg or gain[v] <= NEG:
                    continue                      # stale or dead entry
                if sizes[best_q[v]] >= cap:
                    blocked_dest.setdefault(int(best_q[v]),
                                            []).append((negg, v))
                    continue
                if sizes[part[v]] <= floor_:
                    blocked_src.setdefault(int(part[v]),
                                           []).append((negg, v))
                    continue
                u = v
                break
            if u < 0:
                break
            q, pu = int(best_q[u]), int(part[u])
            cur -= int(gain[u])
            part[u] = q
            sizes[pu] -= 1
            sizes[q] += 1
            locked[u] = True
            trail.append((u, pu))
            for item in blocked_dest.pop(pu, ()):   # pu shrank
                heapq.heappush(heap, item)
            for item in blocked_src.pop(q, ()):     # q grew
                heapq.heappush(heap, item)
            if cur < best_cut:
                best_cut, best_at = cur, len(trail)
            elif cur - best_cut > max(20, cut // 20):
                break               # wandered too far uphill
            for v in adj[ptr[u]: ptr[u + 1]]:
                if v != u and not locked[v]:
                    recompute(int(v))
                    if gain[v] > NEG:
                        heapq.heappush(heap, (-int(gain[v]), int(v)))
        for u, pu in trail[best_at:]:   # roll back past the best point
            part[u] = pu
        if best_cut >= cut:
            break
    return part


def _partition_rb_weighted(Ac: CsrMatrix, nw, nparts: int,
                           seed: int) -> np.ndarray:
    """Recursive bisection by BFS level sets split at the WEIGHT median:
    the V-cycle's coarsest-level partition, whose nodes carry the fine
    nodes they absorbed."""
    part = np.zeros(Ac.nrows, dtype=np.int32)

    def bisect(nodes: np.ndarray, k: int, offset: int):
        if k == 1:
            part[nodes] = offset
            return
        k1 = k // 2
        p = _pseudo_peripheral(Ac, nodes, seed)
        order = _bfs_order(Ac, nodes, p)
        cw = np.cumsum(nw[order])
        target = int(np.searchsorted(cw, cw[-1] * k1 / k)) + 1
        target = min(max(target, 1), len(nodes) - 1)
        bisect(np.sort(order[:target]), k1, offset)
        bisect(np.sort(order[target:]), k - k1, offset + k1)

    bisect(np.arange(Ac.nrows, dtype=np.int64), nparts, 0)
    return part


def partition_multilevel(A: CsrMatrix, nparts: int, seed: int = 0,
                         coarsen_to: int | None = None,
                         best_of: int | None = None) -> np.ndarray:
    """Multilevel k-way partition, the METIS V-cycle (ref
    acg/metis.c:80-435): coarsen by heavy-edge matching down to
    ``coarsen_to`` nodes (default max(5 nparts, 40)), partition the
    coarsest graph by weighted recursive bisection (best of three seeds,
    then weighted refinement), and project back, refining at every level
    (the finest by :func:`refine_partition` and :func:`_fm_refine`).
    ``best_of`` runs the whole V-cycle that many times with derived seeds
    and keeps the lowest cut (default 3 up to 500,000 rows, else 1)."""
    n = A.nrows
    if best_of is None:
        best_of = 3 if n <= 500_000 else 1
    if best_of > 1:
        best_part, best_cut = None, None
        for i in range(best_of):
            p = partition_multilevel(A, nparts, seed=seed + 7 * i,
                                     coarsen_to=coarsen_to, best_of=1)
            c = edge_cut(A, p)
            if best_cut is None or c < best_cut:
                best_part, best_cut = p, c
        return best_part
    rng = np.random.default_rng(seed)
    if coarsen_to is None:
        coarsen_to = max(5 * nparts, 40)
    rowids = np.repeat(np.arange(n, dtype=np.int64), A.rowlens)
    cols = A.colidx.astype(np.int64)
    keep = rowids != cols
    rowids, cols = rowids[keep], cols[keep]
    w = np.ones(len(rowids), dtype=np.float64)
    nw = np.ones(n, dtype=np.int64)
    maxw = max(int(1.5 * n / max(nparts, 1) / 8), 2)
    levels = []           # (rowids, cols, w, nw, cmap) of each level
    cur_n = n
    while cur_n > coarsen_to:
        match = _hem_match(rowids, cols, w, nw, maxw, rng)
        if (match >= 0).sum() < 0.1 * cur_n:      # the matching stalled
            break
        finest = cur_n == n
        cr, cc, cw, cnw, cmap = _contract(rowids, cols, w, nw, match)
        # the finest level refines through A itself and keeps no edges
        levels.append(((None, None, None) if finest
                       else (rowids, cols, w)) + (nw, cmap))
        rowids, cols, w, nw = cr, cc, cw, cnw
        cur_n = len(nw)
    # the coarsest level: a CsrMatrix for the structural partitioners,
    # weight-median splits, best of three seeds, weighted refinement
    order = np.lexsort((cols, rowids))
    cr, cc = rowids[order], cols[order]
    rowptr = np.searchsorted(cr, np.arange(cur_n + 1)).astype(np.int64)
    Ac = CsrMatrix(cur_n, cur_n, rowptr, cc.astype(np.int32),
                   np.ones(len(cc)))
    cap = int(np.ceil(nw.sum() / nparts * 1.05))

    def _cut_w(p):
        return float(w[p[rowids] != p[cols]].sum()) / 2.0

    best = None
    for s in range(3):
        cand = _refine_weighted(
            rowids, cols, w, nw,
            _partition_rb_weighted(Ac, nw, nparts, seed + s).copy(),
            nparts, cap)
        c = _cut_w(cand)
        if best is None or c < best[0]:
            best = (c, cand)
    part = best[1]
    # uncoarsen: project, then refine each level
    while levels:
        rowids_f, cols_f, w_f, nw_f, cmap = levels.pop()
        part = part[cmap]
        if rowids_f is None:              # the finest level, through A
            part = refine_partition(A, part, nparts, sweeps=3)
            part = _fm_refine(A, part, nparts)
        else:
            capf = int(np.ceil(nw_f.sum() / nparts * 1.05))
            part = _refine_weighted(rowids_f, cols_f, w_f, nw_f,
                                    part.copy(), nparts, capf, sweeps=2)
    return np.asarray(part, dtype=np.int32)


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
    if method in ("multilevel", "ml"):
        return partition_multilevel(A, nparts, seed)
    if method == "rb":
        return refine_partition(A, partition_rb(A, nparts, seed), nparts)
    if method == "bfs":
        return refine_partition(A, partition_bfs(A, nparts, seed), nparts)
    if method == "kway":
        return refine_partition(A, partition_kway(A, nparts, seed), nparts)
    raise AcgError(Status.ERR_INVALID_VALUE,
                   f"unknown partition method {method!r}")


def edge_cut(A: CsrMatrix, part: np.ndarray) -> int:
    """Number of cut edges (the METIS objval analog)."""
    cross = part[A._rowids()] != part[A.colidx]
    return int(cross.sum()) // 2
