"""Structured SPD Poisson problem generators.

The reference's benchmark inputs are SPD systems from Matrix Market files
(SuiteSparse) or discretized Poisson operators; BASELINE.json's north-star
metric is CG on 100M-DOF Poisson.  These generators build the standard
finite-difference Laplacians directly in vectorized NumPy COO, so tests and
benchmarks need no external matrix files.
"""

from __future__ import annotations

import numpy as np

from acg_torch.sparse.csr import CsrMatrix, coo_to_csr


def _stencil_coo(shape, offsets, center_val, off_val, dtype):
    """Generic FD stencil on a regular grid with Dirichlet boundaries."""
    ndim = len(shape)
    n = int(np.prod(shape))
    idx = np.arange(n)
    coords = np.unravel_index(idx, shape)
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, center_val, dtype=dtype)]
    for off, v in zip(offsets, off_val):
        shifted = [c + o for c, o in zip(coords, off)]
        ok = np.ones(n, dtype=bool)
        for c, s in zip(range(ndim), shifted):
            ok &= (s >= 0) & (s < shape[c])
        nb = np.ravel_multi_index([s[ok] for s in shifted], shape)
        rows.append(idx[ok])
        cols.append(nb)
        vals.append(np.full(nb.shape[0], v, dtype=dtype))
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n)


def poisson2d_5pt(nx: int, ny: int | None = None, dtype=np.float64) -> CsrMatrix:
    """5-point 2D Laplacian (diag 4, neighbours -1); SPD."""
    ny = ny if ny is not None else nx
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    r, c, v, n = _stencil_coo((nx, ny), offs, 4.0, [-1.0] * 4, dtype)
    return coo_to_csr(r, c, v, n, n)


def poisson3d_7pt(nx: int, ny: int | None = None, nz: int | None = None,
                  dtype=np.float64) -> CsrMatrix:
    """7-point 3D Laplacian (diag 6, neighbours -1); SPD."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    offs = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]
    r, c, v, n = _stencil_coo((nx, ny, nz), offs, 6.0, [-1.0] * 6, dtype)
    return coo_to_csr(r, c, v, n, n)


def poisson3d_27pt(nx: int, ny: int | None = None, nz: int | None = None,
                   dtype=np.float64) -> CsrMatrix:
    """27-point 3D stencil (diag 26, all neighbours -1); SPD.

    Denser stencil exercising wider ELL rows (width 27)."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    offs = [(i, j, k)
            for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
            if (i, j, k) != (0, 0, 0)]
    r, c, v, n = _stencil_coo((nx, ny, nz), offs, 26.0, [-1.0] * 26, dtype)
    return coo_to_csr(r, c, v, n, n)


def poisson3d_7pt_varcoef(nx: int, ny: int | None = None,
                          nz: int | None = None, dtype=np.float64,
                          seed: int = 0, contrast: float = 10.0
                          ) -> CsrMatrix:
    """Variable-coefficient 7-pt diffusion operator: -div(kappa grad u)
    with a log-uniform random cell coefficient field, harmonic-mean face
    transmissibilities, Dirichlet boundaries.  SPD by construction
    (diagonal = sum of incident face coefficients).

    This is the generator for the GENERAL band path: the bands are neither
    two-valued nor bf16-exact, so operator storage stays full width —
    the honest workload for the mixed-precision policy tests and for
    benchmarking the uncompressed DIA stream (the SuiteSparse-FEM stand-in
    in this zero-egress environment; the reference benchmarks such
    matrices from Matrix Market files, cuda/acg-cuda.c:1296-1331).
    """
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    shape = (nx, ny, nz)
    n = int(np.prod(shape))
    rng = np.random.default_rng(seed)
    kappa = np.exp(rng.uniform(0.0, np.log(contrast), size=shape)
                   ).astype(dtype)

    idx = np.arange(n).reshape(shape)
    rows, cols, vals = [], [], []
    diag = np.zeros(shape, dtype=dtype)
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(None, -1)
        hi[axis] = slice(1, None)
        lo, hi = tuple(lo), tuple(hi)
        # harmonic mean of adjacent cell coefficients on the shared face
        t = 2.0 * kappa[lo] * kappa[hi] / (kappa[lo] + kappa[hi])
        rows.append(idx[lo].ravel())
        cols.append(idx[hi].ravel())
        vals.append(-t.ravel())
        rows.append(idx[hi].ravel())
        cols.append(idx[lo].ravel())
        vals.append(-t.ravel())
        diag[lo] += t
        diag[hi] += t
    # Dirichlet boundary faces contribute kappa of the boundary cell
    for axis in range(3):
        for side in (0, -1):
            face = [slice(None)] * 3
            face[axis] = side
            face = tuple(face)
            diag[face] += kappa[face]
    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(diag.ravel())
    return coo_to_csr(np.concatenate(rows), np.concatenate(cols),
                      np.concatenate(vals), n, n)


def poisson3d_7pt_dia(nx: int, ny: int | None = None, nz: int | None = None,
                      dtype=np.float64, row_align: int = 8):
    """7-pt 3D Laplacian built DIRECTLY in DIA band form.

    The COO/CSR route stores ~24 B per nonzero transiently; at the 100M-DOF
    north-star scale (BASELINE.md: ~700M nonzeros) that is ~17 GB of host
    churn for a matrix whose bands are trivially computable from the grid
    geometry.  This generator materializes only the 7 band vectors
    (7 * n * itemsize), exactly matching ``DiaMatrix.from_csr(
    poisson3d_7pt(...))`` (tested), and feeds the two-value compression
    tier unchanged.
    """
    from acg_torch.ops.dia import DiaMatrix

    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    n = nx * ny * nz
    nrp = -(-n // row_align) * row_align
    i = np.arange(n)
    zc = i % nz
    yc = (i // nz) % ny
    xc = i // (ny * nz)
    offs = (-ny * nz, -nz, -1, 0, 1, nz, ny * nz)
    masks = (xc > 0, yc > 0, zc > 0, None, zc < nz - 1, yc < ny - 1,
             xc < nx - 1)
    bands = np.zeros((7, nrp), dtype=dtype)
    nnz = 0
    for d, m in enumerate(masks):
        if m is None:
            bands[d, :n] = 6.0
            nnz += n
        else:
            bands[d, :n] = np.where(m, -1.0, 0.0)
            nnz += int(m.sum())
    return DiaMatrix(n, n, offs, bands, nnz)


def grid_partition_vector(shape, grid) -> np.ndarray:
    """Part id of every gridpoint (row-major) for a block partition of a
    structured grid into ``grid`` blocks per axis: the exact structured
    analog of METIS partitioning.  ``grid`` has the same length as
    ``shape``."""
    shape = tuple(shape)
    grid = tuple(grid)
    if len(shape) != len(grid):
        raise ValueError(f"grid {grid} and shape {shape} differ in rank")
    coords = np.unravel_index(np.arange(int(np.prod(shape))), shape)
    part = np.zeros(int(np.prod(shape)), dtype=np.int32)
    mult = 1
    for c, s, g in zip(coords[::-1], shape[::-1], grid[::-1]):
        blk = np.minimum((c * g) // s, g - 1)
        part += (blk * mult).astype(np.int32)
        mult *= g
    return part


def random_spd(n: int, degree: int = 8, dtype=np.float64,
               seed: int = 0) -> CsrMatrix:
    """Random-graph SPD matrix: a diagonally-dominant operator over a
    random sparse graph with no recoverable band structure (RCM cannot
    localize an expander), forcing the gather-based ELL device path.

    This is the zero-egress stand-in for the unstructured SuiteSparse
    north-star set (Queen_4147, Bump_2911, Serena — BASELINE.md): those
    matrices are what the reference's merge-based CSR SpMV exists for
    (ref acg/cg-kernels-cuda.cu:340-441), so this generator is the honest
    benchmark workload for the ELL/gather tier.
    """
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), degree)
    c = rng.integers(0, n, n * degree)
    v = rng.standard_normal(n * degree).astype(dtype) * 0.05
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 2.0 * degree, dtype=dtype)])
    return coo_to_csr(rows, cols, vals, n, n)
