"""Unstructured FEM-style mesh operators: the SuiteSparse stand-in.

The port's copy of ``acg_tpu/sparse/mesh.py``.  The reference benchmarks
its merge-based CSR SpMV on SuiteSparse FEM matrices (Queen_4147,
Bump_2911, Serena), read from Matrix Market files.  These generators
make the same shape of workload from a seed: a genuine unstructured mesh
graph (random Delaunay triangulation) with bounded degree, spatial
locality, and no band structure in its delivered ordering: the matrices
the DIA / RCM+DIA / RCM+sgell / ELL ladder exists to sort out.
"""

from __future__ import annotations

import numpy as np

from acg_torch.sparse.csr import CsrMatrix, coo_to_csr


def fem_delaunay_spd(n: int, dim: int = 2, seed: int = 0,
                     dtype=np.float64, contrast: float = 10.0,
                     shuffle: bool = True) -> CsrMatrix:
    """SPD operator over a random Delaunay mesh of ``n`` points in
    ``dim`` dimensions: a weighted graph Laplacian (log-uniform random
    edge coefficients, the jumping-coefficient regime) plus a boundary
    mass term, so the matrix is an irreducibly diagonally dominant
    M-matrix, SPD like an assembled FEM stiffness matrix, with the same
    ~6 (2-D) / ~15 (3-D) average degree and mesh locality.

    ``shuffle=True`` delivers the rows in a random vertex numbering:
    SuiteSparse matrices arrive in arbitrary orderings, and recovering
    locality (RCM, then the sgell pack) is part of the pipeline."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n, dim))
    tri = Delaunay(pts)
    s = tri.simplices
    pairs = [(i, j) for i in range(dim + 1) for j in range(i + 1, dim + 1)]
    er = np.concatenate([s[:, i] for i, _ in pairs])
    ec = np.concatenate([s[:, j] for _, j in pairs])
    # unique undirected edges
    lo, hi = np.minimum(er, ec), np.maximum(er, ec)
    key = lo.astype(np.int64) * n + hi
    key = np.unique(key)
    lo, hi = (key // n).astype(np.int64), (key % n).astype(np.int64)
    w = np.exp(rng.uniform(0.0, np.log(contrast),
                           size=len(lo))).astype(dtype)
    if shuffle:
        perm = rng.permutation(n)
        lo, hi = perm[lo], perm[hi]
    diag = np.zeros(n, dtype=dtype)
    np.add.at(diag, lo, w)
    np.add.at(diag, hi, w)
    rows = np.concatenate([lo, hi, np.arange(n)])
    cols = np.concatenate([hi, lo, np.arange(n)])
    vals = np.concatenate([-w, -w, diag * 1.05])  # 5% mass: strictly SPD
    return coo_to_csr(rows, cols, vals, n, n)


def poisson3d_7pt_aniso(nx: int, ny: int | None = None,
                        nz: int | None = None, dtype=np.float64,
                        ax: float = 1.0, ay: float = 10.0,
                        az: float = 100.0) -> CsrMatrix:
    """Anisotropic 7-pt diffusion: constant per-axis coefficients
    (ax, ay, az), the anisotropy regime of the FEM benchmark family
    (bands that are neither two-valued nor bf16-exact take the
    full-width storage path)."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    shape = (nx, ny, nz)
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    coef = (dtype(ax), dtype(ay), dtype(az))
    rows, cols, vals = [], [], []
    diag = np.zeros(shape, dtype=dtype)
    for axis, c in enumerate(coef):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(None, -1)
        hi[axis] = slice(1, None)
        lo, hi = tuple(lo), tuple(hi)
        rows += [idx[lo].ravel(), idx[hi].ravel()]
        cols += [idx[hi].ravel(), idx[lo].ravel()]
        m = idx[lo].size
        vals += [np.full(m, -c, dtype=dtype)] * 2
        diag[lo] += c
        diag[hi] += c
        for side in (0, -1):
            face = [slice(None)] * 3
            face[axis] = side
            diag[tuple(face)] += c
    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(diag.ravel())
    return coo_to_csr(np.concatenate(rows), np.concatenate(cols),
                      np.concatenate(vals), n, n)
