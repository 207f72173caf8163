"""RCM's BFS levels expanded with array operations (``acg_torch/sparse/
rcm.py``, ``_LEVEL_VECTOR``): every level size threshold gives the order the
node-by-node BFS gives, which is ``acg_tpu``'s, on meshes, a grid, a
scrambled path (levels of one node) and a matrix of several components
with isolated rows."""

import numpy as np
import pytest

from acg_tpu.sparse import mesh as jmesh
from acg_tpu.sparse import rcm as jrcm
from acg_tpu.sparse.csr import coo_to_csr as jcoo_to_csr
from acg_torch.sparse import mesh as tmesh
from acg_torch.sparse import poisson as tpoisson
from acg_torch.sparse import rcm as trcm
from acg_torch.sparse.csr import coo_to_csr


def _path(n, seed):
    p = np.random.default_rng(seed).permutation(n)
    i = np.arange(n - 1)
    r = np.concatenate([p[i], p[i + 1], p])
    c = np.concatenate([p[i + 1], p[i], p])
    v = np.concatenate([-np.ones(n - 1)] * 2 + [np.full(n, 3.0)])
    return r, c, v, n


def _components(seed):
    A1 = tmesh.fem_delaunay_spd(900, dim=3, seed=1)
    A2 = tmesh.fem_delaunay_spd(700, dim=2, seed=2)
    r1, c1, v1 = A1.to_coo()
    r2, c2, v2 = A2.to_coo()
    n1, n2 = A1.nrows, A2.nrows
    iso = np.arange(n1 + n2, n1 + n2 + 4)
    n = n1 + n2 + 4
    p = np.random.default_rng(seed).permutation(n)
    r = p[np.concatenate([r1, r2 + n1, iso])]
    c = p[np.concatenate([c1, c2 + n1, iso])]
    return r, c, np.concatenate([v1, v2, np.ones(4)]), n


@pytest.mark.parametrize("case", ["mesh3d", "mesh2d", "grid", "path",
                                  "components"])
def test_level_arrays_give_the_node_by_node_order(case, monkeypatch):
    if case.startswith("mesh"):
        dim = 3 if case == "mesh3d" else 2
        At = tmesh.fem_delaunay_spd(2500, dim=dim, seed=4)
        Aj = jmesh.fem_delaunay_spd(2500, dim=dim, seed=4)
    elif case == "grid":
        At = tpoisson.poisson3d_7pt(12)
        Aj = None
    else:
        r, c, v, n = _path(3000, 5) if case == "path" else _components(6)
        At, Aj = coo_to_csr(r, c, v, n, n), jcoo_to_csr(r, c, v, n, n)
    monkeypatch.setattr(trcm, "_LEVEL_VECTOR", 10 ** 9)   # node by node
    ref = trcm.rcm_order(At)
    for vector in (0, 1, 2, 32):
        monkeypatch.setattr(trcm, "_LEVEL_VECTOR", vector)
        np.testing.assert_array_equal(trcm.rcm_order(At), ref)
    if Aj is not None:
        np.testing.assert_array_equal(ref, jrcm.rcm_order(Aj))
