"""Port parity for the bfs, kway and multilevel partitioners and the
nested-dissection ordering (``acg_torch.partition.partitioner``) against
``acg_tpu.partition.partitioner`` on the same graphs and seeds, and the
``mtxpartition`` tool.

The JAX package runs these through its native host library where it is
built (``acg_tpu/native.py``, which states its results are the NumPy
paths' bit for bit); the port copies the NumPy paths.  Part vectors and
orderings must be equal, element for element.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from acg_tpu.partition import partitioner as jpart
from acg_tpu.sparse import mesh as jmesh
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, read_mtx, write_mtx
from acg_torch.partition import partitioner as tpart
from acg_torch.sparse import mesh as tmesh
from acg_torch.sparse import poisson as tpoisson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRAPHS = {
    "p2d": lambda m: m.poisson2d_5pt(24),
    "p2d-rect": lambda m: m.poisson2d_5pt(17, 11),
    "p3d": lambda m: m.poisson3d_7pt(10),
    "fem": lambda m: m.fem_delaunay_spd(600, dim=2, seed=1),
    "random": lambda m: m.random_spd(500, degree=6, seed=2),
}


def _pair(name):
    make = GRAPHS[name]
    if name == "fem":
        return make(jmesh), make(tmesh)
    return make(jpoisson), make(tpoisson)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    return request.param, _pair(request.param)


@pytest.mark.parametrize("method", ["bfs", "kway", "multilevel"])
@pytest.mark.parametrize("nparts,seed", [(4, 0), (4, 1), (3, 2), (8, 0)])
def test_part_vector_equals_jax(graphs, method, nparts, seed):
    _name, (J, T) = graphs
    want = jpart.partition_graph(J, nparts, method=method, seed=seed)
    got = tpart.partition_graph(T, nparts, method=method, seed=seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == set(range(nparts))


def test_ml_alias_and_multilevel_entry(graphs):
    _name, (J, T) = graphs
    np.testing.assert_array_equal(
        tpart.partition_graph(T, 4, method="ml", seed=3),
        jpart.partition_multilevel(J, 4, seed=3))
    np.testing.assert_array_equal(
        tpart.partition_multilevel(T, 4, seed=3, best_of=1),
        jpart.partition_multilevel(J, 4, seed=3, best_of=1))


@pytest.mark.parametrize("cutoff,seed", [(32, 0), (8, 1)])
def test_nd_order_equals_jax(graphs, cutoff, seed):
    _name, (J, T) = graphs
    got = tpart.nd_order(T, cutoff=cutoff, seed=seed)
    np.testing.assert_array_equal(got, jpart.nd_order(J, cutoff=cutoff,
                                                      seed=seed))
    np.testing.assert_array_equal(np.sort(got), np.arange(T.nrows))


@pytest.mark.parametrize("method", ["bfs", "kway"])
def test_unrefined_growers_equal_jax(graphs, method):
    _name, (J, T) = graphs
    fn = "partition_" + method
    np.testing.assert_array_equal(getattr(tpart, fn)(T, 5, seed=4),
                                  getattr(jpart, fn)(J, 5, seed=4))


def test_unknown_method_raises():
    T = tpoisson.poisson2d_5pt(6)
    with pytest.raises(AcgError) as ei:
        tpart.partition_graph(T, 2, method="metis")
    assert ei.value.status == Status.ERR_INVALID_VALUE


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


@pytest.mark.parametrize("method", ["auto", "kway"])
def test_mtxpartition_round_trip(tmp_path, method):
    """The tool writes the part vector partition_graph computes, as the
    JAX package's tool writes it (the same bytes), and it reads back; -v
    prints the edge cut."""
    T = tpoisson.poisson2d_5pt(14)
    r, c, v = T.to_coo()
    path = str(tmp_path / "A.mtx")
    write_mtx(path, MtxFile(nrows=T.nrows, ncols=T.ncols, nnz=T.nnz,
                            rowidx=r, colidx=c, vals=v))
    out, jout = str(tmp_path / "p.mtx"), str(tmp_path / "pj.mtx")
    p = _run("acg_torch.tools.mtxpartition", path, "--parts", "4",
             "--method", method, "--seed", "1", "-o", out, "-v")
    assert p.returncode == 0, p.stderr
    part = tpart.partition_graph(T, 4, method=method, seed=1)
    assert f"edge cut: {tpart.edge_cut(T, part)};" in p.stderr
    m = read_mtx(out)
    assert (m.object, m.format, m.field) == ("vector", "array", "integer")
    np.testing.assert_array_equal(m.vals.astype(np.int32), part)
    pj = _run("acg_tpu.tools.mtxpartition", path, "--parts", "4",
              "--method", method, "--seed", "1", "-o", jout)
    assert pj.returncode == 0, pj.stderr
    with open(out, "rb") as f1, open(jout, "rb") as f2:
        assert f1.read() == f2.read()
    # to stdout, the same vector
    s = _run("acg_torch.tools.mtxpartition", path, "--parts", "4",
             "--method", method, "--seed", "1")
    assert s.returncode == 0
    lines = s.stdout.splitlines()
    assert lines[0] == "%%MatrixMarket vector array integer general"
    np.testing.assert_array_equal(np.array(lines[2:], dtype=np.int32), part)


def test_mtxpartition_errors_exit_1(tmp_path):
    p = _run("acg_torch.tools.mtxpartition", str(tmp_path / "missing.mtx"),
             "--parts", "2")
    assert p.returncode == 1 and "error:" in p.stderr
    assert "Traceback" not in p.stderr
