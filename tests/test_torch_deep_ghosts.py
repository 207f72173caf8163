"""Port parity for the deep ghost zones (``acg_torch.parallel.deep``)
against ``acg_tpu.parallel.deep`` on the CPU, on the same part vector.

- ``build_deep`` at depths 1-4 on a grid partition and a recursive-
  bisection one: each part's deep ghosts in (owner, global id) order
  equal to the JAX package's BFS; ``gdeep`` and every exchange table
  equal; the interface and skin entries, per shard, equal to the
  nonzero entries of the JAX package's padded ELL arrays (the port keeps
  them as CSR, its skin columns laid out against the same padded owned
  length for the comparison).
- The deep exchange (ppermute and allgather) delivers each ghost's value
  exactly (the global vector read at the ghost's id).
- The extended recurrence (``DeepDevice.ext_shifted`` on the CPU shards)
  gives the global A^j v on the owned rows for j up to the depth, within
  1e-10 (the port's version of ``tests/test_cg_sstep.py``'s
  ``test_deep_basis_matches_global_operator``), and A v - sigma v with a
  shift.
"""

import numpy as np
import pytest
import torch

from acg_tpu.parallel import deep as jdeep
from acg_tpu.partition.graph import partition_system as jpartition_system
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import HaloMethod
from acg_torch.parallel import deep as tdeep
from acg_torch.partition.graph import partition_system
from acg_torch.partition.partitioner import partition_graph
from acg_torch.solvers.cg_dist import build_sharded
from acg_torch.sparse.csr import coo_to_csr
from acg_torch.sparse import poisson as tpoisson

# (generator, arguments, partition method): a 2 x 2 grid partition and a
# recursive bisection of an irregular grid
CASES = {"grid": ("poisson2d_5pt", (12,), "auto"),
         "grid3d": ("poisson3d_7pt", (6,), "auto"),
         "rb": ("poisson2d_5pt", (11, 9), "rb")}


@pytest.fixture(scope="module", params=sorted(CASES))
def parts(request):
    kind, args, method = CASES[request.param]
    JA = getattr(jpoisson, kind)(*args)
    TA = getattr(tpoisson, kind)(*args)
    part = partition_graph(TA, 4, method=method)
    return (TA, part, jpartition_system(JA, part, local_order="band"),
            partition_system(TA, part, local_order="band"))


def _ell_entries(vals, cols):
    """(row, column, value) of the nonzero entries of a padded ELL."""
    r, w = np.nonzero(vals)
    return np.c_[r, cols[r, w]], vals[r, w]


def _csr_entries(M):
    return np.c_[M._rowids(), M.colidx], M.vals


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_build_deep_matches_jax(parts, depth):
    TA, part, J, T = parts
    nown = max(-(-max(p.nown for p in J.parts) // 8) * 8, 8)
    jh = jdeep.build_deep(J, depth, nown)
    th = tdeep.build_deep(T, depth, (nown,) * T.nparts)
    assert th.gdeep == jh.gdeep and th.max_ghost == jh.max_ghost
    for f in ("partner", "send_idx", "recv_idx", "pack_idx",
              "ghost_src_part", "ghost_src_pos"):
        np.testing.assert_array_equal(getattr(th.tables, f),
                                      getattr(jh.tables, f), err_msg=f)
    assert th.tables.nrounds == jh.tables.nrounds
    assert th.tables.perms == jh.tables.perms
    JAc = jdeep.global_csr_from_parts(J)
    for i, p in enumerate(J.parts):
        g, lv = jdeep._bfs_levels(JAc, p.owned_global, depth)
        order = np.lexsort((g, part[g]))
        np.testing.assert_array_equal(th.ghosts[i], g[order])
        np.testing.assert_array_equal(th.levels[i], lv[order])
        for mine, (v, c) in ((th.iface[i], (jh.ifv[i], jh.ifc[i])),
                             (th.skin[i], (jh.grv[i], jh.grc[i]))):
            rc, vals = _csr_entries(mine)
            jrc, jvals = _ell_entries(v, c)
            np.testing.assert_array_equal(rc, jrc)
            np.testing.assert_array_equal(vals, jvals)


def test_part_rows_reassemble_the_operator(parts):
    """Every row read from its owning part (what the BFS and the skin
    read) gives back the global operator exactly."""
    TA, _part, _J, T = parts
    r, c, v = tdeep._PartRows(T).rows(np.arange(T.nrows, dtype=np.int64))
    Ar = coo_to_csr(r, c, v, T.nrows, T.nrows)
    np.testing.assert_array_equal(Ar.rowptr, TA.rowptr)
    np.testing.assert_array_equal(Ar.colidx, TA.colidx)
    np.testing.assert_array_equal(Ar.vals, TA.vals)


@pytest.fixture(scope="module")
def sharded(parts):
    TA, part, _J, T = parts
    return TA, build_sharded(T, devices=["cpu"] * 4, dtype=np.float64)


@pytest.mark.parametrize("method", ["ppermute", "allgather"])
@pytest.mark.parametrize("depth", [2, 4])
def test_deep_exchange_delivers_every_ghost(sharded, method, depth):
    TA, ss = sharded
    ss = ss.with_halo(method)
    dd = tdeep.build_deep_device(ss, depth)
    v = np.random.default_rng(3).standard_normal(TA.nrows)
    xs = ss.to_sharded(v)
    for i, g in enumerate(dd.exchange(ss, xs)):
        np.testing.assert_array_equal(g.numpy(), v[dd.host.ghosts[i]])
    # a (2, B, n) stack goes as one exchange and comes back stacked
    xs2 = [torch.stack([x[None], 2 * x[None]]) for x in xs]
    for i, g in enumerate(dd.exchange(ss, xs2)):
        assert g.shape == (2, 1, dd.nghost[i])
        np.testing.assert_array_equal(g[1, 0].numpy(),
                                      2 * v[dd.host.ghosts[i]])
    assert dd.nrounds == dd.host.tables.nrounds
    assert tdeep.build_deep_device(ss, depth) is dd       # cached


@pytest.mark.parametrize("shift", [0.0, 1.75])
def test_extended_recurrence_matches_global_operator(sharded, shift):
    """(A - sigma)^j v on the owned rows for j <= depth, from one
    exchange: each application consumes one level of the skin."""
    TA, ss = sharded
    depth = 3
    dd = tdeep.build_deep_device(ss, depth)
    v = np.random.default_rng(13).standard_normal(TA.nrows)
    xs = ss.to_sharded(v)
    gh = dd.exchange(ss, xs)
    sig = torch.tensor(shift, dtype=torch.float64)
    want = v.copy()
    ves = [torch.cat([x, g]) for x, g in zip(xs, gh)]
    for j in range(depth):
        want = TA.matvec(want) - shift * want
        ves = [dd.ext_shifted(ss, i, ve, torch.empty_like(ve), sig)
               for i, ve in enumerate(ves)]
        for i, (p, ve) in enumerate(zip(ss.ps.parts, ves)):
            got = ve[: p.nown].numpy()
            np.testing.assert_allclose(
                got, want[p.owned_global],
                atol=1e-10 * np.abs(want).max(),
                err_msg=f"part {i} level {j + 1}")


def test_extended_residual_is_b_minus_ax(sharded):
    TA, ss = sharded
    dd = tdeep.build_deep_device(ss, 2)
    rng = np.random.default_rng(5)
    x, b = rng.standard_normal((2, TA.nrows))
    xs, bs = ss.to_sharded(x), ss.to_sharded(b)
    want = b - TA.matvec(x)
    for i, (gx, gb) in enumerate(zip(dd.exchange(ss, xs),
                                     dd.exchange(ss, bs))):
        xe, be = torch.cat([xs[i], gx]), torch.cat([bs[i], gb])
        out = dd.ext_shifted(ss, i, xe, torch.empty_like(xe), minuend=be)
        p = ss.ps.parts[i]
        np.testing.assert_allclose(out[: p.nown].numpy(),
                                   want[p.owned_global], rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_deep_layer_refuses_the_rdma_halo(sharded):
    _TA, ss = sharded
    dd = tdeep.build_deep_device(ss, 2)
    fake = type("S", (), {"method": HaloMethod.RDMA})()
    with pytest.raises(ValueError):
        dd.exchange(fake, ss.to_sharded(np.zeros(ss.nrows)))
