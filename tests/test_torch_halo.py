"""Port parity for the distributed slice's host and halo layers:
partitioning, the partitioned system, the halo tables and the three halo
transports, on the CPU against the JAX package on the same inputs.

Inputs are made with numpy seeds and handed to both packages: 2-D and
3-D Poisson grids (the grid branch of ``partition_graph``), banded
non-grid matrices (chunk), ``random_spd`` and a shuffled 3-D Delaunay
mesh (rb + refinement), at P in {2, 4, 8}.  The JAX side runs on the
root conftest's 8-device CPU mesh.

Tolerances, each with its reason:
- part vectors, partitioned-system arrays, RCM relabels, halo tables:
  exact (the port copies the algorithms; its BFS is the JAX package's
  NumPy fallback, which gives the native library's order);
- ghosts of ``halo_ppermute`` / ``halo_allgather`` against the JAX
  transports under ``shard_map``: bit-equal (both only copy values);
- the put+signal transport's plain version followed by the ghost gather:
  bit-equal to the port's ``halo_ppermute`` (the JAX package's rdma
  cannot execute on the CPU, and its contract is "same as
  ``halo_ppermute``");
- ``PartitionedSystem.matvec`` against A·x: 1e-12 relative (the split
  sums each row in another order).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from acg_tpu.config import HaloMethod as JHaloMethod
from acg_tpu.parallel import halo as jhalo
from acg_tpu.parallel.mesh import PARTS_AXIS
from acg_tpu.parallel.sharded import ShardedSystem as JShardedSystem
from acg_tpu.partition import graph as jgraph
from acg_tpu.partition import partitioner as jpart
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import mesh as jmesh
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import HaloMethod
from acg_torch.errors import AcgError, Status
from acg_torch.ops import sliced, spmv
from acg_torch.parallel import halo, rdma_halo
from acg_torch.parallel.mesh import make_mesh
from acg_torch.partition import graph, partitioner
from acg_torch.solvers.cg_dist import build_sharded
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import mesh as tmesh
from acg_torch.sparse import poisson as tpoisson

CPU = torch.device("cpu")


def _tridiag(n, seed=0):
    """SPD banded matrix with offsets {0, ±1, ±3}: no grid shape fits,
    so the auto partitioner takes contiguous chunks."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    rows, cols, vals = [i], [i], [np.full(n, 8.0)]
    for off in (1, 3):
        j = np.arange(n - off)
        v = -rng.random(n - off)
        rows += [j, j + off]
        cols += [j + off, j]
        vals += [v, v]
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n)


def _pair(case):
    """The same matrix in both packages: (JAX CsrMatrix, port CsrMatrix)."""
    kind, arg = case
    if kind == "p2d":
        return jpoisson.poisson2d_5pt(*arg), tpoisson.poisson2d_5pt(*arg)
    if kind == "p3d":
        return jpoisson.poisson3d_7pt(arg), tpoisson.poisson3d_7pt(arg)
    if kind == "p27":
        return jpoisson.poisson3d_27pt(arg), tpoisson.poisson3d_27pt(arg)
    if kind == "band":
        r, c, v, n = _tridiag(arg)
        return (jcsr.coo_to_csr(r, c, v, n, n),
                tcsr.coo_to_csr(r, c, v, n, n))
    if kind == "rand":
        return jpoisson.random_spd(arg, seed=3), tpoisson.random_spd(arg,
                                                                    seed=3)
    if kind == "mesh":
        return (jmesh.fem_delaunay_spd(arg, dim=3, seed=5, shuffle=True),
                tmesh.fem_delaunay_spd(arg, dim=3, seed=5, shuffle=True))
    raise ValueError(kind)


CASES = [("p2d", (16, 16)), ("p3d", 8), ("band", 300), ("p2d", (7, 9)),
         ("rand", 300), ("mesh", 400)]


@pytest.mark.parametrize("nparts", [2, 4, 8])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
def test_partition_graph_equals_jax(case, nparts):
    JA, TA = _pair(case)
    want = jpart.partition_graph(JA, nparts, seed=1)
    got = partitioner.partition_graph(TA, nparts, seed=1)
    np.testing.assert_array_equal(got, want)
    assert partitioner.edge_cut(TA, got) == jpart.edge_cut(JA, want)


@pytest.mark.parametrize("method", ["chunk", "rb"])
def test_partition_methods_equal_jax(method):
    JA, TA = _pair(("mesh", 400))
    np.testing.assert_array_equal(
        partitioner.partition_graph(TA, 4, method=method, seed=2),
        jpart.partition_graph(JA, 4, method=method, seed=2))


def test_refine_batched_sweep_equals_jax():
    """The batched sweep (boundaries past ``max_boundary``) on a chunk
    cut of the shuffled mesh, whose boundary is nearly every node."""
    JA, TA = _pair(("mesh", 600))
    part = partitioner.partition_chunk(TA, 4)
    got = partitioner.refine_partition(TA, part, 4, max_boundary=10)
    want = jpart.refine_partition(JA, part, 4, max_boundary=10)
    np.testing.assert_array_equal(got, want)
    assert partitioner.edge_cut(TA, got) < partitioner.edge_cut(TA, part)


@pytest.mark.parametrize("shape", [(16, 16), (8, 8, 8), (7, 9), (64,),
                                   (12, 6, 5)])
@pytest.mark.parametrize("nparts", [2, 3, 4, 8])
def test_grid_helpers_equal_jax(shape, nparts):
    assert (partitioner.grid_dims_for_parts(shape, nparts)
            == jpart.grid_dims_for_parts(shape, nparts))
    dims = jpart.grid_dims_for_parts(shape, nparts)
    if dims is not None:
        np.testing.assert_array_equal(
            tpoisson.grid_partition_vector(shape, dims),
            jpoisson.grid_partition_vector(shape, dims))


def test_detect_grid_and_bfs_equal_jax():
    for case in (("p2d", (16, 12)), ("p3d", 6), ("band", 50)):
        JA, TA = _pair(case)
        assert (partitioner.detect_grid_stencil(TA)
                == jpart.detect_grid_stencil(JA))
    JA, TA = _pair(("mesh", 400))
    nodes = np.arange(TA.nrows, dtype=np.int64)
    np.testing.assert_array_equal(partitioner._bfs_order(TA, nodes, 7),
                                  jpart._bfs_order(JA, nodes, 7))
    assert (partitioner._pseudo_peripheral(TA, nodes, 3)
            == jpart._pseudo_peripheral(JA, nodes, 3))


@pytest.mark.parametrize("method", ["bfs", "kway", "multilevel"])
def test_unported_methods_raise(method):
    """These methods were refused until they were ported; they now give
    the JAX package's part vectors and ordering (the wider sweep is
    tests/test_torch_partition_ml.py), and an unknown method still
    raises."""
    JA, TA = _pair(("p2d", (8, 8)))
    np.testing.assert_array_equal(
        partitioner.partition_graph(TA, 4, method=method),
        jpart.partition_graph(JA, 4, method=method))
    np.testing.assert_array_equal(partitioner.nd_order(TA),
                                  jpart.nd_order(JA))
    with pytest.raises(AcgError) as e:
        partitioner.partition_graph(TA, 4, method="nope")
    assert e.value.status == Status.ERR_INVALID_VALUE


def _assert_parts_equal(tps, jps):
    assert tps.nparts == jps.nparts and tps.nrows == jps.nrows
    assert tps.rcm_localized == jps.rcm_localized
    np.testing.assert_array_equal(tps.part, jps.part)
    for tp, jp in zip(tps.parts, jps.parts):
        assert tp.part == jp.part and tp.ninterior == jp.ninterior
        for name in ("owned_global", "ghost_global", "ghost_owner",
                     "neighbors", "send_counts", "send_idx", "recv_counts"):
            np.testing.assert_array_equal(getattr(tp, name),
                                          getattr(jp, name), err_msg=name)
        for name in ("A_local", "A_iface"):
            t, j = getattr(tp, name), getattr(jp, name)
            assert (t.nrows, t.ncols) == (j.nrows, j.ncols), name
            for f in ("rowptr", "colidx", "vals"):
                np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                              err_msg=f"{name}.{f}")


@pytest.mark.parametrize("order", ["band", "interior"])
@pytest.mark.parametrize("case", [("p3d", 8), ("mesh", 400), ("rand", 200)],
                         ids=lambda c: c[0])
def test_partition_system_equals_jax(case, order):
    JA, TA = _pair(case)
    part = jpart.partition_graph(JA, 4, seed=0)
    tps = graph.partition_system(TA, part, local_order=order)
    _assert_parts_equal(tps, jgraph.partition_system(JA, part,
                                                     local_order=order))
    x = np.random.default_rng(4).standard_normal(TA.nrows)
    y = TA.matvec(x)
    np.testing.assert_allclose(tps.matvec(x), y,
                               rtol=0, atol=1e-12 * np.abs(y).max())
    np.testing.assert_array_equal(graph.comm_matrix(tps),
                                  jgraph.comm_matrix(
                                      jgraph.partition_system(JA, part)))


def test_rcm_localize_equals_jax():
    JA, TA = _pair(("mesh", 500))
    part = jpart.partition_graph(JA, 4)
    jps = jgraph.rcm_localize(jgraph.partition_system(JA, part,
                                                      local_order="band"))
    tps = graph.rcm_localize(graph.partition_system(TA, part,
                                                    local_order="band"))
    _assert_parts_equal(tps, jps)
    x = np.random.default_rng(5).standard_normal(TA.nrows)
    np.testing.assert_allclose(tps.matvec(x), TA.matvec(x), rtol=1e-12,
                               atol=1e-12)


def _systems(case, nparts, order="band"):
    JA, TA = _pair(case)
    part = jpart.partition_graph(JA, nparts)
    return (JA, TA, jgraph.partition_system(JA, part, local_order=order),
            graph.partition_system(TA, part, local_order=order))


@pytest.mark.parametrize("nparts", [2, 4, 8])
@pytest.mark.parametrize("case", [("p2d", (12, 12)), ("p27", 6),
                                  ("mesh", 400)], ids=lambda c: c[0])
def test_halo_tables_equal_jax(case, nparts):
    _, _, jps, tps = _systems(case, nparts)
    jr, jpartner = jhalo.edge_color(jps)
    tr, tpartner = halo.edge_color(tps)
    assert tr == jr
    np.testing.assert_array_equal(tpartner, jpartner)
    for G in (None, max(p.nghost for p in tps.parts) + 13):
        jt = jhalo.build_halo_tables(jps, nghost_max=G)
        tt = halo.build_halo_tables(tps, nghost_max=G)
        assert (tt.nrounds, tt.perms, tt.nghost_max, tt.total_send_values
                ) == (jt.nrounds, jt.perms, jt.nghost_max,
                      jt.total_send_values)
        for name in ("partner", "send_idx", "recv_idx", "pack_idx",
                     "ghost_src_part", "ghost_src_pos"):
            np.testing.assert_array_equal(getattr(tt, name),
                                          getattr(jt, name), err_msg=name)


def _jax_ghosts(jps, x, method, dtype):
    """The JAX package's ghosts: its transport under shard_map on the CPU
    mesh, exactly as its own halo test drives it."""
    ss = JShardedSystem.build(jps, method=method, dtype=dtype, fmt="ell")
    halo_fn = ss.shard_halo_fn()

    def shard(x_own, sidx, ridx, ptnr, pidx, gsp, gpp):
        return halo_fn(x_own[0], sidx[0], ridx[0], ptnr[0], pidx[0],
                       gsp[0], gpp[0])[None]

    ghosts = jax.jit(jax.shard_map(
        shard, mesh=ss.mesh, in_specs=(JP(PARTS_AXIS),) * 7,
        out_specs=JP(PARTS_AXIS), check_vma=False))(
            ss.to_sharded(x), ss.send_idx, ss.recv_idx, ss.partner,
            ss.pack_idx, ss.ghost_src_part, ss.ghost_src_pos)
    return np.asarray(ghosts)


def _port_tables(tps):
    G = max(-(-max(p.nghost for p in tps.parts) // 8) * 8, 8)
    tables = halo.build_halo_tables(tps, nghost_max=G)
    return halo.shard_tables(tables, tps, [CPU] * tps.nparts)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_ghosts_bit_equal_jax(nparts, dtype):
    JA, TA, jps, tps = _systems(("p27", 6), nparts)
    x = np.random.default_rng(nparts).standard_normal(TA.nrows).astype(dtype)
    st = _port_tables(tps)
    xs = [torch.from_numpy(xl.copy()) for xl in tps.scatter_vector(x)]
    oracle = tps.exchange_halo(tps.scatter_vector(x))
    for jm, fn in ((JHaloMethod.PPERMUTE, halo.halo_ppermute),
                   (JHaloMethod.ALLGATHER, halo.halo_allgather)):
        want = _jax_ghosts(jps, x, jm, dtype)
        got = fn(xs, st)
        for i, p in enumerate(tps.parts):
            assert got[i].dtype == torch.from_numpy(x).dtype
            np.testing.assert_array_equal(got[i].numpy(),
                                          want[i, : p.nghost])
            np.testing.assert_array_equal(got[i].numpy(),
                                          oracle[i][p.nown:])


@pytest.mark.parametrize("case", [("p2d", (12, 12)), ("p27", 6),
                                  ("mesh", 400)], ids=lambda c: c[0])
@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_rdma_plain_equals_ppermute(case, nparts):
    _, TA, _, tps = _systems(case, nparts, order="interior")
    x = np.random.default_rng(1).standard_normal(TA.nrows)
    st = _port_tables(tps)
    xs = [torch.from_numpy(xl.copy()) for xl in tps.scatter_vector(x)]
    before = rdma_halo.launches
    got = rdma_halo.halo_rdma(xs, st)
    assert rdma_halo.launches == before       # the CPU runs no kernel
    for a, b in zip(got, halo.halo_ppermute(xs, st)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nparts", [2, 4, 8])
@pytest.mark.parametrize("case", [("p2d", (12, 12)), ("p27", 6),
                                  ("mesh", 400)], ids=lambda c: c[0])
def test_ghost_slots_invert_ghost_src(case, nparts):
    """The fused halo's unpack map: every ghost is covered once, at the
    slot position it arrives at; every other position is a pad (-1); no
    position is named twice."""
    _, _, _, tps = _systems(case, nparts)
    G = max(-(-max(p.nghost for p in tps.parts) // 8) * 8, 8)
    tables = halo.build_halo_tables(tps, nghost_max=G)
    st = halo.shard_tables(tables, tps, [CPU] * tps.nparts)
    R, S = st.partner.shape[1], st.max_msg
    for p in tps.parts:
        src = st.ghost_src[p.part]
        slot = rdma_halo.ghost_slots(src, R * S)
        assert slot.shape == (R * S,) and slot.dtype == torch.int64
        filled = slot[slot >= 0]
        assert torch.equal(torch.sort(filled).values,
                           torch.arange(p.nghost))          # once each
        assert torch.equal(slot[src], torch.arange(p.nghost))
        assert bool(torch.all(slot[slot < 0] == -1))
        # the pads are the positions no round delivers a ghost to, and a
        # delivered position names the ghost slot the tables give it
        recv = torch.from_numpy(tables.recv_idx[p.part].reshape(-1)
                                .astype(np.int64))
        assert torch.equal(slot >= 0, recv < G)
        assert torch.equal(slot[slot >= 0], recv[recv < G])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_fused_halo_plain_equals_every_transport(nparts, dtype):
    """The fused halo's plain version (gather by send_full, deliver,
    unpack through the inverse of ghost_src) against halo_ppermute,
    halo_allgather and the JAX package's ppermute transport on the same
    tables and the same seeded vectors: bit-equal (every path only
    copies values)."""
    _, TA, jps, tps = _systems(("p27", 6), nparts)
    x = np.random.default_rng(nparts + 20).standard_normal(
        TA.nrows).astype(dtype)
    st = _port_tables(tps)
    xs = [torch.from_numpy(xl.copy()) for xl in tps.scatter_vector(x)]
    got = rdma_halo.halo_rdma_plain(xs, st)
    want = _jax_ghosts(jps, x, JHaloMethod.PPERMUTE, dtype)
    for i, p in enumerate(tps.parts):
        assert got[i].dtype == xs[i].dtype and got[i].shape == (p.nghost,)
        np.testing.assert_array_equal(got[i].numpy(), want[i, : p.nghost])
    for fn in (halo.halo_ppermute, halo.halo_allgather):
        for a, b in zip(got, fn(xs, st)):
            assert torch.equal(a, b)
    # through the entry point (CPU tensors take the plain version)
    for a, b in zip(rdma_halo.halo_rdma(xs, st), got):
        assert torch.equal(a, b)


def test_rdma_exchange_plain_delivery():
    """Slot r of shard p lands in slot r of its partner; a slot with no
    partner comes back to its own shard."""
    partner = np.array([[1, 2, -1], [0, -1, 2], [-1, 0, 1]], dtype=np.int32)
    send = [torch.arange(12, dtype=torch.float64).view(3, 4) + 100 * p
            for p in range(3)]
    out = rdma_halo.rdma_exchange(send, partner)
    for p in range(3):
        for r in range(3):
            q = partner[p, r]
            src = send[q if q >= 0 else p][r]
            assert torch.equal(out[p][r], src)


def test_rdma_raises_off_cuda():
    _, TA = _pair(("p2d", (8, 8)))
    for m in ("rdma", HaloMethod.RDMA):
        with pytest.raises(AcgError) as e:
            build_sharded(TA, nparts=4, devices=["cpu"] * 4, method=m)
        assert e.value.status == Status.ERR_NOT_SUPPORTED
        assert "rdma" in str(e.value).lower()
    ss = build_sharded(TA, nparts=4, devices=["cpu"] * 4)
    with pytest.raises(AcgError) as e:
        ss.with_halo("rdma")
    assert e.value.status == Status.ERR_NOT_SUPPORTED
    with pytest.raises(AcgError) as e:
        rdma_halo.RdmaState(ss.tables.partner, 8, torch.float64,
                            ss.devices)
    assert e.value.status == Status.ERR_NOT_SUPPORTED


def test_make_mesh_layouts(monkeypatch):
    assert make_mesh(3, ["cpu"] * 3) == (CPU,) * 3
    with pytest.raises(AcgError) as e:
        make_mesh(3, ["cpu"] * 2)
    assert e.value.status == Status.ERR_MESH
    if not torch.cuda.is_available():
        with pytest.raises(AcgError) as e:
            make_mesh(2)
        assert e.value.status == Status.ERR_NOT_SUPPORTED
    # one visible card: the default mesh keeps the JAX package's ERR_MESH
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh(1) == (torch.device("cuda", 0),)
    with pytest.raises(AcgError) as e:
        make_mesh(4)
    assert e.value.status == Status.ERR_MESH


def test_compressed_wire_not_ported():
    """The compressed wires are ported (``tests/test_torch_halo_wire.py``
    holds them against the JAX codec): both transports take them and
    deliver the f32 ghosts to the wire's precision; a wire that does not
    exist is refused."""
    _, _, _, tps = _systems(("p2d", (8, 8)), 2)
    st = _port_tables(tps)
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal(p.nown)) for p in tps.parts]
    for fn in (halo.halo_ppermute, halo.halo_allgather):
        exact = fn(xs, st)
        for wire, tol in (("bf16", 2.0 ** -8), ("int16-delta", 1e-4)):
            for a, b in zip(fn(xs, st, wire=wire), exact):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert float((a - b).abs().max()) <= tol * 4.0
        with pytest.raises(AcgError, match="unknown halo wire") as e:
            fn(xs, st, wire="fp8")
        assert e.value.status == Status.ERR_INVALID_VALUE


def test_ell_rectangle_and_shape_errors():
    """The interface operator is rectangular (owned rows × ghost slots):
    its sliced layout keeps the column bound, the plain version takes any
    x at least that long, and the wrapper's argument check accepts it and
    rejects what the kernel cannot take."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal((6, 3)))
    cols = torch.from_numpy(rng.integers(0, 4, (6, 3)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(4))
    op = sliced.slice_ell(vals, cols, 4)
    y = spmv.ell_spmv(op, x)
    want = (vals.numpy() * x.numpy()[cols.numpy()]).sum(1)
    assert y.shape == (6,)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-15)

    def check(o, xx):
        sliced.check_operands("ell_spmv", o, xx, spmv._VEC_DTYPES,
                              spmv._VAL_DTYPES)

    check(op, x)                                # a rectangle passes
    check(op, torch.zeros(100, dtype=torch.float64))
    empty = sliced.slice_ell(vals[:0], cols[:0], 4)
    for o, xx in ((op, torch.zeros(0, dtype=torch.float64)),
                  (op, x[:3]),
                  (empty, x),
                  (op, x[None]),
                  (op, torch.zeros(8, dtype=torch.float64)[::2]),
                  (dataclasses.replace(op, vals=op.vals.half()), x),
                  (op, x.to(torch.int32))):
        with pytest.raises(AcgError) as e:
            check(o, xx)
        assert e.value.status == Status.ERR_INVALID_VALUE
    # a layout the kernel cannot read is refused when it is made
    for bad in (dict(cols=op.cols.long()), dict(ptr=op.ptr.int()),
                dict(perm=op.perm[:-1]), dict(vals=op.vals[:-1])):
        with pytest.raises(AcgError) as e:
            dataclasses.replace(op, **bad)
        assert e.value.status == Status.ERR_INVALID_VALUE
    # a column past the ghost slots is refused once, when sliced
    with pytest.raises(AcgError) as e:
        sliced.slice_ell(vals, cols, 3)
    assert e.value.status == Status.ERR_INDEX_OUT_OF_BOUNDS


def test_rdma_kernel_source():
    """The put+signal kernel is hand-written CUDA in the tree, built with
    the others, and moves its words itself (no memcpy)."""
    from acg_torch import _build

    assert "rdma_halo" in _build.SOURCES
    text = (_build.CSRC / "rdma_halo.cu").read_text()
    for need in ('extern "C"', "Replaces the TPU kernel",
                 "Bound on this card", "__threadfence_system",
                 "cudaLaunchCooperativeKernel", "ld.acquire.sys",
                 "red.release.sys",
                 # GPU scope where every partner shares the card
                 "ld.acquire.gpu", "red.release.gpu", "fence.acq_rel.gpu",
                 # the pack and unpack fused in, by value parameters
                 "src[pack[i]]", "out[gh] = w", "const Launch L",
                 "bool HALO", "bool SYS"):
        assert need in text, need
    assert "cudaMemcpy" not in text
