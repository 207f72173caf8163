"""The sliced-ELL layout (``acg_torch/ops/sliced.py``) that the sgell and
ELL kernels read, on the CPU: built from an sgell pack and from an ELL
rectangle, against the source layouts, and its plain product against
the JAX package's SpMVs on the same inputs.

Inputs are made with numpy seeds and handed to both packages: the sgell
probe matrix (four 1024-row tiles, tile 2 empty), RCM'd 2-D Delaunay
meshes of at most 3,000 points, and random rectangles.

Tolerances, each with its reason:
- the layout against its source: exact (every stored entry once, each
  row's order kept);
- ``sliced_matvec`` on a pack's layout against ``sgell_matvec`` on the
  pack: bit for bit (both sum each row from +0 in slot order, a product
  then a sum; a dropped padding slot added ±0);
- ``sliced_matvec`` on a rectangle's layout against ``ell_matvec`` and the
  JAX package's ``ell_matvec_pallas`` (interpret mode) and XLA
  ``ell_matvec``: 1e-6 of max|y| at f32, 1e-14 at f64 (the row sums run
  in another order);
- whole solves on a 3-D mesh: iteration counts within 1 (on this mesh
  the port's f64 ELL solve took 62 iterations against the JAX package's
  63 before the sliced layout too: its dots sum in another order than
  XLA's); x within 1e-8 (f64) or 1e-3 (f32) of the JAX solution relative
  to its norm; the true residual within 10 x rtol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.ops import sgell as jsgell
from acg_tpu.ops import spmv as jspmv
from acg_tpu.ops.pallas_spmv import ell_matvec_pallas
from acg_tpu.solvers.cg import cg as jcg
from acg_tpu.sparse import mesh as jmesh

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.ops import sgell, sliced, spmv
from acg_torch.solvers.cg import build_device_operator, cg
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import mesh as tmesh
from acg_torch.sparse import rcm as trcm
from acg_torch.sparse.ell import EllMatrix

WARP = sliced.WARP


@pytest.fixture
def jax_sgell_interpret(monkeypatch):
    """The JAX sgell tier in Pallas interpret mode (its TPU kernel cannot
    run here)."""
    build, require = jsgell.build_device_sgell, jsgell.sgell_require_available

    def forced_build(A, dtype=None, mat_dtype="auto",
                     min_fill=jsgell.MIN_FILL, interpret=False,
                     _probing=False):
        return build(A, dtype=dtype, mat_dtype=mat_dtype, min_fill=min_fill,
                     interpret=True)

    monkeypatch.setattr(jsgell, "build_device_sgell", forced_build)
    monkeypatch.setattr(jsgell, "sgell_require_available",
                        lambda vdt, interpret=False: require(vdt, True))


def _probe(seed=0):
    """Four 1024-row tiles of local random sparsity, tile 2 empty (the
    JAX package's sgell probe workload), as a port CSR matrix."""
    rng = np.random.default_rng(seed)
    n, W = 4 * sgell.TILE, 6
    rows = np.repeat(np.arange(n), W)
    cols = np.clip(rows + rng.integers(-500, 501, size=n * W), 0, n - 1)
    keep = (rows // sgell.TILE) != 2
    rows, cols = rows[keep], cols[keep]
    uniq = np.unique(rows * np.int64(n) + cols)
    rows, cols = uniq // n, uniq % n
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return tcsr.coo_to_csr(rows, cols, vals, n, n)


def _mesh_rcm(points=3000, dtype=np.float32):
    A = tmesh.fem_delaunay_spd(points, dim=2, seed=7, dtype=dtype)
    return trcm.permute_symmetric(A, trcm.rcm_order(A))


def _ragged(n=1000, seed=3):
    """n rows (not a multiple of 32) of 0 to 9 entries, every fifth row
    empty."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 10, n)
    lens[::5] = 0
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, len(rows))
    uniq = np.unique(rows * np.int64(n) + cols)
    rows, cols = uniq // n, uniq % n
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return tcsr.coo_to_csr(rows, cols, vals, n, n)


_MATRICES = {"probe": _probe, "mesh_rcm": _mesh_rcm, "ragged": _ragged}


def _pack(A, mat_dtype=None):
    return sgell.build_device_sgell(A, dtype=np.float32, mat_dtype=mat_dtype,
                                    min_fill=0.0, device="cpu")


def _rows_of(op):
    """{row: [(col, val), ...]} read back from a sliced layout, each row's
    entries in stored order, trailing zero padding dropped."""
    ptr, perm = op.ptr.numpy(), op.perm.numpy()
    vals, cols = op.vals.double().numpy(), op.cols.numpy()
    out = {}
    for k in range(op.nslices):
        w = (ptr[k + 1] - ptr[k]) // WARP
        block = slice(ptr[k], ptr[k + 1])
        v = vals[block].reshape(w, WARP)
        c = cols[block].reshape(w, WARP)
        for r in range(WARP):
            p = k * WARP + r
            if p >= op.nrows:
                assert not v[:, r].any() and not c[:, r].any()
                continue
            ent = list(zip(c[:, r].tolist(), v[:, r].tolist()))
            while ent and ent[-1][1] == 0.0:
                assert ent[-1][0] == 0                 # padding: column 0
                ent.pop()
            out[int(perm[p])] = ent
    return out


def _check_shape(op, lens):
    """ptr, perm and the slice widths against the row lengths ``lens``."""
    assert op.ptr.dtype == torch.int64 and op.perm.dtype == torch.int32
    assert op.cols.dtype == torch.int32
    assert op.nslices == -(-op.nrows // WARP)
    perm = op.perm.numpy()
    assert np.array_equal(np.sort(perm), np.arange(op.nrows))
    plen = np.zeros(op.nslices * WARP, dtype=np.int64)
    plen[: op.nrows] = lens[perm]
    width = plen.reshape(-1, WARP).max(1)
    np.testing.assert_array_equal(np.diff(op.ptr.numpy()), width * WARP)
    assert op.vals.numel() == op.cols.numel() == int(width.sum()) * WARP
    # rows sorted by length, longest first, inside each window of sigma
    if op.sigma > 1:
        for a in range(0, op.nrows, op.sigma):
            seg = lens[perm[a: a + op.sigma]]
            assert np.all(seg[:-1] >= seg[1:])
    else:
        np.testing.assert_array_equal(perm, np.arange(op.nrows))


@pytest.mark.parametrize("sigma", [1, 1024])
@pytest.mark.parametrize("case", ["probe", "mesh_rcm", "ragged"])
def test_layout_from_pack_keeps_every_entry_in_slot_order(case, sigma):
    dev = _pack(_MATRICES[case]())
    op = sgell.slice_pack(dev.vals, dev.idx, dev.seg, dev.tile_start,
                          sigma=sigma)
    assert (op.nrows, op.ncols, op.sigma) == (dev.nrows_padded,
                                              dev.nrows_padded, sigma)
    # the pack's entries, per row, in slot order
    S = dev.S
    vals = dev.vals.numpy().reshape(S, sgell.TILE)
    cols = (dev.seg.numpy().astype(np.int64) * sgell.LANES)[:, :, None] \
        + dev.idx.numpy().reshape(S, sgell.SUBL, sgell.LANES)
    cols = cols.reshape(S, sgell.TILE)
    start = dev.tile_start.numpy()
    want = {}
    for t in range(dev.ntiles):
        for k in range(start[t], start[t + 1]):
            for e in np.flatnonzero(vals[k]):
                want.setdefault(t * sgell.TILE + e, []).append(
                    (int(cols[k, e]), float(vals[k, e])))
    got = {r: ent for r, ent in _rows_of(op).items() if ent}
    assert got == want
    assert op.nnz == sum(len(v) for v in want.values()) == dev.nnz
    lens = np.zeros(op.nrows, dtype=np.int64)
    for r, ent in want.items():
        lens[r] = len(ent)
    _check_shape(op, lens)
    if case == "probe":                    # tile 2 holds no entry
        assert not any(2 * sgell.TILE <= r < 3 * sgell.TILE for r in got)


@pytest.mark.parametrize("sigma", [1, 1024])
@pytest.mark.parametrize("shape", ["square", "ragged_n", "rectangle"])
def test_layout_from_rectangle_keeps_every_entry_in_lane_order(shape,
                                                               sigma):
    """Each row's lanes up to its last nonzero one, in lane order, zeros
    inside a row kept; the rectangle of an interface operator (rows ×
    ghost slots, m < n) keeps its column bound."""
    rng = np.random.default_rng(11)
    n, m, width = {"square": (256, 256, 9), "ragged_n": (1001, 1001, 17),
                   "rectangle": (700, 123, 6)}[shape]
    vals = rng.standard_normal((n, width))
    cols = rng.integers(0, m, (n, width)).astype(np.int32)
    lens = rng.integers(0, width + 1, n)
    lens[:40] = 0                                   # a run of empty rows
    pad = np.arange(width)[None, :] >= lens[:, None]
    vals[pad], cols[pad] = 0.0, 0
    vals[5, 0] = 0.0                  # a stored zero inside a row is kept
    lens[5] = max(lens[5], 2)
    vals[5, 1] = 1.5
    op = sliced.slice_ell(torch.from_numpy(vals), torch.from_numpy(cols), m,
                          sigma=sigma)
    assert (op.nrows, op.ncols) == (n, m)
    got = _rows_of(op)
    for i in range(n):
        keep = int(np.flatnonzero(vals[i])[-1]) + 1 if vals[i].any() else 0
        want = list(zip(cols[i, :keep].tolist(), vals[i, :keep].tolist()))
        assert got[i] == want
    rowlen = np.array([len(got[i]) for i in range(n)])
    _check_shape(op, rowlen)
    assert op.nnz == int(rowlen.sum())
    x = torch.from_numpy(rng.standard_normal(m))
    y = sliced.sliced_matvec(op, x)
    want = spmv.ell_matvec(torch.from_numpy(vals), torch.from_numpy(cols), x)
    assert y.shape == (n,)
    assert float((y - want).abs().max()) <= 1e-14 * float(want.abs().max())


def test_sigma_sorts_away_slice_padding():
    """Sorting rows by length inside windows of sigma rows leaves less
    padding than the given order, and the padding is exactly each slice's
    width times 32 less its entries."""
    A = tmesh.fem_delaunay_spd(3000, dim=3, seed=4)
    E = EllMatrix.from_csr(A)
    vals = torch.from_numpy(E.vals)
    cols = torch.from_numpy(E.colidx)
    fills = {}
    for sigma in (1, 64, 1024):
        op = sliced.slice_ell(vals, cols, A.ncols, sigma=sigma)
        lens = np.zeros(op.nrows, dtype=np.int64)
        lens[: A.nrows] = A.rowlens
        plen = np.zeros(op.nslices * WARP, dtype=np.int64)
        plen[: op.nrows] = lens[op.perm.numpy()]
        pad = int((plen.reshape(-1, WARP).max(1) * WARP).sum()) - A.nnz
        assert op.vals.numel() - op.nnz == pad
        fills[sigma] = op.fill
    assert fills[1] < fills[64] <= fills[1024]
    assert fills[1024] > 0.9 > A.nnz / E.vals.size   # the rectangle's fill


@pytest.mark.parametrize("mat_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("case", ["probe", "mesh_rcm", "ragged"])
def test_sliced_matvec_bit_equal_to_sgell_matvec(case, mat_dtype):
    dev = _pack(_MATRICES[case](), mat_dtype)
    assert dev.sliced.vals.dtype == dev.vals.dtype
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        dev.nrows_padded).astype(np.float32))
    want = sgell.sgell_matvec(dev.vals, dev.idx, dev.seg, dev.tile_start, x)
    for sigma in (1, 1024):
        op = sgell.slice_pack(dev.vals, dev.idx, dev.seg, dev.tile_start,
                              sigma=sigma)
        assert torch.equal(sliced.sliced_matvec(op, x), want)
    assert torch.equal(dev.matvec(x), want)


@pytest.mark.parametrize("vdt,mat", [("float32", None), ("float32", "bf16"),
                                     ("float64", None), ("float64", "bf16")])
def test_sliced_matvec_matches_ell_pallas_and_xla(vdt, mat):
    A = tmesh.fem_delaunay_spd(1200, dim=3, seed=5)
    E = EllMatrix.from_csr(A)
    vals = E.vals.astype(vdt)
    if mat == "bf16":                 # bf16-exact values: exact products
        vals = np.asarray(torch.from_numpy(vals).to(torch.bfloat16).float()
                          ).astype(vdt)
    dev = spmv.DeviceEll.from_ell(
        EllMatrix(E.nrows, E.ncols, vals, E.colidx, E.nnz, E.rowlens),
        dtype=vdt, device="cpu")
    assert dev.sliced.vals.dtype == dev.vals.dtype == (
        torch.bfloat16 if mat else getattr(torch, vdt))
    x = np.random.default_rng(6).standard_normal(dev.nrows_padded).astype(
        vdt)
    got = sliced.sliced_matvec(dev.sliced, torch.from_numpy(x)).numpy()
    plain = spmv.ell_matvec(dev.vals, dev.colidx, torch.from_numpy(x))
    jvals = jnp.asarray(vals)
    if mat:
        jvals = jvals.astype(jnp.bfloat16)
    pallas = np.asarray(ell_matvec_pallas(jvals, jnp.asarray(E.colidx),
                                          jnp.asarray(x), tile=8,
                                          interpret=True))
    xla = np.asarray(jspmv.ell_matvec(jvals, jnp.asarray(E.colidx),
                                      jnp.asarray(x)))
    rtol = 1e-14 if vdt == "float64" else 1e-6
    scale = np.abs(xla).max()
    for want in (plain.numpy(), pallas, xla):
        assert np.abs(got - want).max() <= rtol * scale


def _arrow(n=3000, long=2500, seed=4):
    """``_ragged``'s rows with row 7 replaced by one far longer than the
    rest (``long`` entries over the whole matrix: an arrow's row)."""
    A = _ragged(n, seed)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), A.rowlens)
    keep = rows != 7
    rows = np.concatenate([rows[keep], np.full(long, 7)])
    cols = np.concatenate([A.colidx[keep],
                           np.sort(rng.choice(n, long, replace=False))])
    vals = np.concatenate([A.vals[keep],
                           rng.standard_normal(long).astype(np.float32)])
    return tcsr.coo_to_csr(rows, cols, vals, n, n)


@pytest.mark.parametrize("source", ["pack", "rectangle"])
def test_sliced_matvec_on_one_long_row(source):
    """One row ~300x longer than the others: the plain product steps
    through that slice's width alone, and agrees with the pack's bits or
    the rectangle's sums and the JAX package's XLA ``ell_matvec``."""
    A = _arrow()
    x = np.random.default_rng(8).standard_normal(A.nrows).astype(
        np.float32)
    if source == "pack":
        dev = _pack(A)
        xt = torch.zeros(dev.nrows_padded)
        xt[: A.nrows] = torch.from_numpy(x)
        want = sgell.sgell_matvec(dev.vals, dev.idx, dev.seg,
                                  dev.tile_start, xt)
        got = sliced.sliced_matvec(dev.sliced, xt)
        assert torch.equal(got, want)
        got = got[: A.nrows].numpy()
    else:
        E = EllMatrix.from_csr(A)
        assert E.width == 2500
        dev = spmv.DeviceEll.from_ell(E, device="cpu")
        xt = torch.zeros(dev.nrows_padded)
        xt[: A.nrows] = torch.from_numpy(x)
        got = sliced.sliced_matvec(dev.sliced, xt)
        xla = np.asarray(jspmv.ell_matvec(jnp.asarray(E.vals),
                                          jnp.asarray(E.colidx),
                                          jnp.asarray(xt.numpy())))
        for want in (spmv.ell_matvec(dev.vals, dev.colidx, xt).numpy(),
                     xla):
            assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(
                want).max()
        got = got[: A.nrows].numpy()
    assert int(((dev.sliced.ptr[1:] - dev.sliced.ptr[:-1]) // WARP).max()) \
        == 2500
    ref = A.matvec(x.astype(np.float64))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("vdt", ["float32", "float64"])
def test_interface_rectangle_matches_jax(vdt):
    """A rectangular interface-shaped operator (border rows × ghost
    slots) against the JAX package's XLA ``ell_matvec`` on the same
    rectangle."""
    rng = np.random.default_rng(21)
    n, m, width = 333, 77, 5
    vals = rng.standard_normal((n, width)).astype(vdt)
    cols = rng.integers(0, m, (n, width)).astype(np.int32)
    vals[::3, 3:], cols[::3, 3:] = 0, 0
    x = rng.standard_normal(m).astype(vdt)
    op = sliced.slice_ell(torch.from_numpy(vals), torch.from_numpy(cols), m)
    got = spmv.ell_spmv(op, torch.from_numpy(x)).numpy()
    want = np.asarray(jspmv.ell_matvec(jnp.asarray(vals), jnp.asarray(cols),
                                       jnp.asarray(x)))
    rtol = 1e-14 if vdt == "float64" else 1e-6
    assert got.shape == (n,)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def test_slicing_refuses_entries_outside_the_matrix():
    rows = torch.tensor([0, 1, 2])
    vals = torch.ones(3)
    for cols, nrows, ncols in ((torch.tensor([0, 1, 5]), 3, 5),
                               (torch.tensor([0, -1, 2]), 3, 5),
                               (torch.tensor([0, 1, 2]), 2, 5)):
        with pytest.raises(AcgError) as e:
            sliced.slice_entries(rows, cols, vals, nrows, ncols)
        assert e.value.status == Status.ERR_INDEX_OUT_OF_BOUNDS
    op = sliced.slice_entries(rows, torch.tensor([4, 0, 0]), vals, 40, 5)
    assert op.nslices == 2 and op.nnz == 3


@pytest.mark.parametrize("tier,dtype,rtol", [("rcm+sgell", np.float32, 1e-5),
                                             ("ell", np.float64, 1e-10)])
def test_solves_on_the_sliced_layout_match_jax(jax_sgell_interpret, tier,
                                               dtype, rtol):
    Aj = jmesh.fem_delaunay_spd(2500, dim=3, seed=9)
    At = tmesh.fem_delaunay_spd(2500, dim=3, seed=9)
    xs, b = tcsr.manufactured_rhs(At, seed=4)
    steps = {}
    op = build_device_operator(At, dtype=dtype, device="cpu", timings=steps)
    assert "slice" in steps
    assert isinstance(getattr(op, "dev", op), (sgell.DeviceSgell,
                                               spmv.DeviceEll))
    o = dict(maxits=3000, residual_rtol=rtol)
    rj = jcg(Aj, b, options=JOptions(**o), dtype=dtype)
    rt = cg(op, b, options=SolverOptions(**o))
    assert (rt.operator_format, rj.operator_format) == (tier, tier)
    assert rt.converged and rj.converged
    assert abs(rt.niterations - rj.niterations) <= 1
    rel = 1e-8 if dtype == np.float64 else 1e-3
    assert np.linalg.norm(rt.x - np.asarray(rj.x)) <= rel * np.linalg.norm(
        np.asarray(rj.x))
    true = np.linalg.norm(b - At.matvec(rt.x.astype(np.float64)))
    assert true <= 10 * rtol * np.linalg.norm(b)
