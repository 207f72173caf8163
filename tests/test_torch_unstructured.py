"""Port parity for the unstructured tiers: RCM, the segmented-gather ELL
(sgell) pack and its SpMV, padded ELL and its SpMV, the rest of the
``fmt="auto"`` ladder (RCM+DIA, RCM+sgell, ELL), and whole solves on them,
on the CPU against the JAX package on the same inputs.

Inputs are made once with numpy seeds and handed to both packages: Delaunay
meshes of at most 3,000 points and a scrambled tridiagonal.  The JAX sgell
tier needs its TPU kernel, so it runs in Pallas interpret mode here
(``build_device_sgell`` forced to ``interpret=True``, as the JAX package's
own mesh tests do); its ELL tier runs XLA's gather off the TPU.

Tolerances, each with its reason:
- host arrays (RCM permutation, permuted matrix, pack, ELL rectangle):
  exact, the port copies the algorithms;
- the plain sgell SpMV against the Pallas interpret kernel: 1e-6
  relative to max|y| at f32 and bf16 values (both sum each row in slot
  order; XLA on the CPU may fuse a slot's product and sum into one
  multiply-add, which rounds once where the plain version rounds twice);
- the plain ELL SpMV against the Pallas interpret kernel and XLA's
  gather: 1e-6 relative at f32 (bf16 values are exact products, the row
  sums run in another order), 1e-14 at f64;
- whole solves: equal iteration counts at f64, within 1 at f32 (the dots
  sum in another order than XLA's); x within 1e-8 (f64) or 1e-3 (f32) of
  the JAX solution relative to its norm; the certified residual of the
  port's x, recomputed in float64 in the caller's ordering, within
  10 x rtol.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.ops import sgell as jsgell
from acg_tpu.ops import spmv as jspmv
from acg_tpu.ops.pallas_spmv import ell_matvec_pallas
from acg_tpu.solvers.cg import PermutedOperator as JPermutedOperator
from acg_tpu.solvers.cg import build_device_operator as jbuild
from acg_tpu.solvers.cg import cg as jcg
from acg_tpu.solvers.cg import cg_pipelined as jcg_pipelined
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import ell as jell
from acg_tpu.sparse import mesh as jmesh
from acg_tpu.sparse import rcm as jrcm

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, write_mtx
from acg_torch.ops import sgell, sliced, spmv
from acg_torch.ops.dia import DeviceDia
from acg_torch.solvers.cg import (PermutedOperator, build_device_operator,
                                  cg, cg_pipelined)
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import mesh as tmesh
from acg_torch.sparse import rcm as trcm
from acg_torch.sparse.ell import EllMatrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_sgell_interpret(monkeypatch):
    """The JAX sgell tier in Pallas interpret mode (its TPU kernel cannot
    run here): the builder and the forced-tier gate skip the probe."""
    build, require = jsgell.build_device_sgell, jsgell.sgell_require_available

    def forced_build(A, dtype=None, mat_dtype="auto",
                     min_fill=jsgell.MIN_FILL, interpret=False,
                     _probing=False):
        return build(A, dtype=dtype, mat_dtype=mat_dtype, min_fill=min_fill,
                     interpret=True)

    monkeypatch.setattr(jsgell, "build_device_sgell", forced_build)
    monkeypatch.setattr(jsgell, "sgell_require_available",
                        lambda vdt, interpret=False: require(vdt, True))


def _meshes(n=2000, dim=2, seed=7, dtype=np.float64):
    """(JAX matrix, port matrix) of one shuffled Delaunay mesh."""
    Aj = jmesh.fem_delaunay_spd(n, dim=dim, seed=seed, dtype=dtype)
    At = tmesh.fem_delaunay_spd(n, dim=dim, seed=seed, dtype=dtype)
    return Aj, At


def _tridiags(n=400, seed=7):
    """An SPD tridiagonal under a random symmetric scramble (the JAX
    package's ``tests/test_dia.py`` case): its own ordering has no
    diagonal structure, RCM recovers the band."""
    i = np.arange(n - 1)
    r = np.r_[np.arange(n), i, i + 1]
    c = np.r_[np.arange(n), i + 1, i]
    v = np.r_[np.full(n, 4.0), np.full(n - 1, -1.0), np.full(n - 1, -1.0)]
    scramble = np.random.default_rng(seed).permutation(n)
    Aj = jrcm.permute_symmetric(jcsr.coo_to_csr(r, c, v, n, n), scramble)
    At = trcm.permute_symmetric(tcsr.coo_to_csr(r, c, v, n, n), scramble)
    return Aj, At


def _assert_same_csr(Aj, At):
    assert (At.nrows, At.ncols) == (Aj.nrows, Aj.ncols)
    np.testing.assert_array_equal(At.rowptr, Aj.rowptr)
    np.testing.assert_array_equal(At.colidx, Aj.colidx)
    np.testing.assert_array_equal(At.vals, Aj.vals)
    assert At.vals.dtype == Aj.vals.dtype


# ---------------------------------------------------------------------------
# host modules: mesh, RCM, ELL, the sgell pack


@pytest.mark.parametrize("dim", [2, 3])
def test_mesh_generators_match_jax(dim):
    _assert_same_csr(*_meshes(1500, dim=dim, seed=3))
    _assert_same_csr(jmesh.poisson3d_7pt_aniso(5, 6, 7),
                     tmesh.poisson3d_7pt_aniso(5, 6, 7))


@pytest.mark.parametrize("case", ["mesh2d", "mesh3d", "tridiag"])
def test_rcm_and_permutation_match_jax(case):
    Aj, At = (_tridiags() if case == "tridiag" else
              _meshes(1500, dim=2 if case == "mesh2d" else 3))
    perm_j = jrcm.rcm_order(Aj)
    perm_t = trcm.rcm_order(At)
    np.testing.assert_array_equal(perm_t, perm_j)
    assert np.array_equal(np.sort(perm_t), np.arange(At.nrows))
    Pj, Pt = jrcm.permute_symmetric(Aj, perm_j), trcm.permute_symmetric(
        At, perm_t)
    _assert_same_csr(Pj, Pt)
    assert trcm.bandwidth(Pt) == jrcm.bandwidth(Pj) < trcm.bandwidth(At)


def test_ell_from_csr_matches_jax():
    Aj, At = _meshes(1000, dim=2, seed=4)
    Ej, Et = jell.EllMatrix.from_csr(Aj), EllMatrix.from_csr(At)
    assert (Et.nrows_padded, Et.width) == (Ej.nrows_padded, Ej.width)
    assert Et.nrows_padded % 8 == 0 and Et.nrows_padded >= At.nrows
    for name in ("vals", "colidx", "rowlens"):
        np.testing.assert_array_equal(getattr(Et, name), getattr(Ej, name))
    back = Et.to_csr()
    _assert_same_csr(Aj, back)
    x = np.random.default_rng(0).standard_normal(At.nrows)
    np.testing.assert_allclose(Et.matvec(x), At.matvec(x), rtol=1e-13,
                               atol=1e-13)


def _probe_like_matrix(seed=0):
    """Four 1024-row tiles of local random sparsity with tile 2 left
    empty (the JAX package's sgell probe workload): the forced one-slot
    zero tile, segments spread over the tile neighbourhood."""
    rng = np.random.default_rng(seed)
    n, W = 4 * sgell.TILE, 6
    rows = np.repeat(np.arange(n), W)
    cols = np.clip(rows + rng.integers(-500, 501, size=n * W), 0, n - 1)
    keep = (rows // sgell.TILE) != 2
    rows, cols = rows[keep], cols[keep]
    uniq = np.unique(rows * np.int64(n) + cols)
    rows, cols = uniq // n, uniq % n
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return (jcsr.coo_to_csr(rows, cols, vals, n, n),
            tcsr.coo_to_csr(rows, cols, vals, n, n))


@pytest.mark.parametrize("case", ["probe", "mesh_rcm", "tridiag"])
@pytest.mark.parametrize("min_fill", [0.0, 0.9])
def test_pack_matches_jax(case, min_fill):
    if case == "probe":
        Aj, At = _probe_like_matrix()
    elif case == "tridiag":
        Aj, At = _tridiags(3000)
    else:
        Aj, At = _meshes(3000, dim=2)
        perm = trcm.rcm_order(At)
        Aj = jrcm.permute_symmetric(Aj, perm)
        At = trcm.permute_symmetric(At, perm)
    pj = jsgell.pack_csr(Aj, np.float32, min_fill=min_fill)
    pt = sgell.pack_csr(At, np.float32, min_fill=min_fill)
    for k in ("S", "ntiles", "n_pad", "fill"):
        assert pt[k] == pj[k], k
    if pj["vals"] is None:
        assert pt["vals"] is None and min_fill > pt["fill"]
        return
    for k in ("vals", "idx", "seg", "tile", "first"):
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
        assert pt[k].dtype == pj[k].dtype, k
    start = sgell.tile_starts(pt["first"])
    assert start.dtype == np.int32 and len(start) == pt["ntiles"] + 1
    np.testing.assert_array_equal(
        start, np.searchsorted(pt["tile"], np.arange(pt["ntiles"] + 1)))


# ---------------------------------------------------------------------------
# the SpMVs' plain versions against the TPU kernels in interpret mode


def _device_sgell(At, mat_dtype):
    dev = sgell.build_device_sgell(At, dtype=np.float32, mat_dtype=mat_dtype,
                                   min_fill=0.0, device="cpu")
    assert dev is not None
    return dev


@pytest.mark.parametrize("case", ["probe", "mesh_rcm"])
@pytest.mark.parametrize("mat_dtype", [None, "bfloat16"])
def test_sgell_matvec_matches_pallas_interpret(case, mat_dtype):
    _, At = _probe_like_matrix() if case == "probe" else _meshes(3000)
    if case == "mesh_rcm":
        At = trcm.permute_symmetric(At, trcm.rcm_order(At))
    dev = _device_sgell(At, mat_dtype)       # values cast to f32 (or bf16)
    assert dev.idx.dtype == torch.int8          # lane indices < 128
    assert dev.vals.dtype == (torch.float32 if mat_dtype is None
                              else torch.bfloat16)
    x = np.zeros(dev.nrows_padded, dtype=np.float32)
    x[: At.nrows] = np.random.default_rng(2).standard_normal(At.nrows)
    before = sgell.launches
    got = dev.matvec(torch.from_numpy(x))
    assert sgell.launches == before               # the CPU runs no kernel
    # the JAX kernel's per-slot tile table, from the port's slot ranges
    start = dev.tile_start.numpy()
    tile = np.repeat(np.arange(dev.ntiles, dtype=np.int32), np.diff(start))
    first = np.zeros(dev.S, dtype=np.int32)
    first[start[:-1]] = 1
    want = jsgell.sgell_matvec_pallas(
        jnp.asarray(dev.vals.float().numpy()),
        jnp.asarray(dev.idx.numpy().astype(np.int32)),
        jnp.asarray(dev.seg.numpy()), jnp.asarray(tile),
        jnp.asarray(first), jnp.asarray(x), S=dev.S,
        ntiles=dev.ntiles, interpret=True)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # against the host matrix at the stored values
    ref = At.matvec(x[: At.nrows].astype(np.float64))
    scale = np.abs(ref).max()
    tol = 1e-5 if mat_dtype is None else 2e-2   # bf16 rounds the values
    assert np.abs(got.numpy()[: At.nrows] - ref).max() <= tol * scale
    assert torch.all(got[At.nrows:] == 0)


@pytest.mark.parametrize("vdt,mat", [("float32", None), ("float32", "bf16"),
                                     ("float64", None)])
def test_ell_matvec_matches_pallas_and_xla(vdt, mat):
    Aj, At = _meshes(1200, dim=3, seed=5)
    E = EllMatrix.from_csr(At)
    vals = E.vals.astype(vdt)
    if mat == "bf16":                 # bf16-exact values: exact products
        vals = np.asarray(torch.from_numpy(vals).to(torch.bfloat16).float())
    dev = spmv.DeviceEll.from_ell(
        EllMatrix(E.nrows, E.ncols, vals, E.colidx, E.nnz, E.rowlens),
        dtype=vdt, device="cpu")
    assert dev.vals.dtype == (torch.bfloat16 if mat else getattr(torch, vdt))
    assert (dev.width, dev.nrows_padded) == (E.width, E.nrows_padded)
    x = np.random.default_rng(6).standard_normal(dev.nrows_padded).astype(
        vdt)
    before = spmv.launches
    got = dev.matvec(torch.from_numpy(x)).numpy()
    assert spmv.launches == before
    jvals = jnp.asarray(dev.vals.float().numpy() if mat else vals)
    if mat:
        jvals = jvals.astype(jnp.bfloat16)
    pallas = np.asarray(ell_matvec_pallas(jvals, jnp.asarray(E.colidx),
                                          jnp.asarray(x), tile=8,
                                          interpret=True))
    xla = np.asarray(jspmv.ell_matvec(jvals, jnp.asarray(E.colidx),
                                      jnp.asarray(x)))
    rtol = 1e-14 if vdt == "float64" else 1e-6
    scale = np.abs(xla).max()
    assert np.abs(got - pallas).max() <= rtol * scale
    assert np.abs(got - xla).max() <= rtol * scale


def test_batched_matvecs_are_the_one_system_rows():
    """A (B, n) x runs the one-system SpMV once per system (as the JAX
    package's sgell vmap does), so each row has exactly its bits."""
    _, At = _meshes(1500)
    A32 = tcsr.CsrMatrix(At.nrows, At.ncols, At.rowptr, At.colidx,
                         At.vals.astype(np.float32))
    ops = [_device_sgell(A32, None),
           spmv.DeviceEll.from_ell(EllMatrix.from_csr(At), device="cpu")]
    for op in ops:
        vdt = getattr(torch, op.vec_dtype)
        X = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (3, op.nrows_padded))).to(vdt)
        Y, d = op.matvec_dot(X)
        for s in range(3):
            y1, d1 = op.matvec_dot(X[s])
            assert torch.equal(Y[s], y1) and torch.equal(d[s], d1)


def test_wrappers_on_the_cpu_take_no_kernel_checks():
    """On a CPU tensor each wrapper IS the plain version of the sliced
    product, with the bits of the sgell pack's plain version and within
    rounding of the ELL rectangle's."""
    _, At = _probe_like_matrix()
    dev = _device_sgell(At, None)
    x = torch.randn(dev.nrows_padded)
    before = (sgell.launches, spmv.launches)
    y = sgell.sgell_spmv(dev.sliced, x)
    assert torch.equal(y, sliced.sliced_matvec(dev.sliced, x))
    assert torch.equal(y, sgell.sgell_matvec(dev.vals, dev.idx, dev.seg,
                                             dev.tile_start, x))
    E = spmv.DeviceEll.from_ell(EllMatrix.from_csr(At), device="cpu")
    x = torch.randn(E.nrows_padded)
    y = spmv.ell_spmv(E.sliced, x)
    assert torch.equal(y, sliced.sliced_matvec(E.sliced, x))
    want = spmv.ell_matvec(E.vals, E.colidx, x)
    assert float((y - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert (sgell.launches, spmv.launches) == before


def test_operator_properties_match_jax(jax_sgell_interpret):
    Aj, At = _probe_like_matrix()
    jdev = jsgell.build_device_sgell(Aj, min_fill=0.0)
    tdev = _device_sgell(At, "auto")
    assert (tdev.S, tdev.ntiles, tdev.nrows_padded, tdev.nnz) == (
        jdev.S, jdev.ntiles, jdev.nrows_padded, jdev.nnz)
    assert tdev.fill == pytest.approx(jdev.fill, rel=1e-15)
    # the pack's own bytes, int8 lane indices: S*1024*(4+1), the segments
    # and the tile table
    S, nt = tdev.S, tdev.ntiles
    assert tdev.padded_bytes() == (S * 1024 * 5 + S * 8 * 4 + (nt + 1) * 4)
    # what the kernel streams: the sliced layout, far below the pack
    assert tdev.operator_stream_bytes() == tdev.sliced.stream_bytes()
    assert tdev.operator_stream_bytes() < tdev.padded_bytes() / 2
    Ej, Et = jell.EllMatrix.from_csr(Aj), EllMatrix.from_csr(At)
    je = jspmv.DeviceEll.from_ell(Ej)
    te = spmv.DeviceEll.from_ell(Et, device="cpu")
    assert te.padded_bytes() == je.operator_stream_bytes()
    assert te.operator_stream_bytes() == te.sliced.stream_bytes()
    assert (te.width, te.nrows_padded) == (je.width, je.nrows_padded)


# ---------------------------------------------------------------------------
# the fmt="auto" ladder and the forced tiers


def _jax_tier(dev):
    inner = dev.dev if isinstance(dev, JPermutedOperator) else dev
    name = {"DeviceSgell": "sgell", "DeviceEll": "ell",
            "DeviceDia": "dia"}[type(inner).__name__]
    return ("rcm+" if inner is not dev else "") + name


def _port_tier(dev):
    inner = dev.dev if isinstance(dev, PermutedOperator) else dev
    name = {sgell.DeviceSgell: "sgell", spmv.DeviceEll: "ell",
            DeviceDia: "dia"}[type(inner)]
    return ("rcm+" if inner is not dev else "") + name


@pytest.mark.parametrize("case,dtype,want", [
    ("mesh2d", np.float32, "rcm+sgell"),
    ("mesh2d", np.float64, "ell"),
    ("tridiag", np.float64, "rcm+dia"),
    ("tridiag", np.float32, "rcm+dia"),
])
def test_auto_routing_matches_jax(jax_sgell_interpret, case, dtype, want):
    Aj, At = _meshes(3000) if case == "mesh2d" else _tridiags()
    jdev = jbuild(Aj, dtype=dtype, fmt="auto")
    steps = {}
    tdev = build_device_operator(At, dtype=dtype, fmt="auto", device="cpu",
                                 timings=steps)
    assert _port_tier(tdev) == _jax_tier(jdev) == want
    assert {"rcm", "permute", "dia_check"} <= set(steps)
    assert all(v >= 0 for v in steps.values())
    if want.startswith("rcm+"):
        np.testing.assert_array_equal(tdev.perm, jdev.perm)
        assert tdev.nrows_padded == jdev.nrows_padded
    if want == "rcm+sgell":
        assert tdev.fill == pytest.approx(jdev.dev.fill, rel=1e-15)
        assert tdev.fill >= sgell.MIN_FILL
        assert {"pack", "upload", "slice"} <= set(steps)
    if want == "ell":
        assert {"ell_build", "upload", "slice"} <= set(steps)


@pytest.mark.parametrize("fmt,dtype", [("ell", np.float32),
                                       ("ell", np.float64),
                                       ("sgell", np.float32)])
def test_forced_tiers_match_jax(jax_sgell_interpret, fmt, dtype):
    Aj, At = _meshes(1500)
    jdev = jbuild(Aj, dtype=dtype, fmt=fmt)
    tdev = build_device_operator(At, dtype=dtype, fmt=fmt, device="cpu")
    assert _port_tier(tdev) == _jax_tier(jdev) == fmt  # the given ordering
    assert tdev.nrows_padded == jdev.nrows_padded
    b = np.random.default_rng(3).standard_normal(At.nrows)
    o = dict(maxits=3000, residual_rtol=1e-5 if dtype == np.float32
             else 1e-10)
    rj = jcg(Aj, b, options=JOptions(**o), dtype=dtype, fmt=fmt)
    rt = cg(At, b, options=SolverOptions(**o), dtype=dtype, fmt=fmt,
            device="cpu")
    assert (rt.operator_format, rj.operator_format) == (fmt, fmt)
    assert rt.kernel_note == rj.kernel_note == f"format forced: {fmt}"
    assert abs(rt.niterations - rj.niterations) <= (
        1 if dtype == np.float32 else 0)


def test_forced_sgell_at_f64_raises_as_jax(jax_sgell_interpret):
    Aj, At = _meshes(800)
    with pytest.raises(JAcgError) as ej:
        jbuild(Aj, dtype=np.float64, fmt="sgell")
    with pytest.raises(AcgError, match="format 'sgell' does not support "
                                       "vector dtype float64") as et:
        build_device_operator(At, dtype=np.float64, fmt="sgell",
                              device="cpu")
    assert int(et.value.status) == int(ej.value.status) == int(
        Status.ERR_NOT_SUPPORTED)
    with pytest.raises(AcgError, match="unknown operator format"):
        build_device_operator(At, fmt="csr", device="cpu")


def test_host_ell_and_dia_inputs_route_as_jax():
    """An EllMatrix always gives ELL; a DiaMatrix gives DIA whatever the
    stored-tier format asks (the JAX package's ladder)."""
    from acg_torch.ops.dia import DiaMatrix
    from acg_torch.sparse.poisson import poisson3d_7pt_varcoef

    _, At = _meshes(500)
    op = build_device_operator(EllMatrix.from_csr(At), fmt="dia",
                               device="cpu")
    assert isinstance(op, spmv.DeviceEll)
    D = DiaMatrix.from_csr(poisson3d_7pt_varcoef(4))
    for fmt in ("ell", "sgell", "dia"):
        assert isinstance(build_device_operator(D, fmt=fmt, device="cpu"),
                          DeviceDia)


# ---------------------------------------------------------------------------
# whole solves


_CASES = {
    "rcm+sgell": (lambda: _meshes(3000), np.float32, 1e-5),
    "ell": (lambda: _meshes(3000), np.float64, 1e-10),
    "rcm+dia": (lambda: _tridiags(400), np.float64, 1e-10),
}


def _true_rel(A, x, b):
    x = np.asarray(x, dtype=np.float64)
    return np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("tier", list(_CASES))
def test_solves_match_jax(jax_sgell_interpret, tier, pipelined):
    make, dtype, rtol = _CASES[tier]
    Aj, At = make()
    xs, b = tcsr.manufactured_rhs(At, seed=8)
    o = dict(maxits=3000, residual_rtol=rtol)
    jsolve = jcg_pipelined if pipelined else jcg
    tsolve = cg_pipelined if pipelined else cg
    rj = jsolve(Aj, b, options=JOptions(**o), dtype=dtype)
    rt = tsolve(At, b, options=SolverOptions(**o), dtype=dtype,
                device="cpu")
    assert rt.converged and rj.converged
    assert (rt.operator_format, rt.kernel, rt.kernel_note) == (
        tier, "torch-plain", "")
    assert rj.operator_format == tier
    if dtype == np.float64:
        assert rt.niterations == rj.niterations
    else:
        assert abs(rt.niterations - rj.niterations) <= 1
    # x comes back in the caller's ordering
    assert rt.x.shape == (At.nrows,) and rt.x.dtype == dtype
    rel = 1e-8 if dtype == np.float64 else 1e-3
    assert np.linalg.norm(rt.x - np.asarray(rj.x)) <= rel * np.linalg.norm(
        np.asarray(rj.x))
    assert _true_rel(At, rt.x, b) <= 10 * rtol
    # a prebuilt operator passed back in (the CLI's path): the same bits
    op = build_device_operator(At, dtype=dtype, device="cpu")
    assert _port_tier(op) == tier
    again = tsolve(op, b, options=SolverOptions(**o))
    assert again.niterations == rt.niterations
    np.testing.assert_array_equal(again.x, rt.x)
    assert again.operator_format == tier


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("tier", list(_CASES))
def test_batched_solves_match_jax(jax_sgell_interpret, tier, pipelined):
    make, dtype, rtol = _CASES[tier]
    Aj, At = make()
    bb = np.stack([tcsr.manufactured_rhs(At, seed=s)[1] for s in range(3)])
    o = dict(maxits=3000, residual_rtol=rtol)
    jsolve = jcg_pipelined if pipelined else jcg
    tsolve = cg_pipelined if pipelined else cg
    rj = jsolve(Aj, bb, options=JOptions(**o), dtype=dtype)
    op = build_device_operator(At, dtype=dtype, device="cpu")
    rt = tsolve(op, bb, options=SolverOptions(**o))
    assert rt.nrhs == 3 and rt.x.shape == bb.shape
    assert rt.operator_format == tier and all(rt.converged_per_system)
    kt = np.asarray(rt.iterations_per_system)
    kj = np.asarray(rj.iterations_per_system)
    assert np.all(np.abs(kt - kj) <= (1 if dtype == np.float32 else 0))
    for s in range(3):
        one = tsolve(op, bb[s], options=SolverOptions(**o))
        # one-system kernels per system: every system is its own solve
        assert one.niterations == kt[s]
        np.testing.assert_array_equal(one.x, rt.x[s])
        assert _true_rel(At, rt.x[s], bb[s]) <= 10 * rtol


def test_f32_pipelined_drift_matches_jax(jax_sgell_interpret):
    """Near the f32 floor (rtol 1e-6 on a 3-D mesh) pipelined CG needs
    several more iterations than classic CG, because its recurred
    residual drifts and certification refuses exit candidates: the JAX
    package's own solvers show it, and the port's counts follow them."""
    Aj, At = _meshes(1500, dim=3, seed=0)
    _, b = tcsr.manufactured_rhs(At, seed=1)
    o = dict(maxits=3000, residual_rtol=1e-6)
    kj = [s(Aj, b, options=JOptions(**o), dtype=np.float32).niterations
          for s in (jcg, jcg_pipelined)]
    kt = [s(At, b, options=SolverOptions(**o), dtype=np.float32,
            device="cpu").niterations for s in (cg, cg_pipelined)]
    assert kj[1] >= kj[0] + 4
    assert all(abs(t - j) <= 1 for t, j in zip(kt, kj))


def test_sgell_solve_on_a_bf16_exact_operator():
    """bf16-exact values (a randomly permuted 3-D Poisson operator):
    auto narrows the pack to bf16 and the solve is unchanged."""
    from acg_torch.sparse.poisson import poisson3d_7pt

    A = poisson3d_7pt(10, dtype=np.float32)
    perm = np.random.default_rng(4).permutation(A.nrows)
    A = trcm.permute_symmetric(A, perm)
    b = np.random.default_rng(5).standard_normal(A.nrows).astype(np.float32)
    o = SolverOptions(maxits=500, residual_rtol=1e-5)
    narrow = build_device_operator(A, fmt="sgell", device="cpu")
    wide = build_device_operator(A, fmt="sgell", mat_dtype=None,
                                 device="cpu")
    assert narrow.vals.dtype == torch.bfloat16
    assert wide.vals.dtype == torch.float32
    r1, r2 = cg(narrow, b, options=o), cg(wide, b, options=o)
    assert r1.niterations == r2.niterations
    np.testing.assert_array_equal(r1.x, r2.x)


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def mesh_file(tmp_path_factory):
    A = tmesh.fem_delaunay_spd(2000, dim=3, seed=2)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("cli") / "mesh.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def _iterations(stdout):
    its = [ln for ln in stdout.splitlines()
           if ln.strip().startswith("iterations:")]
    assert len(its) == 1, stdout
    return int(its[0].split(":")[1])


@pytest.mark.parametrize("fmt,dtype,tier", [
    ("ell", "float64", "ell"), ("sgell", "float32", "sgell"),
    ("auto", "float32", "rcm+sgell"), ("auto", "float64", "ell")])
def test_cli_unstructured_formats(mesh_file, fmt, dtype, tier):
    r = _cli("acg_torch.cli", mesh_file, "--device", "cpu", "--format", fmt,
             "--dtype", dtype, "--manufactured-solution",
             "--residual-rtol", "1e-5" if dtype == "float32" else "1e-9",
             "--max-iterations", "1000", "-q", "-v")
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"operator format: {tier}\n" in r.stdout
    note = "" if fmt == "auto" else f" (format forced: {fmt})"
    assert f"kernel: torch-plain{note}\n" in r.stdout
    assert "floating-point exceptions: none" in r.stdout
    assert "ell_spmv 0, sgell_spmv 0" in r.stderr
    if tier.startswith("rcm+"):
        assert "in an RCM ordering" in r.stderr and "; rcm " in r.stderr
    if fmt == "ell":
        ref = _cli("acg_tpu.cli", mesh_file, "--format", fmt, "--dtype",
                   dtype, "--manufactured-solution", "--residual-rtol",
                   "1e-9", "--max-iterations", "1000", "-q")
        assert ref.returncode == 0, ref.stdout + ref.stderr
        assert _iterations(r.stdout) == _iterations(ref.stdout)


def test_cli_sgell_at_f64_exits_1(mesh_file):
    r = _cli("acg_torch.cli", mesh_file, "--device", "cpu", "--format",
             "sgell", "-q")
    assert r.returncode == 1
    assert "does not support vector dtype float64" in r.stderr
    assert "Traceback" not in r.stderr
