"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip elsewhere.  They cover what
``chip_smoke.py`` does not: small and ragged sizes, 1-D/2-D grids and
the 27-point stencil, offsets that leave the vector, every band tier,
the multi-RHS kernels at B in {1, 2, 3, 5, 8, 9, 16} (chunk tails),
grids of fewer than 8 and an odd number of blocks, x off a 16-byte
boundary, two k-steps a block, the
shared-memory ring and clustered-window kernels of the HBM tier (every
band tier, ragged n, spans of several tiles, offsets past the vector,
x off a 16-byte boundary; y bit-equal to dia_spmv), the
wrappers' argument checks and launch counts, whole classic,
pipelined and batched solves on the card against the same solves on
the CPU, and for the s-step and deep-pipelined solvers the f32 Gram
never in TF32, the basis's padding rows staying 0 through every SpMV
tier, and s-step, deep and recycled solves against the CPU's.  The JAX
package is not needed (and not on the machine with the card), so run
them without the repository's root conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError
from acg_torch.ops import dia_kernels
from acg_torch.ops import stencil as st
from acg_torch.ops.dia import DeviceDia, DiaMatrix
from acg_torch.ops.dia_kernels import dia_matvec, dia_spmv
from acg_torch.parallel.mesh import make_mesh
from acg_torch.solvers.cg import cg, cg_pipelined
from acg_torch.sparse import poisson

pytestmark = pytest.mark.cuda

_TOL = {torch.float64: (1e-12, 0.0, 1e-10),
        torch.float32: (1e-5, 1e-5, 1e-4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _check(got, want, x, dtype):
    rtol, atol, dot_rtol = _TOL[dtype]
    y, d = got
    yw, dw = want
    err = float((y - yw).abs().max())
    assert err <= atol + rtol * float(yw.abs().max())
    scale = float(torch.linalg.norm(x) * torch.linalg.norm(yw))
    assert abs(float(d) - float(dw)) <= dot_rtol * scale


def _random_dia(n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            bands[d, max(n - off, 0):] = 0.0
        elif off < 0:
            bands[d, : min(-off, n)] = 0.0
    return DiaMatrix(n, n, tuple(offsets), bands, int((bands != 0).sum()))


@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", "int8", None, "float32"])
@pytest.mark.parametrize("n,offsets", [
    (8, (-3, 0, 5)),
    (1000, (-300, -1, 0, 1, 999)),
    (4099, (-2048, -129, -1, 0, 1, 129, 2048, 5000)),
])
def test_dia_spmv_matches_plain(card, n, offsets, mat, vdt):
    D = _random_dia(n, offsets)
    if mat in ("auto", "int8"):
        D = DiaMatrix(n, n, D.offsets, np.sign(D.bands) * 0.5, D.nnz)
    if mat == "int8":
        D = DiaMatrix(n, n, D.offsets, np.abs(D.bands), D.nnz)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    x = torch.randn(n, dtype=getattr(torch, vdt), device=card)
    before = dia_kernels.launches
    got = dia_spmv(dev.bands, dev.scales, dev.offsets_t, x, with_dot=True)
    assert dia_kernels.launches == before + 1
    y = dia_matvec(dev.bands, dev.offsets, x, dev.scales)
    _check(got, (y, torch.dot(x, y)), x, x.dtype)
    assert torch.equal(dev.matvec(x), got[0])
    again = dia_spmv(dev.bands, dev.scales, dev.offsets_t, x, with_dot=True)
    assert torch.equal(again[1], got[1])            # no atomics: same bits


def _tiered(D, mat):
    """Bands that the tier ``mat`` stores (bf16-exact for "auto",
    two-valued for "int8")."""
    n = D.nrows
    if mat in ("auto", "int8"):
        D = DiaMatrix(n, n, D.offsets, np.sign(D.bands) * 0.5, D.nnz)
    if mat == "int8":
        D = DiaMatrix(n, n, D.offsets, np.abs(D.bands), D.nnz)
    return D


_O27 = tuple(sorted(a * 100 + b * 10 + c for a in (-1, 0, 1)
                    for b in (-1, 0, 1) for c in (-1, 0, 1)))


def _fixed_kernels(dev):
    """The kernels of dia_spmv a call on ``dev`` can take: the generic
    one, and the one with the band count fixed where it is compiled (f32
    vectors, 3, 5, 7 or 27 bands)."""
    from acg_torch.ops import dia_plan

    return (False,) + ((True,) if dev.vec_dtype == "float32" and len(
        dev.offsets) in dia_plan.FIXED_BANDS else ())


# the band counts the fixed kernel is compiled for (3, 5, 7, 27) and one
# it is not (4); n below one block, not a multiple of 256, and a band
# past the vector (every row then takes the generic body)
@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", "int8", None, "float32"])
@pytest.mark.parametrize("offsets", [
    (-1, 0, 1), (-33, -1, 0, 1, 33), (-1100, -33, -1, 0, 1, 33, 1100),
    _O27, (-2, 0, 1, 5)])
@pytest.mark.parametrize("n", [100, 5001, 70_001, "past"])
def test_dia_spmv_fixed_bands_equal_batched(card, n, offsets, mat, vdt):
    """Both kernels of dia_spmv keep its bits: y and the dot equal
    dia_spmv_batched's (which sums every row with the generic body) at
    B = 1, and the plain version within _TOL; the fixed kernel is refused
    where it is not compiled."""
    if n == "past":                                 # a band past the vector
        n, offsets = 900, offsets[:-1] + (offsets[-1] + 900,)
    D = _tiered(_random_dia(n, offsets, seed=len(offsets)), mat)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    x = torch.randn(n, dtype=getattr(torch, vdt), device=card)
    kernels = _fixed_kernels(dev)
    for with_dot in (True, False):
        one = dia_kernels.dia_spmv_batched(dev.bands, dev.scales,
                                           dev.offsets_t, x[None],
                                           with_dot=with_dot)
        for fixed in kernels:
            got = dia_spmv(dev.bands, dev.scales, dev.offsets_t, x,
                           with_dot=with_dot, fixed=fixed)
            if with_dot:
                assert torch.equal(got[0], one[0][0])
                assert torch.equal(got[1], one[1][0])
                y = dia_matvec(dev.bands, dev.offsets, x, dev.scales)
                _check(got, (y, torch.dot(x, y)), x, x.dtype)
            else:
                assert torch.equal(got, one[0])
    if len(kernels) == 1:
        with pytest.raises(AcgError):
            dia_spmv(dev.bands, dev.scales, dev.offsets_t, x, fixed=True)


@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", None])
@pytest.mark.parametrize("offsets", [(-70_000, -257, -1, 0, 1, 257, 70_000),
                                     _O27])
def test_dia_spmv_dot_bits_with_several_rows_a_thread(card, offsets, mat,
                                                      vdt):
    """Past 256 x 4096 rows every thread sums several rows into its dot
    (the 256^3 solves' shape): dia_spmv's y and dot, from either kernel,
    equal each system's of dia_spmv_batched at B = 8 (the generic row
    body, one multiply-add a row into the dot)."""
    n = 256 * 4096 * 2 + 777
    D = _tiered(_random_dia(n, offsets, seed=9), mat)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    X = torch.randn(8, n, dtype=getattr(torch, vdt), device=card)
    Y, d = dia_kernels.dia_spmv_batched(dev.bands, dev.scales,
                                        dev.offsets_t, X, with_dot=True)
    for fixed in _fixed_kernels(dev):
        for s in range(8):
            y, ds = dia_spmv(dev.bands, dev.scales, dev.offsets_t, X[s],
                             with_dot=True, fixed=fixed)
            assert torch.equal(Y[s], y) and torch.equal(d[s], ds)


@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen", [
    lambda: poisson.poisson2d_5pt(1, 37),
    lambda: poisson.poisson2d_5pt(13, 17),
    lambda: poisson.poisson3d_7pt(5, 6, 7),
    lambda: poisson.poisson3d_27pt(6),
])
def test_stencil_spmv_matches_plain(card, gen, vdt):
    spec, why = st.recognize_stencil(gen())
    assert spec is not None, why
    n = spec.nrows
    npad = -(-n // 8) * 8 + 8                       # padding past the grid
    x = torch.zeros(npad, dtype=vdt, device=card)
    x[:n] = torch.randn(n, dtype=vdt, device=card)
    before = st.launches
    got = st.stencil_spmv(spec, x, with_dot=True)
    assert st.launches == before + 1
    y = st.stencil_matvec(x, spec.grid, spec.digits, spec.coeffs)
    _check(got, (y, torch.dot(x, y)), x, vdt)
    assert torch.all(got[0][n:] == 0)
    assert torch.equal(st.stencil_spmv(spec, x), got[0])


def _one_sided_spec():
    """Five one-sided arms on a 6 x 7 x 8 grid (strides 56, 8, 1), built
    directly: the fixed 5-arm kernel in 3-D with no arm past +0."""
    digits = ((-1, -1, 0), (-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0))
    return st.StencilSpec(grid=(6, 7, 8), offsets=(-64, -56, -8, -1, 0),
                          digits=digits, coeffs=(0.5, -1.25, 2.0, 3.0, -0.75),
                          nnz=0)


# (grid generator, rows of padding past the grid)
_FIXED_CASES = {
    "13x14x15": (lambda: poisson.poisson3d_7pt(13, 14, 15), 0),
    "1x32x32": (lambda: poisson.poisson3d_7pt(1, 32, 32), 0),
    "27pt-9x10x11": (lambda: poisson.poisson3d_27pt(9, 10, 11), 0),
    "axis-of-2": (lambda: poisson.poisson3d_7pt(2, 9, 10), 0),
    "padded": (lambda: poisson.poisson3d_7pt(13, 14, 15), 14),
    "stride-wraps-every-axis": (lambda: poisson.poisson3d_7pt(101, 103, 107),
                                5),
    "smaller-than-one-stride": (lambda: poisson.poisson2d_5pt(5, 7), 3),
    "2d-5pt-4097x300": (lambda: poisson.poisson2d_5pt(4097, 300), 0),
    "one-sided-5": (_one_sided_spec, 2),
    "shard-256x128x128": (lambda: poisson.poisson3d_7pt_dia(256, 128, 128),
                          0),
}


@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(_FIXED_CASES))
def test_stencil_spmv_fixed_equals_generic(card, case, vdt):
    """The fixed-arm kernel gives y and the dot the generic kernel's bits
    (on several vectors: a last-bit difference shows on some and not
    others), the padding rows exactly 0, the plain version within _TOL;
    the plan takes it by default, DeviceStencil's products too."""
    gen, pad = _FIXED_CASES[case]
    spec = gen()
    if not isinstance(spec, st.StencilSpec):
        spec, why = st.recognize_stencil(spec)
        assert spec is not None, why
    assert st.fixed_arms(spec)
    n = spec.nrows
    gen_ = torch.Generator(device=card).manual_seed(len(case))
    for _ in range(3):
        x = torch.zeros(n + pad, dtype=vdt, device=card)
        x[:n] = torch.randn(n, generator=gen_, dtype=vdt, device=card)
        before = st.launches
        yf, df = st.stencil_spmv(spec, x, with_dot=True)
        yg, dg = st.stencil_spmv(spec, x, with_dot=True, fixed=False)
        assert st.launches == before + 2
        assert torch.equal(yf, yg) and torch.equal(df, dg)
        assert torch.equal(st.stencil_spmv(spec, x, fixed=True), yg)
        assert torch.all(yf[n:] == 0)
        y = st.stencil_matvec(x, spec.grid, spec.digits, spec.coeffs)
        _check((yf, df), (y, torch.dot(x, y)), x, vdt)
    assert st.route(spec) == f"fixed-{len(spec.offsets)}"
    dev = st.DeviceStencil.from_spec(spec, dtype=str(vdt)[6:], device=card)
    before = st.launches
    assert torch.equal(dev.matvec_dot(x)[1], df)
    assert st.launches == before + 1


def test_stencil_spmv_fixed_is_refused_off_its_arm_counts(card):
    """9 arms: the plan takes the generic kernel, and asking for the
    fixed one raises (no fallback)."""
    r, c, v, n = poisson._stencil_coo(
        (9, 10), [(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)
                  if (i, j) != (0, 0)], 8.0, [-1.0] * 8, np.float64)
    from acg_torch.sparse.csr import coo_to_csr

    spec, why = st.recognize_stencil(coo_to_csr(r, c, v, n, n))
    assert spec is not None and len(spec.offsets) == 9, why
    assert not st.fixed_arms(spec)
    x = torch.randn(n, dtype=torch.float64, device=card)
    y = st.stencil_spmv(spec, x)
    assert torch.equal(y, st.stencil_spmv(spec, x, fixed=False))
    with pytest.raises(AcgError):
        st.stencil_spmv(spec, x, fixed=True)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    D = _random_dia(64, (-1, 0, 1))
    dev = DeviceDia.from_dia(D, mat_dtype=None, device=card)
    x = torch.randn(64, dtype=torch.float64, device=card)
    with pytest.raises(AcgError):                   # half-precision vectors
        dia_spmv(dev.bands, None, dev.offsets_t, x.half())
    with pytest.raises(AcgError):                   # strided vector
        dia_spmv(dev.bands, None, dev.offsets_t,
                 torch.randn(128, dtype=torch.float64, device=card)[::2])
    with pytest.raises(AcgError):                   # int8 mask, no scales
        dia_spmv(dev.bands.to(torch.int8), None, dev.offsets_t, x)
    with pytest.raises(AcgError):                   # bands on the CPU
        dia_spmv(dev.bands.cpu(), None, dev.offsets_t, x)
    spec, _ = st.recognize_stencil(poisson.poisson2d_5pt(8))
    with pytest.raises(AcgError):                   # shorter than the grid
        st.stencil_spmv(spec, torch.zeros(32, dtype=torch.float64,
                                          device=card))


@pytest.mark.parametrize("fmt", ["auto", "dia"])
def test_cg_on_the_card_matches_cpu(card, fmt):
    A = poisson.poisson3d_7pt(12)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(A.nrows)
    o = SolverOptions(maxits=1000, residual_rtol=1e-10)
    rg = cg(A, b, options=o, fmt=fmt)               # default device: cuda
    rc = cg(A, b, options=o, fmt=fmt, device="cpu")
    assert rg.kernel == f"cuda-{rg.operator_format}-fused"
    assert rg.operator_format == ("stencil" if fmt == "auto" else "dia")
    assert abs(rg.niterations - rc.niterations) <= 1
    assert np.linalg.norm(rg.x - rc.x) <= 1e-8 * np.linalg.norm(rc.x)
    assert np.linalg.norm(b - A.matvec(rg.x)) <= 1e-9 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the pipelined-iteration kernels


def _pipe_inputs(n, npad, vdt, card, seed=0):
    """w, z, r, p, s, x (zero past n) and alpha, beta on the card."""
    g = torch.Generator(device=card).manual_seed(seed)
    vecs = []
    for _ in range(6):
        v = torch.zeros(npad, dtype=vdt, device=card)
        v[:n] = torch.randn(n, generator=g, dtype=vdt, device=card)
        vecs.append(v)
    return vecs, (torch.tensor(0.37, dtype=vdt, device=card),
                  torch.tensor(1.21, dtype=vdt, device=card))


def _check_pipe(run, plain, vecs, ab, n):
    """The kernel against its plain version: vectors at _TOL, gamma and
    delta relative to |r'|^2 and |w'|·|r'|, padding exactly 0, the
    in-place contract, and the same bits on a second run."""
    rtol, atol, dot_rtol = _TOL[vecs[0].dtype]
    want = plain(*vecs, *ab)
    ins = [v.clone() for v in vecs]
    got = run(*ins, *ab)
    again = run(*[v.clone() for v in vecs], *ab)
    torch.cuda.synchronize()
    for g, w in zip(got[:6], want[:6]):
        assert float((g - w).abs().max()) <= atol + rtol * float(
            w.abs().max())
        assert torch.all(g[n:] == 0)
    r2, w2 = want[4], want[5]
    assert abs(float(got[6]) - float(want[6])) <= dot_rtol * float(r2 @ r2)
    assert abs(float(got[7]) - float(want[7])) <= dot_rtol * float(
        torch.linalg.norm(w2) * torch.linalg.norm(r2))
    # z, p, s, x, r in place; w' in its own buffer
    w, z, r, p, s, x = ins
    assert [t.data_ptr() for t in got[:5]] == [t.data_ptr()
                                               for t in (z, p, s, x, r)]
    assert got[5].data_ptr() != w.data_ptr()
    for a, b in zip(got, again):
        assert torch.equal(a, b)                    # no atomics: same bits


@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", "int8", None, "float32"])
@pytest.mark.parametrize("n,offsets", [
    (8, (-3, 0, 5)),
    (1000, (-300, -1, 0, 1, 999)),
    (4099, (-2048, -129, -1, 0, 1, 129, 2048, 5000)),
])
def test_dia_pipe_matches_plain(card, n, offsets, mat, vdt):
    D = _random_dia(n, offsets)
    if mat in ("auto", "int8"):
        D = DiaMatrix(n, n, D.offsets, np.sign(D.bands) * 0.5, D.nnz)
    if mat == "int8":
        D = DiaMatrix(n, n, D.offsets, np.abs(D.bands), D.nnz)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    vecs, ab = _pipe_inputs(n, n, getattr(torch, vdt), card)
    before = dia_kernels.pipe_launches
    _check_pipe(dev.pipelined_iter,
                lambda *a: dia_kernels.cg_pipelined_iter_plain(
                    dev.bands, dev.scales, dev.offsets, *a),
                vecs, ab, n)
    assert dia_kernels.pipe_launches == before + 2


def _pipe_forced(dev, fixed):
    """cg_pipelined_iter on ``dev`` with the kernel ``fixed`` forced."""
    return lambda *a, **k: dia_kernels.cg_pipelined_iter(
        dev.bands, dev.scales, dev.offsets_t, *a, fixed=fixed, **k)


def _pipe_bits_equal(dev, vecs, ab):
    """The fixed and the generic kernel on copies of the same inputs:
    the six vectors, gamma and delta bit for bit."""
    outs = [_pipe_forced(dev, f)(*[v.clone() for v in vecs], *ab)
            for f in (False, True)]
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# the band counts the fixed kernel is compiled for, every band tier, both
# vector types; n below one block, not a multiple of 256, and every row
# within max|offset| of an end at n = 100 (the widest offsets then take
# the edge body on every row)
@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", "int8", None, "float32"])
@pytest.mark.parametrize("offsets", [
    (-1, 0, 1), (-33, -1, 0, 1, 33), (-1100, -33, -1, 0, 1, 33, 1100),
    _O27])
@pytest.mark.parametrize("n", [100, 5001, 70_001])
def test_dia_pipe_fixed_equals_generic(card, n, offsets, mat, vdt):
    """Both kernels of cg_pipelined_iter give the same bits, and the
    fixed one matches the plain version within _TOL (one launch a call:
    the counter adds one a call)."""
    D = _tiered(_random_dia(n, offsets, seed=len(offsets)), mat)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    vecs, ab = _pipe_inputs(n, n, getattr(torch, vdt), card, seed=3)
    _pipe_bits_equal(dev, vecs, ab)
    before = dia_kernels.pipe_launches
    _check_pipe(_pipe_forced(dev, True),
                lambda *a: dia_kernels.cg_pipelined_iter_plain(
                    dev.bands, dev.scales, dev.offsets, *a),
                vecs, ab, n)
    assert dia_kernels.pipe_launches == before + 2


@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", None])
@pytest.mark.parametrize("offsets", [(-70_000, -257, -1, 0, 1, 257, 70_000),
                                     _O27])
def test_dia_pipe_fixed_equals_generic_several_rows_a_thread(card, offsets,
                                                             mat, vdt):
    """Past 256 x 4096 rows every thread updates several rows and sums
    them into its gamma and delta partials (the 256^3 solves' shape):
    both kernels give the same bits."""
    n = 256 * 4096 * 2 + 777
    D = _tiered(_random_dia(n, offsets, seed=9), mat)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    vecs, ab = _pipe_inputs(n, n, getattr(torch, vdt), card, seed=4)
    _pipe_bits_equal(dev, vecs, ab)


def test_dia_pipe_fixed_is_refused_off_its_band_counts(card):
    """Four bands: the generic kernel runs, the fixed one raises (no
    fallback)."""
    n = 5001
    dev = DeviceDia.from_dia(_random_dia(n, (-2, 0, 1, 5)), dtype="float64",
                             mat_dtype=None, device=card)
    assert not dev.pipe_fixed
    vecs, ab = _pipe_inputs(n, n, torch.float64, card)
    _pipe_forced(dev, False)(*vecs, *ab)
    with pytest.raises(AcgError):
        _pipe_forced(dev, True)(*vecs, *ab)


def test_dia_pipe_one_launch_a_call(card):
    """Each call of cg_pipelined_iter, with either kernel, is one kernel
    on the card and no memset (torch.profiler), once its library and its
    stream's scratch exist."""
    from torch.profiler import ProfilerActivity, profile

    n = 70_001
    dev = DeviceDia.from_dia(_random_dia(n, (-1100, -33, -1, 0, 1, 33,
                                             1100)),
                             dtype="float32", mat_dtype=None, device=card)
    vecs, ab = _pipe_inputs(n, n, torch.float32, card)
    w_out = torch.empty_like(vecs[0])
    for fixed in (False, True):
        run = _pipe_forced(dev, fixed)
        run(*vecs, *ab, w_out=w_out)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                run(*vecs, *ab, w_out=w_out)
            torch.cuda.synchronize()
        on_card = [(e.key, e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        assert sum(c for _, c in on_card) == 2, on_card
        assert all("dia_pipe" in k for k, _ in on_card), on_card


def test_dia_pipe_counter_back_at_zero_on_two_streams(card):
    """Calls on two streams of their own give the default stream's bits,
    and each stream's ticket counter is back at 0 after them."""
    n = 70_001
    dev = DeviceDia.from_dia(_random_dia(n, (-1, 0, 1)), dtype="float32",
                             mat_dtype=None, device=card)
    vecs, ab = _pipe_inputs(n, n, torch.float32, card)
    inputs = [[v.clone() for v in vecs] for _ in range(2)]
    want = dev.pipelined_iter(*[v.clone() for v in vecs], *ab)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st, ins in zip(streams, inputs):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(dev.pipelined_iter(*ins, *ab))
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    for st in streams:
        counter, _ = dia_kernels._pipe_scratch[(vecs[0].device.index,
                                                st.cuda_stream)]
        assert int(counter) == 0


@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen", [
    lambda: poisson.poisson2d_5pt(1, 37),
    lambda: poisson.poisson2d_5pt(13, 17),
    lambda: poisson.poisson3d_7pt(5, 6, 7),
    lambda: poisson.poisson3d_27pt(6),
])
def test_stencil_pipe_matches_plain(card, gen, vdt):
    spec, why = st.recognize_stencil(gen())
    assert spec is not None, why
    n = spec.nrows
    npad = -(-n // 8) * 8 + 8                       # padding past the grid
    vecs, ab = _pipe_inputs(n, npad, vdt, card)
    before = st.pipe_launches
    _check_pipe(lambda *a: st.cg_pipelined_iter_stencil(spec, *a),
                lambda *a: st.cg_pipelined_iter_stencil_plain(spec, *a),
                vecs, ab, n)
    assert st.pipe_launches == before + 2


def test_pipe_wrappers_reject_what_the_kernels_do_not_take(card):
    spec, _ = st.recognize_stencil(poisson.poisson2d_5pt(8))
    vecs, (a, b) = _pipe_inputs(64, 64, torch.float64, card)
    w, z, r, p, s, x = vecs
    with pytest.raises(AcgError):                   # w' would overwrite w
        st.cg_pipelined_iter_stencil(spec, *vecs, a, b, w_out=w)
    with pytest.raises(AcgError):                   # w' over z
        st.cg_pipelined_iter_stencil(spec, *vecs, a, b, w_out=z)
    with pytest.raises(AcgError):                   # two vectors in one
        st.cg_pipelined_iter_stencil(spec, w, z, z, p, s, x, a, b)
    with pytest.raises(AcgError):                   # overlapping views
        big = torch.zeros(128, dtype=torch.float64, device=card)
        st.cg_pipelined_iter_stencil(spec, w, big[:64], r, p, s, x, a, b,
                                     w_out=big[32:96])
    with pytest.raises(AcgError):                   # alpha on the host
        st.cg_pipelined_iter_stencil(spec, *vecs, a.cpu(), b)
    with pytest.raises(AcgError):                   # mixed dtypes
        st.cg_pipelined_iter_stencil(spec, w, z.float(), r, p, s, x, a, b)
    with pytest.raises(AcgError):                   # shorter than the grid
        st.cg_pipelined_iter_stencil(spec, *[v[:32] for v in vecs], a, b)
    D = _random_dia(64, (-1, 0, 1))
    dev = DeviceDia.from_dia(D, mat_dtype=None, device=card)
    with pytest.raises(AcgError):                   # w' would overwrite w
        dev.pipelined_iter(*vecs, a, b, w_out=w)
    with pytest.raises(AcgError):                   # int8 mask, no scales
        dia_kernels.cg_pipelined_iter(dev.bands.to(torch.int8), None,
                                      dev.offsets_t, *vecs, a, b)
    with pytest.raises(AcgError):                   # bands of another n
        dia_kernels.cg_pipelined_iter(dev.bands, None, dev.offsets_t,
                                      *[v[:32] for v in vecs], a, b)


@pytest.mark.parametrize("fmt", ["auto", "dia"])
def test_cg_pipelined_on_the_card_matches_cpu(card, fmt):
    A = poisson.poisson3d_7pt(12)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(A.nrows)
    o = SolverOptions(maxits=1000, residual_rtol=1e-10)
    before = (dia_kernels.pipe_launches, st.pipe_launches)
    rg = cg_pipelined(A, b, options=o, fmt=fmt)     # default device: cuda
    launched = (dia_kernels.pipe_launches - before[0],
                st.pipe_launches - before[1])
    rc = cg_pipelined(A, b, options=o, fmt=fmt, device="cpu")
    assert rg.kernel == f"cuda-{rg.operator_format}-pipe"
    assert rg.operator_format == ("stencil" if fmt == "auto" else "dia")
    assert launched == ((0, rg.niterations) if fmt == "auto"
                        else (rg.niterations, 0))
    assert abs(rg.niterations - rc.niterations) <= 1
    assert np.linalg.norm(rg.x - rc.x) <= 1e-8 * np.linalg.norm(rc.x)
    assert np.linalg.norm(b - A.matvec(rg.x)) <= 1e-9 * np.linalg.norm(b)
    rr = cg_pipelined(A, b, options=SolverOptions(
        maxits=1000, residual_rtol=1e-10, replace_every=25), fmt=fmt)
    assert rr.kernel == f"cuda-{rr.operator_format}-spmv"
    assert "pipe disengaged: replace_every=25" in rr.kernel_note
    assert abs(rr.niterations - rc.niterations) <= 2


# ---------------------------------------------------------------------------
# the multi-RHS SpMV kernels


def _check_batched(Y, d, X, Yp, one):
    """The batched kernel against its plain version (``_TOL``, the dots
    relative to |x_s|·|y_s|), and each system bit-identical to the 1-D
    kernel ``one(x) -> (y, dot)`` on that system."""
    rtol, atol, dot_rtol = _TOL[X.dtype]
    assert float((Y - Yp).abs().max()) <= atol + rtol * float(
        Yp.abs().max())
    dp = torch.stack([torch.dot(a, b) for a, b in zip(X, Yp)])
    scale = torch.linalg.norm(X, dim=1) * torch.linalg.norm(Yp, dim=1)
    assert torch.all((d - dp).abs() <= dot_rtol * scale)
    for s in range(X.shape[0]):
        y, ds = one(X[s].contiguous())
        assert torch.equal(Y[s], y) and torch.equal(d[s], ds)


# chunk tails: one launch of 1, 2, 3, 5 or 8 systems, and 8 + 1, 8 + 8
_NSYS = [1, 2, 3, 5, 8, 9, 16]


@pytest.mark.parametrize("nsys", _NSYS)
@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", "int8", None, "float32"])
@pytest.mark.parametrize("n,offsets", [
    (700, (-33, -1, 0, 1, 33)),                    # G = 3
    (1000, (-300, -1, 0, 1, 999)),                 # G = 4
    (2053, (-300, -129, -1, 0, 1, 129, 300)),      # G = 9; f32 rows off
    #                                                16-byte boundaries
    (4099, (-2048, -129, -1, 0, 1, 129, 2048, 5000)),
])
def test_dia_spmv_batched_matches_plain_and_1d(card, n, offsets, mat, vdt,
                                               nsys):
    D = _random_dia(n, offsets)
    if mat in ("auto", "int8"):
        D = DiaMatrix(n, n, D.offsets, np.sign(D.bands) * 0.5, D.nnz)
    if mat == "int8":
        D = DiaMatrix(n, n, D.offsets, np.abs(D.bands), D.nnz)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    X = torch.randn(nsys, n, dtype=getattr(torch, vdt), device=card)
    before = dia_kernels.batched_launches
    Y, d = dia_kernels.dia_spmv_batched(dev.bands, dev.scales,
                                        dev.offsets_t, X, with_dot=True)
    assert dia_kernels.batched_launches == before + 1
    _check_batched(Y, d, X, dia_matvec(dev.bands, dev.offsets, X,
                                       dev.scales), dev.matvec_dot)
    assert torch.equal(dev.matvec(X), Y)
    again = dev.matvec_dot(X)[1]
    assert torch.equal(again, d)                    # no atomics: same bits


@pytest.mark.parametrize("nsys", _NSYS)
@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("gen", [
    lambda: poisson.poisson2d_5pt(13, 17),
    lambda: poisson.poisson3d_7pt(5, 6, 7),
    lambda: poisson.poisson3d_7pt(13, 14, 15),     # G = 11
    lambda: poisson.poisson3d_27pt(6),
])
def test_stencil_spmv_batched_matches_plain_and_1d(card, gen, vdt, nsys):
    spec, why = st.recognize_stencil(gen())
    assert spec is not None, why
    n = spec.nrows
    npad = -(-n // 8) * 8 + 8                       # padding past the grid
    X = torch.zeros(nsys, npad, dtype=vdt, device=card)
    X[:, :n] = torch.randn(nsys, n, dtype=vdt, device=card)
    before = st.batched_launches
    Y, d = st.stencil_spmv_batched(spec, X, with_dot=True)
    assert st.batched_launches == before + 1
    _check_batched(Y, d, X, st.stencil_matvec(X, spec.grid, spec.digits,
                                              spec.coeffs),
                   lambda x: st.stencil_spmv(spec, x, with_dot=True))
    assert torch.all(Y[:, n:] == 0)
    assert torch.equal(st.stencil_spmv_batched(spec, X), Y)


@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
def test_batched_kernels_take_x_off_a_16_byte_boundary(card, vdt):
    """X one element past a 16-byte boundary (every system's row starts
    off a 16-byte boundary): Y and the dots keep the 1-D kernels'
    bits."""
    D = _random_dia(2053, (-300, -129, -1, 0, 1, 129, 300))
    dev = DeviceDia.from_dia(D, dtype=str(vdt)[6:], mat_dtype=None,
                             device=card)
    buf = torch.zeros(5 * 2053 + 1, dtype=vdt, device=card)
    X = buf[1:].view(5, 2053)
    X.copy_(torch.randn(5, 2053, dtype=vdt, device=card))
    assert X.data_ptr() % 16 != 0
    Y, d = dev.matvec_dot(X)
    _check_batched(Y, d, X, dia_matvec(dev.bands, dev.offsets, X,
                                       dev.scales), dev.matvec_dot)
    spec, _ = st.recognize_stencil(poisson.poisson3d_7pt(13, 14, 15))
    n = spec.nrows
    buf = torch.zeros(3 * n + 1, dtype=vdt, device=card)
    X = buf[1:].view(3, n)
    X.copy_(torch.randn(3, n, dtype=vdt, device=card))
    Y, d = st.stencil_spmv_batched(spec, X, with_dot=True)
    _check_batched(Y, d, X, st.stencil_matvec(X, spec.grid, spec.digits,
                                              spec.coeffs),
                   lambda x: st.stencil_spmv(spec, x, with_dot=True))


def test_batched_kernels_two_ksteps(card):
    """Past 256 x 4096 rows a block runs two k-steps: Y and the dots keep
    the 1-D kernel's bits."""
    n = 256 * 4096 + 1000
    D = _random_dia(n, (-70000, -257, -1, 0, 1, 257, 70000), seed=3)
    dev = DeviceDia.from_dia(D, dtype="float64", mat_dtype=None,
                             device=card)
    X = torch.randn(8, n, dtype=torch.float64, device=card)
    Y, d = dia_kernels.dia_spmv_batched(dev.bands, dev.scales,
                                        dev.offsets_t, X, with_dot=True)
    _check_batched(Y, d, X, dia_matvec(dev.bands, dev.offsets, X,
                                       dev.scales), dev.matvec_dot)


def test_batched_wrappers_reject_what_the_kernels_do_not_take(card):
    D = _random_dia(64, (-1, 0, 1))
    dev = DeviceDia.from_dia(D, mat_dtype=None, device=card)
    X = torch.randn(2, 64, dtype=torch.float64, device=card)
    with pytest.raises(AcgError):                   # a 1-D vector
        dia_kernels.dia_spmv_batched(dev.bands, None, dev.offsets_t, X[0])
    with pytest.raises(AcgError):                   # rows of another n
        dia_kernels.dia_spmv_batched(dev.bands, None, dev.offsets_t,
                                     X[:, :32].contiguous())
    with pytest.raises(AcgError):                   # strided rows
        dia_kernels.dia_spmv_batched(dev.bands, None, dev.offsets_t,
                                     torch.randn(2, 128, dtype=torch.float64,
                                                 device=card)[:, ::2])
    spec, _ = st.recognize_stencil(poisson.poisson2d_5pt(8))
    with pytest.raises(AcgError):                   # shorter than the grid
        st.stencil_spmv_batched(spec, X[:, :32].contiguous())
    with pytest.raises(AcgError):                   # half precision
        st.stencil_spmv_batched(spec, X.half())


@pytest.mark.parametrize("fmt", ["auto", "dia"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_batched_cg_on_the_card_matches_sequential(card, fmt, pipelined):
    """A (B, n) solve on the card launches the batched kernel and gives
    each system the iteration count of its own 1-D solve on the card."""
    A = poisson.poisson3d_7pt(12)
    rng = np.random.default_rng(3)
    bb = rng.standard_normal((3, A.nrows))
    o = SolverOptions(maxits=1000, residual_rtol=1e-10)
    solve = cg_pipelined if pipelined else cg
    counters = (dia_kernels, st)
    before = [m.batched_launches for m in counters]
    rg = solve(A, bb, options=o, fmt=fmt)
    launched = [m.batched_launches - b for m, b in zip(counters, before)]
    assert rg.kernel == f"cuda-{rg.operator_format}-batched"
    assert rg.operator_format == ("stencil" if fmt == "auto" else "dia")
    assert launched[fmt == "auto"] >= rg.niterations
    assert launched[fmt != "auto"] == 0
    for s in range(3):
        r1 = solve(A, bb[s], options=o, fmt=fmt)
        assert rg.iterations_per_system[s] == r1.niterations
        assert np.linalg.norm(bb[s] - A.matvec(rg.x[s])) <= \
            1e-9 * np.linalg.norm(bb[s])


# ---------------------------------------------------------------------------
# the unstructured tiers: sgell and padded ELL


def _local_csr(n, width, spread, seed=0, empty_tile=None, dtype=np.float32):
    """A random symmetric-pattern-free local matrix: ``width`` entries per
    row within ``spread`` of the diagonal, rows of tile ``empty_tile``
    (1024 rows) left empty."""
    from acg_torch.sparse.csr import coo_to_csr

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), width)
    cols = np.clip(rows + rng.integers(-spread, spread + 1, n * width), 0,
                   n - 1)
    if empty_tile is not None:
        keep = rows // 1024 != empty_tile
        rows, cols = rows[keep], cols[keep]
    uniq = np.unique(rows * np.int64(n) + cols)
    rows, cols = uniq // n, uniq % n
    vals = rng.standard_normal(len(rows)).astype(dtype)
    return coo_to_csr(rows, cols, vals, n, n)


@pytest.mark.parametrize("sigma", [1, 1024])
@pytest.mark.parametrize("mat", [None, "bfloat16"])
@pytest.mark.parametrize("n,width,spread,empty", [
    (1000, 5, 40, None),           # one tile, rows not a multiple of 8
    (4 * 1024, 6, 500, 2),         # an empty interior tile
    (5000, 12, 3000, None),        # many segments per sublane
])
def test_sgell_spmv_matches_plain(card, n, width, spread, empty, mat, sigma):
    from acg_torch.ops import sgell, sliced

    A = _local_csr(n, width, spread, empty_tile=empty)
    dev = sgell.build_device_sgell(A, mat_dtype=mat, min_fill=0.0,
                                   device=card)
    assert dev.idx.dtype == torch.int8
    # only the sliced layout lives on the card; the pack stays on the host
    assert dev.vals.device.type == "cpu" and dev.sliced.device.type == "cuda"
    pack = [a.to(card) for a in (dev.vals, dev.idx, dev.seg, dev.tile_start)]
    op = sgell.slice_pack(*pack, sigma=sigma)
    assert op.device == pack[0].device and op.nnz == dev.nnz
    x = torch.zeros(dev.nrows_padded, device=card)
    x[:n] = torch.randn(n, device=card)
    before = sgell.launches
    y = sgell.sgell_spmv(op, x)
    assert sgell.launches == before + 1
    want = sgell.sgell_matvec(*pack, x)
    rtol, atol, _ = _TOL[torch.float32]
    assert float((y - want).abs().max()) <= atol + rtol * float(
        want.abs().max())
    # each entry a product then a sum, in slot order: the pack's plain bits
    assert torch.equal(y, want)
    assert torch.equal(y, sliced.sliced_matvec(op, x))
    assert torch.equal(sgell.sgell_spmv(op, x), y)
    if empty is not None:
        assert torch.all(y[empty * 1024:(empty + 1) * 1024] == 0)
    assert torch.all(y[n:] == 0)
    ref = A.matvec(x[:n].double().cpu().numpy())
    tol = 1e-5 if mat is None else 2e-2            # bf16 rounds the values
    assert np.abs(y[:n].cpu().numpy() - ref).max() <= tol * np.abs(
        ref).max()


@pytest.mark.parametrize("sigma", [1, 1024])
@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("mdt", [torch.bfloat16, torch.float32,
                                 torch.float64])
@pytest.mark.parametrize("n,width", [(1001, 1), (999, 2), (1003, 3),
                                     (777, 7), (2048, 9), (513, 17),
                                     (3001, 55), (4097, 64)])
def test_ell_spmv_matches_plain(card, n, width, mdt, vdt, sigma):
    from acg_torch.ops import sliced, spmv

    g = torch.Generator(device=card).manual_seed(n + width)
    vals = torch.randn(n, width, generator=g, device=card,
                       dtype=torch.float64)
    cols = torch.randint(0, n, (n, width), generator=g, device=card,
                         dtype=torch.int32)
    vals[n // 3:n // 2, width // 2:] = 0.0         # padded lanes: column 0
    cols[n // 3:n // 2, width // 2:] = 0
    vals[n // 2:n // 2 + 40] = 0.0                 # a run of empty rows
    cols[n // 2:n // 2 + 40] = 0
    vals = vals.to(mdt)
    op = sliced.slice_ell(vals, cols, n, sigma=sigma)
    x = torch.randn(n, generator=g, device=card, dtype=torch.float64).to(vdt)
    before = spmv.launches
    y = spmv.ell_spmv(op, x)
    assert spmv.launches == before + 1
    want = spmv.ell_matvec(vals, cols, x)
    rtol, atol, _ = _TOL[vdt]
    assert float((y - want).abs().max()) <= atol + rtol * float(
        want.abs().max())
    assert torch.equal(y, sliced.sliced_matvec(op, x))   # lane order
    assert torch.equal(spmv.ell_spmv(op, x), y)          # same bits


def test_device_ell_keeps_only_its_sliced_layout_on_the_card(card):
    from acg_torch.ops import sliced, spmv
    from acg_torch.sparse.ell import EllMatrix

    A = _local_csr(3000, 7, 400)
    dev = spmv.DeviceEll.from_ell(EllMatrix.from_csr(A), device=card)
    assert dev.vals.device.type == "cpu" and dev.colidx.device.type == "cpu"
    assert dev.sliced.device.type == "cuda" and dev.device.type == "cuda"
    assert sliced.unroll("ell_spmv") == sliced.unroll("sgell_spmv") >= 1
    x = torch.randn(dev.nrows_padded, device=card)
    y = dev.matvec(x)
    assert torch.equal(y, sliced.sliced_matvec(dev.sliced, x))
    want = spmv.ell_matvec(dev.vals.to(card), dev.colidx.to(card), x)
    rtol, atol, _ = _TOL[torch.float32]
    assert float((y - want).abs().max()) <= atol + rtol * float(
        want.abs().max())


def test_unstructured_wrappers_reject_what_the_kernels_do_not_take(card):
    from acg_torch.ops import sgell, sliced, spmv

    A = _local_csr(2000, 4, 100)
    dev = sgell.build_device_sgell(A, min_fill=0.0, device=card)
    op = dev.sliced
    x = torch.zeros(dev.nrows_padded, device=card)
    before = sgell.launches
    with pytest.raises(AcgError):                   # f64 vectors
        sgell.sgell_spmv(op, x.double())
    with pytest.raises(AcgError):                   # x shorter than ncols
        sgell.sgell_spmv(op, x[:8])
    with pytest.raises(AcgError):                   # f64 values
        sgell.sgell_spmv(dataclasses.replace(op, vals=op.vals.double()), x)
    with pytest.raises(AcgError):                   # int64 columns
        sgell.sgell_spmv(dataclasses.replace(op, cols=op.cols.long()), x)
    with pytest.raises(AcgError):                   # the layout on the host
        sgell.sgell_spmv(dataclasses.replace(op, vals=op.vals.cpu()), x)
    assert sgell.launches == before
    vals = torch.randn(64, 3, device=card)
    cols = torch.zeros(64, 3, dtype=torch.int32, device=card)
    eop = sliced.slice_ell(vals, cols, 64)
    xv = torch.randn(64, device=card)
    before = spmv.launches
    with pytest.raises(AcgError):                   # int32 row order
        spmv.ell_spmv(dataclasses.replace(eop, perm=eop.perm.long()), xv)
    with pytest.raises(AcgError):                   # half precision
        spmv.ell_spmv(eop, xv.half())
    with pytest.raises(AcgError):                   # strided values
        spmv.ell_spmv(dataclasses.replace(
            eop, vals=torch.randn(2 * eop.vals.numel(),
                                  device=card)[::2]), xv)
    # x may be longer than the columns (a rectangular operator), not shorter
    with pytest.raises(AcgError):                   # an empty x
        spmv.ell_spmv(eop, xv[:0])
    assert spmv.launches == before
    assert spmv.ell_spmv(eop, torch.randn(100, device=card)).shape == (64,)


@pytest.mark.parametrize("tier,dtype", [("rcm+sgell", np.float32),
                                        ("ell", np.float64),
                                        ("rcm+dia", np.float64)])
@pytest.mark.parametrize("pipelined", [False, True])
def test_unstructured_solves_on_the_card_match_cpu(card, tier, dtype,
                                                   pipelined):
    from acg_torch.ops import sgell, spmv
    from acg_torch.sparse.mesh import fem_delaunay_spd
    from acg_torch.sparse.rcm import permute_symmetric

    if tier == "rcm+dia":
        A = poisson.poisson2d_5pt(1, 3000)              # a tridiagonal
        A = permute_symmetric(A, np.random.default_rng(7).permutation(3000))
    else:
        A = fem_delaunay_spd(20000, dim=3, seed=1)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(A.nrows)
    rtol = 1e-5 if dtype == np.float32 else 1e-10
    o = SolverOptions(maxits=5000, residual_rtol=rtol)
    solve = cg_pipelined if pipelined else cg
    counters = (spmv, sgell, dia_kernels)
    before = [m.launches for m in counters] + [dia_kernels.pipe_launches]
    rg = solve(A, b, options=o, dtype=dtype)
    launched = [m.launches for m in counters] + [dia_kernels.pipe_launches]
    launched = [a - b for a, b in zip(launched, before)]
    rc = solve(A, b, options=o, dtype=dtype, device="cpu")
    assert rg.operator_format == rc.operator_format == tier
    kernel = {"rcm+sgell": "cuda-sgell-spmv", "ell": "cuda-ell-spmv",
              "rcm+dia": "cuda-dia-pipe" if pipelined
              else "cuda-dia-fused"}[tier]
    assert rg.kernel == kernel and rg.kernel_note == ""
    loop = {"ell": 0, "rcm+sgell": 1}.get(tier)
    if loop is not None:
        assert launched[loop] >= rg.niterations
        assert launched[2] == launched[3] == 0
    elif pipelined:
        assert launched[3] == rg.niterations
    # at f32 the count near rtol moves with the dots' summation order
    # (cuBLAS on the card, another order on the CPU)
    assert abs(rg.niterations - rc.niterations) <= (
        3 if dtype == np.float32 else 1)
    assert np.linalg.norm(b - A.matvec(rg.x.astype(np.float64))) <= \
        10 * rtol * np.linalg.norm(b)


@pytest.mark.parametrize("tier,dtype", [("rcm+sgell", np.float32),
                                        ("ell", np.float64)])
def test_unstructured_batched_counts_equal_one_system(card, tier, dtype):
    from acg_torch.solvers.cg import build_device_operator
    from acg_torch.sparse.mesh import fem_delaunay_spd

    A = fem_delaunay_spd(20000, dim=3, seed=1)
    op = build_device_operator(A, dtype=dtype)
    bb = np.random.default_rng(3).standard_normal((3, A.nrows))
    o = SolverOptions(maxits=5000, residual_rtol=1e-5 if dtype == np.float32
                      else 1e-10)
    rg = cg(op, bb, options=o)
    assert rg.operator_format == tier
    for s in range(3):
        r1 = cg(op, bb[s], options=o)
        assert rg.iterations_per_system[s] == r1.niterations
        np.testing.assert_array_equal(rg.x[s], r1.x)


# ---------------------------------------------------------------------------
# the HBM tier: the shared-memory ring and clustered-window kernels


def _hbm_plan(kind, tile, dev, card):
    """A plan of ``kind`` at ``tile`` on the card's own budgets."""
    from acg_torch.ops import dia_plan

    return dia_plan.make_plan(kind, tile, dev.nrows_padded, dev.offsets,
                              getattr(torch, dev.vec_dtype), dev.bands.dtype,
                              dia_plan.device_budgets(card), device=card)


@pytest.mark.parametrize("kind", ["hbm-ring", "hbm"])
@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", "int8", None, "float32"])
@pytest.mark.parametrize("n,offsets,tile", [
    (8, (-3, 0, 5), 256),                           # one ragged tile
    (1000, (-300, -1, 0, 1, 999), 256),             # |off| ~ n
    (4099, (-2048, -129, -1, 0, 1, 129, 2048, 5000), 256),  # |off| >= n
    (20_001, (-3001, -3, -1, 0, 1, 3, 3001), 512),  # span > 2 tiles, and
    #                                                 windows off 16 bytes
    (100_003, (-7000, -333, 0, 333, 7000), 1024),
])
def test_hbm_kernels_match_plain(card, n, offsets, tile, mat, vdt, kind):
    D = _random_dia(n, offsets)
    if mat in ("auto", "int8"):
        D = DiaMatrix(n, n, D.offsets, np.sign(D.bands) * 0.5, D.nnz)
    if mat == "int8":
        D = DiaMatrix(n, n, D.offsets, np.abs(D.bands), D.nnz)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    plan = _hbm_plan(kind, tile, dev, card)
    spmv, plain, counter = (
        (dia_kernels.dia_spmv_ring, dia_kernels.dia_matvec_ring_plain,
         "ring_launches") if kind == "hbm-ring" else
        (dia_kernels.dia_spmv_windows, dia_kernels.dia_matvec_windows_plain,
         "windows_launches"))
    # x twice: 16-byte aligned, and one element past a 16-byte boundary
    buf = torch.randn(dev.nrows_padded + 1, dtype=getattr(torch, vdt),
                      device=card)
    for x in (buf[:-1].clone(), buf[1:]):
        before = getattr(dia_kernels, counter)
        got = spmv(dev.bands, dev.scales, dev.offsets_t, x, plan,
                   with_dot=True)
        assert getattr(dia_kernels, counter) == before + 1
        y = plain(dev.bands, dev.offsets, x, dev.scales, plan)
        _check(got, (y, torch.dot(x, y)), x, x.dtype)
        # dia_spmv's bits: one row body whichever way x arrives
        assert torch.equal(got[0], dia_spmv(dev.bands, dev.scales,
                                            dev.offsets_t, x))
        assert torch.equal(spmv(dev.bands, dev.scales, dev.offsets_t, x,
                                plan), got[0])
        again = spmv(dev.bands, dev.scales, dev.offsets_t, x, plan,
                     with_dot=True)
        assert torch.equal(again[1], got[1])        # no atomics: same bits


# the pipelined windows kernel: 7 bands (its fixed-D body) and 5 (the
# generic one), spans wide enough for bulk-copied tiles, both ring depths
# the plan makes (the shallower through a per-block budget that holds it
# and not the deeper)
@pytest.mark.parametrize("stages", [4, 3])
@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", "int8", None])
@pytest.mark.parametrize("n,offsets,tile", [
    (300_007, (-20_000, -150, -1, 0, 1, 150, 20_000), 1024),
    (200_000, (-9000, -31, 0, 31, 9000), 512),
])
def test_windows_pipeline_matches_plain(card, n, offsets, tile, mat, vdt,
                                        stages):
    """Bulk-copied interior tiles beside the tiles read straight from
    device memory (the ends, the ragged last tile), x 16-byte aligned and
    one element off, and a grid with more blocks than tiles: y bit-equal
    to dia_spmv, the dot within _TOL of the plain version and stable."""
    from acg_torch.ops import dia_plan

    D = _tiered(_random_dia(n, offsets, seed=5), mat)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    budgets = dia_plan.device_budgets(card)
    vt = getattr(torch, vdt)

    def need(tile):
        return dia_plan.windows_bytes(
            offsets, tile, torch.empty((), dtype=vt).element_size(),
            dev.bands.element_size(), len(offsets), stages)

    while need(tile) > budgets.smem_block:
        tile //= 2                                  # the ring fits one block
    if stages < dia_plan.STAGES[0]:
        budgets = dataclasses.replace(budgets, smem_block=need(tile))
    plan = dia_plan.make_plan("hbm", tile, dev.nrows_padded, dev.offsets, vt,
                              dev.bands.dtype, budgets, device=card)
    assert plan.stages == stages
    buf = torch.randn(dev.nrows_padded + 1, dtype=getattr(torch, vdt),
                      device=card)
    for p in (plan, dataclasses.replace(plan, nblocks=plan.ntiles + 7)):
        for x in (buf[:-1].clone(), buf[1:]):
            got = dia_kernels.dia_spmv_windows(dev.bands, dev.scales,
                                               dev.offsets_t, x, p,
                                               with_dot=True)
            y = dia_kernels.dia_matvec_windows_plain(dev.bands, dev.offsets,
                                                     x, dev.scales, p)
            _check(got, (y, torch.dot(x, y)), x, x.dtype)
            assert torch.equal(got[0], dia_spmv(dev.bands, dev.scales,
                                                dev.offsets_t, x))
            again = dia_kernels.dia_spmv_windows(dev.bands, dev.scales,
                                                 dev.offsets_t, x, p,
                                                 with_dot=True)
            assert torch.equal(again[1], got[1])


# the ring's producer-warp pipeline: 5 bands (its fixed-D body) and 9 (the
# generic one), spans of many tiles, every depth the plan makes (the
# shallower through a per-block budget that holds it and not the deeper);
# n even with a ragged last tile, and odd (band rows off 16 bytes: every
# row straight from device memory)
@pytest.mark.parametrize("stages", [4, 3, 2])
@pytest.mark.parametrize("vdt", ["float32", "float64"])
@pytest.mark.parametrize("mat", ["auto", "int8", None])
@pytest.mark.parametrize("n,offsets,tile", [
    (300_008, (-6000, -1, 0, 1, 6000), 1024),
    (200_003, (-9000, -31, 0, 31, 9000), 512),
    (250_000, (-6000, -2100, -1024, -1, 0, 1, 1024, 2100, 6000), 256),
])
def test_ring_pipeline_matches_plain(card, n, offsets, tile, mat, vdt,
                                     stages):
    """Bulk-copied row tiles beside the tiles read straight from device
    memory (the ends of the vector, the ragged last tile, unaligned rows),
    x 16-byte aligned and one element off, runs of many tiles and grids
    whose runs are shorter than the span: y with and without the dot
    bit-equal to dia_spmv, within _TOL of the plain version, the dot
    stable."""
    from acg_torch.ops import dia_plan

    D = _tiered(_random_dia(n, offsets, seed=7), mat)
    dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat, device=card)
    budgets = dia_plan.device_budgets(card)
    vt = getattr(torch, vdt)

    def need(tile):
        return dia_plan.ring_bytes(
            offsets, tile, torch.empty((), dtype=vt).element_size(),
            dev.bands.element_size(), len(offsets), stages)

    while need(tile) > budgets.smem_block:
        tile //= 2                                  # the ring fits one block
    assert tile >= 256
    # a block budget that holds this depth and no deeper one, one block an
    # SM; and the card's own plan at the same tile
    reserve = budgets.smem_sm - budgets.smem_block
    one = dataclasses.replace(budgets, smem_block=need(tile),
                              smem_sm=need(tile) + reserve)
    plan = dia_plan.make_plan("hbm-ring", tile, dev.nrows_padded,
                              dev.offsets, vt, dev.bands.dtype, one,
                              device=card)
    assert plan.stages == stages
    own = dia_plan.make_plan("hbm-ring", tile, dev.nrows_padded,
                             dev.offsets, vt, dev.bands.dtype, budgets,
                             device=card)
    buf = torch.randn(dev.nrows_padded + 1, dtype=vt, device=card)
    span = plan.hi - plan.lo + 1
    for p in (plan, own, dataclasses.replace(plan, nblocks=max(
            1, plan.ntiles // max(1, span // 2))),
              dataclasses.replace(plan, nblocks=plan.ntiles + 7)):
        for x in (buf[:-1].clone(), buf[1:]):
            before = dia_kernels.ring_launches
            got = dia_kernels.dia_spmv_ring(dev.bands, dev.scales,
                                            dev.offsets_t, x, p,
                                            with_dot=True)
            y_only = dia_kernels.dia_spmv_ring(dev.bands, dev.scales,
                                               dev.offsets_t, x, p)
            assert dia_kernels.ring_launches == before + 2
            y = dia_kernels.dia_matvec_ring_plain(dev.bands, dev.offsets, x,
                                                  dev.scales, p)
            _check(got, (y, torch.dot(x, y)), x, x.dtype)
            ref = dia_spmv(dev.bands, dev.scales, dev.offsets_t, x)
            assert torch.equal(got[0], ref) and torch.equal(y_only, ref)
            again = dia_kernels.dia_spmv_ring(dev.bands, dev.scales,
                                              dev.offsets_t, x, p,
                                              with_dot=True)
            assert torch.equal(again[1], got[1])


def test_hbm_wrappers_reject_what_the_kernels_do_not_take(card):
    D = _random_dia(5000, (-1000, 0, 1000))
    dev = DeviceDia.from_dia(D, mat_dtype=None, device=card)
    x = torch.randn(5000, dtype=torch.float64, device=card)
    plan = _hbm_plan("hbm", 256, dev, card)
    with pytest.raises(AcgError):                   # the table on the CPU
        dia_kernels.dia_spmv_windows(
            dev.bands, None, dev.offsets_t, x,
            dataclasses.replace(plan, table=plan.table.cpu()))
    with pytest.raises(AcgError):                   # a ring plan
        dia_kernels.dia_spmv_windows(dev.bands, None, dev.offsets_t, x,
                                     _hbm_plan("hbm-ring", 256, dev, card))
    with pytest.raises(AcgError):                   # strided vector
        dia_kernels.dia_spmv_ring(
            dev.bands, None, dev.offsets_t,
            torch.randn(10_000, dtype=torch.float64, device=card)[::2],
            _hbm_plan("hbm-ring", 256, dev, card))


def _ring_operator(n):
    """An SPD operator that the plan sends to the ring kernel on the
    card's own shared memory, at f32 and at f64 vectors: 31 bands in 16
    offset clusters over +-11,783 (offsets +-1537 k and +-(1537 k +
    1024), k = 0..7), where no windows ring of 3 stages fits one block
    at any tile.  Diagonal 2, every other band -1/32."""
    offsets = tuple(sorted({s * (1537 * k + e) for k in range(8)
                            for e in (0, 1024) for s in (1, -1)}))
    bands = np.full((len(offsets), n), -1 / 32)
    for d, off in enumerate(offsets):
        if off == 0:
            bands[d] = 2.0
        elif off > 0:
            bands[d, n - off:] = 0.0
        else:
            bands[d, :-off] = 0.0
    return DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))


def _wide_operator(n):
    """An SPD operator whose +-40,000 span no ring of x tiles holds in one
    block of the card, at any tile or depth, while three windows do:
    offsets (-40,000, -1, 0, 1, 40,000), diagonal 2, every other band
    -1/8."""
    offsets = (-40_000, -1, 0, 1, 40_000)
    bands = np.full((5, n), -1 / 8)
    bands[2] = 2.0
    for d, off in enumerate(offsets):
        if off > 0:
            bands[d, n - off:] = 0.0
        elif off < 0:
            bands[d, :-off] = 0.0
    return DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))


@pytest.mark.parametrize("kind", ["hbm-ring", "hbm", "resident"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cg_through_the_hbm_kernels_matches_cpu(card, kind, dtype):
    """A solve whose operator leaves a (pretended) small L2: the loop and
    the eager matvecs go through the planned kernel, once per SpMV: the
    ring for an operator of many clusters over a short span, the windows
    kernel for one whose span no ring holds, and dia_spmv where no ring
    or windows fit one block (its fixed kernel at f32 vectors)."""
    from acg_torch.ops import dia_plan

    D = (_ring_operator(50_000) if kind == "hbm-ring" else
         _wide_operator(200_000) if kind == "hbm" else
         poisson.poisson3d_7pt_dia(24))
    real = dia_plan.device_budgets(card)
    small = dataclasses.replace(real, l2_bytes=1024)
    if kind == "resident":
        small = dataclasses.replace(small, smem_block=4096)
    dev = DeviceDia.from_dia(D, dtype=dtype, device=card, budgets=small)
    assert dev.kind == kind
    if kind == "resident":
        assert dev.fixed == (dtype == np.float32)
    host = DeviceDia.from_dia(D, dtype=dtype, device="cpu", budgets=small)
    rng = np.random.default_rng(6)
    b = D.matvec(rng.standard_normal(D.nrows))
    rtol = 1e-5 if dtype == np.float32 else 1e-10
    o = SolverOptions(maxits=1000, residual_rtol=rtol)
    counter = {"hbm-ring": "ring_launches", "hbm": "windows_launches",
               "resident": "launches"}[kind]
    before = {c: getattr(dia_kernels, c) for c in
              ("ring_launches", "windows_launches", "launches")}
    rg = cg(dev, b, options=o)
    for c, v in before.items():
        assert getattr(dia_kernels, c) - v == (
            rg.niterations + 1 if c == counter else 0)
    rc = cg(host, b, options=o, device="cpu")
    want = "cuda-dia-fused" if kind == "resident" else f"cuda-dia-{kind}"
    assert rg.kernel == want and rc.kernel == "torch-plain"
    assert abs(rg.niterations - rc.niterations) <= 1
    x = rg.x.astype(np.float64)
    assert np.linalg.norm(b - D.matvec(x)) <= 10 * rtol * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the distributed slice: the put+signal halo kernel, the rectangular ELL
# product, and distributed classic CG with shards sharing the card


def _partner_table(P, R, seed):
    """A symmetric (P, R) partner table: each round a random matching,
    some shards left without a partner (-1)."""
    rng = np.random.default_rng(seed)
    partner = np.full((P, R), -1, dtype=np.int32)
    for r in range(R):
        perm = rng.permutation(P)
        for a, b in zip(perm[0::2], perm[1::2]):
            if rng.random() < 0.8:
                partner[a, r], partner[b, r] = b, a
    return partner


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P,R,S", [(2, 1, 1), (2, 3, 5000), (4, 2, 32768),
                                   (8, 5, 777), (8, 7, 9000)])
def test_rdma_exchange_matches_plain(card, P, R, S, dtype):
    from acg_torch.parallel import rdma_halo

    partner = _partner_table(P, R, seed=P * 100 + R)
    state = rdma_halo.RdmaState(partner, S, dtype, make_mesh(P, [card] * P))
    assert state.scope == "gpu"            # every partner shares the card
    gen = torch.Generator(device=card).manual_seed(S)
    for rep in range(3):        # parities 0, 1, 0: the buffers alternate
        send = [torch.randn((R, S), dtype=dtype, device=card, generator=gen)
                for _ in range(P)]
        before = rdma_halo.launches
        got = [o.clone() for o in
               rdma_halo.rdma_exchange(send, partner, state)]
        torch.cuda.synchronize()
        assert rdma_halo.launches == before + 1
        want = rdma_halo.rdma_exchange_plain(send, partner)
        for p in range(P):
            assert torch.equal(got[p], want[p]), (rep, p)
            for r in range(R):           # no partner: its own slot back
                if partner[p, r] < 0:
                    assert torch.equal(got[p][r], send[p][r])
        # every flag and epoch advanced once per exchange
        for fl, ep in zip(state.flags, state.epoch):
            assert torch.all(fl == rep + 1) and torch.all(ep == rep + 1)


def test_rdma_rejects_what_the_kernel_does_not_take(card):
    from acg_torch.parallel import rdma_halo

    partner = np.full((8, 200), -1, dtype=np.int32)
    two = make_mesh(2, [card] * 2)
    with pytest.raises(AcgError):           # bf16: not 4- or 8-byte words
        rdma_halo.RdmaState(partner[:2, :1], 16, torch.bfloat16, two)
    with pytest.raises(AcgError):           # "cuda" without its index
        rdma_halo.RdmaState(partner[:2, :1], 16, torch.float32,
                            [torch.device("cuda")] * 2)
    # 1600 blocks cannot all be resident: refused before any launch
    with pytest.raises(AcgError, match="resident"):
        rdma_halo.RdmaState(partner, 16, torch.float32,
                            make_mesh(8, [card] * 8))
    ok = rdma_halo.RdmaState(partner[:2, :1], 16, torch.float32, two)
    with pytest.raises(AcgError):           # another partner table
        rdma_halo.rdma_exchange([torch.zeros((1, 16), device=card)] * 2,
                                partner[:2, :1] + 1, ok)
    with pytest.raises(AcgError):           # another message shape
        rdma_halo.rdma_exchange([torch.zeros((1, 8), device=card)] * 2,
                                partner[:2, :1], ok)


def test_rdma_wait_times_out_instead_of_hanging(card, monkeypatch):
    """A grid whose partner never launches (as after a failed launch on
    another card) gives up at the state's timeout: the error word is set,
    check() raises, and the spoilt state refuses the next exchange."""
    from acg_torch.parallel import rdma_halo

    monkeypatch.setattr(rdma_halo, "TIMEOUT_S", 0.05)
    partner = np.array([[1], [0]], dtype=np.int32)
    state = rdma_halo.RdmaState(partner, 64, torch.float32,
                                make_mesh(2, [card] * 2))
    # launch shard 0's blocks alone: shard 1 never puts
    lt = state.launch_tables[0]
    state.launch_tables = [rdma_halo._Launch(lt.device, lt.local[:1],
                                             lt.shards, lt.partner, lt.sys)]
    send = [torch.ones((1, 64), device=card) for _ in range(2)]
    rdma_halo.rdma_exchange(send, partner, state)
    torch.cuda.synchronize()
    assert int(state.err[0].item()) == 1 and int(state.err[1].item()) == 0
    assert int(state.epoch[0][0].item()) == 0
    with pytest.raises(AcgError, match="did not arrive"):
        state.check()
    before = rdma_halo.launches
    with pytest.raises(AcgError, match="spoilt"):
        rdma_halo.rdma_exchange(send, partner, state)
    assert rdma_halo.launches == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("edge", [9, 12])        # S = 81 (odd), 144-36
def test_fused_halo_matches_every_transport(card, edge, P, dtype):
    """The put+signal halo with its pack and unpack fused in, P shards
    sharing the card (GPU scope): one launch an exchange, ghosts bit-equal
    to its plain version, halo_ppermute and halo_allgather over three
    exchanges (both receive parities), every flag and epoch advanced
    once an exchange; a state made for other tables is refused."""
    from acg_torch.parallel import rdma_halo
    from acg_torch.parallel.halo import halo_allgather, halo_ppermute
    from acg_torch.solvers.cg_dist import build_sharded

    A = poisson.poisson3d_7pt(edge)
    ss = build_sharded(A, nparts=P, devices=[card] * P, dtype=dtype,
                       method="rdma")
    state, st = ss.rdma, ss.tables
    assert state.scope == "gpu" and state.tables is st
    gen = np.random.default_rng(edge * 10 + P)
    for rep in range(3):
        xs = [torch.from_numpy(gen.standard_normal(op.nrows_padded).astype(
            dtype)).to(card) for op in ss.local_ops]
        before = rdma_halo.launches
        got = [g.clone() for g in rdma_halo.halo_rdma(xs, st, state)]
        torch.cuda.synchronize()
        assert rdma_halo.launches == before + 1
        state.check()
        for a, b, c, d in zip(got, rdma_halo.halo_rdma_plain(xs, st),
                              halo_ppermute(xs, st), halo_allgather(xs, st)):
            assert torch.equal(a, b) and torch.equal(a, c)
            assert torch.equal(a, d)
        for fl, ep in zip(state.flags, state.epoch):
            assert torch.all(fl == rep + 1) and torch.all(ep == rep + 1)
    other = build_sharded(A, nparts=P, devices=[card] * P, dtype=dtype)
    with pytest.raises(AcgError):
        rdma_halo.halo_rdma(xs, other.tables, state)


@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,width", [(1, 1, 1), (300, 7, 5),
                                       (5000, 123, 33)])
def test_ell_spmv_rectangle_matches_plain(card, n, m, width, vdt):
    """The interface operator's shape (n rows over m ghost slots): with
    small-integer values every sum is exact in any order, so y must equal
    the plain version bit for bit; with random values, within _TOL."""
    from acg_torch.ops import spmv

    from acg_torch.ops import sliced

    rng = np.random.default_rng(n + m)
    cols = torch.from_numpy(rng.integers(0, m, (n, width)).astype(np.int32))
    for exact in (True, False):
        if exact:
            vals = torch.from_numpy(rng.integers(-8, 9, (n, width)))
            x = torch.from_numpy(rng.integers(-8, 9, m))
        else:
            vals = torch.from_numpy(rng.standard_normal((n, width)))
            x = torch.from_numpy(rng.standard_normal(m))
        vals, x = vals.to(vdt).to(card), x.to(vdt).to(card)
        op = sliced.slice_ell(vals, cols.to(card), m)
        before = spmv.launches
        y = spmv.ell_spmv(op, x)
        assert spmv.launches == before + 1 and y.shape == (n,)
        want = spmv.ell_matvec(vals, cols.to(card), x)
        if exact:
            assert torch.equal(y, want)
        else:
            rtol, atol, _ = _TOL[vdt]
            assert float((y - want).abs().max()) <= atol + rtol * float(
                want.abs().max())


@pytest.mark.parametrize("fmt,dtype", [("auto", np.float64),
                                       ("dia", np.float32),
                                       ("ell", np.float64)])
def test_cg_dist_rdma_equals_ppermute_on_the_card(card, fmt, dtype):
    """Four shards on the one card: the put+signal halo gives the
    ppermute halo's x bit for bit, launching once per exchange; the CPU
    solve agrees within the tolerances of one device."""
    from acg_torch.parallel import rdma_halo
    from acg_torch.solvers.cg_dist import build_sharded, cg_dist

    A = poisson.poisson3d_7pt(12)
    rng = np.random.default_rng(4)
    b = A.matvec(rng.standard_normal(A.nrows)).astype(dtype)
    rtol = 1e-5 if dtype == np.float32 else 1e-10
    o = SolverOptions(maxits=1000, residual_rtol=rtol)
    ss = build_sharded(A, nparts=4, devices=[card] * 4, dtype=dtype,
                       fmt=fmt)
    out = {}
    for m in ("ppermute", "allgather", "rdma"):
        before = rdma_halo.launches
        out[m] = cg_dist(ss.with_halo(m), b, options=o)
        n = rdma_halo.launches - before
        assert n == (out[m].niterations + 1 if m == "rdma" else 0)
        assert out[m].kernel.startswith("cuda-") and \
            out[m].kernel.endswith("+" + m)
    for m in ("allgather", "rdma"):
        assert out[m].niterations == out["ppermute"].niterations
        assert np.array_equal(out[m].x, out["ppermute"].x)
    host = cg_dist(A, b, options=o, nparts=4, devices=["cpu"] * 4,
                   dtype=dtype, fmt=fmt)
    assert abs(host.niterations - out["rdma"].niterations) <= (
        1 if dtype == np.float32 else 0)
    x = out["rdma"].x.astype(np.float64)
    assert np.linalg.norm(b - A.matvec(x)) <= 10 * rtol * np.linalg.norm(b)


def test_rdma_and_cg_dist_across_cards(card):
    """Shards spread over the visible cards: the puts go through
    peer-mapped addresses; the delivery equals the plain version, and a
    solve gives the one-card layout's bits."""
    from acg_torch.parallel import rdma_halo
    from acg_torch.solvers.cg_dist import build_sharded, cg_dist

    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        pytest.skip("needs two or more cards")
    devs = [torch.device("cuda", i % n_dev) for i in range(4)]
    partner = _partner_table(4, 3, seed=11)
    state = rdma_halo.RdmaState(partner, 5000, torch.float64, devs)
    assert state.scope == "sys"           # partners on other cards
    gen = np.random.default_rng(12)
    for _ in range(3):
        send = [torch.from_numpy(gen.standard_normal((3, 5000))).to(d)
                for d in devs]
        got = [o.clone() for o in
               rdma_halo.rdma_exchange(send, partner, state)]
        for d in dict.fromkeys(devs):
            torch.cuda.synchronize(d)
        want = rdma_halo.rdma_exchange_plain(send, partner)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    A = poisson.poisson3d_7pt(12)
    b = A.matvec(np.random.default_rng(4).standard_normal(A.nrows))
    o = SolverOptions(maxits=1000, residual_rtol=1e-10)
    one = cg_dist(A, b, options=o, nparts=4, devices=[card] * 4,
                  method="rdma")
    for m in ("rdma", "ppermute", "allgather"):
        many = cg_dist(A, b, options=o, nparts=4, devices=devs, method=m)
        assert many.niterations == one.niterations, m
        assert np.array_equal(many.x, one.x), m


# ---------------------------------------------------------------------------
# distributed pipelined, multi-RHS and compressed-wire paths


def _two_components():
    """A 7 x 9 grid and, beside it, a 5 x 3 grid with no edge between
    them, split into parts of 21, 19 and 23 rows (odd lengths) and one
    part holding the second grid alone (a shard with no ghosts)."""
    from acg_torch.sparse.csr import coo_to_csr

    A1, A2 = poisson.poisson2d_5pt(7, 9), poisson.poisson2d_5pt(5, 3)
    r1, c1, v1 = A1.to_coo()
    r2, c2, v2 = A2.to_coo()
    n = A1.nrows + A2.nrows
    A = coo_to_csr(np.concatenate([r1, r2 + A1.nrows]),
                   np.concatenate([c1, c2 + A1.nrows]),
                   np.concatenate([v1, v2]), n, n)
    part = np.repeat(np.arange(4, dtype=np.int32), [21, 19, 23, A2.nrows])
    return A, part


def _dist_case(kind):
    if kind == "dia-two-components":
        A, part = _two_components()
        return A, dict(part=part, fmt="dia")
    return poisson.poisson3d_7pt(12), dict(nparts=4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["dia-two-components", "stencil"])
def test_dist_pipe_step_matches_plain(card, kind, dtype):
    """One step of the per-shard single-kernel pipelined iteration with
    the interface folded in, four shards on the card under each halo,
    against the same step on the CPU (the kernels' plain versions)."""
    import importlib

    from acg_torch.solvers.cg_dist import build_sharded

    cgd = importlib.import_module("acg_torch.solvers.cg_dist")
    A, kw = _dist_case(kind)
    gpu = build_sharded(A, devices=[card] * 4, dtype=dtype, **kw)
    cpu = build_sharded(A, devices=["cpu"] * 4, dtype=dtype, **kw)
    assert gpu.local_fmt == ("dia" if kind.startswith("dia") else "stencil")
    if kind.startswith("dia"):
        assert gpu.iface[3] is None
        assert [p.nown % 2 for p in gpu.ps.parts[:3]] == [1, 1, 1]
    rng = np.random.default_rng(3)
    vecs = [rng.standard_normal(A.nrows).astype(dtype) for _ in range(6)]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    rtol, atol, dot_rtol = _TOL[tdt]

    def run(ss):
        z, r, p, w, s, x = (ss.to_sharded(v) for v in vecs)
        dev = ss.devices[0]
        ab = (torch.tensor(0.37, dtype=tdt, device=dev),
              torch.tensor(1.21, dtype=tdt, device=dev))
        out = cgd._pipe_step(ss, dev, "f32")(z, r, p, w, s, x, *ab)
        return [ss.from_sharded(v) for v in out[:6]], out[6:], [
            [t.cpu() for t in v] for v in out[:6]]

    want, (gw, dw), _ = run(cpu)
    for halo in ("ppermute", "allgather", "rdma"):
        got, (gg, dg), shards = run(gpu.with_halo(halo))
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= atol + rtol * np.abs(w).max()
        r2, w2 = want[4].astype(np.float64), want[5].astype(np.float64)
        assert abs(float(gg) - float(gw)) <= dot_rtol * (r2 @ r2)
        assert abs(float(dg) - float(dw)) <= dot_rtol * (
            np.linalg.norm(r2) * np.linalg.norm(w2))
        for op, v in zip(gpu.local_ops, shards[0]):
            assert bool(torch.all(v[op.nrows:] == 0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["dia-two-components", "stencil"])
def test_cg_pipelined_dist_on_the_card(card, kind, dtype):
    """A whole distributed pipelined solve on four shards of the card:
    the single-kernel iteration once a shard an iteration, the same x bit
    for bit under the three halos, the CPU solve's count (f64; within 1
    at f32) and a certified residual.  f32 solves to rtol 1e-4, an order
    above the f32 floor eps·κ of these operators (about 4e-6), near
    which the pipelined recurrences of two roundings part (ROADMAP Queue
    3, not faults)."""
    from acg_torch.ops import dia_kernels
    from acg_torch.ops import stencil as stn
    from acg_torch.solvers.cg_dist import build_sharded, cg_pipelined_dist

    A, kw = _dist_case(kind)
    b = A.matvec(np.random.default_rng(4).standard_normal(A.nrows)).astype(
        dtype)
    rtol = 1e-4 if dtype == np.float32 else 1e-10
    o = SolverOptions(maxits=1000, residual_rtol=rtol)
    ss = build_sharded(A, devices=[card] * 4, dtype=dtype, **kw)
    tier = ss.local_fmt
    out = {}
    for m in ("ppermute", "allgather", "rdma"):
        before = (dia_kernels.pipe_launches + stn.pipe_launches)
        out[m] = cg_pipelined_dist(ss.with_halo(m), b, options=o)
        n = dia_kernels.pipe_launches + stn.pipe_launches - before
        assert n == 4 * out[m].niterations
        assert out[m].kernel == f"cuda-{tier}-pipe+{m}"
    for m in ("allgather", "rdma"):
        assert out[m].niterations == out["ppermute"].niterations
        assert np.array_equal(out[m].x, out["ppermute"].x)
    host = cg_pipelined_dist(A, b, options=o, devices=["cpu"] * 4,
                             dtype=dtype, **kw)
    assert abs(host.niterations - out["rdma"].niterations) <= (
        1 if dtype == np.float32 else 0)
    x = out["rdma"].x.astype(np.float64)
    assert np.linalg.norm(b - A.matvec(x)) <= 10 * rtol * np.linalg.norm(b)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("fmt", ["auto", "dia", "ell"])
def test_dist_batched_on_the_card(card, fmt, pipelined):
    """A (B, n) solve on four shards of the card: the multi-RHS kernels
    (the one-system kernel once per system on ELL), the CPU solve's
    per-system counts and x within 1e-10."""
    from acg_torch.ops import dia_kernels
    from acg_torch.ops import stencil as stn
    from acg_torch.solvers.cg_dist import cg_dist, cg_pipelined_dist

    A = poisson.poisson3d_7pt(12)
    rng = np.random.default_rng(6)
    b = np.stack([A.matvec(rng.standard_normal(A.nrows)) for _ in range(3)])
    o = SolverOptions(maxits=1000, residual_rtol=1e-10)
    fn = cg_pipelined_dist if pipelined else cg_dist
    one = (dia_kernels.launches + stn.launches + dia_kernels.pipe_launches
           + stn.pipe_launches)
    got = fn(A, b, options=o, nparts=4, devices=[card] * 4, fmt=fmt,
             method="allgather")
    assert one == (dia_kernels.launches + stn.launches
                   + dia_kernels.pipe_launches + stn.pipe_launches)
    want = fn(A, b, options=o, nparts=4, devices=["cpu"] * 4, fmt=fmt,
              method="allgather")
    np.testing.assert_array_equal(got.iterations_per_system,
                                  want.iterations_per_system)
    for s in range(3):
        assert np.linalg.norm(got.x[s] - want.x[s]) <= 1e-10 * np.linalg.norm(
            want.x[s])
    tier = {"auto": "stencil"}.get(fmt, fmt)
    body = "spmv" if fmt == "ell" else "batched"
    assert got.kernel == f"cuda-{tier}-{body}+allgather"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int16-delta"])
def test_batched_ghosts_and_wire_on_the_card(card, wire, dtype):
    """The halos of one system and of a (B, n) batch, under each wire, on
    the card bit-equal to the same exchange on the CPU; the codec alone
    too, on random, constant and batched messages."""
    from acg_torch.parallel import halo
    from acg_torch.solvers.cg_dist import build_sharded

    A = poisson.poisson3d_27pt(8)
    gpu = build_sharded(A, nparts=4, devices=[card] * 4, fmt="ell")
    cpu = build_sharded(A, nparts=4, devices=["cpu"] * 4, fmt="ell")
    gen = torch.Generator().manual_seed(9)
    for shape in ((), (5,)):
        xs = [torch.randn(shape + (op.nrows_padded,), generator=gen,
                          dtype=torch.float64).to(dtype) * 4 + 1
              for op in cpu.local_ops]
        for fn in (halo.halo_ppermute, halo.halo_allgather):
            got = fn([x.to(card) for x in xs], gpu.tables, wire)
            want = fn(xs, cpu.tables, wire)
            for g, w in zip(got, want):
                assert g.shape == w.shape and torch.equal(g.cpu(), w)
    msgs = [torch.randn(1001, generator=gen, dtype=torch.float64) * 30,
            torch.full((64,), -2.5, dtype=torch.float64),
            torch.randn(3, 257, generator=gen, dtype=torch.float64)]
    for m in msgs:
        m = m.to(dtype)
        enc = halo.wire_encode(m.to(card), wire)
        assert torch.equal(enc.cpu(), halo.wire_encode(m, wire))
        assert torch.equal(halo.wire_decode(enc, wire, dtype).cpu(),
                           halo.wire_decode(halo.wire_encode(m, wire), wire,
                                            dtype))


# ---------------------------------------------------------------------------
# the s-step and deep-pipelined solvers: the Gram, the basis, the solves


def test_gram_f32_never_tf32(card):
    """The f32 Gram, block_dot and combine run at f32 whatever the global
    TF32 setting (the s-step decisions stand on them): against the f64
    products within f32 rounding, where TF32 would be ~1e-3 off; the
    setting is restored."""
    from acg_torch.ops import blas1

    g = torch.Generator(device=card).manual_seed(0)
    V64 = torch.randn((9, 1 << 20), dtype=torch.float64, device=card,
                      generator=g)
    V = V64.to(torch.float32)
    Vb = V64.reshape(9, 4, -1).to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for got, want in (
                (blas1.gram(V), blas1.gram(V.double())),
                (blas1.gram(Vb), blas1.gram(Vb.double())),
                (blas1.block_dot(V, V[3]), blas1.block_dot(V.double(),
                                                           V[3].double())),
                (blas1.combine(V[:, 5], V),
                 blas1.combine(V[:, 5].double(), V.double()))):
            err = float((got.double() - want).abs().max())
            assert err <= 1e-5 * float(want.abs().max()), err
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("vdt", [np.float32, np.float64])
@pytest.mark.parametrize("tier", ["stencil", "dia", "hbm"])
def test_sstep_basis_padding_stays_zero(card, tier, vdt):
    """Every basis vector mv(v) - theta v of an s-step block keeps the
    padded rows at exactly 0 on grids of nrows % 8 != 0 (the Gram reduces
    over them), through stencil_spmv, dia_spmv and dia_spmv_windows
    without the dot; V and G against the same block on the CPU."""
    from acg_torch.ops import dia_plan
    from acg_torch.solvers.cg import _sstep_block_fn, build_device_operator

    s = 4
    A = poisson.poisson3d_7pt(37, 29, 11)            # 11,803 rows
    n = A.nrows
    assert n % 8
    fmt = "stencil" if tier == "stencil" else "dia"
    op = build_device_operator(A, dtype=vdt, fmt=fmt, device=card)
    cpu = build_device_operator(A, dtype=vdt, fmt=fmt, device="cpu")
    if tier == "hbm":
        vt = getattr(torch, op.vec_dtype)
        b = dia_plan.device_budgets(card)
        tile = dia_plan.windows_plan(op.nrows_padded, op.offsets, vt,
                                     op.bands.dtype, b)
        op = dataclasses.replace(op, plan=dia_plan.make_plan(
            "hbm", tile, op.nrows_padded, op.offsets, vt, op.bands.dtype, b,
            device=card))
    rng = np.random.default_rng(5)
    vecs = []
    for _ in range(3):
        v = np.zeros(op.nrows_padded, vdt)
        v[:n] = rng.standard_normal(n)
        vecs.append(torch.from_numpy(v))
    shifts = np.array([11.0, 0.5, 7.0, 3.0], vdt)
    before = dict(st=st.launches, dia=dia_kernels.launches,
                  win=dia_kernels.windows_launches)
    V, G = _sstep_block_fn(op.matvec, vecs[0].to(card), s)(
        vecs[1].to(card), vecs[2].to(card), shifts)
    Vc, Gc = _sstep_block_fn(cpu.matvec, vecs[0], s)(vecs[1], vecs[2],
                                                     shifts)
    assert torch.all(V[:, n:] == 0)
    launched = {"stencil": st.launches - before["st"],
                "dia": dia_kernels.launches - before["dia"],
                "hbm": dia_kernels.windows_launches - before["win"]}
    assert launched[tier] == 2 * s
    rtol = 1e-12 if vdt == np.float64 else 1e-5
    assert float((V.cpu() - Vc).abs().max()) <= rtol * float(Vc.abs().max())
    assert float((G.cpu() - Gc).abs().max()) <= rtol * float(Gc.abs().max())


@pytest.mark.parametrize("solver", ["sstep", "deep", "recycled"])
@pytest.mark.parametrize("batch", [0, 3])
def test_sstep_deep_recycled_on_the_card(card, solver, batch):
    """Whole solves on the card against the same solves on the CPU: the
    same counts (±1), x within 1e-9, certified; the loops launch only the
    plain SpMV kernel (the batched one for a batch).  The deep solve
    restarts every 50 updates, the residual replacement at which both
    packages reach the same counts in the same dispatches
    (scripts/torch_sstep_deep.py)."""
    from acg_torch.solvers.cg import cg_pipelined_deep, cg_recycled, cg_sstep

    A = poisson.poisson3d_7pt(20, 18, 13)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((batch, A.nrows) if batch else A.nrows)
    o = SolverOptions(maxits=2000, residual_rtol=1e-10, sstep=4,
                      pipeline_depth=2,
                      replace_every=50 if solver == "deep" else 0)
    kw = {}
    if solver == "recycled":
        W, _ = np.linalg.qr(rng.standard_normal((A.nrows, 4)))
        kw = dict(W=W, WtAW=W.T @ np.stack([A.matvec(w) for w in W.T], 1))
    fn = {"sstep": cg_sstep, "deep": cg_pipelined_deep,
          "recycled": cg_recycled}[solver]
    before = (st.launches, st.batched_launches, st.pipe_launches)
    rg = fn(A, b, options=o, device=card, **kw)
    launched = (st.launches - before[0], st.batched_launches - before[1],
                st.pipe_launches - before[2])
    rc = fn(A, b, options=o, device="cpu", **kw)
    assert rg.converged and rc.converged
    assert np.all(np.abs(np.asarray(rg.iterations_per_system if batch
                                    else rg.niterations)
                         - (rc.iterations_per_system if batch
                            else rc.niterations)) <= 1)
    assert np.linalg.norm(rg.x - rc.x) <= 1e-9 * np.linalg.norm(rc.x)
    body = ("batched" if batch else "fused" if solver == "recycled"
            else "spmv")
    assert rg.kernel == f"cuda-stencil-{body}"
    assert launched[2] == 0
    assert (launched[1] > 0 and launched[0] == 0) if batch else \
        (launched[0] > 0 and launched[1] == 0)


@pytest.mark.parametrize("batch", [0, 3])
def test_deep_without_replacement_certifies_on_the_card(card, batch):
    """The deep solve with no residual replacement at rtol 1e-10: its
    recurrence drifts from the true residual there in both packages, so
    its counts are not compared; every exit it claims must be certified,
    by the solve's own true residual and by one recomputed on the host
    in float64."""
    from acg_torch.solvers.cg import cg_pipelined_deep

    A = poisson.poisson3d_7pt(20, 18, 13)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((batch, A.nrows) if batch else A.nrows)
    rtol = 1e-10
    res = cg_pipelined_deep(A, b, options=SolverOptions(
        maxits=2000, residual_rtol=rtol, pipeline_depth=2), device=card)
    assert res.converged
    rn = res.rnrm2_per_system if batch else np.array([res.rnrm2])
    r0 = res.r0nrm2_per_system if batch else np.array([res.r0nrm2])
    assert np.all(rn <= rtol * r0)
    for x, bb in zip(np.atleast_2d(res.x), np.atleast_2d(b)):
        true = np.linalg.norm(bb - A.matvec(x)) / np.linalg.norm(bb)
        assert true <= 2 * rtol, true


@pytest.mark.parametrize("depth", [2, 4])
def test_deep_interface_and_skin_ell_match_plain(card, depth):
    """ell_spmv on each shard's deep interface (border rows x deep ghost
    slots) and skin (ghost-interior rows x [owned | deep ghosts]) bit for
    bit against its plain version (sliced_matvec) on the same layout, and
    within 1e-13 relative at f64 of the host CSR product on those rows."""
    from acg_torch.ops.sliced import sliced_matvec
    from acg_torch.ops.spmv import ell_spmv
    from acg_torch.parallel.deep import build_deep_device
    from acg_torch.solvers.cg_dist import build_sharded

    A = poisson.poisson3d_7pt(16)
    ss = build_sharded(A, nparts=4, devices=[card] * 4)
    dd = build_deep_device(ss, depth)
    gen = torch.Generator(device="cuda").manual_seed(3)
    launched = 0
    for i in range(4):
        for opr, M in ((dd.iface[i], dd.host.iface[i]),
                       (dd.skin[i], dd.host.skin[i])):
            op, rows = opr
            x = torch.randn(M.ncols, generator=gen, dtype=torch.float64,
                            device="cuda")
            y = ell_spmv(op, x)
            launched += 1
            assert torch.equal(y, sliced_matvec(op, x))
            want = M.matvec(x.cpu().numpy())[rows.cpu().numpy()]
            err = float(np.abs(y.cpu().numpy() - want).max())
            assert err <= 1e-13 * float(np.abs(want).max())
    assert launched == 8


@pytest.mark.parametrize("solver", ["sstep", "deep"])
def test_sstep_deep_dist_on_the_card_match_cpu(card, solver):
    """cg_sstep_dist (s = 4) and cg_pipelined_deep_dist (depth 2,
    replace_every=50) on four shards of the card against the same solves
    on four CPU shards at 16^3 f64: counts within 1, x within 1e-9, the
    stencil SpMV without the dot and ell_spmv on the deep operators
    launched, ppermute and allgather giving the same bits."""
    from acg_torch.ops import spmv
    from acg_torch.solvers.cg_dist import (build_sharded,
                                           cg_pipelined_deep_dist,
                                           cg_sstep_dist)

    A = poisson.poisson3d_7pt(16)
    b = A.matvec(np.random.default_rng(6).standard_normal(A.nrows))
    o = SolverOptions(maxits=2000, residual_rtol=1e-10, sstep=4,
                      pipeline_depth=2,
                      replace_every=50 if solver == "deep" else 0)
    fn = cg_sstep_dist if solver == "sstep" else cg_pipelined_deep_dist
    ss = build_sharded(A, nparts=4, devices=[card] * 4)
    before = (st.launches, spmv.launches)
    rg = fn(ss, b, options=o)
    launched = (st.launches - before[0], spmv.launches - before[1])
    ra = fn(ss.with_halo("allgather"), b, options=o)
    rc = fn(A, b, options=o, nparts=4, devices=["cpu"] * 4)
    assert rg.converged and rc.converged
    assert abs(rg.niterations - rc.niterations) <= 1
    assert np.linalg.norm(rg.x - rc.x) <= 1e-9 * np.linalg.norm(rc.x)
    assert rg.niterations == ra.niterations
    assert np.array_equal(rg.x, ra.x)
    assert rg.kernel == "cuda-stencil-spmv+ppermute"
    assert "deep ghost zones depth" in rg.kernel_note
    assert launched[0] > 0 and launched[1] > 0
    assert np.linalg.norm(b - A.matvec(rg.x)) <= 10 * 1e-10 * \
        np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the fused classic-CG update and the device-resident (graph) loop


@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 257, 100_003, 1_048_576 + 5])
@pytest.mark.parametrize("nsys", [0, 3])
@pytest.mark.parametrize("want_pp", [False, True])
def test_cg_update_matches_plain(card, vdt, n, nsys, want_pp):
    """x and r bit for bit against the two addcmul_ of the plain
    version; the dots in the kernel's own fixed order, within rounding of
    torch.dot and the same on every run; every row of a (B, n) call
    bit-equal to the one-system call on that row; one launch a call and
    the ticket counters back at 0."""
    from acg_torch.ops import cg_update as cu

    shape = (nsys, n) if nsys else (n,)
    g = torch.Generator(device="cpu").manual_seed(n + nsys)
    x, r, p, t = (torch.randn(shape, generator=g, dtype=torch.float64)
                  .to(vdt).to(card) for _ in range(4))
    alpha = (torch.rand(nsys or (), generator=g, dtype=torch.float64)
             .to(vdt).to(card))
    xp, rp = x.clone(), r.clone()
    rr_p, pp_p = cu.cg_update_plain(xp, rp, p, t, alpha, want_pp)
    runs = []
    for _ in range(2):
        xk, rk = x.clone(), r.clone()
        before = cu.launches
        rr, pp = cu.cg_update(xk, rk, p, t, alpha, want_pp)
        assert cu.launches == before + 1
        runs.append((xk, rk, rr.clone(), None if pp is None else pp.clone()))
    xk, rk, rr, pp = runs[0]
    assert torch.equal(xk, xp) and torch.equal(rk, rp)
    assert torch.equal(rr, runs[1][2])
    tol = 1e-12 if vdt == torch.float64 else 2e-5
    assert torch.allclose(rr, rr_p, rtol=tol, atol=0)
    if want_pp:
        assert torch.equal(pp, runs[1][3])
        assert torch.allclose(pp, pp_p, rtol=tol, atol=0)
    else:
        assert pp is None
    if nsys:
        for i in range(nsys):
            x1, r1 = x[i].clone(), r[i].clone()
            rr1, pp1 = cu.cg_update(x1, r1, p[i].contiguous(),
                                    t[i].contiguous(),
                                    alpha[i].contiguous(), want_pp)
            assert torch.equal(x1, xk[i]) and torch.equal(r1, rk[i])
            assert torch.equal(rr1, rr[i])
            if want_pp:
                assert torch.equal(pp1, pp[i])
    torch.cuda.synchronize()
    for counter, _ in cu._scratch.values():
        assert int(counter.abs().sum()) == 0


def test_cg_update_rejects_what_the_kernel_does_not_take(card):
    from acg_torch.ops.cg_update import cg_update

    v = torch.zeros(64, dtype=torch.float64, device=card)
    a = torch.zeros((), dtype=torch.float64, device=card)
    with pytest.raises(AcgError):
        cg_update(v, v.clone(), v, v[:32], a)             # shapes
    with pytest.raises(AcgError):
        cg_update(v, v.clone(), v, v, a.float())          # alpha dtype
    with pytest.raises(AcgError):
        cg_update(v, v, v, v, a)                          # x is r
    with pytest.raises(AcgError):
        cg_update(v.half(), v.half(), v.half(), v.half(), a.half())
    w = torch.zeros((2, 64), dtype=torch.float64, device=card)
    with pytest.raises(AcgError):
        cg_update(w, w.clone(), w, w, a)                  # alpha per system


def _both_loops(solve, *args, **kw):
    """The same solve with the open loop and the graph loop, each with
    the launch counters it moved."""
    from acg_torch.solvers import graphs

    out = {}
    for loop in ("open", "graph"):
        before = graphs.counts()
        try:
            res = solve(*args, loop=loop, **kw)
        except AcgError as e:
            res = e.result
        out[loop] = (res, [a - b for a, b in
                           zip(graphs.counts(), before)])
    return out


def _same_bits(out):
    (ro, co), (rg, cg_) = out["open"], out["graph"]
    assert ro.loop == "open" and rg.loop == "graph"
    assert rg.niterations == ro.niterations
    assert np.array_equal(rg.x, ro.x)
    assert np.array_equal(rg.residual_history, ro.residual_history,
                          equal_nan=True)
    assert rg.rnrm2 == ro.rnrm2 and rg.converged == ro.converged
    if ro.iterations_per_system is not None:
        assert np.array_equal(rg.iterations_per_system,
                              ro.iterations_per_system)
    assert cg_ == co                       # replays counted
    assert rg.stats.ncaptures >= 1 and rg.stats.nreplays >= 1
    assert rg.stats.tcapture > 0


_GRAPH_CASES = {
    # name: (solver, fmt, dtype, nrhs, options)
    "classic-stencil-f64": ("cg", "auto", np.float64, 0,
                            dict(maxits=400, residual_rtol=1e-10)),
    "classic-dia-f32-check3": ("cg", "dia", np.float32, 0,
                               dict(maxits=400, residual_rtol=1e-5,
                                    check_every=3)),
    "classic-diff": ("cg", "auto", np.float64, 0,
                     dict(maxits=400, residual_rtol=0.0, diffatol=1e-9)),
    "pipelined-stencil-check3": ("cg_pipelined", "auto", np.float64, 0,
                                 dict(maxits=400, residual_rtol=1e-10,
                                      check_every=3)),
    "pipelined-dia-bf16": ("cg_pipelined", "dia", np.float32, 0,
                           dict(maxits=100, residual_rtol=0.0)),
    "pipelined-replace": ("cg_pipelined", "auto", np.float64, 0,
                          dict(maxits=400, residual_rtol=1e-10,
                               replace_every=10, check_every=4)),
    "pipelined-guard": ("cg_pipelined", "auto", np.float64, 0,
                        dict(maxits=400, residual_rtol=1e-10,
                             guard_nonfinite=True, check_every=5)),
    "batched-classic": ("cg", "auto", np.float64, 3,
                        dict(maxits=400, residual_rtol=1e-10)),
    "batched-pipelined": ("cg_pipelined", "dia", np.float64, 3,
                          dict(maxits=400, residual_rtol=1e-10,
                               check_every=2, replace_every=6,
                               guard_nonfinite=True)),
    "segmented": ("cg", "auto", np.float64, 0,
                  dict(maxits=400, residual_rtol=1e-10, segment_iters=7,
                       check_every=16)),
}


@pytest.mark.parametrize("case", sorted(_GRAPH_CASES))
def test_graph_loop_equals_open_loop(card, case):
    """Each block captured once and replayed gives the open loop's bits:
    x, the count, the history, the exit; the launch counters move by
    the same counts (a replay adds the counts its capture recorded)."""
    solvers = {"cg": cg, "cg_pipelined": cg_pipelined}
    solver, fmt, dtype, nrhs, o = _GRAPH_CASES[case]
    A = poisson.poisson3d_7pt(14)
    rng = np.random.default_rng(7)
    b = np.stack([A.matvec(v) for v in
                  rng.standard_normal((max(nrhs, 1), A.nrows))])
    b = b[0] if not nrhs else b
    kw = dict(mat_dtype="bfloat16") if case == "pipelined-dia-bf16" else {}
    out = _both_loops(solvers[solver], A, b,
                      options=SolverOptions(**o), dtype=dtype, fmt=fmt,
                      **kw)
    _same_bits(out)


@pytest.mark.parametrize("method", ["ppermute", "allgather", "rdma"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_graph_loop_equals_open_loop_on_shards(card, method, pipelined):
    """Four shards on the one card, each halo (the put+signal kernel's
    cooperative launch inside the capture): graph against open, bit for
    bit, rdma_exchange counted once per replayed exchange."""
    from acg_torch.solvers.cg_dist import (build_sharded, cg_dist,
                                           cg_pipelined_dist)

    A = poisson.poisson3d_7pt(12)
    b = A.matvec(np.random.default_rng(4).standard_normal(A.nrows))
    ss = build_sharded(A, nparts=4, devices=[card] * 4, method=method)
    o = SolverOptions(maxits=600, residual_rtol=1e-10, check_every=4)
    out = _both_loops(cg_pipelined_dist if pipelined else cg_dist, ss, b,
                      options=o)
    _same_bits(out)
    assert "open loop" not in out["graph"][0].kernel_note


def test_graph_loop_monitor_and_segments(card):
    """monitor_every through the graph loop: the lines the open loop
    emits, the history's values at their iterations; segment_iters
    changes no bit."""
    from acg_torch.obs import monitor

    A = poisson.poisson3d_7pt(12)
    b = A.matvec(np.random.default_rng(2).standard_normal(A.nrows))
    lines = {}
    for loop in ("open", "graph"):
        got = []

        def sink(k, rr, got=got):
            got.append((k, rr))

        monitor.add_monitor_sink(sink)
        try:
            with monitor.muted():
                res = cg(A, b, options=SolverOptions(
                    maxits=500, residual_rtol=1e-10, monitor_every=3,
                    check_every=5), loop=loop)
        finally:
            monitor.remove_monitor_sink(sink)
        lines[loop] = got
        ks = [k for k, _ in got]
        assert ks == list(range(3, res.niterations + 1, 3))
        for k, rr in got:
            assert rr == res.residual_history[k]
    assert lines["open"] == lines["graph"]
    seg = cg(A, b, options=SolverOptions(maxits=500, residual_rtol=1e-10,
                                         segment_iters=7), loop="graph")
    plain = cg(A, b, options=SolverOptions(maxits=500, residual_rtol=1e-10),
               loop="graph")
    assert np.array_equal(seg.x, plain.x)
    assert seg.niterations == plain.niterations


def test_graph_capture_failure_raises(card):
    """A block that reads the device inside cannot be captured: the
    runner raises (no quiet fall back to launching from the host) and
    leaves the counters as they were."""
    from acg_torch.ops import cg_update as cu
    from acg_torch.solvers.graphs import BlockRunner

    v = torch.ones(8, device=card)

    def block():
        cu.launches += 1
        float(v.sum())                     # a host read

    runner = BlockRunner(card, graph=True)
    runner.run("k", block)                 # the eager warm-up block
    before = cu.launches
    with pytest.raises(AcgError, match="capture"):
        runner.run("k", block)
    assert cu.launches == before
    torch.cuda.synchronize()
    with pytest.raises(AcgError):
        BlockRunner("cpu", graph=True)
