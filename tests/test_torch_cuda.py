"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and skip elsewhere.  They cover what
``chip_smoke.py`` does not: small and ragged sizes, 1-D/2-D grids and
the 27-point stencil, offsets that leave the vector, every band tier,
the wrappers' argument checks and launch counts, and a whole solve on
the card against the same solve on the CPU.  The JAX package is not
needed (and not on the machine with the card), so run them without the
repository's root conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError
from acg_torch.ops import dia_kernels
from acg_torch.ops import stencil as st
from acg_torch.ops.dia import DeviceDia, DiaMatrix
from acg_torch.ops.dia_kernels import dia_matvec, dia_spmv
from acg_torch.solvers.cg import cg
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
