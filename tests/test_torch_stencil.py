"""Port parity: stencil recognition and ``stencil_spmv`` against the JAX
package's matrix-free tier on the same operator.

Recognition must give the identical ``StencilSpec``; the port's
``stencil_spmv`` (plain grid-shift version on CPU tensors) must match
``stencil_matvec_pallas_padded(with_dot=True, interpret=True)``.
Tolerances: f64 rtol 1e-12, f32 rtol/atol 1e-5, the dot 1e-10 (f64) /
1e-4 (f32) relative to |x|·|y|.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from acg_tpu.ops import dia as jdia
from acg_tpu.ops import pallas_kernels as pk
from acg_tpu.ops import stencil as jst
from acg_tpu.sparse import poisson as jpoisson

from acg_torch import convert
from acg_torch.errors import AcgError
from acg_torch.ops import dia as tdia
from acg_torch.ops import stencil as tst
from acg_torch.sparse import poisson as tpoisson

ROWS_TILE = 8
_TOL = {np.float64: (1e-12, 0.0, 1e-10), np.float32: (1e-5, 1e-5, 1e-4)}

# (name, JAX generator, port generator) — the same in both packages
_STENCILS = [
    ("poisson2d_5pt", lambda: jpoisson.poisson2d_5pt(32),
     lambda: tpoisson.poisson2d_5pt(32)),
    ("poisson2d_5pt_rect", lambda: jpoisson.poisson2d_5pt(16, 24),
     lambda: tpoisson.poisson2d_5pt(16, 24)),
    ("poisson3d_7pt", lambda: jpoisson.poisson3d_7pt(16),
     lambda: tpoisson.poisson3d_7pt(16)),
    ("poisson3d_27pt", lambda: jpoisson.poisson3d_27pt(8),
     lambda: tpoisson.poisson3d_27pt(8)),
    ("poisson3d_7pt_dia", lambda: jpoisson.poisson3d_7pt_dia(12),
     lambda: tpoisson.poisson3d_7pt_dia(12)),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,jgen,tgen", _STENCILS,
                         ids=[s[0] for s in _STENCILS])
def test_recognize_stencil_matches_jax(name, jgen, tgen, dtype):
    jspec, jwhy = jst.recognize_stencil(jgen(), dtype=dtype)
    tspec, twhy = tst.recognize_stencil(tgen(), dtype=dtype)
    assert jspec is not None and tspec is not None, (jwhy, twhy)
    assert tspec.grid == jspec.grid
    assert tspec.offsets == jspec.offsets
    assert tspec.digits == jspec.digits
    assert tspec.coeffs == jspec.coeffs
    assert tspec.nnz == jspec.nnz
    assert tspec.spec_hash() == jspec.spec_hash()


@pytest.mark.parametrize("gen", [
    lambda m: m.poisson3d_7pt_varcoef(8),
    lambda m: m.random_spd(300, degree=4),
])
def test_recognize_stencil_rejects_like_jax(gen):
    jspec, jwhy = jst.recognize_stencil(gen(jpoisson))
    tspec, twhy = tst.recognize_stencil(gen(tpoisson))
    assert jspec is None and tspec is None
    assert twhy == jwhy


def test_forced_stencil_on_varcoef_raises():
    with pytest.raises(AcgError):
        tst.DeviceStencil.from_matrix(tpoisson.poisson3d_7pt_varcoef(6),
                                      device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,jgen,tgen", _STENCILS,
                         ids=[s[0] for s in _STENCILS])
def test_stencil_spmv_matches_pallas_padded(name, jgen, tgen, dtype):
    rtol, atol, dot_rtol = _TOL[dtype]
    jdev = jst.DeviceStencil.from_matrix(jgen(), dtype=dtype)
    tdev = convert.device_stencil_from_fields(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, jdev.nrows,
        jdev.nnz, dtype, device="cpu")
    n = jdev.nrows
    npad = -(-n // pk.LANES) * pk.LANES
    rng = np.random.default_rng(5)
    x = np.zeros(npad, dtype=dtype)
    x[:n] = rng.standard_normal(n)
    (xp,), front = pk.pad_dia_vectors((jnp.asarray(x),), npad, ROWS_TILE,
                                      jdev.offsets)
    yj, dj = jst.stencil_matvec_pallas_padded(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, xp,
        rows_tile=ROWS_TILE, n=n, with_dot=True, interpret=True)
    yj = np.asarray(yj)[front: front + npad]
    xt = torch.from_numpy(x)
    y, d = tst.stencil_spmv(tdev.spec, xt, with_dot=True)
    np.testing.assert_allclose(y.numpy(), yj, rtol=rtol, atol=atol)
    assert np.all(y.numpy()[n:] == 0.0)
    scale = np.linalg.norm(x) * np.linalg.norm(yj)
    assert abs(float(d) - float(dj)) <= dot_rtol * scale
    # without the dot: the same vector, bit for bit
    assert torch.equal(tdev.matvec(xt), y)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stencil_tier_matches_dia_tier(dtype):
    """The matrix-free action equals the stored-band action on the same
    system (the two tiers are interchangeable)."""
    rtol, atol, _ = _TOL[dtype]
    A = tpoisson.poisson3d_7pt(10)
    st, why = tst.try_device_stencil(A, dtype=dtype, device="cpu")
    assert st is not None, why
    dd = tdia.DeviceDia.from_dia(tdia.DiaMatrix.from_csr(A), dtype=dtype,
                                 device="cpu")
    assert st.nrows_padded == dd.nrows_padded
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        dd.nrows_padded).astype(dtype))
    x[A.nrows:] = 0
    np.testing.assert_allclose(st.matvec(x).numpy(), dd.matvec(x).numpy(),
                               rtol=rtol, atol=atol)


def test_c_spec_pads_to_three_axes():
    """The kernel's struct: a 2-D grid gains a leading unit axis and every
    arm a leading zero digit."""
    spec, _ = tst.recognize_stencil(tpoisson.poisson2d_5pt(6, 7))
    a = tst._c_spec(spec)
    assert a.narms == len(spec.offsets)
    assert list(a.dims) == [1, 6, 7]
    for i, (off, dg, c) in enumerate(zip(spec.offsets, spec.digits,
                                         spec.coeffs)):
        assert a.offsets[i] == off
        assert list(a.digits[i]) == [0] + list(dg)
        assert a.coeffs[i] == c


def test_device_stencil_holds_no_tensors():
    st, _ = tst.try_device_stencil(tpoisson.poisson2d_5pt(8), device="cpu")
    assert st.operator_stream_bytes() == 0
    assert st.mat_itemsize == 0
    assert not any(isinstance(v, torch.Tensor) for v in vars(st).values())
