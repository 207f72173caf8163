"""Port parity: the DIA operator and ``dia_spmv`` against the JAX
package's DIA kernels on the same operator.

The JAX side builds ``DeviceDia.from_dia`` and runs its Pallas kernels in
interpret mode; ``acg_torch.convert`` carries the very same band arrays
across (bf16 through its uint16 bits), and ``dia_spmv`` on CPU tensors
runs its plain PyTorch version.  Tolerances: f64 rtol 1e-12 (fused
multiply-adds and summation order differ), f32 rtol/atol 1e-5, the dot
1e-10 (f64) / 1e-4 (f32) relative to |x|·|y|.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from acg_tpu.ops import dia as jdia
from acg_tpu.ops import pallas_kernels as pk
from acg_tpu.sparse import poisson as jpoisson

from acg_torch import convert
from acg_torch.errors import AcgError
from acg_torch.ops import dia as tdia
from acg_torch.ops.dia_kernels import dia_spmv
from acg_torch.sparse import poisson as tpoisson

ROWS_TILE = 8

_TOL = {np.float64: (1e-12, 0.0, 1e-10), np.float32: (1e-5, 1e-5, 1e-4)}


def _random_bands(n=2048, seed=7):
    """A random band stack with offsets that exercise both the sublane and
    the lane shifts of the TPU kernels (as in tests/test_pallas.py)."""
    offsets = (-300, -128, -1, 0, 1, 128, 300)
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):   # zero where the column leaves [0, n)
        if off > 0:
            bands[d, n - off:] = 0.0
        elif off < 0:
            bands[d, :-off] = 0.0
    return jdia.DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))


_OPERATORS = {
    "poisson2d": lambda: jdia.DiaMatrix.from_csr(jpoisson.poisson2d_5pt(32)),
    "poisson3d": lambda: jdia.DiaMatrix.from_csr(jpoisson.poisson3d_7pt(16)),
    "varcoef": lambda: jdia.DiaMatrix.from_csr(
        jpoisson.poisson3d_7pt_varcoef(16)),
    "random": _random_bands,
}

# (operator, mat_dtype) pairs that exist: int8 needs two-valued bands
_CASES = [(op, mat) for op in _OPERATORS for mat in ("auto", "int8", None)
          if not (mat == "int8" and op in ("varcoef", "random"))]


def _pair(op_name, mat_dtype, vdt):
    """(JAX DeviceDia, the port's DeviceDia carried across, x)."""
    D = _OPERATORS[op_name]()
    jdev = jdia.DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat_dtype)
    tdev = convert.device_dia_from_arrays(
        np.asarray(jdev.bands),
        None if jdev.scales is None else np.asarray(jdev.scales),
        jdev.offsets, jdev.nrows, jdev.ncols, jdev.nnz, vdt, device="cpu")
    rng = np.random.default_rng(11)
    x = np.zeros(jdev.nrows_padded, dtype=vdt)
    x[: jdev.nrows] = rng.standard_normal(jdev.nrows)
    return jdev, tdev, x


def _assert_dot(got, want, x, y, rtol):
    scale = np.linalg.norm(x) * np.linalg.norm(y)
    assert abs(float(got) - float(want)) <= rtol * scale


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("op_name,mat_dtype", _CASES)
def test_dia_spmv_matches_pallas_2d(op_name, mat_dtype, vdt):
    """with_dot=False against dia_matvec_pallas_2d (the eager matvec)."""
    rtol, atol, _ = _TOL[vdt]
    jdev, tdev, x = _pair(op_name, mat_dtype, vdt)
    want = pk.dia_matvec_pallas_2d(jdev.bands, jdev.offsets, jnp.asarray(x),
                                   rows_tile=ROWS_TILE, interpret=True,
                                   scales=jdev.scales)
    got = dia_spmv(tdev.bands, tdev.scales, tdev.offsets_t,
                   torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("op_name,mat_dtype", _CASES)
def test_dia_spmv_dot_matches_pallas_2d_padded(op_name, mat_dtype, vdt):
    """with_dot=True against dia_matvec_pallas_2d_padded(with_dot=True) on
    operands padded with JAX's pad_dia_operands and sliced back out."""
    rtol, atol, dot_rtol = _TOL[vdt]
    jdev, tdev, x = _pair(op_name, mat_dtype, vdt)
    n = x.shape[0]
    bp, (xp,) = pk.pad_dia_operands(jdev.bands, (jnp.asarray(x),),
                                    ROWS_TILE, jdev.offsets)
    front = pk.padded_halo_rows(jdev.offsets, ROWS_TILE) * pk.LANES
    yj, dj = pk.dia_matvec_pallas_2d_padded(bp, jdev.offsets, xp,
                                            rows_tile=ROWS_TILE,
                                            with_dot=True, interpret=True,
                                            scales=jdev.scales)
    yj = np.asarray(yj)[front: front + n]
    y, d = dia_spmv(tdev.bands, tdev.scales, tdev.offsets_t,
                    torch.from_numpy(x), with_dot=True)
    assert d.dim() == 0
    np.testing.assert_allclose(y.numpy(), yj, rtol=rtol, atol=atol)
    _assert_dot(d, dj, x, yj, dot_rtol)


@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("op_name,mat_dtype", _CASES)
def test_from_dia_picks_the_same_tier(op_name, mat_dtype, vdt):
    """The port's own DeviceDia.from_dia stores the bands exactly as the
    JAX package does: same tier (bf16, int8 mask + scales, or full), same
    values."""
    D = _OPERATORS[op_name]()
    jdev = jdia.DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat_dtype)
    tD = tdia.DiaMatrix(D.nrows, D.ncols, D.offsets, D.bands, D.nnz)
    tdev = tdia.DeviceDia.from_dia(tD, dtype=vdt, mat_dtype=mat_dtype,
                                   device="cpu")
    assert str(tdev.bands.dtype).removeprefix("torch.") == \
        np.dtype(jdev.bands.dtype).name
    assert (tdev.scales is None) == (jdev.scales is None)
    np.testing.assert_array_equal(
        tdev.bands.to(torch.float64).numpy(),
        np.asarray(jdev.bands, dtype=np.float64))
    if jdev.scales is not None:
        np.testing.assert_array_equal(tdev.scales.numpy(),
                                      np.asarray(jdev.scales))
    assert tdev.operator_stream_bytes() == jdev.operator_stream_bytes()


def test_from_dia_int8_rejects_non_two_valued():
    D = tdia.DiaMatrix.from_csr(tpoisson.poisson3d_7pt_varcoef(6))
    with pytest.raises(AcgError):
        tdia.DeviceDia.from_dia(D, mat_dtype="int8", device="cpu")


@pytest.mark.parametrize("vals", [
    np.array([-1.0, 6.0, 0.0, 0.5, 2.0 ** -20]),      # bf16-exact
    np.array([1.0 / 3.0, 6.0]),                       # not bf16-exact
    np.array([1.0 + 2.0 ** -8]),                      # needs 9 bits
])
def test_lossless_cast_matches_jax(vals):
    assert tdia.lossless_cast(vals, "bfloat16") == \
        jdia.lossless_cast(vals, jnp.bfloat16)


@pytest.mark.parametrize("op_name", list(_OPERATORS))
def test_two_value_scales_matches_jax(op_name):
    D = _OPERATORS[op_name]()
    want = jdia.two_value_scales(D.bands)
    got = tdia.two_value_scales(D.bands)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_poisson3d_7pt_dia_matches_csr_route():
    """The direct band generator equals the CSR route, in both packages."""
    direct = tpoisson.poisson3d_7pt_dia(10)
    via_csr = tdia.DiaMatrix.from_csr(tpoisson.poisson3d_7pt(10))
    jdirect = jpoisson.poisson3d_7pt_dia(10)
    assert direct.offsets == via_csr.offsets == jdirect.offsets
    np.testing.assert_array_equal(direct.bands, via_csr.bands)
    np.testing.assert_array_equal(direct.bands, jdirect.bands)
    assert direct.nnz == via_csr.nnz == jdirect.nnz


def test_dia_efficiency_matches_jax():
    A = tpoisson.poisson2d_5pt(20)
    Aj = jpoisson.poisson2d_5pt(20)
    assert tdia.dia_efficiency(A) == jdia.dia_efficiency(Aj)


def test_plain_dia_matvec_matches_host_oracle():
    """DeviceDia.matvec on CPU (the plain version) against the host
    DiaMatrix.matvec oracle."""
    D = tdia.DiaMatrix.from_csr(tpoisson.poisson3d_7pt_varcoef(8))
    dev = tdia.DeviceDia.from_dia(D, mat_dtype=None, device="cpu")
    x = np.random.default_rng(3).standard_normal(D.nrows)
    xp = torch.zeros(D.nrows_padded, dtype=torch.float64)
    xp[: D.nrows] = torch.from_numpy(x)
    np.testing.assert_allclose(dev.matvec(xp)[: D.nrows].numpy(),
                               D.matvec(x), rtol=1e-12, atol=1e-12)


def test_plain_dia_matvec_offsets_past_the_vector():
    """A band whose offset reaches past the whole vector contributes
    nothing (the kernel's bounds test; the plain shift's zero fill)."""
    n = 16
    offsets = (-20, -1, 0, 1, 17)
    bands = np.random.default_rng(1).standard_normal((len(offsets), n))
    bands[0] = bands[4] = 0.0
    bands[1, :1] = bands[3, -1:] = 0.0
    D = tdia.DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))
    x = np.random.default_rng(2).standard_normal(n)
    y = tdia.dia_matvec(torch.from_numpy(bands), offsets, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), D.matvec(x), rtol=1e-14,
                               atol=1e-14)


def test_dia_spmv_rejects_unknown_device_type():
    """A tensor that is neither on the CPU nor on a CUDA device has no
    kernel and no plain fallback: the wrapper raises."""
    D = tdia.DiaMatrix.from_csr(tpoisson.poisson2d_5pt(4))
    dev = tdia.DeviceDia.from_dia(D, device="cpu")
    x = torch.zeros(D.nrows_padded, dtype=torch.float64, device="meta")
    with pytest.raises(AcgError):
        dia_spmv(dev.bands, dev.scales, dev.offsets_t, x)
