"""The multi-RHS SpMVs' plain versions at the shapes whose geometry the
card kernels must get right: every chunk tail (B in {1, 2, 3, 5, 8, 9,
16}: one launch of 1, 2, 3, 5 or 8 systems, then 8 + 1 and 8 + 8), grids
of fewer than 8 and an odd number of 256-row blocks (n not a multiple of
256), offsets that are not multiples of 4 (rows off 16-byte boundaries)
and bands that reach past the vector, every band tier.

The same inputs, made with numpy from a seed, go through the JAX
package's batched Pallas kernels in interpret mode
(``dia_matvec_pallas_2d_padded_batched``,
``stencil_matvec_pallas_padded_batched``; tolerances as
``tests/test_torch_batched.py``:
rows at f64 rtol 1e-12, f32 rtol/atol 1e-5 of the largest entry; dots at
1e-10 / 1e-4 of |x_s|·|y_s|), and each system's Y row and dot equal the
1-D plain version on that system bit for bit (the property
``tests/test_torch_cuda.py`` holds the card kernels to against the
one-system kernels, at the same shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu.ops import dia as jdia
from acg_tpu.ops import pallas_kernels as pk
from acg_tpu.ops import stencil as jst
from acg_tpu.sparse import poisson as jpoisson

from acg_torch import convert
from acg_torch.ops import dia_kernels
from acg_torch.ops import stencil as tst
from acg_torch.ops.dia_kernels import grid_blocks

ROWS_TILE = 8
NSYS = [1, 2, 3, 5, 8, 9, 16]
_TOL = {np.float64: (1e-12, 0.0, 1e-10), np.float32: (1e-5, 1e-5, 1e-4)}


def _batch(nrows, npad, dtype, nsys, seed=5):
    X = np.zeros((nsys, npad), dtype=dtype)
    X[:, :nrows] = np.random.default_rng(seed).standard_normal((nsys, nrows))
    return X


def _assert_close(Y, D, X, yj, dj, dtype):
    rtol, atol, dot_rtol = _TOL[dtype]
    assert Y.shape == yj.shape and Y.dtype == dtype
    assert np.max(np.abs(Y - yj)) <= atol + rtol * np.max(np.abs(yj))
    scale = (np.linalg.norm(X.astype(np.float64), axis=-1)
             * np.linalg.norm(yj.astype(np.float64), axis=-1))
    assert np.all(np.abs(D.astype(np.float64) - dj) <= dot_rtol * scale)


def _random_bands(n, offsets, seed=3):
    bands = np.random.default_rng(seed).standard_normal((len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            bands[d, max(n - off, 0):] = 0.0
        elif off < 0:
            bands[d, :-off] = 0.0
    return jdia.DiaMatrix(n, n, offsets, bands, int((bands != 0).sum()))


_DIA = {
    # G = 3 blocks of 256 rows (n = 640: the JAX kernel takes whole
    # 128-lane rows); offsets off every 4-element boundary
    "g3": lambda: _random_bands(640, (-33, -1, 0, 1, 33)),
    # G = 9, an odd grid
    "g9": lambda: _random_bands(2176, (-300, -129, -1, 0, 1, 129, 300)),
    # a band that reaches past the vector (1023 of 1024 rows), G = 4
    "past": lambda: _random_bands(1024, (-300, -1, 0, 1, 1023)),
    # two-valued bands: the int8 tier too; G = 6
    "poisson": lambda: jdia.DiaMatrix.from_csr(
        jpoisson.poisson3d_7pt(8, 12, 16)),
}
_DIA_CASES = [(op, mat) for op in _DIA for mat in ("auto", "int8", None)
              if mat != "int8" or op == "poisson"]


@pytest.mark.parametrize("nsys", NSYS)
@pytest.mark.parametrize("vdt", [np.float64, np.float32])
@pytest.mark.parametrize("op_name,mat_dtype", _DIA_CASES)
def test_dia_batched_tails_match_pallas_and_1d(op_name, mat_dtype, vdt,
                                                nsys):
    D = _DIA[op_name]()
    jdev = jdia.DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat_dtype)
    tdev = convert.device_dia_from_arrays(
        np.asarray(jdev.bands),
        None if jdev.scales is None else np.asarray(jdev.scales),
        jdev.offsets, jdev.nrows, jdev.ncols, jdev.nnz, vdt, device="cpu")
    n = jdev.nrows_padded
    assert grid_blocks(n) < 8 or grid_blocks(n) % 2 == 1
    X = _batch(jdev.nrows, n, vdt, nsys)
    bp, (xp,) = pk.pad_dia_operands(jdev.bands, (jnp.asarray(X),),
                                    ROWS_TILE, jdev.offsets)
    front = pk.padded_halo_rows(jdev.offsets, ROWS_TILE) * pk.LANES
    yj, dj = pk.dia_matvec_pallas_2d_padded_batched(
        bp, jdev.offsets, xp, rows_tile=ROWS_TILE, with_dot=True,
        interpret=True, scales=jdev.scales)
    yj = np.asarray(yj)[:, front: front + n]
    Xt = torch.from_numpy(X)
    Y, d = dia_kernels.dia_spmv_batched(tdev.bands, tdev.scales,
                                        tdev.offsets_t, Xt, with_dot=True)
    _assert_close(Y.numpy(), d.numpy(), X, yj,
                  np.asarray(dj, dtype=np.float64), vdt)
    for s in range(nsys):
        y, ds = dia_kernels.dia_spmv(tdev.bands, tdev.scales, tdev.offsets_t,
                                     Xt[s].clone(), with_dot=True)
        assert torch.equal(Y[s], y) and torch.equal(d[s], ds)


_STENCILS = {
    "p3d_g11": lambda m: m.poisson3d_7pt(13, 14, 15),
    "p2d_g1": lambda m: m.poisson2d_5pt(13, 17),
    "p3d27_g1": lambda m: m.poisson3d_27pt(6),
}


@pytest.mark.parametrize("nsys", NSYS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(_STENCILS))
def test_stencil_batched_tails_match_pallas_and_1d(name, dtype, nsys):
    jdev = jst.DeviceStencil.from_matrix(_STENCILS[name](jpoisson),
                                         dtype=dtype)
    tdev = convert.device_stencil_from_fields(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, jdev.nrows,
        jdev.nnz, dtype, device="cpu")
    n = jdev.nrows
    npad = -(-n // pk.LANES) * pk.LANES
    assert grid_blocks(npad) < 8 or grid_blocks(npad) % 2 == 1
    X = _batch(n, npad, dtype, nsys)
    (xp,), front = pk.pad_dia_vectors((jnp.asarray(X),), npad, ROWS_TILE,
                                      jdev.offsets)
    yj, dj = jst.stencil_matvec_pallas_padded_batched(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, xp,
        rows_tile=ROWS_TILE, n=n, with_dot=True, interpret=True)
    yj = np.asarray(yj)[:, front: front + npad]
    Xt = torch.from_numpy(X)
    Y, d = tst.stencil_spmv_batched(tdev.spec, Xt, with_dot=True)
    _assert_close(Y.numpy(), d.numpy(), X, yj,
                  np.asarray(dj, dtype=np.float64), dtype)
    assert np.all(Y.numpy()[:, n:] == 0.0)
    for s in range(nsys):
        y, ds = tst.stencil_spmv(tdev.spec, Xt[s].clone(), with_dot=True)
        assert torch.equal(Y[s], y) and torch.equal(d[s], ds)
