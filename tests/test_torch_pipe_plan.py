"""Port parity: which kernel the pipelined DIA iteration takes.

``cg_pipelined_iter`` (``csrc/dia_pipe.cu``) has two kernels, the
generic one and one with the band count fixed at 3, 5, 7 or 27 and
streaming loads and stores; ``dia_plan.pipe_fixed`` chooses, once per
operator, and ``DeviceDia.pipelined_iter`` passes the choice on.  Both
kernels compute the same function with the same bits (held on the card
by ``tests/test_torch_cuda.py``); on the CPU the wrapper runs the plain
version whatever the choice.  So these check:

- the bytes a call must move (the bands once, 12 vector streams);
- the rule at the H100's budgets, written out on the cells the card's
  runs measured (``dia_plan.pipe_fixed``'s docstring): at f32 vectors
  past the L2 the fixed kernel for each band count and band tier where
  it measured no slower (D = 3 and 7 in every tier, D = 5 at bf16 and
  int8 bands, D = 27 at int8), the generic one elsewhere, at f64
  vectors (which measured faster there) and inside the L2; band counts
  out of ``FIXED_BANDS``;
- the rule through ``Budgets`` (the L2 is read from them) and ``None``
  budgets (the CPU);
- ``DeviceDia`` stores the choice and ``pipelined_iter`` passes it;
- a planned operator's iteration on the CPU, which is the plain
  version, against ``acg_tpu``'s ``cg_pipelined_iter_pallas`` in
  interpret mode (f64 rtol 1e-12, f32 1e-5; gamma and delta 1e-10 /
  1e-4 relative to |r'|^2 and |w'|·|r'|, the tolerances of
  ``tests/test_torch_pipelined.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu.ops import pallas_kernels as pk

from acg_torch.ops import dia as tdia
from acg_torch.ops import dia_plan as dp
from acg_torch.ops.dia import DeviceDia, DiaMatrix
from acg_torch.sparse import poisson as tpoisson

F32, F64, BF16, I8 = torch.float32, torch.float64, torch.bfloat16, torch.int8
H100 = dp.Budgets(l2_bytes=50 * 2**20, smem_block=232_448,
                  smem_sm=233_472, sms=132)
ROWS_TILE = 8
ALPHA, BETA = 0.37, 1.21
_TOL = {np.float64: (1e-12, 0.0, 1e-10), np.float32: (1e-5, 1e-5, 1e-4)}


@pytest.mark.parametrize("vdt,bdt,per_row", [
    (F32, BF16, 7 * 2 + 12 * 4), (F32, I8, 7 * 1 + 12 * 4),
    (F32, F32, 7 * 4 + 12 * 4), (F64, F64, 7 * 8 + 12 * 8),
    (F64, BF16, 7 * 2 + 12 * 8)])
def test_pipe_bytes_counts_the_bands_and_twelve_vector_streams(vdt, bdt,
                                                               per_row):
    assert dp.pipe_bytes(1000, 7, vdt, bdt) == 1000 * per_row


# (cell, n, band count, vector dtype, band dtype, the plan's kernel at the
# H100's budgets): the cells of the card's runs (dia_plan.pipe_fixed's
# docstring), and band counts the fixed kernel is not compiled for
_CELLS = [
    ("256^3 bf16/f32", 256 ** 3, 7, F32, BF16, True),
    ("256^3 int8/f32", 256 ** 3, 7, F32, I8, True),
    ("256^3 f32/f32", 256 ** 3, 7, F32, F32, True),
    ("256^3 f64/f64", 256 ** 3, 7, F64, F64, False),
    ("256^3/4 shard bf16/f32", 256 ** 3 // 4, 7, F32, BF16, True),
    ("varcoef 128^3 f64/f64", 128 ** 3, 7, F64, F64, False),
    ("tridiagonal 10^6 bf16/f64", 10 ** 6, 3, F64, BF16, False),
    ("tridiagonal 10^7 bf16/f32", 10 ** 7, 3, F32, BF16, True),
    ("tridiagonal 10^7 int8/f32", 10 ** 7, 3, F32, I8, True),
    ("tridiagonal 10^7 f32/f32", 10 ** 7, 3, F32, F32, True),
    ("tridiagonal 10^5 bf16/f32, inside the L2", 10 ** 5, 3, F32, BF16,
     False),
    ("64^3 bf16/f32, inside the L2", 64 ** 3, 7, F32, BF16, False),
    ("64^3 f64/f64, inside the L2", 64 ** 3, 7, F64, F64, False),
    ("2-D 2048^2 bf16/f32", 2048 ** 2, 5, F32, BF16, True),
    ("2-D 2048^2 int8/f32", 2048 ** 2, 5, F32, I8, True),
    ("2-D 2048^2 f32/f32", 2048 ** 2, 5, F32, F32, False),
    ("2-D 256^2 bf16/f32, inside the L2", 256 ** 2, 5, F32, BF16, False),
    ("27 bands 128^3 bf16/f32", 128 ** 3, 27, F32, BF16, False),
    ("27 bands 128^3 int8/f32", 128 ** 3, 27, F32, I8, True),
    ("27 bands 128^3 f32/f32", 128 ** 3, 27, F32, F32, False),
    ("27 bands 32^3 bf16/f32, inside the L2", 32 ** 3, 27, F32, BF16,
     False),
    ("4 bands 256^3 bf16/f32", 256 ** 3, 4, F32, BF16, False),
    ("9 bands 256^3 f64/f64", 256 ** 3, 9, F64, F64, False),
    ("4 bands 64^3 f32/f32", 64 ** 3, 4, F32, F32, False),
]


@pytest.mark.parametrize("cell,n,nd,vdt,bdt,want", _CELLS,
                         ids=[c[0] for c in _CELLS])
def test_pipe_fixed_at_the_h100s_budgets(cell, n, nd, vdt, bdt, want):
    assert dp.pipe_fixed(n, nd, vdt, bdt, H100) is want


def test_pipe_fixed_pairs_are_compiled_band_counts():
    """Every (band count, band type) the rule may take has a fixed
    kernel: a compiled band count and a band tier of the wrapper."""
    assert all(nd in dp.FIXED_BANDS and bdt in (BF16, I8, F32, F64)
               for nd, bdt in dp.PIPE_FIXED)


@pytest.mark.parametrize("nd", [3, 4, 5, 7, 9, 27])
@pytest.mark.parametrize("bdt", [BF16, I8, F32])
@pytest.mark.parametrize("vdt", [F32, F64])
def test_pipe_fixed_follows_the_l2_of_the_budgets(nd, bdt, vdt):
    """The same call on budgets whose L2 lies just above and just below
    its bytes: the fixed kernel only past the L2, only at f32 vectors and
    only for a band count and band type of ``PIPE_FIXED``; no budgets
    (the CPU): never."""
    n = 100_000
    nbytes = dp.pipe_bytes(n, nd, vdt, bdt)
    above = dataclasses.replace(H100, l2_bytes=nbytes)
    below = dataclasses.replace(H100, l2_bytes=nbytes - 1)
    assert dp.pipe_fixed(n, nd, vdt, bdt, above) is False
    assert dp.pipe_fixed(n, nd, vdt, bdt, below) is (
        vdt == F32 and (nd, bdt) in dp.PIPE_FIXED)
    assert dp.pipe_fixed(n, nd, vdt, bdt, None) is False


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_dia_stores_the_choice_and_passes_it(monkeypatch, dtype):
    """``DeviceDia`` stores the rule's choice (planned as on a card with
    the given budgets; no budgets on the CPU) and ``pipelined_iter``
    hands it to the wrapper."""
    D = DiaMatrix.from_csr(tpoisson.poisson3d_7pt(12))
    small = dataclasses.replace(H100, l2_bytes=1024)
    planned = DeviceDia.from_dia(D, dtype=dtype, device="cpu",
                                 budgets=small)
    vdt = getattr(torch, dtype)
    assert planned.pipe_fixed is dp.pipe_fixed(
        D.nrows_padded, 7, vdt, planned.bands.dtype, small) is (
            dtype == "float32")
    planned = dataclasses.replace(planned, pipe_fixed=True)
    assert DeviceDia.from_dia(D, dtype=dtype, device="cpu").pipe_fixed \
        is False
    assert DeviceDia.from_dia(D, dtype=dtype, device="cpu",
                              budgets=H100).pipe_fixed is False
    seen = []
    real = tdia.cg_pipelined_iter

    def spy(*a, **k):
        seen.append(k.get("fixed"))
        return real(*a, **k)

    monkeypatch.setattr(tdia, "cg_pipelined_iter", spy)
    vecs = [torch.ones(D.nrows_padded, dtype=vdt) for _ in range(6)]
    ab = (torch.tensor(ALPHA, dtype=vdt), torch.tensor(BETA, dtype=vdt))
    planned.pipelined_iter(*vecs, *ab)
    dataclasses.replace(planned, pipe_fixed=False).pipelined_iter(*vecs, *ab)
    assert seen == [True, False]


def _vectors(n, npad, dtype, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        v = np.zeros(npad, dtype=dtype)
        v[:n] = rng.standard_normal(n).astype(dtype)
        out.append(v)
    return out


@pytest.mark.parametrize("tier", ["bf16/f32", "int8/f32", "f64/f64"])
@pytest.mark.parametrize("shape", [(10, 10, 10), (7, 9, 13)])
def test_planned_operator_plain_iteration_matches_pallas(tier, shape):
    """A 7-point operator planned as on a card (the fixed kernel at f32,
    the generic one at f64): on the CPU ``pipelined_iter`` runs the plain
    version whatever the plan, here on the stored bands and int8 scales,
    against the Pallas kernel in interpret mode on the same inputs.  The
    kernels themselves are held against the plain version, and against
    each other bit for bit, only on the card."""
    # rows padded to whole 128-lane rows, as the Pallas kernel takes them
    D = DiaMatrix.from_csr(tpoisson.poisson3d_7pt(*shape), row_align=128)
    vdt = np.float64 if tier == "f64/f64" else np.float32
    mat = {"bf16/f32": "auto", "int8/f32": "int8", "f64/f64": None}[tier]
    small = dataclasses.replace(H100, l2_bytes=1024)
    dev = DeviceDia.from_dia(D, dtype=np.dtype(vdt).name, mat_dtype=mat,
                             device="cpu", budgets=small)
    assert dev.pipe_fixed is (vdt == np.float32)
    n, npad = D.nrows, D.nrows_padded
    vecs = _vectors(n, npad, vdt)
    # the port's stored bands, exactly, for the JAX kernel
    jb = jnp.asarray(dev.bands.to(F32 if dev.bands.dtype == BF16
                                  else dev.bands.dtype).numpy())
    if dev.bands.dtype == BF16:
        jb = jb.astype(jnp.bfloat16)
    jsc = None if dev.scales is None else jnp.asarray(dev.scales.numpy())
    offsets = dev.offsets
    bp, padded = pk.pad_dia_operands(jb, tuple(jnp.asarray(v) for v in vecs),
                                     ROWS_TILE, offsets)
    front = pk.padded_halo_rows(offsets, ROWS_TILE) * pk.LANES
    want = pk.cg_pipelined_iter_pallas(
        bp, offsets, *padded, jnp.asarray(ALPHA, vdt),
        jnp.asarray(BETA, vdt), rows_tile=ROWS_TILE, interpret=True,
        scales=jsc)
    want = [np.asarray(v)[front: front + npad] for v in want[:6]] + [
        np.asarray(want[6]), np.asarray(want[7])]
    tv = [torch.from_numpy(v) for v in vecs]
    got = dev.pipelined_iter(*tv, torch.tensor(ALPHA, dtype=tv[0].dtype),
                             torch.tensor(BETA, dtype=tv[0].dtype))
    rtol, atol, dot_rtol = _TOL[vdt]
    for g, w in zip(got[:6], want[:6]):
        g = g.numpy()
        assert np.abs(g - w).max() <= atol + rtol * np.abs(w).max()
        assert np.all(g[n:] == 0)
    r2, w2 = want[4].astype(np.float64), want[5].astype(np.float64)
    assert abs(float(got[6]) - float(want[6])) <= dot_rtol * float(r2 @ r2)
    assert abs(float(got[7]) - float(want[7])) <= dot_rtol * float(
        np.linalg.norm(w2) * np.linalg.norm(r2))
