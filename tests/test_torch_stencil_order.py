"""Port parity: the fixed-arm stencil kernel's plan and geometry.

``stencil_spmv`` (``csrc/stencil_spmv.cu``) has a second kernel with the
arm count fixed at 5, 7 or 27 (``ops/stencil.py`` ``FIXED_ARMS``).  It
walks each thread's grid-stride elements by adding the stride's grid
coordinates with carries instead of dividing, and sums the elements of
an interior box that the host computes without per-arm tests; the rest
take the generic row body.  Neither changes what a row computes, and on
the CPU the wrapper runs the plain version, so these check the host's
side and the plain version; the kernels themselves are held to the same
bits on the card (``tests/test_torch_cuda.py``):

- the interior box (``interior_box``) against a brute-force test of
  every arm of every element: 2-D and 3-D grids, a rectangular
  13 x 14 x 15, unit axes, the 27-point pattern, one-sided arm sets,
  axes of length 1 and 2 (where the box is empty);
- the launch stride's coordinates (``stride_coords``) and a model of
  the kernel's carry walk over them (``_walk``, the loop of
  ``stencil_spmv_fixed_kernel`` in Python) against ``divmod`` for every
  thread of many launches: strides that wrap several axes, strides
  longer than the grid, padding rows past it; the walk in the kernel
  itself is checked only on the card, through its bits;
- the route: 5, 7 and 27 arms take the fixed kernel, other counts the
  generic one, at f32 and f64;
- the ``_CStencil`` mirror against the layout that ``acg::StencilArgs``
  in ``csrc/common.cuh`` implies, its new fields last;
- the plain version (what a CPU tensor runs, whichever kernel a CUDA
  one would) against the JAX package's ``stencil_matvec_pallas_padded``
  in interpret mode on the fixed kernel's shapes (f64 rtol 1e-12, f32 rtol/atol 1e-5, the dot
  1e-10 / 1e-4 relative to |x|·|y|: the tolerances of
  ``tests/test_torch_stencil.py``).
"""

import ctypes
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from acg_tpu.ops import pallas_kernels as pk
from acg_tpu.ops import stencil as jst
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.ops import stencil as tst
from acg_torch.ops.dia_kernels import THREADS, grid_blocks
from acg_torch.sparse import poisson as tpoisson
from acg_torch.sparse.csr import coo_to_csr

ROWS_TILE = 8
_TOL = {np.float64: (1e-12, 0.0, 1e-10), np.float32: (1e-5, 1e-5, 1e-4)}

_FIVE = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
_SEVEN = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
          (0, 1, 0), (1, 0, 0))
_BOX = tuple(itertools.product((-1, 0, 1), repeat=3))
_NINE = tuple(itertools.product((-1, 0, 1), repeat=2))
_NINETEEN = tuple(d for d in _BOX if sum(map(abs, d)) <= 2)


def _pad(digits):
    return tuple((0,) * (3 - len(d)) + tuple(d) for d in digits)


def _brute_interior(dims, digits):
    """Every element (as coordinates) whose every arm stays inside."""
    out = set()
    for c in itertools.product(*(range(g) for g in dims)):
        if all(all(0 <= c[a] + d[a] < dims[a] for a in range(3))
               for d in digits):
            out.add(c)
    return out


# ---------------------------------------------------------------------------
# the interior box


@pytest.mark.parametrize("dims,digits", [
    ((1, 32, 32), _pad(_FIVE)),                     # 2-D, a unit axis
    ((1, 17, 9), _pad(_NINE)),
    ((13, 14, 15), _SEVEN),                         # rectangular 3-D
    ((9, 10, 11), _BOX),                            # 27-point
    ((5, 6, 7), _NINETEEN),
    ((6, 7, 8), ((0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0), (1, 1, 1))),
    ((6, 7, 8), ((-1, -1, 0), (-1, 0, 0), (0, -1, 0), (0, 0, -1),
                 (0, 0, 0))),                       # one-sided
    ((1, 1, 12), _pad(((0, -1), (0, 0), (0, 1)))),  # 1-D
    ((1, 9, 8), _SEVEN),                            # axis of length 1
    ((2, 9, 10), _SEVEN),                           # axis of length 2
    ((9, 2, 10), _BOX),
    ((4, 5, 2), _SEVEN),
    ((2, 2, 2), _BOX),
    ((3, 3, 3), _BOX),                              # one interior element
])
def test_interior_box_equals_brute_force(dims, digits):
    lo, hi = tst.interior_box(dims, digits)
    box = {c for c in itertools.product(*(range(g) for g in dims))
           if all(lo[a] <= c[a] <= hi[a] for a in range(3))}
    assert box == _brute_interior(dims, digits)


@pytest.mark.parametrize("dims", [(1, 32, 32), (2, 9, 10), (1, 1, 5)])
def test_interior_box_is_empty_on_short_axes(dims):
    lo, hi = tst.interior_box(dims, _SEVEN)
    assert any(h < l for l, h in zip(lo, hi))
    assert not _brute_interior(dims, _SEVEN)


# ---------------------------------------------------------------------------
# the carry walk


def _walk(first: int, step: int, dims: tuple, count: int) -> list:
    """The coordinates the fixed-arm kernel's thread gives its elements
    first, first + step, ...: ``count`` of them, the first by division,
    every later one by adding ``stride_coords(step)`` with one carry an
    axis, as the kernel's loop does."""
    s0, s1, s2 = tst.stride_coords(step, dims)
    r, c2 = divmod(first, dims[2])
    c0, c1 = divmod(r, dims[1])
    out = []
    for _ in range(count):
        out.append((c0, c1, c2))
        c2 += s2
        if c2 >= dims[2]:
            c2 -= dims[2]
            c1 += 1
        c1 += s1
        if c1 >= dims[1]:
            c1 -= dims[1]
            c0 += 1
        c0 += s0
    return out


@pytest.mark.parametrize("dims,npad", [
    ((13, 14, 15), 2730),                  # 11 blocks: the stride wraps c1
    ((13, 14, 15), 2736),                  # and padding rows past the grid
    ((1, 32, 32), 1032),
    ((2, 9, 10), 184),                     # a grid smaller than one stride
    ((9, 10, 11), 990),
    ((16, 16, 16), 4096),                  # the stride a whole plane
    ((3, 7, 5), 120),
    ((5, 3, 700), 10_500),                 # a row longer than the stride
    ((700, 3, 5), 10_504),                 # a plane shorter than it
    ((256, 128, 128), 256 * 128 * 128),    # the shard: 4096 blocks
    ((1, 1, 1_100_000), 1_100_000),        # 1-D past 4096 blocks
])
def test_carry_walk_equals_divmod(dims, npad):
    nb = grid_blocks(npad)
    step = nb * THREADS
    s0, s1, s2 = tst.stride_coords(step, dims)
    assert (s0 * dims[1] + s1) * dims[2] + s2 == step
    assert 0 <= s1 < dims[1] and 0 <= s2 < dims[2]
    plane = dims[1] * dims[2]
    # every thread when the launch is small, else a spread of them
    threads = (range(step) if step * -(-npad // step) <= 40_000 else
               sorted({0, 1, 255, 256, step // 2, step - 1}
                      | set(range(0, step, 997))))
    for first in threads:
        count = len(range(first, npad, step))
        got = _walk(first, step, dims, count)
        want = [(i // plane, i // dims[2] % dims[1], i % dims[2])
                for i in range(first, npad, step)]
        assert got == want, first


def test_c_spec_holds_the_launch_stride_and_box():
    spec, _ = tst.recognize_stencil(tpoisson.poisson3d_7pt(13, 14, 15))
    for npad in (2730, 2736, 1 << 20):
        nb = grid_blocks(npad)
        a = tst._c_spec(spec, nb)
        assert tuple(a.stride) == tst.stride_coords(nb * THREADS,
                                                    (13, 14, 15))
        assert tuple(a.lo) == (1, 1, 1) and tuple(a.hi) == (11, 12, 13)


# ---------------------------------------------------------------------------
# the route


def _stencil_csr(shape, digits, dtype):
    """A constant-coefficient stencil (centre 2 * arms, others -1) with
    the arms ``digits`` (the centre left out)."""
    arms = [d for d in digits if any(d)]
    r, c, v, n = tpoisson._stencil_coo(shape, arms, 2.0 * len(arms),
                                       [-1.0] * len(arms), dtype)
    return coo_to_csr(r, c, v, n, n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gen,narms,fixed", [
    (lambda dt: tpoisson.poisson2d_5pt(12, 13, dtype=dt), 5, True),
    (lambda dt: tpoisson.poisson3d_7pt(5, 6, 7, dtype=dt), 7, True),
    (lambda dt: tpoisson.poisson3d_27pt(5, 6, 7, dtype=dt), 27, True),
    (lambda dt: _stencil_csr((9, 10), _NINE, dt), 9, False),
    (lambda dt: _stencil_csr((5, 6, 7), _NINETEEN, dt), 19, False),
    (lambda dt: tpoisson.poisson2d_5pt(1, 37, dtype=dt), 3, False),
])
def test_route_by_arm_count(gen, narms, fixed, dtype):
    spec, why = tst.recognize_stencil(gen(dtype), dtype=dtype)
    assert spec is not None, why
    assert len(spec.offsets) == narms
    assert tst.fixed_arms(spec) is fixed
    assert tst.route(spec) == (f"fixed-{narms}" if fixed else "generic")
    assert tst.route(spec, fixed=False) == "generic"


# ---------------------------------------------------------------------------
# the struct


_CTYPES = {"int32_t": 4, "double": 8}


def _stencil_args_layout():
    """[(name, offset, size)] and the size of ``acg::StencilArgs`` as the
    C rules lay out its fields (each at its own alignment, the struct
    rounded to its largest)."""
    src = (Path(tst.__file__).resolve().parent.parent / "csrc"
           / "common.cuh").read_text()
    body = re.search(r"struct StencilArgs \{(.*?)\};", src, re.S).group(1)
    consts = {"kMaxArms": int(re.search(r"kMaxArms = (\d+)", src).group(1))}
    out, at, align = [], 0, 1
    for ty, name, dims in re.findall(r"^\s*(\w+) (\w+)((?:\[\w+\])*);",
                                     body, re.M):
        size = _CTYPES[ty]
        count = 1
        for d in re.findall(r"\[(\w+)\]", dims):
            count *= int(consts.get(d, d))
        at = -(-at // size) * size
        out.append((name, at, size * count))
        at += size * count
        align = max(align, size)
    return out, -(-at // align) * align


def test_c_struct_matches_stencil_args():
    fields, size = _stencil_args_layout()
    assert [f[0] for f in fields] == [f[0] for f in tst._CStencil._fields_]
    for name, off, nbytes in fields:
        member = getattr(tst._CStencil, name)
        assert (member.offset, member.size) == (off, nbytes), name
    assert size == ctypes.sizeof(tst._CStencil) == 824
    assert [f[0] for f in fields][-3:] == ["stride", "lo", "hi"]


# ---------------------------------------------------------------------------
# the plain version on the fixed kernel's shapes, against the JAX package


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["13x14x15", "1x32x32", "27pt-9x10x11",
                                  "2x9x10", "2d-5pt-31x32"])
def test_plain_version_matches_pallas_on_fixed_shapes(name, dtype):
    gens = {"13x14x15": lambda m: m.poisson3d_7pt(13, 14, 15),
            "1x32x32": lambda m: m.poisson3d_7pt(1, 32, 32),
            "27pt-9x10x11": lambda m: m.poisson3d_27pt(9, 10, 11),
            "2x9x10": lambda m: m.poisson3d_7pt(2, 9, 10),
            "2d-5pt-31x32": lambda m: m.poisson2d_5pt(31, 32)}
    rtol, atol, dot_rtol = _TOL[dtype]
    jdev = jst.DeviceStencil.from_matrix(gens[name](jpoisson), dtype=dtype)
    spec, why = tst.recognize_stencil(gens[name](tpoisson), dtype=dtype)
    assert spec is not None, why
    assert tst.fixed_arms(spec)
    n = spec.nrows
    npad = -(-n // pk.LANES) * pk.LANES
    x = np.zeros(npad, dtype=dtype)
    x[:n] = np.random.default_rng(11).standard_normal(n)
    (xp,), front = pk.pad_dia_vectors((jnp.asarray(x),), npad, ROWS_TILE,
                                      jdev.offsets)
    yj, dj = jst.stencil_matvec_pallas_padded(
        jdev.grid, jdev.offsets, jdev.digits, jdev.coeffs, xp,
        rows_tile=ROWS_TILE, n=n, with_dot=True, interpret=True)
    yj = np.asarray(yj)[front: front + npad]
    y, d = tst.stencil_spmv(spec, torch.from_numpy(x), with_dot=True)
    np.testing.assert_allclose(y.numpy(), yj, rtol=rtol, atol=atol)
    assert np.all(y.numpy()[n:] == 0.0)
    scale = np.linalg.norm(x) * np.linalg.norm(yj)
    assert abs(float(d) - float(dj)) <= dot_rtol * scale
