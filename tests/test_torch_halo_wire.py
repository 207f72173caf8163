"""Port parity for the compressed halo wire (``halo_wire``: "bf16",
"int16-delta"): the codec, the ghosts each transport delivers under it,
and whole distributed solves, on the CPU against the JAX package.

- ``wire_encode`` / ``wire_decode`` against ``acg_tpu.parallel.halo``'s,
  compiled as its halo compiles them (``jax.jit``: XLA fuses the
  decode's multiply and add), on random, constant, tied and batched
  messages at f32 and f64: bit-equal (the same f32 arithmetic, round half
  to even, one rounding a step);
- ghosts of ``halo_ppermute`` / ``halo_allgather`` under each wire, one
  system and (B, n) batches, against the JAX transports under
  ``shard_map``: bit-equal under "f32" and "bf16" (the same messages,
  pads included, through the same codec); under "int16-delta" within one
  f32 rounding of each system's largest ghost, because XLA:CPU fuses the
  decode's multiply and add in its vector loop and not in its tail, so
  the JAX package's own bits depend on a value's position (the encoded
  messages are bit-equal: ``test_codec_bit_equal_jax``);
- certified exits under a compressed wire, classic and pipelined, the
  JAX package's recipe (``tests/test_halo_wire.py``): bf16 at rtol 1e-3
  certified below 1e-2, int16-delta at rtol 1e-4 below 1e-3, with
  ``replace_every=10`` (f32 vectors; near the wire's noise floor the
  counts of the two packages part, so they are not compared there); a
  (B, n) solve under int16-delta at f64 in the JAX solve's per-system
  counts;
- the rdma halo refuses a compressed wire (``ERR_NOT_SUPPORTED``, CLI
  exit 1), and the CLI's ``--halo-wire`` runs the JAX solve's count.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from acg_tpu.config import HaloMethod as JHaloMethod
from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.parallel import halo as jhalo
from acg_tpu.parallel.mesh import PARTS_AXIS
from acg_tpu.parallel.sharded import ShardedSystem as JShardedSystem
from acg_tpu.partition import graph as jgraph
from acg_tpu.partition import partitioner as jpart
from acg_tpu.solvers.cg_dist import cg_dist as jcg_dist
from acg_tpu.solvers.cg_dist import cg_pipelined_dist as jcg_pipelined_dist
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, write_mtx
from acg_torch.parallel import halo
from acg_torch.partition import graph
from acg_torch.solvers.cg_dist import cg_dist, cg_pipelined_dist
from acg_torch.sparse import poisson as tpoisson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRES = ("f32", "bf16", "int16-delta")


def _messages(dtype):
    """Random, constant, all-zero, tied (values a bf16 / int16 step
    apart) and batched messages."""
    rng = np.random.default_rng(0)
    tie = np.float32(1.0) + np.float32(2.0 ** -8) * np.arange(9)
    return [rng.standard_normal(257).astype(dtype) * 7.0 - 2.0,
            np.full(33, 3.25, dtype=dtype),
            np.zeros(5, dtype=dtype),
            tie.astype(dtype),
            (rng.standard_normal((3, 100)) * np.array([[1e-3], [1.0],
                                                        [1e4]])
             ).astype(dtype),
            np.stack([np.full(17, -1.5), rng.standard_normal(17)]
                     ).astype(dtype)]


@pytest.mark.parametrize("wire", ["bf16", "int16-delta"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_codec_bit_equal_jax(wire, dtype):
    enc = jax.jit(lambda v: jhalo.wire_encode(v, wire))
    dec = jax.jit(lambda v: jhalo.wire_decode(v, wire, jnp.dtype(dtype)))
    for m in _messages(dtype):
        want = np.asarray(enc(jnp.asarray(m)))
        got = halo.wire_encode(torch.from_numpy(m), wire)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy().view(want.dtype), want)
        wdec = np.asarray(dec(jnp.asarray(want)))
        gdec = halo.wire_decode(got, wire, torch.from_numpy(m).dtype)
        assert gdec.numpy().dtype == np.dtype(dtype)
        np.testing.assert_array_equal(gdec.numpy(), wdec)
    assert (halo.wire_itemsize(wire, dtype)
            == jhalo.wire_itemsize(wire, dtype) == 2)


def test_codec_edges():
    x = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    assert halo.wire_encode(x, "f32") is x
    assert halo.wire_decode(x, "f32", torch.float64) is x
    assert halo.wire_itemsize("f32", np.float64) == 8
    assert halo.wire_itemsize("f32", np.float32) == 4
    # a constant message decodes to itself: the scale floor keeps q = 0
    c = torch.full((6,), 3.25)
    enc = halo.wire_encode(c, "int16-delta")
    assert enc.shape == (10,) and bool(torch.all(enc[4:] == 0))
    assert torch.equal(halo.wire_decode(enc, "int16-delta", torch.float32),
                       c)
    # the deltas span the int16 range: the extremes sit at +-32767
    r = torch.linspace(-5.0, 11.0, 101)
    q = halo.wire_encode(r, "int16-delta")[4:]
    assert int(q.min()) == -32767 and int(q.max()) == 32767
    for bad in ("fp8", ""):
        with pytest.raises(AcgError) as e:
            halo.wire_encode(r, bad)
        assert e.value.status == Status.ERR_INVALID_VALUE


def _systems(nparts, shape=(6, 6, 6)):
    JA, TA = jpoisson.poisson3d_27pt(shape[0]), tpoisson.poisson3d_27pt(
        shape[0])
    part = jpart.partition_graph(JA, nparts)
    return (JA, TA, jgraph.partition_system(JA, part, local_order="band"),
            graph.partition_system(TA, part, local_order="band"))


def _jax_ghosts(jps, x, method, dtype, wire):
    """The JAX package's ghosts under ``wire``: its transport under
    shard_map on the CPU mesh (``tests/test_torch_halo.py``'s driver);
    ``x`` (n,) or (B, n)."""
    ss = JShardedSystem.build(jps, method=method, dtype=dtype, fmt="ell")
    halo_fn = ss.shard_halo_fn(wire=wire)

    def shard(x_own, sidx, ridx, ptnr, pidx, gsp, gpp):
        return halo_fn(x_own[0], sidx[0], ridx[0], ptnr[0], pidx[0],
                       gsp[0], gpp[0])[None]

    ghosts = jax.jit(jax.shard_map(
        shard, mesh=ss.mesh, in_specs=(JP(PARTS_AXIS),) * 7,
        out_specs=JP(PARTS_AXIS), check_vma=False))(
            ss.to_sharded(x), ss.send_idx, ss.recv_idx, ss.partner,
            ss.pack_idx, ss.ghost_src_part, ss.ghost_src_pos)
    return np.asarray(ghosts)


def _port_xs(tps, x):
    """Owned vectors padded to 8 rows, as the shards hold them."""
    out = []
    for p in tps.parts:
        v = np.zeros(x.shape[:-1] + (max(-(-p.nown // 8) * 8, 8),),
                     dtype=x.dtype)
        v[..., : p.nown] = x[..., p.owned_global]
        out.append(torch.from_numpy(v))
    return out


def _tables(tps):
    G = max(-(-max(p.nghost for p in tps.parts) // 8) * 8, 8)
    return halo.shard_tables(halo.build_halo_tables(tps, nghost_max=G), tps,
                             [torch.device("cpu")] * tps.nparts)


@pytest.mark.parametrize("batch", [0, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("nparts", [2, 4])
def test_ghosts_under_each_wire_bit_equal_jax(nparts, wire, dtype, batch):
    _, TA, jps, tps = _systems(nparts)
    rng = np.random.default_rng(nparts + batch)
    shape = (batch, TA.nrows) if batch else (TA.nrows,)
    x = (rng.standard_normal(shape) * 3.0 + 1.0).astype(dtype)
    st = _tables(tps)
    xs = _port_xs(tps, x)
    for jm, fn in ((JHaloMethod.PPERMUTE, halo.halo_ppermute),
                   (JHaloMethod.ALLGATHER, halo.halo_allgather)):
        want = _jax_ghosts(jps, x, jm, dtype, wire)
        got = fn(xs, st, wire=wire)
        for i, p in enumerate(tps.parts):
            g, w = got[i].numpy(), want[i, ..., : p.nghost]
            assert g.shape == x.shape[:-1] + (p.nghost,)
            if wire != "int16-delta":
                np.testing.assert_array_equal(g, w)
                continue
            one = 2.0 ** -23 * np.abs(w).max(axis=-1, keepdims=True)
            assert np.all(np.abs(g - w) <= one)


def _rel(A, b, x):
    return (np.linalg.norm(b - A.matvec(np.asarray(x, dtype=np.float64)))
            / np.linalg.norm(b))


@pytest.mark.parametrize("method", ["ppermute", "allgather"])
@pytest.mark.parametrize("wire,rtol,floor", [
    ("bf16", 1e-3, 1e-2),
    ("int16-delta", 1e-4, 1e-3),
])
@pytest.mark.parametrize("pipelined", [False, True])
def test_certified_exit_compressed(wire, rtol, floor, pipelined, method):
    """The JAX package's recipe: classic and pipelined CG under a
    compressed wire reach a certified exit above the wire's noise floor
    (periodic replacement keeps the pipelined recurrence on the true
    residual), as the JAX solve does."""
    JA, TA = jpoisson.poisson2d_5pt(16), tpoisson.poisson2d_5pt(16)
    b = np.random.default_rng(0).standard_normal(TA.nrows)
    part = jpart.partition_graph(JA, 4)
    o = dict(maxits=400, residual_rtol=rtol, halo_wire=wire,
             replace_every=10)
    jfn, tfn = ((jcg_pipelined_dist, cg_pipelined_dist) if pipelined
                else (jcg_dist, cg_dist))
    r = tfn(TA, b, options=SolverOptions(**o), part=part, method=method,
            devices=["cpu"] * 4, dtype=np.float32)
    assert r.status == Status.SUCCESS and r.converged
    assert _rel(TA, b, r.x) < floor
    assert r.kernel == f"torch-plain+{method}"
    j = jfn(JA, b, options=JOptions(**o), part=part, method=method,
            dtype=np.float32)
    assert j.converged and _rel(JA, b, j.x) < floor


@pytest.mark.parametrize("pipelined", [False, True])
def test_compressed_wire_batched_matches_jax(pipelined):
    """A (B, n) solve under int16-delta: the ghosts of every system
    through one encoded message a round; per-system counts equal the JAX
    package's (f64 vectors, rtol 1e-4)."""
    JA, TA = jpoisson.poisson2d_5pt(12), tpoisson.poisson2d_5pt(12)
    b = np.random.default_rng(2).standard_normal((3, TA.nrows))
    part = jpart.partition_graph(JA, 4)
    o = dict(maxits=400, residual_rtol=1e-4, halo_wire="int16-delta",
             replace_every=10)
    jfn, tfn = ((jcg_pipelined_dist, cg_pipelined_dist) if pipelined
                else (jcg_dist, cg_dist))
    r = tfn(TA, b, options=SolverOptions(**o), part=part,
            devices=["cpu"] * 4, fmt="dia")
    j = jfn(JA, b, options=JOptions(**o), part=part, fmt="dia")
    np.testing.assert_array_equal(r.iterations_per_system,
                                  j.iterations_per_system)
    for s in range(3):
        assert _rel(TA, b[s], r.x[s]) < 1e-3


def test_rdma_refuses_a_compressed_wire():
    TA = tpoisson.poisson2d_5pt(8)
    b = np.ones(TA.nrows)
    for fn in (cg_dist, cg_pipelined_dist):
        for wire in ("bf16", "int16-delta"):
            with pytest.raises(AcgError, match="halo_wire compression") as e:
                fn(TA, b, options=SolverOptions(halo_wire=wire), nparts=2,
                   devices=["cpu"] * 2, method="rdma")
            assert e.value.status == Status.ERR_NOT_SUPPORTED


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = tpoisson.poisson3d_7pt(10)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("wire_cli") / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _run(*args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "acg_torch.cli", *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


@pytest.mark.parametrize("wire", ["bf16", "int16-delta"])
def test_cli_halo_wire_matches_jax(matrix_file, wire):
    from acg_tpu.io.mtxfile import read_mtx
    from acg_tpu.sparse.csr import csr_from_mtx
    from acg_tpu.sparse.csr import manufactured_rhs as jrhs

    JA = csr_from_mtx(read_mtx(matrix_file))
    _, b = jrhs(JA, seed=0)
    want = jcg_dist(JA, b, nparts=4, options=JOptions(
        maxits=500, residual_rtol=1e-4, halo_wire=wire))
    out = _run(matrix_file, "--device", "cpu", "--nparts", "4",
               "--halo-wire", wire, "--residual-rtol", "1e-4",
               "--manufactured-solution", "--max-iterations", "500", "-q")
    assert out.returncode == 0, out.stdout + out.stderr
    its = [ln for ln in out.stdout.splitlines()
           if ln.strip().startswith("iterations:")]
    assert abs(int(its[0].split(":")[1]) - want.niterations) <= 1
    out = _run(matrix_file, "--device", "cpu", "--nparts", "4",
               "--halo", "rdma", "--halo-wire", wire, "-q")
    assert out.returncode == 1 and "rdma" in out.stderr
