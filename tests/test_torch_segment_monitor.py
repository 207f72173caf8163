"""``segment_iters`` and ``monitor_every`` on the port, against acg_tpu.

``segment_iters`` ends a block of the port's loop every that many
iterations (the JAX package's re-dispatch of its compiled loop): the
solve keeps the unsegmented solve's bits, and its count and x agree with
the JAX package's segmented solve; the s-step and deep solvers refuse it
with the JAX package's status.  ``monitor_every`` streams ``iteration k:
rnrm2`` lines through the sinks of ``acg_torch/obs/monitor.py``: the
same k sequence as the JAX package's (collected after
``jax.effects_barrier()``) and rnrm2 to 1e-6 at f64 (or rr within 1e-12
of the largest line, the pipelined parity tests' history tolerance), for
classic, pipelined, s-step, deep, batched and distributed solves, one
stream for the whole mesh; ``muted()`` keeps the sinks and drops the
printer; the CLI's ``--monitor-every`` and ``-vv``.
"""

import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.obs import monitor as jmon
from acg_tpu.sparse import poisson as jpoisson
from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, write_mtx
from acg_torch.obs import monitor as tmon
from acg_torch.sparse import poisson as tpoisson

# the modules (the packages' __init__ exports functions of these names)
jcgm = importlib.import_module("acg_tpu.solvers.cg")
jdist = importlib.import_module("acg_tpu.solvers.cg_dist")
tcgm = importlib.import_module("acg_torch.solvers.cg")
tdist = importlib.import_module("acg_torch.solvers.cg_dist")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(edge=8, nrhs=0, seed=5):
    Aj, At = jpoisson.poisson3d_7pt(edge), tpoisson.poisson3d_7pt(edge)
    rng = np.random.default_rng(seed)
    bs = [At.matvec(rng.standard_normal(At.nrows))
          for _ in range(max(nrhs, 1))]
    return Aj, At, (np.stack(bs) if nrhs else bs[0])


def _parts(A, P=4):
    from acg_torch.partition.partitioner import partition_graph

    return np.asarray(partition_graph(A, P))


# ---------------------------------------------------------------------------
# segment_iters


_SEG_SOLVERS = {
    "cg": (jcgm.cg, tcgm.cg, {}),
    "cg_pipelined": (jcgm.cg_pipelined, tcgm.cg_pipelined, {}),
    "cg-batched": (jcgm.cg, tcgm.cg, {"nrhs": 3}),
    "cg_dist": (jdist.cg_dist, tdist.cg_dist, {"P": 4}),
    "cg_pipelined_dist": (jdist.cg_pipelined_dist, tdist.cg_pipelined_dist,
                          {"P": 4}),
}


@pytest.mark.parametrize("segment", [1, 7, 50])
@pytest.mark.parametrize("solver", sorted(_SEG_SOLVERS))
def test_segment_iters_bits_and_jax(solver, segment):
    jf, tf, kw = _SEG_SOLVERS[solver]
    Aj, At, b = _pair(nrhs=kw.get("nrhs", 0))
    o = dict(maxits=400, residual_rtol=1e-10, check_every=3)
    jkw, tkw = {}, {"device": "cpu"}
    if "P" in kw:
        part = _parts(At, kw["P"])
        jkw = {"part": part}
        tkw = {"part": part, "devices": ["cpu"] * kw["P"]}
    plain = tf(At, b, options=SolverOptions(**o), **tkw)
    seg = tf(At, b, options=SolverOptions(segment_iters=segment, **o),
             **tkw)
    assert seg.niterations == plain.niterations
    np.testing.assert_array_equal(seg.x, plain.x)
    np.testing.assert_array_equal(seg.residual_history,
                                  plain.residual_history)
    ref = jf(Aj, b, options=JOptions(segment_iters=segment, **o), **jkw)
    assert seg.niterations == ref.niterations
    scale = np.abs(np.asarray(ref.x)).max()
    assert np.abs(seg.x - np.asarray(ref.x)).max() <= 1e-9 * scale


@pytest.mark.parametrize("solver", ["sstep", "deep", "sstep_dist",
                                    "deep_dist"])
def test_segment_iters_refused_where_jax_refuses(solver):
    Aj, At, b = _pair(edge=6)
    extra = (dict(sstep=2) if solver.startswith("sstep")
             else dict(pipeline_depth=2))
    o = dict(segment_iters=5, maxits=50, **extra)
    if solver.endswith("dist"):
        part = _parts(At, 2)
        jf = getattr(jdist, "cg_" + ("sstep" if "sstep" in solver
                                     else "pipelined_deep") + "_dist")
        tf = getattr(tdist, "cg_" + ("sstep" if "sstep" in solver
                                     else "pipelined_deep") + "_dist")
        jkw, tkw = {"part": part}, {"part": part, "devices": ["cpu"] * 2}
    else:
        jf = jcgm.cg_sstep if solver == "sstep" else jcgm.cg_pipelined_deep
        tf = tcgm.cg_sstep if solver == "sstep" else tcgm.cg_pipelined_deep
        jkw, tkw = {}, {"device": "cpu"}
    with pytest.raises(JAcgError) as ej:
        jf(Aj, b, options=JOptions(**o), **jkw)
    with pytest.raises(AcgError) as et:
        tf(At, b, options=SolverOptions(**o), **tkw)
    assert int(et.value.status) == int(ej.value.status) == \
        int(Status.ERR_NOT_SUPPORTED)


# ---------------------------------------------------------------------------
# monitor_every


def _lines(mon, run):
    got = []

    def sink(k, rr):
        got.append((int(k), float(rr)))

    mon.add_monitor_sink(sink)
    try:
        with mon.muted():
            try:
                run()
            except (AcgError, JAcgError):
                pass
            if mon is jmon:
                jax.effects_barrier()
    finally:
        mon.remove_monitor_sink(sink)
    return got


_MON_CASES = {
    # name: (JAX solver, port solver, options, nrhs, parts)
    "classic": ("cg", "cg", dict(check_every=4), 0, 0),
    "classic-batched": ("cg", "cg", dict(check_every=2), 3, 0),
    "pipelined": ("cg_pipelined", "cg_pipelined", dict(check_every=3), 0, 0),
    "pipelined-replace": ("cg_pipelined", "cg_pipelined",
                          dict(replace_every=10), 0, 0),
    "pipelined-batched": ("cg_pipelined", "cg_pipelined", {}, 3, 0),
    "sstep": ("cg_sstep", "cg_sstep", dict(sstep=4), 0, 0),
    "sstep-batched": ("cg_sstep", "cg_sstep", dict(sstep=3), 2, 0),
    "deep": ("cg_pipelined_deep", "cg_pipelined_deep",
             dict(pipeline_depth=2, replace_every=30), 0, 0),
    "deep-batched": ("cg_pipelined_deep", "cg_pipelined_deep",
                     dict(pipeline_depth=2), 2, 0),
    "dist-classic": ("cg_dist", "cg_dist", dict(check_every=2), 0, 4),
    "dist-pipelined": ("cg_pipelined_dist", "cg_pipelined_dist", {}, 0, 4),
    "dist-sstep": ("cg_sstep_dist", "cg_sstep_dist", dict(sstep=2), 0, 2),
    "dist-deep": ("cg_pipelined_deep_dist", "cg_pipelined_deep_dist",
                  dict(pipeline_depth=2), 0, 2),
}


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("case", sorted(_MON_CASES))
def test_monitor_lines_match_jax(case, every):
    jname, tname, extra, nrhs, P = _MON_CASES[case]
    Aj, At, b = _pair(nrhs=nrhs)
    o = dict(maxits=300, residual_rtol=1e-9, monitor_every=every, **extra)
    if P:
        part = _parts(At, P)
        jkw, tkw = {"part": part}, {"part": part, "devices": ["cpu"] * P}
        jf, tf = getattr(jdist, jname), getattr(tdist, tname)
    else:
        jkw, tkw = {}, {"device": "cpu"}
        jf, tf = getattr(jcgm, jname), getattr(tcgm, tname)
    want = _lines(jmon, lambda: jf(Aj, b, options=JOptions(**o), **jkw))
    got = _lines(tmon, lambda: tf(At, b, options=SolverOptions(**o), **tkw))
    assert want, "the JAX solve emitted nothing"
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(k % every == 0 for k, _ in got)
    # rnrm2 to 1e-6; a pipelined solve's recurred gamma near its exit
    # carries the two packages' summation orders, so rr also passes within
    # 1e-12 of the largest line (the standing history tolerance of the
    # pipelined parity tests)
    g = np.array([rr for _, rr in got])
    w = np.array([rr for _, rr in want])
    np.testing.assert_allclose(np.sqrt(g), np.sqrt(w), rtol=1e-6,
                               atol=np.sqrt(1e-12 * w.max()))


def test_monitor_changes_no_bit_and_matches_the_history():
    """Classic CG's lines are its history's values at their counts, and
    monitoring changes nothing the solve returns."""
    _, At, b = _pair()
    o = dict(maxits=300, residual_rtol=1e-9)
    ref = tcgm.cg(At, b, options=SolverOptions(**o), device="cpu")
    res = []
    got = _lines(tmon, lambda: res.append(tcgm.cg(
        At, b, options=SolverOptions(monitor_every=2, **o), device="cpu")))
    np.testing.assert_array_equal(res[0].x, ref.x)
    assert [k for k, _ in got] == list(range(2, ref.niterations + 1, 2))
    for k, rr in got:
        assert rr == ref.residual_history[k]


def test_muted_keeps_sinks_and_drops_the_printer(capsys):
    got = []

    def sink(k, rr):
        got.append((k, rr))

    tmon.add_monitor_sink(sink)
    try:
        with tmon.muted():
            tmon.emit_residual_line(3, 4.0)
        tmon.emit_residual_line(4, 9.0)
    finally:
        tmon.remove_monitor_sink(sink)
    assert got == [(3, 4.0), (4, 9.0)]
    err = capsys.readouterr().err
    assert "iteration 3" not in err
    assert "iteration 4: rnrm2 3.00000000e+00" in err
    assert sink not in tmon.monitor_sinks()
    assert tmon._print_sink in tmon.monitor_sinks()


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = tpoisson.poisson3d_7pt(12)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("mon") / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def _stream(stderr):
    return [ln for ln in stderr.splitlines() if ln.startswith("iteration ")]


@pytest.mark.parametrize("flags", [("--monitor-every", "5"), ("-vv",)])
def test_cli_monitor_every_and_vv(matrix_file, flags):
    common = ["--manufactured-solution", "--max-iterations", "500", "-q",
              *flags]
    port = _run("acg_torch.cli", matrix_file, "--device", "cpu", *common)
    assert port.returncode == 0, port.stdout + port.stderr
    ref = _run("acg_tpu.cli", matrix_file, *common)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    pl, rl = _stream(port.stderr), _stream(ref.stderr)
    # the warmup solve is muted: one stream, the timed solve's
    assert pl and [ln.split(":")[0] for ln in pl] == \
        [ln.split(":")[0] for ln in rl]
    ks = [int(ln.split()[1].rstrip(":")) for ln in pl]
    assert len(set(ks)) == len(ks)
    every = 5 if "--monitor-every" in flags else 1
    assert all(k % every == 0 for k in ks)
    for a, c in zip(pl, rl):
        np.testing.assert_allclose(float(a.split()[-1]),
                                   float(c.split()[-1]), rtol=1e-6)
