"""The port's host solvers against the JAX package's: ``cg_host`` (the
NumPy oracle) and ``cg_scipy`` (the SciPy baseline) are the same host
arithmetic in both packages, so counts, histories and solutions agree to
the last rounding of the two CSR products (1e-12 relative), and their
errors carry the same statuses; the CLI's ``--solver host|petsc*``
refuses ``--nrhs > 1`` and otherwise needs the JAX program's count."""

import os
import subprocess
import sys

import numpy as np
import pytest

from acg_tpu.config import SolverOptions as JOptions
from acg_tpu.errors import AcgError as JAcgError
from acg_tpu.obs import monitor as jmon
from acg_tpu.solvers.baseline import cg_scipy as jcg_scipy
from acg_tpu.solvers.cg_host import cg_host as jcg_host
from acg_tpu.sparse import csr as jcsr
from acg_tpu.sparse import poisson as jpoisson

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import MtxFile, write_mtx
from acg_torch.obs import monitor as tmon
from acg_torch.solvers.baseline import cg_scipy
from acg_torch.solvers.cg_host import cg_host
from acg_torch.sparse import csr as tcsr
from acg_torch.sparse import poisson as tpoisson

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _systems(seed=0):
    Aj, At = jpoisson.poisson3d_7pt(10), tpoisson.poisson3d_7pt(10)
    _, b = tcsr.manufactured_rhs(At, seed=seed)
    return Aj, At, b


def _indefinite(pkg):
    n = 40
    i = np.arange(n)
    d = np.where(i % 7 == 3, -2.0, 4.0)
    return pkg.coo_to_csr(np.r_[i, i[:-1], i[:-1] + 1],
                          np.r_[i, i[:-1] + 1, i[:-1]],
                          np.r_[d, np.full(n - 1, -1.0),
                                np.full(n - 1, -1.0)], n, n)


@pytest.mark.parametrize("kw", [dict(residual_rtol=1e-10),
                                dict(residual_atol=1e-6, residual_rtol=0.0),
                                dict(diffatol=1e-9, residual_rtol=0.0),
                                dict(diffrtol=1e-8, residual_rtol=0.0)])
@pytest.mark.parametrize("with_x0", [False, True])
def test_cg_host_matches_jax(kw, with_x0):
    Aj, At, b = _systems()
    x0 = (np.random.default_rng(1).standard_normal(At.nrows) if with_x0
          else None)
    o = dict(maxits=1000, **kw)
    rj = jcg_host(Aj, b, x0=x0, options=JOptions(**o))
    rt = cg_host(At, b, x0=x0, options=SolverOptions(**o))
    assert rt.converged and rj.converged
    assert rt.niterations == rj.niterations
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rt.residual_history, rj.residual_history,
                               rtol=1e-10, atol=1e-24)
    for f in ("rnrm2", "r0nrm2", "bnrm2", "x0nrm2", "dxnrm2"):
        np.testing.assert_allclose(getattr(rt, f), getattr(rj, f),
                                   rtol=1e-10)


@pytest.mark.parametrize("with_x0", [False, True])
def test_cg_scipy_matches_jax(with_x0):
    Aj, At, b = _systems(seed=2)
    x0 = (np.random.default_rng(3).standard_normal(At.nrows) if with_x0
          else None)
    o = dict(maxits=1000, residual_rtol=1e-10)
    rj = jcg_scipy(Aj, b, x0=x0, options=JOptions(**o), record_history=True)
    rt = cg_scipy(At, b, x0=x0, options=SolverOptions(**o),
                  record_history=True)
    assert rt.converged and rj.converged
    assert rt.niterations == rj.niterations
    assert rt.stats.nflops == rj.stats.nflops
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rt.residual_history, rj.residual_history,
                               rtol=1e-10)
    assert rt.rnrm2 / rt.r0nrm2 < 1e-10
    # history off by default: no extra products in the timed window
    assert cg_scipy(At, b, options=SolverOptions(**o)).residual_history \
        is None


def test_host_solver_errors_match_jax():
    Aj, At, b = _systems()
    # maxits exhausted: not converged, the partial result attached
    for jf, tf in ((jcg_host, cg_host), (jcg_scipy, cg_scipy)):
        o = dict(maxits=3, residual_rtol=1e-12)
        with pytest.raises(JAcgError) as ej:
            jf(Aj, b, options=JOptions(**o))
        with pytest.raises(AcgError) as et:
            tf(At, b, options=SolverOptions(**o))
        assert et.value.status == Status.ERR_NOT_CONVERGED
        assert int(et.value.status) == int(ej.value.status)
        assert et.value.result.niterations == ej.value.result.niterations
        # one right-hand side at a time
        with pytest.raises(AcgError) as et:
            tf(At, np.stack([b, b]), options=SolverOptions())
        assert et.value.status == Status.ERR_NOT_SUPPORTED
    # an indefinite operator: the breakdown, as in the JAX oracle
    bi = np.ones(40)
    with pytest.raises(JAcgError) as ej:
        jcg_host(_indefinite(jcsr), bi, options=JOptions(maxits=200))
    with pytest.raises(AcgError) as et:
        cg_host(_indefinite(tcsr), bi, options=SolverOptions(maxits=200))
    assert et.value.status == Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX
    assert et.value.result.niterations == ej.value.result.niterations
    # the SciPy baseline takes residual criteria only
    with pytest.raises(AcgError) as et:
        cg_scipy(At, b, options=SolverOptions(diffatol=1e-8))
    assert et.value.status == Status.ERR_NOT_SUPPORTED
    # no criteria: maxits iterations, reported converged
    r = cg_host(At, b, options=SolverOptions(maxits=7, residual_rtol=0.0))
    assert r.converged and r.niterations == 7


def _monitor_lines(mon, run):
    """The ``(k, rr)`` pairs a solve emits through ``mon``'s sinks (the
    stderr printer muted)."""
    got = []

    def sink(k, rr):
        got.append((int(k), float(rr)))

    mon.add_monitor_sink(sink)
    try:
        with mon.muted():
            res = run()
    finally:
        mon.remove_monitor_sink(sink)
    return got, res


@pytest.mark.parametrize("every", [1, 5])
@pytest.mark.parametrize("which", ["cg_host", "cg_scipy"])
def test_host_monitor_lines_match_jax(which, every):
    """``monitor_every`` on the host solvers: the same ``(k, rr)`` lines
    as the JAX package's (cg_host: the recurred |r_k|^2 after each
    update; cg_scipy: the true |b - S x_k|^2 from SciPy's callback), to
    the last rounding of the CSR products, on a 12^2 Poisson system."""
    Aj, At = jpoisson.poisson2d_5pt(12), tpoisson.poisson2d_5pt(12)
    _, b = tcsr.manufactured_rhs(At, seed=4)
    jf, tf = {"cg_host": (jcg_host, cg_host),
              "cg_scipy": (jcg_scipy, cg_scipy)}[which]
    o = dict(maxits=500, residual_rtol=1e-10, monitor_every=every)
    want, _ = _monitor_lines(jmon, lambda: jf(Aj, b, options=JOptions(**o)))
    got, res = _monitor_lines(tmon,
                              lambda: tf(At, b, options=SolverOptions(**o)))
    assert want, "the JAX solve emitted nothing"
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [k for k, _ in got] == list(range(every, res.niterations + 1,
                                             every))
    np.testing.assert_allclose([rr for _, rr in got],
                               [rr for _, rr in want], rtol=1e-12)
    # the lines are the history's samples (SciPy records it when the
    # monitor is on), and monitoring changes nothing the solve returns
    for k, rr in got:
        assert rr == res.residual_history[k]
    quiet = tf(At, b, options=SolverOptions(**dict(o, monitor_every=0)))
    np.testing.assert_array_equal(res.x, quiet.x)
    assert res.niterations == quiet.niterations


def test_cg_host_guard_nonfinite():
    _, At, b = _systems()
    b = b.copy()
    b[3] = np.nan
    with pytest.raises(AcgError) as et:
        cg_host(At, b, options=SolverOptions(guard_nonfinite=True))
    assert et.value.status == Status.ERR_FAULT_DETECTED


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = tpoisson.poisson3d_7pt(12)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("hostcli") / "A.mtx")
    write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                            rowidx=r, colidx=c, vals=v))
    return path


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def _iterations(stdout):
    lines = [ln for ln in stdout.splitlines()
             if ln.strip().startswith("iterations:")]
    assert len(lines) == 1, stdout
    return int(lines[0].split(":")[1])


@pytest.mark.parametrize("solver", ["host", "petsc", "petsc-pipelined"])
def test_cli_host_solvers(matrix_file, solver):
    """The host solvers need no device: they run without ``--device``
    (no card here) and print the JAX program's stats block and count;
    ``--nrhs 2`` exits 1."""
    flags = ["--solver", solver, "--manufactured-solution",
             "--max-iterations", "500", "-q"]
    port = _run("acg_torch.cli", matrix_file, *flags)
    assert port.returncode == 0, port.stdout + port.stderr
    ref = _run("acg_tpu.cli", matrix_file, *flags)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert _iterations(port.stdout) == _iterations(ref.stdout)
    assert "floating-point exceptions: none" in port.stdout
    r = _run("acg_torch.cli", matrix_file, "--solver", solver, "--nrhs",
             "2", "-q")
    assert r.returncode == 1
    assert "--nrhs > 1 requires a device solver" in r.stderr
    assert "Traceback" not in r.stderr
