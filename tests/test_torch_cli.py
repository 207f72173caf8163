"""The port's CLI against the JAX package's on the same Matrix Market
file: ``python -m acg_torch.cli A.mtx --device cpu --manufactured-solution
-q`` exits 0 and needs the same iteration count (±1) as ``python -m
acg_tpu.cli``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acg_torch.io.mtxfile import MtxFile, read_mtx, write_mtx
from acg_torch.sparse.poisson import poisson3d_7pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    A = poisson3d_7pt(16)
    r, c, v = A.to_coo()
    path = str(tmp_path_factory.mktemp("cli") / "A.mtx")
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


def test_cli_matches_jax_cli(matrix_file):
    flags = ["--manufactured-solution", "--max-iterations", "500", "-q"]
    port = _run("acg_torch.cli", matrix_file, "--device", "cpu", *flags)
    assert port.returncode == 0, port.stdout + port.stderr
    ref = _run("acg_tpu.cli", matrix_file, *flags)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert abs(_iterations(port.stdout) - _iterations(ref.stdout)) <= 1
    assert "kernel: torch-plain" in port.stdout
    assert "operator format: stencil" in port.stdout
    assert "floating-point exceptions: none" in port.stdout
    # the same stats block: every line label of the reference's block
    # that the port prints must be spelled the same way
    labels = {ln.split(":")[0].strip() for ln in ref.stdout.splitlines()
              if ":" in ln}
    for ln in port.stdout.splitlines():
        if ":" in ln and not ln.startswith("manufactured"):
            assert ln.split(":")[0].strip() in labels, ln


def test_cli_writes_solution(matrix_file, tmp_path):
    out = str(tmp_path / "x.mtx")
    r = _run("acg_torch.cli", matrix_file, "--device", "cpu",
             "--format", "dia", "--dtype", "float32",
             "--residual-rtol", "1e-5", "--output-solution", out, "-v")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "kernel: torch-plain (format forced: dia)" in r.stdout
    x = read_mtx(out).vals
    assert x.shape == (16 ** 3,) and np.all(np.isfinite(x))
    assert "reading matrix" in r.stderr          # -v logs to stderr
    # plain versions on the CPU: no kernel launched in the timed solve
    assert ("kernel launches in the timed solve: dia_spmv 0, "
            "stencil_spmv 0") in r.stderr


def test_cli_reports_non_convergence(matrix_file):
    r = _run("acg_torch.cli", matrix_file, "--device", "cpu",
             "--max-iterations", "2", "-q")
    assert r.returncode == 1
    assert "did not converge" in r.stderr
    assert _iterations(r.stdout) == 2           # stats of the failed solve


def test_cli_default_device_without_cuda_fails(matrix_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run("acg_torch.cli", matrix_file, "-q")
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr


def _main_iterations(main, argv, capsys):
    """Run a CLI's ``main`` in this process: (exit code, iterations or
    None, stdout, stderr)."""
    rc = main(argv)
    out = capsys.readouterr()
    its = [ln for ln in out.out.splitlines()
           if ln.strip().startswith("iterations:")]
    return (rc, int(its[0].split(":")[1]) if its else None, out.out,
            out.err)


@pytest.mark.parametrize("solver,extra", [
    ("acg-sstep", ["--sstep", "4"]), ("cg-sstep", ["--sstep", "6"]),
    ("acg-pipelined-deep", ["--pipeline-depth", "2"]),
    ("cg-pipelined-deep", ["--pipeline-depth", "3"]),
    ("acg-pipelined-deep", ["--pipeline-depth", "1"])])
def test_cli_sstep_deep_match_jax_cli(matrix_file, solver, extra, capsys):
    from acg_torch import cli
    from acg_tpu import cli as jcli

    flags = [matrix_file, "--solver", solver, *extra,
             "--manufactured-solution", "--max-iterations", "500", "-q"]
    rc, its, out, err = _main_iterations(cli.main,
                                         flags + ["--device", "cpu"], capsys)
    assert rc == 0, out + err
    rcj, itsj, outj, errj = _main_iterations(jcli.main, flags, capsys)
    assert rcj == 0, outj + errj
    assert abs(its - itsj) <= 1
    assert "floating-point exceptions: none" in out
    kernel = [ln.strip() for ln in out.splitlines()
              if ln.strip().startswith("kernel:")][0]
    if "deep" in solver and extra[-1] != "1":
        assert f"(deep pipeline depth {extra[-1]}, " in kernel
    elif "deep" in solver:
        assert kernel == "kernel: torch-plain"


@pytest.mark.parametrize("args,msg", [
    (["--solver", "acg-sstep", "--sstep", "1"], "--sstep 1: "),
    (["--solver", "cg-sstep", "--sstep", "17"], "--sstep 17: "),
    (["--solver", "acg-pipelined-deep", "--pipeline-depth", "0"],
     "--pipeline-depth 0: "),
    (["--solver", "cg-pipelined-deep", "--pipeline-depth", "9"],
     "--pipeline-depth 9: "),
    (["--solver", "acg-sstep", "--nparts", "4", "--halo", "rdma"],
     "takes the ppermute or allgather halo"),
    (["--solver", "cg-pipelined-deep", "--nparts", "2", "--comm",
      "nvshmem"], "takes the ppermute or allgather halo")])
def test_cli_sstep_deep_refusals(matrix_file, args, msg, capsys):
    from acg_torch import cli

    rc, _, _, err = _main_iterations(
        cli.main, [matrix_file, "--device", "cpu", "-q", *args], capsys)
    assert rc == 1
    assert msg in err and "Traceback" not in err


def test_cli_sstep_deep_flags_inert_out_of_mode(matrix_file, capsys):
    """As in the JAX program, the ranges bind only in their modes."""
    from acg_torch import cli

    rc, its, _, _ = _main_iterations(
        cli.main, [matrix_file, "--device", "cpu", "-q", "--sstep", "99",
                   "--pipeline-depth", "99", "--max-iterations", "500"],
        capsys)
    assert rc == 0 and its > 0


@pytest.fixture(scope="module")
def part_files(matrix_file, tmp_path_factory):
    """The 16^3 matrix's kway part vector in 4 parts, as a text and a
    binary Matrix Market file."""
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.sparse.csr import csr_from_mtx

    A = csr_from_mtx(read_mtx(matrix_file))
    part = partition_graph(A, 4, method="kway")
    d = tmp_path_factory.mktemp("parts")
    m = MtxFile(object="vector", format="array", field="integer",
                nrows=len(part), ncols=1, nnz=len(part),
                vals=part.astype(np.float64))
    write_mtx(str(d / "p.mtx"), m)
    write_mtx(str(d / "p.bin.mtx"), m, binary=True)
    return A, part, str(d / "p.mtx"), str(d / "p.bin.mtx"), matrix_file


@pytest.mark.parametrize("binary", [False, True])
def test_cli_partition_file_gives_cg_dist_x(part_files, tmp_path, binary,
                                            capsys):
    """--partition FILE (text, or binary with --binary-partition) runs the
    distributed solve on that part vector: the written solution is the
    library's cg_dist(part=...) solution."""
    from acg_torch import cli
    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg_dist import cg_dist

    A, part, text, binf, path = part_files
    out = str(tmp_path / "x.mtx")
    args = [binf, "--binary-partition"] if binary else [text]
    rc, its, stdout, err = _main_iterations(
        cli.main, [path, "--device", "cpu", "--nparts", "4",
                   "--partition", *args, "--max-iterations", "500",
                   "--output-solution", out, "--numfmt", "%.17g", "-q"],
        capsys)
    assert rc == 0, stdout + err
    res = cg_dist(A, np.ones(A.nrows), options=SolverOptions(
        maxits=500, residual_rtol=1e-9), part=part, devices=["cpu"] * 4)
    assert its == res.niterations
    np.testing.assert_array_equal(read_mtx(out).vals, res.x)


def test_cli_partition_file_refuses_a_wrong_vector(part_files, tmp_path,
                                                   capsys):
    from acg_torch import cli

    A, part, _text, _binf, path = part_files
    bad = str(tmp_path / "bad.mtx")
    write_mtx(bad, MtxFile(object="vector", format="array",
                           field="integer", nrows=A.nrows - 1, ncols=1,
                           nnz=A.nrows - 1,
                           vals=part[:-1].astype(np.float64)))
    rc, _, _, err = _main_iterations(
        cli.main, [path, "--device", "cpu", "--nparts", "4",
                   "--partition", bad, "-q"], capsys)
    assert rc == 1 and "--partition" in err and "Traceback" not in err


@pytest.mark.parametrize("solver,extra", [
    ("acg-sstep", ["--sstep", "4"]),
    ("acg-pipelined-deep", ["--pipeline-depth", "2",
                            "--residual-replacement", "50"])])
@pytest.mark.parametrize("halo", ["ppermute", "allgather"])
def test_cli_sstep_deep_nparts_match_jax_cli(matrix_file, solver, extra,
                                             halo, capsys):
    """The s-step and deep solvers over 4 CPU shards: the JAX program's
    count (±1) on the same part vector (its CPU mesh), the deep-ghost
    path named in the kernel line."""
    from acg_torch import cli
    from acg_tpu import cli as jcli

    flags = [matrix_file, "--solver", solver, *extra, "--nparts", "4",
             "--halo", halo, "--manufactured-solution",
             "--max-iterations", "500", "-q"]
    rc, its, out, err = _main_iterations(cli.main,
                                         flags + ["--device", "cpu"], capsys)
    assert rc == 0, out + err
    rcj, itsj, outj, errj = _main_iterations(jcli.main, flags, capsys)
    assert rcj == 0, outj + errj
    assert abs(its - itsj) <= 1
    kernel = [ln.strip() for ln in out.splitlines()
              if ln.strip().startswith("kernel:")][0]
    assert kernel.startswith(f"kernel: torch-plain+{halo} (")
    assert "deep ghost zones depth" in kernel


# ---------------------------------------------------------------------------
# introspection: --explain, --per-op-stats, --output-stats-json,
# --trace-json, --profile, --version; the reference-compatibility flags


def _gemv_times(out):
    line = [ln for ln in out.splitlines() if ln.strip().startswith("gemv:")]
    return int(line[0].split()[3])


def test_cli_introspection_flags(matrix_file, tmp_path, capsys):
    """All six flags at once: the audit and roofline before the solve,
    the per-op table filled with the JAX program's cadence, a stats
    document both validators accept, a Chrome trace with the pipeline's
    spans, a profiler trace in the directory."""
    import json

    from acg_torch import cli
    from acg_torch.obs.export import load_stats_document
    from acg_tpu import cli as jcli
    from acg_tpu.obs.export import SCHEMA as JSCHEMA
    from acg_tpu.obs.export import validate_stats_document as jvalidate

    doc, trace, prof = (str(tmp_path / "s.json"), str(tmp_path / "t.json"),
                        str(tmp_path / "prof"))
    flags = ["--manufactured-solution", "--max-iterations", "500", "-q",
             "--per-op-stats", "--explain"]
    rc, its, out, err = _main_iterations(
        cli.main, [matrix_file, "--device", "cpu", *flags,
                   "--hbm-gbps", "1000", "--output-stats-json", doc,
                   "--trace-json", trace, "--profile", prof], capsys)
    assert rc == 0, out + err
    rcj, itsj, outj, errj = _main_iterations(jcli.main,
                                             [matrix_file, *flags], capsys)
    assert rcj == 0, outj + errj
    for o in (out, outj):
        assert "CommAudit (" in o and "roofline model (" in o
        assert "predicted ceiling" in o
    # the cadence of the JAX program: one SpMV an iteration and the prelude's
    assert _gemv_times(out) == its + 1 and _gemv_times(outj) == itsj + 1
    d = load_stats_document(doc)
    assert jvalidate(dict(d, schema=JSCHEMA)) == []
    roof = d["introspection"]["roofline"]
    assert roof["hbm_gbps"] == 1000.0 and roof["measured_iters_per_sec"] > 0
    assert roof["roofline_frac"] > 0
    assert d["introspection"]["comm_audit"]["per_iteration"]["ppermute"][
        "count"] == 0
    assert d["stats"]["per_op"]["gemv"]["n"] == its + 1
    assert d["options"]["warmup"] == 0          # --profile: no warmup
    spans = {e["name"] for e in json.load(open(trace))["traceEvents"]
             if e["ph"] == "X"}
    assert {"read", "operator-build", "explain", "solve"} <= spans
    files = os.listdir(prof)
    assert files and all(f.endswith(".json") for f in files)
    json.load(open(os.path.join(prof, files[0])))


def test_cli_stats_document_of_a_failed_solve(matrix_file, tmp_path,
                                              capsys):
    from acg_torch import cli
    from acg_torch.obs.export import load_stats_document

    doc = str(tmp_path / "s.json")
    rc, its, out, err = _main_iterations(
        cli.main, [matrix_file, "--device", "cpu", "--max-iterations", "3",
                   "--per-op-stats", "--output-stats-json", doc, "-q"],
        capsys)
    assert rc == 1 and its == 3 and "did not converge" in err
    d = load_stats_document(doc)
    assert d["result"]["status"] == "ERR_NOT_CONVERGED"
    assert d["result"]["niterations"] == 3
    assert d["stats"]["per_op"]["gemv"]["n"] == 4
    assert d["introspection"]["roofline"] is None


@pytest.mark.parametrize("args,warned", [
    (["--solver", "host", "--explain"], "--explain"),
    (["--solver", "petsc", "--per-op-stats"], "--per-op-stats"),
    (["--solver", "acg-sstep", "--per-op-stats"], "--per-op-stats")])
def test_cli_introspection_warnings_match_jax_cli(matrix_file, args, warned,
                                                  capsys):
    from acg_torch import cli
    from acg_tpu import cli as jcli

    flags = [matrix_file, *args, "--max-iterations", "500", "-q"]
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        rc, _, out, err = _main_iterations(main, flags + extra, capsys)
        assert rc == 0, out + err
        assert f"warning: {warned}" in err and "ignored" in err
        assert "CommAudit (" not in out


@pytest.mark.parametrize("extra", [
    ["-z"], ["--gunzip"], ["--no-manufactured-solution"],
    ["--idx-size", "64"], ["--epsilon", "0.5"],
    ["--cusparse-spmv-alg", "CSR-1"]])
def test_cli_compat_flags_match_jax_cli(matrix_file, extra, capsys):
    """The reference-compatibility flags: accepted by both programs, the
    same iteration count (±1), the same note or output."""
    from acg_torch import cli
    from acg_tpu import cli as jcli

    flags = [matrix_file, "--manufactured-solution", *extra,
             "--max-iterations", "500", "-q"]
    rc, its, out, err = _main_iterations(cli.main,
                                         flags + ["--device", "cpu"], capsys)
    rcj, itsj, outj, errj = _main_iterations(jcli.main, flags, capsys)
    assert rc == rcj == 0, out + err + outj + errj
    assert abs(its - itsj) <= 1
    for o in (out, outj):
        assert ("manufactured solution error" in o) == (
            "--no-manufactured-solution" not in extra)
    if "--cusparse-spmv-alg" in extra:
        assert "note: --cusparse-spmv-alg csr-1" in err
        assert "note: --cusparse-spmv-alg csr-1" in errj
    if "--epsilon" in extra:
        rc0, its0, _, _ = _main_iterations(
            cli.main, [matrix_file, "--manufactured-solution",
                       "--max-iterations", "500", "-q", "--device", "cpu"],
            capsys)
        assert its < its0          # A + 0.5 I is better conditioned


@pytest.mark.parametrize("bad", [["--idx-size", "16"],
                                 ["--cusparse-spmv-alg", "csr-3"]])
def test_cli_compat_flags_refuse_like_jax_cli(matrix_file, bad, capsys):
    from acg_torch import cli
    from acg_tpu import cli as jcli

    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as ei:
            main([matrix_file, *bad])
        assert ei.value.code == 2
    capsys.readouterr()


def test_cli_version_prints_capabilities(capsys):
    from acg_torch import cli
    from acg_torch.obs.export import capability_info

    with pytest.raises(SystemExit) as ei:
        cli.main(["--version"])
    assert ei.value.code == 0
    out = capsys.readouterr().out
    info = capability_info()
    assert out.startswith(f"acg-torch {info['version']}")
    assert f"torch: {info['torch']}" in out
    assert "native host library: no" in out


def test_cli_serve_writes_stats_and_trace(matrix_file, tmp_path, capsys):
    import json

    from acg_torch import cli
    from acg_torch.obs.export import load_stats_document

    cmds = tmp_path / "cmds.txt"
    cmds.write_text("solve\nbatch 2\n")
    doc, trace = str(tmp_path / "s.json"), str(tmp_path / "t.json")
    rc, _, out, err = _main_iterations(
        cli.main, [matrix_file, "--device", "cpu", "--serve", str(cmds),
                   "--output-stats-json", doc, "--trace-json", trace],
        capsys)
    assert rc == 0, out + err
    d = load_stats_document(doc)
    assert d["session"] is not None and d["admission"] is not None
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert d["session"]["request_id"] == lines[-1]["request"]
    events = json.load(open(trace))["traceEvents"]
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {
        "host phases", "requests"}
    assert sum(e["ph"] == "X" and e["cat"] == "request"
               for e in events) == 3


def test_chrome_trace_has_the_jax_structure():
    """The same spans and request timelines through both packages'
    ``chrome_trace``: the same events, kinds, names, lanes and keys."""
    from acg_torch.obs import events as tev
    from acg_torch.obs.trace import SpanTracer
    from acg_tpu.obs import events as jev
    from acg_tpu.obs.trace import SpanTracer as JTracer

    docs = []
    for ev, tracer in ((tev, SpanTracer()), (jev, JTracer())):
        rec = ev.FlightRecorder(capacity=4)
        with tracer.span("read"):
            with tracer.span("inner"):
                pass
        with tracer.span("solve"):
            tl = rec.begin(request_id="r1", trace_id="ab" * 8)
            tl.event("dispatch", bucket=4)
        docs.append(ev.chrome_trace(tracer=tracer, recorder=rec))

    def shape(doc):
        return [(e["name"], e["ph"], e["pid"], e["tid"], sorted(e),
                 sorted(e.get("args", {})))
                for e in doc["traceEvents"]]

    assert shape(docs[0]) == shape(docs[1])
    assert docs[0]["displayTimeUnit"] == docs[1]["displayTimeUnit"]
    merged = tev.merge_recorder_dumps([tev.FlightRecorder(), None])
    assert merged == []
