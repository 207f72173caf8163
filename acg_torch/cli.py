"""``acg-torch`` command-line program, on one device or over shards.

The port of the single-device and distributed paths of
``acg_tpu/cli.py`` (itself the counterpart of the reference program
cuda/acg-cuda.c): the same positional arguments (A [b] [x0], Matrix
Market files), the same flags for what is ported, the same pipeline and
the same stats block:

  read A -> build the device operator -> b from file / ones /
  manufactured solution -> warmup solves -> solve -> stats ->
  (optionally) write the solution.

``--solver`` takes the JAX program's eleven choices: ``acg`` (classic
CG) and ``acg-pipelined`` (pipelined CG), with their aliases
``acg-device`` and ``acg-device-pipelined``; ``acg-sstep`` / ``cg-sstep``
(s-step CG, one Gram reduction per ``--sstep`` iterations);
``acg-pipelined-deep`` / ``cg-pipelined-deep`` (``--pipeline-depth``
reductions in flight); ``host`` (the NumPy oracle) and ``petsc`` /
``petsc-pipelined`` (the SciPy baseline), which run on the host and take
one right-hand side.  ``--nrhs K`` solves K copies of the right-hand side
in one batched loop (the multi-RHS kernels).
``--format`` takes the JAX program's layouts: ``auto`` (the stencil,
DIA, RCM+DIA, RCM+sgell or ELL tier, as the matrix allows), ``dia``,
``ell``, ``sgell`` (f32 only) and ``stencil``.
``--device`` picks where it runs (default ``cuda``; with no card that
default is an error, never a silent CPU run).  ``--nparts P`` (P > 1)
runs distributed CG over P shards (``acg_torch.solvers.cg_dist``:
classic; pipelined with ``--solver acg-pipelined``; s-step and
depth-L pipelined with ``--solver acg-sstep`` / ``acg-pipelined-deep``,
whose basis runs in deep ghost zones, one depth-s (or depth-L) exchange
a block or fill chain, on the SpMV kernel without the dot and
``ell_spmv`` on the deep interface and skin; and with ``--nrhs K`` K
systems in one loop), partitioned by ``--partition-method``
(auto|chunk|rb|bfs|kway|multilevel) or read from ``--partition FILE``
(a part vector as ``acg_torch.tools.mtxpartition`` writes it; binary
with ``--binary-partition``), with the halo of ``--halo``
(ppermute|allgather|rdma, or from ``--comm``; the s-step and deep
solvers take ppermute or allgather) and its messages in the encoding of
``--halo-wire`` (f32|bf16|int16-delta; rdma sends f32 only); on CUDA the
shards take the visible cards, one each (one card and P > 1 exit 1 with
ERR_MESH, as the JAX program does on one chip), and with ``--device
cpu`` they share the CPU.  ``--serve FILE`` prepares the operator
once and serves requests from a file of commands through the serve
stack (``acg_torch/serve/``: resident solves, the coalescing queue, the
admission layer), one JSON line a request.
Introspection: ``--explain`` prints the counted CommAudit and the
roofline before the solve (``acg_torch/obs/audit.py``,
``obs/roofline.py``, ``--hbm-gbps``), ``--per-op-stats`` fills the per-op
table (``utils/profile.py``), ``--output-stats-json`` writes the stats
document (``obs/export.py``, also for a failed solve), ``--trace-json``
the host phase spans as a Chrome trace and ``--profile DIR`` a
``torch.profiler`` trace of the solve; ``--version`` prints the
capability matrix.

Run: ``python -m acg_torch.cli A.mtx --manufactured-solution -v``
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError, Status
from acg_torch.io.mtxfile import read_mtx, vector_to_mtx, write_mtx
from acg_torch.sparse.csr import csr_from_mtx, manufactured_rhs
from acg_torch.utils.stats import format_solver_stats


# the JAX program's --solver choices (acg_tpu/cli.py)
_SOLVERS = ("acg", "acg-pipelined", "acg-sstep", "cg-sstep", "acg-device",
            "acg-device-pipelined", "acg-pipelined-deep",
            "cg-pipelined-deep", "host", "petsc", "petsc-pipelined")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="acg-torch",
        description="Solve a linear system Ax=b using the conjugate "
                    "gradient (CG) method on one GPU.")
    p.add_argument("A", help="path to Matrix Market file for the matrix A")
    p.add_argument("b", nargs="?", default=None,
                   help="optional Matrix Market file for right-hand side b")
    p.add_argument("x0", nargs="?", default=None,
                   help="optional Matrix Market file for initial guess x0")
    # -z is accepted so reference command lines run unchanged (ref
    # cuda/acg-cuda.c usage "-z, --gzip ... filter files through gzip"); a
    # no-op: gzip input is recognized by its magic bytes
    p.add_argument("-z", "--gzip", "--gunzip", "--ungzip",
                   action="store_true", dest="gzip",
                   help="accepted for reference compatibility; gzip input "
                        "is recognized, so this is a no-op")
    p.add_argument("--binary", action="store_true",
                   help="read Matrix Market files in binary format")
    p.add_argument("--seed", type=int, default=0, help="random seed [0]")
    p.add_argument("--partition", metavar="FILE", default=None,
                   help="read the part vector of --nparts > 1 from a "
                        "Matrix Market file (python -m "
                        "acg_torch.tools.mtxpartition writes one)")
    p.add_argument("--binary-partition", action="store_true",
                   help="read the --partition file in binary format")
    p.add_argument("--partition-method", default="auto",
                   choices=["auto", "chunk", "rb", "bfs", "kway",
                            "multilevel"],
                   help="graph partitioner for --nparts > 1 without "
                        "--partition [auto]: auto takes exact grid blocks "
                        "for a stencil, chunk (contiguous row slabs) for "
                        "other banded matrices, rb (recursive bisection + "
                        "refinement) otherwise; bfs (greedy BFS growing) "
                        "and kway (k seeds grown together), each refined; "
                        "multilevel (the METIS-style V-cycle)")
    p.add_argument("--nparts", type=int, default=1,
                   help="number of row shards [1]; > 1 runs distributed "
                        "CG (every --solver but host and petsc*, one or "
                        "--nrhs systems), one shard per visible card (or "
                        "on the CPU with --device cpu)")
    p.add_argument("--nrhs", type=int, default=1, metavar="K",
                   help="solve K right-hand sides against the one operator "
                        "in a single batched loop (the operator is read "
                        "once per iteration for all K systems); the "
                        "right-hand side is replicated K times and the "
                        "first system's solution is written [1]")
    p.add_argument("--max-iterations", type=int, default=100, metavar="N",
                   help="maximum number of iterations [100]")
    p.add_argument("--diff-atol", type=float, default=0.0, metavar="TOL")
    p.add_argument("--diff-rtol", type=float, default=0.0, metavar="TOL")
    p.add_argument("--residual-atol", type=float, default=0.0, metavar="TOL")
    p.add_argument("--residual-rtol", type=float, default=1e-9,
                   metavar="TOL")
    p.add_argument("--epsilon", type=float, default=0.0, metavar="TOL",
                   help="add TOL to the diagonal of A [0]")
    p.add_argument("--warmup", type=int, default=1, metavar="N",
                   help="perform N warmup solves before the timed solve, so "
                        "tsolve excludes kernel builds and first-touch "
                        "costs [1]")
    p.add_argument("--solver", default="acg", choices=_SOLVERS,
                   help="solver variant [acg]; acg-device* are aliases of "
                        "acg*; acg-pipelined runs pipelined CG (one fused "
                        "reduction per iteration, the whole iteration in "
                        "one kernel); acg-sstep / cg-sstep run s-step CG "
                        "(one Gram reduction per --sstep iterations); "
                        "acg-pipelined-deep / cg-pipelined-deep run the "
                        "depth-L pipelined loop (--pipeline-depth "
                        "reductions in flight, certified exits); host "
                        "runs the NumPy oracle and petsc* the SciPy "
                        "baseline, on the host")
    p.add_argument("--sstep", type=int, default=4, metavar="S",
                   help="s-step block size for --solver acg-sstep: one "
                        "Gram reduction per S iterations; 2 <= S <= 16 "
                        "(an indefinite Gram falls back to classic CG, "
                        "said in the kernel line) [4]")
    p.add_argument("--pipeline-depth", type=int, default=2, metavar="L",
                   help="depth for --solver acg-pipelined-deep: L dot-block "
                        "reductions in flight, every exit certified "
                        "against the true residual; 1 <= L <= 8 (L = 1 is "
                        "the ordinary pipelined solver) [2]")
    p.add_argument("--check-every", type=int, default=1, metavar="K",
                   help="test convergence every K iterations; the host "
                        "reads the device loop's flag only then [1]")
    p.add_argument("--monitor-every", type=int, default=0, metavar="K",
                   help="stream one 'iteration k: rnrm2 ...' line to "
                        "stderr every K iterations of a device solver, "
                        "emitted when the loop reads the device (the "
                        "reference's verbose per-iteration residuals); "
                        "-vv enables it with K=1 [0 = off]")
    p.add_argument("--residual-replacement", type=int, default=0,
                   metavar="R",
                   help="pipelined CG: recompute r/w/s/z from their "
                        "definitions every R iterations, correcting "
                        "recurrence drift at tight tolerances (0 = off)")
    p.add_argument("--comm", default=None,
                   choices=["none", "mpi", "nccl", "nvshmem", "rccl",
                            "rocshmem"],
                   help="reference compatibility: mpi/nccl/rccl select "
                        "--halo ppermute, nvshmem/rocshmem (device-"
                        "initiated) --halo rdma, unless --halo is given")
    p.add_argument("--halo", default=None,
                   choices=["ppermute", "allgather", "rdma"],
                   help="halo exchange of --nparts > 1 [ppermute]: "
                        "edge-coloured neighbour copies, one gather of "
                        "every part's border values, or the device-"
                        "initiated put+signal kernel (CUDA only)")
    p.add_argument("--halo-wire", default="f32",
                   choices=["f32", "bf16", "int16-delta"],
                   help="on-wire halo message encoding for --nparts > 1 "
                        "[f32 = the vector dtype, exact]; bf16 / "
                        "int16-delta send two bytes a value and decode "
                        "before any arithmetic (ppermute and allgather "
                        "only)")
    p.add_argument("--format", default="auto",
                   choices=["auto", "dia", "ell", "sgell", "stencil"],
                   help="device operator layout [auto]: auto picks the "
                        "stencil, DIA, RCM+DIA, RCM+sgell or ELL tier; "
                        "stencil errors unless the matrix is a verified "
                        "constant-coefficient grid stencil; sgell needs "
                        "--dtype float32")
    p.add_argument("--cusparse-spmv-alg", default=None, metavar="ALG",
                   type=str.lower, choices=["default", "csr-1", "csr-2"],
                   help="reference compatibility (ref cuda/acg-cuda.c:714, "
                        "the cuSPARSE algorithm selector, the same choices, "
                        "any case): accepted with a note; the port's SpMV "
                        "kernels are its own, chosen by --format")
    p.add_argument("--dtype", default="float64",
                   choices=["float32", "float64"],
                   help="value precision [float64]")
    p.add_argument("--idx-size", type=int, default=32, choices=[32, 64],
                   help="column-index width of the host matrix, the "
                        "acgidx_t analog (ref acg/config.h) [32]")
    p.add_argument("--mat-precision", default="auto",
                   choices=["auto", "same", "bfloat16", "float32", "int8"],
                   help="operator STORAGE precision (compute stays at "
                        "--dtype): auto = narrow to bfloat16 only when "
                        "exact; same = store at --dtype; int8 = force the "
                        "exact two-value mask tier; bfloat16/float32 = opt "
                        "into mixed-precision CG [auto]")
    p.add_argument("--manufactured-solution", action="store_true",
                   help="use a manufactured solution and right-hand side")
    p.add_argument("--no-manufactured-solution", action="store_false",
                   dest="manufactured_solution",
                   help="disable the manufactured solution (ref "
                        "cuda/acg-cuda.c:753)")
    p.add_argument("--numfmt", default="%.17g", metavar="FMT",
                   help="printf-style format for numeric output")
    p.add_argument("--output-solution", metavar="FILE", default=None,
                   help="write solution vector to Matrix Market FILE")
    # introspection (acg_torch/obs/, acg_torch/utils/profile.py)
    p.add_argument("--per-op-stats", action="store_true",
                   help="time each op class alone on the loop's kernels "
                        "(CUDA events on the card) and fill the per-op "
                        "breakdown table (ref ACG_ENABLE_PROFILING)")
    p.add_argument("--explain", action="store_true",
                   help="before solving, print the counted CommAudit (halo "
                        "exchanges, reductions, kernel launches and host "
                        "reads an iteration, from two short fixed-"
                        "iteration solves) and the roofline model (bytes "
                        "an iteration and the iteration-rate ceiling); "
                        "both go into --output-stats-json")
    p.add_argument("--hbm-gbps", type=float, default=None, metavar="GBPS",
                   help="memory rate of the roofline model, GB/s [the "
                        "table in acg_torch/obs/roofline.py, keyed by the "
                        "card's name]")
    p.add_argument("--output-stats-json", metavar="FILE", default=None,
                   help="write the stats block (per-op counters, norms, "
                        "convergence history, phase spans, capability "
                        "matrix, introspection) as one JSON document, "
                        "schema acg-torch-stats/1, for failed solves too; "
                        "with --serve, the last request's audit document")
    p.add_argument("--trace-json", metavar="FILE", default=None,
                   help="write the host phase spans (and with --serve the "
                        "request timelines) as a Chrome trace-event file "
                        "(Perfetto, chrome://tracing)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="trace the solve with torch.profiler (CPU and CUDA "
                        "activity) into a Chrome trace in DIR; no warmup "
                        "solve runs")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to solve [cuda]; cpu runs the plain PyTorch "
                        "versions of the kernels")
    # serving (acg_torch/serve/: a persistent Session, the coalescing
    # admission queue, the admission-guarded SolverService)
    p.add_argument("--serve", metavar="FILE", default=None,
                   help="serve mode: prepare the operator ONCE (Session: "
                        "read/partition/operator-build paid once, the "
                        "loop's state kept a signature, its CUDA graphs "
                        "replayed by later requests) and process requests "
                        "from FILE ('-' = stdin), one command per line: "
                        "'solve [B.mtx]' (default: the CLI's b); 'batch K "
                        "[B.mtx]' submits K requests through the "
                        "coalescing queue (one batched solve); 'stats', "
                        "'health', 'metrics [prom]', 'flightrec', "
                        "'flush', 'quit'.  One JSON line per request on "
                        "stdout; exit 1 if any request failed")
    p.add_argument("--serve-max-batch", type=int, default=8, metavar="B",
                   help="coalescing queue: max requests per batched "
                        "dispatch [8]")
    p.add_argument("--serve-max-wait-ms", type=float, default=0.0,
                   metavar="MS",
                   help="coalescing queue: max time the oldest pending "
                        "request waits for batch-mates [0 = dispatch "
                        "whatever is queued]")
    p.add_argument("--serve-buckets", default=None, metavar="B1,B2,..",
                   help="admitted padded batch sizes (bounds the cached "
                        "signatures) [powers of two up to "
                        "--serve-max-batch]")
    p.add_argument("--serve-max-depth", type=int, default=0, metavar="D",
                   help="load shedding: reject new requests with "
                        "ERR_OVERLOADED once D are pending [0 = "
                        "unbounded]")
    p.add_argument("--deadline-ms", type=float, default=0.0, metavar="MS",
                   help="per-request deadline: a request still queued at "
                        "it is shed with ERR_TIMEOUT [0 = none]")
    p.add_argument("--queue-deadline-ms", type=float, default=0.0,
                   metavar="MS",
                   help="the in-queue slice of --deadline-ms [0 = the "
                        "whole deadline]")
    p.add_argument("--max-retries", type=int, default=0, metavar="N",
                   help="retry a request that failed TRANSIENTLY "
                        "(ERR_NONFINITE / ERR_FAULT_DETECTED) alone up to "
                        "N times with seeded backoff [0]")
    p.add_argument("--breaker-threshold", type=int, default=0,
                   metavar="K",
                   help="circuit breaker: K consecutive failures on one "
                        "(solver, bucket, dtype) trip it OPEN [0 = no "
                        "breaker]")
    p.add_argument("--breaker-cooldown-ms", type=float, default=1000.0,
                   metavar="MS",
                   help="how long an OPEN breaker waits before "
                        "half-opening for one probe [1000]")
    p.add_argument("--degrade", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="while a pipelined solver's breaker is open, "
                        "serve its requests with classic CG "
                        "(--no-degrade: fast-fail them) [on]")
    p.add_argument("--metrics", action="store_true",
                   help="enable the runtime-metrics registry "
                        "(acg_torch/obs/metrics.py), read by --serve's "
                        "'metrics' command [off]")
    # not ported yet: refused with ERR_NOT_SUPPORTED (ROADMAP Queue 1)
    for flag, kw in (("--replicas", dict(type=int, default=1,
                                         metavar="R")),
                     ("--elastic", dict(action="store_true")),
                     ("--min-replicas", dict(type=int, default=None,
                                             metavar="R")),
                     ("--max-replicas", dict(type=int, default=None,
                                             metavar="R")),
                     ("--slo-p99-ms", dict(type=float, default=None,
                                           metavar="MS")),
                     ("--obs-port", dict(type=int, default=None,
                                         metavar="PORT")),
                     ("--resilient", dict(action="store_true"))):
        p.add_argument(flag, help="not ported: refused", **kw)
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress solution output")
    p.add_argument("--version", action=_VersionAction, nargs=0,
                   help="print version and capability matrix, then exit")
    return p


class _VersionAction(argparse.Action):
    """Version and capability matrix (the reference's --version report,
    cuda/acg-cuda.c:382-440), from ``obs/export.capability_info``: the
    dict the stats document embeds."""

    def __call__(self, parser, namespace, values, option_string=None):
        from acg_torch.obs.export import capability_info

        info = capability_info()
        print(f"acg-torch {info['version']}")
        print(f"  torch: {info['torch']}  cuda: {info['cuda']}")
        print(f"  platform: {', '.join(info['platforms'])} "
              f"({info['ndevices']} CUDA device(s))")
        if info["device_kinds"]:
            print(f"  device kind: {', '.join(info['device_kinds'])}")
        print(f"  processes: {info['processes']}")
        print("  native host library: no (NumPy host code)")
        if info.get("scipy"):
            print(f"  scipy baseline (--solver petsc): {info['scipy']}")
        else:
            print("  scipy baseline: unavailable")
        parser.exit()


def _log(args, msg):
    if args.verbose:
        print(msg, file=sys.stderr, flush=True)


def resolve_halo(comm: str | None, halo: str | None) -> str:
    """The halo of the reference's --comm spelling: an explicit --halo
    wins; nvshmem/rocshmem (device-initiated) mean rdma, every other
    backend ppermute (``acg_tpu/cli.py`` ``resolve_halo``)."""
    if halo is not None:
        return halo
    return "rdma" if comm in ("nvshmem", "rocshmem") else "ppermute"


def _first_system(x):
    """The one representative solution of a --nrhs batch: the systems
    are copies of one b, and every 1-D consumer (the manufactured-error
    report, the solution output) takes system 0."""
    x = np.asarray(x)
    return x[0] if x.ndim == 2 else x


def _refuse_unported(args) -> None:
    """The serve stack's flags whose modules are not ported (the replica
    fleet, its autoscaler, the observability plane, resilient solving):
    ERR_NOT_SUPPORTED, in every mode."""
    given = [f for f, on in (
        ("--replicas", args.replicas != 1), ("--elastic", args.elastic),
        ("--min-replicas", args.min_replicas is not None),
        ("--max-replicas", args.max_replicas is not None),
        ("--slo-p99-ms", args.slo_p99_ms is not None),
        ("--obs-port", args.obs_port is not None),
        ("--resilient", args.resilient)) if on]
    if given:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"{', '.join(given)}: not ported (the replica "
                       "fleet, its autoscaler, the observability plane "
                       "and resilient solving are not in acg_torch)")


def _read_partition(args, A):
    """The part vector of ``--partition FILE``, checked against A and
    ``--nparts`` (None without the flag)."""
    if not args.partition:
        return None
    # the pinned part vector is honoured exactly: partitioning again
    # would change the halo and the tiers under the user
    part = read_mtx(args.partition,
                    binary=args.binary_partition or None
                    ).vals.astype(np.int32)
    if part.shape != (A.nrows,) or part.min(initial=0) < 0 \
            or int(part.max(initial=0)) + 1 != args.nparts:
        raise AcgError(
            Status.ERR_INVALID_VALUE,
            f"--partition {args.partition}: want a part in [0, "
            f"{args.nparts}) for each of the {A.nrows} rows, part "
            f"{args.nparts - 1} among them; got {part.shape[0]} "
            f"entries in [{part.min(initial=0)}, "
            f"{part.max(initial=0)}]")
    return part


def _serve_main(args, tracer, A, b, options, device, halo: str,
                mat_dtype) -> int:
    """--serve: the solver-as-a-service REPL (``acg_torch/serve/``, the
    port of ``acg_tpu/cli.py`` ``_serve_main``).  One Session holds the
    prepared operator; commands submit right-hand sides through the
    coalescing admission queue; one JSON line per completed request goes
    to stdout."""
    import json

    from acg_torch.config import HaloMethod
    from acg_torch.serve import AdmissionPolicy, Session, SolverService

    if args.solver == "host" or args.solver.startswith("petsc"):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"--serve drives the device solvers (--solver "
                       f"{args.solver} prepares no resident operator)")
    if args.nrhs > 1:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       "--serve batches requests through its own queue; "
                       "--nrhs does not apply (use 'batch K')")
    try:
        buckets = (tuple(int(v) for v in args.serve_buckets.split(","))
                   if args.serve_buckets else ())
    except ValueError:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"--serve-buckets {args.serve_buckets!r}: "
                       "expected a comma-separated list of ints "
                       "(e.g. 1,4,8)")
    admission = AdmissionPolicy(
        deadline_ms=args.deadline_ms,
        queue_deadline_ms=args.queue_deadline_ms,
        max_retries=args.max_retries, seed=args.seed,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_ms=args.breaker_cooldown_ms,
        max_queue_depth=args.serve_max_depth,
        degrade=args.degrade)
    dist = args.nparts > 1
    session = Session(
        A, nparts=args.nparts, part=_read_partition(args, A) if dist
        else None, dtype=np.dtype(args.dtype), fmt=args.format,
        mat_dtype=mat_dtype, halo=HaloMethod(halo),
        partition_method=args.partition_method, seed=args.seed,
        options=options, tracer=tracer,
        device=None if dist else device,
        devices=(None if not dist or device.type == "cuda"
                 else [device] * args.nparts))
    svc = SolverService(
        session, solver=args.solver, options=options,
        max_batch=args.serve_max_batch,
        max_wait_ms=args.serve_max_wait_ms, buckets=buckets,
        admission=admission)

    def _read_rhs(path: str):
        vec = read_mtx(path, binary=args.binary or None).vals.astype(
            np.dtype(args.dtype))
        if vec.shape[0] != A.nrows:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"right-hand side {path!r} has {vec.shape[0]} "
                           f"entries, matrix has {A.nrows} rows")
        return vec

    last = {"audit": None}

    def _emit(resp):
        print(json.dumps(resp.summary()), flush=True)
        last["audit"] = resp.audit
        return resp

    def _emit_rejected(e: Exception, lineno: int) -> int:
        """A request REFUSED before admission (non-finite RHS, an
        unreadable/missing RHS file, size mismatch) is a classified
        per-request outcome: one JSON line, and the session goes on."""
        if isinstance(e, AcgError):
            if e.status not in (Status.ERR_INVALID_VALUE,
                                Status.ERR_INVALID_FORMAT,
                                Status.ERR_EOF):
                raise e     # operational errors stay session-fatal
            status = e.status.name
        else:               # OSError: the RHS file itself (open/read)
            status = Status.ERR_INVALID_VALUE.name
        print(json.dumps({"request": None, "ok": False,
                          "status": status, "line": lineno,
                          "error": str(e)}), flush=True)
        return 1

    nfailed = 0
    fh = sys.stdin if args.serve == "-" else open(args.serve)
    try:
        for lineno, raw in enumerate(fh, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            tok = line.split()
            cmd = tok[0].lower()
            if cmd in ("quit", "exit"):
                break
            if cmd == "stats":
                print(json.dumps(svc.stats(), default=str), flush=True)
            elif cmd == "health":
                print(json.dumps(svc.health(), default=str), flush=True)
            elif cmd == "metrics":
                from acg_torch.obs.metrics import registry
                if len(tok) > 1 and tok[1].lower() == "prom":
                    sys.stdout.write(registry().prometheus_text())
                    sys.stdout.flush()
                else:
                    print(json.dumps(registry().snapshot()), flush=True)
            elif cmd == "flightrec":
                print(json.dumps(svc.flightrec.dump()), flush=True)
            elif cmd == "flush":
                svc.flush()
            elif cmd == "solve":
                try:
                    rhs = _read_rhs(tok[1]) if len(tok) > 1 else b
                    resp = _emit(svc.solve(rhs))
                    nfailed += 0 if resp.ok else 1
                except (OSError, AcgError) as e:
                    nfailed += _emit_rejected(e, lineno)
            elif cmd == "batch":
                if len(tok) < 2 or not tok[1].isdigit():
                    raise AcgError(Status.ERR_INVALID_VALUE,
                                   f"--serve line {lineno}: batch needs "
                                   "a request count ('batch K [B.mtx]')")
                try:
                    rhs = _read_rhs(tok[2]) if len(tok) > 2 else b
                    reqs = [svc.submit(rhs)
                            for _ in range(int(tok[1]))]
                except (OSError, AcgError) as e:
                    nfailed += _emit_rejected(e, lineno)
                    continue
                for req in reqs:
                    resp = _emit(req.response())
                    nfailed += 0 if resp.ok else 1
            else:
                raise AcgError(Status.ERR_INVALID_VALUE,
                               f"--serve line {lineno}: unknown command "
                               f"{cmd!r} (solve|batch|stats|health|"
                               "metrics|flightrec|flush|quit)")
    finally:
        if fh is not sys.stdin:
            fh.close()
        svc.close()
        session.close()
    if args.trace_json:
        # host phase spans and every recorded request timeline, one
        # timebase
        from acg_torch.obs.events import write_chrome_trace
        write_chrome_trace(args.trace_json, tracer=tracer,
                           recorder=svc.flightrec)
        _log(args, f"chrome trace written to {args.trace_json!r}")
    _log(args, f"serve: {svc.stats()['queue']['submitted']} request(s), "
               f"{nfailed} failed")
    if args.output_stats_json and last["audit"] is not None:
        # the audit document of the last completed request
        from acg_torch.obs.export import write_stats_json
        write_stats_json(args.output_stats_json, last["audit"])
        _log(args, f"stats document written to "
                   f"{args.output_stats_json!r}")
    return 1 if nfailed else 0


def main(argv=None) -> int:
    from acg_torch.errors import run_main
    return run_main(lambda: _main(argv))


def _main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    # validate --numfmt up front (ref fmtspec_parse, acg/fmtspec.c, called
    # during option parsing cuda/acg-cuda.c:363-366)
    from acg_torch.utils.fmtspec import parse_fmtspec
    try:
        args.numfmt = str(parse_fmtspec(args.numfmt))
    except AcgError as e:
        print(f"error: --numfmt: {e}", file=sys.stderr)
        return 2
    _refuse_unported(args)
    if args.metrics:
        from acg_torch.obs.metrics import enable_metrics
        enable_metrics()
    from acg_torch.obs.trace import SpanTracer
    tracer = SpanTracer(log=lambda m: _log(args, m))
    solver = args.solver
    host = solver == "host" or solver.startswith("petsc")
    sstep_mode = "sstep" in solver
    deep_mode = "deep" in solver
    pipelined = "pipelined" in solver and not (deep_mode or host)
    if args.nparts < 1:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"--nparts must be >= 1, got {args.nparts}")
    if sstep_mode and not 2 <= args.sstep <= 16:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"--sstep {args.sstep}: the s-step block size "
                       "must be in [2, 16]")
    if deep_mode and not 1 <= args.pipeline_depth <= 8:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"--pipeline-depth {args.pipeline_depth}: the "
                       "pipeline depth must be in [1, 8] (depth 1 is the "
                       "ordinary pipelined solver)")
    # -vv turns on the live residual stream (reference verbose mode); an
    # explicit --monitor-every K sets the throttle
    if args.verbose >= 2 and args.monitor_every == 0:
        args.monitor_every = 1
    # the host solvers take A as it is read, on one process
    dist = args.nparts > 1 and not host
    halo = resolve_halo(args.comm, args.halo)
    if dist and halo == "rdma" and (sstep_mode or (
            deep_mode and args.pipeline_depth > 1)):
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       f"--solver {solver} with --nparts {args.nparts} "
                       "takes the ppermute or allgather halo (the rdma "
                       "halo, a put+signal kernel, moves 1-D distance-1 "
                       "packs, not the deep ghost exchange)")
    if dist and halo == "rdma" and args.halo_wire != "f32":
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "--halo-wire compresses the ppermute/allgather "
                       "messages; the rdma halo is a put+signal kernel "
                       "that writes raw vector words (use --halo "
                       "ppermute or allgather)")
    if dist and halo == "rdma" and args.nrhs > 1:
        raise AcgError(Status.ERR_NOT_SUPPORTED,
                       "--nrhs > 1 with --nparts > 1 takes the ppermute or "
                       "allgather halo (the rdma halo moves 1-D packs)")
    if args.residual_replacement and not (pipelined or deep_mode):
        print("warning: --residual-replacement applies to pipelined "
              "solvers only (--solver acg-pipelined); ignored",
              file=sys.stderr)
    if args.check_every != 1 and sstep_mode:
        print("warning: --check-every has no effect on the s-step loop "
              "(convergence is decided at every block boundary); ignored",
              file=sys.stderr)
    if args.per_op_stats and host:
        print("warning: --per-op-stats times the device op classes and "
              f"applies to the acg* solvers only (--solver {solver} builds "
              "no device operator); ignored", file=sys.stderr)
        args.per_op_stats = False
    if args.explain and host:
        print("warning: --explain audits the device loop and applies to "
              f"the acg* solvers only (--solver {solver} runs on the "
              "host); ignored", file=sys.stderr)
        args.explain = False
    if args.per_op_stats and sstep_mode:
        print("warning: --per-op-stats has no per-op model for the s-step "
              "block structure yet; ignored", file=sys.stderr)
        args.per_op_stats = False
    if args.cusparse_spmv_alg is not None:
        print(f"note: --cusparse-spmv-alg {args.cusparse_spmv_alg} is a "
              "cuSPARSE selector; the port's SpMV kernels are its own, "
              f"chosen by --format (currently '{args.format}')",
              file=sys.stderr)
    from acg_torch.utils.backend import resolve_device
    device = None if host else resolve_device(args.device)
    vdt = np.dtype(args.dtype)

    # 1. read A (ref cuda/acg-cuda.c:1296-1331)
    _log(args, f"reading matrix {args.A!r}")
    t0 = time.perf_counter()
    with tracer.span("read"):
        m = read_mtx(args.A, binary=args.binary or None)
        A = csr_from_mtx(m, val_dtype=vdt,
                         idx_dtype=np.int64 if args.idx_size == 64
                         else np.int32)
        if args.epsilon:
            A = A.shift_diagonal(args.epsilon)
    _log(args, f"matrix: {A.nrows} rows, {A.nnz} nonzeros "
               f"({time.perf_counter() - t0:.3f} s)")

    # 2. right-hand side: file / manufactured / ones
    xstar = None
    if args.manufactured_solution:
        xstar, b = manufactured_rhs(A, seed=args.seed)
        _log(args, "using manufactured solution")
    elif args.b:
        b = read_mtx(args.b, binary=args.binary or None).vals.astype(vdt)
        if b.shape[0] != A.nrows:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"right-hand side has {b.shape[0]} "
                           f"entries, matrix has {A.nrows} rows")
    else:
        b = np.ones(A.nrows, dtype=vdt)
    x0 = None
    if args.x0:
        x0 = read_mtx(args.x0, binary=args.binary or None).vals.astype(vdt)
        if x0.shape[0] != A.nrows:
            raise AcgError(Status.ERR_INVALID_VALUE,
                           f"initial guess has {x0.shape[0]} entries, "
                           f"matrix has {A.nrows} rows")
    if args.nrhs < 1:
        raise AcgError(Status.ERR_INVALID_VALUE,
                       f"--nrhs must be >= 1, got {args.nrhs}")
    if args.nrhs > 1:
        if host:
            raise AcgError(Status.ERR_NOT_SUPPORTED,
                           f"--nrhs > 1 requires a device solver "
                           f"(--solver {solver} solves one system at a "
                           "time)")
        # the (K, n) batch; K = 1 stays on the 1-D path, and x0 stays 1-D
        # (the solvers share one guess across the batch)
        b = np.tile(np.asarray(b)[None, :], (args.nrhs, 1))
    # with --profile no warmup solve runs (as in the JAX program): a
    # warmup that failed would end the run before the trace opened, and
    # the options block must say how many ran
    nwarmup = 0 if host or args.profile else args.warmup
    options = SolverOptions(
        maxits=args.max_iterations, diffatol=args.diff_atol,
        diffrtol=args.diff_rtol, residual_atol=args.residual_atol,
        residual_rtol=args.residual_rtol,
        warmup=nwarmup, check_every=args.check_every,
        replace_every=(args.residual_replacement
                       if pipelined or deep_mode else 0),
        sstep=args.sstep if sstep_mode else 0,
        pipeline_depth=args.pipeline_depth if deep_mode else 1,
        halo_wire=args.halo_wire, monitor_every=args.monitor_every)
    mat_dtype = {"auto": "auto", "same": None}.get(
        args.mat_precision, args.mat_precision)
    if args.serve is not None:
        # serve mode: the session REPL takes the prepared inputs; the rest
        # of this program is the one-shot pipeline
        return _serve_main(args, tracer, A, b, options, device, halo,
                           mat_dtype)

    # 3. operator build + solve (ref cuda/acg-cuda.c:2209-2261)
    from acg_torch.solvers.cg import (build_device_operator, cg,
                                      cg_pipelined, cg_pipelined_deep,
                                      cg_sstep)
    solve = (cg_sstep if sstep_mode else cg_pipelined_deep if deep_mode
             else cg_pipelined if pipelined else cg)
    skind = ("cg-sstep" if sstep_mode else "cg-pipelined-deep" if deep_mode
             else "cg-pipelined" if pipelined else "cg")
    t0 = time.perf_counter()
    steps = {}
    if host:
        # the host oracle and the SciPy baseline take A as it was read
        from acg_torch.solvers.baseline import cg_scipy
        from acg_torch.solvers.cg_host import cg_host
        dev = A
        what = "host CSR"
        if solver == "host":
            def solve(A, b, x0=None, options=None, fmt=None):
                return cg_host(A, b, x0=x0, options=options)
        else:
            def solve(A, b, x0=None, options=None, fmt=None):
                # --output-stats-json exports the trajectory: record it
                return cg_scipy(A, b, x0=x0, options=options,
                                record_history=(True if args.output_stats_json
                                                else None))
    elif dist:
        from acg_torch.solvers.cg_dist import (build_sharded, cg_dist,
                                               cg_pipelined_deep_dist,
                                               cg_pipelined_dist,
                                               cg_sstep_dist)
        solve = (cg_sstep_dist if sstep_mode
                 else cg_pipelined_deep_dist if deep_mode
                 else cg_pipelined_dist if pipelined else cg_dist)
        part = _read_partition(args, A)
        with tracer.span("operator-build"):
            dev = build_sharded(
                A, nparts=args.nparts, part=part,
                devices=(None if device.type == "cuda"
                         else [device] * args.nparts),
                dtype=vdt, method=halo,
                partition_method=args.partition_method, seed=args.seed,
                mat_dtype=mat_dtype, fmt=args.format, timings=steps)
        what = (f"{args.nparts} shards ({dev.local_fmt}, halo "
                f"{dev.method.value}, {dev.halo.nrounds} rounds, wire "
                f"{args.halo_wire})")
    else:
        with tracer.span("operator-build"):
            dev = build_device_operator(A, dtype=vdt, fmt=args.format,
                                        mat_dtype=mat_dtype, device=device,
                                        timings=steps)
        inner = getattr(dev, "dev", dev)
        what = (type(inner).__name__
                + (" in an RCM ordering" if inner is not dev else ""))
    _log(args, f"operator: {what} on {device or 'the host'} "
               f"({time.perf_counter() - t0:.3f} s"
               + "".join(f"; {k} {v:.3f} s" for k, v in steps.items())
               + ")")
    intro = _explain(args, tracer, dev, skind, options, dist) \
        if args.explain else {}

    def _report(res):
        """What follows a solve, converged or not: the per-op table, the
        stats document, the trace, the printed stats block."""
        if args.per_op_stats and res.stats is not None:
            from acg_torch.utils.profile import profile_dist_ops, profile_ops
            prof = profile_dist_ops if dist else profile_ops
            prof(dev, res.stats, res.niterations,
                 pipelined=pipelined or deep_mode,
                 replace_every=options.replace_every)
        if args.output_stats_json:
            _export_stats(args, tracer, solver, options, res, A.nrows,
                          intro)
        if args.trace_json:
            from acg_torch.obs.events import write_chrome_trace
            write_chrome_trace(args.trace_json, tracer=tracer)
            _log(args, f"chrome trace written to {args.trace_json!r}")
        print(format_solver_stats(res.stats, res, options,
                                  nunknowns=A.nrows, nprocs=args.nparts))

    try:
        from acg_torch.obs.monitor import muted
        if options.warmup:
            with tracer.span("compile/warmup"):
                for _ in range(options.warmup):
                    # a warmup that does not converge still warmed
                    # everything; its monitor lines reach the sinks but
                    # not the printer
                    try:
                        with muted():
                            solve(dev, b, x0=x0, options=options,
                                  fmt=args.format)
                    except AcgError as e:
                        if getattr(e, "result", None) is None:
                            raise
        from acg_torch.ops import (cg_update, deep_coeffs, dia_kernels,
                                   sgell, spmv, sstep_coeffs, stencil)
        from acg_torch.parallel import rdma_halo
        rdma_halo.launches = cg_update.launches = 0
        sstep_coeffs.launches = deep_coeffs.launches = 0
        dia_kernels.launches = stencil.launches = 0
        dia_kernels.pipe_launches = stencil.pipe_launches = 0
        dia_kernels.batched_launches = stencil.batched_launches = 0
        dia_kernels.ring_launches = dia_kernels.windows_launches = 0
        spmv.launches = sgell.launches = 0
        with tracer.span("solve"), _profiled(args, device):
            res = solve(dev, b, x0=x0, options=options, fmt=args.format)
        _log(args, f"kernel launches in the timed solve: dia_spmv "
                   f"{dia_kernels.launches}, stencil_spmv "
                   f"{stencil.launches}, cg_pipelined_iter "
                   f"{dia_kernels.pipe_launches}, cg_pipelined_iter_stencil "
                   f"{stencil.pipe_launches}, dia_spmv_batched "
                   f"{dia_kernels.batched_launches}, stencil_spmv_batched "
                   f"{stencil.batched_launches}, ell_spmv {spmv.launches}, "
                   f"sgell_spmv {sgell.launches}, dia_spmv_ring "
                   f"{dia_kernels.ring_launches}, dia_spmv_windows "
                   f"{dia_kernels.windows_launches}, rdma_exchange "
                   f"{rdma_halo.launches}, cg_update {cg_update.launches}, "
                   f"sstep_coeffs {sstep_coeffs.launches}, deep_coeffs "
                   f"{deep_coeffs.launches}")
        if res.stats is not None and res.loop:
            st = res.stats
            _log(args, f"loop: {res.loop} ({st.ncaptures} graph captures "
                       f"in {st.tcapture:.3f} s, {st.nreplays} replays, "
                       f"{st.nloopopen} blocks launched from the host)")
    except AcgError as e:
        res = getattr(e, "result", None)
        print(f"error: {e}", file=sys.stderr)
        if res is None:
            return 1
        # stats for the failed solve, as the reference prints them
        _report(res)
        return 1

    # 4. stats block (ref acgsolver_fwrite, acg/cg.c:665-828)
    _report(res)

    # 5. manufactured-solution error report (ref cuda/acg-cuda.c:2376-2385)
    x_out = _first_system(res.x)
    if xstar is not None:
        err = float(np.linalg.norm(x_out - xstar))
        err0 = float(np.linalg.norm(xstar if x0 is None else xstar - x0))
        print(f"manufactured solution error: {args.numfmt % err} "
              f"(initial: {args.numfmt % err0})")

    # 6. solution output (ref cuda/acg-cuda.c:2388-2425): Matrix Market
    # vectors are 1-D, so a batch writes its first system
    if res.nrhs > 1 and (args.output_solution or not args.quiet):
        print(f"note: --nrhs {res.nrhs}: writing the first system's "
              "solution", file=sys.stderr)
    if args.output_solution:
        write_mtx(args.output_solution, vector_to_mtx(x_out),
                  numfmt=args.numfmt)
    elif not args.quiet:
        for v in x_out:
            sys.stdout.write((args.numfmt % v) + "\n")
    return 0


def _explain(args, tracer, dev, skind: str, options, dist: bool) -> dict:
    """--explain: the counted CommAudit and the roofline model, printed
    before the solve, and the halo-wire block; the payload the stats
    document embeds ("model" keeps the roofline to price the measured
    rate).  A stage that cannot run warns and leaves its member null."""
    from acg_torch.obs.audit import audit_solver, format_comm_audit
    from acg_torch.obs.roofline import (roofline_for_operator,
                                        roofline_for_sharded)
    from acg_torch.parallel.halo import wire_itemsize

    intro = {"comm_audit": None, "roofline": None, "halo_wire": None,
             "model": None}
    with tracer.span("explain"):
        try:
            audit = audit_solver(dev, solver=skind, nrhs=args.nrhs,
                                 options=options)
            print(format_comm_audit(
                audit, title=f"{args.solver}, nparts={args.nparts}, "
                             f"nrhs={args.nrhs}"))
            intro["comm_audit"] = audit.as_dict()
        except AcgError as e:
            print(f"warning: --explain: the counted audit is unavailable: "
                  f"{e}", file=sys.stderr)
        kw = dict(solver=skind, nrhs=args.nrhs, hbm_gbps=args.hbm_gbps,
                  sstep=options.sstep)
        model = (roofline_for_sharded(dev, halo_wire=options.halo_wire,
                                      **kw) if dist
                 else roofline_for_operator(dev, **kw))
        print(model.report())
        intro["roofline"], intro["model"] = model.as_dict(), model
    vdt = np.dtype(args.dtype)
    wi = wire_itemsize(options.halo_wire, vdt)
    intro["halo_wire"] = {
        "wire": options.halo_wire,
        "dtype": {"bf16": "bfloat16", "int16-delta": "int16"}.get(
            options.halo_wire, vdt.name),
        "itemsize": int(wi),
        "bytes_saved_ratio": 1.0 - wi / vdt.itemsize if dist else None}
    if dist:
        print(f"halo wire: {options.halo_wire} ({wi} B a value, "
              f"{intro['halo_wire']['bytes_saved_ratio']:.0%} off the "
              "identity wire)")
    return intro


def _export_stats(args, tracer, solver, options, res, nunknowns,
                  intro) -> None:
    """--output-stats-json: the stats document of this solve, the
    measured rate priced against the roofline when --explain made one."""
    from acg_torch.obs.export import build_stats_document, write_stats_json
    from acg_torch.obs.metrics import metrics_enabled, registry

    roofline = intro.get("roofline")
    if roofline is not None and res.stats is not None:
        measured = res.stats.iterations_per_sec()
        roofline = dict(roofline, measured_iters_per_sec=measured,
                        roofline_frac=intro["model"].frac(measured))
    doc = build_stats_document(
        solver=solver, options=options, res=res, stats=res.stats,
        nunknowns=nunknowns, nparts=args.nparts, phases=tracer.as_dicts(),
        introspection=dict(intro, roofline=roofline),
        metrics=registry().snapshot() if metrics_enabled() else None)
    write_stats_json(args.output_stats_json, doc)
    _log(args, f"stats document written to {args.output_stats_json!r}")


@contextlib.contextmanager
def _profiled(args, device):
    """--profile DIR: the solve under ``torch.profiler`` (CPU activity,
    and CUDA on the card), its Chrome trace written into DIR.  A CUPTI
    record can be dropped, so the trace gives times and kernel names,
    not counts: the launches are the wrappers' counters."""
    if not args.profile:
        yield
        return
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(args.profile, "acg_torch_solve.trace.json")
    prof.export_chrome_trace(path)
    _log(args, f"profiler trace written to {path!r}")


if __name__ == "__main__":
    sys.exit(main())
