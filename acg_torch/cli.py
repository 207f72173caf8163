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
cpu`` they share the CPU.

Run: ``python -m acg_torch.cli A.mtx --manufactured-solution -v``
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from acg_torch import __version__
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
    p.add_argument("--dtype", default="float64",
                   choices=["float32", "float64"],
                   help="value precision [float64]")
    p.add_argument("--mat-precision", default="auto",
                   choices=["auto", "same", "bfloat16", "float32", "int8"],
                   help="operator STORAGE precision (compute stays at "
                        "--dtype): auto = narrow to bfloat16 only when "
                        "exact; same = store at --dtype; int8 = force the "
                        "exact two-value mask tier; bfloat16/float32 = opt "
                        "into mixed-precision CG [auto]")
    p.add_argument("--manufactured-solution", action="store_true",
                   help="use a manufactured solution and right-hand side")
    p.add_argument("--numfmt", default="%.17g", metavar="FMT",
                   help="printf-style format for numeric output")
    p.add_argument("--output-solution", metavar="FILE", default=None,
                   help="write solution vector to Matrix Market FILE")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to solve [cuda]; cpu runs the plain PyTorch "
                        "versions of the kernels")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress solution output")
    p.add_argument("--version", action="version",
                   version=f"acg-torch {__version__}")
    return p


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


def main(argv=None) -> int:
    from acg_torch.errors import run_main
    return run_main(lambda: _main(argv))


def _main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    try:
        args.numfmt % 1.0
    except (TypeError, ValueError) as e:
        print(f"error: --numfmt: {e}", file=sys.stderr)
        return 2
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
    # -vv turns on the live residual stream of the device solvers
    # (reference verbose mode); an explicit --monitor-every K sets it
    if args.verbose >= 2 and args.monitor_every == 0 and not host:
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
    from acg_torch.utils.backend import resolve_device
    device = None if host else resolve_device(args.device)
    vdt = np.dtype(args.dtype)

    # 1. read A (ref cuda/acg-cuda.c:1296-1331)
    _log(args, f"reading matrix {args.A!r}")
    t0 = time.perf_counter()
    m = read_mtx(args.A, binary=args.binary or None)
    A = csr_from_mtx(m, val_dtype=vdt)
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
    options = SolverOptions(
        maxits=args.max_iterations, diffatol=args.diff_atol,
        diffrtol=args.diff_rtol, residual_atol=args.residual_atol,
        residual_rtol=args.residual_rtol,
        warmup=0 if host else args.warmup, check_every=args.check_every,
        replace_every=(args.residual_replacement
                       if pipelined or deep_mode else 0),
        sstep=args.sstep if sstep_mode else 0,
        pipeline_depth=args.pipeline_depth if deep_mode else 1,
        halo_wire=args.halo_wire, monitor_every=args.monitor_every)
    mat_dtype = {"auto": "auto", "same": None}.get(
        args.mat_precision, args.mat_precision)

    # 3. operator build + solve (ref cuda/acg-cuda.c:2209-2261)
    from acg_torch.solvers.cg import (build_device_operator, cg,
                                      cg_pipelined, cg_pipelined_deep,
                                      cg_sstep)
    solve = (cg_sstep if sstep_mode else cg_pipelined_deep if deep_mode
             else cg_pipelined if pipelined else cg)
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
                return cg_scipy(A, b, x0=x0, options=options)
    elif dist:
        from acg_torch.solvers.cg_dist import (build_sharded, cg_dist,
                                               cg_pipelined_deep_dist,
                                               cg_pipelined_dist,
                                               cg_sstep_dist)
        solve = (cg_sstep_dist if sstep_mode
                 else cg_pipelined_deep_dist if deep_mode
                 else cg_pipelined_dist if pipelined else cg_dist)
        part = None
        if args.partition:
            # the pinned part vector is honoured exactly: partitioning
            # again would change the halo and the tiers under the user
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
        dev = build_sharded(
            A, nparts=args.nparts, part=part,
            devices=None if device.type == "cuda" else [device] * args.nparts,
            dtype=vdt, method=halo,
            partition_method=args.partition_method, seed=args.seed,
            mat_dtype=mat_dtype, fmt=args.format, timings=steps)
        what = (f"{args.nparts} shards ({dev.local_fmt}, halo "
                f"{dev.method.value}, {dev.halo.nrounds} rounds, wire "
                f"{args.halo_wire})")
    else:
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
    try:
        from acg_torch.obs.monitor import muted
        for _ in range(options.warmup):
            # a warmup that does not converge still warmed everything;
            # its monitor lines reach the sinks but not the printer
            try:
                with muted():
                    solve(dev, b, x0=x0, options=options, fmt=args.format)
            except AcgError as e:
                if getattr(e, "result", None) is None:
                    raise
        from acg_torch.ops import (cg_update, dia_kernels, sgell, spmv,
                                   stencil)
        from acg_torch.parallel import rdma_halo
        rdma_halo.launches = cg_update.launches = 0
        dia_kernels.launches = stencil.launches = 0
        dia_kernels.pipe_launches = stencil.pipe_launches = 0
        dia_kernels.batched_launches = stencil.batched_launches = 0
        dia_kernels.ring_launches = dia_kernels.windows_launches = 0
        spmv.launches = sgell.launches = 0
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
                   f"{rdma_halo.launches}, cg_update {cg_update.launches}")
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
        print(format_solver_stats(res.stats, res, options,
                                  nunknowns=A.nrows,
                                  nprocs=args.nparts))
        return 1

    # 4. stats block (ref acgsolver_fwrite, acg/cg.c:665-828)
    print(format_solver_stats(res.stats, res, options, nunknowns=A.nrows,
                                  nprocs=args.nparts))

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


if __name__ == "__main__":
    sys.exit(main())
