#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``acg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card; every phase
    python3 chip_smoke.py --only sstep-stencil,deep-stencil
                                     # those phases, the build and the
                                     # phases they are held against; no
                                     # kernel line

Phases, each printing one JSON line with its wall time; any failure
raises and the script exits non-zero:

1. build      compile every kernel in acg_torch/csrc with nvcc (sm_90a),
              one process per source, all at once;
   fem3d-1m   set-up of the unstructured configuration: a shuffled
              1,000,000-point 3-D Delaunay mesh (fem_delaunay_spd, seed 0)
              and its operators through build_device_operator(fmt="auto"),
              built once for every later phase (f32: RCM + sgell; f64:
              ELL), with the host seconds of mesh generation, RCM,
              permutation, pack / ELL build, upload and slice (the
              sliced layout the kernels read, cut on the card), and
              what each layout streams against the stored entries;
   p3d-464    set-up of the north star: 7-point Poisson on 464^3
              (99,897,344 unknowns) in band form through fmt="dia" (bf16
              bands, f32 vectors), planned past the card's L2 onto the
              clustered-window kernel;
   p2d-10k    set-up of the 5-point 2-D Poisson on 10,000^2 (10^8
              unknowns) built directly in band form, fmt="dia", planned
              onto the ring kernel (the windows on a plan made for it);
   dist-setup set-up of the distributed cell: 256^3 f64 Poisson as a
              host CSR, partition_graph into 4 grid blocks,
              partition_system, build_sharded onto ["cuda:0"] * 4 (the
              stencil a shard, the border-row interface ELL, the
              put+signal halo state) and the same shards as bf16 DIA
              bands at f32, host seconds of every step;
2. kernels    at the solve's shapes, each kernel in every tier, held
              against its plain PyTorch version on the card (stated
              tolerances), its outputs and dots checked bit-identical
              across two runs, and timed with CUDA events beside its
              memory bound, the plain version and one PyTorch library
              call computing the same function: the SpMV kernels with and
              without the fused dot; the pipelined-iteration kernels
              with their padding rows checked exactly zero and beside the
              open-coded body (SpMV kernel, torch updates and dots),
              as no single library call computes a pipelined iteration,
              timed one call and queued (ms_queued); each DIA one names
              the kernel the plan took (pipe_fixed) and holds the fixed
              and the generic kernel, forced on the same inputs, bit for
              bit (six vectors, gamma, delta: bits_equal_generic);
              every stencil_spmv row names the kernel the plan routes
              it to (route: fixed-5, fixed-7, fixed-27 or generic) and
              holds y and the dot bit for bit against the generic
              kernel forced on the same x (bits_equal_generic), and the
              fixed kernel's other arm counts run on the 27-point
              operator on 128^3 and the 2-D 5-point on 4096^2 (f32 and
              f64, beside conv3d / conv2d);
              sgell_spmv and ell_spmv on the sliced layouts of the
              fem3d-1m operators (ELL also at f32, and at f32 on the RCM
              ordering sgell runs on) and, with bf16 values, of a randomly
              permuted 64^3 Poisson operator, sgell bit for bit against
              sgell_matvec on the pack, ELL against ell_matvec on the
              rectangle and bit for bit against sliced_matvec, each beside
              cuSPARSE CSR x on the same matrix in the same ordering and
              a bound counting the stored entries; the HBM tier:
              dia_spmv_windows at 256^3 (bf16/f32, int8/f32, f64/f64),
              464^3 (bf16 bands, f32 and f64 vectors) and 10,000^2
              (bf16/f32), dia_spmv_ring on 10,000^2 (bf16/f32, f64/f64;
              a kernel on a plan made for it where the operator's plan
              takes another is marked planned: false), each with y
              bit-equal to dia_spmv and timed beside dia_spmv and
              cuSPARSE CSR x on the same operator, dia_spmv with the
              dot on the 464^3 operator in a row of its own, and
              dia_spmv at bench.py's 128^3 (its resident path); the
              distributed path's kernels at its shapes: stencil_spmv on
              a 256x128x128 shard, ell_spmv on a shard's interface
              operator (border rows x ghost slots), dia_spmv on a shard's
              bf16 bands, and the put+signal kernel on the 4-shard
              tables at GPU scope (rdma_exchange bit for bit against its
              plain version, the fused halo's ghosts bit for bit against
              its plain version, halo_ppermute and halo_allgather; one
              call and 25 queued, beside one Tensor.copy_ per slot, the
              three whole halos and the fused halo's bound); the ring's
              and windows' rows name their depth (row tiles in flight);
3. stencil    classic CG, 256^3 Poisson, f64, fmt="auto" (the matrix-free
              tier), manufactured solution, rtol 1e-8, true residual
              recomputed here with the stencil kernel;
4. dia-bf16   256^3 Poisson, f32 vectors, bf16 bands, fmt="dia",
              fixed-iteration timing (bench.py's protocol): x (67 MB)
              is past the card's L2, so the loop and the eager matvecs
              run the windows kernel (cuda-dia-hbm); dia-bf16-128 is the
              same at 128^3 (x 8.4 MB), where dia_spmv runs
              (cuda-dia-fused);
5. dia-f64    variable-coefficient 128^3 operator, f64, fmt="auto" (full
              width f64 bands), rtol 1e-8, true residual recomputed;
6-9.          the same three solves through pipelined CG (phases
              pipelined-stencil, pipelined-dia-bf16, pipelined-dia-f64),
              and pipelined-replace: the 256^3 stencil solve with
              replace_every=50, which runs the open-coded body;
10. cli       ``python -m acg_torch.cli`` on a 48^3 Poisson .mtx, then
              again with ``--solver acg-pipelined`` (cli-pipelined);
11. batched   the multi-RHS path, B = 8 systems against one operator:
              batched-stencil (classic CG, 256^3 Poisson f64, 8
              manufactured solutions, rtol 1e-8, per-system counts held
              equal to 8 one-system solves run here, true residuals
              recomputed), batched-dia-bf16 (1000 fixed iterations),
              batched-dia-f64 (varcoef 128^3), batched-pipelined-stencil
              (cg_pipelined, counts within 1 of classic's), and cli-nrhs
              (the CLI with --nrhs 4); the kernels phase holds both
              batched kernels in every tier against their plain versions
              and, system by system, bit for bit against the one-system
              kernels (B = 8 and B = 1; the DIA kernel also at B = 16,
              two launches), and times them beside B calls of the
              one-system kernel; the build phase lists the registers of
              every instantiation of the two kernels;
11b. solver families
              sstep-stencil (cg_sstep, s = 4, on the stencil phase's
              system, rtol 1e-8: no fallback, within s + 2 iterations of
              classic, certified in float64 on the host within 10 x
              rtol, stencil_spmv without the dot 2s times a block + 8,
              µs per iteration and per block), sstep-batched-stencil (the
              batched phases' 8 systems through stencil_spmv_batched,
              per-system counts within s + 2 of batched-stencil's, every
              system certified), sstep-dia-bf16 (256^3 bf16 bands, f32
              vectors, the windows kernel without the dot, which the
              kernels phase also holds and times, rtol 1e-4; a fallback
              to classic CG is allowed and printed), deep-stencil
              (cg_pipelined_deep, depth 2, replace_every 50, rtol 1e-8:
              dispatches, iterations beside pipelined-stencil's, the SpMV
              launches as the dispatch protocol gives them),
              recycled-stencil (cg_recycled with the 8 lowest Dirichlet
              eigenvectors of the Laplacian in closed form and W'AW
              through the port's operator: fewer iterations than classic,
              the deflation's host seconds), cli-sstep, cli-deep,
              cli-host, cli-petsc (the CLI's --solver acg-sstep --sstep
              4, acg-pipelined-deep --pipeline-depth 2
              --residual-replacement 50, host and petsc on the 48^3
              .mtx);
12. unstructured
              fem-sgell (classic CG, f32, rtol 1e-6: rcm+sgell) and
              fem-ell (f64, rtol 1e-8: ell) on fem3d-1m from a
              manufactured solution, the true residual recomputed in the
              caller's ordering from the host CSR in float64; the same
              two through cg_pipelined (pipelined-fem-*); rcm-dia (a
              scrambled 1,000,000-row tridiagonal, f64, classic and
              pipelined: rcm+dia); batched-fem-sgell (B = 4 manufactured
              solutions, counts equal to the one-system solves run
              there); cli-fem (the CLI on a 50,000-point mesh .mtx at f32
              and f64);
13. the 100M-DOF path
              dia-100m: classic CG on the 464^3 operator from b = A x*
              (x* = default_rng(464) normal), rtol 1e-4, maxits 1500
              (scripts/check_100m_convergence.py): cuda-dia-hbm, the
              windows kernel once per SpMV, the true residual certified
              in float64 with the plain dia_matvec on the card (< 3e-4),
              us/iter beside the iteration's bound; dia-100m-f64: the
              same bf16 bands with f64 vectors to rtol 1e-8 (< 1e-7);
              p2d and p2d-windows: 200 fixed iterations on 10,000^2
              through its planned ring kernel (cuda-dia-hbm-ring) and
              through the windows kernel on a plan made for it
              (cuda-dia-hbm), the true residual held to the
              recurrence's within f32 rounding drift; every DIA phase
              prints the plan it took (kernel, tile, grid, shared
              memory, ring depth);
14. distributed
              cg_dist with 4 shards on the one card: dist-stencil,
              dist-stencil-allgather, dist-stencil-rdma (the stencil
              phase's solve: its count within 1, certified through the
              distributed operator within 10 x rtol, the same bits
              from the three halos, rdma_exchange once per exchange and
              only under rdma; on two or more cards the same shards
              spread over them), dist-dia-bf16 (1000 fixed iterations
              on the bf16 DIA shards), dist-fem (fem3d-1m in 4 rb
              parts: rcm+sgell at f32, ELL at f64, certified from the
              host CSR); cg_pipelined_dist on the same shards:
              dist-pipelined-stencil, -allgather, -rdma (the per-shard
              single-kernel iteration with the interface folded in,
              cuda-stencil-pipe+<halo>: its count within 1 of
              pipelined-stencil's, certified within 10 x rtol, the same
              bits from the three halos, the pipe kernel once a shard an
              iteration), dist-pipelined-dia-bf16 (1000 fixed iterations
              on the bf16 DIA shards, cg_pipelined_iter once a shard an
              iteration, the true residual in an f32 drift window of the
              classic dist-dia-bf16's); (B, n) solves, B = 4, the first
              four of the batched phases' systems: dist-batched-stencil
              (classic, ppermute) and dist-batched-pipelined-stencil
              (allgather), per-system counts within 1 of the
              single-device batched phases', every system certified,
              stencil_spmv_batched once a shard per SpMV and the halo
              once per SpMV for all 4 systems;
              dist-wire (the bf16 DIA shards through ppermute under the
              bf16 and int16-delta wires, classic and pipelined with
              replace_every=10, certified below 1e-2 and 1e-3, pipelined
              under bf16 certified or reported not converged; the
              ghosts of both halos under each wire bit-equal to the same
              exchange on the CPU; each wire's message bytes);
              dist-sstep-stencil (cg_sstep_dist, s = 4, ppermute, rtol
              1e-8: no fallback, within s + 2 iterations of
              dist-stencil's, certified within 10 x rtol, one deep
              exchange and one Gram sum a block, stencil_spmv without
              the dot and ell_spmv on the deep interface and skin 2s
              times a block a shard, the first block's basis bit-equal
              under allgather, the deep layer's host seconds) and
              dist-deep-stencil (cg_pipelined_deep_dist, depth 2,
              replace_every 50: within 1 iteration of deep-stencil's,
              one depth-2 exchange a dispatch, certified); the kernels
              phase also holds the pipelined-iteration kernels on a
              shard, the multi-RHS kernels on a shard at B = 8,
              stencil_spmv on a shard without the dot and ell_spmv on a
              shard's deep interface and skin at depths 4 and 2 against
              their plain versions;
    graph-loop the device-resident loop against the open loop: each
              case solved with loop="open" and loop="graph" and held bit
              for bit (x, counts, flags, histories, launch counters), with
              µs/iter both ways, the captures and their host seconds: the
              classic and pipelined cases, and the s-step and deep ones,
              whose coefficient work is one kernel a block / body
              (sstep_coeffs, deep_coeffs; the kernels phase holds both
              against their plain versions on the card): sstep-stencil,
              sstep-batched-stencil (60 fixed iterations), deep-stencil,
              dist-sstep-stencil and dist-deep-stencil at full size;
    introspection
              the measuring surface (acg_torch/obs/, utils/profile.py) on
              the earlier phases' operators and results: each of stencil,
              pipelined-stencil, dia-bf16, dia-100m, batched-stencil,
              fem-sgell, fem-ell, sstep-stencil and dist-stencil-rdma
              priced by the roofline model (0 < roofline_frac <= 1); the
              model's memory rate beside the card's measured copy_ of
              1 GiB; profile_ops on the 256^3 f64 stencil operator (its
              gemv within 25% of the kernels phase's stencil_spmv row)
              and profile_dist_ops on the rdma shards; the counted
              CommAudit of classic stencil (0 halos, 0 reductions, one
              stencil_spmv and one cg_update an iteration) and of the
              rdma shards (1 exchange and 2 reduction points an
              iteration, one stencil_spmv and cg_update a shard); the
              CLI in-process on the 48^3 .mtx with --explain,
              --per-op-stats, --hbm-gbps, --output-stats-json,
              --trace-json and --profile (the document valid, the trace's
              read / operator-build / solve spans, the profiler trace
              naming the stencil kernel); the latency bound of a launch:
              an empty kernel captured in a CUDA graph, replayed queued,
              beside sstep_coeffs and deep_coeffs;
15. profile   for the operators of phases 3, 4, 6, batched-stencil,
              sstep-stencil, deep-stencil, fem-sgell, fem-ell, dia-100m,
              dist-stencil-rdma, dist-pipelined-stencil-rdma and
              dist-sstep-stencil (each in the solver's default loop, the
              graph loop on one card): 50
              iterations under torch.profiler (device time by kernel,
              device idle share of the solve's wall time, kernels per
              iteration), and µs/iter with the host reading the loop flag
              every iteration vs every 16, all with a tolerance that is
              never met (rtol 1e-30), so the loops test for an exit as a
              solve to a tolerance does.

Every kernel wrapper counts its launches; each solve phase zeroes the
counts just before the solve and reads them just after; the CLI logs the
counts of its timed solve at -v.  The line before the last lists each
kernel, once per tier a solve runs it in, with that solve's launches and
the tier's times; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent

# data-sheet peaks: memory bytes/s, f32 and f64 non-tensor-core flop/s
_PEAKS = {
    "H100 SXM": (3.35e12, 67e12, 34e12),
    "H100 PCIe": (2.0e12, 51e12, 26e12),
    "H100 NVL": (3.9e12, 60e12, 30e12),
    "H200": (4.8e12, 67e12, 34e12),
}


def _peaks(name: str):
    """(part, peaks) of the data sheet matching the card's name."""
    if "H200" in name:
        part = "H200"
    elif "H100" in name:
        part = ("H100 PCIe" if "PCIe" in name else
                "H100 NVL" if "NVL" in name else "H100 SXM")
    else:
        raise SystemExit(f"error: no data-sheet peaks for GPU {name!r}")
    return part, _PEAKS[part]


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


_PHASE_SECONDS: dict = {}


def _phase(name: str, fn):
    t0 = time.perf_counter()
    info = fn()
    dt = round(time.perf_counter() - t0, 3)
    _PHASE_SECONDS[name] = dt
    _emit({"phase": name, "seconds": dt, **info})
    return info


def _mesh_job(points: int):
    """fem3d-1m's mesh in a worker process: (the host CSR, its seconds).
    Generating it is host-bound (the Delaunay triangulation of a million
    points), so the run starts it first and overlaps it with the card's
    set-up phases."""
    from acg_torch.sparse.mesh import fem_delaunay_spd

    t0 = time.perf_counter()
    A = fem_delaunay_spd(points, dim=3, seed=0, shuffle=True)
    return A, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--only", default="", metavar="PHASE[,PHASE...]",
                    help="run only these phases, with the build and the "
                         "phases they read or are held against, and print "
                         "no kernel line")
    args = ap.parse_args(argv)
    # Poisson edge, varcoef edge, CLI edge, timed reps, bench iterations,
    # right-hand sides of the batched phases
    grid, var_grid, cli_grid, reps, bench_iters = 256, 128, 48, 25, 1000
    nrhs = 8
    # the HBM tier: bench.py's resident DIA edge, the 100M-DOF north star
    # (464^3 = 99,897,344 unknowns), the 2-D ring edge (10^8 unknowns),
    # fixed iterations of the 2-D run
    bench_grid, big_grid, p2d_edge, p2d_iters = 128, 464, 10_000, 200
    # the unstructured configuration fem3d-1m (3-D Delaunay mesh points),
    # the CLI's mesh, the scrambled tridiagonal's rows, the batched
    # right-hand sides on the sgell tier
    fem_points, cli_fem_points, tridiag_rows, fem_nrhs = (
        1_000_000, 50_000, 1_000_000, 4)
    # the distributed path: shards of the 256^3 cell on the one card, and
    # the systems of its batched phases (the first 4 of the batched
    # phases' 8: B = 8 took 38 s of the run's time budget there), the
    # width the kernels phase holds the shards' multi-RHS kernels at
    nparts, dist_nrhs = 4, 4

    # (name, run, the earlier phases whose results it reads or is held
    # against)
    phases = [
        ("p3d-464", lambda: _p3d_big_setup(big_grid, ctx), ()),
        ("p2d-10k", lambda: _p2d_setup(p2d_edge, ctx), ()),
        ("dist-setup", lambda: _dist_setup(grid, nparts, ctx), ()),
        # its mesh is made in a worker started with the run, meanwhile
        ("fem3d-1m", lambda: _fem_setup(fem_points, ctx), ()),
        ("kernels", lambda: _kernels_phase(grid, nrhs, dist_nrhs, ctx),
         ("fem3d-1m", "p3d-464", "p2d-10k", "dist-setup")),
        ("stencil", lambda: _stencil_solve(grid, ctx), ()),
        ("dia-bf16-128",
         lambda: _dia_bf16_solve(bench_grid, bench_iters, ctx), ()),
        ("dia-bf16", lambda: _dia_bf16_solve(grid, bench_iters, ctx), ()),
        ("dia-f64", lambda: _dia_f64_solve(var_grid, ctx), ()),
        ("pipelined-stencil", lambda: _stencil_solve(grid, ctx, True),
         ("stencil",)),
        ("pipelined-dia-bf16",
         lambda: _dia_bf16_solve(grid, bench_iters, ctx, True), ()),
        ("pipelined-dia-f64", lambda: _dia_f64_solve(var_grid, ctx, True),
         ()),
        ("pipelined-replace", lambda: _replace_solve(grid, ctx),
         ("stencil",)),
        ("cli", lambda: _cli_phase(cli_grid), ()),
        ("cli-pipelined", lambda: _cli_phase(cli_grid, "acg-pipelined"),
         ()),
        ("batched-stencil", lambda: _batched_stencil(grid, nrhs, ctx),
         ("stencil",)),
        ("batched-dia-bf16",
         lambda: _dia_bf16_solve(grid, bench_iters, ctx, nrhs=nrhs),
         ("dia-bf16",)),
        ("batched-dia-f64", lambda: _dia_f64_solve(var_grid, ctx,
                                                   nrhs=nrhs),
         ("dia-f64",)),
        ("batched-pipelined-stencil",
         lambda: _batched_stencil(grid, nrhs, ctx, pipelined=True),
         ("pipelined-stencil", "batched-stencil")),
        ("cli-nrhs", lambda: _cli_phase(cli_grid, nrhs=4), ()),
        ("sstep-stencil", lambda: _sstep_solve(ctx, "sstep-stencil"),
         ("stencil",)),
        ("sstep-batched-stencil",
         lambda: _sstep_solve(ctx, "sstep-batched-stencil"),
         ("batched-stencil",)),
        ("sstep-dia-bf16", lambda: _sstep_dia_bf16(grid, ctx), ()),
        ("deep-stencil", lambda: _deep_stencil(ctx),
         ("stencil", "pipelined-stencil")),
        ("recycled-stencil", lambda: _recycled_stencil(ctx), ("stencil",)),
        ("cli-sstep", lambda: _cli_solver_phase(cli_grid, "acg-sstep",
                                                "--sstep", "4"), ()),
        ("cli-deep", lambda: _cli_solver_phase(
            cli_grid, "acg-pipelined-deep", "--pipeline-depth", "2",
            "--residual-replacement", str(_DEEP["replace_every"])), ()),
        ("cli-host", lambda: _cli_solver_phase(cli_grid, "host"), ()),
        ("cli-petsc", lambda: _cli_solver_phase(cli_grid, "petsc"), ()),
        ("fem-sgell", lambda: _fem_solve(ctx, "sgell"), ("fem3d-1m",)),
        ("fem-ell", lambda: _fem_solve(ctx, "ell"), ("fem3d-1m",)),
        ("pipelined-fem-sgell", lambda: _fem_solve(ctx, "sgell", True),
         ("fem-sgell",)),
        ("pipelined-fem-ell", lambda: _fem_solve(ctx, "ell", True),
         ("fem-ell",)),
        ("rcm-dia", lambda: _rcm_dia_phase(tridiag_rows, ctx), ()),
        ("batched-fem-sgell", lambda: _batched_fem(fem_nrhs, ctx),
         ("fem-sgell",)),
        ("cli-fem", lambda: _cli_fem_phase(cli_fem_points), ()),
    ]
    for method in ("ppermute", "allgather", "rdma"):
        phases.append((_dist_name("dist-stencil", method),
                       lambda m=method: _dist_stencil_solve(ctx, m),
                       ("dist-setup", "stencil")))
    phases += [
        ("dist-dia-bf16", lambda: _dist_dia_solve(bench_iters, ctx),
         ("dist-setup", "dia-bf16")),
        ("dist-fem", lambda: _dist_fem_phase(nparts, ctx),
         ("fem-sgell", "fem-ell")),
    ]
    for method in ("ppermute", "allgather", "rdma"):
        phases.append((_dist_name("dist-pipelined-stencil", method),
                       lambda m=method: _dist_pipelined_stencil(ctx, m),
                       ("pipelined-stencil",
                        _dist_name("dist-stencil", method))))
    phases += [
        ("dist-pipelined-dia-bf16",
         lambda: _dist_pipelined_dia(bench_iters, ctx),
         ("dist-dia-bf16", "pipelined-dia-bf16")),
        ("dist-batched-stencil",
         lambda: _dist_batched_stencil(dist_nrhs, ctx),
         ("dist-setup", "batched-stencil")),
        ("dist-batched-pipelined-stencil",
         lambda: _dist_batched_stencil(dist_nrhs, ctx, pipelined=True),
         ("dist-setup", "batched-pipelined-stencil")),
        ("dist-wire", lambda: _dist_wire_phase(ctx), ("dist-setup",)),
        ("dist-sstep-stencil", lambda: _dist_sstep_stencil(ctx),
         ("dist-setup", "stencil", "dist-stencil")),
        ("dist-deep-stencil", lambda: _dist_deep_stencil(ctx),
         ("dist-setup", "stencil", "pipelined-stencil", "deep-stencil",
          "dist-stencil")),
        ("dia-100m", lambda: _dia_100m_solve(ctx, "float32"),
         ("p3d-464",)),
        ("dia-100m-f64", lambda: _dia_100m_solve(ctx, "float64"),
         ("dia-100m",)),
        ("p2d", lambda: _p2d_solve(p2d_iters, ctx, windows=False),
         ("p2d-10k",)),
        ("p2d-windows", lambda: _p2d_solve(p2d_iters, ctx, windows=True),
         ("p2d-10k",)),
        ("graph-loop", lambda: _graph_phase(ctx),
         ("stencil", "pipelined-dia-bf16", "batched-stencil",
          "dist-setup")),
        ("serve", lambda: _serve_phase(ctx), ("dist-setup", "stencil")),
        ("cli-serve", lambda: _cli_serve_phase(cli_grid), ()),
        ("introspection", lambda: _introspection_phase(cli_grid, ctx),
         ("kernels", "stencil", "pipelined-stencil", "dia-bf16",
          "dia-100m", "batched-stencil", "fem-sgell", "fem-ell",
          "sstep-stencil", "dist-stencil-rdma")),
        ("profile", lambda: _profile_phase(ctx), ()),
    ]
    run = _selected(phases, args.only)

    import torch

    ctx = _context(reps)
    if ctx is None:
        return 2

    pool = None
    if "fem3d-1m" in run:
        # the mesh is host work with no card in it: a worker process
        # makes it while the card's set-up phases run
        import multiprocessing

        pool = multiprocessing.get_context("spawn").Pool(1)
        ctx["fem_mesh"] = pool.apply_async(_mesh_job, (fem_points,))
    try:
        _phase("build", _build_phase)
        for name, fn, _needs in phases:
            if name in run:
                _phase(name, fn)
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    _emit({"phase_seconds": _PHASE_SECONDS,
           "phases_total_seconds": round(sum(_PHASE_SECONDS.values()), 3)})
    if args.only:
        # a partial run: no kernel line, since not every kernel was driven
        _emit({"ok": True, "only": [p[0] for p in phases if p[0] in run]})
        return 0
    lines = _kernel_lines(ctx)
    idle = [k["name"] for k in lines if k["launches"] <= 0]
    if idle:
        raise SystemExit(f"error: the main path never launched {idle}")
    _emit({"gap_ranking_ms": _gap_ranking(lines)})
    _emit({"kernels": lines})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


def _dist_name(base: str, method: str) -> str:
    return base if method == "ppermute" else f"{base}-{method}"


def _selected(phases, only: str) -> set:
    """The names of the phases to run: every phase, or those ``only``
    names (comma-separated) with the phases they need, transitively."""
    names = [p[0] for p in phases]
    for i, (name, _fn, needs) in enumerate(phases):
        late = sorted(set(needs) - set(names[:i]))
        if late:
            raise SystemExit(f"error: phase {name} needs {late}, which do "
                             f"not run before it")
    if not only:
        return set(names)
    run = set(only.split(","))
    unknown = sorted(run - set(names))
    if unknown:
        raise SystemExit(f"error: unknown phases {unknown}; the phases are "
                         f"{names}")
    # a phase needs only earlier phases, so one pass from the end closes
    for name, _fn, needs in reversed(phases):
        if name in run:
            run.update(needs)
    return run


def _context(reps: int):
    """The card's name, power limit and data-sheet peaks, printed, and the
    context every phase reads and fills; None (after an error on stderr)
    without a CUDA device or without the acg_torch package beside this
    script."""
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return None
    if not (REPO / "acg_torch" / "__init__.py").is_file():
        print(f"error: the acg_torch package is not beside {__file__}",
              file=sys.stderr)
        return None
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    part, (mem_bw, f32_peak, f64_peak) = _peaks(name)
    _emit({"gpu": name, "nvidia_smi": smi, "peaks_from": part,
           "mem_bytes_per_s": mem_bw, "f32_flops": f32_peak,
           "f64_flops": f64_peak, "torch": torch.__version__,
           "cuda": torch.version.cuda})
    return {"mem_bw": mem_bw,
            "peak": {torch.float32: f32_peak, torch.float64: f64_peak},
            "reps": reps, "phase_launches": {}, "rows": []}


# ---------------------------------------------------------------------------
# phase 1


def _build_phase():
    from acg_torch import _build

    logs = _build.build()
    regs, spills = {}, {}
    for name, log in logs.items():
        used = [ln for ln in log.splitlines() if "registers" in ln]
        regs[name] = max((int(ln.split("Used ")[1].split()[0])
                          for ln in used if "Used " in ln), default=None)
        spills[name] = sum(int(v) for v in
                           re.findall(r"(\d+) bytes spill", log))
    # every instantiation of the two multi-RHS kernels
    batched = {name: sorted({int(v) for v in
                             re.findall(r"Used (\d+) registers", log)})
               for name, log in logs.items() if name.endswith("_batched")}
    return {"built": sorted(logs), "max_registers": regs,
            "spill_bytes": spills, "batched_kernel_registers": batched,
            "libraries": [str(_build.library_path(n).relative_to(REPO))
                          for n in _build.SOURCES]}


# ---------------------------------------------------------------------------
# phase 2


def _time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _queued_ms(fn, calls: int = 25, reps: int = 5) -> float:
    """ms a call on the card: the median of ``reps`` runs of ``calls``
    calls of ``fn()`` queued back to back between one pair of CUDA events
    (one call queued before the first event, so the card is busy while
    the host queues the rest)."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return sorted(out)[reps // 2]


def _bound(nbytes: int, flops: int, dtype, ctx) -> tuple[float, str]:
    tb = nbytes / ctx["mem_bw"] * 1e3
    tf = flops / ctx["peak"][dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _tolerances(dtype):
    import torch

    # (rtol, atol) of the vector, rtol of the dot: the kernel adds with
    # fused multiply-adds and sums the dot in another order than torch
    if dtype == torch.float64:
        return 1e-12, 0.0, 1e-10
    return 1e-5, 1e-5, 1e-4


def _check_kernel(label, run, plain, x, ctx, nbytes, flops, library,
                  extra=None, tol=None, plain_reps=None):
    """Hold one kernel configuration against its plain version, check its
    dot's bits across two runs, and time all three.  ``x`` may be a (B, n)
    batch: its dots are then per system.  ``extra(row) -> bool`` runs
    further checks and timings into the row before it is judged.  ``tol``
    is (rtol, atol, dot_rtol), by default ``_tolerances``.  The plain
    version is timed over ``plain_reps`` runs (by default as many as the
    kernel)."""
    import torch

    rtol, atol, dot_rtol = tol if tol is not None else _tolerances(x.dtype)
    out1, out2, want = run(), run(), plain()
    torch.cuda.synchronize()
    with_dot = isinstance(want, tuple)
    y1, d1 = out1 if with_dot else (out1, None)
    y2, d2 = out2 if with_dot else (out2, None)
    yw, dw = want if with_dot else (want, None)
    err = float((y1 - yw).abs().max())
    scale = float(yw.abs().max())
    row = dict(label, max_abs_err=err, max_abs_plain=scale,
               rtol=rtol, atol=atol,
               bits_stable=bool(torch.equal(y1, y2)))
    ok = err <= atol + rtol * scale and row["bits_stable"]
    if with_dot:
        dscale = (torch.linalg.norm(x, dim=-1)
                  * torch.linalg.norm(yw, dim=-1))
        derr = (d1 - dw).abs()
        row.update(dot=d1.tolist(), dot_plain=dw.tolist(),
                   dot_abs_err=float(derr.max()), dot_rtol=dot_rtol,
                   dot_bits_stable=bool(torch.equal(d1, d2)))
        ok = (ok and bool(torch.all(derr <= dot_rtol * dscale))
              and row["dot_bits_stable"])
    if extra is not None:
        ok = extra(row) and ok
    row["ms"] = _time_ms(run, ctx["reps"])
    row["plain_ms"] = _time_ms(plain, plain_reps or ctx["reps"])
    row["library_ms"] = _time_ms(library, ctx["reps"])
    row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, x.dtype, ctx)
    ctx["rows"].append(row)
    _emit({"kernel_check": row})
    if not ok:
        raise SystemExit(f"error: kernel disagrees with its plain version: "
                         f"{json.dumps(row)}")


def _check_pipe(label, run, plain, composed, vecs, ab, n, ctx, nbytes,
                flops, bodies=None):
    """Hold one pipelined-iteration configuration against its plain
    version: the six vectors at ``_tolerances``, gamma and delta relative
    to |r'|^2 and |w'|·|r'|, padding rows exactly zero, every output
    bit-identical across two runs; with ``bodies`` (``{"generic": f,
    "fixed": f}``, the DIA kernel with each body forced) the two bodies'
    outputs bit for bit equal; then time the kernel (one call, and
    queued), the plain version and the open-coded body (``composed``)."""
    import torch

    rtol, atol, dot_rtol = _tolerances(vecs[0].dtype)
    want = plain(*vecs, *ab)
    got, again = (run(*[v.clone() for v in vecs], *ab,
                      w_out=torch.empty_like(vecs[0])) for _ in range(2))
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max()) for g, w in zip(got[:6], want[:6])]
    scales = [float(w.abs().max()) for w in want[:6]]
    r2, w2 = want[4], want[5]
    gscale = float(r2 @ r2)
    dscale = float(torch.linalg.norm(w2) * torch.linalg.norm(r2))
    row = dict(label, max_abs_err=max(errs), max_abs_plain=max(scales),
               rtol=rtol, atol=atol,
               padding_rows=vecs[0].shape[0] - n,
               padding_zero=all(bool(torch.all(g[n:] == 0))
                                for g in got[:6]),
               bits_stable=all(torch.equal(a, b)
                               for a, b in zip(got, again)),
               gamma=float(got[6]), gamma_plain=float(want[6]),
               gamma_abs_err=abs(float(got[6]) - float(want[6])),
               delta=float(got[7]), delta_plain=float(want[7]),
               delta_abs_err=abs(float(got[7]) - float(want[7])),
               dot_rtol=dot_rtol)
    ok = (all(e <= atol + rtol * sc for e, sc in zip(errs, scales))
          and row["gamma_abs_err"] <= dot_rtol * gscale
          and row["delta_abs_err"] <= dot_rtol * dscale
          and row["padding_zero"] and row["bits_stable"])
    if bodies is not None:
        # the fixed and the generic body: the six vectors, gamma and
        # delta bit for bit
        outs = {k: f(*[v.clone() for v in vecs], *ab,
                     w_out=torch.empty_like(vecs[0]))
                for k, f in bodies.items()}
        row["bits_equal_generic"] = all(
            torch.equal(a, b) for a, b in zip(outs["fixed"],
                                              outs["generic"]))
        ok = ok and row["bits_equal_generic"]
        del outs
    # timed on a state of its own, updated in place call after call, as
    # the solver loop does (two w buffers alternate there; one here)
    state = [v.clone() for v in vecs]
    w_out = torch.empty_like(vecs[0])
    row["ms"] = _time_ms(lambda: run(*state, *ab, w_out=w_out), ctx["reps"])
    row["ms_queued"] = _queued_ms(lambda: run(*state, *ab, w_out=w_out))
    row["plain_ms"] = _time_ms(lambda: plain(*vecs, *ab), ctx["reps"])
    row["composed_ms"] = _time_ms(lambda: composed(*vecs, *ab), ctx["reps"])
    row["library_ms"] = None     # no single PyTorch call computes it
    row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, vecs[0].dtype,
                                              ctx)
    ctx["rows"].append(row)
    _emit({"kernel_check": row})
    if not ok:
        raise SystemExit(f"error: pipelined kernel disagrees with its plain "
                         f"version: {json.dumps(row)}")


def _pipe_inputs(n, npad, dtype, seed=1):
    """w, z, r, p, s, x on the card (zero past n) and alpha, beta."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    vecs = []
    for _ in range(6):
        v = torch.zeros(npad, dtype=dtype, device="cuda")
        v[:n] = torch.randn(n, generator=gen, dtype=dtype, device="cuda")
        vecs.append(v)
    return vecs, (torch.tensor(0.37, dtype=dtype, device="cuda"),
                  torch.tensor(1.21, dtype=dtype, device="cuda"))


def _pipe_bodies(dev):
    """The DIA pipelined iteration on ``dev`` with each kernel forced
    (the fixed one where its band count is compiled)."""
    from acg_torch.ops.dia_kernels import cg_pipelined_iter
    from acg_torch.ops.dia_plan import FIXED_BANDS

    if len(dev.offsets) not in FIXED_BANDS:
        return None
    return {k: (lambda *a, f=f, **kw: cg_pipelined_iter(
        dev.bands, dev.scales, dev.offsets_t, *a, fixed=f, **kw))
        for k, f in (("generic", False), ("fixed", True))}


def _composed(matvec):
    """The open-coded pipelined body: the SpMV kernel, the six torch
    updates and two torch dots."""
    import torch

    from acg_torch.ops.blas1 import pipelined_update

    def body(w, z, r, p, s, x, alpha, beta):
        out = pipelined_update(matvec(w), w, z, r, p, s, x, alpha, beta)
        return out + (torch.dot(out[4], out[4]), torch.dot(out[5], out[4]))

    return body


def _csr_of(dev, dtype):
    """The DIA operator as a torch sparse CSR matrix on its device, built
    straight from the bands (rows in order, each row's entries in
    ascending column order, zeros dropped; for the library yardstick
    only)."""
    import torch

    n = dev.nrows
    D_ = len(dev.offsets)
    vals = torch.empty((n, D_), dtype=dtype, device=dev.device)
    cols = torch.empty((n, D_), dtype=torch.int64, device=dev.device)
    i = torch.arange(n, device=dev.device)
    for d, off in enumerate(dev.offsets):
        band = dev.bands[d, :n].to(dtype)
        if dev.scales is not None:
            band = band * dev.scales[d].to(dtype)
        vals[:, d] = band
        cols[:, d] = i + off
    del i
    keep = vals != 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    cols, vals = cols[keep], vals[keep]
    del keep
    with warnings.catch_warnings():      # sparse tensors warn they are beta
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(crow, cols, vals, size=(n, n))


def _kernels_phase(G: int, nrhs: int, dist_nrhs: int, ctx):
    import torch

    from acg_torch.ops.dia import DeviceDia
    from acg_torch.ops.dia_kernels import (cg_pipelined_iter_plain,
                                           dia_matvec, dia_spmv)
    from acg_torch.ops.dia_plan import pipe_bytes
    from acg_torch.ops.stencil import (cg_pipelined_iter_stencil,
                                       cg_pipelined_iter_stencil_plain,
                                       recognize_stencil, stencil_spmv)
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    D = poisson3d_7pt_dia(G)
    n = D.nrows
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = {dt: torch.randn(D.nrows_padded, generator=gen, device="cuda",
                          dtype=torch.float64).to(dt)
          for dt in (torch.float32, torch.float64)}
    csr = {}
    tiers = (("bf16/f32", torch.float32, "auto"),
             ("int8/f32", torch.float32, "int8"),
             ("f64/f64", torch.float64, None))
    for tier, vdt, mat in tiers:
        dev = DeviceDia.from_dia(D, dtype=str(vdt)[6:], mat_dtype=mat)
        want_band = {"auto": torch.bfloat16, "int8": torch.int8,
                     None: torch.float64}[mat]
        if dev.bands.dtype != want_band:
            raise SystemExit(f"error: tier {tier} stored "
                             f"{dev.bands.dtype}, expected {want_band}")
        if vdt not in csr:
            csr[vdt] = _csr_of(dev, vdt)
        x, A = xs[vdt], csr[vdt]
        D_, vb = len(dev.offsets), x.element_size()
        for with_dot in (False, True):
            def run(dev=dev, x=x, w=with_dot):
                return dia_spmv(dev.bands, dev.scales, dev.offsets_t, x,
                                with_dot=w, fixed=dev.fixed)

            def plain(dev=dev, x=x, w=with_dot):
                y = dia_matvec(dev.bands, dev.offsets, x, dev.scales)
                return (y, torch.dot(x, y)) if w else y

            nbytes = D_ * n * dev.mat_itemsize + 2 * n * vb
            flops = 2 * D_ * n + (2 * n if with_dot else 0)
            _check_kernel({"name": "dia_spmv", "tier": tier,
                           "with_dot": with_dot},
                          run, plain, x, ctx, nbytes, flops,
                          lambda A=A, x=x: A @ x)
        # the pipelined iteration: 12 vector streams plus the bands
        vecs, ab = _pipe_inputs(n, D.nrows_padded, vdt)
        _check_pipe({"name": "cg_pipelined_iter", "tier": tier,
                     "pipe_fixed": dev.pipe_fixed},
                    dev.pipelined_iter,
                    lambda *a, dev=dev: cg_pipelined_iter_plain(
                        dev.bands, dev.scales, dev.offsets, *a),
                    _composed(lambda v, dev=dev: dia_spmv(
                        dev.bands, dev.scales, dev.offsets_t, v,
                        fixed=dev.fixed)),
                    vecs, ab, n, ctx,
                    pipe_bytes(n, D_, vdt, dev.bands.dtype),
                    2 * D_ * n + 16 * n, bodies=_pipe_bodies(dev))
        del dev, vecs
    del csr
    torch.cuda.empty_cache()
    weight = torch.zeros(1, 1, 3, 3, 3, dtype=torch.float64, device="cuda")
    weight[0, 0, 1, 1, 1] = 6.0
    for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        weight[(0, 0) + c] = -1.0
    for vdt in (torch.float32, torch.float64):
        spec, why = recognize_stencil(D, dtype=str(vdt)[6:])
        if spec is None:
            raise SystemExit(f"error: the Poisson operator did not "
                             f"recognize as a stencil: {why}")
        x = xs[vdt]
        w = weight.to(vdt)
        for with_dot in (False, True):
            def library(x=x, w=w):
                return torch.nn.functional.conv3d(
                    x[:n].view(1, 1, G, G, G), w, padding=1)

            _stencil_row(spec, x, with_dot, f"matrix-free/{str(vdt)[6:]}",
                         library, ctx)
        # the pipelined iteration, with 8 padding rows past the grid
        vecs, ab = _pipe_inputs(n, n + 8, vdt)
        _check_pipe({"name": "cg_pipelined_iter_stencil",
                     "tier": f"matrix-free/{str(vdt)[6:]}"},
                    lambda *a, spec=spec, **k: cg_pipelined_iter_stencil(
                        spec, *a, **k),
                    lambda *a, spec=spec: cg_pipelined_iter_stencil_plain(
                        spec, *a),
                    _composed(lambda v, spec=spec: stencil_spmv(spec, v)),
                    vecs, ab, n, ctx, 12 * n * x.element_size(),
                    2 * len(spec.offsets) * n + 16 * n)
        del vecs
    del xs
    torch.cuda.empty_cache()
    _stencil_shapes(ctx)
    _cg_update_rows(G, nrhs, ctx)
    _coeff_rows(nrhs, ctx)
    _batched_kernels(D, G, nrhs, ctx)
    _unstructured_kernels(ctx)
    _hbm_kernels(D, ctx)
    _dist_kernels(dist_nrhs, ctx)
    return {"grid": [G, G, G], "n": n, "nrhs": nrhs,
            "dist_nrhs": dist_nrhs,
            "configurations": len(ctx["rows"]),
            "launches_while_checking": _counts()}


def _cg_update_rows(G: int, nrhs: int, ctx, big: int = 464):
    """The classic loop's fused update (``ops/cg_update.py``) at the
    shapes the solve phases give it: 256^3 f64 (stencil), the 256^3/4
    shard f64 (dist-stencil-rdma), B = 8 systems of 256^3 f64
    (batched-stencil) and 464^3 f32 (dia-100m).  x and r are held bit for
    bit against the plain version (two addcmul_), the dots against
    torch.dot to rounding and bit-stable across runs, each row of the
    batch bit-equal to the one-system call; timed beside the plain
    version (the composed addcmul_ x 2 + torch.dot, which no single
    PyTorch call replaces: library_ms null) and its bound, 6 vector
    streams (4 read, 2 written)."""
    import torch

    from acg_torch.ops.cg_update import cg_update, cg_update_plain

    cases = (("f64 256^3", torch.float64, (G ** 3,)),
             ("f64 256^3/4 shard", torch.float64, (G ** 3 // 4,)),
             (f"f64 256^3 B={nrhs}", torch.float64, (nrhs, G ** 3)),
             (f"f32 {big}^3", torch.float32, (big ** 3,)))
    gen = torch.Generator(device="cuda").manual_seed(17)
    for tier, vdt, shape in cases:
        x, r, p, t = (torch.randn(shape, generator=gen, device="cuda",
                                  dtype=vdt) for _ in range(4))
        alpha = torch.rand(shape[:-1], generator=gen, device="cuda",
                           dtype=vdt)
        xk, rk, xp, rp = x.clone(), r.clone(), x.clone(), r.clone()
        rr1, _ = cg_update(xk, rk, p, t, alpha)
        rr1 = rr1.clone()
        xk2, rk2 = x.clone(), r.clone()
        rr2, _ = cg_update(xk2, rk2, p, t, alpha)
        rrp, _ = cg_update_plain(xp, rp, p, t, alpha)
        torch.cuda.synchronize()
        xbits = bool(torch.equal(xk, xp))
        rbits = bool(torch.equal(rk, rp))
        err = max(float((xk - xp).abs().max()), float((rk - rp).abs().max()))
        rtol = 1e-12 if vdt == torch.float64 else 2e-5
        derr = float(((rr1 - rrp).abs() / rrp.abs()).max())
        rows_equal = None
        if len(shape) == 2:
            rows_equal = True
            for i in range(shape[0]):
                x1, r1 = x[i].clone(), r[i].clone()
                d1, _ = cg_update(x1, r1, p[i], t[i], alpha[i].contiguous())
                rows_equal = rows_equal and bool(
                    torch.equal(x1, xk[i]) and torch.equal(r1, rk[i])
                    and torch.equal(d1, rr1[i]))
        row = {"name": "cg_update", "tier": tier, "with_dot": None,
               "shape": list(shape), "max_abs_err": err,
               "bits_equal_plain": xbits and rbits,
               "dot_rel_err": derr, "dot_rtol": rtol,
               "dot_bits_stable": bool(torch.equal(rr1, rr2)),
               "per_system_bits_equal_1d": rows_equal}

        def run(x=xk, r=rk, p=p, t=t, a=alpha):
            return cg_update(x, r, p, t, a)

        def plain(x=xp, r=rp, p=p, t=t, a=alpha):
            return cg_update_plain(x, r, p, t, a)

        row["ms"] = _time_ms(run, ctx["reps"])
        row["ms_queued"] = _queued_ms(run)
        row["plain_ms"] = _time_ms(plain, ctx["reps"])
        row["composed_ms"] = row["plain_ms"]
        row["library_ms"] = None
        nel = x.numel()
        row["bound_ms"], row["bound_by"] = _bound(
            6 * nel * x.element_size(), 6 * nel, vdt, ctx)
        ctx["rows"].append(row)
        _emit({"kernel_check": row})
        ok = (row["bits_equal_plain"] and derr <= rtol
              and row["dot_bits_stable"] and rows_equal is not False)
        if not ok:
            raise SystemExit(f"error: cg_update disagrees with its plain "
                             f"version: {json.dumps(row)}")
        del x, r, p, t, xk, rk, xp, rp, xk2, rk2
        torch.cuda.empty_cache()


def _sstep_inputs(s: int, nsys: int, maxits: int, dtype=None,
                  edge: int = 32):
    """One s-step block's coefficient state at the main path's shapes
    (the kernel sees (B, 2s+1, 2s+1) Gram matrices, whatever n): the Gram
    matrices of real bases (a 32^3 Poisson operator on the card at the
    vector dtype, f64 by default; random right-hand sides, the Chebyshev
    seeds at 12), fresh flags and counts, a criterion no block meets
    (rtol 0), so every call does a whole block's work."""
    import numpy as np
    import torch

    from acg_torch.solvers.cg import (_cheb_leja_nodes, _sstep_block_fn,
                                      build_device_operator)
    from acg_torch.sparse.poisson import poisson3d_7pt

    tdt = torch.float64 if dtype is None else dtype
    A = poisson3d_7pt(edge)
    op = build_device_operator(
        A, dtype=np.float64 if tdt == torch.float64 else np.float32,
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    th = torch.tensor(12.0 * _cheb_leja_nodes(s), dtype=tdt, device="cuda")
    grams = []
    for _ in range(nsys):
        b = torch.zeros(op.nrows_padded, dtype=tdt, device="cuda")
        b[: A.nrows] = torch.randn(A.nrows, generator=gen, device="cuda",
                                   dtype=tdt)
        _, G = _sstep_block_fn(op.matvec, b, s)(torch.zeros_like(b),
                                                b.clone(), th)
        grams.append(G.clone())
    G = torch.stack(grams)
    m = 2 * s + 1
    rr0 = G[:, s + 1, s + 1].clone()

    def state():
        return dict(G=G, shifts=th.repeat(nsys, 1).contiguous(),
                    rr=rr0.clone(), rr0=rr0, thresh2=torch.zeros_like(rr0),
                    kiter=torch.zeros(nsys, dtype=torch.int64,
                                      device="cuda"),
                    flag=torch.zeros(nsys, dtype=torch.int32, device="cuda"),
                    hist=torch.full((nsys, maxits + 1), float("nan"),
                                    dtype=tdt, device="cuda"),
                    coef=torch.zeros((nsys, 2, m), dtype=tdt,
                                     device="cuda"),
                    changed=torch.zeros(nsys, dtype=torch.bool,
                                        device="cuda"),
                    status=torch.zeros((nsys, 3), dtype=torch.float64,
                                       device="cuda"))
    return state


def _deep_inputs(l: int, seed: int = 5):
    """One deep body's buffers at the main path's shape (one system,
    f64): G upper triangular with a positive diagonal, a dot block with
    a positive last entry (a committing body), gamma/delta rings."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    w = 2 * l + 1

    def t(a, dt=torch.float64):
        return torch.tensor(np.asarray(a), dtype=dt, device="cuda")

    G = np.triu(rng.standard_normal((w, w)) * 0.1)
    G[np.arange(w), np.arange(w)] = 1.0 + rng.random(w)
    D = rng.standard_normal(w) * 0.1
    D[w - 1] = 4.0
    return dict(
        D=t(D), G=t(G), shifts=t(2.0 + rng.random(l)),
        gring=t(1.0 + rng.random(l)), dring=t(0.5 + rng.random(l)),
        sc=t([1.5, 1.2, 0.3, 0.5, 1e-300]),
        flag=t(0, torch.int32), est=t(False, torch.bool),
        kdev=t(0, torch.int32), ksys=t(0, torch.int32),
        kit=t(0, torch.int64),
        hist=torch.full((100001,), float("nan"), dtype=torch.float64,
                        device="cuda"),
        co=torch.zeros(w + 5, dtype=torch.float64, device="cuda"),
        commit=t(False, torch.bool), act=t(False, torch.bool),
        live=t(False, torch.bool), kmon=t(0, torch.int32))


def _coeff_rows(nrhs: int, ctx, s: int = 4, l: int = 2):
    """The s-step and deep loops' coefficient kernels
    (``ops/sstep_coeffs.py``, ``ops/deep_coeffs.py``) at the shapes and
    types the solve phases give them: sstep_coeffs at s = 4, f64, one
    system (sstep-stencil, dist-sstep-stencil) and B systems (sstep-
    batched-stencil), and f32, one system (sstep-dia-bf16's f32
    vectors); deep_coeffs at l = 2, f64, one system (deep-stencil,
    dist-deep-stencil).  Each is held against its plain version on the
    card on the same inputs (sstep_coeffs: flags, counts and ``changed``
    equal, the rest within 1e-12 (f64) / 1e-5 (f32) of its scale;
    deep_coeffs: every buffer bit for bit over ten bodies), then timed
    one call and queued beside the plain version.  Both are latency-bound: the bound (their few
    hundred bytes over the memory rate, their operations over the f64
    peak) is nanoseconds; no single PyTorch call computes either
    (library_ms null)."""
    import torch

    from acg_torch.ops import deep_coeffs as dc
    from acg_torch.ops import sstep_coeffs as sc

    maxits = 100000
    m = 2 * s + 1
    for tdt, nsys, tol in ((torch.float64, 1, 1e-12),
                           (torch.float64, nrhs, 1e-12),
                           (torch.float32, 1, 1e-5)):
        state = _sstep_inputs(s, nsys, maxits, tdt)
        got, want = state(), state()
        sc.sstep_coeffs(**got, s=s, maxits=maxits, any_crit=False)
        sc.sstep_coeffs_plain(**want, s=s, maxits=maxits, any_crit=False)
        torch.cuda.synchronize()
        exact = all(torch.equal(got[k], want[k])
                    for k in ("flag", "kiter", "changed"))
        err, bits = 0.0, True
        for k in ("coef", "rr", "shifts", "hist"):
            a, b = got[k].nan_to_num(), want[k].nan_to_num()
            scale = float(b.abs().max())
            err = max(err, float((a - b).abs().max()) / scale)
            bits = bits and torch.equal(a, b)
        tier = f"{'f64' if tdt == torch.float64 else 'f32'} s={s} B={nsys}"
        row = {"name": "sstep_coeffs", "tier": tier, "with_dot": None,
               "max_abs_err": err, "err_relative_to": "each output's scale",
               "tolerance": tol,
               "flags_counts_changed_equal": exact,
               "bits_equal_plain": bits, "blocks_committed": int(
                   got["changed"].sum())}
        st1, st2 = state(), state()
        row["ms"] = _time_ms(lambda: sc.sstep_coeffs(
            **st1, s=s, maxits=maxits, any_crit=False), ctx["reps"])
        row["ms_queued"] = _queued_ms(lambda: sc.sstep_coeffs(
            **st1, s=s, maxits=maxits, any_crit=False))
        row["plain_ms"] = _time_ms(lambda: sc.sstep_coeffs_plain(
            **st2, s=s, maxits=maxits, any_crit=False), 5, warmup=1)
        row["library_ms"] = None
        # operations a system: s inner steps (two G products, four
        # m-sums, the coefficient updates), the bisection's halvings of
        # s Sturm counts, the Leja order
        flops = nsys * (s * (4 * m * m + 16 * m)
                        + sc.HALVINGS[tdt] * s * 4 * s
                        + 3 * s * s)
        size = torch.empty((), dtype=tdt).element_size()
        nbytes = nsys * (size * (m * m + 2 * m + 3 * s + 3) + 8 + 4 + 1
                         + 8 * 3)
        row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, tdt, ctx)
        ctx["rows"].append(row)
        _emit({"kernel_check": row})
        if not (exact and err <= tol and row["blocks_committed"] == nsys):
            raise SystemExit(f"error: sstep_coeffs disagrees with its "
                             f"plain version: {json.dumps(row)}")
    w = 2 * l + 1
    got, want = _deep_inputs(l), _deep_inputs(l)
    bits = True
    for t in range(10):
        kw = dict(l=l, t=t, hh=t % l, hv=t % (w - 1), at_check=t % 3 == 2,
                  guard=True, any_crit=True)
        dc.deep_coeffs(**got, **kw)
        dc.deep_coeffs_plain(**want, **kw)
        torch.cuda.synchronize()
        for k in want:
            a, b = got[k], want[k]
            if a.is_floating_point():
                bits = bits and torch.equal(torch.isnan(a), torch.isnan(b))
                a, b = a.nan_to_num(), b.nan_to_num()
            bits = bits and torch.equal(a, b)
    err = float((got["co"] - want["co"]).abs().max())
    row = {"name": "deep_coeffs", "tier": f"f64 l={l} B=1", "with_dot": None,
           "max_abs_err": err, "bits_equal_plain": bits, "bodies_checked": 10}
    st1, st2 = _deep_inputs(l), _deep_inputs(l)
    kw = dict(l=l, t=l + 1, hh=1, hv=3, at_check=False, guard=False,
              any_crit=True)
    row["ms"] = _time_ms(lambda: dc.deep_coeffs(**st1, **kw), ctx["reps"])
    row["ms_queued"] = _queued_ms(lambda: dc.deep_coeffs(**st1, **kw))
    row["plain_ms"] = _time_ms(lambda: dc.deep_coeffs_plain(**st2, **kw),
                               ctx["reps"])
    row["library_ms"] = None
    flops = (w - 1) * (w - 1) + 2 * (w - 1) + 40
    nbytes = 8 * (w * w + w + 2 * l + 8 + w + 5) + 16
    row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, torch.float64,
                                              ctx)
    ctx["rows"].append(row)
    _emit({"kernel_check": row})
    if not bits:
        raise SystemExit(f"error: deep_coeffs disagrees with its plain "
                         f"version: {json.dumps(row)}")
    torch.cuda.empty_cache()


def _stencil_row(spec, x, with_dot, tier, library, ctx):
    """One stencil_spmv configuration through ``_check_kernel``, with the
    kernel the plan routes it to (``route``) and ``bits_equal_generic``:
    y (and the dot) bit-equal to the generic kernel forced on the same x,
    which is judged.  The conv library call's difference from the plain
    version is recorded beside it."""
    import torch

    from acg_torch.ops.stencil import route, stencil_matvec, stencil_spmv

    n = spec.nrows

    def run():
        return stencil_spmv(spec, x, with_dot=with_dot)

    def plain():
        y = stencil_matvec(x, spec.grid, spec.digits, spec.coeffs)
        return (y, torch.dot(x, y)) if with_dot else y

    def check(row):
        got = run()
        want = stencil_spmv(spec, x, with_dot=with_dot, fixed=False)
        if with_dot:
            row["bits_equal_generic"] = (bool(torch.equal(got[0], want[0]))
                                         and bool(torch.equal(got[1],
                                                              want[1])))
        else:
            row["bits_equal_generic"] = bool(torch.equal(got, want))
        return row["bits_equal_generic"]

    yp = plain()
    yp = yp[0] if with_dot else yp
    lib_err = float((library().reshape(-1) - yp[:n]).abs().max())
    del yp
    _check_kernel({"name": "stencil_spmv", "tier": tier,
                   "with_dot": with_dot, "route": route(spec),
                   "grid": list(spec.grid),
                   "library_max_abs_err": lib_err},
                  run, plain, x, ctx, 2 * n * x.element_size(),
                  2 * len(spec.offsets) * n + (2 * n if with_dot else 0),
                  library, extra=check)


def _grid_stencil(grid: tuple, digits: list, centre: float):
    """The constant-coefficient stencil on ``grid`` with the arms
    ``digits`` (each at -1, the centre at ``centre``), made directly as a
    spec: no host matrix."""
    from acg_torch.ops.stencil import StencilSpec

    strides = [math.prod(grid[a + 1:]) for a in range(len(grid))]
    arms = sorted((sum(g * s for g, s in zip(dg, strides)), tuple(dg))
                  for dg in digits)
    nnz = sum(math.prod(G - abs(g) for G, g in zip(grid, dg))
              for _, dg in arms)
    return StencilSpec(grid=tuple(grid), offsets=tuple(o for o, _ in arms),
                       digits=tuple(dg for _, dg in arms),
                       coeffs=tuple(centre if not any(dg) else -1.0
                                    for _, dg in arms), nnz=nnz)


def _stencil_shapes(ctx, edge27: int = 128, edge2d: int = 4096):
    """stencil_spmv on the other arm counts its fixed kernel is compiled
    for: the 27-point operator on edge27^3 beside conv3d, the 2-D 5-point
    on edge2d^2 beside conv2d, f32 and f64, with and without the dot."""
    import itertools

    import torch

    cases = (("27pt", (edge27,) * 3,
              list(itertools.product((-1, 0, 1), repeat=3)), 26.0),
             ("2d-5pt", (edge2d,) * 2,
              [(-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)], 4.0))
    gen = torch.Generator(device="cuda").manual_seed(11)
    for name, grid, digits, centre in cases:
        spec = _grid_stencil(grid, digits, centre)
        n = spec.nrows
        w64 = torch.full((3,) * len(grid), -1.0, dtype=torch.float64,
                         device="cuda")
        if len(grid) == 2:
            w64[0, 0] = w64[0, 2] = w64[2, 0] = w64[2, 2] = 0.0
        w64[(1,) * len(grid)] = centre
        conv = (torch.nn.functional.conv3d if len(grid) == 3
                else torch.nn.functional.conv2d)
        for vdt in (torch.float32, torch.float64):
            x = torch.randn(n, generator=gen, dtype=torch.float64,
                            device="cuda").to(vdt)
            w = w64.to(vdt)[None, None]
            tier = (f"matrix-free/{str(vdt)[6:]} {name} "
                    f"{'x'.join(map(str, grid))}")
            for with_dot in (False, True):
                _stencil_row(spec, x, with_dot, tier,
                             lambda x=x, w=w: conv(x.view(1, 1, *grid), w,
                                                   padding=1), ctx)
            del x
        torch.cuda.empty_cache()


def _per_system_bits(Y, d, X, one):
    """True when every system's row of the batched output (and its dot,
    when ``d`` is not None) has exactly the bits of the one-system kernel
    ``one(x, with_dot)`` on that system."""
    import torch

    for s in range(X.shape[0]):
        x = X[s].contiguous()
        if d is None:
            if not torch.equal(Y[s], one(x, False)):
                return False
        else:
            y, ds = one(x, True)
            if not (torch.equal(Y[s], y) and torch.equal(d[s], ds)):
                return False
    return True


def _batched_kernels(D, G: int, nrhs: int, ctx):
    """Both multi-RHS kernels in every tier at (nrhs, n), and the DIA
    kernel at bf16/f32 with 2 nrhs systems (two launches, the bands read
    twice): held against their plain versions (``_check_kernel``), each
    system bit-identical to the one-system kernel at B and at B = 1, and
    timed beside B calls of the one-system kernel and the library call on
    the same batch (cuSPARSE SpMM for DIA, conv3d with batch N = nrhs for
    the stencil)."""
    import torch

    from acg_torch.ops.blas1 import batched_dot
    from acg_torch.ops.dia import DeviceDia
    from acg_torch.ops.dia_kernels import (dia_matvec, dia_spmv,
                                           dia_spmv_batched)
    from acg_torch.ops.stencil import (recognize_stencil, stencil_matvec,
                                       stencil_spmv, stencil_spmv_batched)

    n, nrp = D.nrows, D.nrows_padded
    gen = torch.Generator(device="cuda").manual_seed(3)
    X64 = torch.randn(2 * nrhs, nrp, generator=gen, device="cuda",
                      dtype=torch.float64)

    def extras(batched, one, X):
        """Per-system bits at B = nrhs and B = 1, and nrhs one-system
        calls timed."""
        def check(row):
            out = batched(X)
            Y, d = out if isinstance(out, tuple) else (out, None)
            row["per_system_bits_equal_1d"] = _per_system_bits(Y, d, X, one)
            out1 = batched(X[:1].contiguous())
            Y1, d1 = out1 if isinstance(out1, tuple) else (out1, None)
            row["b1_bits_equal_1d"] = _per_system_bits(Y1, d1, X[:1], one)
            rows = [X[s].contiguous() for s in range(X.shape[0])]
            row["one_system_calls_ms"] = _time_ms(
                lambda: [one(x, row["with_dot"]) for x in rows],
                ctx["reps"])
            return row["per_system_bits_equal_1d"] and row[
                "b1_bits_equal_1d"]
        return check

    tiers = (("bf16/f32", torch.float32, "auto"),
             ("int8/f32", torch.float32, "int8"),
             ("f64/f64", torch.float64, None))
    # B = nrhs in every tier, both with and without the dot; B = 2 nrhs
    # (two launches, the band stream read twice) at bf16/f32 with the dot
    for tier, vdt, mat in tiers:
        dev = DeviceDia.from_dia(D, dtype=str(vdt)[6:], mat_dtype=mat)
        A = _csr_of(dev, vdt)
        D_ = len(dev.offsets)
        vb = torch.empty((), dtype=vdt).element_size()

        def one(x, w, dev=dev):
            return dia_spmv(dev.bands, dev.scales, dev.offsets_t, x,
                            with_dot=w, fixed=dev.fixed)

        runs = [(nrhs, False), (nrhs, True)]
        if tier == "bf16/f32":
            runs.append((2 * nrhs, True))
        for B, with_dot in runs:
            X = X64[:B].to(vdt).contiguous()
            Xt = X[:, :n].T.contiguous()          # (n, B) for the SpMM

            def run(X=X, dev=dev, w=with_dot):
                return dia_spmv_batched(dev.bands, dev.scales,
                                        dev.offsets_t, X, with_dot=w)

            def plain(X=X, dev=dev, w=with_dot):
                Y = dia_matvec(dev.bands, dev.offsets, X, dev.scales)
                return (Y, batched_dot(X, Y)) if w else Y

            _check_kernel({"name": "dia_spmv_batched",
                           "tier": tier if B == nrhs else f"{tier} B={B}",
                           "with_dot": with_dot, "nrhs": B},
                          run, plain, X, ctx,
                          D_ * n * dev.mat_itemsize + B * 2 * n * vb,
                          B * (2 * D_ * n + (2 * n if with_dot else 0)),
                          lambda A=A, Xt=Xt: torch.sparse.mm(A, Xt),
                          extra=extras(run, one, X))
            del X, Xt
        del dev, A
        torch.cuda.empty_cache()
    weight = torch.zeros(1, 1, 3, 3, 3, dtype=torch.float64, device="cuda")
    weight[0, 0, 1, 1, 1] = 6.0
    for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        weight[(0, 0) + c] = -1.0
    for vdt in (torch.float32, torch.float64):
        spec, why = recognize_stencil(D, dtype=str(vdt)[6:])
        if spec is None:
            raise SystemExit(f"error: the Poisson operator did not "
                             f"recognize as a stencil: {why}")
        X = X64[:nrhs].to(vdt).contiguous()
        X[:, n:] = 0
        w = weight.to(vdt)

        def one(x, wd, spec=spec):
            return stencil_spmv(spec, x, with_dot=wd)

        for with_dot in (False, True):
            def run(X=X, spec=spec, wd=with_dot):
                return stencil_spmv_batched(spec, X, with_dot=wd)

            def plain(X=X, spec=spec, wd=with_dot):
                Y = stencil_matvec(X, spec.grid, spec.digits, spec.coeffs)
                return (Y, batched_dot(X, Y)) if wd else Y

            def library(X=X, w=w):
                return torch.nn.functional.conv3d(
                    X[:, :n].view(nrhs, 1, G, G, G), w, padding=1)

            yp = plain()
            yp = yp[0] if with_dot else yp
            lib_err = float((library().reshape(nrhs, n)
                             - yp[:, :n]).abs().max())
            del yp
            _check_kernel({"name": "stencil_spmv_batched",
                           "tier": f"matrix-free/{str(vdt)[6:]}",
                           "with_dot": with_dot, "nrhs": nrhs,
                           "library_max_abs_err": lib_err},
                          run, plain, X, ctx,
                          nrhs * 2 * nrp * X.element_size(),
                          nrhs * (2 * len(spec.offsets) * n
                                  + (2 * n if with_dot else 0)),
                          library, extra=extras(run, one, X))
        del X
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 3-5: solves through the user-facing entry points


def _counts() -> dict:
    from acg_torch.ops import cg_update, dia_kernels, sgell, spmv, stencil
    from acg_torch.parallel import rdma_halo

    from acg_torch.ops import deep_coeffs, sstep_coeffs

    return {"cg_update": cg_update.launches,
            "sstep_coeffs": sstep_coeffs.launches,
            "deep_coeffs": deep_coeffs.launches,
            "dia_spmv": dia_kernels.launches,
            "stencil_spmv": stencil.launches,
            "cg_pipelined_iter": dia_kernels.pipe_launches,
            "cg_pipelined_iter_stencil": stencil.pipe_launches,
            "dia_spmv_batched": dia_kernels.batched_launches,
            "stencil_spmv_batched": stencil.batched_launches,
            "ell_spmv": spmv.launches, "sgell_spmv": sgell.launches,
            "dia_spmv_ring": dia_kernels.ring_launches,
            "dia_spmv_windows": dia_kernels.windows_launches,
            "rdma_exchange": rdma_halo.launches}


def _reset_counts():
    from acg_torch.ops import cg_update, dia_kernels, sgell, spmv, stencil
    from acg_torch.parallel import rdma_halo

    from acg_torch.ops import deep_coeffs, sstep_coeffs

    rdma_halo.launches = cg_update.launches = 0
    sstep_coeffs.launches = deep_coeffs.launches = 0
    dia_kernels.launches = dia_kernels.pipe_launches = 0
    stencil.launches = stencil.pipe_launches = 0
    dia_kernels.batched_launches = stencil.batched_launches = 0
    dia_kernels.ring_launches = dia_kernels.windows_launches = 0
    spmv.launches = sgell.launches = 0


def _read_counts(ctx, phase: str) -> dict:
    got = _counts()
    ctx["phase_launches"][phase] = got
    return got


def _true_residual(op, x_host, b_host) -> float:
    """||b - A x|| / ||b|| recomputed on the card with the operator's own
    kernel."""
    import torch

    vdt = getattr(torch, op.vec_dtype)
    x = torch.zeros(op.nrows_padded, dtype=vdt)
    x[: op.nrows] = torch.from_numpy(x_host)
    b = torch.zeros(op.nrows_padded, dtype=vdt)
    b[: op.nrows] = torch.from_numpy(b_host.astype(x_host.dtype))
    x, b = x.cuda(), b.cuda()
    r = b - op.matvec(x)
    return float(torch.linalg.norm(r) / torch.linalg.norm(b))


def _solve_report(res, launches: dict) -> dict:
    its = max(res.niterations, 1)
    rep = {"iterations": res.niterations,
           "tsolve_s": res.stats.tsolve,
           "us_per_iter": res.stats.tsolve / its * 1e6,
           "relative_residual": res.relative_residual,
           "operator_format": res.operator_format, "kernel": res.kernel,
           "kernel_note": res.kernel_note, "launches": launches,
           "launches_per_iter": {k: v / its for k, v in launches.items()}}
    if res.nrhs > 1:
        # a batch: the loop runs to its slowest system; each system counts
        # only the iterations it was active
        total = max(int(res.iterations_per_system.sum()), 1)
        rep.update(nrhs=res.nrhs,
                   iterations_per_system=res.iterations_per_system.tolist(),
                   us_per_system_iter=res.stats.tsolve / total * 1e6)
    return rep


def _batched_true_residuals(op, x_host, b_host) -> list:
    """||b_s - A x_s|| / ||b_s|| of every system, on the card."""
    return [_true_residual(op, x_host[s], b_host[s])
            for s in range(b_host.shape[0])]


def _check_batched_launches(rep, launches, kernel, its, where):
    """A batched solve went through the multi-RHS kernel, at least once
    per iteration, and launched no one-system kernel."""
    one = [k for k in ("dia_spmv", "stencil_spmv", "cg_pipelined_iter",
                       "cg_pipelined_iter_stencil", "dia_spmv_ring",
                       "dia_spmv_windows") if launches[k]]
    if launches[kernel] < its or one:
        raise SystemExit(f"error: {where}: {kernel} launched "
                         f"{launches[kernel]} times in {its} iterations "
                         f"(one-system kernels launched: {one}): {rep}")


def _solver(pipelined: bool):
    """(solve function, kernel-name suffix) of classic or pipelined CG."""
    from acg_torch.solvers.cg import cg, cg_pipelined

    return (cg_pipelined, "pipe") if pipelined else (cg, "fused")


_DIA_ONE_VECTOR = {"resident": "dia_spmv", "hbm-ring": "dia_spmv_ring",
                   "hbm": "dia_spmv_windows"}


def _plan_info(op) -> dict:
    """The one-vector SpMV plan a DIA operator took: its kernel and, for
    ``dia_spmv``, whether it runs with the band count fixed, for an HBM
    kernel the tile, grid, shared memory, ring depth (row tiles in
    flight) and, for the ring, its span; and whether its pipelined
    iteration runs the kernel with the band count fixed
    (``pipe_fixed``)."""
    p = op.plan
    if p is None:
        return {"kind": "resident", "kernel": "dia_spmv", "fixed": op.fixed,
                "pipe_fixed": op.pipe_fixed}
    return {"kind": p.kind, "kernel": _DIA_ONE_VECTOR[p.kind],
            "tile": p.tile, "nblocks": p.nblocks, "smem": p.smem,
            "stages": p.stages, "pipe_fixed": op.pipe_fixed,
            **({} if p.kind == "hbm" else {"span": [p.lo, p.hi]})}


def _dia_names(op, pipelined: bool):
    """(loop body of the kernel name, loop kernel, eager kernel) of a DIA
    solve: the one-vector SpMV kernel of the operator's plan takes the
    eager matvecs (initial residual, certification), and the classic
    loop too."""
    eager = _DIA_ONE_VECTOR[op.kind]
    if pipelined:
        return "pipe", "cg_pipelined_iter", eager
    body = "fused" if op.kind == "resident" else op.kind
    return body, eager, eager


def _check_launches(rep, launches, kernel, its, pipelined, where,
                    eager=None):
    """The solve went through its kernel: the loop kernel launched (the
    pipelined one once per iteration).  ``eager``: the one-vector DIA
    kernel the operator's plan gives its matvecs, which must have run
    (classic: once per iteration and once for the initial residual),
    and no other one-vector DIA kernel."""
    n = launches[kernel]
    bad = n <= 0 or (pipelined and n != its)
    if eager is not None:
        others = [k for k in _DIA_ONE_VECTOR.values()
                  if k != eager and launches[k]]
        bad = bad or bool(others) or launches[eager] <= 0 or (
            not pipelined and launches[eager] != its + 1)
    if bad:
        raise SystemExit(f"error: {where}: {kernel} launched {n} times in "
                         f"{its} iterations (eager kernel {eager}): {rep}")


def _stencil_solve(G: int, ctx, pipelined: bool = False):
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import build_device_operator
    from acg_torch.sparse.csr import manufactured_rhs
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    solve, body = _solver(pipelined)
    phase = "pipelined-stencil" if pipelined else "stencil"
    if pipelined:
        op, b, xstar = ctx["stencil_case"]
    else:
        D = poisson3d_7pt_dia(G)
        xstar, b = manufactured_rhs(D, seed=1)
        op = build_device_operator(D, dtype=np.float64, fmt="auto")
        ctx["stencil_case"] = (op, b, xstar)
    # warm-up (the CLI's default --warmup 1): first-use costs of the
    # CUDA libraries stay out of the timed solve
    solve(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    _reset_counts()
    res = solve(op, b, options=SolverOptions(maxits=20000,
                                             residual_rtol=1e-8))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    rep["true_relative_residual"] = _true_residual(op, res.x, b)
    rep["error_vs_manufactured"] = float(np.linalg.norm(res.x - xstar))
    ok = ((res.operator_format, res.kernel)
          == ("stencil", f"cuda-stencil-{body}") and res.converged
          and rep["true_relative_residual"] <= 1e-7
          and np.all(np.isfinite(res.x)) and res.x.shape == (op.nrows,))
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    if pipelined:
        _check_launches(rep, launches, "cg_pipelined_iter_stencil",
                        res.niterations, True, phase)
        # the exit certifier's SpMVs (r = b - A x, w = A r, s = A p,
        # z = A s) and the prelude's, apart from the loop kernel
        rep["certification_spmv_launches"] = launches["stencil_spmv"]
        rep["classic_iterations"] = ctx["classic_iterations"]
        ctx.setdefault("iterations", {})[phase] = res.niterations
    else:
        _check_launches(rep, launches, "stencil_spmv", res.niterations,
                        False, phase)
        ctx["classic_iterations"] = res.niterations
        ctx["stencil_error"] = rep["error_vs_manufactured"]
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    ctx["profile_cases"] = ctx.get("profile_cases", []) + [
        (f"{phase}-f64", op, b, solve)]
    return rep


def _dia_bf16_solve(G: int, iters: int, ctx, pipelined: bool = False,
                    nrhs: int = 0):
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import build_device_operator
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    solve, _ = _solver(pipelined)
    phase = ("batched-dia-bf16" if nrhs else
             "pipelined-dia-bf16" if pipelined else "dia-bf16")
    if G != 256:
        phase += f"-{G}"
    D = poisson3d_7pt_dia(G, dtype=np.float32)
    op = build_device_operator(D, dtype=np.float32, fmt="dia")
    if op.bands.dtype != torch.bfloat16:
        raise SystemExit(f"error: expected bf16 bands, got {op.bands.dtype}")
    body, loop_kernel, eager = _dia_names(op, pipelined)
    body = "batched" if nrhs else body
    rng = np.random.default_rng(0)
    b = rng.standard_normal((nrhs, D.nrows) if nrhs else D.nrows
                            ).astype(np.float32)
    # residual_rtol=0: every criterion off, the loop runs to maxits
    solve(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    _reset_counts()
    res = solve(op, b, options=SolverOptions(maxits=iters,
                                             residual_rtol=0.0))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    rep["plan"] = _plan_info(op)
    ok = ((res.operator_format, res.kernel) == ("dia", f"cuda-dia-{body}")
          and res.niterations == iters and np.all(np.isfinite(res.x))
          and res.x.shape == np.shape(b))
    if nrhs:
        ok = ok and list(res.iterations_per_system) == [iters] * nrhs
        rep["us_per_iter_one_system"] = ctx["us_per_iter"]["dia-bf16"]
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    if nrhs:
        _check_batched_launches(rep, launches, "dia_spmv_batched", iters,
                                phase)
    else:
        _check_launches(rep, launches, loop_kernel, iters, pipelined, phase,
                        eager=eager)
    if op.plan is not None and not pipelined and not nrhs:
        # the route change, measured: the same solve with the operator
        # planned resident (dia_spmv), as before the HBM tier existed
        resident = dataclasses.replace(op, plan=None)
        solve(resident, b, options=SolverOptions(maxits=20,
                                                 residual_rtol=0.0))
        before = dict(_counts())
        res_r = solve(resident, b, options=SolverOptions(maxits=iters,
                                                         residual_rtol=0.0))
        rep["us_per_iter_resident_plan"] = (res_r.stats.tsolve
                                            / res_r.niterations * 1e6)
        rep["resident_plan_kernel"] = res_r.kernel
        if (res_r.kernel != "cuda-dia-fused"
                or _counts()["dia_spmv"] - before["dia_spmv"] != iters + 1):
            raise SystemExit(f"error: {phase}: the resident-plan solve did "
                             f"not run dia_spmv: {res_r.kernel}")
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    if pipelined and not nrhs and G == 256:
        # what dist-pipelined-dia-bf16 is held against
        rep["host_true_relative_residual"] = _poisson7_residual(G, res.x, b)
        rep["recurrence_relative_residual"] = res.rnrm2 / res.bnrm2
        ctx["pipelined_dia_bf16_ref"] = dict(
            rep, history=res.residual_history, bnrm2=res.bnrm2)
        ctx["pipelined_dia_bf16_case"] = (op, b)
    if not pipelined and not nrhs and G == 256:
        ctx["profile_cases"] = ctx.get("profile_cases", []) + [
            ("dia-bf16-f32", op, b, solve)]
        # what dist-dia-bf16 is held against: the same b, the same
        # iterations, on one operator
        rep["host_true_relative_residual"] = _poisson7_residual(G, res.x, b)
        rep["recurrence_relative_residual"] = res.rnrm2 / res.bnrm2
        ctx["dia_bf16_ref"] = rep
    return rep


def _dia_f64_solve(G: int, ctx, pipelined: bool = False, nrhs: int = 0):
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import build_device_operator
    from acg_torch.sparse.csr import manufactured_rhs
    from acg_torch.sparse.poisson import poisson3d_7pt_varcoef

    solve, _ = _solver(pipelined)
    phase = ("batched-dia-f64" if nrhs else
             "pipelined-dia-f64" if pipelined else "dia-f64")
    A = poisson3d_7pt_varcoef(G)
    if nrhs:
        # seeds 0..nrhs-1; system 2 is the one-system phase's (seed 2)
        xstar, b = (np.stack(v) for v in zip(
            *(manufactured_rhs(A, seed=s) for s in range(nrhs))))
    else:
        xstar, b = manufactured_rhs(A, seed=2)
    op = build_device_operator(A, dtype=np.float64, fmt="auto")
    if op.bands.dtype != torch.float64:
        raise SystemExit(f"error: expected f64 bands, got {op.bands.dtype}")
    body, loop_kernel, eager = _dia_names(op, pipelined)
    body = "batched" if nrhs else body
    _reset_counts()
    res = solve(op, b, options=SolverOptions(maxits=20000,
                                             residual_rtol=1e-8))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    rep["plan"] = _plan_info(op)
    if nrhs:
        rep["true_relative_residual"] = _batched_true_residuals(op, res.x, b)
        rep["one_system_iterations_seed2"] = ctx["iterations"]["dia-f64"]
    else:
        rep["true_relative_residual"] = _true_residual(op, res.x, b)
    rep["error_vs_manufactured"] = float(np.linalg.norm(res.x - xstar))
    ok = ((res.operator_format, res.kernel) == ("dia", f"cuda-dia-{body}")
          and res.converged
          and max(np.ravel(rep["true_relative_residual"])) <= 1e-7
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    if nrhs:
        ok = ok and (res.iterations_per_system[2]
                     == rep["one_system_iterations_seed2"])
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    if nrhs:
        _check_batched_launches(rep, launches, "dia_spmv_batched",
                                res.niterations, phase)
    else:
        _check_launches(rep, launches, loop_kernel, res.niterations,
                        pipelined, phase, eager=eager)
    ctx.setdefault("iterations", {})[phase] = res.niterations
    return rep


def _batched_stencil(G: int, nrhs: int, ctx, pipelined: bool = False):
    """Classic (or pipelined) CG on ``nrhs`` 256^3 Poisson systems at once
    from ``nrhs`` manufactured solutions (seeds 0..nrhs-1), through the
    batched stencil kernel.  Classic: each system's count must equal its
    own one-system solve's (run here; the batched kernel gives every
    system the one-system kernel's bits).  Pipelined: counts within 1 of
    the classic batch's.  Every exit is certified against the true
    residual."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import build_device_operator
    from acg_torch.sparse.csr import manufactured_rhs
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    solve, _ = _solver(pipelined)
    phase = "batched-pipelined-stencil" if pipelined else "batched-stencil"
    if pipelined:
        op, b, xstar = ctx["batched_case"]
    else:
        D = poisson3d_7pt_dia(G)
        xstar, b = (np.stack(v) for v in zip(
            *(manufactured_rhs(D, seed=s) for s in range(nrhs))))
        op = build_device_operator(D, dtype=np.float64, fmt="auto")
        ctx["batched_case"] = (op, b, xstar)
    opts = SolverOptions(maxits=20000, residual_rtol=1e-8)
    solve(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    _reset_counts()
    res = solve(op, b, options=opts)
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    rep["true_relative_residual"] = _batched_true_residuals(op, res.x, b)
    rep["error_vs_manufactured"] = [float(np.linalg.norm(res.x[s]
                                                         - xstar[s]))
                                    for s in range(nrhs)]
    rep["us_per_iter_one_system"] = ctx["us_per_iter"][
        "pipelined-stencil" if pipelined else "stencil"]
    counts = np.asarray(res.iterations_per_system)
    ctx.setdefault("us_per_system_iter", {})[phase] = rep[
        "us_per_system_iter"]
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    if pipelined:
        ref = np.asarray(ctx["batched_counts"])
        rep["classic_batched_iterations"] = ref.tolist()
        counts_ok = bool(np.all(np.abs(counts - ref) <= 1))
        ctx["batched_pipelined_counts"] = counts.tolist()
    else:
        one = [solve(op, b[s], options=opts) for s in range(nrhs)]
        rep["one_system_iterations"] = [r.niterations for r in one]
        counts_ok = counts.tolist() == rep["one_system_iterations"]
        ctx["batched_counts"] = counts.tolist()
    ok = ((res.operator_format, res.kernel)
          == ("stencil", "cuda-stencil-batched") and res.converged
          and all(res.converged_per_system) and counts_ok
          and max(rep["true_relative_residual"]) <= 1e-7
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    if pipelined:
        ok = ok and res.kernel_note.startswith("stencil pipe disengaged: "
                                               f"nrhs={nrhs}")
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    _check_batched_launches(rep, launches, "stencil_spmv_batched",
                            res.niterations, phase)
    if not pipelined:
        ctx["profile_cases"] = ctx.get("profile_cases", []) + [
            (f"{phase}-f64", op, b, solve)]
    return rep


def _replace_solve(G: int, ctx):
    """Pipelined CG with residual replacement every 50 iterations: the
    open-coded body (SpMV kernel, torch updates and dots), said so in
    the kernel note."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import cg_pipelined

    op, b, xstar = ctx["stencil_case"]
    _reset_counts()
    res = cg_pipelined(op, b, options=SolverOptions(
        maxits=20000, residual_rtol=1e-8, replace_every=50))
    launches = _read_counts(ctx, "pipelined-replace")
    rep = _solve_report(res, launches)
    rep["true_relative_residual"] = _true_residual(op, res.x, b)
    ok = ((res.operator_format, res.kernel)
          == ("stencil", "cuda-stencil-spmv")
          and res.kernel_note == "stencil pipe disengaged: replace_every=50"
          and res.converged and rep["true_relative_residual"] <= 1e-7
          and launches["cg_pipelined_iter_stencil"] == 0
          and launches["stencil_spmv"] >= res.niterations)
    if not ok:
        raise SystemExit(f"error: pipelined-replace solve failed: {rep}")
    return rep


# ---------------------------------------------------------------------------
# phase 6


def _cli_main(argv):
    """``acg_torch.cli.main(argv)`` in this process (no interpreter start
    is timed): (exit code, stdout, stderr)."""
    import contextlib
    import io

    from acg_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _cli_phase(G: int, solver: str = "acg", nrhs: int = 1):
    from acg_torch.io.mtxfile import MtxFile, write_mtx
    from acg_torch.sparse.poisson import poisson3d_7pt

    A = poisson3d_7pt(G)
    r, c, v = A.to_coo()
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = os.path.join(tmp, "A.mtx")
        write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                                rowidx=r, colidx=c, vals=v))
        rc, stats, log = _cli_main(
            [path, "--solver", solver, "--nrhs", str(nrhs),
             "--manufactured-solution", "--max-iterations", "2000", "-v",
             "-q"])
    # -v logs the wrapper counts of the timed solve, zeroed just before it
    launches = _cli_launches(log)
    pipelined = solver == "acg-pipelined"
    if nrhs > 1:
        kernel, loop_kernel = "cuda-stencil-batched", "stencil_spmv_batched"
    elif pipelined:
        kernel, loop_kernel = "cuda-stencil-pipe", "cg_pipelined_iter_stencil"
    else:
        kernel, loop_kernel = "cuda-stencil-fused", "stencil_spmv"
    ok = (rc == 0 and f"kernel: {kernel}\n" in stats
          and "floating-point exceptions: none" in stats
          and launches is not None and launches[loop_kernel] > 0)
    if nrhs > 1:
        ok = ok and f"right-hand sides (batched): {nrhs}" in stats
    if not ok:
        raise SystemExit(f"error: CLI run failed (exit {rc}):\n"
                         f"{stats}\n{log}")
    its = [ln.split(":")[1].strip() for ln in stats.splitlines()
           if ln.strip().startswith("iterations:")]
    return {"grid": [G, G, G], "solver": solver, "nrhs": nrhs,
            "exit": rc,
            "iterations": int(its[0]) if its else None,
            "launches": launches,
            "kernel_line": [ln.strip() for ln in stats.splitlines()
                            if ln.strip().startswith("kernel:")][0]}


def _cli_launches(stderr: str):
    """The wrapper counts the CLI logs at -v for its timed solve (zeroed
    just before it), or None when the line is missing."""
    names = ("dia_spmv", "stencil_spmv", "cg_pipelined_iter",
             "cg_pipelined_iter_stencil", "dia_spmv_batched",
             "stencil_spmv_batched", "ell_spmv", "sgell_spmv",
             "dia_spmv_ring", "dia_spmv_windows")
    counted = re.search("kernel launches in the timed solve: " + ", ".join(
        rf"{k} (\d+)" for k in names), stderr)
    return ({k: int(v) for k, v in zip(names, counted.groups())}
            if counted else None)


# ---------------------------------------------------------------------------
# the single-device solver families: s-step, deep-pipelined, recycled CG

# deep-stencil's depth, tolerance and pipeline segment: at 48^3 f64
# (scripts/torch_sstep_deep.py) both packages' depth-2 solves fall back
# to classic CG without a bound on the segment, even at rtol 1e-6, and
# reach 1e-8 without fallback, in the same counts, with replace_every=50
_DEEP = {"depth": 2, "rtol": 1e-8, "replace_every": 50}


def _sstep_blocks(launches: int, s: int, its: int, where: str) -> int:
    """The blocks of an s-step solve from its SpMV launches, which must be
    2s a block (the replaced residual, the s P-block and s-1 R-block
    products) plus 8 (the entry residual, 6 power-iteration products,
    the certifying product).  Convergence is decided at a block boundary,
    so the loop ran at least ceil(its / s) blocks and, with one block
    that certifies the exit and one that resumes a paused estimate, at
    most two more."""
    blocks, rest = divmod(launches - 8, 2 * s)
    lo = -(-its // s)
    if rest or not lo <= blocks <= lo + 2:
        raise SystemExit(f"error: {where}: {launches} SpMV launches for "
                         f"{its} iterations at s = {s}, not 2s x blocks + "
                         f"8 with {lo} to {lo + 2} blocks")
    return blocks


def _sstep_solve(ctx, phase: str, s: int = 4):
    """s-step CG (``cg_sstep``) on the stencil phase's 256^3 f64 system
    (sstep-stencil) or the batched phases' 8 systems
    (sstep-batched-stencil), rtol 1e-8: no fallback, counts within s + 2
    of classic CG's (the JAX package's own bound,
    tests/test_cg_sstep.py:42), every system certified in float64 on the
    host within 10 x rtol, and the SpMV kernel without the dot launched
    2s times a block + 8."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import cg_sstep

    batched = phase == "sstep-batched-stencil"
    op, b, xstar = ctx["batched_case" if batched else "stencil_case"]
    G = round(op.nrows ** (1 / 3))
    rtol = 1e-8
    cg_sstep(op, b, options=SolverOptions(maxits=8, residual_rtol=0.0,
                                          sstep=s))
    _reset_counts()
    res = cg_sstep(op, b, options=SolverOptions(maxits=20000,
                                                residual_rtol=rtol, sstep=s))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    kernel = "stencil_spmv_batched" if batched else "stencil_spmv"
    blocks = _sstep_blocks(launches[kernel], s, res.niterations, phase)
    rep.update(s=s, blocks=blocks, spmv_launches_per_block=2 * s,
               **_sstep_block_times(res.stats, blocks, phase))
    xs, bs = (res.x, b) if batched else (res.x[None], b[None])
    rep["host_true_relative_residual"] = [
        _poisson7_residual(G, x, bb) for x, bb in zip(xs, bs)]
    if batched:
        ref = np.asarray(ctx["batched_counts"])
        counts = np.asarray(res.iterations_per_system)
        rep["classic_batched_iterations"] = ref.tolist()
        counts_ok = bool(np.all(np.abs(counts - ref) <= s + 2))
        rep["us_per_system_iter_classic"] = ctx["us_per_system_iter"][
            "batched-stencil"]
    else:
        rep["classic_iterations"] = ctx["classic_iterations"]
        rep["us_per_iter_classic"] = ctx["us_per_iter"]["stencil"]
        counts_ok = abs(res.niterations - ctx["classic_iterations"]) <= s + 2
    rep["loop"] = res.loop
    ok = ((res.operator_format, res.kernel)
          == ("stencil", f"cuda-stencil-{'batched' if batched else 'spmv'}")
          and res.converged and res.kernel_note == "" and res.loop == "graph"
          and launches["sstep_coeffs"] == blocks and counts_ok
          and max(rep["host_true_relative_residual"]) <= 10 * rtol
          and np.all(np.isfinite(res.x)) and res.x.shape == np.shape(b))
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    if batched:
        _check_batched_launches(rep, launches, kernel, res.niterations, phase)
    elif any(v for k, v in launches.items()
             if k not in (kernel, "sstep_coeffs")):
        raise SystemExit(f"error: {phase} launched other kernels: {rep}")
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    if not batched:
        ctx["profile_cases"] = ctx.get("profile_cases", []) + [
            (f"{phase}-f64", op, b, _with_options(cg_sstep, sstep=s))]
    return rep


def _sstep_block_times(stats, blocks: int, where: str) -> dict:
    """The timed solve's µs a block: all of it, the host's wait in the
    block's one status read (the card finishing the block), and the rest
    of the block on the host (the replay's launch, or every launch of
    the open loop, and the monitor), as ``cg_sstep_while`` accumulated
    them in the solve's stats; its block count must be the one the SpMV
    launches give."""
    if stats.nsstepblocks != blocks:
        raise SystemExit(f"error: {where}: the loop ran "
                         f"{stats.nsstepblocks} blocks, the launches say "
                         f"{blocks}")
    return dict(us_per_block=stats.tsolve / blocks * 1e6,
                status_read_us_per_block=stats.tsstepwait / blocks * 1e6,
                host_us_per_block=stats.tsstephost / blocks * 1e6)


def _with_options(solve, **fields):
    """``solve`` with ``fields`` set in the options it is given (the
    profile phase's fixed-iteration solves, in the solver's default
    loop; the graph-loop phase compares both loops)."""
    def run(op, b, options):
        return solve(op, b, options=dataclasses.replace(options, **fields))
    return run


def _sstep_dia_bf16(G: int, ctx, s: int = 4):
    """s-step CG on the 256^3 bf16-band operator at f32 vectors through
    the windows kernel without the dot (x past the L2), rtol 1e-4, from
    dia-bf16's b: certified in float64 within 10 x rtol, the f32
    coefficient kernel once a block.  f32 s-step is fragile at size, so
    a fallback to classic CG is allowed; it is printed, with the
    iterations folded as the JAX wrapper folds them."""
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import build_device_operator, cg_sstep
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    rtol = 1e-4
    D = poisson3d_7pt_dia(G, dtype=np.float32)
    op = build_device_operator(D, dtype=np.float32, fmt="dia")
    if op.bands.dtype != torch.bfloat16 or op.kind != "hbm":
        raise SystemExit(f"error: sstep-dia-bf16 planned {op.kind} with "
                         f"{op.bands.dtype} bands")
    b = np.random.default_rng(0).standard_normal(D.nrows).astype(np.float32)
    del D
    cg_sstep(op, b, options=SolverOptions(maxits=8, residual_rtol=0.0,
                                          sstep=s))
    _reset_counts()
    res = cg_sstep(op, b, options=SolverOptions(maxits=20000,
                                                residual_rtol=rtol, sstep=s))
    launches = _read_counts(ctx, "sstep-dia-bf16")
    rep = _solve_report(res, launches)
    rep["plan"] = _plan_info(op)
    rep["fallback"] = "fell back to classic cg" in res.kernel_note
    blocks = None
    if not rep["fallback"]:
        blocks = _sstep_blocks(launches["dia_spmv_windows"], s,
                               res.niterations, "sstep-dia-bf16")
        rep.update(blocks=blocks, **_sstep_block_times(
            res.stats, blocks, "sstep-dia-bf16"))
    rep["host_true_relative_residual"] = _poisson7_residual(G, res.x, b)
    ok = ((res.operator_format, res.kernel) == ("dia", "cuda-dia-hbm")
          and (res.kernel_note == "" or rep["fallback"])
          and res.converged
          and rep["host_true_relative_residual"] <= 10 * rtol
          and launches["dia_spmv"] == launches["dia_spmv_ring"] == 0
          and launches["dia_spmv_windows"] > 0
          and launches["sstep_coeffs"] > 0
          and (rep["fallback"] or launches["sstep_coeffs"] == blocks)
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    if not ok:
        raise SystemExit(f"error: sstep-dia-bf16 solve failed: {rep}")
    return rep


def _deep_stencil(ctx):
    """Depth-2 pipelined CG on the stencil phase's 256^3 f64 system at
    ``_DEEP``'s tolerance and segment, certified in float64 within 10 x
    rtol.  The SpMV kernel without the dot follows the dispatch
    protocol: per dispatch, the entry residual, l fill products, one per
    body and the certifying product; plus 6 for the power prelude, once.
    The bodies are the iterations, plus at most two a dispatch that
    commit nothing: one that ended in a breakdown and the one the host
    runs while it reads the last check point's flag."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import cg_pipelined_deep

    op, b, xstar = ctx["stencil_case"]
    G = round(op.nrows ** (1 / 3))
    l, rtol, R = _DEEP["depth"], _DEEP["rtol"], _DEEP["replace_every"]
    cg_pipelined_deep(op, b, options=SolverOptions(
        maxits=8, residual_rtol=0.0, pipeline_depth=l))
    _reset_counts()
    res = cg_pipelined_deep(op, b, options=SolverOptions(
        maxits=20000, residual_rtol=rtol, pipeline_depth=l,
        replace_every=R))
    launches = _read_counts(ctx, "deep-stencil")
    rep = _solve_report(res, launches)
    note = res.kernel_note
    fallback = "fell back to classic cg" in note
    ndisp = (None if fallback else int(note.split(", ")[1].split()[0]))
    rep.update(depth=l, replace_every=R, rtol=rtol, dispatches=ndisp,
               fallback=fallback,
               pipelined_iterations=ctx["iterations"]["pipelined-stencil"],
               classic_iterations=ctx["classic_iterations"],
               us_per_iter_pipelined=ctx["us_per_iter"]["pipelined-stencil"],
               host_true_relative_residual=_poisson7_residual(G, res.x, b))
    ok = ((res.operator_format, res.kernel) == ("stencil",
                                                 "cuda-stencil-spmv")
          and res.converged and not fallback
          and rep["host_true_relative_residual"] <= 10 * rtol
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    if ok:
        bodies = launches["stencil_spmv"] - 6 - ndisp * (l + 2)
        rep.update(bodies=bodies, loop=res.loop,
                   graph_captures=res.stats.ncaptures)
        ok = (res.niterations <= bodies <= res.niterations + 2 * ndisp
              and launches["deep_coeffs"] == bodies
              and res.loop == "graph" and "open loop" not in note
              and not any(v for k, v in launches.items()
                          if k not in ("stencil_spmv", "deep_coeffs")))
    if not ok:
        raise SystemExit(f"error: deep-stencil solve failed: {rep}")
    ctx.setdefault("us_per_iter", {})["deep-stencil"] = rep["us_per_iter"]
    ctx.setdefault("iterations", {})["deep-stencil"] = res.niterations
    ctx["profile_cases"] = ctx.get("profile_cases", []) + [
        ("deep-stencil-f64", op, b,
         _with_options(cg_pipelined_deep, pipeline_depth=l,
                       replace_every=R))]
    return rep


def _laplacian_modes(G: int, k: int):
    """The k lowest Dirichlet eigenvectors of the 7-point Laplacian on a
    G^3 grid, unit columns of an (n, k) float64 array: products of sines
    sin(a pi i / (G+1)) sin(b pi j / (G+1)) sin(c pi m / (G+1)), the modes
    (a, b, c) ordered by their eigenvalue (a tie at the k-th broken by
    the modes' order)."""
    import numpy as np

    lam = np.sin(np.arange(1, 5) * np.pi / (2 * G + 2)) ** 2
    modes = sorted(((a, b, c) for a in range(4) for b in range(4)
                    for c in range(4)),
                   key=lambda m: (lam[m[0]] + lam[m[1]] + lam[m[2]], m))[:k]
    i = np.arange(1, G + 1)
    sines = [np.sin((a + 1) * np.pi * i / (G + 1)) for a in range(4)]
    W = np.empty((G ** 3, k))
    for j, (a, b, c) in enumerate(modes):
        w = np.multiply.outer(np.multiply.outer(sines[a], sines[b]),
                              sines[c]).reshape(-1)
        W[:, j] = w / np.linalg.norm(w)
    return W, modes


def _recycled_stencil(ctx, k: int = 8):
    """Deflated CG (``cg_recycled``) on the stencil phase's 256^3 f64
    system, W the k = 8 lowest Dirichlet eigenvectors of the Laplacian in
    closed form, W'AW through the port's operator on the card: certified
    in float64 within 10 x rtol, fewer iterations than the stencil
    phase's, the fused stencil kernel once an iteration and once for the
    initial residual (the deflation is host set-up, outside tsolve)."""
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import cg_recycled

    op, b, xstar = ctx["stencil_case"]
    G = round(op.nrows ** (1 / 3))
    rtol = 1e-8
    t0 = time.perf_counter()
    W, modes = _laplacian_modes(G, k)
    basis_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    AW = np.empty_like(W)
    w = torch.zeros(op.nrows_padded, dtype=torch.float64, device=op.device)
    for j in range(k):
        w[: op.nrows] = torch.from_numpy(W[:, j]).to(op.device)
        AW[:, j] = op.matvec(w)[: op.nrows].cpu().numpy()
    WtAW = W.T @ AW
    del AW, w
    wtaw_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    res = cg_recycled(op, b, W=W, WtAW=WtAW, options=SolverOptions(
        maxits=20000, residual_rtol=rtol))
    wall = time.perf_counter() - t0
    launches = _read_counts(ctx, "recycled-stencil")
    rep = _solve_report(res, launches)
    rep.update(k=k, modes=[list(m) for m in modes],
               ritz_of_WtAW=np.linalg.eigvalsh(WtAW).tolist(),
               basis_seconds=basis_s, wtaw_seconds=wtaw_s,
               deflation_setup_seconds=wall - res.stats.tsolve,
               classic_iterations=ctx["classic_iterations"],
               host_true_relative_residual=_poisson7_residual(G, res.x, b),
               error_vs_manufactured=float(np.linalg.norm(res.x - xstar)))
    del W
    ok = ((res.operator_format, res.kernel) == ("stencil",
                                                 "cuda-stencil-fused")
          and res.converged
          and rep["host_true_relative_residual"] <= 10 * rtol
          and res.niterations < ctx["classic_iterations"]
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    if not ok:
        raise SystemExit(f"error: recycled-stencil solve failed: {rep}")
    _check_launches(rep, launches, "stencil_spmv", res.niterations, False,
                    "recycled-stencil")
    return rep


def _cli_solver_phase(G: int, solver: str, *extra: str):
    """The CLI's ``main`` (``python -m acg_torch.cli``), in this process so
    that no interpreter start is timed, with ``--solver solver`` on the
    48^3 Poisson .mtx from a manufactured solution: exit 0 and a stats
    block; the device solvers launch the stencil kernel without the dot
    and say so in the kernel line, the host solvers launch nothing and
    print none."""
    import contextlib
    import io

    from acg_torch import cli
    from acg_torch.io.mtxfile import MtxFile, write_mtx
    from acg_torch.sparse.poisson import poisson3d_7pt

    A = poisson3d_7pt(G)
    r, c, v = A.to_coo()
    (REPO / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = os.path.join(tmp, "A.mtx")
        write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                                rowidx=r, colidx=c, vals=v))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([path, "--solver", solver, *extra,
                           "--manufactured-solution", "--max-iterations",
                           "2000", "-v", "-q"])
    stats, log = out.getvalue(), err.getvalue()
    launches = _cli_launches(log)
    kernel = [ln.strip() for ln in stats.splitlines()
              if ln.strip().startswith("kernel:")]
    host = solver in ("host", "petsc", "petsc-pipelined")
    ok = (rc == 0 and "total iterations:" in stats
          and "floating-point exceptions: none" in stats
          and launches is not None)
    if ok and host:
        ok = not kernel and not any(launches.values())
    elif ok:
        # the deep solver's note names its dispatches; a fallback to
        # classic CG would name the fused kernel and fail here
        ok = (bool(kernel) and kernel[0].startswith(
            "kernel: cuda-stencil-spmv") and launches["stencil_spmv"] > 0)
    if not ok:
        raise SystemExit(f"error: CLI run failed (exit {rc}):\n{stats}\n"
                         f"{log}")
    its = [ln.split(":")[1].strip() for ln in stats.splitlines()
           if ln.strip().startswith("iterations:")]
    errline = [ln for ln in stats.splitlines()
               if ln.startswith("manufactured solution error")]
    return {"grid": [G, G, G], "solver": solver, "flags": list(extra),
            "exit": rc, "iterations": int(its[0]),
            "launches": launches, "kernel_line": kernel[0] if kernel else None,
            "manufactured_error_line": errline[0] if errline else None,
            "wall_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the unstructured tiers: fem3d-1m, its kernels, solves and CLI


def _fem_setup(points: int, ctx):
    """The configuration fem3d-1m: a shuffled 3-D Delaunay mesh of
    ``points`` points (``fem_delaunay_spd(points, dim=3, seed=0)``, the
    SuiteSparse FEM stand-in of the JAX package's suite), and its two
    operators through ``build_device_operator(fmt="auto")``, built once
    for every later phase: f32 (RCM, then the sgell pack of the permuted
    matrix) and f64 (RCM, then padded ELL on the original ordering).  The
    host seconds of each step, and the card memory each operator holds
    once built, are reported."""
    import numpy as np
    import torch

    from acg_torch.ops.sgell import DeviceSgell
    from acg_torch.ops.spmv import DeviceEll
    from acg_torch.solvers.cg import PermutedOperator, build_device_operator
    from acg_torch.sparse.csr import manufactured_rhs
    from acg_torch.sparse.mesh import fem_delaunay_spd

    t0 = time.perf_counter()
    if "fem_mesh" in ctx:
        A, gen_s = ctx.pop("fem_mesh").get()
    else:
        A, gen_s = fem_delaunay_spd(points, dim=3, seed=0, shuffle=True), None
    waited = time.perf_counter() - t0
    gen_s = waited if gen_s is None else gen_s
    steps, ops, held = {}, {}, {}
    for label, vdt in (("f32", np.float32), ("f64", np.float64)):
        steps[label] = {}
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ops[label] = build_device_operator(A, dtype=vdt, fmt="auto",
                                           timings=steps[label])
        torch.cuda.synchronize()
        steps[label]["total"] = time.perf_counter() - t0
        held[label] = torch.cuda.memory_allocated() - before
    op32, op64 = ops["f32"], ops["f64"]
    if not (isinstance(op32, PermutedOperator)
            and isinstance(op32.dev, DeviceSgell)
            and isinstance(op64, DeviceEll)):
        raise SystemExit(f"error: fmt='auto' routed fem3d-1m to "
                         f"{type(op32).__name__}/{type(op64).__name__}, "
                         "expected rcm+sgell (f32) and ell (f64)")
    xstar, b = manufactured_rhs(A, seed=1)
    ctx["fem"] = {"A": A, "op32": op32, "op64": op64, "xstar": xstar,
                  "b": b}
    sg = op32.dev
    per_tile = torch.diff(sg.tile_start).cpu().numpy()
    return {"points": points, "dim": 3, "n": A.nrows, "nnz": A.nnz,
            "max_row_entries": int(A.rowlens.max()),
            "host_seconds": {"mesh_generation": gen_s,
                             "mesh_wait_in_phase": waited, **steps},
            "setup_seconds": gen_s + sum(v["total"] for v in steps.values()),
            "device_bytes_held": held,
            "sgell": {"S": sg.S, "ntiles": sg.ntiles, "fill": sg.fill,
                      "slots_per_tile": {"mean": float(per_tile.mean()),
                                         "max": int(per_tile.max())},
                      "values": str(sg.vals.dtype)[6:],
                      "lane_indices": str(sg.idx.dtype)[6:],
                      "padded_bytes": sg.padded_bytes(),
                      "sliced": _layout(sg.sliced, 4, "sgell_spmv")},
            "ell": {"nrows_padded": op64.nrows_padded, "width": op64.width,
                    "values": str(op64.vals.dtype)[6:],
                    "padded_bytes": op64.padded_bytes(),
                    "sliced": _layout(op64.sliced, 8, "ell_spmv")}}


def _layout(op, vec_bytes: int, kernel: str,
            xcols: int | None = None) -> dict:
    """What a sliced operator streams (values, columns, slice offsets and
    row order) against the work's bytes: stored entries x (value + 4)
    plus x (its ``xcols`` columns read, ``_work_bytes``) and y at
    ``vec_bytes`` an entry; with the unroll the library of ``kernel``
    was built with."""
    from acg_torch.ops import sliced

    work = _work_bytes(op, vec_bytes, xcols)
    return {"stored_entries": op.nnz, "layout_fill": op.fill,
            "sigma": op.sigma,
            "unroll": sliced.unroll(kernel), "slices": op.nslices,
            "stream_bytes": op.stream_bytes(), "work_bytes": work,
            "stream_over_entries": op.stream_bytes()
            / (op.nnz * (op.vals.element_size() + 4))}


def _work_bytes(op, vec_bytes: int, xcols: int | None = None) -> int:
    """The least bytes a sliced product moves: each stored value and int32
    column once, x read once and y (nrows) written once.  x counts its
    ``xcols`` columns that hold an entry (default all ``ncols``: a
    rectangular operator may read only a few of its columns)."""
    xcols = op.ncols if xcols is None else xcols
    return (op.nnz * (op.vals.element_size() + 4)
            + (xcols + op.nrows) * vec_bytes)


def _torch_csr(A, dtype):
    """A host CSR matrix as a torch sparse CSR matrix on the card (for the
    library yardstick only)."""
    import numpy as np
    import torch

    with warnings.catch_warnings():      # sparse tensors warn they are beta
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(
            torch.from_numpy(A.rowptr.astype(np.int64)),
            torch.from_numpy(A.colidx.astype(np.int64)),
            torch.from_numpy(A.vals).to(dtype), size=(A.nrows, A.ncols)
        ).cuda()


def _padded_x(n, npad, dtype, seed):
    """A random vector on the card, zero past ``n``."""
    import numpy as np
    import torch

    x = torch.zeros(npad, dtype=dtype)
    x[:n] = torch.from_numpy(np.random.default_rng(seed).standard_normal(n))
    return x.cuda()


def _sgell_check(dev, A, tier, ctx):
    """``sgell_spmv`` on ``dev``'s sliced layout against its plain version
    on the pack (uploaded from the host for this check),
    ``sgell_matvec``: bit for bit (and so within 1e-5 of max|y|), timed
    beside cuSPARSE CSR x on ``A``, the same matrix in the same ordering.
    The bound counts the stored entries, not the pack."""
    import torch

    from acg_torch.ops.sgell import sgell_matvec, sgell_spmv
    from acg_torch.ops.sliced import sliced_matvec

    n, op = dev.nrows, dev.sliced
    x = _padded_x(n, dev.nrows_padded, torch.float32, 5)
    Acsr = _torch_csr(A, torch.float32)
    pack = [a.to(x.device) for a in (dev.vals, dev.idx, dev.seg,
                                     dev.tile_start)]

    def run():
        return sgell_spmv(op, x)

    def plain():
        return sgell_matvec(*pack, x)

    def bits(row):
        y = run()
        row["bits_equal_plain"] = bool(torch.equal(y, plain()))
        row["bits_equal_sliced_matvec"] = bool(torch.equal(
            y, sliced_matvec(op, x)))
        row["library_max_abs_err"] = float((Acsr @ x[:n] - y[:n]).abs().max())
        return row["bits_equal_plain"] and row["bits_equal_sliced_matvec"]

    _check_kernel({"name": "sgell_spmv", "tier": tier, "S": dev.S,
                   "fill": dev.fill, "values": str(dev.vals.dtype)[6:],
                   "padded_bytes": dev.padded_bytes(),
                   **_layout(op, 4, "sgell_spmv")},
                  run, plain, x, ctx, _work_bytes(op, 4), 2 * op.nnz,
                  lambda: Acsr @ x[:n], extra=bits, tol=(1e-5, 0.0, None))


def _ell_check(dev, A, tier, ctx):
    """``ell_spmv`` on ``dev``'s sliced layout against its plain version
    on the rectangle (uploaded from the host for this check),
    ``ell_matvec`` (1e-5 of max|y| at f32, 1e-13 at f64), and bit for bit
    against ``sliced_matvec`` (each row summed in lane order), timed
    beside cuSPARSE CSR x on ``A``."""
    import torch

    from acg_torch.ops.sliced import sliced_matvec
    from acg_torch.ops.spmv import ell_matvec, ell_spmv

    vdt = getattr(torch, dev.vec_dtype)
    n, op = dev.nrows, dev.sliced
    x = _padded_x(n, dev.nrows_padded, vdt, 6)
    Acsr = _torch_csr(A, vdt)
    vals, cols = dev.vals.to(x.device), dev.colidx.to(x.device)

    def run():
        return ell_spmv(op, x)

    def plain():
        return ell_matvec(vals, cols, x)

    def bits(row):
        y = run()
        row["bits_equal_sliced_matvec"] = bool(torch.equal(
            y, sliced_matvec(op, x)))
        row["library_max_abs_err"] = float((Acsr @ x[:n] - y[:n]).abs().max())
        return row["bits_equal_sliced_matvec"]

    word = x.element_size()
    _check_kernel({"name": "ell_spmv", "tier": tier, "width": dev.width,
                   "values": str(dev.vals.dtype)[6:],
                   "padded_bytes": dev.padded_bytes(),
                   **_layout(op, word, "ell_spmv")},
                  run, plain, x, ctx, _work_bytes(op, word), 2 * op.nnz,
                  lambda: Acsr @ x[:n], extra=bits,
                  tol=(1e-5 if vdt == torch.float32 else 1e-13, 0.0, None))


def _unstructured_kernels(ctx):
    """The two unstructured kernels: sgell_spmv on the fem3d-1m f32
    operator (RCM ordering), ell_spmv on the fem3d-1m f64 operator, on
    an f32 ELL build of the same matrix and on an f32 ELL build of the
    RCM-ordered matrix that sgell_spmv runs on (the fill gate's question:
    is sgell slower than ELL on the same matrix?), and the bf16-value
    tiers of both on a randomly permuted 64^3 Poisson operator (values
    bf16-exact, so ``mat_dtype="auto"`` stores them as bf16)."""
    import numpy as np
    import torch

    from acg_torch.solvers.cg import build_device_operator
    from acg_torch.sparse.poisson import poisson3d_7pt
    from acg_torch.sparse.rcm import permute_symmetric

    fem = ctx["fem"]
    A, op32, op64 = fem["A"], fem["op32"], fem["op64"]
    Ap = permute_symmetric(A, op32.perm)
    _sgell_check(op32.dev, Ap, "f32/f32 fem3d-1m", ctx)
    _ell_check(op64, A, "f64/f64 fem3d-1m", ctx)
    ell32 = build_device_operator(A, dtype=np.float32, fmt="ell")
    _ell_check(ell32, A, "f32/f32 fem3d-1m", ctx)
    ell32 = build_device_operator(Ap, dtype=np.float32, fmt="ell")
    _ell_check(ell32, Ap, "f32/f32 fem3d-1m RCM", ctx)
    del ell32, Ap
    P = poisson3d_7pt(64)
    P = permute_symmetric(P, np.random.default_rng(0).permutation(P.nrows))
    for vdt, fmt in ((np.float32, "sgell"), (np.float32, "ell"),
                     (np.float64, "ell")):
        dev = build_device_operator(P, dtype=vdt, fmt=fmt)
        if dev.vals.dtype != torch.bfloat16:
            raise SystemExit(f"error: the permuted Poisson {fmt} operator "
                             f"stored {dev.vals.dtype}, expected bf16")
        tier = f"bf16/f{np.dtype(vdt).itemsize * 8} permuted poisson 64^3"
        check = _sgell_check if fmt == "sgell" else _ell_check
        check(dev, P, tier, ctx)
        del dev
    torch.cuda.empty_cache()


def _host_true_residual(A, x, b) -> float:
    """||b - A x|| / ||b|| in float64 on the host, in the caller's
    ordering."""
    import numpy as np

    x = np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(b - A.matvec(x)) / np.linalg.norm(b))


_FEM_RTOL = {"sgell": 1e-6, "ell": 1e-8}
# f32 pipelined / classic iteration counts on this mesh family at rtol 1e-6:
# the outer limits of the ratios scripts/torch_pipelined_drift.py measured
# in the JAX package and in the port on the CPU (3-D meshes of 2,000 to
# 256,000 points, three seeds each, the sgell and ELL tiers)
_F32_PIPE_RATIO = (1.15, 1.28)


def _fem_solve(ctx, tier: str, pipelined: bool = False):
    """Classic (or pipelined) CG on fem3d-1m through ``fmt="auto"``'s
    operator: f32 through RCM + sgell at rtol 1e-6, or f64 through ELL at
    rtol 1e-8, from a manufactured solution.  The true residual is
    recomputed in the caller's ordering from the original CSR in float64
    on the host.  Classic: the SpMV kernel ran once per SpMV of the solve
    (the initial residual and one per iteration) and no other kernel ran.
    Pipelined (the open-coded body): every exit certified; at f64 the
    count within 1 of classic's.  At f32 near the f32 floor the
    pipelined recurrences drift and certification refuses exit
    candidates, so the count is held to classic's times the measured
    ratios ``_F32_PIPE_RATIO``, give or take one."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import cg, cg_pipelined

    fem = ctx["fem"]
    A, b, xstar = fem["A"], fem["b"], fem["xstar"]
    op = fem["op32"] if tier == "sgell" else fem["op64"]
    fmt, kernel = (("rcm+sgell", "sgell_spmv") if tier == "sgell"
                   else ("ell", "ell_spmv"))
    phase = ("pipelined-" if pipelined else "") + f"fem-{tier}"
    solve = cg_pipelined if pipelined else cg
    rtol = _FEM_RTOL[tier]
    solve(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    _reset_counts()
    res = solve(op, b, options=SolverOptions(maxits=20000,
                                             residual_rtol=rtol))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    rep["rtol"] = rtol
    rep["true_relative_residual"] = _host_true_residual(A, res.x, b)
    rep["error_vs_manufactured"] = float(np.linalg.norm(
        res.x.astype(np.float64) - xstar))
    # classic CG's update and |r|^2: one cg_update launch an iteration
    others = {k: v for k, v in launches.items()
              if k not in (kernel, "cg_update") and v}
    ok = ((res.operator_format, res.kernel, res.kernel_note)
          == (fmt, f"cuda-{tier}-spmv", "") and res.converged
          and rep["true_relative_residual"] <= 10 * rtol
          and np.all(np.isfinite(res.x)) and res.x.shape == (A.nrows,)
          and not others and launches["cg_update"]
          == (0 if pipelined else res.niterations))
    key = f"fem-{tier}"
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    if pipelined:
        classic = ctx["iterations"][key]
        rep["classic_iterations"] = classic
        lo, hi = (1.0, 1.0) if tier == "ell" else _F32_PIPE_RATIO
        rep["allowed_iterations"] = [math.ceil(lo * classic) - 1,
                                     math.floor(hi * classic) + 1]
        ok = ok and (rep["allowed_iterations"][0] <= res.niterations
                     <= rep["allowed_iterations"][1]) and (
            launches[kernel] >= res.niterations + 2)
    else:
        ok = ok and launches[kernel] == res.niterations + 1
        ctx.setdefault("iterations", {})[key] = res.niterations
        ctx["profile_cases"] = ctx.get("profile_cases", []) + [
            (f"fem-{tier}-{op.vec_dtype}", op, b, solve)]
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    return rep


def _scrambled_tridiag(n: int, seed: int = 7):
    """An SPD tridiagonal (4 on the diagonal, -1 beside it) under a random
    symmetric scramble: its own ordering has no diagonal structure, RCM
    recovers the band (the JAX package's tests/test_dia.py case)."""
    import numpy as np

    from acg_torch.sparse.csr import coo_to_csr
    from acg_torch.sparse.rcm import permute_symmetric

    i = np.arange(n - 1)
    r = np.r_[np.arange(n), i, i + 1]
    c = np.r_[np.arange(n), i + 1, i]
    v = np.r_[np.full(n, 4.0), np.full(n - 1, -1.0), np.full(n - 1, -1.0)]
    A = coo_to_csr(r, c, v, n, n)
    return permute_symmetric(A, np.random.default_rng(seed).permutation(n))


def _rcm_dia_phase(n: int, ctx):
    """The scrambled tridiagonal of ``n`` rows, f64, through
    ``fmt="auto"``: RCM recovers the band, so the operator is DIA in the
    RCM ordering (``rcm+dia``), whose classic loop runs the fused DIA
    kernel and whose pipelined loop the single-kernel iteration.  x comes
    back in the caller's ordering: the true residual is recomputed there
    on the host."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.ops.dia import DeviceDia, dia_efficiency
    from acg_torch.solvers.cg import (PermutedOperator,
                                      build_device_operator)
    from acg_torch.sparse.csr import manufactured_rhs

    t0 = time.perf_counter()
    A = _scrambled_tridiag(n)
    gen_s = time.perf_counter() - t0
    steps = {}
    t0 = time.perf_counter()
    op = build_device_operator(A, dtype=np.float64, fmt="auto",
                               timings=steps)
    steps["total"] = time.perf_counter() - t0
    if not (isinstance(op, PermutedOperator)
            and isinstance(op.dev, DeviceDia)):
        raise SystemExit(f"error: rcm-dia routed to {type(op).__name__}")
    xstar, b = manufactured_rhs(A, seed=3)
    out = {"n": n, "dia_efficiency_given_ordering": dia_efficiency(A),
           "host_seconds": {"generation": gen_s, **steps},
           "bands": list(op.offsets)}
    for pipelined in (False, True):
        solve, _ = _solver(pipelined)
        body, loop_kernel, eager = _dia_names(op, pipelined)
        phase = "rcm-dia" + ("-pipelined" if pipelined else "")
        _reset_counts()
        res = solve(op, b, options=SolverOptions(maxits=20000,
                                                 residual_rtol=1e-8))
        launches = _read_counts(ctx, phase)
        rep = _solve_report(res, launches)
        rep["plan"] = _plan_info(op.dev)
        rep["true_relative_residual"] = _host_true_residual(A, res.x, b)
        rep["error_vs_manufactured"] = float(np.linalg.norm(res.x - xstar))
        ok = ((res.operator_format, res.kernel)
              == ("rcm+dia", f"cuda-dia-{body}") and res.converged
              and rep["true_relative_residual"] <= 1e-7
              and rep["error_vs_manufactured"] <= 1e-6
              and res.x.shape == (n,))
        if not ok:
            raise SystemExit(f"error: {phase} solve failed: {rep}")
        _check_launches(rep, launches, loop_kernel, res.niterations,
                        pipelined, phase, eager=eager)
        out["pipelined" if pipelined else "classic"] = rep
    return out


def _batched_fem(nrhs: int, ctx):
    """B = ``nrhs`` manufactured solutions (seeds 0..B-1) on the fem3d-1m
    f32 operator (RCM + sgell) in one classic loop: the sgell kernel runs
    once per system per SpMV, so each system's count must equal its own
    one-system solve, run here."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import cg
    from acg_torch.sparse.csr import manufactured_rhs

    fem = ctx["fem"]
    A, op = fem["A"], fem["op32"]
    xstar, b = (np.stack(v) for v in zip(
        *(manufactured_rhs(A, seed=s) for s in range(nrhs))))
    opts = SolverOptions(maxits=20000, residual_rtol=_FEM_RTOL["sgell"])
    _reset_counts()
    res = cg(op, b, options=opts)
    launches = _read_counts(ctx, "batched-fem-sgell")
    rep = _solve_report(res, launches)
    rep["true_relative_residual"] = [_host_true_residual(A, res.x[s], b[s])
                                     for s in range(nrhs)]
    one = [cg(op, b[s], options=opts) for s in range(nrhs)]
    rep["one_system_iterations"] = [r.niterations for r in one]
    rep["us_per_iter_one_system"] = ctx["us_per_iter"].get("fem-sgell")
    ok = ((res.operator_format, res.kernel) == ("rcm+sgell",
                                                "cuda-sgell-spmv")
          and res.converged and all(res.converged_per_system)
          and list(res.iterations_per_system) == rep["one_system_iterations"]
          and max(rep["true_relative_residual"]) <= 10 * _FEM_RTOL["sgell"]
          and res.x.shape == b.shape and np.all(np.isfinite(res.x))
          and launches["sgell_spmv"] == nrhs * (res.niterations + 1))
    if not ok:
        raise SystemExit(f"error: batched-fem-sgell solve failed: {rep}")
    return rep


def _cli_fem_phase(points: int):
    """The CLI's ``main`` (in this process) on a shuffled 3-D mesh .mtx of
    ``points`` points, at f32 (auto: RCM + sgell) and at f64 (auto: ELL):
    exit 0, the stats block names the tier and kernel, and the -v launch
    line shows the kernel ran."""
    from acg_torch.io.mtxfile import MtxFile, write_mtx
    from acg_torch.sparse.mesh import fem_delaunay_spd

    A = fem_delaunay_spd(points, dim=3, seed=2)
    r, c, v = A.to_coo()
    out = {"points": points, "n": A.nrows, "nnz": A.nnz}
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = os.path.join(tmp, "mesh.mtx")
        write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                                rowidx=r, colidx=c, vals=v))
        for dtype, rtol, fmt, kernel in (
                ("float32", "1e-6", "rcm+sgell", "sgell_spmv"),
                ("float64", "1e-9", "ell", "ell_spmv")):
            rc, stats, log = _cli_main(
                [path, "--dtype", dtype, "--residual-rtol", rtol,
                 "--manufactured-solution", "--max-iterations", "2000",
                 "-v", "-q"])
            launches = _cli_launches(log)
            tier = fmt.split("+")[-1]
            ok = (rc == 0
                  and f"operator format: {fmt}\n" in stats
                  and f"kernel: cuda-{tier}-spmv\n" in stats
                  and "floating-point exceptions: none" in stats
                  and launches is not None and launches[kernel] > 0)
            if not ok:
                raise SystemExit(f"error: CLI run failed (exit {rc}):\n"
                                 f"{stats}\n{log}")
            its = [ln.split(":")[1].strip() for ln in stats.splitlines()
                   if ln.strip().startswith("iterations:")]
            out[dtype] = {"exit": rc,
                          "iterations": int(its[0]) if its else None,
                          "operator_line": [
                              ln.strip() for ln in log.splitlines()
                              if ln.startswith("operator:")],
                          "launches": launches}
    return out


# ---------------------------------------------------------------------------
# the HBM tier: x past the card's L2, the ring and clustered-window kernels


def _hbm_check(dev, tier, x, ctx, resident_row=False, planned=True,
               with_dot=True):
    """The planned HBM kernel of ``dev`` (its ``plan``: ring or windows)
    with the fused dot (or without, ``with_dot=False``: the s-step
    basis), held against its plain version, y bit-equal to ``dia_spmv``
    on the same operator, the dot's bits stable; timed beside the bound,
    the plain version, ``dia_spmv`` and cuSPARSE CSR x on the same
    matrix.  ``resident_row``: ``dia_spmv`` with the dot on the same
    operator gets a row of its own beside it.  ``planned``: whether the
    operator's own plan takes this kernel (else the row runs it on a plan
    made for it, ``_forced``)."""
    import torch

    from acg_torch.ops.dia_kernels import (dia_matvec_ring_plain,
                                           dia_matvec_windows_plain,
                                           dia_spmv, dia_spmv_ring,
                                           dia_spmv_windows)

    plan = dev.plan
    ring = plan.kind == "hbm-ring"
    name = "dia_spmv_ring" if ring else "dia_spmv_windows"
    spmv = dia_spmv_ring if ring else dia_spmv_windows
    plain_y = dia_matvec_ring_plain if ring else dia_matvec_windows_plain
    n, D_, vb = dev.nrows, len(dev.offsets), x.element_size()

    def run():
        return spmv(dev.bands, dev.scales, dev.offsets_t, x, plan,
                    with_dot=with_dot)

    def plain():
        y = plain_y(dev.bands, dev.offsets, x, dev.scales, plan)
        return (y, torch.dot(x, y)) if with_dot else y

    def resident():
        return dia_spmv(dev.bands, dev.scales, dev.offsets_t, x,
                        with_dot=with_dot, fixed=dev.fixed)

    def y_of(out):
        return out[0] if with_dot else out

    def extra(row):
        row["bits_equal_dia_spmv"] = bool(torch.equal(y_of(run()),
                                                      y_of(resident())))
        row["dia_spmv_ms"] = _time_ms(resident, ctx["reps"])
        return row["bits_equal_dia_spmv"]

    A = _csr_of(dev, x.dtype)
    nbytes = (D_ * dev.nrows_padded * dev.mat_itemsize
              + 2 * dev.nrows_padded * vb)
    label = {"name": name, "tier": tier, "with_dot": with_dot, "n": n,
             "plan": {"tile": plan.tile, "nblocks": plan.nblocks,
                      "smem": plan.smem, "ntiles": plan.ntiles,
                      "planned": planned, "stages": plan.stages,
                      **({"span": [plan.lo, plan.hi]} if ring else
                         {"clusters": plan.nclusters,
                          "buflen": plan.buflen})}}
    # the plain versions walk the tiles from Python (the ring one step of
    # the persistent grid at a time): five timed runs
    _check_kernel(label, run, plain, x, ctx, nbytes,
                  2 * D_ * n + (2 * n if with_dot else 0),
                  lambda: A @ x[:n], extra=extra, plain_reps=5)
    if resident_row:
        from acg_torch.ops.dia_kernels import dia_matvec

        def plain_resident():
            y = dia_matvec(dev.bands, dev.offsets, x, dev.scales)
            return y, torch.dot(x, y)

        _check_kernel({"name": "dia_spmv", "tier": tier, "with_dot": True,
                       "n": n}, resident, plain_resident, x, ctx, nbytes,
                      2 * D_ * n + 2 * n, lambda: A @ x[:n], plain_reps=5)
    del A
    torch.cuda.empty_cache()


def _hbm_kernels(D, ctx):
    """Both HBM kernels at the shapes their paths give them: the windows
    kernel at 256^3 (the bands/vectors tiers bf16/f32, int8/f32 and, on
    a plan made for it, f64/f64, which the plan sends to ``dia_spmv``),
    on the 464^3 operator (bf16/f32, and bf16 bands with f64 vectors)
    and on the 10,000^2 2-D operator (bf16/f32, on a plan made for it);
    the ring on 10,000^2 (bf16/f32 as planned, f64/f64 on a plan made
    for it, which the plan sends to ``dia_spmv``).  ``dia_spmv`` keeps
    its resident path at 128^3 and gets a row of its own at 464^3."""
    import numpy as np
    import torch

    from acg_torch.ops.dia import DeviceDia
    from acg_torch.ops.dia_kernels import dia_matvec, dia_spmv
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    # dia_spmv on bench.py's 128^3, the resident path of dia-bf16-128
    D128 = poisson3d_7pt_dia(128, dtype=np.float32)
    dev = DeviceDia.from_dia(D128, dtype="float32")
    if dev.kind != "resident":
        raise SystemExit(f"error: 128^3 f32 planned {dev.kind}")
    x = _padded_x(D128.nrows, dev.nrows_padded, torch.float32, 8)
    A = _csr_of(dev, torch.float32)
    n = dev.nrows
    _check_kernel({"name": "dia_spmv", "tier": "bf16/f32 128^3",
                   "with_dot": True},
                  lambda: dia_spmv(dev.bands, dev.scales, dev.offsets_t, x,
                                   with_dot=True, fixed=dev.fixed),
                  lambda: (lambda y: (y, torch.dot(x, y)))(
                      dia_matvec(dev.bands, dev.offsets, x, dev.scales)),
                  x, ctx, 7 * n * dev.mat_itemsize + 2 * n * 4,
                  2 * 7 * n + 2 * n, lambda: A @ x)
    del dev, x, A, D128
    # the plan: windows for the narrow bands, dia_spmv for f64 bands
    for tier, vdt, mat, kind in (("bf16/f32", "float32", "auto", "hbm"),
                                 ("int8/f32", "float32", "int8", "hbm"),
                                 ("f64/f64", "float64", None, "resident")):
        dev = DeviceDia.from_dia(D, dtype=vdt, mat_dtype=mat)
        if dev.kind != kind:
            raise SystemExit(f"error: 256^3 {tier} planned {dev.kind}")
        x = _padded_x(D.nrows, dev.nrows_padded, getattr(torch, vdt), 9)
        _hbm_check(_forced(dev, "hbm"), f"{tier} 256^3", x, ctx,
                   planned=kind == "hbm")
        if tier == "bf16/f32":
            # without the dot: the s-step basis of sstep-dia-bf16
            _hbm_check(dev, f"{tier} 256^3", x, ctx, with_dot=False)
        del dev, x
    big = ctx["p464"]["op"]
    for vdt in (torch.float32, torch.float64):
        dev = (big if vdt == torch.float32 else _with_vectors(big,
                                                              "float64"))
        if dev.kind != "hbm":
            raise SystemExit(f"error: 464^3 {vdt} planned {dev.kind}")
        x = _padded_x(dev.nrows, dev.nrows_padded, vdt, 10)
        _hbm_check(dev, f"bf16/f{x.element_size() * 8} 464^3", x, ctx,
                   resident_row=vdt == torch.float32)
        del dev, x
    # 10,000^2: the plan takes the ring at bf16/f32 and dia_spmv at
    # f64/f64 (the ring's row there on a plan made for it); the windows
    # kernel keeps its bf16/f32 row on a plan made for it
    p2d = ctx["p2d"]["op"]
    for tier, dev, kind in (("bf16/f32", p2d, "hbm-ring"),
                            ("f64/f64", DeviceDia.from_dia(
                                ctx["p2d"]["D"], dtype="float64",
                                mat_dtype=None), "resident")):
        if dev.kind != kind:
            raise SystemExit(f"error: 10,000^2 {tier} planned {dev.kind}")
        x = _padded_x(dev.nrows, dev.nrows_padded,
                      getattr(torch, dev.vec_dtype), 11)
        _hbm_check(_forced(dev, "hbm-ring"), f"{tier} 10000^2", x, ctx,
                   planned=kind == "hbm-ring")
        if kind == "hbm-ring":
            _hbm_check(_forced(dev, "hbm"), f"{tier} 10000^2", x, ctx,
                       planned=False)
        del dev, x
    del ctx["p2d"]["D"]
    torch.cuda.empty_cache()


def _with_vectors(op, vec_dtype):
    """The same band storage on the card, with vectors of ``vec_dtype``
    (planned anew for them)."""
    from acg_torch.ops.dia import DeviceDia

    return DeviceDia.from_bands(op.bands, op.scales, op.offsets, op.nrows,
                                op.ncols, op.nnz, vec_dtype)


def _forced(dev, kind: str):
    """``dev`` with a plan of ``kind`` ("hbm" or "hbm-ring") at that
    kernel's own tile on this card, where the operator's plan takes
    another kernel: the kernel keeps its row and its phase (the windows
    on 10,000^2, which plans the ring; the ring on the 3-D operators'
    +-nx*ny spans, where it does not fit, is never forced)."""
    import torch

    from acg_torch.ops import dia_plan

    if dev.kind == kind:
        return dev
    b = dia_plan.device_budgets(dev.device)
    vdt = getattr(torch, dev.vec_dtype)
    pick = dia_plan.windows_plan if kind == "hbm" else dia_plan.ring_plan
    tile = pick(dev.nrows_padded, dev.offsets, vdt, dev.bands.dtype, b)
    return dataclasses.replace(dev, plan=dia_plan.make_plan(
        kind, tile, dev.nrows_padded, dev.offsets, vdt, dev.bands.dtype, b,
        device=dev.device))


def _p3d_big_setup(G: int, ctx):
    """The north-star operator, 7-point Poisson on G^3 (464^3 =
    99,897,344 unknowns, the JAX package's p3d-464-100M configuration),
    built directly in band form and through ``build_device_operator(
    fmt="dia")``: bf16 bands (exact), f32 vectors, planned past the L2
    onto the windows kernel.  Kept on the card for the kernels, dia-100m
    and profile phases; the host bands are freed."""
    import numpy as np
    import torch

    from acg_torch.solvers.cg import build_device_operator
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    t0 = time.perf_counter()
    D = poisson3d_7pt_dia(G, dtype=np.float32)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = build_device_operator(D, dtype=np.float32, fmt="dia")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    if op.bands.dtype != torch.bfloat16 or op.kind != "hbm":
        raise SystemExit(f"error: {G}^3 stored {op.bands.dtype} planned "
                         f"{op.kind}, expected bf16 on the windows kernel")
    ctx["p464"] = {"op": op, "setup_seconds": gen_s + up_s}
    del D
    return {"grid": [G, G, G], "n": op.nrows, "nnz": op.nnz,
            "offsets": list(op.offsets), "plan": op.kind,
            "tile": op.plan.tile, "clusters": op.plan.nclusters,
            "nblocks": op.plan.nblocks, "smem_bytes": op.plan.smem,
            "host_seconds": {"bands": gen_s, "check_cast_upload": up_s}}


def _poisson2d_dia(nx: int):
    """The 5-point 2-D Poisson operator on an nx x nx grid (diagonal 4,
    neighbours -1, Dirichlet), built directly in band form: offsets -nx,
    -1, 0, 1, nx.  Equal to ``DiaMatrix.from_csr(poisson2d_5pt(nx))``
    without its 5 n entries of COO/CSR churn on the host."""
    import numpy as np

    from acg_torch.ops.dia import DiaMatrix

    n = nx * nx
    nrp = -(-n // 8) * 8
    col = np.arange(n) % nx
    bands = np.zeros((5, nrp), dtype=np.float32)
    bands[0, nx:n] = -1.0
    bands[1, :n] = np.where(col > 0, -1.0, 0.0)
    bands[2, :n] = 4.0
    bands[3, :n] = np.where(col < nx - 1, -1.0, 0.0)
    bands[4, : n - nx] = -1.0
    del col
    return DiaMatrix(n, n, (-nx, -1, 0, 1, nx), bands,
                     int(np.count_nonzero(bands)))


def _p2d_setup(nx: int, ctx):
    """The 2-D 5-point Poisson at nx^2 = 10^8 unknowns (the JAX
    package's p2d family at the 100M-DOF scale) in band form, through
    ``build_device_operator(fmt="dia")``: bf16 bands, f32 vectors,
    planned onto the ring kernel, as the JAX package plans it (PERF.md:
    the redesigned ring runs ahead of the windows there).  The host
    bands are kept for the f64 kernel rows, then freed."""
    import numpy as np
    import torch

    from acg_torch.solvers.cg import build_device_operator

    t0 = time.perf_counter()
    D = _poisson2d_dia(nx)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = build_device_operator(D, dtype=np.float32, fmt="dia")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    if op.bands.dtype != torch.bfloat16 or op.kind != "hbm-ring":
        raise SystemExit(f"error: {nx}^2 stored {op.bands.dtype} planned "
                         f"{op.kind}, expected bf16 on the ring kernel")
    ctx["p2d"] = {"op": op, "D": D}
    return {"grid": [nx, nx], "n": op.nrows, "nnz": op.nnz,
            "plan": _plan_info(op), "windows": _plan_info(_forced(op,
                                                                  "hbm")),
            "host_seconds": {"bands": gen_s, "check_cast_upload": up_s}}


def _iteration_bound_us(op, ctx) -> float:
    """The least time of one classic-CG iteration on the card: the SpMV's
    bytes (bands at their storage width, x read and y written once) and
    ten vector passes (the updates and dots), over the memory rate."""
    import torch

    vb = torch.empty((), dtype=getattr(torch, op.vec_dtype)).element_size()
    n = op.nrows_padded
    nbytes = len(op.offsets) * n * op.mat_itemsize + 2 * n * vb
    return (nbytes + 10 * n * vb) / ctx["mem_bw"] * 1e6


def _dia_100m_solve(ctx, vec_dtype: str):
    """Classic CG on the 464^3 operator (scripts/check_100m_convergence.py
    on the card): b = A x* for x* = default_rng(464).standard_normal(n),
    rtol 1e-4 at f32 vectors (maxits 1500) and 1e-8 at f64 vectors with
    the same bf16 bands (maxits 40 x the f32 count: four more decades,
    at the slower rate of the smooth components that a rough x* leaves
    for last).  The loop and the
    initial residual go through the windows kernel, once per SpMV; the
    true residual is certified with the plain ``dia_matvec`` on the card
    in float64 (< 3e-4, the script's bar, at f32; < 1e-7 at f64)."""
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.ops.dia_kernels import dia_matvec
    from acg_torch.solvers.cg import cg

    big = ctx["p464"]
    op32 = big["op"]
    f64 = vec_dtype == "float64"
    phase = "dia-100m-f64" if f64 else "dia-100m"
    op = _with_vectors(op32, "float64") if f64 else op32
    n = op.nrows_padded
    xstar = torch.from_numpy(np.random.default_rng(464).standard_normal(
        n)).cuda()
    b64 = dia_matvec(op.bands, op.offsets, xstar, op.scales)
    del xstar
    b = b64.to(getattr(torch, vec_dtype))
    rtol = 1e-8 if f64 else 1e-4
    maxits = 40 * ctx["iterations"]["dia-100m"] if f64 else 1500
    cg(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    _reset_counts()
    res = cg(op, b, options=SolverOptions(maxits=maxits,
                                          residual_rtol=rtol))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    x = torch.from_numpy(res.x).cuda().double()
    r = b64 - dia_matvec(op.bands, op.offsets, x, op.scales)
    cert = float(torch.linalg.norm(r) / torch.linalg.norm(b64))
    del x, r
    bound = _iteration_bound_us(op, ctx)
    rep.update(rtol=rtol, maxits=maxits, true_relative_residual=cert,
               plan=_plan_info(op), iteration_bound_us=bound,
               us_per_iter_over_bound=rep["us_per_iter"] / bound,
               host_setup_seconds=big["setup_seconds"])
    its = res.niterations
    ok = ((res.operator_format, res.kernel) == ("dia", "cuda-dia-hbm")
          and res.converged and cert < (1e-7 if f64 else 3e-4)
          and res.x.shape == (op.nrows,) and np.all(np.isfinite(res.x)))
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    _check_launches(rep, launches, "dia_spmv_windows", its, False, phase,
                    eager="dia_spmv_windows")
    ctx.setdefault("iterations", {})[phase] = its
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    if not f64:
        ctx["profile_cases"] = ctx.get("profile_cases", []) + [
            ("dia-100m-f32", op, b.cpu().numpy(), cg)]
    del op, b, b64
    torch.cuda.empty_cache()
    return rep


def _p2d_solve(iters: int, ctx, windows: bool):
    """Classic CG on the 10^8-unknown 2-D operator for ``iters`` fixed
    iterations (every criterion off, the bench protocol), from b = A x*
    for x* = default_rng(10_000).standard_normal(n): the loop runs the
    operator's planned kernel (phase p2d: the ring), or with ``windows``
    the windows kernel on a plan made for it (phase p2d-windows, last: it
    frees the operator).  The true residual ||b - A x|| (float64, plain
    ``dia_matvec`` on the card) must agree with the recurrence's ||r||
    to within the rounding drift of f32 CG, iters * 2^-24 * (8 ||x|| +
    ||b||) (8 bounds ||A|| for the 5-point operator with diagonal 4)."""
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.ops.dia_kernels import dia_matvec
    from acg_torch.solvers.cg import cg

    phase = "p2d-windows" if windows else "p2d"
    op = ctx["p2d"]["op"]
    if windows:
        op = _forced(op, "hbm")
    kind = op.kind
    n = op.nrows_padded
    xstar = torch.from_numpy(np.random.default_rng(10_000).standard_normal(
        n)).cuda()
    b64 = dia_matvec(op.bands, op.offsets, xstar, op.scales)
    del xstar
    b = b64.float()
    cg(op, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    _reset_counts()
    res = cg(op, b, options=SolverOptions(maxits=iters, residual_rtol=0.0))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    x = torch.from_numpy(res.x).cuda().double()
    true = float(torch.linalg.norm(b64 - dia_matvec(op.bands, op.offsets,
                                                    x, op.scales)))
    drift = iters * 2.0 ** -24 * (8 * float(torch.linalg.norm(x))
                                  + float(torch.linalg.norm(b64)))
    del x
    bound = _iteration_bound_us(op, ctx)
    rep.update(true_residual=true, recurrence_residual=res.rnrm2,
               residual_gap=abs(true - res.rnrm2), drift_allowed=drift,
               relative_residual_bnorm=true / float(torch.linalg.norm(b64)),
               plan=_plan_info(op), iteration_bound_us=bound,
               us_per_iter_over_bound=rep["us_per_iter"] / bound)
    ok = ((res.operator_format, res.kernel) == ("dia", f"cuda-dia-{kind}")
          and kind == ("hbm" if windows else "hbm-ring")
          and res.niterations == iters and np.all(np.isfinite(res.x))
          and abs(true - res.rnrm2) <= drift
          and true < float(torch.linalg.norm(b64)))
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    kernel = _DIA_ONE_VECTOR[kind]
    _check_launches(rep, launches, kernel, iters, False, phase,
                    eager=kernel)
    if windows:
        del ctx["p2d"]
    del op, b, b64
    torch.cuda.empty_cache()
    return rep


# ---------------------------------------------------------------------------
# the distributed path: cg_dist over 4 shards sharing the one card


def _csr_from_dia(D):
    """The host CSR of a DIA matrix: rows in order, each row's entries in
    ascending column order (the offsets are sorted), zeros dropped; for
    7-point Poisson exactly ``poisson3d_7pt``'s matrix, made without its
    COO sort of 116 M entries."""
    import numpy as np

    from acg_torch.sparse.csr import CsrMatrix

    n = D.nrows
    bands = D.bands[:, :n]
    keep = (bands != 0).T                       # (n, D): row-major entries
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(1), out=rowptr[1:])
    cols = (np.arange(n, dtype=np.int64)[:, None]
            + np.asarray(D.offsets, dtype=np.int64)[None, :])
    colidx = cols[keep].astype(np.int32)
    del cols
    return CsrMatrix(n, n, rowptr, colidx, bands.T[keep])


def _dist_setup(G: int, nparts: int, ctx):
    """The distributed cell: 7-point Poisson G^3 (f64) as a host CSR,
    partitioned into ``nparts`` by ``partition_graph`` (auto: grid blocks),
    split by ``partition_system`` (band order) and built onto
    ``["cuda:0"] * nparts`` by ``build_sharded`` (auto: the matrix-free
    stencil a shard, the interface ELL over ghost slots, the put+signal
    halo state), host seconds of every step.  The same partitioned system
    is built again at f32 vectors with bf16 DIA bands (fmt="dia") for
    dist-dia-bf16."""
    import numpy as np
    import torch

    from acg_torch.parallel.sharded import ShardedSystem
    from acg_torch.partition.graph import partition_system
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.solvers.cg_dist import build_sharded
    from acg_torch.sparse.poisson import poisson3d_7pt_dia

    steps = {}
    t0 = time.perf_counter()
    A = _csr_from_dia(poisson3d_7pt_dia(G))
    steps["csr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    part = partition_graph(A, nparts)
    steps["partition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ps = partition_system(A, part, local_order="band")
    steps["partition_system"] = time.perf_counter() - t0
    del A
    devices = ["cuda:0"] * nparts
    t0 = time.perf_counter()
    ss = build_sharded(ps, devices=devices, dtype=np.float64, method="rdma",
                       timings=steps)
    torch.cuda.synchronize()
    steps["build_sharded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ss_dia = ShardedSystem.build(ps, "dia", ss.local_ops[0].spec.offsets,
                                 devices=devices, dtype=np.float32,
                                 method="rdma", forced=True)
    torch.cuda.synchronize()
    dia_s = time.perf_counter() - t0
    if ss.local_fmt != "stencil" or ss_dia.local_ops[0].bands.dtype != \
            torch.bfloat16:
        raise SystemExit(f"error: dist-setup built {ss.local_fmt} shards "
                         f"and {ss_dia.local_ops[0].bands.dtype} bands, "
                         "expected the stencil and bf16")
    ctx["dist"] = {"ss": ss, "ss_dia": ss_dia, "ps": ps, "grid": G}
    host = sum(v for k, v in steps.items() if k != "build_sharded")
    return {"grid": [G] * 3, "nparts": nparts, "n": ps.nrows,
            "devices": [str(d) for d in ss.devices],
            "blocks": [op.spec.grid for op in ss.local_ops],
            "local_tier": ss.local_fmt, "rounds": ss.halo.nrounds,
            "max_message": ss.halo.max_msg,
            "values_per_exchange": ss.halo.total_send_values,
            "ghosts_per_shard": [p.nghost for p in ps.parts],
            "iface_rows": [int(rows.numel()) for _, rows in ss.iface],
            "iface_entries": [op.nnz for op, _ in ss.iface],
            "iface_fill": [op.fill for op, _ in ss.iface],
            "iface_values": str(ss.iface[0][0].vals.dtype)[6:],
            "rdma_chunks_per_slot": ss.rdma.C,
            "host_seconds": steps, "host_seconds_total": host,
            "dia_bf16_build_seconds": dia_s,
            "host_setup_within_120s": host <= 120.0}


def _dist_kernels(nrhs: int, ctx):
    """The kernels of the distributed path at its shapes, against their
    plain versions: stencil_spmv on one shard's sub-grid (with the dot;
    beside conv3d), ell_spmv on one shard's interface operator (border
    rows x ghost slots; beside cuSPARSE CSR on the same matrix), dia_spmv on
    one shard's bf16 bands at f32 (with the dot), and the put+signal
    kernel on the 4-shard halo tables at GPU scope: rdma_exchange's
    delivered blocks bit-equal to the plain version, the fused halo's
    ghosts bit-equal to its plain version, halo_ppermute and
    halo_allgather; the exchange timed one call at a time and queued,
    beside the same slots moved by one Tensor.copy_ each and its bound,
    and the three whole halos (one call, queued) beside the fused halo's
    own bound."""
    import torch

    from acg_torch.ops.blas1 import batched_dot
    from acg_torch.ops.dia_kernels import (cg_pipelined_iter_plain,
                                           dia_matvec, dia_spmv,
                                           dia_spmv_batched)
    from acg_torch.ops.dia_plan import pipe_bytes
    from acg_torch.ops.stencil import (cg_pipelined_iter_stencil,
                                       cg_pipelined_iter_stencil_plain,
                                       stencil_matvec, stencil_spmv,
                                       stencil_spmv_batched)
    from acg_torch.parallel import rdma_halo
    from acg_torch.parallel.halo import halo_allgather, halo_ppermute

    ss, ss_dia = ctx["dist"]["ss"], ctx["dist"]["ss_dia"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    # the stencil of shard 0, f64
    op = ss.local_ops[0]
    spec, n = op.spec, op.nrows
    x = torch.zeros(op.nrows_padded, dtype=torch.float64, device="cuda")
    x[:n] = torch.randn(n, generator=gen, dtype=torch.float64, device="cuda")
    w = torch.zeros(1, 1, 3, 3, 3, dtype=torch.float64, device="cuda")
    w[0, 0, 1, 1, 1] = 6.0
    for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        w[(0, 0) + c] = -1.0

    for with_dot in (True, False):
        _stencil_row(spec, x, with_dot, "matrix-free/float64 256^3/4 shard",
                     lambda: torch.nn.functional.conv3d(
                         x[:n].view(1, 1, *spec.grid), w, padding=1), ctx)
    # the interface operator of shard 0: its border rows over its ghost
    # slots
    _iface_check(ss, 0, "bf16/f64 interface 256^3/4", ctx)
    # the deep ghost zones' operators of shard 0 at the depths of the
    # distributed s-step (4) and deep-pipelined (2) phases: the deep
    # interface (border rows x deep ghost slots) and the skin
    # (ghost-interior rows x [owned | deep ghosts])
    for depth in (4, 2):
        dd, _secs = _deep_layer(ctx, ss, depth)
        for which in ("interface", "skin"):
            _deep_ell_check(dd, 0, which, ctx)
    # shard 0's DIA bands, bf16 at f32 vectors, with the dot
    dop = ss_dia.local_ops[0]
    xf = torch.randn(dop.nrows_padded, generator=gen, device="cuda")

    D_, nd = len(dop.offsets), dop.nrows_padded
    csr32 = _csr_of(dop, torch.float32)
    # with the dot (classic CG's fused step) and without (the distributed
    # s-step and deep-pipelined bases)
    for wd in (True, False):
        def plain_dia(wd=wd):
            y = dia_matvec(dop.bands, dop.offsets, xf, dop.scales)
            return (y, torch.dot(xf, y)) if wd else y

        _check_kernel({"name": "dia_spmv", "tier": "bf16/f32 256^3/4 shard",
                       "with_dot": wd, "plan": dop.kind},
                      lambda wd=wd: dia_spmv(dop.bands, dop.scales,
                                             dop.offsets_t, xf, with_dot=wd,
                                             fixed=dop.fixed),
                      plain_dia, xf, ctx,
                      D_ * nd * 2 + 2 * nd * 4,
                      2 * D_ * nd + (2 * nd if wd else 0),
                      lambda: csr32 @ xf)
    # the shards' pipelined iterations (the distributed pipelined loop's
    # kernels) and multi-RHS SpMVs at B = nrhs (the distributed batched
    # loops'), f64 stencil and bf16/f32 DIA
    n0, np0, nr = op.nrows, op.nrows_padded, dop.nrows
    vecs, ab = _pipe_inputs(n0, np0, torch.float64, seed=5)
    _check_pipe({"name": "cg_pipelined_iter_stencil",
                 "tier": "matrix-free/float64 256^3/4 shard"},
                lambda *a, **k: cg_pipelined_iter_stencil(spec, *a, **k),
                lambda *a: cg_pipelined_iter_stencil_plain(spec, *a),
                _composed(lambda v: stencil_spmv(spec, v)),
                vecs, ab, n0, ctx, 12 * n0 * 8,
                2 * len(spec.offsets) * n0 + 16 * n0)
    vecs, ab = _pipe_inputs(nr, nd, torch.float32, seed=6)
    _check_pipe({"name": "cg_pipelined_iter",
                 "tier": "bf16/f32 256^3/4 shard",
                 "pipe_fixed": dop.pipe_fixed},
                dop.pipelined_iter,
                lambda *a: cg_pipelined_iter_plain(dop.bands, dop.scales,
                                                   dop.offsets, *a),
                _composed(lambda v: dia_spmv(dop.bands, dop.scales,
                                             dop.offsets_t, v,
                                             fixed=dop.fixed)),
                vecs, ab, nr, ctx,
                pipe_bytes(nr, D_, torch.float32, dop.bands.dtype),
                2 * D_ * nr + 16 * nr, bodies=_pipe_bodies(dop))
    del vecs
    X = torch.zeros(nrhs, np0, dtype=torch.float64, device="cuda")
    X[:, :n0] = torch.randn(nrhs, n0, generator=gen, dtype=torch.float64,
                            device="cuda")
    for wd in (False, True):
        def plain_sb(wd=wd):
            Y = stencil_matvec(X, spec.grid, spec.digits, spec.coeffs)
            return (Y, batched_dot(X, Y)) if wd else Y

        _check_kernel({"name": "stencil_spmv_batched",
                       "tier": "matrix-free/float64 256^3/4 shard",
                       "with_dot": wd, "nrhs": nrhs},
                      lambda wd=wd: stencil_spmv_batched(spec, X,
                                                         with_dot=wd),
                      plain_sb, X, ctx, nrhs * 2 * np0 * 8,
                      nrhs * (2 * len(spec.offsets) * n0
                              + (2 * n0 if wd else 0)),
                      lambda: torch.nn.functional.conv3d(
                          X[:, :n0].view(nrhs, 1, *spec.grid), w,
                          padding=1))
    del X
    Xf = torch.zeros(nrhs, nd, dtype=torch.float32, device="cuda")
    Xf[:, :nr] = torch.randn(nrhs, nr, generator=gen, device="cuda")
    Xt = Xf[:, :nr].T.contiguous()

    def plain_db():
        Y = dia_matvec(dop.bands, dop.offsets, Xf, dop.scales)
        return Y, batched_dot(Xf, Y)

    _check_kernel({"name": "dia_spmv_batched",
                   "tier": "bf16/f32 256^3/4 shard", "with_dot": True,
                   "nrhs": nrhs},
                  lambda: dia_spmv_batched(dop.bands, dop.scales,
                                           dop.offsets_t, Xf, with_dot=True),
                  plain_db, Xf, ctx,
                  D_ * nr * 2 + nrhs * 2 * nr * 4,
                  nrhs * (2 * D_ * nr + 2 * nr),
                  lambda: torch.sparse.mm(csr32, Xt))
    del csr32, Xf, Xt
    # the put+signal kernel on the 4-shard tables: the exchange of (R, S)
    # blocks, and the halo with its pack and unpack fused in
    st, state = ss.tables, ss.rdma
    P, R, S = len(ss.local_ops), state.R, state.S
    xs = [torch.randn(o.nrows_padded, generator=gen, dtype=torch.float64,
                      device="cuda") for o in ss.local_ops]
    send = [xi[idx].view(R, S) for xi, idx in zip(xs, st.send_full)]
    got = [o.clone() for o in
           rdma_halo.rdma_exchange(send, st.partner, state)]
    want = rdma_halo.rdma_exchange_plain(send, st.partner)
    torch.cuda.synchronize()
    state.check()
    bits = all(torch.equal(a, b) for a, b in zip(got, want))
    g_rdma = [g.clone() for g in rdma_halo.halo_rdma(xs, st, state)]
    g_plain = rdma_halo.halo_rdma_plain(xs, st)
    g_pp, g_ag = halo_ppermute(xs, st), halo_allgather(xs, st)
    torch.cuda.synchronize()
    state.check()
    halo_bits = all(torch.equal(a, b) and torch.equal(a, c)
                    and torch.equal(a, d)
                    for a, b, c, d in zip(g_rdma, g_pp, g_ag, g_plain))
    pairs = [(p, r, int(st.partner[p, r]) if st.partner[p, r] >= 0 else p)
             for p in range(P) for r in range(R)]

    def copies():
        for p, r, q in pairs:
            state.out[p][r].copy_(send[q][r])

    def exchange():
        return rdma_halo.rdma_exchange(send, st.partner, state)

    halos = {"rdma": lambda: rdma_halo.halo_rdma(xs, st, state),
             "ppermute": lambda: halo_ppermute(xs, st),
             "allgather": lambda: halo_allgather(xs, st)}
    word = send[0].element_size()
    nghost = sum(st.nghost)
    row = {"name": "rdma_exchange", "tier": "f64 256^3/4", "with_dot": None,
           "P": P, "R": R, "S": S, "chunks_per_slot": state.C,
           "chunk_words": state.chunk, "scope": state.scope,
           "max_abs_err": max(float((a - b).abs().max())
                              for a, b in zip(got, want)),
           "bits_equal_plain": bits,
           "ghosts_bit_equal_plain_ppermute_allgather": halo_bits,
           "ms": _time_ms(exchange, ctx["reps"]),
           "ms_queued": _queued_ms(exchange),
           "plain_ms": _time_ms(lambda: rdma_halo.rdma_exchange_plain(
               send, st.partner), ctx["reps"]),
           "library_ms": _time_ms(copies, ctx["reps"]),
           "library": "one Tensor.copy_ (cudaMemcpyAsync) per slot",
           "halo_ms": {k: _time_ms(f, ctx["reps"]) for k, f in halos.items()},
           "halo_ms_queued": {k: _queued_ms(f) for k, f in halos.items()},
           "halo_plain_ms": _time_ms(lambda: rdma_halo.halo_rdma_plain(
               xs, st), ctx["reps"])}
    # the exchange reads every send word and writes every delivered word
    # once; the fused halo reads every send word from the owned vectors
    # and the pack and unpack words (int32) once, and writes every ghost
    # once
    row["bound_ms"], row["bound_by"] = _bound(2 * P * R * S * word, 0,
                                              torch.float64, ctx)
    row["halo_bound_ms"], _ = _bound(
        P * R * S * word + nghost * word + 2 * P * R * S * 4, 0,
        torch.float64, ctx)
    ctx["rows"].append(row)
    _emit({"kernel_check": row})
    if not (bits and halo_bits and state.scope == "gpu"):
        raise SystemExit(f"error: rdma_exchange disagrees: {row}")


def _iface_check(ss, i: int, tier: str, ctx):
    """``ell_spmv`` on shard ``i``'s interface operator (its border rows
    over its ghost slots: a rectangle, sliced) against its plain version
    on the same rows' ELL rectangle on the card (``_ell_check``'s
    tolerances) and bit for bit against ``sliced_matvec``, timed beside
    cuSPARSE CSR on the same rows."""
    import torch

    from acg_torch.parallel.sharded import border_rows

    p = ss.ps.parts[i]
    op, _ = ss.iface[i]
    _rect_ell_check(op, border_rows(p.A_iface)[1],
                    getattr(torch, ss.vec_dtype), tier,
                    {"shard": i, "ghosts": p.nghost}, 8 + i, ctx)


def _rect_ell_check(op, B, vdt, tier: str, label: dict, seed: int, ctx):
    """``ell_spmv`` on a rectangular sliced operator ``op`` made of the
    rows of the host CSR ``B``: against ``ell_matvec`` on B's ELL
    rectangle (``_ell_check``'s tolerances) and bit for bit against
    ``sliced_matvec``, timed beside cuSPARSE CSR on B.  Its bound reads
    x only at the columns that hold an entry (``columns_read``): the
    deep skin reads a few of its [owned | deep ghosts] columns, the deep
    interface only its distance-1 ghosts."""
    import numpy as np
    import torch

    from acg_torch.ops.sliced import sliced_matvec
    from acg_torch.ops.spmv import ell_matvec, ell_spmv
    from acg_torch.sparse.ell import EllMatrix

    m = op.ncols
    gh = _padded_x(m, m, vdt, seed).to(op.device)
    lib = _torch_csr(B, vdt)
    E = EllMatrix.from_csr(B, row_align=1)
    ivals = torch.from_numpy(E.vals.astype(str(vdt)[6:])).to(
        op.vals.dtype).to(op.device)
    icols = torch.from_numpy(E.colidx.astype(np.int32)).to(op.device)

    def bits(row):
        row["bits_equal_sliced_matvec"] = bool(torch.equal(
            ell_spmv(op, gh), sliced_matvec(op, gh)))
        return row["bits_equal_sliced_matvec"]

    word = gh.element_size()
    xcols = int(np.unique(B.colidx[:B.rowptr[-1]]).size)
    _check_kernel({"name": "ell_spmv", "tier": tier, "with_dot": None,
                   **label, "rows": op.nrows, "columns": m,
                   "columns_read": xcols,
                   "width": E.width, "values": str(op.vals.dtype)[6:],
                   **_layout(op, word, "ell_spmv", xcols)},
                  lambda: ell_spmv(op, gh),
                  lambda: ell_matvec(ivals, icols, gh), gh, ctx,
                  _work_bytes(op, word, xcols), 2 * op.nnz,
                  lambda: lib @ gh,
                  extra=bits,
                  tol=(1e-5 if vdt == torch.float32 else 1e-13, 0.0, None))


def _deep_layer(ctx, ss, depth: int):
    """(the deep ghost zones of the distributed cell's shards at
    ``depth``, the host seconds of their build): built once on the shards
    (``build_deep_device`` caches them, for every halo of the shards)."""
    from acg_torch.parallel.deep import build_deep_device

    secs = ctx["dist"].setdefault("deep_seconds", {})
    t = {}
    dd = build_deep_device(ss, depth, timings=t)
    if t:
        secs[depth] = t
    return dd, secs[depth]


def _deep_ell_check(dd, i: int, which: str, ctx):
    """``ell_spmv`` on shard ``i``'s deep ``which`` operator ("interface"
    or "skin") at the layer's depth: against its plain version on the
    same rows' ELL rectangle and bit for bit against ``sliced_matvec``,
    timed beside cuSPARSE CSR on the same rows (``_iface_check``'s
    protocol)."""
    import torch

    from acg_torch.parallel.sharded import border_rows

    op, _rows = (dd.iface if which == "interface" else dd.skin)[i]
    M = (dd.host.iface if which == "interface" else dd.host.skin)[i]
    vals = {torch.bfloat16: "bf16", torch.float32: "f32",
            torch.float64: "f64"}[op.vals.dtype]
    _rect_ell_check(op, border_rows(M)[1], torch.float64,
                    f"{vals}/f64 deep {which} d{dd.depth} 256^3/4",
                    {"shard": i, "depth": dd.depth,
                     "deep_ghosts": dd.nghost[i]}, 20 + i, ctx)


def _poisson7_residual(G: int, x, b) -> float:
    """||b - A x|| / ||b|| in float64 on the host for the 7-point Poisson
    matrix of a G^3 grid (6 on the diagonal, -1 to each grid neighbour),
    by slicing the grid: independent of every operator of the port."""
    import numpy as np

    u = np.asarray(x, dtype=np.float64).reshape(G, G, G)
    y = 6.0 * u
    y[1:] -= u[:-1]
    y[:-1] -= u[1:]
    y[:, 1:] -= u[:, :-1]
    y[:, :-1] -= u[:, 1:]
    y[:, :, 1:] -= u[:, :, :-1]
    y[:, :, :-1] -= u[:, :, 1:]
    bb = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(bb - y.reshape(-1)) / np.linalg.norm(bb))


def _dist_stencil_solve(ctx, method: str):
    """Classic cg_dist on the 256^3/4 stencil shards through one halo, to
    the stencil phase's rtol from its right-hand side: the count within 1
    of the single-device count; the residual certified in float64 on the
    host from the grid itself (no operator of the port) within 10 x rtol;
    the error against the manufactured solution within 2 x the
    single-device phase's; x bit-identical and the count equal across the
    three halos; the local and interface kernels launched once a shard
    per SpMV, rdma_exchange once per halo exchange (the initial residual
    and one per iteration; the certification runs on the host) and only
    under --halo rdma.  The counts are read before the certification."""
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg_dist import cg_dist

    phase = "dist-stencil" + ("" if method == "ppermute" else f"-{method}")
    ss = ctx["dist"]["ss"].with_halo(method)
    _, b, xstar = ctx["stencil_case"]
    rtol = 1e-8
    cg_dist(ss, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    _reset_counts()
    res = cg_dist(ss, b, options=SolverOptions(maxits=20000,
                                               residual_rtol=rtol))
    launches = _read_counts(ctx, phase)
    cert = _poisson7_residual(ctx["dist"]["grid"], res.x, b)
    rep = _solve_report(res, launches)
    its, P = res.niterations, ss.nparts
    single = ctx["classic_iterations"]
    err = float(np.linalg.norm(res.x - xstar))
    rep.update(certified_relative_residual=cert, rtol=rtol,
               certified_by="float64 7-point product on the host",
               single_device_iterations=single,
               single_device_us_per_iter=ctx["us_per_iter"]["stencil"],
               error_vs_manufactured=err,
               single_device_error_vs_manufactured=ctx["stencil_error"])
    spmvs = its + 1
    want = {"stencil_spmv": P * spmvs, "ell_spmv": P * spmvs,
            "rdma_exchange": spmvs if method == "rdma" else 0,
            "cg_update": P * its}
    others = {k: v for k, v in launches.items() if k not in want and v}
    ok = ((res.operator_format, res.kernel)
          == ("stencil", f"cuda-stencil-fused+{method}") and res.converged
          and abs(its - single) <= 1 and cert <= 10 * rtol
          and err <= 2 * ctx["stencil_error"]
          and all(launches[k] == v for k, v in want.items()) and not others
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    first = ctx["dist"].setdefault("stencil_x", (method, its, res.x))
    rep["same_as"] = first[0]
    rep["bit_identical_x"] = bool(np.array_equal(res.x, first[2]))
    ok = ok and rep["bit_identical_x"] and its == first[1]
    if method == "rdma":
        n_dev = torch.cuda.device_count()
        if n_dev < 2:
            rep["multi_gpu"] = "not run: 1 device"
        else:
            # the same shards on distinct cards: the puts cross NVLink
            # through peer-mapped addresses
            from acg_torch.parallel.sharded import ShardedSystem

            multi = ShardedSystem.build(
                ctx["dist"]["ps"], "stencil", ss.local_ops[0].spec,
                devices=[f"cuda:{i % n_dev}" for i in range(P)],
                dtype=np.float64, method="rdma")
            rm = cg_dist(multi, b, options=SolverOptions(
                maxits=20000, residual_rtol=rtol))
            rep["multi_gpu"] = {
                "devices": [str(d) for d in multi.devices],
                "iterations": rm.niterations,
                "us_per_iter": rm.stats.tsolve / max(rm.niterations, 1)
                * 1e6,
                "bit_identical_x": bool(np.array_equal(rm.x, res.x))}
            ok = ok and rm.niterations == its and \
                rep["multi_gpu"]["bit_identical_x"]
        ctx["profile_cases"] = ctx.get("profile_cases", []) + [
            ("dist-stencil-rdma-f64", ss, b, cg_dist)]
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    return rep


def _dist_dia_solve(iters: int, ctx):
    """cg_dist on the 256^3/4 shards as bf16 DIA bands at f32 vectors
    (fmt="dia"), rdma halo, ``iters`` fixed iterations from dia-bf16's
    right-hand side: each iteration one fused dia_spmv a shard (the JAX
    package's per-shard fused coupled step with the interface correction
    in p'Ap), rdma_exchange once per exchange.  Held against the
    single-device dia-bf16 phase after the same iterations on the same b:
    the recurrence residual within 5 % (a wrong <p, A_iface ghosts> term
    changes every step length, and the residual after 1000 steps by
    orders of magnitude) and the true residual, in float64 on the host
    from the grid, within 2 x."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg_dist import cg_dist

    phase = "dist-dia-bf16"
    ss = ctx["dist"]["ss_dia"]
    b = np.random.default_rng(0).standard_normal(ss.nrows).astype(
        np.float32)
    cg_dist(ss, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    _reset_counts()
    res = cg_dist(ss, b, options=SolverOptions(maxits=iters,
                                               residual_rtol=0.0))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    P = ss.nparts
    ref = ctx["dia_bf16_ref"]
    rec = res.rnrm2 / res.bnrm2
    true = _poisson7_residual(ctx["dist"]["grid"], res.x, b)
    rep.update(plan=_plan_info(ss.local_ops[0]),
               single_device_us_per_iter=ref["us_per_iter"],
               host_true_relative_residual=true,
               single_device_host_true_relative_residual=ref[
                   "host_true_relative_residual"],
               recurrence_relative_residual=rec,
               single_device_recurrence_relative_residual=ref[
                   "recurrence_relative_residual"])
    want = {"dia_spmv": P * (iters + 1), "ell_spmv": P * (iters + 1),
            "rdma_exchange": iters + 1, "cg_update": P * iters}
    others = {k: v for k, v in launches.items() if k not in want and v}
    ok = ((res.operator_format, res.kernel) == ("dia", "cuda-dia-fused+rdma")
          and res.kernel_note == "format forced: dia"
          and res.niterations == iters and np.all(np.isfinite(res.x))
          and all(launches[k] == v for k, v in want.items()) and not others
          and abs(rec / ref["recurrence_relative_residual"] - 1) <= 0.05
          and true <= 2 * ref["host_true_relative_residual"])
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    ctx["dist"]["dia_classic"] = {"true": true, "recurrence": rec,
                                  "history": res.residual_history,
                                  "bnrm2": res.bnrm2}
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    return rep


def _dist_fem_phase(nparts: int, ctx):
    """cg_dist on fem3d-1m's matrix in ``nparts`` rb parts (recursive
    bisection + refinement) with the rdma halo: f32 through the per-part
    RCM and the sgell packs (fmt="auto" resolves rcm+sgell), rtol 1e-6;
    f64 on padded-ELL shards of the same partition (fmt="ell": what auto
    resolves at f64, without its rejected RCM pass), rtol 1e-8.  Host
    seconds of the partition, the split and each shard build; the
    certified residual from the host CSR in float64.  On the shard with
    the most ghosts of each build, the local kernel (sgell_spmv, or
    ell_spmv on the ELL shard) and the interface ell_spmv are held against
    their plain versions on the same card tensors."""
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.partition.graph import partition_system
    from acg_torch.partition.partitioner import partition_graph
    from acg_torch.solvers.cg_dist import build_sharded, cg_dist

    fem = ctx["fem"]
    A, b = fem["A"], fem["b"]
    steps = {}
    t0 = time.perf_counter()
    part = partition_graph(A, nparts, method="rb")
    steps["partition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ps = partition_system(A, part, local_order="band")
    steps["partition_system"] = time.perf_counter() - t0
    devices = ["cuda:0"] * nparts
    out = {"points": A.nrows, "nparts": nparts,
           "part_sizes": np.bincount(part).tolist(),
           "ghosts_per_shard": [p.nghost for p in ps.parts]}
    for label, vdt, fmt, tier, rtol in (
            ("f32", np.float32, "auto", "sgell", 1e-6),
            ("f64", np.float64, "ell", "ell", 1e-8)):
        phase = f"dist-fem-{tier}"
        bsteps = {}
        t0 = time.perf_counter()
        ss = build_sharded(ps, devices=devices, dtype=vdt, method="rdma",
                           fmt=fmt,
                           timings=bsteps)
        torch.cuda.synchronize()
        bsteps["total"] = time.perf_counter() - t0
        bv = b.astype(vdt)
        cg_dist(ss, bv, options=SolverOptions(maxits=20, residual_rtol=0.0))
        _reset_counts()
        res = cg_dist(ss, bv, options=SolverOptions(maxits=20000,
                                                    residual_rtol=rtol))
        launches = _read_counts(ctx, phase)
        rep = _solve_report(res, launches)
        kern = f"{tier}_spmv"
        spmvs = res.niterations + 1
        rep.update(rtol=rtol, build_seconds=bsteps,
                   partition_plus_build_seconds=(
                       steps["partition"] + steps["partition_system"]
                       + bsteps["total"]),
                   true_relative_residual=_host_true_residual(A, res.x, b),
                   single_device_iterations=ctx["iterations"][f"fem-{tier}"])
        # the interface product is ELL on every shard; on the ELL tier the
        # local SpMV is ell_spmv too
        want = {kern: nparts * spmvs, "rdma_exchange": spmvs,
                "cg_update": nparts * (spmvs - 1)}
        want["ell_spmv"] = nparts * spmvs * (2 if tier == "ell" else 1)
        others = {k: v for k, v in launches.items() if k not in want and v}
        fmt_name = "rcm+sgell" if tier == "sgell" else "ell"
        ok = ((res.operator_format, res.kernel)
              == (fmt_name, f"cuda-{tier}-spmv+rdma") and res.converged
              and rep["true_relative_residual"] <= 10 * rtol
              and all(launches[k] == v for k, v in want.items())
              and not others and np.all(np.isfinite(res.x)))
        ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
        out[phase] = rep
        if not ok:
            raise SystemExit(f"error: {phase} solve failed: {rep}")
        # the kernels at this build's shapes, after the counted run
        i = int(np.argmax([p.nghost for p in ss.ps.parts]))
        check = _sgell_check if tier == "sgell" else _ell_check
        check(ss.local_ops[i], ss.ps.parts[i].A_local,
              f"{label}/{label} fem3d-1m/{nparts} shard", ctx)
        _iface_check(ss, i, f"{label} interface fem3d-1m/{nparts}", ctx)
        rep["kernels_checked_on_shard"] = i
        del ss
        torch.cuda.empty_cache()
    out["host_seconds"] = steps
    return out


# ---------------------------------------------------------------------------
# the distributed pipelined, multi-RHS and compressed-wire paths


def _dist_pipelined_stencil(ctx, method: str):
    """cg_pipelined_dist on the 256^3/4 stencil shards through one halo,
    to the stencil phase's rtol from its right-hand side: the per-shard
    single-kernel iteration with the interface folded in
    (cuda-stencil-pipe+<halo>); the count within 1 of the single-device
    pipelined-stencil phase's; the residual certified in float64 on the
    host from the grid within 10 x rtol; x bit-identical and the count
    equal across the three halos; cg_pipelined_iter_stencil once a shard
    an iteration; stencil_spmv once a shard per eager SpMV (the prelude's
    two and the certifications' four each), ell_spmv once a shard per
    iteration and per eager SpMV; rdma_exchange once per halo (an
    iteration's and each eager SpMV's) and only under --halo rdma.  The
    counts are read before the certification."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg_dist import cg_pipelined_dist

    phase = "dist-pipelined-stencil" + ("" if method == "ppermute"
                                        else f"-{method}")
    ss = ctx["dist"]["ss"].with_halo(method)
    _, b, xstar = ctx["stencil_case"]
    rtol = 1e-8
    cg_pipelined_dist(ss, b, options=SolverOptions(maxits=20,
                                                   residual_rtol=0.0))
    _reset_counts()
    res = cg_pipelined_dist(ss, b, options=SolverOptions(
        maxits=20000, residual_rtol=rtol))
    launches = _read_counts(ctx, phase)
    cert = _poisson7_residual(ctx["dist"]["grid"], res.x, b)
    rep = _solve_report(res, launches)
    its, P = res.niterations, ss.nparts
    single = ctx["iterations"]["pipelined-stencil"]
    eager = launches["stencil_spmv"] // P
    rep.update(certified_relative_residual=cert, rtol=rtol,
               certified_by="float64 7-point product on the host",
               single_device_iterations=single,
               single_device_us_per_iter=ctx["us_per_iter"][
                   "pipelined-stencil"],
               classic_dist_us_per_iter=ctx["us_per_iter"][
                   "dist-stencil" + ("" if method == "ppermute"
                                     else f"-{method}")],
               eager_spmvs=eager,
               error_vs_manufactured=float(np.linalg.norm(res.x - xstar)))
    want = {"cg_pipelined_iter_stencil": P * its,
            "stencil_spmv": P * eager, "ell_spmv": P * (its + eager),
            "rdma_exchange": its + eager if method == "rdma" else 0}
    others = {k: v for k, v in launches.items() if k not in want and v}
    ok = ((res.operator_format, res.kernel)
          == ("stencil", f"cuda-stencil-pipe+{method}") and res.converged
          and res.kernel_note == "" and abs(its - single) <= 1
          and cert <= 10 * rtol and eager >= 6
          and launches["stencil_spmv"] % P == 0
          and all(launches[k] == v for k, v in want.items()) and not others
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    first = ctx["dist"].setdefault("pipelined_x", (method, its, res.x))
    rep["same_as"] = first[0]
    rep["bit_identical_x"] = bool(np.array_equal(res.x, first[2]))
    ok = ok and rep["bit_identical_x"] and its == first[1]
    if method == "rdma":
        ctx["profile_cases"] = ctx.get("profile_cases", []) + [
            ("dist-pipelined-stencil-rdma-f64", ss, b, cg_pipelined_dist)]
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    return rep


def _first_below(hist, bnrm2: float, tau: float):
    """The first iteration whose recorded |r|^2 (a solve's residual
    history) is at most (tau |b|)^2, or None."""
    import numpy as np

    hit = np.nonzero(np.sqrt(np.asarray(hist, dtype=np.float64))
                     <= tau * bnrm2)[0]
    return int(hit[0]) if len(hit) else None


# relative residuals a fixed-iteration f32 pipelined run on the 256^3
# operator must pass through in the iteration window of classic's, and
# one more that is recorded only: the f32 pipelined recurrence's own
# floor there lies near 1e-4 (the single-device pipelined run passes 1e-4
# before classic does, which exact arithmetic forbids, and a 48^3 run of
# the folded, the open-coded and the single-device pipelined loops
# passes every mark down to 1e-5 within one iteration of classic and
# then drifts in each)
_PIPE_MARKS = (1e-2, 1e-3)
_PIPE_MARKS_RECORDED = (1e-4,)


def _dist_pipelined_dia(iters: int, ctx):
    """cg_pipelined_dist on the 256^3/4 bf16 DIA shards at f32 vectors,
    rdma halo, ``iters`` fixed iterations from dist-dia-bf16's right-hand
    side: cg_pipelined_iter once a shard an iteration with the interface
    folded in (cuda-dia-pipe+rdma), dia_spmv once a shard for each of the
    prelude's two SpMVs, rdma_exchange once per halo.  Held to an f32
    drift window of classic dist-dia-bf16's: pipelined CG needs up to
    1.28 times classic's iterations at f32 (``_F32_PIPE_RATIO``), and no
    fewer in exact arithmetic, so for each mark tau of ``_PIPE_MARKS``
    the first iteration k_p at which its recurrence residual is at most
    tau lies in [k_c - 1, floor(1.28 k_c) + 1], k_c classic's (a wrong
    interface term changes every step length and misses the window).
    Past its f32 floor, with no criterion to stop it, the pipelined
    recurrence drifts: the marks of ``_PIPE_MARKS_RECORDED``, its lowest
    recurrence residual and its true residual after ``iters`` iterations
    are recorded beside the single-device pipelined-dia-bf16 phase's."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg_dist import cg_pipelined_dist

    phase = "dist-pipelined-dia-bf16"
    ss = ctx["dist"]["ss_dia"]
    b = np.random.default_rng(0).standard_normal(ss.nrows).astype(
        np.float32)
    cg_pipelined_dist(ss, b, options=SolverOptions(maxits=20,
                                                   residual_rtol=0.0))
    _reset_counts()
    res = cg_pipelined_dist(ss, b, options=SolverOptions(
        maxits=iters, residual_rtol=0.0))
    launches = _read_counts(ctx, phase)
    rep = _solve_report(res, launches)
    P = ss.nparts
    classic, single = ctx["dist"]["dia_classic"], ctx["pipelined_dia_bf16_ref"]
    marks, ok_marks = {}, True
    for tau in _PIPE_MARKS + _PIPE_MARKS_RECORDED:
        kc = _first_below(classic["history"], classic["bnrm2"], tau)
        kp = _first_below(res.residual_history, res.bnrm2, tau)
        ks = _first_below(single["history"], single["bnrm2"], tau)
        lo, hi = (None, None) if kc is None else (
            kc - 1, math.floor(_F32_PIPE_RATIO[1] * kc) + 1)
        marks[str(tau)] = {"classic_dist": kc, "pipelined_dist": kp,
                           "pipelined_single_device": ks,
                           "window": [lo, hi],
                           "held": tau in _PIPE_MARKS}
        if tau in _PIPE_MARKS:
            ok_marks = ok_marks and kp is not None and lo is not None and (
                lo <= kp <= hi)
    rel = np.sqrt(res.residual_history.astype(np.float64)) / res.bnrm2
    rep["lowest_recurrence"] = [int(rel.argmin()), float(rel.min())]
    rep.update(plan=_plan_info(ss.local_ops[0]), marks=marks,
               host_true_relative_residual=_poisson7_residual(
                   ctx["dist"]["grid"], res.x, b),
               recurrence_relative_residual=res.rnrm2 / res.bnrm2,
               classic_dist_host_true_relative_residual=classic["true"],
               single_device_pipelined_host_true_relative_residual=single[
                   "host_true_relative_residual"],
               classic_dist_us_per_iter=ctx["us_per_iter"]["dist-dia-bf16"],
               single_device_us_per_iter=ctx["us_per_iter"][
                   "pipelined-dia-bf16"])
    want = {"cg_pipelined_iter": P * iters, "dia_spmv": 2 * P,
            "ell_spmv": P * (iters + 2), "rdma_exchange": iters + 2}
    others = {k: v for k, v in launches.items() if k not in want and v}
    ok = ((res.operator_format, res.kernel) == ("dia", "cuda-dia-pipe+rdma")
          and res.kernel_note == "format forced: dia"
          and res.niterations == iters and np.all(np.isfinite(res.x))
          and all(launches[k] == v for k, v in want.items()) and not others
          and ok_marks)
    ctx.setdefault("us_per_iter", {})[phase] = rep["us_per_iter"]
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    return rep


def _dist_batched_stencil(nrhs: int, ctx, pipelined: bool = False):
    """A (B, n) solve on the 256^3/4 stencil shards, B = ``nrhs`` (the
    first ``nrhs`` of the batched phases' manufactured systems), rtol
    1e-8: classic through
    ppermute (cg_dist), pipelined through allgather (cg_pipelined_dist,
    the open-coded batched body).  Each system's count within 1 of the
    single-device batched-stencil / batched-pipelined-stencil phase's,
    each certified in float64 on the host from the grid within 10 x rtol;
    stencil_spmv_batched once a shard per distributed SpMV, the interface
    ell_spmv once a shard and system per SpMV, no one-system stencil
    kernel; the halo called once per SpMV for all B systems (classic:
    iterations + 1 times), by the halo's counters."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.parallel import halo
    from acg_torch.solvers.cg_dist import cg_dist, cg_pipelined_dist

    phase = ("dist-batched-pipelined-stencil" if pipelined
             else "dist-batched-stencil")
    method = "allgather" if pipelined else "ppermute"
    solve = cg_pipelined_dist if pipelined else cg_dist
    ss = ctx["dist"]["ss"].with_halo(method)
    _, b, xstar = ctx["batched_case"]
    b, xstar = b[:nrhs], xstar[:nrhs]
    rtol = 1e-8
    solve(ss, b, options=SolverOptions(maxits=20, residual_rtol=0.0))
    # the halo's own counters (acg_torch/parallel/halo.py): allgathers,
    # and ppermute rounds, R an exchange
    rounds, gathers = halo.ppermute_rounds, halo.allgathers
    _reset_counts()
    res = solve(ss, b, options=SolverOptions(maxits=20000,
                                             residual_rtol=rtol))
    launches = _read_counts(ctx, phase)
    halos = (halo.allgathers - gathers if pipelined
             else (halo.ppermute_rounds - rounds) // ss.halo.nrounds)
    G = ctx["dist"]["grid"]
    cert = [_poisson7_residual(G, res.x[s], b[s]) for s in range(nrhs)]
    rep = _solve_report(res, launches)
    its, P = res.niterations, ss.nparts
    single = np.asarray(ctx["batched_pipelined_counts" if pipelined
                            else "batched_counts"])[:nrhs]
    counts = np.asarray(res.iterations_per_system)
    base = "batched-pipelined-stencil" if pipelined else "batched-stencil"
    rep.update(certified_relative_residual=cert, rtol=rtol,
               certified_by="float64 7-point product on the host",
               halo_calls=halos,
               single_device_iterations=single.tolist(),
               single_device_us_per_system_iter=ctx["us_per_system_iter"][
                   base],
               error_vs_manufactured=[float(np.linalg.norm(
                   res.x[s] - xstar[s])) for s in range(nrhs)])
    want = {"stencil_spmv_batched": P * halos,
            "ell_spmv": P * nrhs * halos,
            "cg_update": 0 if pipelined else P * its}
    others = {k: v for k, v in launches.items() if k not in want and v}
    note = (f"stencil pipe disengaged: nrhs={nrhs} (the single-kernel "
            "iteration is not batched)" if pipelined else "")
    ok = ((res.operator_format, res.kernel, res.kernel_note)
          == ("stencil", f"cuda-stencil-batched+{method}", note)
          and res.converged and all(res.converged_per_system)
          and bool(np.all(np.abs(counts - single) <= 1))
          and max(cert) <= 10 * rtol
          and (halos == its + 1 if not pipelined else its + 1 <= halos
               < 2 * (its + 1))
          and all(launches[k] == v for k, v in want.items()) and not others
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    if not ok:
        raise SystemExit(f"error: {phase} solve failed: {rep}")
    return rep


def _dist_wire_phase(ctx):
    """The compressed halo wire on the 256^3/4 bf16 DIA shards at f32
    vectors through ppermute: classic and pipelined CG with
    replace_every=10 from dist-dia-bf16's right-hand side, bf16 at rtol
    1e-3 (certified below 1e-2) and int16-delta at rtol 1e-4 (below 1e-3),
    the JAX package's recipe (tests/test_halo_wire.py), certified in
    float64 on the host from the grid (pipelined under bf16: certified,
    or not converged in 3000 iterations and saying so); the ghosts of both transports under
    each wire bit-equal to the same exchange of the same vectors on the
    CPU (the codec's plain run); the bytes of the messages of one
    exchange under each wire."""
    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.errors import AcgError, Status
    from acg_torch.parallel.halo import (halo_allgather, halo_ppermute,
                                         shard_tables, wire_itemsize)
    from acg_torch.solvers.cg_dist import cg_dist, cg_pipelined_dist

    ss = ctx["dist"]["ss_dia"].with_halo("ppermute")
    st, G = ss.tables, ctx["dist"]["grid"]
    b = np.random.default_rng(0).standard_normal(ss.nrows).astype(
        np.float32)
    gen = torch.Generator(device="cuda").manual_seed(21)
    xs = [torch.randn(o.nrows_padded, generator=gen, device="cuda") * 5.0
          + 1.0 for o in ss.local_ops]
    st_cpu = shard_tables(ss.halo, ss.ps, [torch.device("cpu")] * ss.nparts)
    xs_cpu = [x.cpu() for x in xs]
    R, S, W = st.partner.shape[1], st.max_msg, st.pack_width
    nmsg = int((st.partner >= 0).sum())
    out = {"ghosts": {}, "message_bytes": {}, "solves": {}}
    ok = True
    for wire in ("f32", "bf16", "int16-delta"):
        hdr = 8 if wire == "int16-delta" else 0
        word = wire_itemsize(wire, np.float32)
        out["message_bytes"][wire] = {
            "ppermute": nmsg * (S * word + hdr),
            "allgather": ss.nparts * (W * word + hdr)}
        bits = {}
        for name, fn, fn_st in (("ppermute", halo_ppermute, st),
                                ("allgather", halo_allgather, st)):
            got = fn(xs, fn_st, wire)
            want = fn(xs_cpu, st_cpu, wire)
            bits[name] = all(torch.equal(g.cpu(), w)
                             for g, w in zip(got, want))
        out["ghosts"][wire] = {"bit_equal_cpu": bits,
                               "ms": {n: _time_ms(
                                   lambda f=f: f(xs, st, wire), ctx["reps"])
                                   for n, f in (("ppermute", halo_ppermute),
                                                ("allgather",
                                                 halo_allgather))}}
        ok = ok and all(bits.values())
    for wire, rtol, floor in (("bf16", 1e-3, 1e-2),
                              ("int16-delta", 1e-4, 1e-3)):
        for pipelined in (False, True):
            solve = cg_pipelined_dist if pipelined else cg_dist
            opts = SolverOptions(maxits=3000, residual_rtol=rtol,
                                 halo_wire=wire, replace_every=10)
            solve(ss, b, options=SolverOptions(maxits=20, residual_rtol=0.0,
                                               halo_wire=wire))
            _reset_counts()
            try:
                res = solve(ss, b, options=opts)
            except AcgError as e:
                res = getattr(e, "result", None)
                if e.status != Status.ERR_NOT_CONVERGED or res is None:
                    raise
            launches = _counts()
            true = _poisson7_residual(G, res.x, b)
            key = f"{'pipelined' if pipelined else 'classic'}-{wire}"
            rep = _solve_report(res, launches)
            rep.update(rtol=rtol, floor=floor, converged=res.converged,
                       host_true_relative_residual=true)
            out["solves"][key] = rep
            body = "spmv" if pipelined else "fused"
            note = "format forced: dia" + (
                "; dia pipe disengaged: replace_every=10" if pipelined
                else "")
            # pipelined CG under the bf16 wire may miss the recipe's rtol
            # (its recurrences take the wire's noise; the JAX package's
            # misses it too from 32^3 on: scripts/torch_wire_drift.py),
            # but never claims it falsely
            must = not (pipelined and wire == "bf16")
            ok = ok and ((res.converged and true < floor)
                         or (not must and not res.converged
                             and res.status == Status.ERR_NOT_CONVERGED)
                         ) and (res.kernel, res.kernel_note) == (
                             f"cuda-dia-{body}+ppermute", note) and (
                             not launches["rdma_exchange"])
    out["R"], out["S"], out["pack_width"], out["messages"] = R, S, W, nmsg
    if not ok:
        raise SystemExit(f"error: dist-wire failed: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 7


def _dist_sstep_stencil(ctx, s: int = 4):
    """cg_sstep_dist (s = 4, ppermute) on the 256^3/4 stencil shards to
    the stencil phase's rtol from its right-hand side: no fallback, the
    count within s + 2 of dist-stencil's, certified in float64 on the
    host within 10 x rtol.  Counted: ONE deep exchange a block (plus b's
    once) and ONE Gram sum a block (a gram a shard), in the blocks the
    loop ran as Python (a replay repeats its capture's); stencil_spmv
    without the dot 2s a block a shard plus the 8 ordinary operator
    applications a shard (the entry residual, six power-iteration
    products, the certificate), ell_spmv on the deep interface and the
    skin 2 x 2s a block a shard plus the ordinary interface's 8 a shard,
    nothing else.  The first block's basis and Gram from the allgather
    halo bit-equal to ppermute's.  Beside it: µs/iter against
    dist-stencil's, hand-kernel launches an iteration, the deep layer's
    host seconds (BFS and tables, their upload, the operators)."""
    import importlib

    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.solvers.cg import _cheb_leja_nodes

    cgd = importlib.import_module("acg_torch.solvers.cg_dist")
    ss = ctx["dist"]["ss"].with_halo("ppermute")
    P = ss.nparts
    _, b, _xstar = ctx["stencil_case"]
    rtol = 1e-8
    dd, deep_s = _deep_layer(ctx, ss, s)
    cgd.cg_sstep_dist(ss, b, options=SolverOptions(
        maxits=8, residual_rtol=0.0, sstep=s))
    calls = {"exchange": 0, "gram": 0}
    exchange, gram = dd.exchange, cgd.gram

    def counted_exchange(*a, **k):
        calls["exchange"] += 1
        return exchange(*a, **k)

    def counted_gram(V):
        calls["gram"] += 1
        return gram(V)

    dd.exchange, cgd.gram = counted_exchange, counted_gram
    try:
        _reset_counts()
        res = cgd.cg_sstep_dist(ss, b, options=SolverOptions(
            maxits=20000, residual_rtol=rtol, sstep=s))
        launches = _read_counts(ctx, "dist-sstep-stencil")
    finally:
        del dd.exchange
        cgd.gram = gram
    rep = _solve_report(res, launches)
    its, blocks = res.niterations, res.stats.nsstepblocks
    # the blocks the loop ran as Python (the warm-up, run, and the
    # capture, which launches nothing); the replays (the first right
    # after its capture) repeat a captured block's exchange and Gram sums
    python_blocks = res.stats.nloopopen + res.stats.ncaptures
    classic = ctx["dist"]["stencil_x"][1]
    cert = _poisson7_residual(ctx["dist"]["grid"], res.x, b)
    want = {"stencil_spmv": P * (2 * s * blocks + 8),
            "ell_spmv": P * (2 * 2 * s * blocks + 8),
            "sstep_coeffs": blocks}
    others = {k: v for k, v in launches.items() if k not in want and v}
    # the first block from one (x, p) under both halos
    gen = np.random.default_rng(11)
    b_sh = ss.to_sharded(b)
    x_sh = ss.to_sharded(gen.standard_normal(ss.nrows))
    p_sh = b_sh - ss.matvec(x_sh)
    shifts = (12.0 * _cheb_leja_nodes(s)).astype(np.float64)
    first = {}
    for m in ("ppermute", "allgather"):
        V, G = cgd._sstep_block_dist(ss.with_halo(m), dd, b_sh, s, "f32",
                                     ss.devices[0])(x_sh, p_sh, shifts)
        first[m] = ([v.clone() for v in V.shards], G.clone())
    first_bits = (all(torch.equal(a, c) for a, c in
                      zip(first["ppermute"][0], first["allgather"][0]))
                  and torch.equal(first["ppermute"][1],
                                  first["allgather"][1]))
    del first, b_sh, x_sh, p_sh
    rep.update(s=s, blocks=blocks, rtol=rtol,
               certified_relative_residual=cert,
               certified_by="float64 7-point product on the host",
               dist_stencil_iterations=classic,
               dist_stencil_us_per_iter=ctx["us_per_iter"]["dist-stencil"],
               us_per_iter_over_dist_stencil=rep["us_per_iter"]
               / ctx["us_per_iter"]["dist-stencil"],
               deep_exchanges=calls["exchange"], gram_calls=calls["gram"],
               blocks_run_as_python=python_blocks,
               replays=res.stats.nreplays,
               deep_ghosts_per_shard=list(dd.nghost),
               deep_rounds=dd.nrounds, deep_host_seconds=deep_s,
               hand_kernels_per_iter=sum(launches.values()) / its,
               first_block_bits_equal_allgather=first_bits,
               **_sstep_block_times(res.stats, blocks,
                                    "dist-sstep-stencil"))
    rep["loop"] = res.loop
    ok = ((res.operator_format, res.kernel)
          == ("stencil", "cuda-stencil-spmv+ppermute") and res.converged
          and "fell back" not in res.kernel_note and res.loop == "graph"
          and "open loop" not in res.kernel_note
          and abs(its - classic) <= s + 2 and cert <= 10 * rtol
          and res.stats.nloopopen + res.stats.nreplays == blocks
          and calls["exchange"] == python_blocks + 1
          and calls["gram"] == P * python_blocks
          and all(launches[k] == v for k, v in want.items()) and not others
          and first_bits and np.all(np.isfinite(res.x))
          and res.x.shape == b.shape)
    if not ok:
        raise SystemExit(f"error: dist-sstep-stencil failed: {rep}")
    ctx.setdefault("us_per_iter", {})["dist-sstep-stencil"] = \
        rep["us_per_iter"]
    ctx["profile_cases"] = ctx.get("profile_cases", []) + [
        ("dist-sstep-stencil-f64", ss, b,
         _with_options(cgd.cg_sstep_dist, sstep=s))]
    return rep


def _dist_deep_stencil(ctx):
    """cg_pipelined_deep_dist (depth 2, ``replace_every=50``, ppermute) on
    the 256^3/4 stencil shards at deep-stencil's tolerance: no fallback,
    the count within 1 of deep-stencil's on one device, certified in
    float64 on the host within 10 x rtol.  Each dispatch's fill chain is
    ONE depth-l deep exchange (counted) feeding l extended applications:
    stencil_spmv launches P x (6 + 2 a dispatch + the bodies) + P x l a
    dispatch, ell_spmv the same plus P x l a dispatch more (the deep
    interface and the skin), the bodies between the iterations and two
    more a dispatch.  Beside it: dispatches, µs/iter against
    deep-stencil's and dist-stencil's, the deep layer's host seconds."""
    import importlib

    import numpy as np

    from acg_torch.config import SolverOptions

    cgd = importlib.import_module("acg_torch.solvers.cg_dist")
    ss = ctx["dist"]["ss"].with_halo("ppermute")
    P = ss.nparts
    _, b, _xstar = ctx["stencil_case"]
    l, rtol, R = _DEEP["depth"], _DEEP["rtol"], _DEEP["replace_every"]
    dd, deep_s = _deep_layer(ctx, ss, l)
    cgd.cg_pipelined_deep_dist(ss, b, options=SolverOptions(
        maxits=8, residual_rtol=0.0, pipeline_depth=l))
    calls = [0]
    exchange = dd.exchange

    def counted(*a, **k):
        calls[0] += 1
        return exchange(*a, **k)

    dd.exchange = counted
    try:
        _reset_counts()
        res = cgd.cg_pipelined_deep_dist(ss, b, options=SolverOptions(
            maxits=20000, residual_rtol=rtol, pipeline_depth=l,
            replace_every=R))
        launches = _read_counts(ctx, "dist-deep-stencil")
    finally:
        del dd.exchange
    rep = _solve_report(res, launches)
    note = res.kernel_note
    fallback = "fell back to classic cg" in note
    ndisp = None if fallback else int(note.split(", ")[1].split()[0])
    its = res.niterations
    cert = _poisson7_residual(ctx["dist"]["grid"], res.x, b)
    rep.update(depth=l, replace_every=R, rtol=rtol, dispatches=ndisp,
               fallback=fallback, certified_relative_residual=cert,
               certified_by="float64 7-point product on the host",
               deep_stencil_iterations=ctx["iterations"]["deep-stencil"],
               deep_stencil_us_per_iter=ctx["us_per_iter"]["deep-stencil"],
               dist_stencil_us_per_iter=ctx["us_per_iter"]["dist-stencil"],
               fill_exchanges=calls[0], deep_ghosts_per_shard=list(
                   dd.nghost), deep_rounds=dd.nrounds,
               deep_host_seconds=deep_s,
               hand_kernels_per_iter=sum(launches.values()) / its)
    ok = ((res.operator_format, res.kernel)
          == ("stencil", "cuda-stencil-spmv+ppermute") and res.converged
          and not fallback and cert <= 10 * rtol
          and abs(its - ctx["iterations"]["deep-stencil"]) <= 1
          and np.all(np.isfinite(res.x)) and res.x.shape == b.shape)
    if ok:
        bodies = (launches["stencil_spmv"] - P * l * ndisp) // P \
            - 6 - 2 * ndisp
        rep.update(bodies=bodies, loop=res.loop,
                   graph_captures=res.stats.ncaptures)
        ok = (calls[0] == ndisp
              and launches["ell_spmv"] - launches["stencil_spmv"]
              == P * l * ndisp
              and its <= bodies <= its + 2 * ndisp
              and launches["deep_coeffs"] == bodies
              and res.loop == "graph" and "open loop" not in note
              and not any(v for k, v in launches.items()
                          if k not in ("stencil_spmv", "ell_spmv",
                                       "deep_coeffs")))
    if not ok:
        raise SystemExit(f"error: dist-deep-stencil failed: {rep}")
    ctx.setdefault("us_per_iter", {})["dist-deep-stencil"] = \
        rep["us_per_iter"]
    return rep


def _graph_phase(ctx):
    """The device-resident loop (``solvers/graphs.py``) against the open
    loop on the same card: each case solved both ways through the same
    entry point (``loop="open"`` / ``"graph"``), at its phase's full
    width, and held bit for bit: x, the count, the exit, the histories
    (per system for a batch), and the launch counters, which a replay
    moves by what its capture recorded.  The cases: stencil 256^3 f64
    classic (the stencil phase's solve), pipelined-dia-bf16 (200 fixed
    iterations), batched-stencil B = 8 (60 fixed iterations),
    pipelined-replace (replace_every=50, to rtol 1e-8), dist-stencil-rdma
    and dist-pipelined-stencil-rdma (the 256^3/4 shards, to rtol 1e-8),
    a segment_iters=7 solve against its unsegmented twin (graph both),
    and a monitor_every=25 solve whose lines are held to its history;
    the s-step and deep families: sstep-stencil (s = 4, to rtol 1e-8),
    sstep-batched-stencil (B = 8, 60 fixed iterations), deep-stencil
    (l = 2, replace_every=50, 300 fixed iterations: one runner over six
    dispatches, its captures the distinct blocks), dist-sstep-stencil and
    dist-deep-stencil (the 256^3/4 shards under ppermute).  The cases of
    the s-step and deep families skip the warm-up solve: their own phases
    ran the same solves just before.  Each case reports both µs/iter, the
    captures, their host seconds and the replays."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.errors import AcgError
    from acg_torch.obs import monitor
    from acg_torch.solvers.cg import (cg, cg_pipelined, cg_pipelined_deep,
                                      cg_sstep)
    from acg_torch.solvers.cg_dist import (cg_dist, cg_pipelined_deep_dist,
                                           cg_pipelined_dist, cg_sstep_dist)

    op, b, _ = ctx["stencil_case"]
    pop, pb = ctx["pipelined_dia_bf16_case"]
    bop, bb, _ = ctx["batched_case"]
    ss = ctx["dist"]["ss"].with_halo("rdma")
    spp = ctx["dist"]["ss"].with_halo("ppermute")
    fixed = dict(residual_rtol=1e-30)
    full = dict(maxits=20000, residual_rtol=1e-8)
    # the deep cases: 300 fixed bodies in dispatches of 50, every ring
    # phase's block captured and replayed (the full solves run in their
    # own phases)
    deep = dict(maxits=300, pipeline_depth=_DEEP["depth"],
                replace_every=_DEEP["replace_every"], **fixed)
    cases = (
        ("stencil", cg, op, b, full),
        ("pipelined-dia-bf16", cg_pipelined, pop, pb,
         dict(maxits=200, residual_rtol=0.0)),
        ("batched-stencil", cg, bop, bb, dict(maxits=60, **fixed)),
        ("pipelined-replace", cg_pipelined, op, b,
         dict(full, replace_every=50)),
        ("dist-stencil-rdma", cg_dist, ss, b, full),
        ("dist-pipelined-stencil-rdma", cg_pipelined_dist, ss, b, full),
        ("sstep-stencil", cg_sstep, op, b, dict(full, sstep=4)),
        ("sstep-batched-stencil", cg_sstep, bop, bb,
         dict(maxits=60, sstep=4, **fixed)),
        ("deep-stencil", cg_pipelined_deep, op, b, deep),
        ("dist-sstep-stencil", cg_sstep_dist, spp, b, dict(full, sstep=4)),
        ("dist-deep-stencil", cg_pipelined_deep_dist, spp, b, deep),
    )

    def solve(fn, A, rhs, o, loop):
        _reset_counts()
        try:
            res = fn(A, rhs, options=SolverOptions(**o), loop=loop)
        except AcgError as e:
            if e.result is None:
                raise
            res = e.result
        return res, _counts()

    out, bad = {}, []
    for name, fn, A, rhs, o in cases:
        if fn in (cg, cg_pipelined, cg_dist, cg_pipelined_dist):
            solve(fn, A, rhs, dict(o, maxits=20), "graph")  # warm-up
        ro, co = solve(fn, A, rhs, o, "open")
        rg, cg_ = solve(fn, A, rhs, o, "graph")
        st = rg.stats
        its = max(rg.niterations, 1)
        same = {
            "x": bool(np.array_equal(rg.x, ro.x)),
            "iterations": rg.niterations == ro.niterations,
            "flag": (rg.converged, rg.status) == (ro.converged, ro.status),
            "history": bool(np.array_equal(
                rg.residual_history, ro.residual_history, equal_nan=True)),
            "per_system": (ro.iterations_per_system is None or bool(
                np.array_equal(rg.iterations_per_system,
                               ro.iterations_per_system))),
            "launches": co == cg_}
        out[name] = {"iterations": rg.niterations, "loop": rg.loop,
                     "kernel": rg.kernel, "bits_equal": same,
                     "launches_open": co, "launches_graph": cg_,
                     "us_per_iter_open": ro.stats.tsolve / its * 1e6,
                     "us_per_iter_graph": st.tsolve / its * 1e6,
                     "captures": st.ncaptures, "replays": st.nreplays,
                     "blocks_from_the_host": st.nloopopen,
                     "capture_seconds": st.tcapture}
        if not (all(same.values()) and rg.loop == "graph"
                and ro.loop == "open" and st.ncaptures >= 1
                and st.nreplays >= 1):
            bad.append(name)
    # segment_iters: the same bits as the unsegmented solve
    seg, _ = solve(cg, op, b, dict(full, segment_iters=7), "graph")
    plain, _ = solve(cg, op, b, full, "graph")
    out["segment_iters=7"] = {
        "iterations": seg.niterations, "replays": seg.stats.nreplays,
        "bits_equal_unsegmented": bool(np.array_equal(seg.x, plain.x))
        and seg.niterations == plain.niterations}
    if not out["segment_iters=7"]["bits_equal_unsegmented"]:
        bad.append("segment_iters=7")
    # monitor_every: the lines are the history's values at their counts
    lines = []

    def sink(k, rr):
        lines.append((int(k), float(rr)))

    monitor.add_monitor_sink(sink)
    try:
        with monitor.muted():
            mon, _ = solve(cg, op, b, dict(full, monitor_every=25), "graph")
    finally:
        monitor.remove_monitor_sink(sink)
    ks = [k for k, _ in lines]
    agree = (ks == list(range(25, mon.niterations + 1, 25)) and all(
        rr == mon.residual_history[k] for k, rr in lines))
    out["monitor_every=25"] = {"lines": len(lines), "first": lines[:2],
                               "lines_match_history": agree}
    if not agree:
        bad.append("monitor_every=25")
    if bad:
        raise SystemExit(f"error: graph loop differs from the open loop "
                         f"in {bad}: {json.dumps(out, default=str)}")
    return out


def _serve_phase(ctx):
    """The serve path (``acg_torch/serve/``) on the stencil phase's 256^3
    f64 operator: one ``Session`` (the operator as built there) and
    ``SolverService``s with ``max_batch=8, buckets=(1, 4, 8)``, each
    request's response required ``ok``.  Classic 1-D: a request cold (the
    signature's state built, its blocks captured), the same request warm
    (no capture, no warm-up block: ``ncaptures == nloopopen == 0``), bit
    for bit the ordinary ``cg`` on the card, µs/iter of all three.
    Coalescing: 8 requests submitted from 8 threads (a service that waits
    for batch-mates) run as ONE bucket-8 dispatch (the bucket's first, so
    its captures happen while seven threads wait), each demuxed result bit
    for bit the same request served alone through bucket 8 (padded with
    its replicas; no capture there) and certified on the card within 10 x
    rtol.  Pipelined (``replace_every=50``) and deep (depth 2,
    ``replace_every=50``): cold then warm, the same checks, the deep solve
    making no capture in any of its warm dispatches.  Shards: the
    dist-stencil-rdma system (4 on one card) through its own session,
    classic, cold then warm, bits against ``cg_dist``.  Each signature's
    device memory (``torch.cuda.memory_allocated`` around its cold
    dispatch) and what ``Session.close`` gives back are printed; the
    ordinary solves run first, so the workspaces the libraries keep a
    stream are made before the first reading.  The 8 right-hand sides are A x_i, x_i
    normal from seeds 190-197."""
    import threading

    import numpy as np
    import torch

    from acg_torch.config import SolverOptions
    from acg_torch.serve import Session, SolverService
    from acg_torch.serve.queue import demux_result
    from acg_torch.solvers.cg import cg, cg_pipelined, cg_pipelined_deep
    from acg_torch.solvers.cg_dist import cg_dist

    op, b, _ = ctx["stencil_case"]
    rtol = 1e-8
    o_cg = SolverOptions(maxits=20000, residual_rtol=rtol)
    o_pipe = SolverOptions(maxits=20000, residual_rtol=rtol, replace_every=50)
    o_deep = SolverOptions(maxits=20000, residual_rtol=rtol,
                           pipeline_depth=_DEEP["depth"],
                           replace_every=_DEEP["replace_every"])
    ss = ctx["dist"]["ss"].with_halo("rdma")

    def mem() -> int:
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def bits(r1, r2) -> bool:
        return (r1.niterations == r2.niterations
                and bool(np.array_equal(r1.x, r2.x))
                and bool(np.array_equal(r1.residual_history,
                                        r2.residual_history,
                                        equal_nan=True)))

    def timing(res) -> dict:
        st = res.stats
        return {"wall_s": st.tsolve,
                "us_per_iter": st.tsolve / max(res.niterations, 1) * 1e6,
                "captures": st.ncaptures, "replays": st.nreplays,
                "blocks_from_the_host": st.nloopopen,
                "capture_seconds": st.tcapture}

    out, bad = {}, []
    # the ordinary solves first: they also make what the card's libraries
    # allocate once a stream (cuBLAS workspaces), so the memory the
    # sessions hold and free is measured from after them
    refs = {"classic": cg(op, b, options=o_cg),
            "pipelined": cg_pipelined(op, b, options=o_pipe),
            "deep": cg_pipelined_deep(op, b, options=o_deep),
            "dist": cg_dist(ss, b, options=o_cg)}

    def cold_warm(name, svc, rhs):
        m0 = mem()
        _reset_counts()
        cold = svc.solve(rhs)
        m1 = mem()
        warm = svc.solve(rhs)
        launches = _read_counts(ctx, f"serve-{name}")
        ref = refs[name]
        ok = cold.ok and warm.ok
        rep = {"iterations": warm.result.niterations if ok else None,
               "kernel": warm.result.kernel if ok else None,
               "kernel_note": warm.result.kernel_note if ok else None,
               "cache_hit": [cold.cache_hit, warm.cache_hit],
               "resident_bytes": m1 - m0, "launches_cold_and_warm": launches,
               "status": [cold.status, warm.status]}
        if ok:
            rep.update(cold=timing(cold.result), warm=timing(warm.result),
                       ordinary=timing(ref),
                       bits_equal=bits(warm.result, ref)
                       and bits(cold.result, ref),
                       # the shards' x in the global ordering: the same
                       # matrix as the one-card operator's
                       true_relative_residual=_true_residual(
                           op, warm.result.x, rhs))
        if not (ok and rep["bits_equal"] and not cold.cache_hit
                and warm.cache_hit and rep["warm"]["captures"] == 0
                and rep["warm"]["blocks_from_the_host"] == 0
                and rep["cold"]["captures"] >= 1
                and warm.result.loop == "graph"):
            bad.append(name)
        out[name] = rep

    mem0 = mem()
    sess = Session(op, options=o_cg, device="cuda", share_prepared=False)
    kw = dict(max_batch=8, buckets=(1, 4, 8))
    svc = SolverService(sess, solver="cg", options=o_cg, **kw)
    cold_warm("classic", svc, b)

    # 8 threads, one bucket-8 dispatch: a service that waits for
    # batch-mates (the 8th submit dispatches on its thread); b_i = A x_i
    svc8 = SolverService(sess, solver="cg", options=o_cg,
                         max_wait_ms=120_000.0, **kw)
    vdt = getattr(torch, op.vec_dtype)
    rhs = []
    for i in range(8):
        xi = torch.zeros(op.nrows_padded, dtype=vdt, device="cuda")
        xi[: op.nrows] = torch.from_numpy(
            np.random.default_rng(190 + i).standard_normal(op.nrows))
        rhs.append(op.matvec(xi)[: op.nrows].cpu().numpy())
    resps = [None] * 8
    gate = threading.Barrier(8)

    def client(i):
        gate.wait()
        resps[i] = svc8.submit(rhs[i]).response()

    batches0 = svc8.queue.counters["batches"]
    m0 = mem()
    _reset_counts()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    launches8 = _read_counts(ctx, "serve-coalesced")
    m8 = mem()
    nbatches = svc8.queue.counters["batches"] - batches0
    entry = sess.executable(solver="cg", nrhs=8)
    coal = {"batches": nbatches, "resident_bytes": m8 - m0,
            "batch_sizes": [r.batch_size for r in resps],
            "buckets": [r.bucket for r in resps],
            "statuses": [r.status for r in resps],
            "captures_of_the_dispatch": entry.ncaptures,
            "launches": launches8}
    ok8 = (nbatches == 1 and all(r.ok for r in resps)
           and all(r.bucket == 8 and r.batch_size == 8 for r in resps))
    if ok8:
        coal["dispatch_wall_s"] = resps[0].wall
        coal["us_per_iter"] = (resps[0].result.stats.tsolve
                               / max(r.result.niterations for r in resps)
                               * 1e6)
        alone, same, certified, warm_caps = [], [], [], []
        for i, (r, bi) in enumerate(zip(resps, rhs)):
            res = sess.solve(np.stack([bi] * 8), solver="cg", options=o_cg)
            warm_caps.append(res.stats.ncaptures)
            alone.append(res.stats.tsolve)
            same.append(bits(r.result, demux_result(
                res, 0, float(np.linalg.norm(bi)))))
            certified.append(_true_residual(op, r.result.x, bi))
        coal.update(bits_equal=same, true_relative_residual=certified,
                    alone_captures=warm_caps, alone_wall_s=alone,
                    iterations=[r.result.niterations for r in resps])
        ok8 = (all(same) and max(certified) <= 10 * rtol
               and not any(warm_caps) and entry.ncaptures >= 1)
    if not ok8:
        bad.append("coalesced")
    out["coalesced"] = coal

    cold_warm("pipelined", SolverService(sess, solver="cg-pipelined",
                                         options=o_pipe, **kw), b)
    cold_warm("deep", SolverService(sess, solver="cg-pipelined-deep",
                                    options=o_deep, **kw), b)
    sess_d = Session(ss, options=o_cg, share_prepared=False)
    cold_warm("dist", SolverService(sess_d, solver="cg", options=o_cg, **kw),
              b)
    held = mem()
    stats = svc.stats()["session"]
    sess_d.close()
    sess.close()
    left = mem() - mem0
    out["session"] = {"cache": stats["cache"], "signatures":
                      stats["signatures"], "walls": stats["walls"],
                      "solves": stats["solves"]}
    out["memory"] = {"held_before_close": held - mem0,
                     "left_after_close": left}
    # every signature's state comes back with close(): what stays is
    # under half the smallest state, the libraries' workspaces that the
    # client thread's handle made for the streams it met (the coalesced
    # dispatch runs on a client thread; the card tests hold close() to
    # 1 MiB in one thread)
    smallest = min(out[k]["resident_bytes"]
                   for k in ("classic", "pipelined", "deep", "dist"))
    if left >= smallest // 2:
        bad.append("memory")
    out["bits_equal"] = not bad
    if bad:
        raise SystemExit(f"error: serve phase failed in {bad}: "
                         f"{json.dumps(out, default=str)}")
    return out


def _cli_serve_phase(G: int):
    """``acg_torch.cli.main`` with ``--serve`` on the 48^3 Poisson .mtx,
    in this process: a command file with ``solve``, ``batch 4``,
    ``stats``, a right-hand side of the wrong length (refused at
    admission, its own JSON line) and ``quit``.  One JSON line a request
    (5 solved, 1 refused), the stats line, exit code 1 (a request
    failed, the refused one)."""
    import contextlib
    import io

    import numpy as np

    from acg_torch import cli
    from acg_torch.io.mtxfile import MtxFile, vector_to_mtx, write_mtx
    from acg_torch.obs.metrics import disable_metrics
    from acg_torch.sparse.poisson import poisson3d_7pt

    A = poisson3d_7pt(G)
    r, c, v = A.to_coo()
    (REPO / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = os.path.join(tmp, "A.mtx")
        write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                                rowidx=r, colidx=c, vals=v))
        short = os.path.join(tmp, "short.mtx")
        write_mtx(short, vector_to_mtx(np.ones(7)))
        cmds = os.path.join(tmp, "requests.txt")
        with open(cmds, "w") as f:
            f.write(f"solve\nbatch 4\nstats\nsolve {short}\nquit\n")
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([path, "--serve", cmds, "--manufactured-solution",
                           "--max-iterations", "2000", "--metrics", "-v"])
    # --metrics turned the process registry on; the later phases run
    # without it, as before
    disable_metrics()
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    reqs = [d for d in lines if "request" in d]
    stats = [d for d in lines if "session" in d]
    solved = [d for d in reqs if d["ok"]]
    refused = [d for d in reqs if not d["ok"]]
    ok = (rc == 1 and len(solved) == 5 and len(refused) == 1
          and refused[0]["status"] == "ERR_INVALID_VALUE"
          and [d["bucket"] for d in solved] == [1, 4, 4, 4, 4]
          and len(stats) == 1
          and stats[0]["queue"]["batches"] == 2)
    if not ok:
        raise SystemExit(f"error: CLI serve run failed (exit {rc}):\n"
                         f"{out.getvalue()}\n{err.getvalue()}")
    return {"grid": [G] * 3, "exit": rc, "requests": reqs,
            "cache": stats[0]["session"]["cache"],
            "wall_s": time.perf_counter() - t0}


# the introspection phase: the solves it prices (phase, profile case,
# solver, s), and an empty kernel whose replay in a CUDA graph is the
# least a launch takes
_PRICED = (("stencil", "stencil-f64", "cg", 0),
           ("pipelined-stencil", "pipelined-stencil-f64", "cg-pipelined", 0),
           ("dia-bf16", "dia-bf16-f32", "cg", 0),
           ("dia-100m", "dia-100m-f32", "cg", 0),
           ("batched-stencil", "batched-stencil-f64", "cg", 0),
           ("fem-sgell", "fem-sgell-float32", "cg", 0),
           ("fem-ell", "fem-ell-float64", "cg", 0),
           ("sstep-stencil", "sstep-stencil-f64", "cg-sstep", 4),
           ("dist-stencil-rdma", "dist-stencil-rdma-f64", "cg", 0))
_EMPTY_KERNEL = """
#include <cuda_runtime.h>
__global__ void acg_empty_kernel() {}
extern "C" int acg_empty_launch(void *stream) {
    acg_empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""


def _empty_kernel_build():
    """Start nvcc on the empty kernel: (the library's path, the process)."""
    from acg_torch import _build

    out = REPO / "build" / "empty_kernel"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "empty.cu"
    src.write_text(_EMPTY_KERNEL)
    lib = out / "libempty.so"
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def _latency_bound(lib_path, proc, ctx) -> dict:
    """ms of one launch of an empty kernel captured in a CUDA graph,
    replayed 25 times queued (and one replay between events): the least a
    launch of a dependent scalar chain can take on this card."""
    import ctypes

    import torch

    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"error: the empty kernel did not build:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    lib.acg_empty_launch.argtypes = [ctypes.c_void_p]
    lib.acg_empty_launch.restype = ctypes.c_int
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        rc = lib.acg_empty_launch(ctypes.c_void_p(stream.cuda_stream))
        graph.capture_begin()
        rc |= lib.acg_empty_launch(ctypes.c_void_p(stream.cuda_stream))
        graph.capture_end()
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"error: the empty kernel did not launch: {rc}")
    rows = {}
    for r in ctx["rows"]:
        if r["name"] in ("sstep_coeffs", "deep_coeffs"):
            rows.setdefault(r["name"], r)     # the f64, one-system rows
    out = {"graph_replay_ms_queued": _queued_ms(graph.replay),
           "graph_replay_ms": _time_ms(graph.replay, ctx["reps"])}
    for name, row in rows.items():
        out[name] = {"ms": row["ms"], "ms_queued": row.get("ms_queued"),
                     "over_latency_bound": (row.get("ms_queued")
                                            or row["ms"])
                     / out["graph_replay_ms_queued"]}
    return out


def _copy_rate(ctx) -> dict:
    """The card's device-to-device ``copy_`` of 1 GiB (bytes read and
    written over CUDA-event time) beside the roofline table's rate."""
    import torch

    from acg_torch.obs.roofline import hbm_gbps_for

    n = (1 << 30) // 4
    src = torch.ones(n, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = _time_ms(lambda: dst.copy_(src), 10)
    del src, dst
    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0)
    return {"copy_bytes": 2 << 30, "copy_ms": ms,
            "copy_gbps": (2 << 30) / ms / 1e6,
            "table_gbps": hbm_gbps_for(name), "data_sheet_bytes_per_s":
            ctx["mem_bw"]}


def _per_op_table(st) -> dict:
    return {nm: {"seconds_each": (c.t / c.n if c.n else 0.0), "n": c.n,
                 "bytes": c.bytes, "flops": c.flops,
                 "gbps": 1e-9 * c.bytes / c.t if c.t > 0 else 0.0}
            for nm in ("gemv", "dot", "nrm2", "axpy", "copy", "allreduce",
                       "halo")
            for c in (getattr(st, nm),)}


def _introspection_phase(G: int, ctx):
    """The port's own measuring surface on the earlier phases' operators
    and results (see the module's text)."""
    import numpy as np

    from acg_torch.config import SolverOptions
    from acg_torch.io.mtxfile import MtxFile, write_mtx
    from acg_torch.obs.audit import audit_solver
    from acg_torch.obs.export import load_stats_document
    from acg_torch.obs.roofline import (roofline_for_operator,
                                        roofline_for_sharded)
    from acg_torch.parallel.sharded import ShardedSystem
    from acg_torch.solvers.base import SolveStats
    from acg_torch.sparse.poisson import poisson3d_7pt
    from acg_torch.utils.profile import profile_dist_ops, profile_ops

    lib, proc = _empty_kernel_build()
    cases = {c[0]: c for c in ctx["profile_cases"]}
    rep, bad = {"roofline": {}}, []
    for phase, case, solver, s in _PRICED:
        _, op, b, _solve = cases[case]
        nrhs = b.shape[0] if np.ndim(b) == 2 else 1
        if isinstance(op, ShardedSystem):
            model = roofline_for_sharded(op, solver=solver, nrhs=nrhs)
        else:
            model = roofline_for_operator(op, solver=solver, nrhs=nrhs,
                                          sstep=s)
        us = ctx["us_per_iter"][phase]
        frac = model.frac(1e6 / us)
        rep["roofline"][phase] = {
            "us_per_iter": us, "bound_us_per_iter": model.bound_us_per_iter,
            "roofline_frac": frac, "bytes_per_iter": model.bytes_per_iter,
            "operator_bytes": model.operator_bytes,
            "vector_bytes": model.vector_bytes, "nrhs": nrhs,
            "ncards": model.ncards}
        if not 0 < frac <= 1.0:
            bad.append(f"{phase}: roofline_frac {frac}")
    rep["bandwidth"] = _copy_rate(ctx)

    # per-op times on the stencil operator and the rdma shards
    _, op, _, _ = cases["stencil-f64"]
    _, ss, _, _ = cases["dist-stencil-rdma-f64"]
    its = ctx["classic_iterations"]
    st = profile_ops(op, SolveStats(), its)
    st_dist = profile_dist_ops(ss, SolveStats(), its)
    rep["per_op"] = {"stencil": _per_op_table(st),
                     "dist-stencil-rdma": _per_op_table(st_dist)}
    row = [r for r in ctx["rows"] if r["name"] == "stencil_spmv"
           and r["tier"] == "matrix-free/float64" and not r["with_dot"]
           and r["grid"] == [256, 256, 256]][0]
    gemv_ms = st.gemv.t / st.gemv.n * 1e3
    rep["per_op"]["gemv_ms_over_kernels_row"] = gemv_ms / row["ms"]
    if abs(gemv_ms / row["ms"] - 1) > 0.25:
        bad.append(f"gemv {gemv_ms} ms against stencil_spmv {row['ms']}")

    # the counted audit: one card, then the rdma shards
    o = SolverOptions(residual_rtol=1e-8)
    one = audit_solver(op, options=o)
    dist = audit_solver(ss, options=o)
    rep["audit"] = {"stencil": one.as_dict(),
                    "dist-stencil-rdma": dist.as_dict()}
    comm = ("ppermute", "allgather", "rdma", "allreduce")
    want_one = {c: 0 for c in comm}
    want_dist = dict(ppermute=0, allgather=0, rdma=1, allreduce=2)
    for a, want, per in ((one, want_one, 1), (dist, want_dist, 4)):
        got = {c: a.count(c) for c in comm}
        launches = {k: a.launches[k] for k in ("stencil_spmv", "cg_update")}
        if got != want or launches != {"stencil_spmv": per,
                                       "cg_update": per} \
                or a.host_reads != 1:
            bad.append(f"audit: {got} {launches} reads {a.host_reads}")

    # the CLI with all six flags on the 48^3 .mtx
    A = poisson3d_7pt(G)
    r, c, v = A.to_coo()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = os.path.join(tmp, "A.mtx")
        write_mtx(path, MtxFile(nrows=A.nrows, ncols=A.ncols, nnz=A.nnz,
                                rowidx=r, colidx=c, vals=v))
        doc, trace = os.path.join(tmp, "s.json"), os.path.join(tmp, "t.json")
        prof = os.path.join(tmp, "prof")
        rc, out, err = _cli_main(
            [path, "--manufactured-solution", "--max-iterations", "2000",
             "-q", "--explain", "--per-op-stats", "--hbm-gbps", "3350",
             "--output-stats-json", doc, "--trace-json", trace,
             "--profile", prof])
        cli = {"exit": rc}
        try:
            d = load_stats_document(doc)
            cli["roofline_frac"] = d["introspection"]["roofline"][
                "roofline_frac"]
            cli["comm_audit_launches"] = d["introspection"]["comm_audit"][
                "launches"]["per_iteration"]
            spans = {e["name"] for e in json.load(open(trace))["traceEvents"]
                     if e["ph"] == "X"}
            cli["spans"] = sorted(spans)
            texts = [open(os.path.join(prof, f)).read()
                     for f in os.listdir(prof)]
            cli["profile_names_stencil_kernel"] = any(
                "stencil" in t for t in texts)
        except (OSError, ValueError, KeyError, TypeError) as e:
            cli["error"] = repr(e)
        if (rc != 0 or "error" in cli
                or not {"read", "operator-build", "solve"} <= set(
                    cli.get("spans", ()))
                or not cli.get("profile_names_stencil_kernel")):
            bad.append(f"CLI: {cli}\n{out[-2000:]}\n{err[-2000:]}")
    rep["cli"] = cli
    rep["latency_bound"] = _latency_bound(lib, proc, ctx)
    if bad:
        raise SystemExit("error: introspection: " + "; ".join(bad)
                         + f"\n{json.dumps(rep, default=str)[:4000]}")
    return rep


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _takes_loop(solve) -> bool:
    import inspect

    return "loop" in inspect.signature(solve).parameters


def _fixed_solve(solve, op, b, its: int, every: int = 1, loop=None):
    """A solve of exactly ``its`` iterations that still tests for
    convergence (rtol 1e-30 is never met), so the host reads the loop's
    flag every ``every`` iterations as a solve to a tolerance does (with
    every criterion off the pipelined loop has no exit to test and never
    reads it).  ``loop``: "graph" or "open" (None: the solver's
    default)."""
    from acg_torch.config import SolverOptions
    from acg_torch.errors import AcgError, Status

    kw = {} if loop is None else {"loop": loop}
    try:
        res = solve(op, b, options=SolverOptions(
            maxits=its, residual_rtol=1e-30, check_every=every), **kw)
    except AcgError as e:
        res = getattr(e, "result", None)
        if e.status != Status.ERR_NOT_CONVERGED or res is None:
            raise
    if res.niterations != its or "fell back" in res.kernel_note:
        raise SystemExit(f"error: a {its}-iteration profile solve ran "
                         f"{res.niterations}: {res.kernel_note}")
    return res


# profiled iterations a case: 50, and 150 (three dispatches of 50) for the
# deep pipeline, whose graph loop captures each of its ring phases' blocks
# (22 at l = 2) once a solve, after running it once as Python: 50 bodies
# would be mostly those
_PROFILE_ITS = {"deep-stencil-f64": 150}


def _profile_phase(ctx):
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, op, b, solve in ctx.get("profile_cases", []):
        its_p = _PROFILE_ITS.get(name, 50)
        # b already padded on the card, so the profiled window holds the
        # loop and not the upload of b (a distributed solve scatters its
        # host b to the shards before its clock starts)
        b_dev = b
        if hasattr(op, "nrows_padded"):
            vdt = getattr(torch, op.vec_dtype)
            b_dev = torch.zeros(b.shape[:-1] + (op.nrows_padded,), dtype=vdt)
            b_dev[..., : op.nrows] = torch.from_numpy(b.astype(op.vec_dtype))
            b_dev = b_dev.cuda()
        _fixed_solve(solve, op, b_dev, its_p)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = _fixed_solve(solve, op, b_dev, its_p)
        # device-side events only: the CPU ops that launched them carry
        # the same time again; the host's launches are the runtime calls
        # that launch a kernel or a graph
        per_name, copies, nkernels, host = {}, 0.0, 0, {}
        for e in prof.key_averages():
            if e.key.startswith(("cudaLaunch", "cuLaunch",
                                 "cudaGraphLaunch")):
                host[e.key] = host.get(e.key, 0) + e.count
            if not (str(getattr(e, "device_type", "")).endswith("CUDA")
                    and _device_us(e) > 0):
                continue
            if e.key.startswith(("Memcpy", "Memset")):
                copies += _device_us(e)
                continue
            key = e.key[:70]
            per_name[key] = per_name.get(key, 0.0) + _device_us(e)
            nkernels += e.count
        its = res.niterations
        busy = sum(per_name.values())
        # the captures' host seconds are set-up the card waits through:
        # the idle share is of the loop's own time
        wall = (res.stats.tsolve - res.stats.tcapture) * 1e6
        rate = {}
        loops = ("graph", "open") if _takes_loop(solve) else (None,)
        for loop in loops:
            for every in (1, 16):
                its_r = max(100, its_p)
                r = _fixed_solve(solve, op, b_dev, its_r, every, loop)
                key = (f"check_every={every}" if loop is None
                       else f"{loop}, check_every={every}")
                rate[key] = {"us_per_iter": r.stats.tsolve / its_r * 1e6,
                             "capture_s": r.stats.tcapture}
        out[name] = {
            "iterations": its,
            "loop": res.loop,
            "wall_us_per_iter": wall / its,
            "kernel_busy_us_per_iter": busy / its,
            "device_idle_share": 1.0 - busy / wall,
            "copies_us_total": copies,
            "kernel_launches_per_iter": nkernels / its,
            "host_launches_per_iter": sum(host.values()) / its,
            "host_launch_calls": host,
            "graph_captures": res.stats.ncaptures,
            "capture_seconds": res.stats.tcapture,
            "kernel_us_per_iter": {
                k: v / its for k, v in sorted(per_name.items(),
                                              key=lambda kv: -kv[1])},
            "us_per_iter_without_profiler": rate}
        torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# the kernels line


def _gap_ranking(lines) -> dict:
    """Per kernel, launches x (ms - bound_ms) summed over the solve
    phases of the kernels line: the device time its launches lose to
    the bound, largest first (the order in which to redesign them)."""
    out = {}
    for k in lines:
        name = k["name"].split(":")[0]
        out[name] = out.get(name, 0.0) + k["launches"] * (k["ms"]
                                                          - k["bound_ms"])
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _kernel_lines(ctx) -> list:
    """One entry per kernel and tier that a solve phase runs: the launches
    of that phase alone, beside the phase-2 numbers of the configuration
    its loop runs (the phase's band and vector types; the fused dot in
    classic CG, none in the open-coded pipelined body)."""
    meta = {"cg_update": ("acg_torch/csrc/cg_update.cu",
                          "acg_tpu/solvers/loops.py:222", None),
            "sstep_coeffs": ("acg_torch/csrc/sstep_coeffs.cu",
                             "acg_tpu/solvers/loops.py:419", None),
            "deep_coeffs": ("acg_torch/csrc/deep_coeffs.cu",
                            "acg_tpu/solvers/loops.py:1143", None),
            "dia_spmv": ("acg_torch/csrc/dia_spmv.cu",
                         "acg_tpu/ops/pallas_kernels.py:189",
                         "acg_tpu/ops/pallas_kernels.py:97"),
            "stencil_spmv": ("acg_torch/csrc/stencil_spmv.cu",
                             "acg_tpu/ops/stencil.py:359", None),
            "cg_pipelined_iter": ("acg_torch/csrc/dia_pipe.cu",
                                  "acg_tpu/ops/pallas_kernels.py:291",
                                  None),
            "cg_pipelined_iter_stencil": ("acg_torch/csrc/stencil_pipe.cu",
                                          "acg_tpu/ops/stencil.py:504",
                                          None),
            "dia_spmv_batched": ("acg_torch/csrc/dia_spmv_batched.cu",
                                 "acg_tpu/ops/pallas_kernels.py:382",
                                 "acg_tpu/ops/pallas_kernels.py:431"),
            "stencil_spmv_batched": ("acg_torch/csrc/stencil_spmv_batched.cu",
                                     "acg_tpu/ops/stencil.py:423", None),
            "ell_spmv": ("acg_torch/csrc/ell_spmv.cu",
                         "acg_tpu/ops/pallas_spmv.py:51", None),
            "sgell_spmv": ("acg_torch/csrc/sgell_spmv.cu",
                           "acg_tpu/ops/sgell.py:284", None),
            "dia_spmv_ring": ("acg_torch/csrc/dia_hbm_ring.cu",
                              "acg_tpu/ops/pallas_kernels.py:767", None),
            "dia_spmv_windows": ("acg_torch/csrc/dia_hbm_windows.cu",
                                 "acg_tpu/ops/pallas_kernels.py:600",
                                 None),
            "rdma_exchange": ("acg_torch/csrc/rdma_halo.cu",
                              "acg_tpu/parallel/rdma_halo.py:79", None)}
    # (kernel, phase-2 tier, solve phase, with_dot of the loop's calls;
    # None for the pipelined-iteration and unstructured kernels, which have
    # no such row key)
    paths = (("sstep_coeffs", "f64 s=4 B=1", "sstep-stencil", None),
             ("sstep_coeffs", "f64 s=4 B=8",
              "sstep-batched-stencil", None),
             ("sstep_coeffs", "f64 s=4 B=1", "dist-sstep-stencil", None),
             ("sstep_coeffs", "f32 s=4 B=1", "sstep-dia-bf16", None),
             ("deep_coeffs", "f64 l=2 B=1", "deep-stencil", None),
             ("deep_coeffs", "f64 l=2 B=1", "dist-deep-stencil", None),
             ("cg_update", "f64 256^3", "stencil", None),
             ("cg_update", "f64 256^3 B=8", "batched-stencil", None),
             ("cg_update", "f64 256^3/4 shard", "dist-stencil-rdma", None),
             ("cg_update", "f32 464^3", "dia-100m", None),
             ("stencil_spmv", "matrix-free/float64", "stencil", True),
             ("dia_spmv", "bf16/f32 128^3", "dia-bf16-128", True),
             ("dia_spmv_windows", "bf16/f32 256^3", "dia-bf16", True),
             ("dia_spmv_windows", "bf16/f32 256^3", "pipelined-dia-bf16",
              True),
             ("dia_spmv", "f64/f64", "dia-f64", True),
             ("cg_pipelined_iter_stencil", "matrix-free/float64",
              "pipelined-stencil", None),
             ("cg_pipelined_iter", "bf16/f32", "pipelined-dia-bf16", None),
             ("cg_pipelined_iter", "f64/f64", "pipelined-dia-f64", None),
             ("stencil_spmv_batched", "matrix-free/float64",
              "batched-stencil", True),
             ("dia_spmv_batched", "bf16/f32", "batched-dia-bf16", True),
             ("dia_spmv_batched", "f64/f64", "batched-dia-f64", True),
             ("stencil_spmv_batched", "matrix-free/float64",
              "batched-pipelined-stencil", False),
             ("stencil_spmv", "matrix-free/float64", "sstep-stencil", False),
             ("stencil_spmv_batched", "matrix-free/float64",
              "sstep-batched-stencil", False),
             ("dia_spmv_windows", "bf16/f32 256^3", "sstep-dia-bf16", False),
             ("stencil_spmv", "matrix-free/float64", "deep-stencil", False),
             ("stencil_spmv", "matrix-free/float64", "recycled-stencil",
              True),
             ("dia_spmv", "f64/f64", "rcm-dia", True),
             ("cg_pipelined_iter", "f64/f64", "rcm-dia-pipelined", None),
             ("sgell_spmv", "f32/f32 fem3d-1m", "fem-sgell", None),
             ("sgell_spmv", "f32/f32 fem3d-1m", "pipelined-fem-sgell", None),
             ("sgell_spmv", "f32/f32 fem3d-1m", "batched-fem-sgell", None),
             ("ell_spmv", "f64/f64 fem3d-1m", "fem-ell", None),
             ("ell_spmv", "f64/f64 fem3d-1m", "pipelined-fem-ell", None),
             ("dia_spmv_windows", "bf16/f32 464^3", "dia-100m", True),
             ("dia_spmv_windows", "bf16/f64 464^3", "dia-100m-f64", True),
             ("dia_spmv_ring", "bf16/f32 10000^2", "p2d", True),
             ("dia_spmv_windows", "bf16/f32 10000^2", "p2d-windows", True),
             ("stencil_spmv", "matrix-free/float64 256^3/4 shard",
              "dist-stencil-rdma", True),
             ("ell_spmv", "bf16/f64 interface 256^3/4",
              "dist-stencil-rdma", None),
             ("rdma_exchange", "f64 256^3/4", "dist-stencil-rdma", None),
             ("dia_spmv", "bf16/f32 256^3/4 shard", "dist-dia-bf16", True),
             ("sgell_spmv", "f32/f32 fem3d-1m/4 shard", "dist-fem-sgell",
              None),
             ("ell_spmv", "f32 interface fem3d-1m/4", "dist-fem-sgell",
              None),
             ("ell_spmv", "f64/f64 fem3d-1m/4 shard", "dist-fem-ell", None),
             ("ell_spmv", "f64 interface fem3d-1m/4", "dist-fem-ell", None),
             ("cg_pipelined_iter_stencil",
              "matrix-free/float64 256^3/4 shard",
              "dist-pipelined-stencil-rdma", None),
             ("ell_spmv", "bf16/f64 interface 256^3/4",
              "dist-pipelined-stencil-rdma", None),
             ("rdma_exchange", "f64 256^3/4", "dist-pipelined-stencil-rdma",
              None),
             ("cg_pipelined_iter", "bf16/f32 256^3/4 shard",
              "dist-pipelined-dia-bf16", None),
             ("stencil_spmv_batched", "matrix-free/float64 256^3/4 shard",
              "dist-batched-stencil", True),
             ("stencil_spmv_batched", "matrix-free/float64 256^3/4 shard",
              "dist-batched-pipelined-stencil", False),
             ("stencil_spmv", "matrix-free/float64 256^3/4 shard",
              "dist-sstep-stencil", False),
             ("ell_spmv", "bf16/f64 deep interface d4 256^3/4",
              "dist-sstep-stencil", None),
             ("ell_spmv", "bf16/f64 deep skin d4 256^3/4",
              "dist-sstep-stencil", None),
             ("ell_spmv", "bf16/f64 interface 256^3/4",
              "dist-sstep-stencil", None),
             ("stencil_spmv", "matrix-free/float64 256^3/4 shard",
              "dist-deep-stencil", False),
             ("ell_spmv", "bf16/f64 deep interface d2 256^3/4",
              "dist-deep-stencil", None),
             ("ell_spmv", "bf16/f64 deep skin d2 256^3/4",
              "dist-deep-stencil", None),
             ("ell_spmv", "bf16/f64 interface 256^3/4",
              "dist-deep-stencil", None))
    out = []
    for kernel, tier, phase, with_dot in paths:
        row = next(r for r in ctx["rows"] if r["name"] == kernel
                   and r["tier"] == tier and r.get("with_dot") == with_dot)
        src, repl, also = meta[kernel]
        entry = {"name": f"{kernel}:{tier}", "route": "cuda",
                 "source": src, "replaces": repl,
                 "launches": ctx["phase_launches"][phase][kernel],
                 "max_abs_err": row["max_abs_err"],
                 "ms": row["ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"],
                 "config": (f"{tier}, phase {phase}" if with_dot is None
                            else f"{tier}, with_dot={with_dot}, "
                                 f"phase {phase}")}
        if also:
            entry["also_replaces"] = also
        if kernel == "cg_update":
            entry["note"] = ("no Pallas counterpart: XLA fused x + alpha p, "
                             "r - alpha t and dot(r, r) into the JAX loop")
        elif kernel in ("sstep_coeffs", "deep_coeffs"):
            entry["note"] = ("no Pallas counterpart: XLA compiled this "
                             "scalar work into the JAX loop; latency-bound")
        for key in ("composed_ms", "nrhs", "one_system_calls_ms",
                    "per_system_bits_equal_1d", "S", "fill", "width",
                    "bits_equal_plain", "bits_equal_sliced_matvec",
                    "flags_counts_changed_equal", "bodies_checked",
                    "stored_entries", "layout_fill", "sigma", "unroll",
                    "stream_bytes", "work_bytes", "stream_over_entries",
                    "padded_bytes",
                    "dia_spmv_ms", "bits_equal_dia_spmv",
                    "plan", "P", "R", "S", "chunks_per_slot",
                    "chunk_words", "scope", "ms_queued",
                    "ghosts_bit_equal_plain_ppermute_allgather", "halo_ms",
                    "halo_ms_queued", "halo_bound_ms",
                    "library", "grid", "rows", "ghosts", "route",
                    "bits_equal_generic", "pipe_fixed", "depth",
                    "deep_ghosts",
                    "columns", "columns_read", "shape", "dot_rel_err",
                    "dot_bits_stable"):
            if key in row:
                entry[key] = row[key]
        # one counter a kernel: two configurations of it in one phase
        # (dist-fem-ell's local and interface ELL) show the same count
        twins = [f"{k}:{t}" for k, t, ph, _ in paths
                 if k == kernel and ph == phase and t != tier]
        if twins:
            entry["launches_shared_with"] = twins
        out.append(entry)
    return out


if __name__ == "__main__":
    sys.exit(main())
