"""``chip_smoke.py --only``: the phase filter picks the named phases with
the build and, transitively, the phases they read or are held against,
in the script's order, and refuses a name it does not know.  The card is
never reached: ``_context`` is replaced by one that finds no card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def _run(monkeypatch, argv):
    """main(argv) with no card; returns (rc, the phases it would run)."""
    seen = {}
    pick = chip_smoke._selected

    def spy(phases, only):
        run = pick(phases, only)
        seen["run"] = [p[0] for p in phases if p[0] in run]
        seen["all"] = [p[0] for p in phases]
        return run

    monkeypatch.setattr(chip_smoke, "_selected", spy)
    monkeypatch.setattr(chip_smoke, "_context", lambda reps: None)
    rc = chip_smoke.main(argv)
    return rc, seen["run"], seen["all"]


def test_no_arguments_runs_every_phase(monkeypatch):
    rc, run, every = _run(monkeypatch, [])
    assert rc == 2
    assert run == every and len(every) == len(set(every))
    for name in ("kernels", "sstep-stencil", "deep-stencil", "cli-petsc",
                 "dist-wire", "serve", "cli-serve", "profile"):
        assert name in every


@pytest.mark.parametrize("only, want", [
    ("sstep-stencil", ["stencil", "sstep-stencil"]),
    ("deep-stencil,profile",
     ["stencil", "pipelined-stencil", "deep-stencil", "profile"]),
    ("sstep-batched-stencil",
     ["stencil", "batched-stencil", "sstep-batched-stencil"]),
    ("cli-host", ["cli-host"]),
    ("dist-pipelined-stencil-rdma",
     ["dist-setup", "stencil", "pipelined-stencil", "dist-stencil-rdma",
      "dist-pipelined-stencil-rdma"]),
    ("dia-100m-f64", ["p3d-464", "dia-100m", "dia-100m-f64"]),
    ("dist-sstep-stencil,dist-deep-stencil",
     ["dist-setup", "stencil", "pipelined-stencil", "deep-stencil",
      "dist-stencil", "dist-sstep-stencil", "dist-deep-stencil"]),
    ("graph-loop",
     ["dist-setup", "stencil", "pipelined-dia-bf16", "batched-stencil",
      "graph-loop"]),
    ("kernels",
     ["p3d-464", "p2d-10k", "dist-setup", "fem3d-1m", "kernels"]),
    ("serve", ["dist-setup", "stencil", "serve"]),
    ("serve,cli-serve", ["dist-setup", "stencil", "serve", "cli-serve"]),
    ("cli-serve", ["cli-serve"]),
])
def test_only_adds_what_a_phase_is_held_against(monkeypatch, only, want):
    rc, run, _every = _run(monkeypatch, ["--only", only])
    assert rc == 2
    assert run == want


def test_only_refuses_an_unknown_phase(monkeypatch):
    with pytest.raises(SystemExit, match=r"unknown phases \['nope'\]"):
        _run(monkeypatch, ["--only", "stencil,nope"])


def test_a_phase_may_need_only_earlier_phases():
    phases = [("a", None, ()), ("b", None, ("c",)), ("c", None, ())]
    with pytest.raises(SystemExit, match="phase b needs"):
        chip_smoke._selected(phases, "")
    phases = [("a", None, ()), ("b", None, ("a",)), ("c", None, ("b",))]
    assert chip_smoke._selected(phases, "c") == {"a", "b", "c"}
    assert chip_smoke._selected(phases, "a") == {"a"}
