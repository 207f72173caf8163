"""The stats document (``acg_torch.obs.export``, schema
``acg-torch-stats/1``) of CPU solves: it passes the port's validator,
and with its schema swapped for the JAX package's ``acg-tpu-stats/13``
it passes ``acg_tpu.obs.export.validate_stats_document`` too (the port
fills no block that validator would refuse).  Also: the round trip
through a file, non-finite values written as null, the per-system arrays
of a multi-RHS solve, and the validator's refusals.
"""

import json
import math

import numpy as np
import pytest

from acg_tpu.obs.export import SCHEMA as JSCHEMA
from acg_tpu.obs.export import validate_stats_document as jvalidate

from acg_torch.config import SolverOptions
from acg_torch.errors import AcgError
from acg_torch.obs import export
from acg_torch.obs.audit import audit_solver
from acg_torch.obs.roofline import roofline_for_operator, roofline_for_sharded
from acg_torch.obs.trace import SpanTracer
from acg_torch.solvers.cg import build_device_operator, cg, cg_sstep
from acg_torch.solvers.cg_dist import build_sharded, cg_dist
from acg_torch.sparse import poisson


def _doc(res, options, intro=None, nparts=1, solver="acg"):
    tracer = SpanTracer()
    with tracer.span("solve"):
        pass
    return export.build_stats_document(
        solver=solver, options=options, res=res, stats=res.stats,
        nunknowns=res.x.shape[-1], nparts=nparts,
        phases=tracer.as_dicts(), introspection=intro)


def _both_valid(doc):
    assert export.validate_stats_document(doc) == []
    assert jvalidate(dict(doc, schema=JSCHEMA)) == []


def _explained(dev, solver, options, dist=False, nrhs=1):
    audit = audit_solver(dev, solver=solver, options=options, nrhs=nrhs)
    model = (roofline_for_sharded(dev, solver=solver, nrhs=nrhs)
             if dist else roofline_for_operator(dev, solver=solver,
                                                nrhs=nrhs,
                                                sstep=options.sstep))
    return audit, model


@pytest.mark.parametrize("case", ["classic", "sstep", "dist"])
def test_document_passes_both_validators(case):
    A = poisson.poisson2d_5pt(12)
    b = np.ones(A.nrows)
    if case == "dist":
        o = SolverOptions(maxits=200, residual_rtol=1e-8)
        dev = build_sharded(A, nparts=4, devices=["cpu"] * 4)
        res = cg_dist(dev, b, options=o)
        audit, model = _explained(dev, "cg", o, dist=True)
    else:
        o = SolverOptions(maxits=200, residual_rtol=1e-8,
                          sstep=4 if case == "sstep" else 0)
        dev = build_device_operator(A, device="cpu")
        fn = cg_sstep if case == "sstep" else cg
        res = fn(dev, b, options=o, device="cpu")
        audit, model = _explained(
            dev, "cg-sstep" if case == "sstep" else "cg", o)
    measured = res.stats.iterations_per_sec()
    intro = {"comm_audit": audit.as_dict(),
             "roofline": dict(model.as_dict(),
                              measured_iters_per_sec=measured,
                              roofline_frac=model.frac(measured)),
             "halo_wire": {"wire": "f32", "dtype": "float64",
                           "itemsize": 8, "bytes_saved_ratio": None}}
    doc = _doc(res, o, intro, nparts=4 if case == "dist" else 1)
    _both_valid(doc)
    assert doc["schema"] == export.SCHEMA
    assert doc["capabilities"]["native_host_library"] is False
    assert doc["introspection"]["comm_audit"]["counted"] is True
    for key in export.NULL_BLOCKS + ("session", "admission", "warmstart"):
        assert doc[key] is None
    json.dumps(doc, allow_nan=False)


def test_round_trip_and_non_finite(tmp_path):
    A = poisson.poisson2d_5pt(8)
    o = SolverOptions(maxits=100, residual_rtol=1e-8)
    res = cg(A, np.ones(A.nrows), options=o, device="cpu")
    assert math.isinf(res.x0nrm2) and math.isinf(res.dxnrm2)
    doc = _doc(res, o)
    assert doc["result"]["x0nrm2"] is None
    assert doc["result"]["dxnrm2"] is None
    intro = {"roofline": {"operator_bytes": 1, "vector_bytes": 2,
                          "bytes_per_iter": 3, "hbm_gbps": 3350.0,
                          "predicted_iters_per_sec": 1e6,
                          "nrhs": 1, "roofline_frac": float("nan")}}
    doc = _doc(res, o, intro)
    assert doc["introspection"]["roofline"]["roofline_frac"] is None
    assert doc["introspection"]["comm_audit"] is None
    path = tmp_path / "s.json"
    export.write_stats_json(str(path), doc)
    assert export.load_stats_document(str(path)) == json.loads(
        json.dumps(doc))
    assert export.sanitize_tree([1.0, float("-inf"), {"a": float("nan")}]
                                ) == [1.0, None, {"a": None}]


def test_multi_rhs_arrays():
    A = poisson.poisson2d_5pt(8)
    o = SolverOptions(maxits=200, residual_rtol=1e-8)
    rng = np.random.default_rng(3)
    B = rng.standard_normal((3, A.nrows))
    B[1] *= 1e-3
    res = cg(A, B, options=o, device="cpu")
    doc = _doc(res, o)
    r = doc["result"]
    assert r["nrhs"] == 3
    assert r["iterations_per_system"] == [int(v) for v in
                                          res.iterations_per_system]
    assert [len(h) for h in r["residual_history"]] == [
        v + 1 for v in r["iterations_per_system"]]
    assert r["niterations"] == max(r["iterations_per_system"])
    _both_valid(doc)


def test_validator_refusals():
    A = poisson.poisson2d_5pt(8)
    o = SolverOptions(maxits=100, residual_rtol=1e-8)
    res = cg(A, np.ones(A.nrows), options=o, device="cpu")
    good = _doc(res, o)
    assert export.validate_stats_document([]) == [
        "document is not a JSON object"]
    bad = dict(good, schema="acg-tpu-stats/13")
    assert any("schema" in p for p in export.validate_stats_document(bad))
    bad = dict(good, fleet={"replica_id": "r0"})
    assert any("fleet" in p for p in export.validate_stats_document(bad))
    bad = dict(good, session={"request_id": "1"})
    assert export.validate_stats_document(bad)
    bad = json.loads(json.dumps(good))
    bad["result"]["residual_history"].append(0.0)
    assert any("residual_history" in p
               for p in export.validate_stats_document(bad))
    with pytest.raises(ValueError):
        export.write_stats_json("/nonexistent/never", dict(good, stats={}))


def test_failed_solve_still_documents():
    A = poisson.poisson2d_5pt(12)
    o = SolverOptions(maxits=3, residual_rtol=1e-12)
    with pytest.raises(AcgError) as ei:
        cg(A, np.ones(A.nrows), options=o, device="cpu")
    res = ei.value.result
    doc = _doc(res, o)
    assert doc["result"]["status"] == "ERR_NOT_CONVERGED"
    assert doc["result"]["converged"] is False
    _both_valid(doc)
