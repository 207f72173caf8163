"""Per-iteration memory-traffic model and iteration-rate ceiling on the
card (the port of ``acg_tpu.obs.roofline``).

CG is bandwidth-bound, so the question for a solve is what fraction of
the memory-traffic ceiling it reached.  The ceiling is the card's memory
rate over the bytes one iteration must move: the operator stream, the
real device operator's bytes at their storage width
(``operator_stream_bytes()``, the JAX package's bytes on the DIA and
stencil tiers; the sliced layout's on ELL and sgell), read once an
iteration for every system; and the vector streams, ``nrhs`` times.

Where the port's model differs from the JAX package's, on purpose:

- the vector streams come from a fixed table a solver family
  (:data:`VECTOR_STREAMS`): the least one iteration of that family must
  move, each input read once and each output written once, whatever a
  kernel fuses.  Classic CG: 11 (the SpMV with its dot reads p and writes
  t, 2; the update reads x, r, p, t and writes x, r, 6; p = r + beta p
  reads r and p and writes p, 3).  Pipelined (and deep-pipelined) CG: 12
  (six vectors read and written once).  s-step CG keeps the JAX
  package's block table: (8s + 6)/s streams an iteration and the operator
  read twice.  The JAX package charges 15 and 19 (a stream model of its
  XLA program), against which a pipelined stencil solve at 767 µs/iter
  already prices at 0.99 of its ceiling;
- a sharded solve's ceiling scales by the number of distinct cards its
  shards lie on, not by the shard count (shards may share a card), its
  rows are the sum of the shards' lengths (the port's shards are not
  padded to one length), and its operator stream is each shard's local
  operator plus its border-row interface ELL as they are stored.

``--hbm-gbps`` overrides the table below.  :meth:`RooflineModel.frac`
prices a measured iteration rate: above 1 means the model is wrong.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# memory rate by card name (GB/s), matched as a substring of the name
# ``nvidia-smi`` and ``torch.cuda.get_device_name`` give, longest key
# first: NVIDIA's data sheets
CHIP_HBM_GBPS = {
    "H100 80GB HBM3": 3350.0,
    "H100 SXM": 3350.0,
    "H100 NVL": 3900.0,
    "H100 PCIe": 2000.0,
    "H200": 4800.0,
}
DEFAULT_HBM_GBPS = 3350.0

#: vector streams an iteration by solver family (see the module's text)
VECTOR_STREAMS = {"cg": 11, "cg-pipelined": 12, "cg-pipelined-deep": 12}


def hbm_gbps_for(device_kind: str | None = None,
                 override: float | None = None) -> float:
    """The memory rate to model against: an explicit override
    (``--hbm-gbps``) wins; else the table keyed by the card's name;
    else the H100 SXM's."""
    if override is not None and override > 0:
        return float(override)
    if device_kind:
        for k, bw in sorted(CHIP_HBM_GBPS.items(),
                            key=lambda kv: -len(kv[0])):
            if k in device_kind:
                return bw
    return DEFAULT_HBM_GBPS


def detected_device_kind() -> str | None:
    """The first card's name (``torch.cuda.get_device_name``), or None
    without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


@dataclasses.dataclass(frozen=True)
class RooflineModel:
    """Traffic model of one solver configuration.

    ``operator_bytes`` is read once an iteration whatever ``nrhs``;
    ``vector_bytes`` already includes the ``nrhs`` factor;
    ``ncards`` is the parallel factor of the ceiling (distinct cards).
    ``predicted_iters_per_sec`` is a CEILING: measured over predicted
    above 1 means the model is wrong.  The halo fields price the ghost
    payload an iteration at the wire's itemsize, kept out of the memory
    ceiling."""

    operator_format: str
    solver: str
    nrhs: int
    nrows: int
    nparts: int
    operator_bytes: int
    vector_bytes: int
    hbm_gbps: float
    device_kind: str | None = None
    sstep: int = 0
    ncards: int = 1
    halo_wire: str = "f32"
    halo_wire_itemsize: int = 0
    halo_base_itemsize: int = 0
    halo_bytes: int = 0

    @property
    def bytes_per_iter(self) -> int:
        return self.operator_bytes + self.vector_bytes

    @property
    def halo_bytes_saved_ratio(self) -> float:
        """Fraction of the identity-wire halo payload the wire saves; NaN
        without a halo."""
        if self.halo_wire_itemsize <= 0 or self.halo_base_itemsize <= 0:
            return float("nan")
        return 1.0 - self.halo_wire_itemsize / self.halo_base_itemsize

    @property
    def predicted_iters_per_sec(self) -> float:
        if self.bytes_per_iter <= 0:
            return float("inf")
        return (self.hbm_gbps * 1e9 * max(self.ncards, 1)
                / self.bytes_per_iter)

    @property
    def bound_us_per_iter(self) -> float:
        """The least µs an iteration can take: the ceiling's inverse."""
        return 1e6 / self.predicted_iters_per_sec

    def frac(self, measured_iters_per_sec: float) -> float:
        """Measured over predicted rate; NaN when either is missing."""
        ceil = self.predicted_iters_per_sec
        if not (measured_iters_per_sec == measured_iters_per_sec) \
                or ceil <= 0 or ceil != ceil or ceil == float("inf"):
            return float("nan")
        return measured_iters_per_sec / ceil

    def as_dict(self) -> dict:
        return {
            "operator_format": str(self.operator_format),
            "solver": str(self.solver),
            "nrhs": int(self.nrhs),
            "nrows": int(self.nrows),
            "nparts": int(self.nparts),
            "ncards": int(self.ncards),
            "operator_bytes": int(self.operator_bytes),
            "vector_bytes": int(self.vector_bytes),
            "bytes_per_iter": int(self.bytes_per_iter),
            "hbm_gbps": float(self.hbm_gbps),
            "device_kind": self.device_kind,
            "predicted_iters_per_sec": float(self.predicted_iters_per_sec),
            "sstep": int(self.sstep),
            "halo_wire": str(self.halo_wire),
            "halo_wire_itemsize": int(self.halo_wire_itemsize),
            "halo_base_itemsize": int(self.halo_base_itemsize),
            "halo_bytes": int(self.halo_bytes),
            "halo_bytes_saved_ratio": float(self.halo_bytes_saved_ratio),
        }

    def report(self) -> str:
        """The ``--explain`` roofline block."""
        def mb(n):
            return f"{n / 1e6:.2f} MB"

        kind = self.device_kind or "no card detected"
        lines = [
            f"roofline model ({self.operator_format} operator, "
            f"{self.solver} solver, nrhs={self.nrhs}"
            + (f", s={self.sstep}" if self.sstep else "")
            + (f", {self.nparts} shards" if self.nparts > 1 else "") + "):",
            f"  operator stream : {mb(self.operator_bytes)}/iter "
            + ("(read once for all systems; x2 for the s-step basis "
               "build)" if self.sstep else "(read once for all systems)"),
            f"  vector streams  : {mb(self.vector_bytes)}/iter "
            f"(x{self.nrhs} system(s))",
            f"  total           : {mb(self.bytes_per_iter)}/iter",
            f"  memory rate     : {self.hbm_gbps:.0f} GB/s ({kind})"
            + (f" x {self.ncards} cards" if self.ncards > 1 else ""),
            f"  predicted ceiling: {self.predicted_iters_per_sec:.1f} "
            f"iterations/sec ({self.bound_us_per_iter:.1f} us/iter)",
        ]
        if self.halo_bytes > 0:
            saved = self.halo_bytes_saved_ratio
            lines.insert(3, (
                f"  halo wire       : {self.halo_bytes / 1e3:.2f} KB/iter "
                f"({self.halo_wire}, {self.halo_wire_itemsize} B/value"
                + (f", {saved:.0%} off the identity wire"
                   if saved == saved and saved > 0 else "") + ")"))
        return "\n".join(lines)


def _vec_bytes(solver: str, nrows: int, val_bytes: int, nrhs: int,
               sstep: int) -> int:
    """Vector bytes an iteration: the family's fixed streams, or the
    s-step block table's (8s + 6)/s, for each of ``nrhs`` systems."""
    if sstep:
        return nrhs * int((8 * sstep + 6) * nrows * val_bytes / sstep)
    streams = VECTOR_STREAMS["cg-pipelined" if "pipelined" in solver
                             else "cg"]
    return nrhs * streams * nrows * val_bytes


def _format_name(dev) -> str:
    inner = getattr(dev, "dev", dev)
    name = {"DeviceStencil": "stencil", "DeviceDia": "dia",
            "DeviceSgell": "sgell"}.get(type(inner).__name__, "ell")
    return "rcm+" + name if inner is not dev else name


def roofline_for_operator(dev, *, solver: str = "cg", nrhs: int = 1,
                          hbm_gbps: float | None = None,
                          device_kind: str | None = None,
                          operator_format: str | None = None,
                          sstep: int = 0) -> RooflineModel:
    """Model a single-device solve over a built device operator
    (anything with ``operator_stream_bytes()``, ``nrows_padded`` and
    ``vec_dtype``).  ``sstep`` selects the s-step block table."""
    if device_kind is None:
        device_kind = detected_device_kind()
    n = int(dev.nrows_padded)
    vb = np.dtype(dev.vec_dtype).itemsize
    op = int(dev.operator_stream_bytes()) * (2 if sstep else 1)
    return RooflineModel(
        operator_format=(operator_format if operator_format is not None
                         else _format_name(dev)),
        solver=solver, nrhs=int(nrhs), nrows=n, nparts=1,
        operator_bytes=op,
        vector_bytes=_vec_bytes(solver, n, vb, int(nrhs), sstep),
        hbm_gbps=hbm_gbps_for(device_kind, hbm_gbps),
        device_kind=device_kind, sstep=int(sstep), ncards=1)


def sharded_operator_bytes(ss) -> int:
    """Bytes of a sharded operator's stream an iteration: each shard's
    local operator and its border-row interface ELL, as stored."""
    total = sum(int(op.operator_stream_bytes()) for op in ss.local_ops)
    for it in ss.iface:
        if it is not None:
            total += int(it[0].stream_bytes())
    return total


def roofline_for_sharded(ss, *, solver: str = "cg", nrhs: int = 1,
                         hbm_gbps: float | None = None,
                         device_kind: str | None = None,
                         sstep: int = 0,
                         halo_wire: str = "f32") -> RooflineModel:
    """Model a distributed solve over a ShardedSystem: the operator
    stream of :func:`sharded_operator_bytes`, vectors over the sum of the
    shards' lengths, the ceiling times the distinct cards the shards lie
    on (one for shards that share a card or the CPU).  ``halo_wire``
    prices the ghost payload an iteration, the JAX package's figure:
    parts × the most ghosts a part holds × the wire's itemsize × nrhs."""
    from acg_torch.parallel.halo import wire_itemsize

    if device_kind is None:
        device_kind = detected_device_kind()
    op_bytes = sharded_operator_bytes(ss) * (2 if sstep else 1)
    n = int(sum(op.nrows_padded for op in ss.local_ops))
    vb = np.dtype(ss.vec_dtype).itemsize
    wi = wire_itemsize(halo_wire, np.dtype(ss.vec_dtype))
    ncards = len({str(d) for d in ss.devices if d.type == "cuda"}) or 1
    return RooflineModel(
        operator_format=ss.local_fmt, solver=solver, nrhs=int(nrhs),
        nrows=n, nparts=int(ss.nparts), operator_bytes=int(op_bytes),
        vector_bytes=_vec_bytes(solver, n, vb, int(nrhs), sstep),
        hbm_gbps=hbm_gbps_for(device_kind, hbm_gbps),
        device_kind=device_kind, sstep=int(sstep), ncards=ncards,
        halo_wire=str(halo_wire), halo_wire_itemsize=int(wi),
        halo_base_itemsize=int(vb),
        halo_bytes=int(ss.nparts) * int(ss.halo.nghost_max) * wi
        * int(nrhs))
