"""Matrix Market I/O: text, gzip-compressed text, and aCG binary format.

Functional parity with the reference reader/writer (reference acg/mtxfile.c,
~5k LoC of hand-rolled C parsing) in vectorized NumPy — the port's own
copy of ``acg_tpu.io.mtxfile`` without its native-library fast path:

- text ``.mtx`` and gzipped ``.mtx.gz`` coordinate/array files
  (ref acg/mtxfile.h:352,371 fread/gzread paths),
- the reference's *binary* layout for fast re-reads — a normal text header
  (``%%MatrixMarket object format field symmetry`` + comment lines + size
  line) followed by raw little-endian ``rowidx[nnz]``, ``colidx[nnz]``
  (acgidx_t = int32 or int64, 1-based) and ``vals[nnz]`` (float64) arrays
  (ref acg/mtxfile.c:684-1155 binary read branches, :1492-1497 binary write;
  produced by the ``mtx2bin`` tool, ref mtx2bin/mtx2bin.c).

Supported fields: real, integer, pattern (value 1.0), as in the reference
(complex is rejected, ref acg/mtxfile.c mtxcomplex branches return
NOT_SUPPORTED for binary).  Symmetry: general / symmetric.
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io
import zlib
import os

import numpy as np

from acg_torch.errors import AcgError, Status


@dataclasses.dataclass
class MtxFile:
    """An in-memory Matrix Market file (ref acg/mtxfile.h:145-238).

    ``rowidx``/``colidx`` are 0-based (converted from the file's 1-based on
    read; ref idxbase handling acg/mtxfile.c:729).  For ``object='vector'`` or
    array format, ``rowidx``/``colidx`` are None and ``vals`` has one entry
    per row (dense).
    """

    object: str = "matrix"        # matrix | vector
    format: str = "coordinate"    # coordinate | array
    field: str = "real"           # real | integer | pattern
    symmetry: str = "general"     # general | symmetric
    nrows: int = 0
    ncols: int = 0
    nnz: int = 0                  # stored entries (file's nnz line)
    rowidx: np.ndarray | None = None
    colidx: np.ndarray | None = None
    vals: np.ndarray | None = None
    comments: list[str] = dataclasses.field(default_factory=list)

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry == "symmetric"


def _open_maybe_gz(path: str | os.PathLike, mode: str = "rb"):
    path = os.fspath(path)
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


def _parse_header(f) -> MtxFile:
    """Parse banner, comments and size line (ref acg/mtxfile.c:468-520)."""
    line = f.readline()
    if isinstance(line, bytes):
        line = line.decode("utf-8", "replace")
    if not line.startswith("%%MatrixMarket "):
        raise AcgError(Status.ERR_INVALID_FORMAT, "missing %%MatrixMarket banner")
    parts = line.split()
    if len(parts) < 5:
        raise AcgError(Status.ERR_INVALID_FORMAT, f"bad banner: {line.strip()!r}")
    m = MtxFile(object=parts[1], format=parts[2], field=parts[3],
                symmetry=parts[4].lower())
    if m.object not in ("matrix", "vector"):
        raise AcgError(Status.ERR_INVALID_FORMAT, f"bad object {m.object!r}")
    if m.format not in ("coordinate", "array"):
        raise AcgError(Status.ERR_INVALID_FORMAT, f"bad format {m.format!r}")
    if m.field == "complex":
        raise AcgError(Status.ERR_NOT_SUPPORTED, "complex matrices not supported")
    if m.field not in ("real", "integer", "pattern"):
        raise AcgError(Status.ERR_INVALID_FORMAT, f"bad field {m.field!r}")
    while True:
        pos_line = f.readline()
        if isinstance(pos_line, bytes):
            pos_line = pos_line.decode("utf-8", "replace")
        if not pos_line:
            raise AcgError(Status.ERR_EOF, "EOF before size line")
        s = pos_line.strip()
        if not s:
            continue
        if s.startswith("%"):
            m.comments.append(s)
            continue
        sizes = s.split()
        break
    try:
        if m.format == "coordinate":
            if len(sizes) != 3:
                raise AcgError(Status.ERR_INVALID_FORMAT,
                               f"bad size line {s!r}")
            m.nrows, m.ncols, m.nnz = (int(sizes[0]), int(sizes[1]),
                                       int(sizes[2]))
        else:
            if m.object == "vector" and len(sizes) == 1:
                m.nrows, m.ncols = int(sizes[0]), 1
            elif len(sizes) == 2:
                m.nrows, m.ncols = int(sizes[0]), int(sizes[1])
            else:
                raise AcgError(Status.ERR_INVALID_FORMAT,
                               f"bad size line {s!r}")
            m.nnz = m.nrows * m.ncols
    except ValueError as e:
        raise AcgError(Status.ERR_INVALID_FORMAT,
                       f"bad size line {s!r}") from e
    if m.nrows < 0 or m.ncols < 0 or m.nnz < 0:
        raise AcgError(Status.ERR_INVALID_FORMAT,
                       f"negative dimensions in size line {s!r}")
    if max(m.nrows, m.ncols, m.nnz) > 1 << 48:
        # 2^48 entries is ~1 PB of text — far past any real matrix (the
        # 100M-DOF north star is 7e8 nnz) but still below the thresholds
        # where np.empty switches from MemoryError to ValueError, so the
        # claim is rejected here with one consistent status instead of
        # whichever allocation failure fires first
        raise AcgError(Status.ERR_INVALID_FORMAT,
                       f"implausible dimensions in size line {s!r}")
    return m


_PARSE_CHUNK = 1 << 24          # chars per str.split() batch (~16M)


def _parse_tokens(data: str, what: str) -> np.ndarray:
    """Whitespace-separated float64 tokens of ``data``, parsed in bounded
    chunks: str.split() materializes one Python str per token, so a single
    whole-file split would peak at ~10x the file size in object heap on a
    multi-GB matrix — chunking bounds the transient to ~_PARSE_CHUNK.
    (float64 is exact for indices up to 2^53, far beyond any dimension.)"""
    try:
        if len(data) <= _PARSE_CHUNK:
            return np.array(data.split(), dtype=np.float64)
        parts = []
        start, n = 0, len(data)
        while start < n:
            end = min(start + _PARSE_CHUNK, n)
            while end < n and not data[end].isspace():
                end += 1            # never split a token across chunks
            parts.append(np.array(data[start:end].split(),
                                  dtype=np.float64))
            start = end
        return np.concatenate(parts)
    except ValueError as e:
        raise AcgError(Status.ERR_INVALID_FORMAT,
                       f"bad {what} entry: {e}") from e


def read_mtx(path: str | os.PathLike, binary: bool | None = None,
             idx_dtype=np.int32, val_dtype=np.float64) -> MtxFile:
    """Read a Matrix Market file (text, .gz, or aCG binary).

    ``binary=None`` auto-detects: files whose data region is raw binary are
    produced by mtx2bin with extension ``.bin`` (ref mtx2bin/mtx2bin.c usage),
    so auto-detection keys on that extension; pass explicitly to override.
    """
    path = os.fspath(path)
    if binary is None:
        binary = path.endswith(".bin") or path.endswith(".binmtx")
    try:
        return _read_mtx_inner(path, binary, idx_dtype, val_dtype)
    except EOFError as e:
        # gzip member truncated mid-stream
        raise AcgError(Status.ERR_EOF, f"truncated compressed file: {e}") from e
    except (zlib.error, gzip.BadGzipFile) as e:
        # corrupted (not merely truncated) deflate stream
        raise AcgError(Status.ERR_INVALID_FORMAT,
                       f"corrupt compressed file: {e}") from e
    except (MemoryError, OverflowError) as e:
        # either the size line overstates the contents (corrupt file) or
        # the matrix genuinely exceeds this machine's memory — don't
        # blame the file for what may be an out-of-memory condition
        raise AcgError(Status.ERR_INVALID_FORMAT,
                       f"cannot allocate storage to read {path!r}: "
                       f"{type(e).__name__} (file corrupt, or matrix too "
                       "large for available memory)") from e


def _read_mtx_inner(path: str, binary: bool, idx_dtype, val_dtype) -> MtxFile:
    with _open_maybe_gz(path, "rb") as f:
        m = _parse_header(f)
        if m.format == "coordinate":
            if not binary and m.nnz > 0:
                # pre-check the nnz claim against the on-disk size: a text
                # entry needs >= 4 bytes ("1 1\n"), so a claim beyond
                # filesize/3 can never be satisfied (gzip may expand, so
                # only bound uncompressed files this way)
                here = f.tell() if not isinstance(f, gzip.GzipFile) else None
                if here is not None:
                    remaining = os.path.getsize(path) - here
                    if m.nnz > max(remaining, 0) // 3:
                        raise AcgError(Status.ERR_EOF,
                                       f"size line claims {m.nnz} entries; "
                                       f"only {remaining} bytes of data "
                                       "follow")
            if binary:
                idx_dtype = np.dtype(idx_dtype)
                raw = f.read(2 * m.nnz * idx_dtype.itemsize)
                want = 2 * m.nnz * idx_dtype.itemsize
                if len(raw) != want:
                    raise AcgError(Status.ERR_EOF, "short read of binary indices")
                idx = np.frombuffer(raw, dtype=idx_dtype.newbyteorder("<"))
                m.rowidx = idx[: m.nnz].astype(np.int64) - 1
                m.colidx = idx[m.nnz:].astype(np.int64) - 1
                if m.field == "pattern":
                    m.vals = np.ones(m.nnz, dtype=val_dtype)
                else:
                    raw = f.read(8 * m.nnz)
                    if len(raw) != 8 * m.nnz:
                        raise AcgError(Status.ERR_EOF, "short read of binary values")
                    m.vals = np.frombuffer(raw, dtype="<f8").astype(val_dtype)
            else:
                data = f.read()
                if isinstance(data, bytes):
                    data = data.decode("utf-8", "replace")
                ncols_per_line = 2 if m.field == "pattern" else 3
                toks = _parse_tokens(data, "matrix")
                if toks.size < m.nnz * ncols_per_line:
                    raise AcgError(Status.ERR_EOF, "too few data entries")
                toks = toks[: m.nnz * ncols_per_line].reshape(
                    m.nnz, ncols_per_line)
                m.rowidx = toks[:, 0].astype(np.int64) - 1
                m.colidx = toks[:, 1].astype(np.int64) - 1
                if m.field == "pattern":
                    m.vals = np.ones(m.nnz, dtype=val_dtype)
                else:
                    m.vals = toks[:, 2].astype(val_dtype)
            if m.nnz and (m.rowidx.min() < 0 or m.rowidx.max() >= m.nrows
                          or m.colidx.min() < 0 or m.colidx.max() >= m.ncols):
                raise AcgError(Status.ERR_INDEX_OUT_OF_BOUNDS,
                               "matrix entry index out of bounds")
        else:  # array format (dense; used for vectors & partition files)
            if binary:
                raw = f.read(8 * m.nnz)
                if len(raw) != 8 * m.nnz:
                    raise AcgError(Status.ERR_EOF, "short read of binary array")
                m.vals = np.frombuffer(raw, dtype="<f8").astype(val_dtype)
            else:
                data = f.read()
                if isinstance(data, bytes):
                    data = data.decode("utf-8", "replace")
                toks = _parse_tokens(data, "array")
                if toks.size < m.nnz:
                    raise AcgError(Status.ERR_EOF, "too few array entries")
                m.vals = toks[: m.nnz].astype(val_dtype)
    return m


def write_mtx(path: str | os.PathLike, m: MtxFile, binary: bool = False,
              idx_dtype=np.int32, numfmt: str = "%.17g") -> None:
    """Write a Matrix Market file (ref acg/mtxfile.c:1368-1500
    ``mtxfile_fwrite_double``; binary body :1492-1497).

    ``numfmt`` is a printf-style format for values (ref --numfmt flag,
    acg/fmtspec.h) applied in text mode.
    """
    path = os.fspath(path)
    with open(path, "wb") as f:
        header = f"%%MatrixMarket {m.object} {m.format} {m.field} {m.symmetry}\n"
        f.write(header.encode())
        for c in m.comments:
            c = c if c.startswith("%") else "% " + c
            f.write((c.rstrip("\n") + "\n").encode())
        if m.format == "coordinate":
            f.write(f"{m.nrows} {m.ncols} {m.nnz}\n".encode())
            if binary:
                f.write((m.rowidx.astype(idx_dtype) + 1).astype(
                    np.dtype(idx_dtype).newbyteorder("<")).tobytes())
                f.write((m.colidx.astype(idx_dtype) + 1).astype(
                    np.dtype(idx_dtype).newbyteorder("<")).tobytes())
                if m.field != "pattern":
                    f.write(m.vals.astype("<f8").tobytes())
            else:
                buf = _io.StringIO()
                if m.field == "pattern":
                    for i, j in zip(m.rowidx + 1, m.colidx + 1):
                        buf.write(f"{i} {j}\n")
                elif m.field == "integer":
                    for i, j, v in zip(m.rowidx + 1, m.colidx + 1, m.vals):
                        buf.write(f"{i} {j} {int(v)}\n")
                else:
                    for i, j, v in zip(m.rowidx + 1, m.colidx + 1, m.vals):
                        buf.write(f"{i} {j} {numfmt % v}\n")
                f.write(buf.getvalue().encode())
        else:
            if m.object == "vector":
                f.write(f"{m.nrows}\n".encode())
            else:
                f.write(f"{m.nrows} {m.ncols}\n".encode())
            if binary:
                f.write(m.vals.astype("<f8").tobytes())
            else:
                buf = _io.StringIO()
                if m.field == "integer":
                    for v in m.vals:
                        buf.write(f"{int(v)}\n")
                else:
                    for v in m.vals:
                        buf.write((numfmt % v) + "\n")
                f.write(buf.getvalue().encode())


def vector_to_mtx(x: np.ndarray, field: str = "real") -> MtxFile:
    """Wrap a dense vector as an array-format MtxFile (for solution output,
    ref cuda/acg-cuda.c:2388-2425)."""
    x = np.asarray(x)
    return MtxFile(object="vector", format="array", field=field,
                   nrows=x.shape[0], ncols=1, nnz=x.shape[0], vals=x)
