"""Error codes and exceptions.

One status-code space for solver outcomes and I/O failures, the same
codes as ``acg_tpu.errors`` (reference acg/error.h:50-104) so results and
exit codes read alike in both packages.  A copy, not an import: the port
depends on nothing of the JAX package.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Solver / library status codes (ref acg/error.h:50-104)."""

    SUCCESS = 0
    ERR_INVALID_VALUE = 1
    ERR_INDEX_OUT_OF_BOUNDS = 2
    ERR_EOF = 3
    ERR_LINE_TOO_LONG = 4
    ERR_INVALID_FORMAT = 5
    ERR_NOT_SUPPORTED = 6
    ERR_NOT_CONVERGED = 7
    ERR_NOT_CONVERGED_INDEFINITE_MATRIX = 8
    ERR_PARTITION = 9
    ERR_MESH = 10
    ERR_NONFINITE = 11
    ERR_FAULT_DETECTED = 12
    ERR_TIMEOUT = 13
    ERR_OVERLOADED = 14


_STATUS_STRINGS = {
    Status.SUCCESS: "success",
    Status.ERR_INVALID_VALUE: "invalid value",
    Status.ERR_INDEX_OUT_OF_BOUNDS: "index out of bounds",
    Status.ERR_EOF: "unexpected end of file",
    Status.ERR_LINE_TOO_LONG: "line too long",
    Status.ERR_INVALID_FORMAT: "invalid file format",
    Status.ERR_NOT_SUPPORTED: "operation not supported",
    Status.ERR_NOT_CONVERGED: "solver did not converge",
    Status.ERR_NOT_CONVERGED_INDEFINITE_MATRIX: (
        "solver did not converge: matrix is not positive definite"
    ),
    Status.ERR_PARTITION: "graph partitioning failed",
    Status.ERR_MESH: "device mesh configuration error",
    Status.ERR_NONFINITE: "non-finite values in solver result",
    Status.ERR_FAULT_DETECTED: (
        "non-finite value detected in flight by the on-device guard"
    ),
    Status.ERR_TIMEOUT: "request deadline expired",
    Status.ERR_OVERLOADED: (
        "service overloaded: request shed at admission"
    ),
}


def status_str(status: Status) -> str:
    """Human-readable description (ref acg/error.h:112 ``acgerrcodestr``)."""
    return _STATUS_STRINGS.get(status, f"unknown error {int(status)}")


class AcgError(Exception):
    """Exception carrying a :class:`Status` code."""

    def __init__(self, status: Status, msg: str | None = None):
        self.status = Status(status)
        super().__init__(msg if msg is not None else status_str(self.status))


def run_main(fn) -> int:
    """CLI entry-point guard: run ``fn()`` and turn I/O failures and
    pre-solve validation errors into one stderr line and exit code 1."""
    import sys

    try:
        return fn()
    except (OSError, AcgError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
