"""printf-style numeric format-spec parsing and validation.

The reference validates the ``--numfmt`` flag with a hand-rolled parser for
C format specifiers before handing it to fprintf (reference acg/fmtspec.c,
acg/fmtspec.h:29+; used by the matrix/vector writers,
acg/symcsrmatrix.c:358, acg/vector.c:267).  Python's ``%`` operator accepts
mostly the same grammar, so this module parses the spec into a structured
form, validates that it is a single *numeric* specifier, and is used by the
CLI to reject bad ``--numfmt`` values up front instead of crashing mid-write.
The port's own copy of ``acg_tpu.utils.fmtspec`` (it imports nothing of
the JAX package).

Grammar (C printf subset, ref acg/fmtspec.h):

    %[flags][width][.precision]conversion
    flags       ::= one or more of  - + space # 0
    width       ::= integer
    precision   ::= integer
    conversion  ::= d i u e E f F g G
"""

from __future__ import annotations

import dataclasses
import re

from acg_torch.errors import AcgError, Status

_SPEC_RE = re.compile(
    r"""^%
        (?P<flags>[-+ #0]*)
        (?P<width>\d+)?
        (?:\.(?P<precision>\d+))?
        (?P<conversion>[diueEfFgG])
        $""",
    re.VERBOSE,
)


@dataclasses.dataclass(frozen=True)
class FmtSpec:
    """A parsed numeric format specifier (ref struct fmtspec,
    acg/fmtspec.h:62-77)."""

    flags: str = ""
    width: int | None = None
    precision: int | None = None
    conversion: str = "g"

    def __str__(self) -> str:
        w = "" if self.width is None else str(self.width)
        p = "" if self.precision is None else f".{self.precision}"
        conv = self.conversion
        if conv == "u":         # C unsigned; Python spells it d
            conv = "d"
        return f"%{self.flags}{w}{p}{conv}"


def parse_fmtspec(fmt: str) -> FmtSpec:
    """Parse and validate a numeric format spec (ref fmtspec_parse,
    acg/fmtspec.c).  Raises AcgError(ERR_INVALID_FORMAT) on anything that
    is not exactly one numeric ``%`` specifier."""
    m = _SPEC_RE.match(fmt)
    if m is None:
        raise AcgError(Status.ERR_INVALID_FORMAT,
                       f"invalid numeric format {fmt!r} "
                       "(expected %[flags][width][.precision](d|i|u|e|E|f|F|g|G))")
    return FmtSpec(
        flags=m.group("flags") or "",
        width=int(m.group("width")) if m.group("width") else None,
        precision=int(m.group("precision")) if m.group("precision") else None,
        conversion=m.group("conversion"),
    )

