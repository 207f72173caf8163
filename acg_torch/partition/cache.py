"""The content key of a prepared operator: the graph hashes.

The port of ``acg_tpu.partition.cache``'s hashes
(``acg_tpu/partition/cache.py:98-160``): :func:`structure_hash` covers
shape + sparsity, :func:`values_hash` the coefficients, and
:func:`graph_hashes` both with their combination, the key the serve
layer's prepared-operator cache (``acg_torch/serve/session.py``) files a
built operator under.  The same bytes go into the same SHA-256 as in the
JAX package, so both packages give one matrix the same key.

The memory and disk prep cache of partitions and partitioned systems
(``PrepCache``, ``cached_partition_graph``) is not ported:
:func:`resolve_prep_cache` takes ``None`` and ``"auto"``, both meaning
no prep cache, and refuses anything else.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np

from acg_torch.errors import AcgError, Status
from acg_torch.sparse.csr import CsrMatrix

# the JAX package's cache version: part of every hash's preamble
PREP_CACHE_VERSION = 2


class GraphHashes(NamedTuple):
    """The split content key of a host CSR operator: ``full`` =
    structure ⊕ values (the strict key); ``structure`` = shape +
    sparsity; ``values`` = coefficients."""

    full: str
    structure: str
    values: str


def structure_hash(A: CsrMatrix) -> str:
    """Hash of shape + sparsity (rowptr, colidx) only."""
    h = hashlib.sha256()
    h.update(f"acg-prep-struct/{PREP_CACHE_VERSION}:"
             f"{A.nrows}:{A.ncols}".encode())
    for arr in (A.rowptr, A.colidx):
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode())
        # hashlib reads the buffer directly: no copy of the arrays
        h.update(memoryview(a))
    return h.hexdigest()


def values_hash(A: CsrMatrix) -> str:
    """Hash of the coefficient array only."""
    h = hashlib.sha256()
    h.update(f"acg-prep-vals/{PREP_CACHE_VERSION}:".encode())
    a = np.ascontiguousarray(A.vals)
    h.update(str(a.dtype).encode())
    h.update(memoryview(a))
    return h.hexdigest()


def graph_hashes(A: CsrMatrix) -> GraphHashes:
    """Both components plus their combination, in one pass over A."""
    s, v = structure_hash(A), values_hash(A)
    full = hashlib.sha256(
        f"acg-prep/{PREP_CACHE_VERSION}:{s}:{v}".encode()).hexdigest()
    return GraphHashes(full=full, structure=s, values=v)


def resolve_prep_cache(spec):
    """The prep cache a ``prep_cache=`` argument names: ``None`` and
    ``"auto"`` mean none in this port (always None); a directory or a
    cache object raises ``ERR_NOT_SUPPORTED``."""
    if spec is None or (isinstance(spec, str) and spec == "auto"):
        return None
    raise AcgError(Status.ERR_NOT_SUPPORTED,
                   f"prep_cache={spec!r}: the partition prep cache (memory "
                   "and disk) is not ported; pass None or 'auto' (no prep "
                   "cache)")
