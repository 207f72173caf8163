"""Host seconds of the named steps of an operator build."""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def host_step(timings: dict | None, name: str):
    """Add the wall seconds of the ``with`` body to ``timings[name]``;
    nothing is recorded when ``timings`` is None."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings[name] = (timings.get(name, 0.0)
                             + time.perf_counter() - t0)
