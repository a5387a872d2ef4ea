"""Stage timing for the prover pipeline.

``stage_timer(name)`` -- nested wall-clock stage timers.  With
``ZKT_TIMING=1`` each stage prints one line, indented by nesting depth;
timings are always collected into ``get_timings()`` for programmatic use
(bench harnesses).  A stage that ends on a host fetch (every transcript
stage) includes the device work queued before it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

_DEPTH = 0
_TIMINGS: dict[str, list[float]] = defaultdict(list)


def timing_enabled() -> bool:
    return bool(os.environ.get("ZKT_TIMING"))


@contextlib.contextmanager
def stage_timer(name: str):
    """Time a pipeline stage; nested stages print indented."""
    global _DEPTH
    t0 = time.perf_counter()
    _DEPTH += 1
    try:
        yield
    finally:
        _DEPTH -= 1
        dt = time.perf_counter() - t0
        _TIMINGS[name].append(dt)
        if timing_enabled():
            print(f"[timing] {'  ' * _DEPTH}{name}: {dt:.3f}s", flush=True)


def get_timings() -> dict[str, list[float]]:
    """All collected stage timings this process (name -> list of seconds)."""
    return dict(_TIMINGS)


def reset_timings() -> None:
    _TIMINGS.clear()
