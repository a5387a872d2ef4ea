"""Stage timing and device traces for the prover pipeline.

``stage_timer(name)`` -- nested wall-clock stage timers.  With
``ZKT_TIMING=1`` each stage prints one line, indented by its nesting
depth in the thread that runs it (a caller may prove on several threads);
timings are always collected into ``get_timings()``
for programmatic use (bench harnesses) and ``dump_timings`` writes them
as JSON.  A stage that ends on a host fetch (every transcript stage)
includes the device work queued before it.

``device_trace(label)`` -- a torch.profiler trace (host operations and
CUDA kernels) written as a Chrome trace under ``$ZKT_PROFILE_DIR/<label>``
when ``ZKT_PROFILE_DIR`` is set; inert otherwise.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

_LOCAL = threading.local()    # .depth: this thread's stage nesting
_LOCK = threading.Lock()
_TIMINGS: dict[str, list[float]] = defaultdict(list)


def timing_enabled() -> bool:
    return bool(os.environ.get("ZKT_TIMING"))


@contextlib.contextmanager
def stage_timer(name: str):
    """Time a pipeline stage; nested stages print indented."""
    t0 = time.perf_counter()
    depth = getattr(_LOCAL, "depth", 0)
    _LOCAL.depth = depth + 1
    try:
        yield
    finally:
        _LOCAL.depth = depth
        dt = time.perf_counter() - t0
        with _LOCK:
            _TIMINGS[name].append(dt)
        if timing_enabled():
            print(f"[timing] {'  ' * depth}{name}: {dt:.3f}s", flush=True)


def get_timings() -> dict[str, list[float]]:
    """All collected stage timings this process (name -> list of seconds)."""
    with _LOCK:
        return {k: list(v) for k, v in _TIMINGS.items()}


def reset_timings() -> None:
    with _LOCK:
        _TIMINGS.clear()


def dump_timings(path: str) -> None:
    """Write collected timings as JSON (per-stage total/count/mean)."""
    summary = {
        name: {
            "total_s": sum(v),
            "count": len(v),
            "mean_s": sum(v) / len(v),
        }
        for name, v in get_timings().items()
    }
    with open(path, "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)


@contextlib.contextmanager
def device_trace(label: str = "zk"):
    """Trace the block with torch.profiler (CPU operations, and CUDA
    kernels and copies where a card is) when ZKT_PROFILE_DIR is set,
    writing ``$ZKT_PROFILE_DIR/<label>/trace.<pid>.json`` (Chrome's trace
    format); inert otherwise.  Yields the profiler, or None when inert."""
    trace_dir = os.environ.get("ZKT_PROFILE_DIR")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(trace_dir, label)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out, f"trace.{os.getpid()}.json"))
