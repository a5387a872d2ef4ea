"""The device trace of a ``--trace 1`` run: torch.profiler over the
measured window, the card only (host operations are not recorded, which
would slow the host path the window measures), read from the profiler's
raw device events (kernels, copies and sets)."""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

from . import stats


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name.split("(", 1)[0]).strip()
    if len(name) > 48:            # a library's templated kernel: its name alone
        name = name.split("<", 1)[0]
    return name[:80] or "unnamed"


@dataclass
class DeviceWindow:
    """The device's events in the traced window: (name, start_s, end_s) on
    the profiler's clock."""

    events: list
    window_s: float
    by_name: dict = field(default_factory=dict)

    def __post_init__(self):
        by = defaultdict(float)
        for name, s, e in self.events:
            by[short_name(name)] += e - s
        self.by_name = dict(by)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return stats.union_length([(s, e) for _, s, e in self.events])

    def seconds_of(self, prefixes) -> float:
        """Device seconds of the operations whose short name starts with one
        of ``prefixes``."""
        return sum(v for k, v in self.by_name.items() if k.startswith(tuple(prefixes)))

    def breakdown(self, span: str, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        between operations summed by where it fell: the benchmark's span
        open around it and the operations before and after it."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        ordered = sorted(self.events, key=lambda ev: ev[1])
        idle = defaultdict(float)
        end, prev = None, None
        for name, s, e in ordered:
            if end is not None and s > end:
                idle[f"{span}: {short_name(prev)} -> {short_name(name)}"] += s - end
            if end is None or e >= end:
                end, prev = e, name
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


class Profiler:
    """torch.profiler's device activity over a block; ``window(seconds)``
    then gives its events."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def window(self, window_s: float) -> DeviceWindow:
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA":
                continue
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            s = e.start_ns() / 1e9
            events.append((e.name(), s, s + e.duration_ns() / 1e9))
        return DeviceWindow(events, window_s)
