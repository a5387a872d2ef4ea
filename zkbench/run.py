#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on this machine's card.

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: set-up (imports; the cell's circuit built, or loaded from the
binaries an earlier run wrote under zkbench/_cache; its inputs made from
the seed; warm-up calls of the cell's own shapes), then the measured
window of ``--seconds`` (with ``--trace 1`` under the device profiler),
then the comparison of the window's answers with the plain reference,
then the result as one JSON line, the last of standard output.  Every
number compared is printed beside its limit as the last lines of standard
error and under ``checks``, the result's last key.

Exit codes: 0 with a result; 2 without one where there is no card (or
fewer than the cell asks for) or the program cannot be imported; 3
without one where JAX or the JAX package was loaded.  ``--dry 1`` runs on
the CPU, for the tests of the harness.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / "_cache"


@dataclass
class Call:
    start: float
    end: float
    asked: int
    given: int

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Window:
    """What the metric readers read: the window's calls, its host seconds,
    the program's stage timers recorded in it, the device trace (None
    without ``--trace 1``), and the driver with its answers."""

    calls: list
    seconds: float
    timings: dict
    driver: object
    device: object = None
    info: dict = field(default_factory=dict)

    @property
    def asked(self) -> int:
        return sum(c.asked for c in self.calls)

    @property
    def given(self) -> int:
        return sum(c.given for c in self.calls)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry", type=int, choices=(0, 1), default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    # keep CUPTI set up between profiler windows (an empty window otherwise
    # follows CUDA graphs at times)
    os.environ["TEARDOWN_CUPTI"] = "0"


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.strip().splitlines()[0] if out.strip() else "not read"


def measure(driver, seconds: float, profiler) -> Window:
    """Calls back to back while the window is open: a call starts only
    before ``seconds`` have passed, and the window ends with the last."""
    before = {k: len(v) for k, v in driver.timings().items()}
    calls, failures = [], []
    with profiler or contextlib.nullcontext():
        w0 = time.perf_counter()
        while not calls or time.perf_counter() - w0 < seconds:
            s = time.perf_counter()
            try:
                asked, given = driver.call()
            except Exception:       # a failed call counts its answers as failed
                failures.append(traceback.format_exc())
                asked, given = driver.asked_per_call, 0
            calls.append(Call(s, time.perf_counter(), asked, given))
        w1 = time.perf_counter()
    for tb in failures[:1]:
        print(tb, file=sys.stderr)
    timings = {k: v[before.get(k, 0):] for k, v in driver.timings().items()}
    return Window(calls, w1 - w0, timings, driver, info={"failed_calls": len(failures)})


def main(argv=None, program_cls=None) -> int:
    """One run; ``program_cls`` puts another program in the port's place
    (zkbench/control.py)."""
    args = parse(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    try:
        import torch

        if program_cls is None:
            import zk_circuits_torch  # noqa: F401  (the system under test)
        from zkbench.harness import isolation, spec, trace
    except ImportError as e:
        print(f"zkbench: cannot import the program or the harness: {e}", file=sys.stderr)
        return 2
    cell = spec.find_cell(spec.load_spec(BENCH), args.workload, BENCH)
    chips = int(cell.entry["chips"])
    if args.dry:
        device = torch.device("cpu")
    elif not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"zkbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"

    traffic = spec.load_module("traffic", cell.mix["driver"])
    driver = traffic.Driver(cell, args.seed, device, CACHE / "circuits", program_cls)
    info = driver.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _T0

    profiler = trace.Profiler() if args.trace and on_card else None
    window = measure(driver, args.seconds, profiler)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if profiler is not None:
        window.device = profiler.window(window.seconds)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **driver.end_to_end(window)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}

    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    check_s = time.perf_counter() - t_check
    failed = window.asked - window.given
    checks.append(("failed", failed, 0, "max"))
    correct = all(v <= lim if kind == "max" else v >= lim for _, v, lim, kind in checks)

    leaked = isolation.forbidden_loaded()
    if leaked:
        print(f"zkbench: loaded {', '.join(leaked)}; the run may load neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips if on_card else 0, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": window.asked, "failed": failed,
              "metrics": metrics, "device": dev}
    if window.device is not None:
        dev["busy_s"] = window.device.busy_s
        dev["window_s"] = window.seconds
        result["breakdown"] = window.device.breakdown(traffic.ENTRY)
    result["run"] = {"calls": len(window.calls), "seconds": window.seconds,
                     "setup_s": setup_s, "check_s": check_s,
                     "card": _card() if on_card else "cpu", **info, **window.info,
                     **driver.check_s}
    result["checks"] = {name: {"value": v, "limit": lim, "kind": kind}
                        for name, v, lim, kind in checks}
    for name, v, lim, kind in checks:
        print(f"check {name}: {v} ({'at most' if kind == 'max' else 'at least'} {lim})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
