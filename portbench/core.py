"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to a cell is found by name: the cell's file
``workloads/<cell>.json`` names its configuration (``configs/<config>.json``),
its driver (``drivers/<driver>.py``: set-up, the measured window, the sample
it keeps for the check) and its check (``checks/<check>.py``: the numbers
compared with the plain reference and their limits).  Each metric is a
reader ``metrics/<metric>.py`` with ``read(run) -> float | None``; the cell
reports the metrics of ``BENCHMARK.json`` that name it (or name no cells).

A run: imports, the CUDA context, the port's kernel library (built on the
first run of a checkout into ``build/specinv_tpu_torch/``), the inputs made
on the card from the seed, a warm-up of the cell's own shapes, then the
window: ``--seconds`` of closed-loop calls, or with ``--trace 1`` a shorter
window under ``torch.profiler``.  After the window the peak memory is read,
the program's state is dropped and the check runs the reference.  The last
line of standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error.
"""
from __future__ import annotations

import bisect
import collections
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "specinv_tpu")


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    return importlib.import_module(f"portbench.{kind}.{name}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (``specinv_tpu_torch`` is not ``specinv_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def cell_spec(cell: str, bench: dict | None = None) -> dict:
    """The cell's entry of ``BENCHMARK.json``, its workload and configuration
    files and the metrics it reports."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {cell!r} in BENCHMARK.json")
    workload = load_json("workloads", cell)
    config = load_json("configs", workload["config"])
    return {
        "entry": entry, "workload": workload, "config": config,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, cell)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, cell)],
    }


def smi() -> str:
    """The card's name, power limit and SM clock from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unavailable"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unavailable"


class Record:
    """One call or push of the window: host-clock start and end (s), audio
    seconds completed, units of work (GL iterations or RTISI steps), kind."""

    __slots__ = ("start", "end", "audio_s", "units", "ok", "kind")

    def __init__(self, start, end, audio_s, units, ok, kind):
        self.start, self.end, self.audio_s = start, end, audio_s
        self.units, self.ok, self.kind = units, ok, kind


class Run:
    """What a metric reader reads: the cell's files, the window's records
    and, in a traced run, the trace."""

    def __init__(self, cell, spec, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.workload, self.config = spec["workload"], spec["config"]
        self.records: list[Record] = []
        self.window_s = 0.0
        self.trace = None       # dict of kernels, spans, host events, window (us)
        self.setup = {}         # set-up phases, seconds
        self.setup_s = None     # the whole set-up, seconds
        self.state = {}         # the cell's inputs and program objects
        self.sample = []        # what the window produced, kept for the check
        self.errors = []        # the exceptions of failed calls, as text


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    return sum(b - a for a, b in merged(intervals))


def capture(prof, window_name: str) -> dict:
    """The profiler's records: device activity, the benchmark's spans and
    the host's events, in microseconds on the profiler's clock."""
    import torch

    kernels, spans, host = [], [], []
    window = None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith("portbench."):  # the spans' own device-side ranges
                kernels.append((e.name, start, end))
        elif e.name == window_name:
            window = (start, end)
        elif e.name.startswith("portbench."):
            spans.append((e.name, start, end))
        else:
            host.append((e.name, start, end))
    if window is None:
        raise RuntimeError("the profiler lost the window's span")
    lo, hi = window
    kernels = [(n, max(a, lo), min(b, hi)) for n, a, b in kernels if b > lo and a < hi]
    spans.sort(key=lambda s: s[1])
    host.sort(key=lambda h: h[1])
    return {"kernels": kernels, "spans": spans, "host": host, "window": window}


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its return type, parameter list and the
    anonymous namespaces, at most ``width`` characters."""
    symbol = "::" in name  # a C++ function: its parameter list goes
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")") and symbol:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.strip()[:width]


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing (the innermost host event open at each
    gap's middle), each with at most ``top`` entries, in seconds."""
    by_name = collections.Counter()
    for name, a, b in trace["kernels"]:
        by_name[short(name)] += (b - a) / 1e6
    lo, hi = trace["window"]
    busy = merged((a, b) for _, a, b in trace["kernels"])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    host = trace["host"]
    starts = [h[1] for h in host]
    idle = collections.Counter()
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        label = "host code outside any profiled op"
        for j in range(i - 1, max(-1, i - 2000), -1):
            if host[j][2] >= mid:
                label = host[j][0]
                break
        idle[label] += (b - a) / 1e6
    return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}


def reader(name: str):
    """The reader of a metric: ``metrics/<name>.py``; a metric split by the
    end-to-end metric its cells report (``driver_gap_us.stream``) reads as
    the part before the first dot does."""
    return load_module("metrics", name.split(".")[0])


def read_metrics(run: Run, metrics: list) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            overrides: dict | None = None, t_start: float | None = None,
            bench: dict | None = None, before: dict | None = None, log=print):
    """One run; returns ``(result, checks, run)``.  Set-up is counted from
    ``t_start``; ``before`` holds what was timed before it (printed, not
    counted).  ``overrides`` updates the cell's workload and configuration
    (the CPU tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell_spec(cell, bench)
    for key, value in (overrides or {}).items():
        (spec["config"] if key in spec["config"] else spec["workload"])[key] = value
    run = Run(cell, spec, seed, device)

    import torch

    on_card = device == "cuda"
    t = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    run.setup["cuda_context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    import specinv_tpu_torch  # noqa: F401  (the program under test)
    from specinv_tpu_torch.ops.cuda import _build
    if on_card:
        _build.library()
    run.setup["kernel_build_s"] = _build.last_build_seconds
    run.setup["kernel_load_s"] = time.perf_counter() - t - _build.last_build_seconds

    driver = load_module("drivers", run.workload["driver"])
    check = load_module("checks", run.workload["check"])
    driver.setup(run)  # records inputs_s and warmup_s in run.setup
    gc.collect()
    gc.freeze()  # what set-up made stays out of the window's collections
    setup_s = time.perf_counter() - t_start
    if on_card:
        log(f"portbench: device {torch.cuda.get_device_name(0)}, count "
            f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("portbench: before set-up " + ", ".join(f"{k} {v:.3f}" for k, v in (before or {}).items())
        + "; set-up " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup.items())
        + f"; setup_s {setup_s:.3f}")
    log(f"portbench: nvidia-smi before the window (name, power limit, SM clock, max SM clock): "
        f"{smi() if on_card else 'no card'}")

    window_s = min(seconds, run.workload["trace_seconds"]) if trace else seconds
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            with record_function("portbench.window"):
                driver.window(run, window_s, spans=True)
        run.trace = capture(prof, "portbench.window")
        del prof
    else:
        driver.window(run, window_s, spans=False)
    gc.unfreeze()
    log(f"portbench: nvidia-smi after the window: {smi() if on_card else 'no card'}")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    run.setup_s = setup_s
    metrics = read_metrics(run, spec["per_layer"] if trace else spec["end_to_end"])
    attempted = len(run.records)
    failed = sum(1 for r in run.records if not r.ok)
    if run.errors:
        log(f"portbench: {len(run.errors)} calls failed; the first: {run.errors[0]}")
    t = time.perf_counter()
    checks = check.compare(run)
    log(f"portbench: the check took {time.perf_counter() - t:.3f} s")
    correct = failed == 0 and all(value <= limit for _, value, limit in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": spec["entry"]["chips"], "memory_peak_bytes": memory_peak}}
    if trace:
        lo, hi = run.trace["window"]
        busy = union_us((a, b) for _, a, b in run.trace["kernels"])
        result["device"]["busy_s"] = busy / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result, checks, run
