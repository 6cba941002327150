#!/usr/bin/env python3
"""Run one cell of the benchmark of ``specinv_tpu_torch`` on one CUDA card.

From the root of a checkout::

    python3 portbench/run.py --workload gl2048_batch64 --seed 1234 --seconds 30 --trace 0

``--trace 0`` measures the cell's end-to-end metrics over ``--seconds``;
``--trace 1`` runs a shorter window under ``torch.profiler`` and reports the
per-layer metrics, the device's busy time and a breakdown.  Without a CUDA
card the run fails and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # kernel caches at fixed places inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    from portbench import core

    t = time.perf_counter()
    import torch
    import_s = time.perf_counter() - t

    spec = core.cell_spec(args.workload)
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    # set-up counts from here: importing torch is the same for every program and
    # cell, and its time on a shared host drifts by seconds
    result, checks, _ = core.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                                     t_start=t + import_s,
                                     before={"python_s": t - T_START, "import_torch_s": import_s})
    found = core.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port's benchmark loads no JAX",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAIL'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
