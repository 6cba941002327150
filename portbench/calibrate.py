#!/usr/bin/env python3
"""Readings for a cell's check limits: the program's and the control's.

From the root of a checkout, on a CUDA card::

    python3 portbench/calibrate.py --workload rtisi2048_stream16 --seconds 5 --seeds 11 12 13

For each seed, one run of the cell (set-up, a window of ``--seconds``, the
check) in this process, then the control on the same compared outputs: the
check's reference computed in bfloat16 in the program's place.  Prints one
line per seed with each number compared, the program's and the control's,
beside the limit.  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds also read the control")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import core

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for k, seed in enumerate(args.seeds):
        result, checks, run = core.execute(args.workload, seed, args.seconds, False,
                                           log=lambda *_: None)
        line = {"seed": seed, "correct": result["correct"], "attempted": result["attempted"],
                "metrics": {n: m["value"] for n, m in result["metrics"].items()},
                "program": {n: v for n, v, _ in checks}, "limit": {n: lim for n, _, lim in checks}}
        if k < args.control_seeds:
            check = core.load_module("checks", run.workload["check"])
            line["control"] = {n: v for n, v, _ in check.compare(run, control=True)}
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
