"""A run's result line and what it loads, on the CPU at a small size (the
harness's look for a card skipped)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests._small import SMALL, run_small

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_untraced_line(cell):
    result, checks, _ = run_small(cell)
    assert list(result) == KEYS  # the numbers compared come last
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in result["metrics"]
    assert any(name.split(".")[0] == "audio_s_per_s" for name in result["metrics"])
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert [name for name, *_ in checks] == list(result["checks"])
    json.dumps(result, allow_nan=False)


def test_traced_line():
    result, *_ = run_small("gl2048_batch64", seconds=0.5, trace=True)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in result["metrics"]


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gl2048_batch64",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench.tests._small import run_small; from portbench import core;"
            "run_small('rtisi2048_stream16', seconds=0.3);"
            "print(core.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from portbench import core

    sys.modules.setdefault("specinv_tpu_torch_probe", sys)
    assert "specinv_tpu_torch" not in core.FORBIDDEN
    assert all(name in core.FORBIDDEN for name in ("jax", "jaxlib", "flax", "specinv_tpu"))
    assert "specinv_tpu_torch_probe" not in core.forbidden_modules()
    sys.modules.pop("specinv_tpu_torch_probe")
