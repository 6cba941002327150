"""The ``rtisi400_16k_batch32`` cell: RTISI-LA at Whisper's geometry (n_fft
400, hop 160, 16 kHz, 30 s chunks, look-ahead 2, 25 refinements) on kernel
D.  Its roofline count worked by hand, its configuration and cell as they
are declared, and, at a size a CPU test holds (two 0.5 s chunks a call on
the kernel's plain version), the program passing the cell's check where the
bfloat16 control fails it."""
import json
import math
from pathlib import Path

import pytest
import torch

from portbench import core
from portbench.roofline import rtisi_step

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL, CONFIG = "rtisi400_16k_batch32", "rtisi400_16k"


def test_rtisi_step_at_400_by_hand():
    """Per stream and refinement: the overlap-add of 2 committed and 3
    in-flight frames (2 x 400 each), the analysis window of 3 frames (400
    each), a forward and an inverse real FFT of each (2.5 x 400 log2 400),
    11 per bin (201 bins); per step 2 x 400 + 160 for the emitted samples.
    32 streams; bytes: one magnitude frame read and a hop written per
    stream."""
    cfg = core.load_json("configs", CONFIG)
    wl = core.load_json("workloads", CELL)
    fft = 2.5 * 400 * math.log2(400)
    refine = 5 * 800 + 3 * (400 + 2 * fft + 11 * 201)
    assert refine == pytest.approx(11833 + 6000 * math.log2(400))
    flops = 32 * (25 * refine + 960)
    assert rtisi_step.flops(cfg, wl) == pytest.approx(flops)
    assert flops == pytest.approx(50.98763e6, rel=1e-6)
    assert rtisi_step.step_bytes(cfg, wl) == 4 * 32 * (201 + 160) == 46208
    # operations bound it: 0.761 us a step at 67 TFLOP/s, the bytes 0.014 us
    assert rtisi_step.least_seconds(cfg, wl) == pytest.approx(flops / 67e12)
    assert rtisi_step.least_seconds(cfg, wl) * 1e6 == pytest.approx(0.76101, abs=1e-5)


def test_config_is_whispers_stft_under_rtisi_la():
    cfg = core.load_json("configs", CONFIG)
    assert (cfg["sample_rate"], cfg["n_fft"], cfg["hop_length"], cfg["clip_seconds"]) == (
        16000, 400, 160, 30.0)
    assert (cfg["window"], cfg["center"], cfg["pad_mode"], cfg["onesided"], cfg["dtype"]) == (
        "hann", True, "reflect", True, "float32")
    assert cfg["algorithm"] == "rtisi_la" and cfg["work"] == "rtisi_step"
    assert cfg["entry"] == {"offline_call": "RTISI_LA"}
    assert cfg["call"] == {"look_ahead": 2, "max_iter": 25, "alpha": 0.99,
                           "asymmetric_window": False, "backend": "kernel"}
    # the entry's default look-ahead, written out
    assert cfg["call"]["look_ahead"] == (cfg["n_fft"] - 1) // cfg["hop_length"]
    assert cfg["kernels"] == {"main": ["rtisi_steps_kernel"], "first": ["rtisi_steps_kernel"]}
    assert cfg["reduced"] == ["batch"] and cfg["batch"] == 32
    assert cfg["source_values"] == {"batch": 256}
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"]


def test_cell_is_one_caller_of_32_chunks_on_one_chip():
    wl = core.load_json("workloads", CELL)
    cfg = core.load_json("configs", CONFIG)
    frames = 1 + round(cfg["clip_seconds"] * cfg["sample_rate"]) // cfg["hop_length"]
    assert frames == 3001
    assert wl["units_per_call"] == frames + cfg["call"]["look_ahead"] == 3003
    assert -(-wl["units_per_call"] // 8) == 376  # launches of 8 steps a call
    assert (wl["config"], wl["driver"], wl["check"], wl["batch"], wl["pool"]) == (
        CONFIG, "offline_call", "rtisi_offline", 32, 2)
    assert wl["tap"] == ["specinv_tpu_torch.ops.cuda.rtisi_fused", "fused_rtisi_steps"]
    assert wl["call"] == {"verbose": False}
    entry = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (CONFIG, "batch32", 1)
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
              if CELL in m.get("workloads", ())}
    assert listed == {"audio_s_per_s", "call_ms_p95", "prep_ms", "driver_gap_us", "step_mfu",
                      "device_idle_pct", "kernelD_us_per_step", "kernelD_roofline"}


# 0.5 s: 51 frames, 53 steps, 7 launches of the kernel path.
SMALL = dict(clip_seconds=0.5, batch=2, pool=2, check_calls=2, warmup_calls=1, units_per_call=53)


def test_the_control_fails_where_the_program_passes():
    torch.set_num_threads(1)
    result, checks, run = core.execute(CELL, 2**31 + 11, 3.0, False, device="cpu",
                                       overrides=SMALL, log=lambda *_: None)
    assert result["correct"] is True, checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    control = core.load_module("checks", run.workload["check"]).compare(run, control=True)
    assert any(value > 3 * limit for _, value, limit in control)
