"""The roofline counts on known shapes."""
import math

import pytest

from portbench.roofline import _peaks, gl_iteration, rtisi_step

CFG = {"n_fft": 16, "hop_length": 4, "clip_seconds": 1.0, "sample_rate": 20,
       "call": {"look_ahead": 1, "max_iter": 2}}
CALL = {"batch": 2, "units_per_call": 10}


def test_rfft_flops():
    assert _peaks.rfft_flops(2048) == 2.5 * 2048 * 11


def test_gl_iteration_counts():
    # 20 samples, hop 4: 6 centred frames of 16 points, 9 bins
    frames, bins = 6, 9
    per_frame = 2 * 2.5 * 16 * 4 + 3 * 16 + 4 + 15 * bins
    assert gl_iteration.flops(CFG, CALL) == 2 * frames * per_frame
    assert gl_iteration.call_bytes(CFG, CALL) == 4 * (2 * frames * bins + 16 + 2 * 5 * 4)
    least = max(2 * frames * per_frame / 67e12, gl_iteration.call_bytes(CFG, CALL) / 10 / 3.35e12)
    assert gl_iteration.least_seconds(CFG, CALL) == pytest.approx(least)


def test_gl_iteration_at_the_cells_shape():
    cfg = dict(CFG, n_fft=2048, hop_length=512, clip_seconds=10.0, sample_rate=22050)
    assert gl_iteration.least_seconds(cfg, {"batch": 64, "units_per_call": 100}) * 1e6 == \
        pytest.approx(55.444, abs=1e-3)


def test_rtisi_step_counts():
    # n 16, hop 4: 3 committed frames, 2 in flight, 9 bins, 2 refinements
    refine = (3 + 2) * 2 * 16 + 2 * (16 + 2 * 2.5 * 16 * 4 + 11 * 9)
    assert rtisi_step.flops(CFG, {"streams": 3}) == 3 * (2 * refine + 2 * 16 + 4)
    assert rtisi_step.step_bytes(CFG, {"streams": 3}) == 4 * 3 * (9 + 4)
    assert rtisi_step.least_seconds(CFG, {"streams": 3}) == pytest.approx(
        max(rtisi_step.flops(CFG, {"streams": 3}) / 67e12, 4 * 3 * 13 / 3.35e12))
    # an offline call's clips are its streams
    assert rtisi_step.flops(CFG, {"batch": 3}) == rtisi_step.flops(CFG, {"streams": 3})


def test_least_time_is_the_larger_bound():
    assert _peaks.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert _peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert math.isclose(_peaks.least_seconds(67e12, 6.7e12), 2.0)
