"""Each metric reader on a synthetic window and trace."""
import pytest

from portbench import core
from portbench.core import Record, Run

GL = {"algorithm": "griffin_lim", "n_fft": 2048, "hop_length": 512, "clip_seconds": 10.0,
      "sample_rate": 22050, "work": "gl_iteration",
      "kernels": {"main": ["frame_kernel", "ola_kernel"], "first": ["frame_kernel"]}}
RT = {"algorithm": "rtisi_la", "n_fft": 2048, "hop_length": 512, "clip_seconds": 10.0,
      "sample_rate": 22050, "call": {"look_ahead": 3, "max_iter": 25}, "work": "rtisi_step",
      "kernels": {"main": ["rtisi_steps_kernel"], "first": ["rtisi_steps_kernel"]}}
GL_CALL = {"batch": 64, "units_per_call": 100}


def run_of(config, workload, records, trace=None, window_s=None):
    run = Run("cell", {"workload": workload, "config": config}, 1, "cpu")
    run.records = records
    run.window_s = window_s if window_s is not None else records[-1].end - records[0].start
    run.trace = trace
    return run


def read(name, run):
    return core.load_module("metrics", name).read(run)


def calls():
    # two calls of 100 iterations: 0-1 s and 1-3 s, 20 audio-s each; one failed
    return [Record(0.0, 1.0, 20.0, 100, True, "call"), Record(1.0, 3.0, 20.0, 100, True, "call"),
            Record(3.0, 4.0, 0.0, 100, False, "call")]


def test_audio_rate_and_call_tail():
    run = run_of(GL, {"batch": 2}, calls())
    assert read("audio_s_per_s", run) == pytest.approx(40.0 / 4.0)
    # latencies 1000, 2000 and the failed call as the window's length, 4000 ms
    assert read("call_ms_p95", run) == pytest.approx(2000 + 0.9 * 2000)
    assert read("push_ms_p95", run) is None


def test_push_tail():
    recs = [Record(i, i + 0.001 * (i + 1), 0.37, 1, True, "push") for i in range(20)]
    recs.append(Record(20, 21, 0.0, 3, True, "flush"))
    run = run_of(RT, {"streams": 16}, recs)
    assert read("push_ms_p95", run) == pytest.approx(19.05)


def gl_trace():
    # one call span 0-1000 us: prep until 300, A's kernels 300-400, 450-550, 600-900,
    # an unrelated copy 420-440; the window 0-1000
    kernels = [("void frame_kernel<GlMiddle, true>", 300, 400), ("memcpy", 420, 440),
               ("void ola_kernel", 450, 550), ("void frame_kernel<GlMiddle, true>", 600, 900)]
    return {"kernels": kernels, "spans": [("portbench.call", 0, 1000)],
            "host": [("aten::copy_", 0, 1000), ("aten::cumsum", 100, 250)],
            "window": (0, 1000)}


def test_gl_trace_readers():
    run = run_of(GL, GL_CALL, [Record(0, 0.001, 640.0, 100, True, "call")], gl_trace())
    assert read("prep_ms", run) == pytest.approx(0.3)
    # between A's first and last kernels (300-900): busy 100 + 20 + 100 + 300
    assert read("driver_gap_us", run) == pytest.approx((600 - 520) / 100)
    assert read("kernelA_us_per_iter", run) == pytest.approx(500 / 100)
    least = core.load_module("roofline", "gl_iteration").least_seconds(GL, GL_CALL) * 1e6
    assert read("kernelA_roofline", run) == pytest.approx(100 * least / 5.0)
    assert read("kernelD_us_per_step", run) is None
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - 520 / 1000))
    flops = core.load_module("roofline", "gl_iteration").flops(GL, GL_CALL)
    assert read("step_mfu", run) == pytest.approx(100 * flops * 100 / (1e-3 * 67e12))


def test_stream_trace_readers():
    kernels = [("void rtisi_steps_kernel", 10, 60), ("void rtisi_steps_kernel", 110, 160),
               ("void rtisi_steps_kernel", 210, 360)]
    spans = [("portbench.push", 0, 80), ("portbench.push", 100, 180), ("portbench.flush", 200, 380)]
    recs = [Record(0, 8e-5, 0.37, 1, True, "push"), Record(1e-4, 1.8e-4, 0.37, 1, True, "push"),
            Record(2e-4, 3.8e-4, 0.0, 3, True, "flush")]
    trace = {"kernels": kernels, "spans": spans, "host": [], "window": (0, 400)}
    run = run_of(RT, {"streams": 16}, recs, trace)
    assert read("prep_ms", run) is None
    assert read("kernelD_us_per_step", run) == pytest.approx(250 / 5)
    assert read("driver_gap_us", run) == pytest.approx((350 - 250) / 5)
    least = core.load_module("roofline", "rtisi_step").least_seconds(RT, {"streams": 16}) * 1e6
    assert read("kernelD_roofline", run) == pytest.approx(100 * least / 50)
    assert read("kernelA_us_per_iter", run) is None and read("kernelA_roofline", run) is None


def test_readers_find_nothing_without_a_trace():
    run = run_of(GL, GL_CALL, calls())
    for name in ("prep_ms", "driver_gap_us", "kernelA_us_per_iter", "kernelA_roofline",
                 "kernelD_us_per_step", "kernelD_roofline", "step_mfu", "device_idle_pct"):
        assert read(name, run) is None


def test_short_names():
    assert core.short("void specinv::(anonymous namespace)::frame_kernel<(anonymous namespace)"
                      "::GLMiddle, true>(float const*, int)") == "specinv::frame_kernel<GLMiddle, true>"
    assert core.short("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD (Device -> Device)"
    assert core.short("(anonymous namespace)::rtisi_steps_kernel(float*, int)") == \
        "rtisi_steps_kernel"


def test_breakdown():
    out = core.breakdown(gl_trace())
    names = dict(out["device_ops"])
    assert names["frame_kernel<GlMiddle, true>"] == pytest.approx(400e-6)  # names shortened
    assert names["memcpy"] == pytest.approx(20e-6)
    gaps = dict(out["idle_gaps"])
    # idle 0-300 (middle 150: inside aten::cumsum), 400-420, 440-450, 550-600, 900-1000
    assert gaps["aten::cumsum"] == pytest.approx(300e-6)
    assert gaps["aten::copy_"] == pytest.approx(180e-6)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10
