"""The ``gl400_16k_batch32`` cell at a size a CPU test holds: Whisper's
geometry (n_fft 400, hop 160, 16 kHz), two 0.5 s clips a call, 100
iterations on the direct-DFT path (``backend='dft'``: the kernel's plain
version; ``'auto'`` is ``'fft'`` on the CPU).  The program passes the cell's
check, the bfloat16 control fails it, and so does each fault planted in the
timed path underneath the entry."""
import importlib

import pytest
import torch

from portbench import core
from specinv_tpu_torch.ops.cuda import gl_fused

gl_module = importlib.import_module("specinv_tpu_torch.models.griffin_lim")

CELL = "gl400_16k_batch32"
SMALL = dict(clip_seconds=0.5, batch=2, pool=2, check_calls=2, warmup_calls=1,
             call=dict(max_iter=100, verbose=False, backend="dft"))


def run_small(seed=2**31 + 7):
    torch.set_num_threads(1)
    return core.execute(CELL, seed, 3.0, False, device="cpu", overrides=SMALL,
                        log=lambda *_: None)


def test_the_control_fails_where_the_program_passes():
    result, _, run = run_small()
    assert result["correct"] is True
    control = core.load_module("checks", run.workload["check"]).compare(run, control=True)
    assert any(value > 3 * limit for _, value, limit in control)


def unchanged(real):
    def bind(*args, **kw):
        iteration = real(*args, **kw)

        def step(x_pad, pre):
            _x, mag, _pre = iteration(x_pad, pre)
            return x_pad, mag, pre
        return step
    return bind


def half(real):
    def bind(*args, **kw):
        iteration = real(*args, **kw)

        def step(x_pad, pre):
            x, mag, out = iteration(x_pad, pre)
            h = x.shape[0] // 2
            return torch.cat([x[:h], torch.zeros_like(x[h:])]), mag, out
        return step
    return bind


def altered(real):
    def restore(x, was_2d):
        return -real(x, was_2d)  # every clip's waveform negated where the entry returns it
    return restore


FAULTS = {"state unchanged": (gl_fused, "bind", unchanged),
          "half the batch": (gl_fused, "bind", half),
          "answer altered": (gl_module, "restore_output", altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    owner, name, make = FAULTS[fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    result, checks, _ = run_small()
    assert result["correct"] is False, checks
