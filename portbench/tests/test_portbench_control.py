"""``correct`` comes out false for the control and for each fault a cell can
have, on the CPU at a small size with the harness's look for a card skipped.

The control is the check's reference computed with every stored value
rounded to bfloat16 (the precision below the configurations' float32), put
in the program's place.  The faults are planted in the program's timed
path underneath the entry: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced.  (One chip:
no exchange between chips to leave out.)"""
import importlib

import pytest
import torch

from portbench import core
from portbench.tests._small import SMALL, run_small
from specinv_tpu_torch.ops.cuda import gl_fullrun, rtisi_fused

# the models' modules (``specinv_tpu_torch.models`` exports functions of the same names)
gl_module = importlib.import_module("specinv_tpu_torch.models.griffin_lim")
rt_module = importlib.import_module("specinv_tpu_torch.models.rtisi_la")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_where_the_program_passes(cell):
    result, _, run = run_small(cell)
    assert result["correct"] is True
    control = core.load_module("checks", run.workload["check"]).compare(run, control=True)
    assert any(value > 3 * limit for _, value, limit in control)


def gl_unchanged(real):
    def run(x_pad, pre, *args, **kw):
        out = real(x_pad, pre, *args, **kw)
        return (x_pad, pre, *out[2:]) if isinstance(out, tuple) else x_pad
    return run


def gl_half(real):
    def run(x_pad, pre, target, *args, **kw):
        h = x_pad.shape[0] // 2
        out = real(x_pad[:h], pre[:h], target[:h], *args, **kw)
        parts = out if isinstance(out, tuple) else (out,)
        x = torch.cat([parts[0], torch.zeros_like(x_pad[h:])])
        if len(parts) == 1:
            return x
        return (x, torch.cat([parts[1], torch.zeros_like(pre[h:])]), *parts[2:])
    return run


def gl_altered(real):
    def restore(x, was_2d):
        y = real(x, was_2d)
        return -y  # every clip's waveform negated where the entry returns it
    return restore


def rt_unchanged(real):
    def steps(keeped, update, pre, target, *args):
        com, *_ = real(keeped, update, pre, target, *args)
        return com, keeped, update, pre
    return steps


def rt_half(real):
    def steps(keeped, update, pre, target, *args):
        h = keeped.shape[0] // 2
        com, k, u, p = real(keeped[:h], update[:h], pre[:h], target[:h], *args)
        return (torch.cat([com, torch.zeros_like(com)], dim=1), torch.cat([k, keeped[h:]]),
                torch.cat([u, update[h:]]), torch.cat([p, pre[h:]]))
    return steps


def rt_altered(real):
    def emit(self, committed):
        return real(self, committed) * (1 + 1e-3)
    return emit


def rt_offline_altered(real):
    def restore(x, was_2d):
        return real(x, was_2d) * (1 + 1e-3)  # every waveform scaled where the entry returns it
    return restore


GL_FAULTS = {"state unchanged": (gl_fullrun, "fused_gl_run", gl_unchanged),
             "half the batch": (gl_fullrun, "fused_gl_run", gl_half),
             "answer altered": (gl_module, "restore_output", gl_altered)}
RT_FAULTS = {"state unchanged": (rtisi_fused, "fused_rtisi_steps", rt_unchanged),
             "half the batch": (rtisi_fused, "fused_rtisi_steps", rt_half),
             "answer altered": (rt_module.RTISIStreamer, "_emit", rt_altered)}
CASES = [("gl2048_batch64", fault) for fault in GL_FAULTS]
RT_OFFLINE_FAULTS = dict(RT_FAULTS, **{"answer altered": (rt_module, "restore_output",
                                                           rt_offline_altered)})
CASES += [("rtisi2048_stream16", fault) for fault in RT_FAULTS]
CASES += [("rtisi2048_batch16", fault) for fault in RT_OFFLINE_FAULTS]
FAULTS = {"gl2048_batch64": GL_FAULTS, "rtisi2048_stream16": RT_FAULTS,
          "rtisi2048_batch16": RT_OFFLINE_FAULTS}


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    owner, name, make = FAULTS[cell][fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    result, checks, _ = run_small(cell)
    assert result["correct"] is False, checks
