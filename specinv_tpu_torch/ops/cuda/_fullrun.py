"""What the whole-run kernels share: the config check, the launch queue, the
return contract and the gradient replay.

``csrc/fullrun.cuh`` is one iteration engine (a frame launch and an OLA
launch) with an algorithm-specific middle; ``gl_fullrun`` and
``admm_fullrun`` wrap its two C entry points, each in two dispatches: the
whole run (``fused_*_run``) and one raw iteration (``fused_*_iteration``,
the sequence-parallel path's).  Both keep the signal ``x_pad (B, lp)`` in
padded coordinates and the state and target as ``(B, T, F)`` planes in
natural bin order, and return ``x[, state][, mag][, stats]``.

Below, ``valid`` is always an explicit frame count in ``[0, T]`` (0: no
frame is valid), and an ``inv_env`` of None means the raw overlap-add: no
envelope and no edge re-pad (:func:`geometry`).  :func:`frame_plan` lays out
each frame launch (``csrc/rfft.cuh`` describes the two plans).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import STFTConfig
from ...models._kernel_driver import PaddedGeometry, make_geometry, raw_geometry
from . import _build
from .fft import scales, supported_size, twiddles

PAD_CODES = {"constant": 0, "reflect": 1, "replicate": 2, "circular": 3}

UNSUPPORTED = "n_fft a power of two in [16, 4096], 0 < hop <= n_fft and a real window"


# An H100's SMs, the shared memory of one SM and what the card keeps of it
# per block: the one-wave plan's blocks that one wave holds.
SMS = 132
SM_SHARED_BYTES = 233472  # 228 KB
BLOCK_RESERVED_BYTES = 1024
POINT_BYTES = 16  # an FP64 complex point
# The largest n_fft of the many-wave plan: at 4096 its blocks of 512 threads,
# at the kernel's bound of 80 registers a thread, leave an SM one block, two
# frames, as many as the one-wave plan holds.
MANY_WAVE_MAX_N_FFT = 2048


class FramePlan(NamedTuple):
    """How a frame launch lays out its blocks."""

    frames_per_block: int
    threads: int      # per block: n_fft / 16 per frame
    smem: int         # dynamic shared-memory bytes per block
    many_wave: bool   # one buffer per frame, twice the frames (else two buffers)


def frame_plan(rows: int, n_fft: int) -> FramePlan:
    """The layout of a frame launch of kernel A or C over ``rows`` frames
    (``B * T``) of ``n_fft`` (a power of two in [16, 4096]).

    The one-wave plan: a block holds one frame, or a warp's worth below
    n_fft 512, with the twiddle table (``n_fft / 2`` FP64 points) and two
    buffers of ``n_fft / 2`` points and one padding point per eight per
    frame in shared memory.  Where ``rows`` would fill more than one wave of
    such blocks (the blocks an SM's shared memory holds, on every SM) and
    n_fft is at most :data:`MANY_WAVE_MAX_N_FFT`, the many-wave plan: twice
    the frames per block, one buffer each, in the same shared memory, so
    more frames in flight on each SM.
    """
    h = n_fft // 2
    tpf = h // 8  # threads per frame
    fpb = max(1, 32 // tpf)
    smem = POINT_BYTES * (h + 2 * fpb * (h + h // 8))
    wave = SMS * fpb * (SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES))
    if rows < wave or n_fft > MANY_WAVE_MAX_N_FFT:
        return FramePlan(fpb, fpb * tpf, smem, False)
    return FramePlan(2 * fpb, 2 * fpb * tpf, smem, True)


def supports(cfg: STFTConfig, window) -> bool:
    """Whether the kernels take this config: n_fft a power of two in
    [16, 4096], 0 < hop <= n_fft, and a real window."""
    return (
        supported_size(cfg.n_fft)
        and 0 < cfg.hop_length <= cfg.n_fft
        and not torch.as_tensor(window).is_complex()
    )


def outputs(x, state, mag, stats, emit_state, with_mag, with_loss):
    """``x[, state][, mag][, stats]``, or ``x`` alone."""
    if not (emit_state or with_mag or with_loss):
        return x
    out = [x]
    if emit_state:
        out.append(state)
    if with_mag:
        out.append(mag)
    if with_loss:
        out.append(stats)
    return tuple(out)


def valid_frames(valid_t: int, T: int) -> int:
    """The whole-run dispatch's frame count for the eval sums (and ADMM's
    row mask): ``valid_t``, where 0 is T."""
    return valid_count(valid_t or None, T)


def valid_count(valid_t, T: int) -> int:
    """The raw dispatch's frame count: ``valid_t``, where None is T and 0
    is no frame (a shard that holds only padding rows)."""
    if valid_t is None:
        return T
    if not 0 <= valid_t <= T:
        raise ValueError(f"valid_t={valid_t} must lie in [0, T={T}]")
    return int(valid_t)


def geometry(cfg: STFTConfig, T: int, inv_env) -> PaddedGeometry:
    """The padded geometry, or the raw one when ``inv_env`` is None."""
    return raw_geometry(cfg, T) if inv_env is None else make_geometry(cfg, T)


def check_config(cfg: STFTConfig, window, n_iters: int, algo: str) -> None:
    """Raise unless the kernels take ``cfg`` and ``window`` and ``n_iters >= 1``."""
    if not supports(cfg, window):
        raise ValueError(
            f"the {algo} kernel needs {UNSUPPORTED} (n_fft={cfg.n_fft}, "
            f"hop={cfg.hop_length})"
        )
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")


def eval_sums(mag, target, valid: int):
    """Plain ``[sum (|S|-tgt)^2, sum |S|^2]`` over the first ``valid`` frames."""
    m, tg = mag[:, :valid], target[:, :valid]
    return torch.stack([torch.sum((m - tg) ** 2), torch.sum(m * m)])


def launch(entry: str, count, x_pad, state, target, window, inv_env, scalar,
           cfg: STFTConfig, n_iters, with_mag, with_loss, valid):
    """Queue ``n_iters`` iterations of the C entry point ``entry`` on the
    current stream, calling ``count(many_wave)`` before each (whether its
    frame launch takes the many-wave plan); returns ``(x, state, mag,
    stats)``."""
    B, T, n_bins = target.shape
    n, hop = cfg.n_fft, cfg.hop_length
    geo = geometry(cfg, T, inv_env)
    dev = x_pad.device
    if n_bins != cfg.num_freqs:
        raise ValueError(f"target has {n_bins} bins, the config {cfg.num_freqs}")
    checks = [
        ("x_pad", x_pad, torch.float32, (B, geo.lp)),
        ("state", state, torch.complex64, (B, T, n_bins)),
        ("target", target, torch.float32, (B, T, n_bins)),
        ("window", window, torch.float32, (n,)),
    ]
    if inv_env is not None:
        checks.append(("inv_env", inv_env, torch.float32, (geo.lp,)))
    for name, t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    target, window = target.contiguous(), window.contiguous()
    if inv_env is not None:
        inv_env = inv_env.contiguous()
    x_a = x_pad.contiguous().clone()
    x_b = torch.empty_like(x_a)
    state = state.contiguous().clone()  # updated in place by the kernel
    frames = torch.empty((B, T, n), dtype=torch.float32, device=dev)
    mag = torch.empty((B, T, n_bins), dtype=torch.float32, device=dev) if with_mag else None
    partial = torch.zeros((B, T, 2), dtype=torch.float32, device=dev) if with_loss else None
    fscale, iscale = scales(n, cfg.normalized)
    tw = twiddles(n, dev, torch.complex128)
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = frame_plan(B * T, n)
    fn = getattr(_build.library(), entry)
    for it in range(n_iters):
        last = it == n_iters - 1
        count(plan.many_wave)
        code = fn(
            x_a.data_ptr(), x_b.data_ptr(), state.data_ptr(), target.data_ptr(),
            window.data_ptr(), tw.data_ptr(),
            inv_env.data_ptr() if inv_env is not None else None, frames.data_ptr(),
            mag.data_ptr() if (with_mag and last) else None,
            partial.data_ptr() if (with_loss and last) else None,
            B, T, n, n.bit_length() - 1, hop, n_bins, geo.lp, int(cfg.onesided),
            geo.p_amt, geo.e, PAD_CODES[cfg.pad_mode],
            float(scalar), fscale, iscale, valid, plan.frames_per_block, plan.threads,
            plan.smem, stream,
        )
        _build.check(code, entry)
        x_a, x_b = x_b, x_a
    stats = partial.sum(dim=(0, 1)) if with_loss else None
    return x_a, state, mag, stats


def apply(function, x_pad, state, target, window, inv_env, scalar, cfg: STFTConfig,
          n_iters: int, emit_state: bool, with_mag: bool, with_loss: bool, valid: int, count):
    """Run a kernel's ``autograd.Function`` and return ``x[, state][, mag][,
    stats]``."""
    x, state_out, *extras = function.apply(
        x_pad, state, target, window, inv_env, float(scalar), cfg, n_iters, with_mag,
        with_loss, valid, count,
    )
    mag = extras.pop(0) if with_mag else None
    stats = extras.pop(0) if with_loss else None
    return outputs(x, state_out, mag, stats, emit_state, with_mag, with_loss)


def replay_backward(ctx, reference, g_x, g_state):
    """The backward of a kernel's ``autograd.Function``: replay its plain
    version under autograd from the saved inputs ``(x_pad, state, target,
    window, inv_env)`` (``inv_env`` may be None: the raw dispatch) and
    ``ctx.scalar/cfg/n_iters/valid_t``."""
    inputs = [t if t is None else t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wrt = [t for t in inputs if t is not None and t.requires_grad]
    with torch.enable_grad():
        x, state = reference(*inputs, ctx.scalar, ctx.cfg, ctx.n_iters,
                             emit_state=True, valid_t=ctx.valid_t)
        grads = iter(torch.autograd.grad((x, state), wrt, (g_x, g_state), allow_unused=True))
    return [next(grads) if t is not None and t.requires_grad else None for t in inputs]
