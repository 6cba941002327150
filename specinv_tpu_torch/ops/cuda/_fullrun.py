"""The whole-run kernels' wrapper, written once for both algorithms: the
config check, the launch queue, the plain loop, the CPU/card dispatch and
the autograd Function.

``csrc/fullrun.cuh`` is one iteration engine (a frame launch and an OLA
launch) with an algorithm-specific middle; ``gl_fullrun`` and
``admm_fullrun`` each describe one of its two C entry points as a
:class:`Kernel`, whose methods are their public functions.  The signal
``x_pad (B, lp)`` lies in padded coordinates, the state and target are ``(B,
T, F)`` planes in natural bin order.  Gradients flow through :class:`Run`,
whose backward replays the plain loop (:func:`plain`) under autograd, as
the JAX package's ``custom_vjp`` replays its XLA twin.

Below, ``valid`` is always an explicit frame count in ``[0, T]`` (0: no
frame is valid), and an ``inv_env`` of None means the raw overlap-add: no
envelope and no edge re-pad (:func:`geometry`).  :func:`frame_plan` lays out
each frame launch (``csrc/rfft.cuh`` describes the two plans).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import STFTConfig
from ...utils.profiling import span
from ..twins import PaddedGeometry, make_geometry, raw_geometry, replay
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


def supports_frames(cfg: STFTConfig, window) -> bool:
    """The frame rule of the kernels on ``csrc/rfft.cuh`` (A, C and D):
    0 < hop <= n_fft, and a real window."""
    return 0 < cfg.hop_length <= cfg.n_fft and not torch.as_tensor(window).is_complex()


def supports(cfg: STFTConfig, window) -> bool:
    """Whether the kernels take this config: n_fft a power of two in
    [16, 4096], 0 < hop <= n_fft, and a real window."""
    return supported_size(cfg.n_fft) and supports_frames(cfg, window)


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


def eval_sums(mag, target, valid: int):
    """Plain ``[sum (|S|-tgt)^2, sum |S|^2]`` over the first ``valid`` frames."""
    m, tg = mag[:, :valid], target[:, :valid]
    return torch.stack([torch.sum((m - tg) ** 2), torch.sum(m * m)])


def launch(kernel, counter: str, x_pad, state, target, window, inv_env, scalar,
           cfg: STFTConfig, n_iters, with_mag, with_loss, valid):
    """Queue ``n_iters`` iterations of ``kernel``'s C entry point on the
    current stream, counting each in its ``counter`` and, where its frame
    launch takes the many-wave plan, in ``many_wave_launches``; returns
    ``(x, state, mag, stats)``."""
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
    _build.check_tensors(dev, checks)
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
    fn = getattr(_build.library(), kernel.entry)
    for it in range(n_iters):
        last = it == n_iters - 1
        kernel.counters[counter] += 1
        kernel.counters["many_wave_launches"] += plan.many_wave
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
        _build.check(code, kernel.entry)
        x_a, x_b = x_b, x_a
    stats = partial.sum(dim=(0, 1)) if with_loss else None
    return x_a, state, mag, stats


def plain(twin, x_pad, state, target, window, inv_env, scalar, cfg: STFTConfig, n_iters: int,
          emit_state: bool = False, with_mag: bool = False, with_loss: bool = False,
          valid_t: int = 0):
    """``n_iters`` plain iterations of an algorithm's ``twin``; ``valid_t``
    is an explicit frame count and an ``inv_env`` of None stops each at the
    raw overlap-add."""
    geo = geometry(cfg, target.shape[-2], inv_env)
    carry, mag = (x_pad, state), None
    for _ in range(n_iters):
        carry, mag = twin(carry, target, window, inv_env, scalar, cfg, geo, valid_t)
    stats = eval_sums(mag, target, valid_t) if with_loss else None
    return outputs(*carry, mag, stats, emit_state, with_mag, with_loss)


class Run(torch.autograd.Function):
    """Kernel forward; backward replays the plain loop under autograd."""

    @staticmethod
    def forward(ctx, kernel, x_pad, state, target, window, inv_env, scalar, cfg, n_iters,
                with_mag, with_loss, valid, counter):
        x, state_out, mag, stats = launch(
            kernel, counter, x_pad, state, target, window, inv_env, scalar, cfg, n_iters,
            with_mag, with_loss, valid,
        )
        ctx.save_for_backward(x_pad, state, target, window, inv_env)
        ctx.args = kernel.twin, scalar, cfg, n_iters, valid
        extras = [t for t in (mag, stats) if t is not None]
        ctx.mark_non_differentiable(*extras)
        return (x, state_out, *extras)

    @staticmethod
    def backward(ctx, g_x, g_state, *_g_extras):
        twin, scalar, cfg, n_iters, valid = ctx.args

        def loop(*inputs):
            return plain(twin, *inputs, scalar, cfg, n_iters, emit_state=True, valid_t=valid)

        grads = replay(loop, ctx.saved_tensors, ctx.needs_input_grad[1:6], (g_x, g_state))
        return (None, *grads, None, None, None, None, None, None, None)


class Kernel:
    """One algorithm on the engine: its name (as errors give it), its C
    entry point, its plain ``twin`` (one iteration: ``twin(state, target,
    window, inv_env, scalar, cfg, geo, valid) -> (state, mag)``) and
    ``counters``, its module's namespace, where ``launches`` and
    ``iteration_launches`` count the whole run's and the raw dispatch's
    launches and ``many_wave_launches`` those on the many-wave plan.  Its
    methods are the algorithm module's public functions: ``state`` is the
    algorithm's plane (Griffin-Lim's momentum ``pre``, ADMM's ``Y``),
    ``scalar`` its parameter (``lr``, ``rho``), ``mag`` its magnitude."""

    def __init__(self, name: str, entry: str, twin, counters: dict):
        self.name, self.entry, self.twin, self.counters = name, entry, twin, counters

    def run(self, x_pad, state, target, window, inv_env, scalar, cfg: STFTConfig,
            n_iters: int, emit_state: bool = False, with_mag: bool = False,
            with_loss: bool = False, valid_t: int = 0):
        """Run ``n_iters`` iterations -> final ``x_pad (B, lp)``.

        With ``emit_state`` the final state plane is returned too; with
        ``with_mag`` the magnitude of the LAST iteration ``(B, T, F)``; with
        ``with_loss`` the eval sums ``[sum (mag-tgt)^2, sum mag^2]`` of the
        last iteration over the first ``valid_t`` frames (0 = all).  Return
        order ``x[, state][, mag][, stats]``, as in the JAX driver.  One
        ``specinv.launch`` span covers the dispatch.
        """
        with span("launch"):
            return self._dispatch("launches", x_pad, state, target, window, inv_env, scalar,
                                  cfg, n_iters, emit_state, with_mag, with_loss,
                                  valid_frames(valid_t, target.shape[-2]))

    def iteration(self, x_pad, state, target, window, scalar, cfg: STFTConfig,
                  with_mag: bool = False, with_loss: bool = False, valid_t=None):
        """One raw iteration, one kernel launch -> ``(x, state[, mag][,
        stats])``, the counterpart of the JAX ``fused_*_iteration4`` with
        ``normalize=False``.

        The signal is the raw overlap-add of the windowed frames, ``(B,
        (T-1)*hop + n_fft)``, with no envelope and no re-pad: times the
        envelope and re-padded it is one iteration of :meth:`run`.
        ``valid_t`` is the number of frames the eval sums cover: None for
        all ``T``, 0 for none (a shard of padding rows; the whole run reads
        0 as all).
        """
        return self._dispatch("iteration_launches", x_pad, state, target, window, None, scalar,
                              cfg, 1, True, with_mag, with_loss,
                              valid_count(valid_t, target.shape[-2]))

    def run_reference(self, x_pad, state, target, window, inv_env, scalar, cfg: STFTConfig,
                      n_iters: int, emit_state: bool = False, with_mag: bool = False,
                      with_loss: bool = False, valid_t: int = 0):
        """Plain PyTorch version of :meth:`run` (same contract)."""
        return plain(self.twin, x_pad, state, target, window, inv_env, scalar, cfg, n_iters,
                     emit_state, with_mag, with_loss, valid_frames(valid_t, target.shape[-2]))

    def iteration_reference(self, x_pad, state, target, window, scalar, cfg: STFTConfig,
                            with_mag: bool = False, with_loss: bool = False, valid_t=None):
        """Plain PyTorch version of :meth:`iteration` (same contract)."""
        return plain(self.twin, x_pad, state, target, window, None, scalar, cfg, 1, True,
                     with_mag, with_loss, valid_count(valid_t, target.shape[-2]))

    def _dispatch(self, counter, x_pad, state, target, window, inv_env, scalar,
                  cfg: STFTConfig, n_iters: int, emit_state: bool, with_mag: bool,
                  with_loss: bool, valid: int):
        """The plain loop on a CPU tensor, else :class:`Run`, counting its
        launches in ``counter``: ``x[, state][, mag][, stats]``."""
        if x_pad.device.type == "cpu":
            return plain(self.twin, x_pad, state, target, window, inv_env, scalar, cfg, n_iters,
                         emit_state, with_mag, with_loss, valid)
        if not supports(cfg, window):
            raise ValueError(f"the {self.name} kernel needs {UNSUPPORTED} (n_fft={cfg.n_fft}, "
                             f"hop={cfg.hop_length})")
        if n_iters < 1:
            raise ValueError(f"n_iters must be >= 1, got {n_iters}")
        x, state_out, *extras = Run.apply(
            self, x_pad, state, target, window, inv_env, float(scalar), cfg, n_iters, with_mag,
            with_loss, valid, counter,
        )
        mag = extras.pop(0) if with_mag else None
        stats = extras.pop(0) if with_loss else None
        return outputs(x, state_out, mag, stats, emit_state, with_mag, with_loss)
