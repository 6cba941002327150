"""The direct-DFT kernels' wrapper, written once for both algorithms: the
config check, the device tables, the scratch, the launch (:class:`Launch`),
the binding of a run (:func:`bind`) and the gradient.

``csrc/dft_iter.cuh`` is one iteration engine (a frame launch, a
forward-product launch with an algorithm-specific middle, an
inverse-product launch, and ``fullrun.cuh``'s OLA launch); ``gl_fused`` and
``admm_fused`` each describe one of its two C entry points as a
:class:`Kernel`.  Both keep the signal ``x_pad (B, lp)`` in padded
coordinates and the state and target as ``(B, T, F)`` onesided planes in
natural bin order, and return ``(x_pad, mag, state)`` per iteration.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from ...config import STFTConfig
from ...utils.profiling import host_sync, span
from .. import dft
from ..twins import make_geometry, replay
from . import _build
from ._fullrun import PAD_CODES

MAX_N = 4096

UNSUPPORTED = "onesided, a real window, n_fft <= 4096 and 0 < hop <= n_fft"


class Kernel(NamedTuple):
    """What one algorithm gives the engine."""

    name: str        # the algorithm, as errors name it
    entry: str       # the C entry point
    # one plain iteration: twin(state, target, window, inv_env, scalar, cfg, geo,
    # *extra, precision) -> (state, mag)
    twin: Callable
    # its module's namespace: ``launches`` counts the iterations launched,
    # ``persistent_products`` their products on the persistent kernel (every
    # product in a bf16 scheme, csrc/dft_iter.cuh launch_split_gemm)
    counters: dict


def supports(cfg: STFTConfig, window) -> bool:
    """Whether the direct-DFT kernels take this config: onesided, a real
    window, n_fft <= 4096 and 0 < hop <= n_fft.  No power of two and no
    multiple of 128 is needed (the TPU kernel's ``128 | n_fft`` and ``128 |
    hop`` are its tiling)."""
    return (
        cfg.onesided
        and cfg.n_fft <= MAX_N
        and 0 < cfg.hop_length <= cfg.n_fft
        and not torch.as_tensor(window).is_complex()
    )


def padded_sizes(n_fft: int) -> tuple[int, int]:
    """``(n_pad, f_pad)``: n_fft rounded up to 64 and F = n_fft // 2 + 1 to
    32, so that every row of the kernels' operands is a whole number of
    128-byte lines (one stage is 64 deep: a bf16 line, two float32 ones)."""
    return -(-n_fft // 64) * 64, -(-(n_fft // 2 + 1) // 32) * 32


def interleaved_tables(n_fft: int, normalized: bool):
    """``(fwd, inv)`` float32 CPU tensors: the tables of
    :func:`dft.dft_tables` as the kernels read them ('highest' as they are,
    the split schemes as bf16 halves).  ``M2 (n_pad, 2 f_pad)`` holds
    ``cos[k, f]`` at ``[k, 2f]`` and ``-sin[k, f]`` at ``[k, 2f + 1]``,
    zeros in the pad (k >= n_fft, f >= F): the forward's operand is
    ``fwd = M2^T`` (each output column pair the (re, im) of one bin), the
    inverse's ``inv = M2`` (rows matching P's (re, im) interleave).  Both are
    row-major, the contraction innermost."""
    cos, sin, _ = (torch.from_numpy(np.array(a)) for a in dft.dft_tables(n_fft, normalized))
    n_pad, f_pad = padded_sizes(n_fft)
    f = cos.shape[1]
    m2 = torch.zeros(n_pad, 2 * f_pad, dtype=torch.float32)
    m2[:n_fft, 0 : 2 * f : 2] = cos
    m2[:n_fft, 1 : 2 * f : 2] = -sin
    return m2.t().contiguous(), m2


class DeviceTables(NamedTuple):
    w: torch.Tensor       # (F) fold weights * iscale / fscale
    fwd: torch.Tensor     # (2 f_pad, n_pad) float32: interleaved_tables' fwd, 'highest'
    inv: torch.Tensor     # (n_pad, 2 f_pad) float32: its inv
    fwd_hi: torch.Tensor  # bf16 halves of fwd
    fwd_lo: torch.Tensor
    inv_hi: torch.Tensor  # (n_pad, 2 f_pad) bf16 halves of its inv
    inv_lo: torch.Tensor


@functools.lru_cache(maxsize=None)
def device_tables(n_fft: int, normalized: bool, device: torch.device) -> DeviceTables:
    """The tables on ``device``, built once per ``(n_fft, normalized,
    device)`` (about 69 MB at n_fft 2048); each copy to a card is one host
    sync."""
    host = (torch.from_numpy(np.array(dft.dft_tables(n_fft, normalized)[2])),
            *interleaved_tables(n_fft, normalized))
    w, fwd, inv = (_to(t, device) for t in host)
    return DeviceTables(w, fwd, inv, *dft.split_bf16(fwd), *dft.split_bf16(inv))


def _to(t: torch.Tensor, device) -> torch.Tensor:
    with host_sync(device):
        return t.to(device)


def _ptr(t):
    return None if t is None else t.data_ptr()


class Launch:
    """``kernel``'s C entry point bound to what stays fixed over a run:
    the target, window, envelope, config, precision and scalars (the
    entry's trailing arguments before the stream) are checked, and the
    tables, the scratch and the fixed arguments made, once.  Each call
    launches one iteration on the current stream, counting it and its
    products on the persistent kernel first, and
    returns ``(x, mag or None, state)``; it does not check ``x_pad`` and
    ``state`` (:meth:`check` does)."""

    def __init__(self, kernel: Kernel, target, window, inv_env, cfg: STFTConfig, precision,
                 with_mag: bool, scalars):
        B, T, n_bins = target.shape
        n, self.dev = cfg.n_fft, target.device
        geo = make_geometry(cfg, T)
        if n_bins != cfg.num_freqs:
            raise ValueError(f"target has {n_bins} bins, the config {cfg.num_freqs}")
        self.expect = {"x_pad": (torch.float32, (B, geo.lp)),
                       "state": (torch.complex64, (B, T, n_bins)),
                       "target": (torch.float32, (B, T, n_bins)),
                       "window": (torch.float32, (n,)),
                       "inv_env": (torch.float32, (geo.lp,))}
        self.check(target=target, window=window, inv_env=inv_env)
        target, window, inv_env = (t.contiguous() for t in (target, window, inv_env))
        fwd, inv = dft.split_schemes(precision)
        tab = device_tables(n, cfg.normalized, self.dev)
        n_pad, f_pad = padded_sizes(n)

        def scratch(shape, dtype, needed=True):
            return torch.empty(shape, dtype=dtype, device=self.dev) if needed else None

        # Written and read within an iteration: the frames; the forward's
        # frames, float32 or split; P, float32 or split.
        frames = scratch((B, T, n), torch.float32)
        planes = (scratch((B, T, n_pad), torch.float32, fwd == "highest"),
                  scratch((B, T, n_pad), torch.bfloat16, fwd != "highest"),
                  scratch((B, T, n_pad), torch.bfloat16, dft.needs_lo(fwd)),
                  scratch((B, T, 2 * f_pad), torch.float32, inv == "highest"),
                  scratch((B, T, 2 * f_pad), torch.bfloat16, inv != "highest"),
                  scratch((B, T, 2 * f_pad), torch.bfloat16, dft.needs_lo(inv)))
        self.held = (target, window, inv_env, tab, frames, planes)
        self.persistent = (fwd != "highest") + (inv != "highest")
        self.fn, self.kernel = getattr(_build.library(), kernel.entry), kernel
        self.mag_shape = (B, T, n_bins) if with_mag else None
        self.head = (target.data_ptr(), window.data_ptr(),
                     *(t.data_ptr() for t in tab), inv_env.data_ptr(), frames.data_ptr())
        self.tail = (*(_ptr(t) for t in planes), B, T, n, cfg.hop_length, n_bins, geo.lp,
                     geo.p_amt, geo.e, PAD_CODES[cfg.pad_mode], dft.SCHEMES.index(fwd),
                     dft.SCHEMES.index(inv), *scalars)

    def check(self, **tensors):
        """Raise unless each named tensor (x_pad, state, target, window,
        inv_env) has its type and shape on the target's device."""
        _build.check_tensors(self.dev, ((name, t, *self.expect[name])
                                        for name, t in tensors.items()))

    def __call__(self, x_pad, state):
        x_pad, state = x_pad.contiguous(), state.contiguous()
        x_out, state_out = torch.empty_like(x_pad), torch.empty_like(state)
        mag = None if self.mag_shape is None else torch.empty(self.mag_shape, device=self.dev)
        self.kernel.counters["launches"] += 1
        self.kernel.counters["persistent_products"] += self.persistent
        code = self.fn(x_pad.data_ptr(), x_out.data_ptr(), state.data_ptr(),
                       state_out.data_ptr(), *self.head, _ptr(mag), *self.tail,
                       torch.cuda.current_stream(self.dev).cuda_stream)
        _build.check(code, self.kernel.entry)
        return x_out, mag, state_out


class Iteration(torch.autograd.Function):
    """One iteration: the forward from ``step`` (the kernel, or on the CPU
    the plain version), the backward from ``replay`` (the plain twin at
    ``'highest'``) under autograd, as the JAX package's ``custom_vjp``
    replays its XLA twin."""

    @staticmethod
    def forward(ctx, step, replay, x_pad, state, target, window, inv_env):
        x, mag, state_out = step(x_pad, state, target, window, inv_env)
        ctx.save_for_backward(x_pad, state, target, window, inv_env)
        ctx.replay = replay
        if mag is None:
            return x, state_out
        ctx.mark_non_differentiable(mag)
        return x, state_out, mag

    @staticmethod
    def backward(ctx, g_x, g_state, *_g_mag):
        grads = replay(lambda *t: ctx.replay(*t)[0], ctx.saved_tensors,
                       ctx.needs_input_grad[2:], (g_x, g_state))
        return (None, None, *grads)


def bind(kernel: Kernel, target, window, inv_env, scalar: float, cfg: STFTConfig, extra,
         precision, with_mag: bool):
    """``(iteration, run)``: a function of ``(x_pad, state)`` that runs one
    iteration of ``kernel`` with everything else bound, and the kernel's
    :class:`Launch` (None for tensors on the CPU), whose checks, tables and
    scratch are made once, here.  ``(scalar, *extra)`` are the entry
    point's trailing arguments; ``precision`` is checked by the caller.
    Each iteration is one ``specinv.launch`` span; it does not check
    ``x_pad`` and ``state``."""
    geo = make_geometry(cfg, target.shape[-2])
    run = None
    if target.device.type == "cpu":
        def step(x_pad, state, *t):
            (x, state), mag = kernel.twin((x_pad, state), *t, scalar, cfg, geo, *extra, precision)
            return x, (mag if with_mag else None), state
    else:
        if not supports(cfg, window):
            raise ValueError(f"the direct-DFT {kernel.name} kernel needs {UNSUPPORTED} "
                             f"(n_fft={cfg.n_fft}, hop={cfg.hop_length})")
        run = Launch(kernel, target, window, inv_env, cfg, precision, with_mag,
                     (scalar, *extra))

        def step(x_pad, state, *_):
            return run(x_pad, state)

    def twin(x, s, *rest):
        return kernel.twin((x, s), *rest, scalar, cfg, geo, *extra, "highest")

    def iteration(x_pad, state):
        with span("launch"):
            x, state_out, *mag = Iteration.apply(step, twin, x_pad, state, target, window,
                                                 inv_env)
        return x, (mag[0] if with_mag else None), state_out

    return iteration, run


def fused_iteration(kernel: Kernel, x_pad, state, target, window, inv_env, scalar: float,
                    cfg: STFTConfig, extra, precision, with_mag: bool):
    """One iteration of ``kernel`` -> ``(x_pad, mag or None, state)``, with
    ``x_pad`` and ``state`` checked: the ``fused_*_iteration`` wrappers'
    dispatch."""
    iteration, run = bind(kernel, target, window, inv_env, scalar, cfg, extra, precision,
                          with_mag)
    if run is not None:
        run.check(x_pad=x_pad, state=state)
    return iteration(x_pad, state)
