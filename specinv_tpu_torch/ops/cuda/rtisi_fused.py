"""k RTISI-LA steps per launch: the CUDA kernel, its plain version, its gradient.

``csrc/rtisi_fused.cu`` replaces the TPU kernels
``specinv_tpu/ops/pallas/rtisi_fused4.py::_kernel_multi`` (k steps per
launch) and ``::_kernel`` (one step per launch, the same function at k = 1).
:func:`fused_rtisi_steps` takes the state in the plain path's layout:
committed frames ``keeped (B, num_keep, n_fft)``, in-flight frames ``update
(B, la+1, n_fft)``, momentum ``pre (B, la+1, F)`` complex, onesided in
natural bin order, and a window of ``k + la`` magnitude frames ``target (B,
k + la, F)``; it returns ``(committed (k, B, n_fft), keeped, update, pre)``.

On a CPU tensor it runs :func:`fused_rtisi_steps_reference`; on a CUDA
tensor it queues one launch on the current stream with no host sync, or
raises.  The kernel takes an even n_fft in [16, 4096] whose half is
2^a 3^b 5^c (:func:`supported_size`): where the half is no power of two
(n_fft 400) it runs the mixed-radix stages of ``csrc/rfft.cuh``.  The
launch is one thread-block cluster per stream; :func:`plan` says how the
``R = la + 1`` in-flight frames spread over its CTAs and where
their state lives (``csrc/rtisi_fused.cu`` explains the design).  Gradients
flow through a ``torch.autograd.Function`` whose backward replays the plain
twin (``ops/twins.rtisi_steps_twin``) under autograd, as the JAX package's
``custom_vjp`` replays ``_multi_twin``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import STFTConfig
from ...utils.profiling import span
from ..twins import RTISIWindows, replay, rtisi_steps_twin
from . import _build, _fullrun
from .fft import MAX_N, MIN_N, scales, twiddles

UNSUPPORTED = ("onesided spectra, an even n_fft in [16, 4096] whose half is 2^a 3^b 5^c, "
               "0 < hop <= n_fft and a real window")

# Kernel launches (one per call of fused_rtisi_steps on CUDA tensors), and
# those of them whose transform has a radix-5 or radix-3 stage.
launches = 0
mixed_radix_launches = 0

SHARED_BYTES = 232448  # the most dynamic shared memory a block takes on Hopper (227 KB)
MAX_CLUSTER = 8        # the portable cluster size
MAX_THREADS = 512


class Plan(NamedTuple):
    """The launch plan of one stream's cluster."""

    cluster: int         # CTAs per stream
    frames_per_cta: int  # in-flight frames a CTA owns: CTA c owns frames_per_cta * c onwards
    group: int           # frames per FFT pass through shared memory
    resident: bool       # whether the frames' state lives in shared memory
    threads: int         # threads per CTA
    smem: int            # dynamic shared-memory bytes per CTA
    scratch: int         # floats of device memory per stream for the state (0 if resident)

    def owned(self, rank: int, R: int) -> range:
        """The frame slots CTA ``rank`` owns."""
        return range(rank * self.frames_per_cta, min(R, (rank + 1) * self.frames_per_cta))


def _frame_floats(n: int) -> int:
    """Floats of state per in-flight frame in device memory: two upd
    buffers, the committed tail over its samples, the momentum (complex) and
    the target row."""
    return 3 * n + 3 * (n // 2 + 1)


def _resident_floats(n: int, R: int, fpc: int) -> int:
    """Floats of a CTA's state in shared memory: a replica of every frame's
    upd (two buffers) and, for its own frames, the committed tail, the
    momentum (complex) and the target row."""
    return 2 * R * n + fpc * (n + 3 * (n // 2 + 1))


def plan(n_fft: int, R: int) -> Plan:
    """Cluster size, frames per CTA, frames per FFT pass, where the state
    lives, threads and shared memory for ``R`` in-flight frames of
    ``n_fft`` (the kernel checks the same layout).  Shared memory holds the
    twiddles (``n_fft/2`` complex FP64), the synthesis window, two FFT
    buffers of ``n_fft/2`` complex FP64 (and one padding point per eight)
    per frame of a pass, and, where it all fits, the state: a replica of
    every frame's upd and the owned frames' other state; else the state
    lives in device memory."""
    if R < 1:
        raise ValueError(f"need R >= 1 frames in flight, got {R}")
    fpc = -(-R // MAX_CLUSTER)
    cluster = -(-R // fpc)
    half = n_fft // 2
    # FP64 twiddles and the float32 synthesis window; two FP64 complex
    # buffers, skewed by one point per eight, per frame of a pass
    fixed, per_frame = 16 * half + 4 * n_fft, 32 * (half + half // 8)
    state = 4 * _resident_floats(n_fft, R, fpc)
    resident = fixed + state + per_frame <= SHARED_BYTES
    group = min(fpc, (SHARED_BYTES - fixed - (state if resident else 0)) // per_frame)
    threads = min(MAX_THREADS, -(-max(32, group * n_fft // 4) // 32) * 32)
    scratch = 0 if resident else -(-R * _frame_floats(n_fft) // 2) * 2
    smem = fixed + group * per_frame + (state if resident else 0)
    return Plan(cluster, fpc, group, resident, threads, smem, scratch)


def supported_size(n: int) -> bool:
    """An even n in [16, 4096] whose half is 2^a 3^b 5^c: the sizes of the
    kernel's transform."""
    h = n // 2
    for p in (2, 3, 5):
        while h > 1 and h % p == 0:
            h //= p
    return MIN_N <= n <= MAX_N and n % 2 == 0 and h == 1


def mixed_radix(n: int) -> bool:
    """Whether the transform of a supported n has a radix-5 or radix-3
    stage: n/2 has a factor 3 or 5 (``rfft::Plan::mixed``)."""
    return (n // 2) % 3 == 0 or (n // 2) % 5 == 0


def supports(cfg: STFTConfig, window) -> bool:
    """Whether the kernel takes this config: onesided, n_fft of
    :func:`supported_size`, 0 < hop <= n_fft, and a real window."""
    return cfg.onesided and supported_size(cfg.n_fft) and _fullrun.supports_frames(cfg, window)


def fused_rtisi_steps_reference(keeped, update, pre, target, windows: RTISIWindows, lr,
                                cfg: STFTConfig, max_iter: int):
    """Plain PyTorch version of :func:`fused_rtisi_steps` (same contract)."""
    return rtisi_steps_twin(keeped, update, pre, target, windows, lr, cfg, max_iter)


def _check(keeped, update, pre, target, windows, cfg: STFTConfig):
    B, R, n = update.shape
    k = target.shape[-2] - R + 1
    _build.check_tensors(update.device, (
        ("keeped", keeped, torch.float32, (B, (n - 1) // cfg.hop_length, n)),
        ("update", update, torch.float32, (B, R, n)),
        ("pre", pre, torch.complex64, (B, R, cfg.num_freqs)),
        ("target", target, torch.float32, (B, k + R - 1, cfg.num_freqs)),
        *((f"windows.{f}", w, torch.float32, (n,)) for f, w in zip(windows._fields, windows)),
    ))
    if n != cfg.n_fft or k < 1:
        raise ValueError(f"n_fft {n} (config {cfg.n_fft}) and k = {k} steps: need k >= 1")


def _launch(keeped, update, pre, target, windows: RTISIWindows, lr, cfg: STFTConfig,
            max_iter: int):
    """Queue one launch of ``k`` steps; returns (committed, keeped, update, pre)."""
    global launches, mixed_radix_launches
    _check(keeped, update, pre, target, windows, cfg)
    B, R, n = update.shape
    k = target.shape[-2] - R + 1
    hop = cfg.hop_length
    dev = update.device
    # the kernel updates the state in place: it works on copies
    keep, upd, pre = (t.contiguous().clone() for t in (keeped, update, pre))
    target = target.contiguous()
    windows = [w.contiguous() for w in windows]
    com = torch.empty((k, B, n), dtype=torch.float32, device=dev)
    p = plan(n, R)
    scratch = torch.empty(max(1, B * p.scratch), dtype=torch.float32, device=dev)
    fscale, iscale = scales(n, cfg.normalized)
    fn = _build.library().specinv_rtisi_steps
    launches += 1
    mixed_radix_launches += mixed_radix(n)
    code = fn(
        keep.data_ptr(), upd.data_ptr(), pre.data_ptr(), target.data_ptr(),
        *(w.data_ptr() for w in windows), twiddles(n, dev, torch.complex128).data_ptr(),
        com.data_ptr(), scratch.data_ptr(),
        B, k, R, keep.shape[1], n, hop, max_iter,
        p.cluster, p.frames_per_cta, p.group, int(p.resident), p.threads, p.smem, p.scratch,
        float(lr), fscale, iscale, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "specinv_rtisi_steps")
    return com, keep, upd, pre


class _RTISISteps(torch.autograd.Function):
    """Kernel forward; backward replays the plain twin under autograd."""

    @staticmethod
    def forward(ctx, keeped, update, pre, target, window, first, rest, synth, lr, cfg,
                max_iter):
        windows = RTISIWindows(window, first, rest, synth)
        out = _launch(keeped, update, pre, target, windows, lr, cfg, max_iter)
        ctx.save_for_backward(keeped, update, pre, target, window, first, rest, synth)
        ctx.lr, ctx.cfg, ctx.max_iter = lr, cfg, max_iter
        return out

    @staticmethod
    def backward(ctx, *grads_out):
        def twin(*t):
            return rtisi_steps_twin(*t[:4], RTISIWindows(*t[4:]), ctx.lr, ctx.cfg, ctx.max_iter)

        grads = replay(twin, ctx.saved_tensors, ctx.needs_input_grad[:8], grads_out)
        return (*grads, None, None, None)


def fused_rtisi_steps(keeped, update, pre, target, windows: RTISIWindows, lr,
                      cfg: STFTConfig, max_iter: int):
    """Run ``k = target.shape[-2] - la`` RTISI-LA output-frame steps of
    ``max_iter`` refinements each -> ``(committed (k, B, n_fft), keeped,
    update, pre)``; see the module docstring for the layout.  One
    ``specinv.launch`` span covers the dispatch."""
    with span("launch"):
        if update.device.type == "cpu":
            return fused_rtisi_steps_reference(keeped, update, pre, target, windows, lr, cfg,
                                               max_iter)
        if not supports(cfg, windows.window):
            raise ValueError(
                f"the RTISI-LA kernel needs {UNSUPPORTED} (n_fft={cfg.n_fft}, "
                f"hop={cfg.hop_length}, onesided={cfg.onesided})"
            )
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        return _RTISISteps.apply(keeped, update, pre, target, *windows, float(lr), cfg,
                                 max_iter)
