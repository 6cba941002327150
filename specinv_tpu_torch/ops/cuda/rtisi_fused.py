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
raises.  Gradients flow through a ``torch.autograd.Function`` whose backward
replays the plain twin (``models/_kernel_driver.rtisi_steps_twin``) under
autograd, as the JAX package's ``custom_vjp`` replays ``_multi_twin``.
"""
from __future__ import annotations

import torch

from ...config import STFTConfig
from ...models._kernel_driver import RTISIWindows, rtisi_steps_twin
from . import _build, _fullrun
from .fft import scales, twiddles

UNSUPPORTED = f"onesided spectra, {_fullrun.UNSUPPORTED}"

# Kernel launches (one per call of fused_rtisi_steps on CUDA tensors).
launches = 0


def supports(cfg: STFTConfig, window) -> bool:
    """Whether the kernel takes this config: onesided, n_fft a power of two
    in [16, 4096], 0 < hop <= n_fft, and a real window."""
    return cfg.onesided and _fullrun.supports(cfg, window)


def fused_rtisi_steps_reference(keeped, update, pre, target, windows: RTISIWindows, lr,
                                cfg: STFTConfig, max_iter: int):
    """Plain PyTorch version of :func:`fused_rtisi_steps` (same contract)."""
    return rtisi_steps_twin(keeped, update, pre, target, windows, lr, cfg, max_iter)


def _check(keeped, update, pre, target, windows, cfg: STFTConfig):
    B, R, n = update.shape
    k = target.shape[-2] - R + 1
    dev = update.device
    for name, t, dtype, shape in (
        ("keeped", keeped, torch.float32, (B, (n - 1) // cfg.hop_length, n)),
        ("update", update, torch.float32, (B, R, n)),
        ("pre", pre, torch.complex64, (B, R, cfg.num_freqs)),
        ("target", target, torch.float32, (B, k + R - 1, cfg.num_freqs)),
        *((f"windows.{f}", w, torch.float32, (n,)) for f, w in zip(windows._fields, windows)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if n != cfg.n_fft or k < 1:
        raise ValueError(f"n_fft {n} (config {cfg.n_fft}) and k = {k} steps: need k >= 1")


def _launch(keeped, update, pre, target, windows: RTISIWindows, lr, cfg: STFTConfig,
            max_iter: int):
    """Queue one launch of ``k`` steps; returns (committed, keeped, update, pre)."""
    global launches
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
    length = (R - 1) * hop + n
    xk = torch.empty((B, length), dtype=torch.float32, device=dev)
    xs = torch.empty_like(xk)
    fscale, iscale = scales(n, cfg.normalized)
    fn = _build.library().specinv_rtisi_steps
    launches += 1
    code = fn(
        keep.data_ptr(), upd.data_ptr(), pre.data_ptr(), target.data_ptr(),
        *(w.data_ptr() for w in windows), twiddles(n, dev).data_ptr(),
        com.data_ptr(), xk.data_ptr(), xs.data_ptr(),
        B, k, R, keep.shape[1], n, n.bit_length() - 1, hop, max_iter,
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
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_rtisi_steps_reference(
                *inputs[:4], RTISIWindows(*inputs[4:]), ctx.lr, ctx.cfg, ctx.max_iter)
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grads_out, allow_unused=True))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None, None)


def fused_rtisi_steps(keeped, update, pre, target, windows: RTISIWindows, lr,
                      cfg: STFTConfig, max_iter: int):
    """Run ``k = target.shape[-2] - la`` RTISI-LA output-frame steps of
    ``max_iter`` refinements each -> ``(committed (k, B, n_fft), keeped,
    update, pre)``; see the module docstring for the layout."""
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
    return _RTISISteps.apply(keeped, update, pre, target, *windows, float(lr), cfg, max_iter)
