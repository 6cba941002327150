"""RTISI-LA: Real-Time Iterative Spectrogram Inversion with Look-Ahead, on PyTorch.

Counterpart of ``specinv_tpu/models/rtisi_la.py``.  Frame-sequential
(causal) inversion: each output frame is committed after ``max_iter``
Griffin-Lim refinements over a small look-ahead window, with momentum, an
optional asymmetric analysis window on the newest frame, and a buffer of
committed frames as the past context.  The numerics are the reference's:
``synth_coeff = hop / sum(w^2)``, asymmetric windows from flipped-window
partial sums, the frame-shifted momentum of the first refinement of every
step, projection epsilon 1e-16, the first ``look_ahead`` commits discarded
and a final window^2-normalised overlap-add.

Two backends, one state layout (``RTISIState``: committed frames ``(B,
num_keep, n_fft)``, in-flight frames ``(B, la+1, n_fft)``, momentum ``(B,
la+1, F)`` complex):

* ``'kernel'``: the hand-written CUDA kernel (``ops/cuda/rtisi_fused``), the
  counterpart of the JAX ``pallas4`` path: ``frames_per_launch`` output-frame
  steps per launch (8 by default), float32 only, at an even n_fft in [16,
  4096] whose half is 2^a 3^b 5^c (Whisper's 400 included).  On a CPU
  tensor it runs the kernel's plain version.  The streamer launches it with
  one step per push.
* ``'fft'``: the literal step on ``torch.fft`` (:func:`_frame_step`), the
  JAX XLA path's counterpart and the speed baseline on the card.

``'auto'`` picks the kernel for a float32 CUDA input whose config the kernel
takes, otherwise ``'fft'``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import STFT_KWARG_NAMES, STFTConfig, canonicalize
from ..ops import fourier
from ..ops.cuda import rtisi_fused
from ..ops.framing import frame, overlap_add
from ..ops.stft import make_envelope
from ..ops.twins import PROJ_EPS, RTISIWindows
from ..transforms import as_tensor, default_device, numpy_dtype, window_tensor
from ..utils.profiling import host_sync, span
from ..utils.runner import checkpointed, gate_verbose
from .common import prepare_spec_b3, restore_output

BACKENDS = ("auto", "kernel", "fft")


def _default_progress(msg: str) -> None:
    print(msg, flush=True)


# Replaceable progress sink: tests (or embedding applications) may swap it
# for a collector.  Looked up by name at report time.
_progress_sink = _default_progress


def _report(i: int, total: int) -> None:
    """Report "rtisi-la frame i+1/total" about 16 times per run (a host-side
    frame index: no device sync)."""
    every = max(1, total // 16)
    if (i + 1) % every == 0 or i + 1 == total:
        _progress_sink(f"rtisi-la frame {i + 1}/{total}")


# Output-frame steps per kernel launch on the offline path.
_FRAMES_PER_LAUNCH = 8


class RTISIState(NamedTuple):
    keeped: torch.Tensor    # (B, num_keep, n_fft) committed time-domain frames
    update: torch.Tensor    # (B, la+1, n_fft) in-flight time-domain frames
    pre_spec: torch.Tensor  # (B, la+1, F) momentum spectrum from the previous pass


def _asym_windows(window: torch.Tensor, hop: int, num_keep: int, synth_coeff):
    """The two asymmetric synthesis-aware analysis windows (the reference's
    flipped-window partial sums)."""
    n = window.shape[0]
    flipped = window.flip(0)
    aw1 = torch.zeros_like(window)
    for i in range(num_keep):
        off = (i + 1) * hop
        aw1 = aw1 + F.pad(flipped[: n - off], (off, 0))
    aw2 = torch.zeros_like(window)
    for i in range(num_keep + 1):
        off = i * hop
        aw2 = aw2 + F.pad(flipped[: n - off], (off, 0))
    return aw1 * synth_coeff, aw2 * synth_coeff


def rtisi_windows(window: torch.Tensor, cfg: STFTConfig, asymmetric_window: bool) -> RTISIWindows:
    """The kernel path's windows; without ``asymmetric_window`` the newest
    frame takes the plain analysis window."""
    hop = cfg.hop_length
    synth_coeff = hop / torch.sum(window * window)
    if asymmetric_window:
        first, rest = _asym_windows(window, hop, (cfg.n_fft - 1) // hop, synth_coeff)
    else:
        first = rest = window
    return RTISIWindows(window, first, rest, window * synth_coeff)


def _frame_step(state: RTISIState, target_slice, window, lr, cfg: STFTConfig,
                look_ahead: int, asymmetric_window: bool, max_iter: int):
    """One RTISI-LA output-frame step on ``torch.fft``: ``max_iter``
    look-ahead refinements, then commit the oldest in-flight frame and slide
    the buffers.  ``target_slice (B, la+1, F)``; returns ``(state,
    committed (B, n_fft))``.  Shared by the offline ``'fft'`` path and the
    streamer."""
    la = look_ahead
    n_fft, hop = cfg.n_fft, cfg.hop_length
    num_keep = (n_fft - 1) // hop
    synth_coeff = hop / torch.sum(window * window)
    aw1, aw2 = _asym_windows(window, hop, num_keep, synth_coeff)
    synth_window = window * synth_coeff

    keeped, update, pre_spec = state
    for j in range(max_iter):
        # Windowed OLA of committed + in-flight frames, committed prefix dropped
        all_frames = torch.cat([keeped, update], dim=1) * synth_window
        x = overlap_add(all_frames, hop)[..., num_keep * hop :]
        frames_x = frame(x, n_fft, hop)  # (B, la+1, n_fft)
        if asymmetric_window:
            asym = aw1 if j == 0 else aw2
            w_rows = torch.cat([window.expand(la, n_fft), asym[None]], dim=0)
            new_spec = fourier.forward(frames_x * w_rows, cfg)
        else:
            new_spec = fourier.forward(frames_x * window, cfg)
        if j == 0:  # frame r takes frame r+1's momentum, the newest none
            new_spec = torch.cat(
                [new_spec[:, :-1] - lr * pre_spec[:, 1:], new_spec[:, -1:]], dim=1)
        else:
            new_spec = new_spec - lr * pre_spec
        pre_spec = new_spec
        update = fourier.inverse(
            new_spec * (target_slice / (new_spec.abs() + PROJ_EPS)), cfg)

    committed = update[:, 0]
    if num_keep:
        keeped = torch.cat([keeped[:, 1:], update[:, :1]], dim=1)
    update = torch.cat([update[:, 1:], torch.zeros_like(update[:, :1])], dim=1)
    return RTISIState(keeped=keeped, update=update, pre_spec=pre_spec), committed


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _seed_update(target_pad: torch.Tensor, la: int, cfg: STFTConfig) -> torch.Tensor:
    """The initial in-flight frames: zeros, then the first target frame's
    zero-phase inverse as the newest."""
    first = fourier.inverse(target_pad[:, la : la + 1].to(_complex_dtype(target_pad.dtype)), cfg)
    return torch.cat([first.new_zeros((first.shape[0], la, cfg.n_fft)), first], dim=1)


def _scan_frames(target_pad, window, lr, cfg, la, asymmetric_window, max_iter, verbose,
                 remat):
    """The ``'fft'`` path: every step through :func:`_frame_step`; returns
    the committed frames ``(steps + la, B, n_fft)``."""
    B, n_pad, n_bins = target_pad.shape
    total = n_pad - la
    update0 = _seed_update(target_pad, la, cfg)
    state = RTISIState(
        keeped=update0.new_zeros((B, (cfg.n_fft - 1) // cfg.hop_length, cfg.n_fft)),
        update=update0,
        pre_spec=torch.zeros((B, la + 1, n_bins), dtype=_complex_dtype(update0.dtype),
                             device=update0.device),
    )

    def step(st, target_slice):
        return _frame_step(st, target_slice, window, lr, cfg, la, asymmetric_window, max_iter)

    if remat:
        step = checkpointed(step)
    out = []
    for i in range(total):
        state, committed = step(state, target_pad[:, i : i + la + 1])
        out.append(committed)
        if verbose:
            _report(i, total)
    return torch.stack(out)


def _kernel_launches(target_pad, update0, windows, lr, cfg, la, max_iter, verbose,
                     frames_per_launch):
    """``ceil(total / k)`` kernel launches of ``k = frames_per_launch``
    steps (the last takes what remains); returns the committed frames."""
    B, n_pad, n_bins = target_pad.shape
    total = n_pad - la
    kpl = _FRAMES_PER_LAUNCH if frames_per_launch is None else frames_per_launch
    kpl = max(1, min(kpl, total))
    n_fft = cfg.n_fft
    state = (
        update0.new_zeros((B, (n_fft - 1) // cfg.hop_length, n_fft)),
        update0,
        torch.zeros((B, la + 1, n_bins), dtype=torch.complex64, device=update0.device),
    )

    out = []
    for i0 in range(0, total, kpl):
        k = min(kpl, total - i0)
        com, *state = rtisi_fused.fused_rtisi_steps(*state, target_pad[:, i0 : i0 + k + la],
                                                    windows, lr, cfg, max_iter)
        out.append(com)
        if verbose:
            _report(min(i0 + kpl, total) - 1, total)
    return torch.cat(out)


def _chunk_streams(batch: int, chunk_rows, la: int) -> int:
    """Streams per launch: all of them, or ``chunk_rows // (la+1)``."""
    return batch if chunk_rows is None else max(1, chunk_rows // (la + 1))


def _kernel_frames(target_pad, window, lr, cfg, la, asymmetric_window, max_iter, verbose,
                   chunk_rows, frames_per_launch):
    """The ``'kernel'`` path (float32); with ``chunk_rows`` the streams run
    as sequential chunks of ``chunk_rows // (la+1)``.  Returns the committed
    frames."""
    with span("seed"):
        target_pad = target_pad.float()
        update0 = _seed_update(target_pad, la, cfg)
        windows = rtisi_windows(window.float(), cfg, asymmetric_window)
    args = (windows, lr, cfg, la, max_iter)
    B = target_pad.shape[0]
    chunk_b = _chunk_streams(B, chunk_rows, la)
    with span("loop"):
        if B <= chunk_b:
            return _kernel_launches(target_pad, update0, *args, verbose, frames_per_launch)
        nb = -(-B // chunk_b)
        out = []
        for c in range(nb):
            rows = slice(c * chunk_b, (c + 1) * chunk_b)
            out.append(_kernel_launches(target_pad[rows], update0[rows], *args, False,
                                        frames_per_launch))
            if verbose:  # per-frame lines would repeat once per chunk
                _progress_sink(f"rtisi-la chunk {c + 1}/{nb}")
        return torch.cat(out, dim=1)


def run_tm(target_tm, window, lr, cfg: STFTConfig, look_ahead: int,
           asymmetric_window: bool = False, max_iter: int = 25, verbose: bool = False,
           backend: str = "fft", remat: bool = False, chunk_rows: int | None = None,
           frames_per_launch: int | None = None) -> torch.Tensor:
    """Time-major RTISI-LA: magnitude (B, T, F) -> waveform (B, L).

    ``backend`` is ``'kernel'`` or ``'fft'`` (resolved); ``remat``
    recomputes each step of the ``'fft'`` path in the backward pass (on
    the card the kernel's backward already keeps only each launch's inputs
    and replays the plain version).
    """
    steps = target_tm.shape[1]
    la = look_ahead
    with span("prep"):
        target_pad = F.pad(target_tm, (0, 0, la, la))  # la zero frames on both sides
    if backend == "kernel":
        frames = _kernel_frames(target_pad, window, lr, cfg, la, asymmetric_window, max_iter,
                                verbose, chunk_rows, frames_per_launch)
    else:
        frames = _scan_frames(target_pad, window, lr, cfg, la, asymmetric_window, max_iter,
                              verbose, remat)
    with span("synth"):
        return synthesize(frames[la:], window, cfg)


def synthesize(frames: torch.Tensor, window: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Committed frames ``(T, B, n_fft)`` -> waveform ``(B, L)``: windowed
    OLA, centre trim and the window^2 envelope."""
    x = overlap_add(frames.movedim(0, 1) * window, cfg.hop_length)
    envelope = make_envelope(cfg, window, frames.shape[0])
    p = cfg.pad_amount
    if p:
        x = x[..., p:-p]
    envelope = torch.where(envelope == 0, torch.ones_like(envelope), envelope)
    return x / envelope


def _resolve_backend(backend: str, cfg: STFTConfig, window, dtype, device,
                     precision=None) -> str:
    """Backend dispatch shared by :func:`RTISI_LA` and :class:`RTISIStreamer`.

    ``'auto'`` -> ``'kernel'`` for a float32 tensor on a CUDA ``device``
    whose config the kernel takes, else ``'fft'`` (it stays ``'auto'``
    while ``device`` is None).  An explicit ``'kernel'`` is validated;
    ``precision`` (None, ``'high'`` or ``'highest'``: the kernel computes in
    full float32) applies to it only.
    """
    fourier.check_not_xla_lowering(backend)
    if backend == "pallas":
        raise ValueError(
            "RTISI-LA has no 'pallas' backend (the JAX package removed its "
            "direct-DFT stream kernel); use backend='kernel' or 'auto'"
        )
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    ok = rtisi_fused.supports(cfg, window)
    if backend == "auto" and device is not None:
        use = device.type == "cuda" and ok and dtype == torch.float32
        backend = "kernel" if use else "fft"
    if backend == "kernel":
        if not ok:
            raise ValueError(
                f"the kernel backend needs {rtisi_fused.UNSUPPORTED}; use backend='auto' instead"
            )
        if dtype != torch.float32:
            raise ValueError(
                "the RTISI-LA kernel runs in float32; cast the spectrogram or use backend='auto'"
            )
        if not (precision is None or (isinstance(precision, str)
                                      and precision.lower() in ("high", "highest"))):
            raise ValueError(
                f"precision {precision!r} is not supported: the kernel computes in "
                "full float32 (pass None, 'high' or 'highest')"
            )
    elif precision is not None:
        raise ValueError(f"precision applies to backend='kernel' only (backend: {backend!r})")
    return backend


def _check_knob(name: str, value, backend: str) -> None:
    """``chunk_rows`` / ``frames_per_launch`` tune the kernel's launches."""
    if value is None:
        return
    if value < 1:
        raise ValueError(f"{name} must be >= 1, got {value}")
    if backend not in ("kernel", "auto"):
        raise ValueError(
            f"{name} tunes the kernel's launches and applies to backend='kernel' "
            f"only (resolved backend: {backend!r})"
        )


def _check_kwargs(stft_kwargs) -> None:
    unknown = set(stft_kwargs) - set(STFT_KWARG_NAMES)
    if unknown:
        raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")


def RTISI_LA(
    spec,
    look_ahead: int = -1,
    asymmetric_window: bool = False,
    max_iter: int = 25,
    alpha: float = 0.99,
    verbose=1,
    backend: str = "auto",
    precision=None,
    remat: bool = False,
    chunk_rows: int | None = None,
    frames_per_launch: int | None = None,
    **stft_kwargs,
):
    """Reference-parity entry point.

    ``look_ahead=-1`` uses ``(win_length - 1) // hop`` future frames; ``0``
    disables look-ahead (original RTISI).  Input is a magnitude spectrogram
    ``(F, T)`` / ``(B, F, T)`` (a tensor on any device, or an array, which
    goes to the card); the waveform comes back on the same device.
    ``backend`` is ``'auto'``, ``'kernel'`` (float32, onesided, an even
    n_fft in [16, 4096] whose half is 2^a 3^b 5^c, hop <= n_fft, a real
    window) or ``'fft'``;
    ``precision`` (None, ``'high'``, ``'highest'``), ``chunk_rows`` (at
    most this many DFT rows ``B * (look_ahead + 1)`` per launch; larger
    batches run as sequential launches, bitwise equal; by default every
    stream is in one launch) and ``frames_per_launch`` (steps per launch,
    default 8) apply to the kernel only.  ``remat`` recomputes each step
    of the ``'fft'`` path in the backward pass; on the card the kernel
    path keeps only each launch's inputs anyway.
    """
    with span("call"):
        with span("prep"):
            if not (max_iter > 0 and alpha >= 0):
                raise ValueError(
                    f"need max_iter > 0 and alpha >= 0 (got {max_iter}, {alpha})")
            _check_kwargs(stft_kwargs)
            spec = as_tensor(spec)
            if spec.is_complex():
                raise ValueError("RTISI_LA expects a magnitude (real) spectrogram")
            spec_b3, was_2d, cfg, window = prepare_spec_b3(spec, **stft_kwargs)
            if spec_b3.dtype not in (torch.float32, torch.float64):
                spec_b3 = spec_b3.to(window.dtype)
            num_keep = (cfg.n_fft - 1) // cfg.hop_length
            la = num_keep if look_ahead < 0 else look_ahead
            backend = _resolve_backend(backend, cfg, window, spec_b3.dtype, spec_b3.device,
                                       precision)
            _check_knob("chunk_rows", chunk_rows, backend)
            _check_knob("frames_per_launch", frames_per_launch, backend)
        x = run_tm(
            spec_b3.transpose(-1, -2), window, alpha / (1 + alpha), cfg, look_ahead=la,
            asymmetric_window=asymmetric_window, max_iter=max_iter,
            verbose=gate_verbose(verbose), backend=backend, remat=remat,
            chunk_rows=chunk_rows, frames_per_launch=frames_per_launch,
        )
        with span("synth"):
            return restore_output(x, was_2d)


rtisi_la = RTISI_LA


class RTISIStreamer:
    """Real-time frame-in / samples-out RTISI-LA.

    Feed magnitude frames one at a time and receive ``hop`` committed
    samples per frame once the ``look_ahead`` warm-up has filled; latency is
    ``look_ahead + 1`` frames.  Samples leave through the steady-state
    window^2 envelope, so a stream's first and last samples differ from the
    offline call's edge-normalised output, by design.

    The streamer runs on the device of the first frame pushed (a tensor on
    any device, or an array, which goes to the card); ``backend='auto'``
    resolves then.  On ``'kernel'`` each step is one launch of the offline
    path's kernel with one step, so the committed frames equal the offline
    kernel path's bit for bit.

    Example::

        st = RTISIStreamer(num_freqs=257, look_ahead=3, window=hann)
        for frame in mag_frames:          # (F,) each
            chunk = st.push(frame)        # (1, hop) or None during warm-up
        tail = st.flush()
    """

    def __init__(
        self,
        num_freqs: int,
        look_ahead: int = 3,
        asymmetric_window: bool = False,
        max_iter: int = 25,
        alpha: float = 0.99,
        batch: int = 1,
        dtype=torch.float32,
        backend: str = "auto",
        chunk_rows: int | None = None,
        **stft_kwargs,
    ):
        _check_kwargs(stft_kwargs)
        self.cfg, self._window_np = canonicalize(num_freqs, numpy_dtype(dtype), **stft_kwargs)
        n_fft, hop = self.cfg.n_fft, self.cfg.hop_length
        self.num_keep = (n_fft - 1) // hop
        self.la = self.num_keep if look_ahead < 0 else look_ahead
        self.asymmetric_window = asymmetric_window
        self.max_iter = max_iter
        self.lr = alpha / (1 + alpha)
        self.batch = batch
        self.dtype = dtype
        self.F = num_freqs
        self.backend = _resolve_backend(backend, self.cfg, self._window_np, dtype, None)
        _check_knob("chunk_rows", chunk_rows, self.backend)
        self.chunk_rows = chunk_rows
        self.state = None  # allocated on the first push's device
        self._started = False

    def _bind(self, device: torch.device) -> None:
        """Resolve the backend for ``device`` and allocate the state there."""
        self.backend = _resolve_backend(self.backend, self.cfg, self._window_np, self.dtype,
                                        device)
        _check_knob("chunk_rows", self.chunk_rows, self.backend)
        n_fft, hop, B = self.cfg.n_fft, self.cfg.hop_length, self.batch
        self.window = window_tensor(self._window_np, device, self.dtype)
        if self.backend == "kernel":
            self._windows = rtisi_windows(self.window, self.cfg, self.asymmetric_window)
        zeros = dict(dtype=self.dtype, device=device)
        self.state = RTISIState(
            keeped=torch.zeros((B, self.num_keep, n_fft), **zeros),
            update=torch.zeros((B, self.la + 1, n_fft), **zeros),
            pre_spec=torch.zeros((B, self.la + 1, self.F), dtype=_complex_dtype(self.dtype),
                                 device=device),
        )
        # Left look-ahead zero padding, as the offline call pads its target.
        self._pending = [torch.zeros((B, self.F), **zeros)] * self.la
        self._warmup = self.la  # commits to discard (the reference drops la)
        self._ola_buf = torch.zeros((B, n_fft), **zeros)
        # Steady-state periodic envelope over one hop (sum of hop-shifted
        # w^2) and the decaying suffix envelope of the flush tail, summed in
        # float64 on the host as the JAX package does.
        wsq = np.asarray(self._window_np) ** 2
        suffix = np.zeros(n_fft)
        for j in range(-(-n_fft // hop)):
            suffix[: n_fft - j * hop] += wsq[j * hop :]
        env = suffix[:hop].copy()
        env[env == 0] = 1.0
        suffix[suffix == 0] = 1.0
        with host_sync(device):
            self._env = torch.from_numpy(env).to(**zeros)
        with host_sync(device):
            self._suffix_env = torch.from_numpy(suffix).to(**zeros)

    def push(self, frame_mag):
        """Feed one magnitude frame ``(F,)`` / ``(B, F)``; returns ``(B, hop)``
        committed samples, or ``None`` while the look-ahead window fills."""
        with span("push"):
            frame_mag = as_tensor(frame_mag)
            if self.state is None:
                with span("seed"):
                    self._bind(frame_mag.device)
            with span("prep"):
                if frame_mag.ndim == 1:
                    frame_mag = frame_mag[None]
                if frame_mag.device != self.window.device:
                    raise ValueError(
                        f"frame on {frame_mag.device}, streamer on {self.window.device}: "
                        "push every frame from the same device"
                    )
                frame_mag = frame_mag.to(self.dtype)
                self._pending.append(frame_mag)
                ready = len(self._pending) >= self.la + 1
                target_slice = torch.stack(self._pending, dim=1) if ready else None
            if not self._started:
                with span("seed"):  # the newest in-flight frame with zero phase
                    first = fourier.inverse(
                        frame_mag[:, None, :].to(_complex_dtype(self.dtype)), self.cfg)
                    self.state = self.state._replace(
                        update=torch.cat([self.state.update[:, : self.la], first], dim=1))
                    self._started = True
            return None if target_slice is None else self._step(target_slice)

    def _kernel_step(self, target_slice):
        keeped, update, pre = self.state
        chunk_b = _chunk_streams(self.batch, self.chunk_rows, self.la)
        outs = []
        for b0 in range(0, self.batch, chunk_b):
            rows = slice(b0, b0 + chunk_b)
            outs.append(rtisi_fused.fused_rtisi_steps(
                keeped[rows], update[rows], pre[rows], target_slice[rows], self._windows,
                self.lr, self.cfg, self.max_iter))
        with span("state"):  # the state rebuilt from the chunks' outputs
            com, keeped, update, pre = (torch.cat(parts, dim=1 if i == 0 else 0)
                                        for i, parts in enumerate(zip(*outs)))
            return RTISIState(keeped, update, pre), com[0]

    def _step(self, target_slice):
        if self.backend == "kernel":
            self.state, committed = self._kernel_step(target_slice)
        else:
            self.state, committed = _frame_step(
                self.state, target_slice, self.window, self.lr, self.cfg, self.la,
                self.asymmetric_window, self.max_iter)
        self._pending.pop(0)
        if self._warmup:
            self._warmup -= 1
            return None
        with span("synth"):
            return self._emit(committed)

    def _emit(self, committed):
        hop = self.cfg.hop_length
        buf = self._ola_buf + committed * self.window
        out = buf[:, :hop] / self._env
        self._ola_buf = torch.cat([buf[:, hop:], torch.zeros_like(buf[:, :hop])], dim=1)
        return out

    def flush(self):
        """Drain the look-ahead pipeline; returns the remaining samples
        ``(B, n_samples)``."""
        with span("flush"):
            if self.state is None:
                with span("seed"):
                    self._bind(default_device())
            chunks = []
            while self._pending:
                # Pad the target window with zero frames, as the offline call
                # pads its target on the right.
                with span("prep"):
                    padded = self._pending + [torch.zeros_like(self._pending[0])] * (
                        self.la + 1 - len(self._pending))
                    target_slice = torch.stack(padded, dim=1)
                out = self._step(target_slice)
                if out is not None:
                    chunks.append(out)
            with span("synth"):
                chunks.append(self._ola_buf / self._suffix_env[None])
                return torch.cat(chunks, dim=1)
