"""Sequence-parallel Griffin-Lim and ADMM: the time axis split over ranks.

Counterpart of ``specinv_tpu/parallel/seq.py``, for clips too long for one
card or to cut the latency of long audio.  The only dependencies between
shards in an iteration lie at chunk boundaries:

* analysis framing needs ``H = n_fft - hop`` samples of the right
  neighbour's signal (the halo) for its last frames;
* synthesis overlap-add spills ``H`` samples past the chunk's right edge
  into the left of the next shard.

Each is one exchange of a ``(B, H)`` slab per iteration with the
neighbouring ranks of the mesh's ``seq`` axis, the counterpart of
``lax.ppermute`` (``utils.collective.shift``); a shard with no partner
receives zeros, as ``ppermute`` gives them.  ``pad_mode='circular'`` adds one exchange
between shard 0 and shard ``n - 1`` (the wrap pad's source samples lie on
the opposite edge shard).  Everything else (transforms, momentum or the
ADMM update, projection, envelope divide, re-pad) is local.

Geometry, as in JAX: ``T`` frames are padded to ``n * Ts``; a shard owns
``C = Ts * hop`` samples in padded coordinates (the centre pad lies inside
shard 0's and shard ``n - 1``'s chunks) and recomputes its own edge pad
every iteration, as the unsharded path re-pads on every analysis.

Every rank gets the whole spectrogram, as ``shard_map`` replicates it, and
runs the one-shot prologue (SPSI seed, first ``istft``, envelope and
interior mask over ``n * C`` samples); then it takes its chunk, iterates,
and the chunks are all-gathered, so every rank returns the whole waveform.

Backends: ``'kernel'`` (the JAX ``'pallas4'``) runs framing, both
transforms, the update and the overlap-add of the shard's ``Ts`` frames as
one raw launch of the whole-run kernels' engine
(``gl_fullrun.fused_gl_iteration`` / ``admm_fullrun.fused_admm_iteration``),
the port of the TPU kernels ``gl_fused4._kernel`` and
``admm_fused4._kernel_iter``; ``'fft'`` runs the same step on ``torch.fft``
with the unsharded ``'fft'`` path's magnitude (``abs``), as JAX's
``gl_step`` / ``admm_step`` do.  (The kernels' plain versions take it as
``sqrt(re^2 + im^2 + 1e-30)``, as JAX's twins do, for a finite gradient;
in float32 that rounds differently, and after 60 iterations the seq path
would lie 8.5e-4 of the max from the unsharded call, not within JAX's
1e-4.)  The exchange, envelope and re-pad stay in PyTorch, because the
spill must cross shards before the divide.  ``'auto'`` is ``'kernel'`` on
the card where the kernels take the config, else ``'fft'``.  The
exchange's transport is set by the process group's backend
(``utils.collective.staged``).

Gradients, as JAX's ``jax.grad`` through ``shard_map``: the spectrogram
enters through ``utils.collective.replicated``, whose backward sums the
cotangent over the ranks that use it (the seq axis, and the data axis under
``shard_batch_axis``), so every rank holds the whole gradient; the
exchanges are ``collective.shift`` (backward: the reverse exchange) and the
final gathers ``collective.all_gather`` (backward: this rank's slice).  On
``'kernel'`` each launch's backward replays its plain twin under autograd
(``ops/cuda/_fullrun.Run``, ``ops/twins.replay``), as JAX's ``custom_vjp`` replays
``gl_xla_twin4`` / ``admm_xla_twin4``; no backward kernel.  The stop rule's
sums run on detached values, so ``mode='fori'`` with tol > 0 stays
differentiable.  Every rank must call ``backward`` on the same loss of the
whole waveform: the backward passes exchange, in the same order on every
rank.  ``remat=True`` recomputes each iteration in the backward pass,
exchanges included.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import STFTConfig
from ..models.common import prepare_spec, restore_output
from ..models.griffin_lim import magnitude_project
from ..models.phase_init import phase_init_tm
from ..ops import fourier
from ..ops.cuda import admm_fullrun, gl_fullrun
from ..ops.framing import frame, ola_envelope, overlap_add, pad_center
from ..ops.stft import istft
from ..ops.twins import PROJ_EPS
from ..utils.collective import all_gather, all_reduce_sum, replicated, shift
from ..utils.runner import iterate
from . import mesh as mesh_mod
from .mesh import Mesh

BACKENDS = ("auto", "fft", "kernel")


def _check_seq_backend(backend: str, algo: str) -> None:
    """Reject backend strings the sequence-parallel path cannot honour."""
    fourier.check_not_xla_lowering(backend)
    if backend == "pallas4":
        raise ValueError(
            "backend 'pallas4' is a TPU kernel; its counterpart on the "
            "sequence-parallel path is 'kernel'")
    if backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not supported on the sequence-parallel "
            f"{'Griffin-Lim' if algo == 'gl' else 'ADMM'} path; expected one "
            f"of {BACKENDS}"
        )


def _geometry(cfg: STFTConfig, T: int, n: int):
    hop, n_fft = cfg.hop_length, cfg.n_fft
    k = math.ceil(n_fft / hop)
    Ts = math.ceil((T + k - 1) / n)
    T_pad = n * Ts
    C = Ts * hop
    H = n_fft - hop
    P_amt = cfg.pad_amount
    Lp = (T - 1) * hop + n_fft
    L_out = Lp - 2 * P_amt
    if H > C:
        raise ValueError(
            f"chunk too small: {Ts} frames x hop {hop} < halo {H}; use fewer seq shards"
        )
    if P_amt and 2 * P_amt + 1 > C:
        raise ValueError("signal too short for this seq mesh (left pad spans shards)")
    b_end = P_amt + L_out - 1  # last real sample, padded coords
    e_local = b_end - (n - 1) * C
    if P_amt and (e_local - P_amt < 0 or e_local + P_amt >= C):
        raise ValueError("signal too short for this seq mesh (right pad spans shards)")
    return Ts, T_pad, C, H, Lp, L_out, b_end, e_local


def _set(x: torch.Tensor, start: int, vals: torch.Tensor) -> torch.Tensor:
    """``x`` with ``x[..., start : start + len(vals)] = vals``."""
    stop = start + vals.shape[-1]
    return torch.cat([x[..., :start], vals, x[..., stop:]], dim=-1)


def _resolve(backend: str, cfg: STFTConfig, window, device) -> str:
    if backend == "auto":
        use = device.type == "cuda" and gl_fullrun.supports(cfg, window)
        return "kernel" if use else "fft"
    if backend == "kernel" and not gl_fullrun.supports(cfg, window):
        raise ValueError(
            f"seq backend='kernel' needs {gl_fullrun.UNSUPPORTED}; use backend='auto'")
    return backend


def _run_seq(target_tm, init_spec_tm, window, scalar, tol, cfg: STFTConfig, mesh: Mesh,
             max_iter: int, eva_iter: int, groups, backend: str, algo: str, remat: bool,
             total: int) -> torch.Tensor:
    """The shard body on this rank: target / seed ``(B', T, F)`` (this
    rank's clips) -> the whole trimmed waveform ``(B', L_out)``; ``groups``:
    the process groups of the ranks that share the input."""
    n, s = mesh.shape["seq"], mesh.index("seq")
    group = mesh.group("seq")
    T = target_tm.shape[-2]
    hop, n_fft = cfg.hop_length, cfg.n_fft
    P = cfg.pad_amount
    Ts, T_pad, C, H, Lp, L_out, _, e_local = _geometry(cfg, T, n)
    left = mesh.peer("seq", s - 1) if s > 0 else None
    right = mesh.peer("seq", s + 1) if s < n - 1 else None
    dev = target_tm.device

    # --- one-shot prologue over the whole clip, then this rank's chunk ---
    x_pad0 = F.pad(pad_center(istft(init_spec_tm, cfg, window), cfg), (0, n * C - Lp))
    kernel = backend == "kernel"
    if kernel:  # the kernel computes in float32, as the whole-run path does
        window, target_tm = window.float(), target_tm.float()
        x_pad0, init_spec_tm = x_pad0.float(), init_spec_tm.to(torch.complex64)
    env = F.pad(ola_envelope(window * window, T, hop), (0, n * C - Lp))
    env = torch.where(env == 0, torch.ones_like(env), env)
    interior = torch.zeros(n * C, dtype=torch.bool, device=dev)
    interior[P : P + L_out] = True
    own, rows = slice(s * C, (s + 1) * C), slice(s * Ts, (s + 1) * Ts)
    x_chunk0 = x_pad0[..., own].contiguous()
    env_loc, mask_loc = env[own], interior[own]
    tgt_loc = F.pad(target_tm, (0, 0, 0, T_pad - T))[:, rows].contiguous()
    # seed the momentum (GL) or the DR state Y0 = X0 (ADMM) with the spectrum
    pre0 = F.pad(init_spec_tm, (0, 0, 0, T_pad - T))[:, rows].contiguous()
    valid = min(max(T - s * Ts, 0), Ts)  # this shard's true frames
    valid_rows = (torch.arange(Ts, device=dev) < valid)[:, None]

    def extend(x_chunk):
        """Append the right neighbour's first H samples (zeros on the last
        shard)."""
        halo = shift(x_chunk[..., :H], group, left, right)
        return torch.cat([x_chunk, halo], dim=-1)  # (B', C + H)

    def finish_signal(y):
        """Exchange the overlap-add spill, divide by the envelope, re-pad
        the edges on the edge shards."""
        tail = shift(y[..., C:], group, right, left)
        y_own = torch.cat([y[..., :H] + tail, y[..., H:C]], dim=-1)
        x_div = torch.where(mask_loc, y_own / env_loc, torch.zeros_like(y_own))
        if not P or cfg.pad_mode == "constant":  # constant: already zero outside
            return x_div
        if cfg.pad_mode == "circular":
            # the left pad copies the LAST P real samples (on shard n-1), the
            # right pad the FIRST P (on shard 0): one exchange between them
            tail_src = x_div[..., e_local - P + 1 : e_local + 1]
            head_src = x_div[..., P : 2 * P]
            if n == 1:
                recv_left, recv_right = tail_src, head_src
            elif s in (0, n - 1):
                other = mesh.peer("seq", n - 1 - s)
                recv_left = recv_right = shift(
                    tail_src if s == n - 1 else head_src, group, other, other)
        elif cfg.pad_mode == "reflect":
            recv_left = x_div[..., P + 1 : 2 * P + 1].flip(-1)
            recv_right = x_div[..., e_local - P : e_local].flip(-1)
        else:  # replicate
            recv_left = x_div[..., P : P + 1].expand(*x_div.shape[:-1], P)
            recv_right = x_div[..., e_local : e_local + 1].expand(*x_div.shape[:-1], P)
        if s == 0:
            x_div = _set(x_div, 0, recv_left)
        if s == n - 1:
            x_div = _set(x_div, e_local + 1, recv_right)
        return x_div

    def gl_step(state):
        x_chunk, pre = state
        spec = fourier.forward(frame(extend(x_chunk), n_fft, hop) * window, cfg)
        out = spec.abs()
        pre = spec - scalar * pre
        y = overlap_add(fourier.inverse(magnitude_project(pre, tgt_loc), cfg) * window, hop)
        return (finish_signal(y), pre), out  # y: (B', C + H)

    def admm_step(state):
        # the DR one-variable form: Y = X + U, so U' = Y - Z and only Y persists
        x_chunk, Y = state
        R = fourier.forward(frame(extend(x_chunk), n_fft, hop) * window, cfg)
        out = R.abs()
        Z = (scalar * Y + R) / (1 + scalar)
        U = Y - Z
        Tz = Z - U
        Yn = Tz * (tgt_loc / (Tz.abs() + PROJ_EPS)) + U
        # rows past T stay inert: the dual would give them Y = -R/(1+rho)
        Yn = torch.where(valid_rows, Yn, torch.zeros_like(Yn))
        y = overlap_add(fourier.inverse(Yn, cfg) * window, hop)
        return (finish_signal(y), Yn), out

    evaluating = tol != 0  # as utils/runner.iterate decides
    dispatch = (admm_fullrun.fused_admm_iteration if algo == "admm"
                else gl_fullrun.fused_gl_iteration)

    def kernel_step(state):
        # one raw launch over the shard's Ts frames: lp = (Ts-1)*hop + n_fft
        # = C + H samples, the eval sums over its true frames only
        x_chunk, plane = state
        x_raw, plane, *stats = dispatch(extend(x_chunk), plane, tgt_loc, window, scalar, cfg,
                                        with_loss=evaluating, valid_t=valid)
        return (finish_signal(x_raw), plane), (stats[0] if evaluating else None)

    # the stop loss only decides the done flag: detached, so that no
    # collective enters the backward graph
    def psum_mse(out, tgt):
        # rows past T have a zero target but read real signal tail: masked,
        # or the stop iteration would move away from the unsharded path's
        d = torch.where(valid_rows, out.detach() - tgt, torch.zeros_like(out))
        return all_reduce_sum(torch.sum((d * d).real), groups) / total

    def psum_stats(stats, _tgt):
        return all_reduce_sum(stats[0].detach(), groups) / total

    step = kernel_step if kernel else (admm_step if algo == "admm" else gl_step)
    state = iterate(
        step, (x_chunk0, pre0), tgt_loc, max_iter=max_iter, tol=tol, eva_iter=eva_iter,
        loss_fn=psum_stats if kernel else psum_mse, mode="fori", remat=remat,
    )
    x = all_gather(state[0], group, dim=-1)
    return x[..., P : P + L_out]


def _prepare(spec, mesh: Mesh, shard_batch_axis: bool, groups, **stft_kwargs):
    """The spectrogram on the mesh's device, time-major, this rank's clips
    (all of them unless ``shard_batch_axis``); the global element count."""
    if isinstance(spec, torch.Tensor):
        spec = spec.to(mesh.device)
    else:
        spec = torch.as_tensor(np.asarray(spec), device=mesh.device)
    if spec.dtype in (torch.bfloat16, torch.float16):
        spec = spec.float()
    # each rank differentiates through its own rows and chunk only
    spec = replicated(spec, groups)
    spec_tm, was_2d, cfg, window = prepare_spec(spec, **stft_kwargs)
    if window.is_complex():
        raise ValueError("the sequence-parallel path needs a real window")
    total = spec_tm.numel()
    if shard_batch_axis:
        spec_tm = spec_tm[mesh_mod.batch_sharding(mesh, batch=spec_tm.shape[0])]
    if spec_tm.is_complex():
        cmplx_tm, target_tm = spec_tm, spec_tm.abs()
    else:
        cmplx_tm, target_tm = phase_init_tm(spec_tm, cfg), spec_tm
    return target_tm, cmplx_tm, was_2d, cfg, window, total


def _run(spec, mesh, algo, scalar, max_iter, tol, eva_iter, shard_batch_axis, backend,
         remat, stft_kwargs):
    _check_seq_backend(backend, algo)
    # the ranks that share the input: the stop loss and the gradient sum
    # over them
    groups = [mesh.group(a) for a in (("seq", "data") if shard_batch_axis else ("seq",))]
    target_tm, cmplx_tm, was_2d, cfg, window, total = _prepare(
        spec, mesh, shard_batch_axis, groups, **stft_kwargs)
    backend = _resolve(backend, cfg, window, mesh.device)
    x = _run_seq(target_tm, cmplx_tm, window, scalar, float(tol), cfg, mesh, max_iter,
                 eva_iter, groups, backend, algo, remat, total)
    if shard_batch_axis:
        x = all_gather(x, mesh.group("data"), dim=0)
    return restore_output(x, was_2d)


def griffin_lim_seq(
    spec,
    mesh: Mesh,
    max_iter: int = 200,
    tol: float = 0.0,
    alpha: float = 0.99,
    eva_iter: int = 10,
    shard_batch_axis: bool = False,
    backend: str = "auto",
    remat: bool = False,
    **stft_kwargs,
):
    """Sequence-parallel Griffin-Lim over ``mesh``'s ``seq`` axis.

    Same numerics as :func:`specinv_tpu_torch.griffin_lim` (momentum,
    projection, envelope) with the time axis sharded; each iteration
    exchanges two halo slabs of ``n_fft - hop`` samples with the
    neighbouring ranks.  Every rank of the mesh calls it with the same
    arguments and gets the whole waveform.  ``shard_batch_axis`` splits the
    batch over the ``data`` axis too.  ``backend``: ``'auto'``, ``'fft'`` or
    ``'kernel'`` (one raw kernel launch per shard and iteration).
    """
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    return _run(spec, mesh, "gl", alpha / (1 + alpha), max_iter, tol, eva_iter,
                shard_batch_axis, backend, remat, stft_kwargs)


def admm_seq(
    spec,
    mesh: Mesh,
    max_iter: int = 1000,
    tol: float = 0.0,
    rho: float = 0.1,
    eva_iter: int = 10,
    shard_batch_axis: bool = False,
    backend: str = "auto",
    remat: bool = False,
    **stft_kwargs,
):
    """Sequence-parallel ADMM over ``mesh``'s ``seq`` axis.

    Same numerics as :func:`specinv_tpu_torch.ADMM` in the Douglas-Rachford
    form, rows past the true frame count held inert, with the time axis
    sharded and the same exchanges as :func:`griffin_lim_seq`.  On
    ``'kernel'`` each shard's launch takes its own true-frame count, 0 on a
    shard that holds only padding.  Gradients as :func:`griffin_lim_seq`:
    every rank calls ``backward`` on the same loss.
    """
    if rho <= 0:
        raise ValueError(f"rho must be > 0, got {rho}")
    return _run(spec, mesh, "admm", rho, max_iter, tol, eva_iter, shard_batch_axis,
                backend, remat, stft_kwargs)
