"""The kernel paths' drivers, written once for Griffin-Lim and ADMM, the
counterparts of the loops of the JAX ``run_tm_pallas4`` and
``run_tm_pallas``.  Each takes the algorithm's kernel wrapper and scalar
and starts from :func:`seed`; ``models/griffin_lim`` and ``models/admm``
bind them as their ``run_tm_kernel`` and ``run_tm_dft``.  The spans: the
first inverse in ``specinv.seed``, the loop in ``specinv.loop`` (each
dispatch in ``specinv.launch``), the trim in ``specinv.synth``.
"""
from __future__ import annotations

import torch

from ..config import STFTConfig
from ..ops.framing import pad_center
from ..ops.stft import istft
from ..ops.twins import make_geometry, make_inv_env
from ..utils.profiling import span
from ..utils.runner import iterate, iterate_segmented, stats_eval_fns, stop_loss_fn


def seed(target_tm, init_spec_tm, window, cfg: STFTConfig, real: torch.dtype):
    """The kernel paths' start in the real type ``real``, one
    ``specinv.seed`` span: ``(geo, window, inv_env, target, (x_pad0,
    plane0))``, with ``x_pad0`` the seed's inverse in padded coordinates and
    ``plane0`` the seed itself (Griffin-Lim's momentum, ADMM's ``Y0``)."""
    T = target_tm.shape[-2]
    with span("seed"):
        geo = make_geometry(cfg, T)
        win = window.to(real)
        inv_env = make_inv_env(cfg, win, T, geo)
        target = target_tm.to(real).contiguous()
        plane0 = init_spec_tm.to(torch.complex64 if real == torch.float32 else torch.complex128)
        x_pad0 = pad_center(istft(init_spec_tm, cfg, window).to(real), cfg)
    return geo, win, inv_env, target, (x_pad0, plane0)


def run_kernel(fused_run, cpu_real, target_tm, init_spec_tm, window, scalar, tol,
               cfg: STFTConfig, *, max_iter: int, eva_iter: int = 10, metric: str = "sc",
               verbose: bool = False, mode: str = "fori", early_stop: bool = True,
               remat: bool = False, loss_psum_axes=None) -> torch.Tensor:
    """Drive the whole-run kernel ``fused_run`` (a ``fused_*_run`` wrapper)
    with the algorithm's ``scalar``: target (B, T, F) -> (B, L).

    The kernel takes float32; on CPU tensors its plain version runs in
    ``cpu_real``, or in the input's precision where that is None.  With no
    evaluation (``tol == 0``, not verbose) all ``max_iter`` iterations are
    one queue of launches; otherwise the run is eval segments of
    ``eva_iter`` iterations whose last iteration emits the two reduced
    sums, then an eval-free tail of ``max_iter % eva_iter``; the stop loss
    sums over the mesh axes ``loss_psum_axes`` when given.
    """
    real = torch.float32 if target_tm.is_cuda else (cpu_real or target_tm.dtype)
    geo, win, inv_env, target, state0 = seed(target_tm, init_spec_tm, window, cfg, real)

    def run(state, n_iters, **flags):
        return fused_run(state[0], state[1], target, win, inv_env, scalar, cfg, n_iters, **flags)

    with span("loop"):
        if not (early_stop or verbose):
            x_pad = run(state0, max_iter)
        else:
            eva_n = min(eva_iter, max_iter)

            def seg_step(state):
                x, plane, stats = run(state, eva_n, emit_state=True, with_loss=True)
                return (x, plane), stats

            tail_fn = None
            if max_iter % eva_iter:
                def tail_fn(state):
                    return run(state, max_iter % eva_iter, emit_state=True), None

            loss_fn, metric_fn = stats_eval_fns(metric, target, loss_psum_axes)
            x_pad = iterate_segmented(
                seg_step, state0, target, max_iter=max_iter, tol=tol,
                eva_iter=eva_iter, tail_fn=tail_fn, metric=metric, verbose=verbose,
                loss_fn=loss_fn, metric_fn=metric_fn, mode=mode, remat=remat,
            )[0]
    with span("synth"):
        return x_pad[..., geo.p_amt : geo.p_amt + geo.l_out]


def run_dft(bind, target_tm, init_spec_tm, window, scalar, tol, cfg: STFTConfig, *,
            max_iter: int, eva_iter: int = 10, metric: str = "sc", verbose: bool = False,
            mode: str = "fori", early_stop: bool = True, remat: bool = False,
            precision="high", loss_psum_axes=None) -> torch.Tensor:
    """Drive the direct-DFT iteration kernel that ``bind`` (a ``bind``
    wrapper) binds, with the algorithm's ``scalar``, in float32: target (B,
    T, F) -> (B, L).

    One launch per iteration under ``utils/runner.iterate``, with the
    magnitude plane as the eval output (written only when a run evaluates).
    JAX pins ``mode='fori'`` here; the port's two modes give the same
    result, so ``mode`` is honoured.
    """
    geo, win, inv_env, target, state0 = seed(target_tm, init_spec_tm, window, cfg,
                                             torch.float32)
    with_mag = verbose or (early_stop and not (isinstance(tol, (int, float)) and tol == 0))

    with span("loop"):
        iteration = bind(target, win, inv_env, scalar, cfg, precision=precision,
                         with_mag=with_mag)

        def step_fn(state):
            x, mag, plane = iteration(*state)
            return (x, plane), mag

        state = iterate(
            step_fn, state0, target, max_iter=max_iter, tol=tol, eva_iter=eva_iter,
            metric=metric, verbose=verbose, mode=mode, early_stop=early_stop, remat=remat,
            loss_fn=stop_loss_fn(loss_psum_axes),
        )
    with span("synth"):
        return state[0][..., geo.p_amt : geo.p_amt + geo.l_out]
