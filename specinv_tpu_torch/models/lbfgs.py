"""L-BFGS inversion of arbitrary differentiable spectral transforms.

Counterpart of ``specinv_tpu/models/lbfgs.py``: minimizes
``MSE(transform_fn(x), spec)`` over a waveform ``x`` for any differentiable
torch ``transform_fn`` (e.g. :func:`~specinv_tpu_torch.ops.mel.log_mel_transform`),
with ``torch.optim.LBFGS`` semantics inside each outer step and the shared
outer loop (``utils/runner.iterate``) around them.

Two inner loops, as in the JAX package:

* ``line_search_fn=None``: the fixed-step ``torch.optim.LBFGS`` step
  (:mod:`._lbfgs_torch`), trajectory-exact against the JAX package in
  float64, with every stop rule kept on the device (a frozen state, no
  read-back per inner iteration).
* ``line_search_fn='strong_wolfe'``: the JAX package's loop (at most
  ``min(max_iter, max_eval)`` iterations, its stop rule, the history carried
  across outer steps), with the compact L-BFGS preconditioner of optax's
  ``scale_by_lbfgs`` (memory written at ``(count - 1) % m``, weights
  ``1/(s.y)`` guarded only against zero, gamma from the newest pair, the
  first step capped at ``min(1, 1/||g||)``) and ``torch.optim.LBFGS``'s own
  strong-Wolfe search (``torch.optim.lbfgs._strong_wolfe``, starting at step
  1 as optax's zoom does) in place of optax's zoom.  The search reads the
  loss back on the host at each evaluation, so this loop is host-driven.

``direction``: ``'compact'`` (the default under ``'auto'``) computes the
two-loop recursion's result through the compact representation
(:mod:`._lbfgs_compact`); ``'two_loop'`` keeps the sequential recursion.
``history_dtype='bfloat16'`` (compact only) stores the history rows in bf16
with every product accumulated in the waveform's type.

``evaluations`` and ``inner_iterations`` count the closure evaluations
(loss and gradient) and the inner iterations the host ran, across calls.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..transforms import as_tensor
from ..utils.runner import _mse, iterate
from ._lbfgs_compact import compact_direction, gram_insert
from ._lbfgs_torch import _vdot, history_dtype_of, init_state, lbfgs_step

evaluations = 0
inner_iterations = 0


class WolfeState(NamedTuple):
    """The strong-Wolfe path's state between outer steps."""

    x: torch.Tensor        # the waveform
    value: torch.Tensor    # loss at x (0-d; inf before the first evaluation)
    grad: torch.Tensor     # its gradient
    count: torch.Tensor    # preconditioner updates so far (int64, 0-d)
    params: torch.Tensor   # x at the last preconditioner update
    updates: torch.Tensor  # the gradient there
    sbuf: torch.Tensor     # (m, *x.shape) parameter differences
    ybuf: torch.Tensor     # (m, *x.shape) gradient differences
    weights: torch.Tensor  # (m,) 1/(s.y), 0 for an unusable slot
    gram: torch.Tensor     # (m, m) S Y^T


def init_wolfe_state(x0: torch.Tensor, history_size: int, history_dtype=None) -> WolfeState:
    dt, dev = x0.dtype, x0.device
    rows = torch.zeros((history_size, *x0.shape), dtype=history_dtype_of(history_dtype) or dt,
                       device=dev)
    return WolfeState(
        x=x0, value=torch.full((), math.inf, dtype=dt, device=dev), grad=torch.zeros_like(x0),
        count=torch.zeros((), dtype=torch.int64, device=dev), params=torch.zeros_like(x0),
        updates=torch.zeros_like(x0), sbuf=rows, ybuf=rows.clone(),
        weights=torch.zeros((history_size,), dtype=dt, device=dev),
        gram=torch.zeros((history_size, history_size), dtype=dt, device=dev),
    )


def value_and_grad(loss_fn: Callable) -> Callable:
    """``x -> (loss, d loss / d x)``, both detached."""

    def vg(x):
        global evaluations
        evaluations += 1
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            loss = loss_fn(x)
            (grad,) = torch.autograd.grad(loss, x)
        return loss.detach(), grad

    return vg


def wolfe_step(state: WolfeState, value_and_grad_fn: Callable, *, max_iter: int,
               max_eval: int, tolerance_grad: float, tolerance_change: float) -> WolfeState:
    """One outer step of the strong-Wolfe path: at most ``min(max_iter,
    max_eval)`` inner iterations, each a preconditioner update, a direction,
    a line search and the JAX package's stop rule (the gradient's max below
    ``tolerance_grad``, the update's max or the loss change below
    ``tolerance_change``).  The history buffers are written in place."""
    from torch.optim.lbfgs import _strong_wolfe

    global inner_iterations
    x, value, grad, count, params, prev_upd, sbuf, ybuf, weights, gram = state
    m, shape, ht = sbuf.shape[0], x.shape, sbuf.dtype
    iota = torch.arange(m, device=x.device)
    count = int(count)
    value = float(value)
    if not math.isfinite(value):  # no value at x yet: evaluate
        loss, grad = value_and_grad_fn(x)
        value = float(loss)

    def obj(x_flat, t, d_flat):
        loss, g = value_and_grad_fn((x_flat + t * d_flat).view(shape))
        return float(loss), g.reshape(-1)

    prev_loss = math.inf
    for _ in range(min(max_iter, max_eval)):
        inner_iterations += 1
        # the compact form of optax's scale_by_lbfgs update
        slot = (count - 1) % m
        if count:
            s, y = x - params, grad - prev_upd
            sy = _vdot(y, s)
            weight = torch.where(sy == 0, torch.zeros_like(sy), 1.0 / sy)
            denom = _vdot(y, y)
            gamma = torch.where(denom > 0, sy / denom, torch.ones_like(sy))
        else:
            s = y = torch.zeros_like(x)
            weight = torch.zeros((), dtype=x.dtype, device=x.device)
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        sbuf[slot] = s.to(ht)
        ybuf[slot] = y.to(ht)
        weights = torch.where(iota == slot, weight, weights)
        gram = gram_insert(gram, sbuf, ybuf, slot, s, y)
        perm = (count % m + iota) % m
        d = -compact_direction(grad, sbuf, ybuf, weights, gram, perm, weights[perm] != 0,
                               gamma)
        params, prev_upd, count = x, grad, count + 1

        f_new, g_new, t, _ = _strong_wolfe(obj, x.reshape(-1), 1.0, d.reshape(-1), value,
                                           grad.reshape(-1), _vdot(grad, d))
        update = t * d
        done = (float(grad.abs().max()) <= tolerance_grad
                or float(update.abs().max()) <= tolerance_change
                or abs(value - prev_loss) < tolerance_change)
        x = x + update
        prev_loss, value, grad = value, f_new, g_new.view(shape)
        if done:
            break
    return WolfeState(
        x=x, value=torch.full((), value, dtype=x.dtype, device=x.device), grad=grad,
        count=torch.full((), count, dtype=torch.int64, device=x.device), params=params,
        updates=prev_upd, sbuf=sbuf, ybuf=ybuf, weights=weights, gram=gram,
    )


def run(
    target: torch.Tensor,
    x0: torch.Tensor,
    tol: float,
    transform_fn: Callable,
    outer_max_iter: int = 1000,
    inner_max_iter: int = 20,
    history_size: int = 100,
    line_search: bool = True,
    lr: float = 1.0,
    max_eval: int = 25,
    tolerance_grad: float = 1e-7,
    tolerance_change: float = 1e-9,
    eva_iter: int = 10,
    metric: str = "sc",
    verbose: bool = False,
    mode: str = "fori",
    direction: str = "compact",
    history_dtype: str | None = None,
) -> torch.Tensor:
    """The outer loop of :func:`L_BFGS` from ``x0`` (checked arguments)."""

    def loss_fn(x):
        return _mse(transform_fn(x), target)

    vg = value_and_grad(loss_fn)

    def output(x):
        with torch.no_grad():
            return transform_fn(x)

    if line_search:
        def outer_step(state):
            state = wolfe_step(state, vg, max_iter=inner_max_iter, max_eval=max_eval,
                               tolerance_grad=tolerance_grad,
                               tolerance_change=tolerance_change)
            return state, output(state.x)

        state = init_wolfe_state(x0, history_size, history_dtype)
    else:
        def outer_step(state):
            global inner_iterations
            x, st = state
            x, st = lbfgs_step(
                x, st, vg, lr=lr, max_iter=inner_max_iter, max_eval=max_eval,
                tolerance_grad=tolerance_grad, tolerance_change=tolerance_change,
                direction=direction,
            )
            inner_iterations += inner_max_iter
            return (x, st), output(x)

        state = (x0, init_state(x0, history_size, history_dtype=history_dtype))

    state = iterate(outer_step, state, target, max_iter=outer_max_iter, tol=tol,
                    eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode)
    return state[0].detach()


def L_BFGS(
    spec,
    transform_fn: Callable,
    samples: Optional[Sequence[int]] = None,
    init_x0=None,
    outer_max_iter: int = 1000,
    tol: float = 1e-6,
    verbose: bool = True,
    eva_iter: int = 10,
    metric: str = "sc",
    mode: str = "fori",
    seed: int = 0,
    lr: float = 1.0,
    max_iter: int = 20,
    max_eval: Optional[int] = None,
    tolerance_grad: float = 1e-7,
    tolerance_change: float = 1e-9,
    history_size: int = 100,
    line_search_fn: Optional[str] = None,
    direction: str = "auto",
    history_dtype: Optional[str] = None,
):
    """Reference-parity entry point, the JAX package's signature.

    ``transform_fn`` maps a waveform of shape ``samples`` (a torch tensor) to
    a representation comparable with ``spec``, differentiably.  ``spec`` is
    a tensor on any device, or an array, which goes to the card; the
    waveform lives on ``spec``'s device.  Without ``init_x0`` the waveform
    starts from ``N(0, 1e-6)`` drawn by a ``torch.Generator`` on that device
    seeded with ``seed``: a start the JAX package's ``PRNGKey`` draw cannot
    give, so runs compared across the packages pass ``init_x0``.

    ``outer_max_iter`` counts outer steps; ``lr`` .. ``line_search_fn``
    carry ``torch.optim.LBFGS`` semantics (``max_iter`` inner iterations per
    outer step, ``max_eval`` defaulting to ``max_iter * 5 // 4``; ``lr`` is
    the fixed step, and the strong-Wolfe search starts at step 1 as the JAX
    package's does).  ``direction`` is ``'auto'`` (= ``'compact'``),
    ``'compact'`` or ``'two_loop'``; ``history_dtype`` (e.g.
    ``'bfloat16'``) needs ``'compact'``.  Unknown kwargs raise
    ``TypeError``.  Returns the waveform, detached.
    """
    target = as_tensor(spec)
    if init_x0 is None:
        if samples is None:
            raise ValueError("provide either init_x0 or samples")
        if isinstance(samples, int):
            samples = (samples,)
        real = target.real.dtype if target.is_complex() else target.dtype
        gen = torch.Generator(device=target.device).manual_seed(seed)
        init_x0 = torch.randn(tuple(samples), generator=gen, dtype=real,
                              device=target.device) * 1e-6
    elif isinstance(init_x0, torch.Tensor):
        init_x0 = init_x0.to(target.device)
    else:
        init_x0 = torch.as_tensor(np.asarray(init_x0), device=target.device)

    if line_search_fn not in (None, "strong_wolfe"):
        raise ValueError(f"unsupported line_search_fn {line_search_fn!r}")
    if direction not in ("auto", "compact", "two_loop"):
        raise ValueError(f"unsupported direction {direction!r}")
    if direction == "auto":
        direction = "compact"
    if history_dtype is not None:
        if direction != "compact":
            raise ValueError(
                "history_dtype requires direction='compact' (the two-loop "
                "recursion keeps torch's exact summation order)"
            )
        history_dtype = history_dtype_of(history_dtype)
    if max_eval is None:
        max_eval = max_iter * 5 // 4  # torch.optim.LBFGS default

    return run(
        target, init_x0, tol, transform_fn, outer_max_iter=outer_max_iter,
        inner_max_iter=max_iter, history_size=history_size,
        line_search=line_search_fn == "strong_wolfe", lr=lr, max_eval=max_eval,
        tolerance_grad=tolerance_grad, tolerance_change=tolerance_change,
        eva_iter=eva_iter, metric=metric, verbose=verbose, mode=mode,
        direction=direction, history_dtype=history_dtype,
    )


l_bfgs = L_BFGS
