"""The fixed-step L-BFGS step of ``torch.optim.LBFGS``, with its stop rules
kept on the device.

Counterpart of ``specinv_tpu/models/_lbfgs_torch.py``: the update rule of
``torch.optim.LBFGS(line_search_fn=None)`` (the two-loop recursion or its
compact form over a bounded history, the first iteration's step scaling
``t = min(1, 1/sum|g|) * lr``, the ``ys > 1e-10`` curvature guard) and all
its break conditions (``max_iter``, ``max_eval``, ``tolerance_grad``,
``tolerance_change`` on the step and on the loss change, the
directional-derivative check), in the JAX package's order of operations.

The JAX package runs the step as a ``lax.while_loop``; here the host runs
``max_iter`` iterations and a ``done`` flag on the device freezes the state
(``torch.where``) once a break condition fired, so no stop decision is read
back.  The history is a ``(m, *x.shape)`` circular buffer written in place
(a row only where the JAX step writes it); the two-loop recursion masks
invalid slots.  State persists across outer steps, as torch's does: the
very first iteration ever resets the memory, later steps keep it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ._lbfgs_compact import compact_direction, gram_insert

CURVATURE_EPS = 1e-10  # torch's `ys > 1e-10` history-update guard


class TorchLBFGSState(NamedTuple):
    d: torch.Tensor          # search direction, shape of x
    t: torch.Tensor          # step size (0-d)
    ybuf: torch.Tensor       # (m, *x.shape) gradient differences (torch old_dirs)
    sbuf: torch.Tensor       # (m, *x.shape) steps (torch old_stps)
    rho: torch.Tensor        # (m,) 1/ys
    hist: torch.Tensor       # valid history rows (int64, 0-d)
    head: torch.Tensor       # next write slot (int64, 0-d, circular)
    h_diag: torch.Tensor     # initial inverse-Hessian scale (0-d)
    prev_grad: torch.Tensor  # shape of x
    prev_loss: torch.Tensor  # 0-d
    n_total: torch.Tensor    # torch's state['n_iter']: the global iteration count
    gram: torch.Tensor       # (m, m) S Y^T for the compact direction


def history_dtype_of(history_dtype) -> torch.dtype | None:
    """A ``history_dtype`` argument (a torch dtype or its name, e.g.
    ``'bfloat16'``) as a torch dtype; None stays None."""
    if history_dtype is None or isinstance(history_dtype, torch.dtype):
        return history_dtype
    dt = getattr(torch, str(history_dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown history_dtype {history_dtype!r}")
    return dt


def init_state(x0: torch.Tensor, history_size: int, history_dtype=None) -> TorchLBFGSState:
    """``history_dtype`` (opt-in, e.g. ``'bfloat16'``) stores the ``(m, n)``
    s/y history rows narrower than the waveform, halving the bytes the
    compact direction's matvecs stream, while every dot accumulates in the
    waveform's type.  Approximate: the trajectory is no longer torch's."""
    dt, dev = x0.dtype, x0.device
    ht = history_dtype_of(history_dtype) or dt

    def scalar(v, dtype=dt):
        return torch.full((), v, dtype=dtype, device=dev)

    return TorchLBFGSState(
        d=torch.zeros_like(x0),
        t=scalar(0.0),
        ybuf=torch.zeros((history_size, *x0.shape), dtype=ht, device=dev),
        sbuf=torch.zeros((history_size, *x0.shape), dtype=ht, device=dev),
        rho=torch.zeros((history_size,), dtype=dt, device=dev),
        hist=scalar(0, torch.int64),
        head=scalar(0, torch.int64),
        h_diag=scalar(1.0),
        prev_grad=torch.zeros_like(x0),
        prev_loss=scalar(float("inf")),
        n_total=scalar(0, torch.int64),
        gram=torch.zeros((history_size, history_size), dtype=dt, device=dev),
    )


def _vdot(a, b):
    return torch.sum(a * b)


def _row(buf, index):
    """``buf[index]`` for a 0-d device index, with no read-back."""
    return buf.index_select(0, index.reshape(1))[0]


def _two_loop(grad, ybuf, sbuf, rho, hist, head, h_diag):
    """L-BFGS two-loop recursion over the circular history (masked slots)."""
    m = ybuf.shape[0]

    def phys(i):  # logical i (0 = oldest) -> physical row
        return (head - hist + i) % m

    q, al = -grad, [None] * m
    for i in reversed(range(m)):
        p, use = phys(i), i < hist
        a = _vdot(_row(sbuf, p), q) * _row(rho, p)
        q = torch.where(use, q - a * _row(ybuf, p), q)
        al[i] = a
    r = q * h_diag
    for i in range(m):
        p, use = phys(i), i < hist
        b = _vdot(_row(ybuf, p), r) * _row(rho, p)
        r = torch.where(use, r + (al[i] - b) * _row(sbuf, p), r)
    return r


def lbfgs_step(
    x: torch.Tensor,
    st: TorchLBFGSState,
    value_and_grad_fn: Callable,
    *,
    lr: float,
    max_iter: int,
    max_eval: int,
    tolerance_grad: float,
    tolerance_change: float,
    direction: str = "compact",
):
    """One ``optimizer.step(closure)`` of fixed-step L-BFGS.

    Mirrors torch/optim/lbfgs.py ``step()`` with ``line_search_fn=None``:
    the closure is evaluated once up front, then up to ``max_iter``
    iterations run until a break condition fires (on the device: later
    iterations leave the state as it was).  ``value_and_grad_fn(x)`` returns
    ``(loss, grad)``.  ``st``'s history buffers are written in place.
    Returns ``(x, state)``.

    ``direction='compact'`` computes the direction through the compact
    representation (:mod:`._lbfgs_compact`), the same math as the two-loop
    recursion; ``'two_loop'`` keeps the sequential recursion (torch's
    summation order).
    """
    loss, grad = value_and_grad_fn(x)
    done = grad.abs().max() <= tolerance_grad
    evals = torch.ones((), dtype=torch.int64, device=x.device)
    m = st.ybuf.shape[0]
    ht = st.ybuf.dtype
    iota = torch.arange(m, device=x.device)
    for n_iter in range(1, max_iter + 1):
        active = ~done
        n_total = st.n_total + 1
        first = n_total == 1

        # lbfgs_dir of the JAX step (its direction is discarded on the first
        # iteration, which leaves the history as it is); the history rows
        # are written where it writes them
        y = grad - st.prev_grad
        s = st.d * st.t
        ys = _vdot(y, s)
        upd = (ys > CURVATURE_EPS) & ~first
        write = upd & active
        for buf, row in ((st.ybuf, y), (st.sbuf, s)):
            buf.index_copy_(0, st.head.reshape(1),
                            torch.where(write, row.to(ht), _row(buf, st.head))[None])
        rho = torch.where(upd & (iota == st.head), 1.0 / ys, st.rho)
        head = torch.where(upd, (st.head + 1) % m, st.head)
        hist = torch.where(upd, torch.clamp(st.hist + 1, max=m), st.hist)
        h_diag = torch.where(upd, ys / _vdot(y, y), st.h_diag)
        if direction == "compact":
            gram = torch.where(upd, gram_insert(st.gram, st.sbuf, st.ybuf, st.head, s, y),
                               st.gram)
            perm = (head - hist + iota) % m
            d = compact_direction(-grad, st.sbuf, st.ybuf, rho, gram, perm, iota < hist,
                                  h_diag)
        else:
            gram = st.gram
            d = _two_loop(grad, st.ybuf, st.sbuf, rho, hist, head, h_diag)
        # first_dir: steepest descent, memory reset
        d = torch.where(first, -grad, d)
        hist = torch.where(first, torch.zeros_like(hist), hist)
        head = torch.where(first, torch.zeros_like(head), head)
        h_diag = torch.where(first, torch.ones_like(h_diag), h_diag)

        t = torch.where(first, torch.clamp(1.0 / grad.abs().sum(), max=1.0) * lr,
                        torch.full_like(loss, lr)).to(loss.dtype)
        gtd = _vdot(grad, d)
        # directional derivative below tolerance: break BEFORE moving
        no_move = gtd > -tolerance_change
        x_new = torch.where(no_move, x, x + t * d)
        if n_iter != max_iter:
            do_eval = ~no_move
            loss_e, grad_e = value_and_grad_fn(x_new)
            loss_new = torch.where(do_eval, loss_e, loss)
            grad_new = torch.where(do_eval, grad_e, grad)
        else:  # torch evaluates no closure on the last iteration
            do_eval = torch.zeros_like(no_move)
            loss_new, grad_new = loss, grad
        evals_new = evals + do_eval.to(evals.dtype)
        opt_cond = do_eval & (grad_new.abs().max() <= tolerance_grad)
        stop = (
            no_move
            | (n_iter == max_iter)
            | (evals_new >= max_eval)
            | opt_cond
            | ((d * t).abs().max() <= tolerance_change)
            | ((loss_new - loss).abs() < tolerance_change)
        )

        def keep(new, old):
            return torch.where(active, new, old)

        st = TorchLBFGSState(
            d=keep(d, st.d), t=keep(t, st.t), ybuf=st.ybuf, sbuf=st.sbuf,
            rho=keep(rho, st.rho), hist=keep(hist, st.hist), head=keep(head, st.head),
            h_diag=keep(h_diag, st.h_diag), prev_grad=keep(grad, st.prev_grad),
            prev_loss=keep(loss, st.prev_loss), n_total=keep(n_total, st.n_total),
            gram=keep(gram, st.gram),
        )
        x, loss, grad = keep(x_new, x), keep(loss_new, loss), keep(grad_new, grad)
        evals = keep(evals_new, evals)
        done = done | stop
    return x, st
