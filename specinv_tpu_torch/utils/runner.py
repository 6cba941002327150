"""Iteration drivers with reference-parity early stopping.

Counterpart of ``specinv_tpu/utils/runner.py``.  The loop runs on the host;
the stop rule is the reference's (methods.py:180-189): evaluate at
iterations ``i % eva_iter == eva_iter - 1``, the first evaluation sets
``init_loss``, and the run stops when ``(prev_loss - l2) / init_loss < tol``
**and** ``prev_loss > l2``.  The returned state is the state after the
stopping iteration (the reference's break-out state).

The two modes give the same result:

* ``mode="fori"`` keeps the stop decision on the device, in a ``done``
  flag, and runs the remaining iterations, so nothing waits on the device
  (no host sync per evaluation).  The steps carry the live state as they
  wrote it; at each evaluation, before the rule sees its loss, a kept copy
  takes the live state unless ``done`` (one ``torch.where`` over the state,
  the live tensor first so that the select keeps its layout), and the run
  returns the live state unless ``done``, else the kept one: the state
  after the stopping evaluation.  ``done`` only changes at evaluations, so
  a select in between could change nothing.  A verbose run selects after
  every step instead, so that its prints after the stop read the frozen
  state (the JAX package's output).
* ``mode="while"`` reads the decision back at each evaluation and leaves the
  loop, skipping the work after the stop.

With ``tol == 0`` the condition can never fire (it needs the loss to rise and
fall at once), so the evaluation is skipped altogether.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..metrics import get_metric
from .collective import axis_sum
from .profiling import host_sync

StepFn = Callable[..., Tuple]  # state -> (state, output)

_MODES = ("fori", "while")


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.mean((d * d).real)


def _global_mean(reduce, total: torch.Tensor, count: float) -> torch.Tensor:
    """``sum(total) / sum(count)`` over the ranks ``reduce`` sums over."""
    both = reduce(torch.stack([total, torch.full_like(total, count)]))
    return both[0] / both[1]


def psum_mse(axes):
    """MSE stop loss reduced across mesh ``axes``: the local squared-error
    sum and element count, each summed over the axes' ranks, divided.  Every
    rank then stops on the global loss, the unsharded stop rule (zero-padded
    clips add zero to the sum and only rescale the ratio)."""
    reduce = axis_sum(axes)  # the counterpart of lax.psum under shard_map

    def loss(out: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        d = out - tgt
        return _global_mean(reduce, torch.sum((d * d).real), float(out.numel()))

    return loss


def stop_loss_fn(axes=None):
    """``loss_fn`` for the iteration drivers: the mesh-reduced MSE
    (:func:`psum_mse`) when mesh ``axes`` are given, else the default local
    MSE (None).  Axes name the axes of the mesh bound by the caller; outside
    one they raise."""
    return psum_mse(axes) if axes else None


def stats_eval_fns(metric: str, target: torch.Tensor, axes=None):
    """``(loss_fn, metric_fn)`` for segments whose eval output is the pair of
    reduced sums ``[sum (|S|-tgt)^2, sum |S|^2]`` instead of the magnitude
    plane.  The loss is the array path's MSE, its sum and count summed over
    mesh ``axes`` when given (as :func:`psum_mse`); the metrics follow from
    the local sums and the target's own sum of squares (SNR normalizes both
    sides by the target norm, so it is ``-10*log10(sum_diff2 /
    sum_tgt2)``)."""
    get_metric(metric)
    n_local = float(target.numel())
    tgt_ss = torch.sum(torch.square(target.float()))
    reduce = axis_sum(axes) if axes else None

    def loss_fn(stats, _tgt):
        if reduce is None:
            return stats[0] / n_local
        return _global_mean(reduce, stats[0], n_local)

    key = metric.upper()

    def metric_fn(stats, _tgt):
        if key == "SC":
            return 10 * (torch.log10(stats[0]) - torch.log10(tgt_ss))
        if key == "SNR":
            return -10 * (torch.log10(stats[0]) - torch.log10(tgt_ss))
        return 10 * (torch.log10(stats[1]) - torch.log10(stats[0]))

    return loss_fn, metric_fn


def gate_verbose(verbose) -> bool:
    """Counterpart of the JAX ``gate_verbose``, which turns progress off on
    backends without host callbacks.  The port's loops run on the host, so
    progress can always be reported: ``bool(verbose)``."""
    return bool(verbose)


def _read(value) -> float:
    """A device scalar on the host (on the card: one host sync)."""
    with host_sync(value):
        return float(value)


def _progress_print(i, metric_name, metric_val, loss):
    print(f"iter {int(i) + 1}: {metric_name}={_read(metric_val):.4f} loss={_read(loss):.3e}")


# Selects over a whole state: fori runs' kept copies and returns, and a
# verbose run's per-step freezes.
state_selects = 0


def _pick(keep_live, live, kept):
    if isinstance(live, tuple):
        leaves = (_pick(keep_live, a, b) for a, b in zip(live, kept))
        return type(live)(*leaves) if hasattr(live, "_fields") else tuple(leaves)
    if live is kept:
        return live
    return torch.where(keep_live, live, kept)


def _select(done, live, kept):
    """``live`` unless ``done``, else ``kept``, leaf by leaf over a state of
    (nested) tuples of tensors; each select takes the live leaf's layout.
    A leaf updated in place (the same tensor in both, as the L-BFGS
    history) stays as it is: after a stop, what later steps write there
    reaches only results that the select discards."""
    global state_selects
    state_selects += 1
    return _pick(~done, live, kept)


class _StopRule:
    """The reference's stop rule, carried as device scalars."""

    def __init__(self, tol, like: torch.Tensor):
        # anything but a tensor already there is a blocking copy to the device
        there = isinstance(tol, torch.Tensor) and tol.device == like.device
        with host_sync("cpu" if there else like):
            self.tol = torch.as_tensor(tol, dtype=like.dtype, device=like.device)
        nan = torch.full((), float("nan"), dtype=like.dtype, device=like.device)
        self.prev, self.init = nan, nan
        self.done = torch.zeros((), dtype=torch.bool, device=like.device)

    def stopped(self) -> bool:
        """Whether the rule has fired (read back: one host sync on the card)."""
        with host_sync(self.done):
            return bool(self.done)

    def update(self, l2: torch.Tensor) -> None:
        l2 = l2.to(self.prev.dtype)
        first = torch.isnan(self.init)
        init = torch.where(first, l2, self.init)
        stop = ~first & ((self.prev - l2) / init < self.tol) & (self.prev > l2)
        self.prev, self.init, self.done = l2, init, self.done | stop


def checkpointed(fn):
    """``fn`` recomputed in the backward pass (``torch.utils.checkpoint``)."""
    from torch.utils.checkpoint import checkpoint

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return run


def _real_part(target: torch.Tensor) -> torch.Tensor:
    return target.real if target.is_complex() else target


def iterate(
    step_fn: StepFn,
    state,
    target: torch.Tensor,
    max_iter: int,
    tol,
    eva_iter: int = 10,
    metric: str = "sc",
    verbose: bool = False,
    mode: str = "fori",
    loss_fn: Callable = None,
    early_stop: bool = True,
    remat: bool = False,
):
    """Run ``state, output = step_fn(state)`` for up to ``max_iter`` iterations.

    ``output`` is compared against ``target`` (MSE, or ``loss_fn``) for the
    stop rule.  ``remat=True`` recomputes each step's internals in the
    backward pass (``torch.utils.checkpoint``).  Returns the final state.
    """
    if not (eva_iter > 0 and max_iter > 0):
        raise ValueError("eva_iter and max_iter must be positive")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r} (expected 'fori' or 'while')")
    metric_fn = get_metric(metric)
    if loss_fn is None:
        loss_fn = _mse
    if remat:
        step_fn = checkpointed(step_fn)

    no_eval = not verbose and (
        not early_stop or (isinstance(tol, (int, float)) and tol == 0)
    )
    if no_eval:
        for _ in range(max_iter):
            state, _out = step_fn(state)
        return state

    rule = _StopRule(tol, _real_part(target))
    freeze = verbose and mode == "fori"
    keep = not verbose and mode == "fori"
    kept = None  # the state at the last evaluation before the stop
    for i in range(max_iter):
        new_state, out = step_fn(state)
        state = _select(rule.done, new_state, state) if freeze else new_state
        if i % eva_iter != eva_iter - 1:
            continue
        if keep:
            kept = state if kept is None else _select(rule.done, state, kept)
        l2 = loss_fn(out, target)
        if verbose:
            _progress_print(i, metric, metric_fn(out, target), l2)
        rule.update(l2)  # done is sticky: later updates cannot undo a stop
        if mode == "while" and rule.stopped():
            break
    return _result(rule, state, kept, max_iter % eva_iter > 0)


def _result(rule, live, kept, stepped):
    """A fori run's result: ``live`` where no evaluation ran, ``kept`` where
    no step ran after the last one, else ``live`` unless ``done``."""
    if kept is None:
        return live
    return _select(rule.done, live, kept) if stepped else kept


def iterate_segmented(
    seg_fn: StepFn,
    state,
    target: torch.Tensor,
    max_iter: int,
    tol,
    eva_iter: int,
    tail_fn: Callable = None,
    metric: str = "sc",
    verbose: bool = False,
    loss_fn: Callable = None,
    metric_fn: Callable = None,
    mode: str = "fori",
    remat: bool = False,
):
    """:func:`iterate` for whole-segment steps.

    The stop rule only consults the loss every ``eva_iter`` iterations, so an
    early-stopping run is exactly ``max_iter // eva_iter`` segments of
    ``eva_iter`` iterations (``seg_fn(state) -> (state, out)`` runs one and
    returns the LAST iteration's eval output), then an eval-free tail of
    ``max_iter % eva_iter`` iterations (``tail_fn``), whose result counts
    only if the stop never fired.  ``loss_fn``/``metric_fn`` take ``(out,
    target)``.
    """
    if not (eva_iter > 0 and max_iter > 0):
        raise ValueError("eva_iter and max_iter must be positive")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r} (expected 'fori' or 'while')")
    if metric_fn is None:
        metric_fn = get_metric(metric)
    if loss_fn is None:
        loss_fn = _mse
    if remat:
        seg_fn = checkpointed(seg_fn)
        if tail_fn is not None:
            tail_fn = checkpointed(tail_fn)

    rule = _StopRule(tol, _real_part(target))
    freeze = verbose and mode == "fori"
    keep = not verbose and mode == "fori"
    kept = None  # the state at the last segment before the stop
    for k in range(max_iter // eva_iter):
        new_state, out = seg_fn(state)
        state = _select(rule.done, new_state, state) if freeze else new_state
        if keep:
            kept = state if kept is None else _select(rule.done, state, kept)
        l2 = loss_fn(out, target)
        if verbose:
            _progress_print((k + 1) * eva_iter - 1, metric, metric_fn(out, target), l2)
        rule.update(l2)
        if mode == "while" and rule.stopped():
            return state
    tail = tail_fn is not None and max_iter % eva_iter > 0
    if tail:
        new_state, _ = tail_fn(state)
        state = _select(rule.done, new_state, state) if freeze else new_state
    return _result(rule, state, kept, tail)
