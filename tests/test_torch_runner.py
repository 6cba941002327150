"""The port's iteration runner against specinv_tpu.utils.runner.

Stub steps count themselves in the state and return a scripted loss, so the
final state says exactly which segment (or iteration) the stop rule fired
at and whether the tail ran.  Both modes of both packages must agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specinv_tpu.utils import runner as jrun
from specinv_tpu_torch.utils import runner as trun

LOSSES = {
    "plateau": [10.0, 9.0, 8.9, 8.89, 8.889, 8.8889, 8.8888, 8.8887, 8.8886, 8.8885],
    "rise_then_fall": [10.0, 11.0, 12.0, 5.0, 4.9, 4.89, 4.889, 4.0, 3.0, 2.0],
    "steady": [10.0 * 0.5**k for k in range(10)],
}
TAIL = 100.0  # the tail step adds this, so a run tail shows in the state


def _run_jax_segmented(losses, tol, max_iter, eva_iter, mode):
    table = jnp.asarray(losses + [0.0] * 40)

    def seg(st):
        return st + 1.0, table[st.astype(jnp.int32)]

    def tail(st):
        return st + TAIL, None

    out = jrun.iterate_segmented(
        seg, jnp.asarray(0.0), jnp.zeros(()), max_iter=max_iter, tol=tol,
        eva_iter=eva_iter, tail_fn=tail, loss_fn=lambda o, t: o, mode=mode,
    )
    return float(out)


def _run_torch_segmented(losses, tol, max_iter, eva_iter, mode):
    table = torch.tensor(losses + [0.0] * 40, dtype=torch.float64)

    def seg(st):
        return st + 1.0, table[st.long()]

    def tail(st):
        return st + TAIL, None

    out = trun.iterate_segmented(
        seg, torch.zeros((), dtype=torch.float64), torch.zeros((), dtype=torch.float64),
        max_iter=max_iter, tol=tol, eva_iter=eva_iter, tail_fn=tail,
        loss_fn=lambda o, t: o, mode=mode,
    )
    return float(out)


@pytest.mark.parametrize("case", sorted(LOSSES))
@pytest.mark.parametrize("tol", [0.0, 1e-3, 0.05, 1.0])
@pytest.mark.parametrize("max_iter,eva_iter", [(50, 5), (47, 5), (3, 5)])
@pytest.mark.parametrize("mode", ["fori", "while"])
def test_iterate_segmented_stop_segment(case, tol, max_iter, eva_iter, mode):
    losses = LOSSES[case]
    ref = _run_jax_segmented(losses, tol, max_iter, eva_iter, mode)
    assert _run_torch_segmented(losses, tol, max_iter, eva_iter, mode) == ref
    # the two modes of the port agree with each other as well
    other = "while" if mode == "fori" else "fori"
    assert _run_torch_segmented(losses, tol, max_iter, eva_iter, other) == ref


@pytest.mark.parametrize("case", sorted(LOSSES))
@pytest.mark.parametrize("tol", [0.0, 1e-3, 1.0])
@pytest.mark.parametrize("mode", ["fori", "while"])
def test_iterate_stop_iteration(case, tol, mode):
    losses = LOSSES[case]
    kw = dict(max_iter=20, tol=tol, eva_iter=2, mode=mode, loss_fn=lambda o, t: o)
    jt = jnp.asarray([v for v in losses for _ in range(2)] + [0.0] * 10)
    tt = torch.tensor([v for v in losses for _ in range(2)] + [0.0] * 10, dtype=torch.float64)
    ref = jrun.iterate(lambda st: (st + 1.0, jt[st.astype(jnp.int32)]),
                       jnp.asarray(0.0), jnp.zeros(()), **kw)
    ours = trun.iterate(lambda st: (st + 1.0, tt[st.long()]),
                        torch.zeros((), dtype=torch.float64),
                        torch.zeros((), dtype=torch.float64), **kw)
    assert float(ours) == float(ref)


def test_stats_eval_fns_match_jax():
    rng = np.random.default_rng(0)
    tgt = np.abs(rng.standard_normal((2, 30, 65))).astype(np.float32)
    stats = np.array([12.5, 340.0], np.float32)
    for metric in ("sc", "snr", "ser"):
        jl, jm = jrun.stats_eval_fns(metric, jnp.asarray(tgt))
        tl, tm = trun.stats_eval_fns(metric, torch.from_numpy(tgt))
        s_j, s_t = jnp.asarray(stats), torch.from_numpy(stats)
        assert float(tl(s_t, None)) == pytest.approx(float(jl(s_j, None)), rel=1e-6)
        assert float(tm(s_t, None)) == pytest.approx(float(jm(s_j, None)), rel=1e-6)


def test_bad_arguments_raise():
    """...and mesh axes outside a bound mesh (``parallel.batched`` binds one)."""
    st = torch.zeros(())
    with pytest.raises(ValueError):
        trun.iterate(lambda s: (s, s), st, st, max_iter=3, tol=0.1, mode="scan")
    with pytest.raises(ValueError):
        trun.iterate(lambda s: (s, s), st, st, max_iter=3, tol=0.1, metric="lsd")
    with pytest.raises(ValueError):
        trun.stop_loss_fn(("data",))


def test_mesh_reduced_losses_match_jax_on_one_rank():
    """stop_loss_fn / stats_eval_fns with mesh axes, on the bound 1x1 mesh
    (a sum over one rank) against JAX's under shard_map on one device;
    tests/test_torch_batch.py holds them over 4 ranks."""
    import jax
    from jax.sharding import PartitionSpec as P

    from specinv_tpu.parallel.mesh import make_mesh as jmake_mesh
    from specinv_tpu_torch.parallel import make_mesh
    from specinv_tpu_torch.utils import collective

    rng = np.random.default_rng(2)
    out, tgt = np.abs(rng.standard_normal((2, 2, 7, 9)))
    stats = np.array([3.5, 11.0])

    def body(o, t, s):
        loss_fn, _ = jrun.stats_eval_fns("snr", t, ("data", "seq"))
        return jrun.stop_loss_fn(("data", "seq"))(o, t), loss_fn(s, None)

    ref = jax.shard_map(body, mesh=jmake_mesh(data=1, seq=1), in_specs=(P(), P(), P()),
                        out_specs=(P(), P()), check_vma=False)(
        jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(stats))
    with collective.bound(make_mesh(device="cpu")):
        mse = trun.stop_loss_fn(("data", "seq"))(torch.from_numpy(out), torch.from_numpy(tgt))
        loss_fn, _ = trun.stats_eval_fns("snr", torch.from_numpy(tgt), ("data", "seq"))
        stats_loss = loss_fn(torch.from_numpy(stats), None)
    assert float(mse) == pytest.approx(float(ref[0]), rel=1e-14)
    assert float(stats_loss) == pytest.approx(float(ref[1]), rel=1e-14)


# --- the fori stop freeze against the per-iteration freeze it replaced ----

def _freeze_oracle(done, old, new):
    """The per-iteration freeze the port used before selecting only at
    evaluations: ``where(done, old, new)`` after every step."""
    if isinstance(old, tuple):
        return tuple(_freeze_oracle(done, o, n) for o, n in zip(old, new))
    return torch.where(done, old, new)


def _oracle_iterate(step_fn, state, target, max_iter, tol, eva_iter, loss_fn, verbose=False):
    rule = trun._StopRule(tol, target)
    for i in range(max_iter):
        new_state, out = step_fn(state)
        state = _freeze_oracle(rule.done, state, new_state)
        if i % eva_iter != eva_iter - 1:
            continue
        l2 = loss_fn(out, target)
        if verbose:
            sc = trun.get_metric("sc")(out, target)
            print(f"iter {i + 1}: sc={float(sc):.4f} loss={float(l2):.3e}")
        rule.update(l2)
    return state


def _oracle_segmented(seg_fn, state, target, max_iter, tol, eva_iter, tail_fn, loss_fn,
                      verbose=False):
    rule = trun._StopRule(tol, target)
    for k in range(max_iter // eva_iter):
        new_state, out = seg_fn(state)
        l2 = loss_fn(out, target)
        if verbose:
            sc = trun.get_metric("sc")(out, target)
            print(f"iter {(k + 1) * eva_iter}: sc={float(sc):.4f} loss={float(l2):.3e}")
        state = _freeze_oracle(rule.done, state, new_state)
        rule.update(l2)
    if tail_fn is not None and max_iter % eva_iter:
        new_state, _ = tail_fn(state)
        state = _freeze_oracle(rule.done, state, new_state)
    return state


def _eval_losses(n_evals, stop_at):
    """Losses per evaluation that halve (no stop at tol 1e-3) until the
    evaluation ``stop_at`` (1-based), which barely improves: the stop fires
    there and nowhere else (None: nowhere)."""
    losses, prev = [], 10.0
    for j in range(1, n_evals + 1):
        prev = prev * (1 - 1e-6) if j == stop_at else prev * 0.5
        losses.append(prev)
    return losses


class _Stub:
    """A step over ``(count, plane)``: ``count`` (contiguous) counts the steps
    the live state took, ``plane`` starts as a transposed view and every
    step writes it contiguous, as the kernel launches allocate their
    outputs.  Each step's output is ``loss * [1, 0.5, 0.5]``, the loss
    scripted by the count; past count ``nan_after`` the plane and the
    output are NaN.  Records each leaf's strides as handed to the step."""

    def __init__(self, table, nan_after=None):
        self.table = torch.tensor(table + [1.0] * 200, dtype=torch.float64)
        self.nan_after, self.seen = nan_after, []

    def __call__(self, state, by=1.0):
        count, plane = state
        self.seen.append(tuple(leaf.stride() for leaf in state))
        count = count + by
        plane = (plane * 0.5 + count[0, 0]).contiguous()
        out = self.table[count[0, 0].long()] * torch.tensor([1.0, 0.5, 0.5], dtype=torch.float64)
        if self.nan_after is not None and count[0, 0] > self.nan_after:
            plane, out = torch.full_like(plane, float("nan")), torch.full_like(out, float("nan"))
        return (count, plane), out

    @staticmethod
    def state0():
        count = torch.zeros((2, 3), dtype=torch.float64)
        plane = torch.arange(20, dtype=torch.float64).reshape(5, 4).t()  # transposed
        return count, plane


def _first_loss(o, _t):
    return o[0]


TARGET = torch.full((3,), 0.5, dtype=torch.float64)
# (max_iter, eva_iter): whole evaluations, a tail after the last one, and
# fewer iterations than one evaluation needs
SHAPES = [(20, 5), (23, 5), (3, 5)]
STOP_CASES = [(m, e, s) for m, e in SHAPES for s in [None, *range(2, m // e + 1)]]


def _run(driver, stub, max_iter, eva_iter, oracle=False):
    """The port's driver (or the oracle) over the stub; for the segmented
    driver one stub step is one segment and the tail adds TAIL."""
    kw = dict(max_iter=max_iter, tol=1e-3, eva_iter=eva_iter, loss_fn=_first_loss)
    if driver == "iterate":
        if oracle:
            return _oracle_iterate(stub, stub.state0(), TARGET, **kw)
        return trun.iterate(stub, stub.state0(), TARGET, mode="fori", **kw)
    tail = lambda st: stub(st, by=TAIL)  # noqa: E731
    if oracle:
        return _oracle_segmented(stub, stub.state0(), TARGET, tail_fn=tail, **kw)
    return trun.iterate_segmented(stub, stub.state0(), TARGET, tail_fn=tail, mode="fori", **kw)


def _table(driver, max_iter, eva_iter, stop_at):
    """The loss of each stub count: for ``iterate`` the evaluation that
    count ``c`` ends reads ``table[c]``, for the segmented driver segment
    ``k`` reads ``table[k]``."""
    losses = _eval_losses(max(max_iter // eva_iter, 1), stop_at)
    if driver == "iterate":
        return [0.0] + [losses[c // eva_iter - 1] if c % eva_iter == 0 else 0.0
                        for c in range(1, max_iter + 1)]
    return [0.0] + losses


def _bits_equal(a, b):
    return all(x.shape == y.shape and torch.equal(x.view(torch.int64), y.view(torch.int64))
               for x, y in zip(a, b))


@pytest.mark.parametrize("driver", ["iterate", "segmented"])
@pytest.mark.parametrize("max_iter,eva_iter,stop_at", STOP_CASES)
def test_fori_selects_only_at_evaluations(driver, max_iter, eva_iter, stop_at):
    """The fori result is the per-iteration freeze's, bit for bit, whether
    the stop fires at any evaluation, at none, before any evaluation or
    before a tail; every step after the first gets the state as the step
    wrote it (never a select's layout); the run makes at most one select
    per evaluation plus one; and a live state that turns to NaN after the
    stop leaves the result as it is."""
    table = _table(driver, max_iter, eva_iter, stop_at)
    ref = _run(driver, _Stub(table), max_iter, eva_iter, oracle=True)

    stub = _Stub(table)
    before = trun.state_selects
    ours = _run(driver, stub, max_iter, eva_iter)
    assert trun.state_selects - before <= max_iter // eva_iter + 1
    assert _bits_equal(ours, ref)
    assert all(strides == ((3, 1), (5, 1)) for strides in stub.seen[1:])
    assert stub.seen[0] == ((3, 1), (1, 4))

    if stop_at is not None:
        # the stop fires at the evaluation that ends count stop_at * eva_iter
        # (iterate) or segment stop_at (segmented): NaN from the next step on
        last = stop_at * eva_iter if driver == "iterate" else stop_at
        poisoned = _run(driver, _Stub(table, nan_after=last), max_iter, eva_iter)
        assert _bits_equal(poisoned, ref)


@pytest.mark.parametrize("driver", ["iterate", "segmented"])
def test_fori_verbose_prints_the_frozen_state(driver, capsys):
    """A verbose fori run keeps the per-iteration freeze: after the stop its
    lines read the frozen state's metric, as before, and its result is the
    oracle's."""
    max_iter, eva_iter, stop_at = 23, 5, 2
    table = _table(driver, max_iter, eva_iter, stop_at)
    kw = dict(max_iter=max_iter, tol=1e-3, eva_iter=eva_iter, loss_fn=_first_loss)
    stub = _Stub(table)
    if driver == "iterate":
        ref = _oracle_iterate(stub, stub.state0(), TARGET, verbose=True, **kw)
        want = capsys.readouterr().out
        ours = trun.iterate(stub, stub.state0(), TARGET, mode="fori", verbose=True, **kw)
    else:
        tail = lambda st: stub(st, by=TAIL)  # noqa: E731
        ref = _oracle_segmented(stub, stub.state0(), TARGET, tail_fn=tail, verbose=True, **kw)
        want = capsys.readouterr().out
        ours = trun.iterate_segmented(stub, stub.state0(), TARGET, tail_fn=tail, mode="fori",
                                      verbose=True, **kw)
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == max_iter // eva_iter
    # the lines after the stop repeat the stopping state's next output
    lines = [line.split(": ", 1)[1] for line in got.splitlines()]
    assert len(set(lines[stop_at:])) == 1 and lines[stop_at] != lines[stop_at - 1]
    assert _bits_equal(ours, ref)
