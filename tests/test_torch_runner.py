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
