"""``parallel.batched`` and ``make_mesh`` of the port against the JAX package.

One spawn of 4 gloo CPU processes (``tests/torch_dist_worker.py``) runs
every case of ``BATCH_JOB`` on a 4x1 mesh; rank 0's waveforms are held
against JAX's ``batched`` on a 4-device CPU mesh (the virtual devices of
``tests/conftest.py``) and, where ``tests/test_sharding.py`` holds JAX's to
it, against the unsharded call: Griffin-Lim, ADMM, RTISI-LA, the kernel
backend, uneven batches, per-shard and global early stopping, and
``gspmd=True``.  The same spawn reads ``make_mesh``'s shapes and errors and
the mesh-reduced stop losses (``utils/runner.stop_loss_fn`` /
``stats_eval_fns`` with axes) over the 4 ranks, held against JAX's under
``shard_map``.

Tolerances: float64 at the port's cross-package band, 1e-9 of the max
(summation order; ADMM runs on speech-like clips), 1e-5 for ADMM with early
stopping (its dual integrates rounding: the packages' unsharded ADMM lie
4e-6 of the max apart after 30-60 iterations), and JAX's own atol 1e-10
against the port's unsharded call; the kernel backend (float32, both
packages from the same complex seed, JAX at precision=HIGHEST) at 5e-5 of
the max, the JAX package's HIGHEST band (``test_torch_griffin_lim.py``), and bit for bit against the
port's unsharded kernel call; RTISI-LA over 12 frames, as
``test_torch_rtisi_la.py`` (it doubles a rounding difference per frame);
the stop losses at rtol 1e-12.

Gradients (the job's ``grad`` cases, float64): ``batched(griffin_lim |
ADMM | RTISI_LA)``'s d mean((y - x)^2) / d spec on every rank, held against
the port's unsharded call's within 1e-12 of the max, an uneven batch
included (not bit for bit: the ranks transform 2 clips where the unsharded
call transforms the whole batch; read 4.8e-15 at most).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu.parallel.batch import batched as jbatched
from specinv_tpu.parallel.mesh import batch_sharding as jbatch_sharding
from specinv_tpu.parallel.mesh import make_mesh as jmake_mesh
from specinv_tpu.utils import runner as jrunner
from specinv_tpu_torch.parallel import batch_sharding, batched, make_mesh, shard_batch
from specinv_tpu_torch.utils import collective
from specinv_tpu_torch.utils import runner as trunner

from . import torch_dist_worker as worker

JAX_FN = {"gl": si.griffin_lim, "admm": si.ADMM, "rtisi": si.RTISI_LA}
PORT_FN = {"gl": st.griffin_lim, "admm": st.ADMM, "rtisi": st.RTISI_LA}
# cases whose per-shard result the JAX suite holds to the unsharded call
# (a per-shard stop without global_stop may differ from it)
UNSHARDED_EQUAL = {name for name in worker.BATCH_JOB if name != "uneven_early_stop"}
GRAD_CASES = [name for name, case in worker.BATCH_JOB.items() if case.get("grad")]


@pytest.fixture(scope="module")
def batch4(tmp_path_factory):
    return worker.run_job("batch", 4, tmp_path_factory.mktemp("batch4"))


def _jax_batched(case):
    kw = worker.call_kwargs(case)
    if kw.get("backend") == "kernel":  # the port's kernel computes in float32
        kw.update(backend="pallas4", precision=jax.lax.Precision.HIGHEST)
    wrapped = jbatched(JAX_FN[case["fn"]], jmake_mesh(data=4, seq=1),
                       gspmd=case.get("gspmd", False),
                       global_stop=case.get("global_stop", False))
    return np.asarray(wrapped(worker.case_spec(case), **kw))


@pytest.mark.parametrize("name", [n for n, c in worker.BATCH_JOB.items()
                                  if c["fn"] in JAX_FN and not c.get("grad")])
def test_batched_four_ranks_match_jax(batch4, name):
    case = worker.BATCH_JOB[name]
    out, ref = batch4[name], _jax_batched(case)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    kernel = case["call"].get("backend") == "kernel"
    band = 5e-5 if kernel else (1e-5 if case["fn"] == "admm" and case["call"]["tol"] else 1e-9)
    np.testing.assert_allclose(out, ref, rtol=0, atol=band * np.abs(ref).max())
    if name in UNSHARDED_EQUAL:
        whole = PORT_FN[case["fn"]](torch.from_numpy(worker.case_spec(case)),
                                    **worker.call_kwargs(case)).numpy()
        np.testing.assert_allclose(out, whole, rtol=0, atol=0 if kernel else 1e-10)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_batched_gradients_match_unsharded_calls(batch4, name):
    case = worker.BATCH_JOB[name]
    out, ref = batch4[name], worker.run_case(PORT_FN[case["fn"]], case)
    assert out.shape == ref.shape == worker.case_spec(case).shape
    assert np.isfinite(out).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("name", worker.MEL_FNS)
def test_batched_mel_paths_match_unsharded_calls(batch4, name):
    """dp L-BFGS and dp mel_to_audio as ``__graft_entry__.dryrun_multichip``
    runs them (per-rank log-mel targets, ``samples`` the shape inside a
    shard): each rank's rows bit for bit the port's call on its 2 clips (one
    thread, as the ranks run), mel_to_audio's clips also one at a time
    within 1e-10 and against the JAX package's batched call at 1e-9 of the
    max.  L-BFGS optimizes a rank's clips jointly, and its default start is
    the port's own draw (not JAX's), so it is held to the per-rank calls."""
    case = worker.BATCH_JOB[name]
    out = batch4[name]
    per_rank = case["batch"] // 4
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = np.concatenate([worker.mel_call(case, rows=slice(r * per_rank, (r + 1) * per_rank))
                              .numpy() for r in range(4)])
    finally:
        torch.set_num_threads(threads)
    assert out.shape == ref.shape == (case["batch"], worker.MEL_SAMPLES)
    np.testing.assert_array_equal(out, ref)
    if name == "mel_to_audio":
        clips = np.stack([worker.mel_call(case, rows=i).numpy() for i in range(case["batch"])])
        np.testing.assert_allclose(out, clips, rtol=0, atol=1e-10)
        _, logmel = worker.mel_inputs(case["batch"])
        mel_pow = np.exp(logmel.numpy()) - 1e-6
        jref = np.asarray(jbatched(si.mel_to_audio, jmake_mesh(data=4, seq=1))(
            mel_pow, worker.MEL_N_FFT, worker.MEL_SR, **case["call"]))
        np.testing.assert_allclose(out, jref, rtol=0, atol=1e-9 * np.abs(jref).max())
    else:
        assert np.abs(out).max() > 1e-4  # it moved from the 1e-6 start


def test_make_mesh_over_four_ranks(batch4):
    assert list(batch4["shape_2x2"]) == [2, 2]
    assert list(batch4["shape_default"]) == [4, 1]
    # the JAX package's errors, worded for ranks
    assert str(batch4["err_too_big"]) == "mesh 8x1 needs 8 ranks, have 4"
    assert str(batch4["err_indivisible"]) == "4 ranks not divisible by seq=3"


def test_stop_losses_over_four_ranks_match_jax(batch4):
    out, tgt, stats = worker.loss_inputs()
    mesh = jmake_mesh(data=4, seq=1)

    def body(o, t, s):
        loss_fn, _ = jrunner.stats_eval_fns("sc", t, ("data",))
        return jrunner.stop_loss_fn(("data",))(o, t)[None], loss_fn(s[0], None)[None]

    ref_mse, ref_stats = jax.shard_map(
        body, mesh=mesh, in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False,
    )(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(stats))
    np.testing.assert_allclose(batch4["psum_mse"], np.asarray(ref_mse)[0], rtol=1e-12)
    # JAX counts the elements in float32 (jnp.float32(target.size))
    np.testing.assert_allclose(batch4["stats_loss"], np.asarray(ref_stats)[0], rtol=1e-12)


# --- in one process: the 1x1 mesh -------------------------------------------


def test_make_mesh_world_one_and_its_errors():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "seq": 1} and mesh.coord == (0, 0)
    assert mesh.group("data") is None and mesh.group("seq") is None
    with pytest.raises(ValueError, match="needs 16 ranks"):
        make_mesh(data=16, seq=1, device="cpu")
    with pytest.raises(ValueError, match="not divisible by seq=3"):
        make_mesh(seq=3, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.index("model")


def test_default_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="device='cpu'"):
        make_mesh()


def test_shard_batch_is_this_ranks_slice():
    mesh = make_mesh(device="cpu")
    x = torch.arange(16.0).reshape(16, 1)
    assert batch_sharding(mesh, batch=16) == slice(0, 16)
    assert torch.equal(shard_batch(x, mesh), x)


def test_batched_rejects_2d():
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="rank 2"):
        batched(st.griffin_lim, mesh)(torch.ones((257, 40), dtype=torch.float64))


def test_batched_global_stop_rejects_unsupported_fn():
    mesh = make_mesh(device="cpu")

    def no_psum_entry(spec, **kwargs):  # pragma: no cover - never called
        return spec

    with pytest.raises(ValueError, match="loss_psum_axes"):
        batched(no_psum_entry, mesh, global_stop=True)


def test_loss_psum_axes_needs_a_bound_mesh():
    spec = torch.from_numpy(worker.stft_mag(worker.signal(4000), 256))
    with pytest.raises(ValueError, match="bound mesh"):
        st.griffin_lim(spec, max_iter=2, verbose=False, loss_psum_axes=("data",))
    with pytest.raises(ValueError, match="bound mesh"):
        trunner.stop_loss_fn(("data",))
    # inside batched the axis resolves; on the 1x1 mesh the sum is the
    # local loss, so the run equals the unsharded one
    mesh = make_mesh(device="cpu")
    kw = dict(max_iter=20, tol=1e-2, eva_iter=5, verbose=False)
    ours = batched(st.griffin_lim, mesh, global_stop=True)(spec[None], **kw)
    torch.testing.assert_close(ours[0], st.griffin_lim(spec, **kw), rtol=0, atol=0)
    with collective.bound(mesh), pytest.raises(ValueError, match="unknown mesh axis"):
        trunner.stop_loss_fn(("model",))


def test_batch_sharding_refuses_the_jax_call_shape():
    """JAX's ``batch_sharding(mesh, ndim)`` returns a sharding; the port's
    takes ``batch=`` and refuses a positional second argument (it would read
    the rank as a batch size)."""
    assert jbatch_sharding(jmake_mesh(data=4, seq=1), 2).spec == P("data", None)
    mesh = make_mesh(device="cpu")
    with pytest.raises(TypeError, match="batch="):
        batch_sharding(mesh, 2)
    with pytest.raises(TypeError, match="batch="):
        batch_sharding(mesh, 2, "data")
    with pytest.raises(TypeError, match="batch="):
        batch_sharding(mesh)
    assert batch_sharding(mesh, batch=4, axis_name="data") == slice(0, 4)
