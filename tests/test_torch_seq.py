"""The port's sequence-parallel path and its raw kernel dispatch, on the CPU.

* The raw per-iteration dispatch (``gl_fullrun.fused_gl_iteration`` /
  ``admm_fullrun.fused_admm_iteration``, the port of K4 ``gl_fused4._kernel``
  and K6 ``admm_fused4._kernel_iter`` with ``normalize=False``) runs its
  plain version on CPU tensors; it is held against the JAX kernels in
  Pallas interpret mode at precision=HIGHEST on the same state carried
  across by ``convert.state_from_jax``, n_fft 256 / hop 128 (128 divides
  both, as ``gl_fused4.supports`` needs), one iteration, ``valid_t`` of
  all, all but 3, and 0 frames.
* ``griffin_lim_seq`` / ``admm_seq`` over 2 gloo CPU processes
  (``tests/torch_dist_worker.py``, one spawn; 4 processes in
  ``test_torch_seq_four.py``) against the JAX functions on a CPU mesh of
  the same shape (the 8 virtual devices of ``tests/conftest.py``), the
  cases of ``tests/test_sharding.py``; at world size 1 in-process against a
  1-device JAX mesh.  Each is also held against the port's unsharded call.

Gradients (the ``grad`` cases of the spawn jobs, and in-process at world
size 1): each rank's d mean((y - x)^2) / d spec, held against ``jax.grad``
of JAX's seq function on a mesh of the same shape, and every rank's equal
(``run_job``).  The float64 ``'fft'`` gradients at the cross-package band,
1e-9 of the max (a complex input's: against the conjugate of JAX's, its
convention).  The float32 cases at 5e-2 of the max, JAX's band between its
own ``'pallas4'`` and ``'fft'`` gradients (``test_sharding.py``): across the
packages the float32 SPSI seed's phase sums round differently, and the
gradient carries that (1.2e-2 of the max for GL, 4.0e-2 for ADMM, the
``'fft'`` path as far as ``'kernel'``).  The port's ``'kernel'`` against
its ``'fft'`` gradient at that band too, and ``remat=True`` against
``remat=False`` at JAX's 1e-7 of the max.

Tolerances (:func:`_bands`).  Against the port's unsharded call, the JAX
package's own bands for its seq path: atol 1e-10 in float64 (1e-8 for ADMM
with early stopping), 1e-4 of the max for float32 and 5e-3 for the kernel.
Against JAX's seq path, the port's cross-package bands: 1e-9 of the max in
float64 (summation order), 1e-5 for ADMM with early stopping and 5e-3 in
float32, where both packages start from the same complex seed.  The raw
dispatch after one iteration: x within 5e-5 of its max (the JAX package's
HIGHEST-vs-XLA band), the state and magnitude planes within 1e-4 of their
max, the eval sums rtol 1e-5 (``test_torch_gl_fullrun.py``'s bands).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specinv_tpu.config import canonicalize as jcanon
from specinv_tpu.ops.pallas import admm_fused4, fft4, gl_fused4
from specinv_tpu.parallel import mesh as jmesh
from specinv_tpu.parallel import seq as jseq
import specinv_tpu_torch as st
from specinv_tpu_torch import convert
from specinv_tpu_torch.config import canonicalize as tcanon
from specinv_tpu_torch.ops.cuda import admm_fullrun, gl_fullrun
from specinv_tpu_torch.parallel import admm_seq, griffin_lim_seq, make_mesh
from specinv_tpu_torch.parallel import seq as tseq

from . import torch_dist_worker as worker

N_FFT, HOP, B, T, BLOCK_T = 256, 128, 2, 24, 8
X_REL, PLANE_ABS, SUM_REL = 5e-5, 1e-4, 1e-5


def _raw_state():
    """A random signal, Hermitian state and target at T frames (t_pad = T,
    so the JAX kernel sees no padded rows)."""
    rng = np.random.default_rng(3)
    win = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    jc, w = jcanon(N_FFT // 2 + 1, np.float32, window=win, hop_length=HOP)
    tc, _ = tcanon(N_FFT // 2 + 1, np.float32, window=win, hop_length=HOP)
    lp = (T - 1) * HOP + N_FFT
    x = rng.standard_normal((B, lp)).astype(np.float32)
    mag = np.abs(rng.standard_normal((B, T, N_FFT // 2 + 1))).astype(np.float32)
    state = (mag * np.exp(1j * rng.uniform(0, 2 * np.pi, mag.shape))).astype(np.complex64)
    full = fft4.extend_hermitian_spec(jnp.asarray(state), N_FFT)
    st_re, st_im = (fft4.to_permuted(p, N_FFT) for p in (full.real, full.imag))
    tgt_p = fft4.to_permuted(fft4.extend_hermitian_mag(jnp.asarray(mag), N_FFT), N_FFT)
    return jc, tc, w, x, st_re, st_im, tgt_p


def _close(ours, ref, band):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=band * np.abs(ref).max())


@pytest.mark.parametrize("algo,valid_t", [
    ("gl", None), ("gl", T - 3), ("gl", 0), ("admm", T), ("admm", T - 3), ("admm", 0),
])
def test_raw_dispatch_matches_jax_kernel(algo, valid_t):
    jc, tc, w, x, st_re, st_im, tgt_p = _raw_state()
    ones = jnp.ones((x.shape[-1],), jnp.float32)
    kw = dict(e=0, block_t=BLOCK_T, interpret=True, precision=jax.lax.Precision.HIGHEST,
              normalize=False)
    if algo == "admm":
        jx, jmag, jre, jim = admm_fused4.fused_admm_iteration4(
            jnp.asarray(x), st_re, st_im, tgt_p, jnp.asarray(w), ones, jnp.float32(0.1), jc,
            valid_t=valid_t, **kw)
        fn, scalar = admm_fullrun.fused_admm_iteration, 0.1
    else:
        jx, jmag, jre, jim = gl_fused4.fused_gl_iteration4(
            jnp.asarray(x), st_re, st_im, tgt_p, jnp.asarray(w), ones, jnp.float32(0.5), jc,
            with_mag=True, **kw)
        fn, scalar = gl_fullrun.fused_gl_iteration, 0.5
    x_t, st_t, tgt_t = convert.state_from_jax(x, st_re, st_im, tgt_p, N_FFT, T)
    before = (gl_fullrun.iteration_launches, admm_fullrun.iteration_launches)
    ox, ost, omag, ostats = fn(
        torch.from_numpy(x_t), torch.from_numpy(st_t), torch.from_numpy(tgt_t),
        torch.from_numpy(w), scalar, tc, with_mag=True, with_loss=True, valid_t=valid_t)
    # the CPU path is the plain version: no launch is counted
    assert (gl_fullrun.iteration_launches, admm_fullrun.iteration_launches) == before
    _close(ox.numpy(), np.asarray(jx), X_REL)
    _, ref_st, _ = convert.state_from_jax(jx, jre, jim, tgt_p, N_FFT, T)
    _close(ost.numpy().real, ref_st.real, PLANE_ABS)
    _close(ost.numpy().imag, ref_st.imag, PLANE_ABS)
    ref_mag = convert.from_permuted(np.asarray(jmag), N_FFT)[:, :T, : N_FFT // 2 + 1]
    _close(omag.numpy(), ref_mag, PLANE_ABS)
    v = T if valid_t is None else valid_t
    d = (ref_mag - tgt_t)[:, :v].astype(np.float64)
    ref_sums = np.array([np.sum(d * d), np.sum(ref_mag[:, :v].astype(np.float64) ** 2)])
    np.testing.assert_allclose(ostats.numpy(), ref_sums, rtol=SUM_REL, atol=1e-30)
    if algo == "admm" and valid_t == 0:  # a shard of padding rows: Y stays zero
        assert not ost.abs().any()


def test_raw_dispatch_geometry_and_normalized_form():
    """The raw dispatch leaves the raw overlap-add, which times the envelope
    and re-padded is one whole-run iteration, and the same state (float64,
    plain versions)."""
    from specinv_tpu_torch.ops import twins

    _, tc, w, x, st_re, st_im, tgt_p = _raw_state()
    x_t, st_t, tgt_t = (torch.from_numpy(a) for a in
                        convert.state_from_jax(x, st_re, st_im, tgt_p, N_FFT, T))
    x_t, st_t, tgt_t = x_t.double(), st_t.to(torch.complex128), tgt_t.double()
    win = torch.from_numpy(w).double()
    geo = twins.make_geometry(tc, T)
    inv_env = twins.make_inv_env(tc, win, T, geo)
    for mod, run, it in ((gl_fullrun, "fused_gl_run", "fused_gl_iteration"),
                         (admm_fullrun, "fused_admm_run", "fused_admm_iteration")):
        whole_x, whole_st = getattr(mod, run)(x_t, st_t, tgt_t, win, inv_env, 0.3, tc, 1,
                                              emit_state=True)
        rx, rst = getattr(mod, it)(x_t, st_t, tgt_t, win, 0.3, tc)
        assert rx.shape == x_t.shape and torch.equal(rst, whole_st)
        torch.testing.assert_close(twins.repad_edges(rx * inv_env, tc, geo), whole_x,
                                   rtol=0, atol=1e-12)
        with pytest.raises(ValueError, match="valid_t"):
            getattr(mod, it)(x_t, st_t, tgt_t, win, 0.3, tc, valid_t=T + 1)


# --- the sequence-parallel entry points --------------------------------------


GRAD_F32_BAND = 5e-2
REMAT_BAND = 1e-7


def _jax_seq(case, world):
    """JAX's seq path on the case: the waveform, or for a ``grad`` case the
    gradient in torch's convention."""
    data, seq = case.get("mesh", (1, world))
    mesh = jmesh.make_mesh(data=data, seq=seq)
    fn = jseq.admm_seq if case["algo"] == "admm" else jseq.griffin_lim_seq
    kw = worker.call_kwargs(case)
    if kw.get("backend") == "kernel":
        kw["backend"] = "pallas4"
    spec = worker.case_spec(case)
    if not case.get("grad"):
        return np.asarray(fn(spec, mesh, **kw))
    x = worker.case_signal(case)
    grad = jax.grad(lambda s: worker.grad_loss(fn(s, mesh, **kw), x))(jnp.asarray(spec))
    # for a complex input jax.grad gives the conjugate of torch's .grad
    return np.conj(np.asarray(grad))


def _unsharded(case):
    """The port's unsharded entry point on the case's input."""
    kw = worker.call_kwargs(case)
    kw.pop("shard_batch_axis", None)
    kw.setdefault("tol", 0.0)
    fn = st.ADMM if case["algo"] == "admm" else st.griffin_lim
    return fn(torch.from_numpy(worker.case_spec(case)), verbose=False, **kw).numpy()


def _bands(name, case, ref):
    """``(against JAX's seq, against the port's unsharded call)``, absolute."""
    scale = np.abs(ref).max()
    if case.get("f32"):
        # JAX's bands for its seq path against its unsharded one: 5e-3 of the
        # max for the kernel, 1e-4 for the fft path; across the packages the
        # float32 rounding of two FFT implementations grows over the
        # iterations (2.7e-3 of the max after 60 at the moderate tol)
        own = 5e-3 if case["call"].get("backend") == "kernel" else 1e-4
        return 5e-3 * scale, own * scale
    if name.startswith("admm_early_stop"):
        # ADMM's dual integrates rounding: the packages' unsharded ADMM lie
        # 4.1e-6 of the max apart on this input after 30 iterations
        return 1e-5 * scale, 1e-8
    return 1e-9 * scale, 1e-10


def check_case(results, name, case, world):
    """Rank 0's output of a spawned case against JAX's seq path on a mesh of
    the same shape, and against the port's unsharded call."""
    if case.get("error"):
        with pytest.raises(ValueError) as err:
            _jax_seq(case, world)
        assert str(results[name]) == str(err.value)
        return
    ref = _jax_seq(case, world)
    out = results[name]
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if case.get("grad"):
        band = GRAD_F32_BAND if case.get("f32") else 1e-9
        np.testing.assert_allclose(out, ref, rtol=0, atol=band * np.abs(ref).max())
        return
    cross, own = _bands(name, case, ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=cross)
    np.testing.assert_allclose(out, _unsharded(case), rtol=0, atol=own)


@pytest.fixture(scope="module")
def seq2(tmp_path_factory):
    return worker.run_job("seq", 2, tmp_path_factory.mktemp("seq2"))


@pytest.mark.parametrize("name", list(worker.SEQ_JOBS[2]))
def test_seq_two_ranks_match_jax(seq2, name):
    check_case(seq2, name, worker.SEQ_JOBS[2][name], 2)


def check_close(out, ref, band):
    np.testing.assert_allclose(out, ref, rtol=0, atol=band * np.abs(ref).max())


@pytest.mark.parametrize("algo", ["gl", "admm"])
def test_seq_kernel_gradients_match_fft(seq2, algo):
    """The raw dispatch's gradient (its plain twin replayed) against the
    fft path's, at test_sharding.py's geometry and band: the twin's
    sqrt(re^2 + im^2 + 1e-30) magnitude against abs (read 4.4e-6 / 1.3e-5)."""
    assert np.isfinite(seq2[f"{algo}_grad_kernel"]).all()
    check_close(seq2[f"{algo}_grad_kernel"], seq2[f"{algo}_grad_fft"], GRAD_F32_BAND)


@pytest.mark.parametrize("algo,backend", [
    ("gl", "fft"), ("gl", "kernel"), ("admm", "fft"), ("admm", "kernel"),
])
def test_seq_remat_gradients_match_two_ranks(seq2, algo, backend):
    """remat=True recomputes each iteration, exchanges included, in the
    backward pass: the same gradient as remat=False (read bit for bit)."""
    check_close(seq2[f"{algo}_grad_{backend}_remat"], seq2[f"{algo}_grad_{backend}"],
                REMAT_BAND)


WORLD1 = {
    "gl_hann": dict(algo="gl", stft=dict(hann=True), call=dict(max_iter=8)),
    "admm_circular": dict(algo="admm", speech=True, stft=dict(pad_mode="circular"),
                          call=dict(max_iter=8)),
    "gl_early_stop": dict(algo="gl", call=dict(max_iter=30, tol=1.0, eva_iter=5)),
    "gl_kernel": dict(algo="gl", f32=True, seeded=True, stft=dict(hop_length=128),
                      call=dict(max_iter=6, backend="kernel")),
    "gl_grad": worker.SEQ_JOBS[2]["gl_grad"],
    "admm_grad": worker.SEQ_JOBS[2]["admm_grad"],
    "gl_grad_tol": worker.SEQ_JOBS[2]["gl_grad_tol"],
}


def _world_one(case):
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "seq": 1}
    return worker.run_case(admm_seq if case["algo"] == "admm" else griffin_lim_seq, case,
                           mesh=mesh)


@pytest.mark.parametrize("name", list(WORLD1))
def test_seq_world_one_matches_jax(name):
    """No process group: make_mesh() is the 1x1 mesh, run in-process."""
    check_case({name: _world_one(WORLD1[name])}, name, WORLD1[name], 1)


@pytest.mark.parametrize("algo,backend", [("gl", "fft"), ("gl", "kernel"), ("admm", "kernel")])
def test_seq_remat_gradients_match_world_one(algo, backend):
    """test_sharding.py's remat cases at world size 1: 4 iterations, float32."""
    case = dict(worker.SEQ_JOBS[2][f"{algo}_grad_{backend}"])
    case["call"] = dict(case["call"], max_iter=4)
    ref = _world_one(case)
    case["call"] = dict(case["call"], remat=True)
    out = _world_one(case)
    assert np.isfinite(out).all()
    check_close(out, ref, REMAT_BAND)


@pytest.mark.parametrize("n_fft,hop,T,n", [
    (512, 128, 173, 2), (512, 128, 173, 4), (512, 128, 16, 4), (512, 128, 16, 8),
    (256, 64, 40, 2), (400, 160, 90, 3), (512, 512, 20, 2),
])
@pytest.mark.parametrize("center", [True, False])
def test_geometry_matches_jax(n_fft, hop, T, n, center):
    kw = dict(hop_length=hop, center=center)
    jc, _ = jcanon(n_fft // 2 + 1, np.float64, **kw)
    tc, _ = tcanon(n_fft // 2 + 1, np.float64, **kw)
    try:
        ref = jseq._geometry(jc, T, n)
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            tseq._geometry(tc, T, n)
        assert str(ours.value) == str(err)
        return
    assert tseq._geometry(tc, T, n) == ref


def test_seq_backend_rejections():
    spec = torch.from_numpy(worker.stft_mag(worker.signal(4410, dtype=np.float32), 256))
    mesh = make_mesh(device="cpu")
    for fn in (griffin_lim_seq, admm_seq):
        for backend in ("pallas", "nccl"):
            with pytest.raises(ValueError, match="not supported"):
                fn(spec, mesh, max_iter=2, backend=backend)
        with pytest.raises(ValueError, match="'kernel'"):
            fn(spec, mesh, max_iter=2, backend="pallas4")
    # the kernel needs a power-of-two n_fft
    odd = torch.from_numpy(worker.stft_mag(worker.signal(4410, dtype=np.float32), 400))
    with pytest.raises(ValueError, match="power of two"):
        griffin_lim_seq(odd, mesh, max_iter=2, backend="kernel")


@pytest.mark.parametrize("backend", ["matmul", "matmul4"])
def test_xla_dft_backends_name_the_ports_counterpart(backend):
    """griffin_lim_seq / admm_seq: JAX's seq path runs the XLA lowering, the
    port raises naming 'fft'."""
    spec = worker.stft_mag(worker.signal(4410, dtype=np.float32), 256)
    jmesh_1 = jmesh.make_mesh(data=1, seq=1)
    mesh = make_mesh(device="cpu")
    for jfn, fn in ((jseq.griffin_lim_seq, griffin_lim_seq), (jseq.admm_seq, admm_seq)):
        assert np.isfinite(np.asarray(jfn(spec, jmesh_1, max_iter=2, backend=backend))).all()
        with pytest.raises(ValueError, match="the port's counterpart is 'fft'"):
            fn(torch.from_numpy(spec), mesh, max_iter=2, backend=backend)
