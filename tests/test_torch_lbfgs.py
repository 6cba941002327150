"""The port's L-BFGS against the JAX package's and ``torch.optim.LBFGS``.

* Fixed step: the trajectories on ``tests/test_lbfgs.py``'s power-spectrum
  pair (non-overlapping frames, a DFT through shared numpy matrices, smooth
  everywhere), over its five kwarg cases and both directions, against
  ``specinv_tpu.L_BFGS`` at ``rtol=1e-6, atol=1e-8`` (float64, the JAX
  suite's band against torch); the ``two_loop`` cases also against
  ``torch.optim.LBFGS`` driven as the reference drives it.
* Strong Wolfe: the port's search is torch's own, the JAX package's is
  optax's zoom, so the outcome is held, as ``tests/test_lbfgs.py`` holds the
  JAX package's: the final relative loss within one decade of JAX's and of
  ``torch.optim.LBFGS(line_search_fn='strong_wolfe')``, and below 1e-6 after
  5 outer steps and 1e-10 after 10.
* The bf16 history (its buffers, float32 accumulation, the quality bands of
  ``tests/test_lbfgs.py``), the raising cases, log-mel inversion, the
  default start, and the compact direction against the two-loop recursion.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu_torch.models import _lbfgs_torch as lt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and more threads only
    contend with the suite's other workers (3x slower under a loaded host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 256


def _power_spec_pair(n=N, n_fft=64, n_freq=33):
    """The same differentiable transform in JAX and in torch, from shared
    numpy matrices (``tests/test_lbfgs.py``)."""
    k = np.arange(n_freq)[None, :]
    t = np.arange(n_fft)[:, None]
    c = np.cos(2 * np.pi * t * k / n_fft)
    s = np.sin(2 * np.pi * t * k / n_fft)
    cj, sj, ct, stt = jnp.asarray(c), jnp.asarray(s), torch.from_numpy(c), torch.from_numpy(s)
    frames = n // n_fft

    def fn_jax(x):
        z = x.reshape(frames, n_fft)
        return (z @ cj) ** 2 + (z @ sj) ** 2

    def fn_torch(x):
        z = x.reshape(frames, n_fft)
        return (z @ ct) ** 2 + (z @ stt) ** 2

    return fn_jax, fn_torch


FN_JAX, FN_TORCH = _power_spec_pair()  # one transform per file: JAX compiles per kwarg set


def _rel(v, s):
    v, s = np.asarray(v), np.asarray(s)
    return float(np.mean((v - s) ** 2) / np.mean(s**2))


def _torch_optim_lbfgs(spec, fn, x0, outer, **kwargs):
    """``torch.optim.LBFGS`` driven as the reference's ``L_BFGS`` drives it:
    one ``step(closure)`` per outer step on the MSE loss (tol 0)."""
    x = x0.clone().requires_grad_()
    opt = torch.optim.LBFGS([x], **kwargs)

    def closure():
        opt.zero_grad()
        loss = torch.mean((fn(x) - spec) ** 2)
        loss.backward()
        return loss

    for _ in range(outer):
        opt.step(closure)
    return x.detach()


CASES = {
    "defaults": {},
    "lr-hist": {"lr": 0.3, "history_size": 3},
    "max_eval": {"max_eval": 5},
    "tol_change": {"tolerance_change": 1e-2},
    "tol_grad": {"tolerance_grad": 1e-3},
}


def _trajectory_inputs(seed=42):
    rng = np.random.default_rng(seed)
    x_true = rng.standard_normal(N)
    return x_true, 0.5 * x_true + 0.1 * rng.standard_normal(N)


@pytest.mark.parametrize("direction", ["compact", "two_loop"])
@pytest.mark.parametrize("case", list(CASES))
def test_fixed_step_trajectory_matches_jax(case, direction):
    x_true, x0 = _trajectory_inputs()
    kw = dict(outer_max_iter=2, tol=0.0, verbose=False, direction=direction, **CASES[case])
    ref = np.asarray(si.L_BFGS(FN_JAX(jnp.asarray(x_true)), FN_JAX, init_x0=jnp.asarray(x0), **kw))
    ours = st.L_BFGS(FN_TORCH(torch.from_numpy(x_true)), FN_TORCH,
                     init_x0=torch.from_numpy(x0), **kw)
    assert ours.dtype == torch.float64 and not ours.requires_grad
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-8)
    assert np.abs(ref - x0).max() > 1e-2  # it moved


@pytest.mark.parametrize("case", list(CASES))
def test_two_loop_trajectory_matches_torch_optim(case):
    x_true, x0 = _trajectory_inputs()
    spec = FN_TORCH(torch.from_numpy(x_true))
    ref = _torch_optim_lbfgs(spec, FN_TORCH, torch.from_numpy(x0), 2, **CASES[case])
    ours = st.L_BFGS(spec, FN_TORCH, init_x0=torch.from_numpy(x0), outer_max_iter=2, tol=0.0,
                     verbose=False, direction="two_loop", **CASES[case])
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-6, atol=1e-8)


def test_compact_matches_two_loop_end_to_end():
    x_true, x0 = _trajectory_inputs(7)
    spec = FN_TORCH(torch.from_numpy(x_true))
    kw = dict(init_x0=torch.from_numpy(x0), outer_max_iter=3, tol=0.0, verbose=False,
              history_size=5)
    a = st.L_BFGS(spec, FN_TORCH, direction="compact", **kw)
    b = st.L_BFGS(spec, FN_TORCH, direction="two_loop", **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("outer,floor", [(5, 1e-6), (10, 1e-10)])
def test_strong_wolfe_outcome(outer, floor):
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal(N)
    x0 = 0.1 * rng.standard_normal(N)  # far start: the line search matters
    kw = dict(outer_max_iter=outer, tol=0.0, verbose=False, max_iter=20, history_size=10,
              line_search_fn="strong_wolfe")
    spec_j, spec_t = FN_JAX(jnp.asarray(x_true)), FN_TORCH(torch.from_numpy(x_true))
    l_jax = _rel(FN_JAX(si.L_BFGS(spec_j, FN_JAX, init_x0=jnp.asarray(x0), **kw)), spec_j)
    l_torch = _rel(FN_TORCH(_torch_optim_lbfgs(spec_t, FN_TORCH, torch.from_numpy(x0), outer,
                                               max_iter=20, history_size=10,
                                               line_search_fn="strong_wolfe")), spec_t)
    l_ours = _rel(FN_TORCH(st.L_BFGS(spec_t, FN_TORCH, init_x0=torch.from_numpy(x0), **kw)),
                  spec_t)
    for ref in (l_jax, l_torch):
        assert l_ours < max(10.0 * ref, 1e-14), (outer, l_ours, l_jax, l_torch)
    assert l_ours < floor, (outer, l_ours)


def _stft_mag_fn(n_fft):
    window = torch.ones(n_fft, dtype=torch.float32)

    def fn(x):
        return st.stft(x, n_fft, window=window).abs()

    return fn


@pytest.mark.parametrize("line_search_fn", [None, "strong_wolfe"])
def test_history_dtype_bf16_quality(line_search_fn):
    """bf16 history rows: approximate, but the same converged quality as the
    float32 history (the bands of tests/test_lbfgs.py)."""
    fn = _stft_mag_fn(256)
    x_true = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    spec = fn(x_true)
    kw = dict(samples=(4096,), outer_max_iter=8, tol=0.0, verbose=False, max_iter=10,
              history_size=10, line_search_fn=line_search_fn)

    def rel(y):
        return _rel(fn(y), spec)

    l32 = rel(st.L_BFGS(spec, fn, **kw))
    l16 = rel(st.L_BFGS(spec, fn, history_dtype="bfloat16", **kw))
    assert l16 < max(10.0 * l32, 1e-10), (l16, l32)
    assert l16 < 0.05, l16


def test_history_dtype_buffers_and_accumulation():
    """The bf16 history is stored in bf16, its scalars in float32, and one
    step's result stays near the float32 history's (float32 accumulation:
    only the stored rows are rounded)."""
    state = lt.init_state(torch.zeros(64), 4, history_dtype="bfloat16")
    assert state.ybuf.dtype == torch.bfloat16 and state.sbuf.dtype == torch.bfloat16
    assert state.rho.dtype == torch.float32 and state.gram.dtype == torch.float32
    q = torch.from_numpy(np.diag(np.linspace(1.0, 4.0, 64)).astype(np.float32))

    def vg(x):
        return 0.5 * x @ q @ x, q @ x

    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(64).astype(np.float32))
    kw = dict(lr=0.5, max_iter=6, max_eval=10, tolerance_grad=0.0, tolerance_change=0.0,
              direction="compact")
    x32, _ = lt.lbfgs_step(x0, lt.init_state(x0, 4), vg, **kw)
    x16, st16 = lt.lbfgs_step(x0, state, vg, **kw)
    assert st16.ybuf.dtype == torch.bfloat16 and bool(st16.ybuf.abs().sum() > 0)
    np.testing.assert_allclose(x16.numpy(), x32.numpy(), rtol=5e-2, atol=5e-3)
    assert not torch.equal(x16, x32)


def test_raising_cases():
    fn = _stft_mag_fn(256)
    spec = torch.zeros((129, 10))
    with pytest.raises(ValueError, match="init_x0 or samples"):
        st.L_BFGS(spec, fn, verbose=False)
    with pytest.raises(ValueError, match="compact"):
        st.L_BFGS(spec, fn, samples=(2048,), direction="two_loop", history_dtype="bfloat16")
    with pytest.raises(TypeError):
        st.L_BFGS(spec, fn, samples=(2048,), bogus_option=3)
    with pytest.raises(ValueError, match="line_search_fn"):
        st.L_BFGS(spec, fn, samples=(2048,), line_search_fn="backtracking")
    with pytest.raises(ValueError, match="direction"):
        st.L_BFGS(spec, fn, samples=(2048,), direction="dense")


def test_fixed_step_log_mel_matches_jax():
    """The fixed step on config 4's transform (log-mel, small): the same
    trajectory as the JAX package's, where it climbs (lr = 1 overshoots on
    this loss in both packages)."""
    rng = np.random.default_rng(0)
    x, x0 = rng.standard_normal(4096), rng.standard_normal(4096) * 1e-6
    kw = dict(n_fft=512, n_mels=64, sample_rate=22050, dtype=np.float64)
    fj, ft = si.log_mel_transform(**kw), st.log_mel_transform(**kw)
    call = dict(outer_max_iter=3, max_iter=20, tol=0.0, verbose=False)
    ref = np.asarray(si.L_BFGS(fj(jnp.asarray(x)), fj, init_x0=jnp.asarray(x0), **call))
    ours = st.L_BFGS(ft(torch.from_numpy(x)), ft, init_x0=torch.from_numpy(x0), **call)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-8 * np.abs(ref).max())


def test_log_mel_inversion():
    """BASELINE config 4 at a small size: a log-mel spectrogram inverted
    by the strong-Wolfe path from the default start."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    fn = st.log_mel_transform(n_fft=512, n_mels=64, sample_rate=22050)
    mel = fn(x)
    assert mel.shape == (64, 33)
    y = st.L_BFGS(mel, fn, samples=(4096,), outer_max_iter=10, max_iter=20,
                  line_search_fn="strong_wolfe", verbose=False)
    assert _rel(fn(y), mel) < 0.1


@pytest.mark.parametrize("line_search_fn", [None, "strong_wolfe"])
def test_default_start_is_the_seeded_draw(line_search_fn):
    """Without init_x0 the start is ``N(0, 1e-6)`` from a torch.Generator
    seeded with ``seed``: the same seed gives the same run, another seed
    another one."""
    fn = _stft_mag_fn(128)
    spec = fn(torch.from_numpy(np.random.default_rng(1).standard_normal(1024)))
    kw = dict(outer_max_iter=2, max_iter=4, tol=0.0, verbose=False,
              line_search_fn=line_search_fn)
    a = st.L_BFGS(spec, fn, samples=(1024,), seed=5, **kw)
    x0 = torch.randn((1024,), generator=torch.Generator().manual_seed(5),
                     dtype=torch.float64) * 1e-6
    torch.testing.assert_close(a, st.L_BFGS(spec, fn, init_x0=x0, **kw), rtol=0, atol=0)
    torch.testing.assert_close(a, st.L_BFGS(spec, fn, samples=1024, seed=5, **kw),
                               rtol=0, atol=0)
    assert not torch.equal(a, st.L_BFGS(spec, fn, samples=(1024,), seed=6, **kw))


@pytest.mark.parametrize("line_search_fn", [None, "strong_wolfe"])
def test_modes_agree_with_early_stopping(line_search_fn):
    """'fori' freezes the state after the stop (the history written in place
    included), 'while' leaves the loop: the same waveform."""
    x_true, x0 = _trajectory_inputs()
    spec = FN_TORCH(torch.from_numpy(x_true))
    kw = dict(init_x0=torch.from_numpy(x0), outer_max_iter=12, tol=1e-2, eva_iter=1,
              max_iter=3, verbose=False, line_search_fn=line_search_fn)
    fori = st.L_BFGS(spec, FN_TORCH, mode="fori", **kw)
    whl = st.L_BFGS(spec, FN_TORCH, mode="while", **kw)
    torch.testing.assert_close(fori, whl, rtol=0, atol=0)
    full = st.L_BFGS(spec, FN_TORCH, **dict(kw, tol=0.0))
    assert not torch.equal(fori, full)  # the stop fired


def test_compact_direction_matches_two_loop():
    """One direction from a random history with a wrapped circular buffer:
    the compact form against the two-loop recursion."""
    from specinv_tpu_torch.models._lbfgs_compact import compact_direction, gram_insert

    rng = np.random.default_rng(9)
    m, n = 5, 40
    sbuf = torch.from_numpy(rng.standard_normal((m, n)))
    ybuf = sbuf + 0.1 * torch.from_numpy(rng.standard_normal((m, n)))
    rho = 1.0 / (sbuf * ybuf).sum(1)
    gram = torch.zeros((m, m), dtype=torch.float64)
    for slot in range(m):
        gram = gram_insert(gram, sbuf, ybuf, slot, sbuf[slot], ybuf[slot])
    grad = torch.from_numpy(rng.standard_normal(n))
    hist, head = torch.tensor(4), torch.tensor(2)
    h_diag = torch.tensor(0.7, dtype=torch.float64)
    iota = torch.arange(m)
    d = compact_direction(-grad, sbuf, ybuf, rho, gram, (head - hist + iota) % m, iota < hist,
                          h_diag)
    ref = lt._two_loop(grad, ybuf, sbuf, rho, hist, head, h_diag)
    np.testing.assert_allclose(d.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)
