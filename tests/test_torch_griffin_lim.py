"""The ported slice as a whole: specinv_tpu_torch.griffin_lim on the CPU
against specinv_tpu.griffin_lim.

* backend='fft' against the JAX fft backend in float64: 1e-9 relative to
  the largest sample (the same float64 FFT math; differences are summation
  order, grown over the iterations).
* backend='kernel' (the CUDA kernel's plain version on CPU tensors) against
  the JAX pallas4 whole-run kernel at precision=HIGHEST in float32: 5e-5
  relative, the JAX package's own HIGHEST band (tests/test_pallas.py).
"""
import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st
tgl = importlib.import_module("specinv_tpu_torch.models.griffin_lim")
from specinv_tpu_torch.models import common
from specinv_tpu_torch.ops.cuda import _fullrun, gl_fullrun
from specinv_tpu_torch.utils import runner

from .helpers import make_signal, torch_stft

F64_REL = 1e-9
F32_REL = 5e-5


def _mag(x, n_fft, **kw):
    return np.abs(torch_stft(x, n_fft, **kw))


def _close(ours, ref, rel):
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, atol=rel * np.abs(ref).max(), rtol=0)


FFT_CASES = {
    "tol0": dict(shape=(22050,), kw=dict(max_iter=8, tol=0.0)),
    "early_stop": dict(shape=(22050,), kw=dict(max_iter=40, tol=1.0, eva_iter=5)),
    "batched": dict(shape=(3, 8000), kw=dict(max_iter=6, tol=0.0)),
    "center_false": dict(shape=(22050,), kw=dict(max_iter=6, tol=0.0, center=False)),
    "hann_tail": dict(shape=(8000,), kw=dict(max_iter=13, tol=1e-4, eva_iter=5), hann=True),
}


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_backend_matches_jax_f64(case):
    c = FFT_CASES[case]
    x = make_signal(c["shape"])
    kw = dict(c["kw"], hop_length=128, verbose=False)
    stft_kw = {"center": kw["center"]} if "center" in kw else {}
    if c.get("hann"):
        kw["window"] = np.hanning(513)[:-1]
        stft_kw["window"] = kw["window"]
    mag = _mag(x, 512, hop_length=128, **stft_kw)
    ref = si.griffin_lim(mag, backend="fft", **kw)
    ours = st.griffin_lim(torch.from_numpy(mag), backend="fft", **kw)
    _close(ours, ref, F64_REL)


@pytest.mark.parametrize("kw", [
    dict(max_iter=6, tol=0.0),
    dict(max_iter=40, tol=1.0, eva_iter=5),
    dict(max_iter=8, tol=1e-4, eva_iter=3),
], ids=["one_run", "early_stop", "segments_tail"])
def test_kernel_backend_matches_jax_pallas4(kw):
    """Both get the same complex64 spectrogram, phase-seeded in float64: in
    float32 the seed's cumulative phase sum (hundreds of radians, summed in
    different orders by XLA and torch) alone moves the edge samples, where
    the envelope is small, by about 1e-3; the seed is held to JAX in
    tests/test_torch_phase_init.py."""
    x = make_signal((2, 8000))
    win = np.hanning(513)[:-1]
    mag = _mag(x, 512, hop_length=128, window=win)
    spec = np.asarray(si.phase_init(mag, hop_length=128, window=win)).astype(np.complex64)
    kw = dict(kw, hop_length=128, window=win.astype(np.float32), verbose=False)
    ref = si.griffin_lim(spec, backend="pallas4", precision=jax.lax.Precision.HIGHEST, **kw)
    ours = st.griffin_lim(torch.from_numpy(spec), backend="kernel", **kw)
    _close(ours, ref, F32_REL)


def test_config1_width_fft_backend():
    """Main-path width: n_fft 2048, hop 512, hann, 10 s at 22.05 kHz (431
    frames), 3 iterations, float64."""
    from specinv_tpu_torch.utils.corpus import make_speech_like

    x = make_speech_like(220500, seed=0)
    win = np.hanning(2049)[:-1]
    mag = _mag(x, 2048, hop_length=512, window=win)
    assert mag.shape == (1025, 431)
    kw = dict(max_iter=3, tol=0.0, hop_length=512, window=win, verbose=False)
    ref = si.griffin_lim(mag, backend="fft", **kw)
    ours = st.griffin_lim(torch.from_numpy(mag), backend="fft", **kw)
    _close(ours, ref, F64_REL)


def test_modes_agree_and_early_stop_freezes():
    x = make_signal((8000,))
    mag = torch.from_numpy(_mag(x, 256))
    kw = dict(max_iter=60, tol=1.0, eva_iter=5, verbose=False)
    for backend in ("fft", "kernel"):
        m = mag.float() if backend == "kernel" else mag
        a = st.griffin_lim(m, mode="fori", backend=backend, **kw)
        b = st.griffin_lim(m, mode="while", backend=backend, **kw)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        # the stop fires at the second eval: 10 iterations, not 60
        c = st.griffin_lim(m, max_iter=10, tol=0.0, backend=backend, verbose=False)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6 * float(c.abs().max()))


@pytest.mark.parametrize("backend", ["fft", "kernel"])
@pytest.mark.parametrize("tol", [1.0, 1e-12])
def test_fori_selects_once_per_evaluation(backend, tol):
    """'fori' selects the kept state at evaluations only (utils/runner), on
    the per-iteration and the segmented driver: at most one select per
    evaluation plus one, and the 'while' result, with the stop firing
    (tol 1.0) or not."""
    mag = torch.from_numpy(_mag(make_signal((8000,)), 256))
    if backend == "kernel":
        mag = mag.float()
    kw = dict(max_iter=43, tol=tol, eva_iter=10, verbose=False, backend=backend)
    before = runner.state_selects
    a = st.griffin_lim(mag, mode="fori", **kw)
    assert runner.state_selects - before <= 43 // 10 + 1
    torch.testing.assert_close(a, st.griffin_lim(mag, mode="while", **kw), rtol=0, atol=0)


def test_gradient_matches_jax():
    """d mean((y - x)^2) / d mag through 3 iterations of the fft path, float64."""
    x = make_signal((2000,))
    mag = _mag(x, 128)

    def jloss(s):
        y = si.griffin_lim(s, max_iter=3, tol=0.0, verbose=False, backend="fft")
        return jnp.mean((y - jnp.asarray(x[: y.shape[0]])) ** 2)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(mag)))
    m = torch.from_numpy(mag).requires_grad_(True)
    y = st.griffin_lim(m, max_iter=3, tol=0.0, verbose=False, backend="fft")
    torch.mean((y - torch.from_numpy(x[: y.shape[0]])) ** 2).backward()
    np.testing.assert_allclose(m.grad.numpy(), ref, atol=1e-9 * np.abs(ref).max(), rtol=0)


def test_kernel_autograd_function_replays_twin(monkeypatch):
    """The autograd.Function around the kernel: forward from the launch,
    backward from the plain twin.  With the launch swapped for its plain
    version on the CPU, its gradients equal plain autograd's."""
    def cpu_launch(kernel, counter, x_pad, pre, target, window, inv_env, lr, cfg, n_iters,
                   with_mag, with_loss, valid):
        x, p, mag = gl_fullrun.fused_gl_run_reference(
            x_pad, pre, target, window, inv_env, lr, cfg, n_iters, emit_state=True,
            with_mag=True)
        return x, p, (mag if with_mag else None), None

    from specinv_tpu_torch.config import canonicalize
    from specinv_tpu_torch.ops import twins

    cfg, w = canonicalize(65, np.float64, hop_length=32)
    T = 12
    geo = twins.make_geometry(cfg, T)
    rng = np.random.default_rng(0)
    win = torch.from_numpy(np.hanning(129)[:-1])
    inv_env = twins.make_inv_env(cfg, win, T, geo).double()
    tgt = torch.from_numpy(np.abs(rng.standard_normal((1, T, 65)))).requires_grad_(True)
    pre = torch.from_numpy(rng.standard_normal((1, T, 65)) + 1j * rng.standard_normal((1, T, 65)))
    x0 = torch.from_numpy(rng.standard_normal((1, geo.lp))).requires_grad_(True)

    def loss(out):
        x, p = out
        return (x ** 2).sum() + (p.abs() ** 2).sum()

    g_plain = torch.autograd.grad(loss(gl_fullrun.fused_gl_run_reference(
        x0, pre, tgt, win, inv_env, 0.4, cfg, 3, emit_state=True)), (x0, tgt))
    monkeypatch.setattr(_fullrun, "launch", cpu_launch)
    x, p, _mag = _fullrun.Run.apply(gl_fullrun.KERNEL, x0, pre, tgt, win, inv_env, 0.4, cfg, 3,
                                    True, False, T, "launches")
    g_fn = torch.autograd.grad(loss((x, p)), (x0, tgt))
    for a, b in zip(g_fn, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=0)


def test_backend_dispatch():
    from specinv_tpu_torch.config import canonicalize

    cfg, w = canonicalize(1025, np.float32, hop_length=512)
    win = torch.from_numpy(w)
    assert common.resolve_backend("auto", cfg, win, torch.device("cuda")) == "kernel"
    assert common.resolve_backend("auto", cfg, win, torch.device("cpu")) == "fft"
    odd, w2 = canonicalize(201, np.float32, hop_length=100)
    # n_fft 400: no whole-run kernel, so the direct-DFT kernel (JAX: pallas4 -> pallas)
    assert common.resolve_backend("auto", odd, torch.from_numpy(w2), torch.device("cuda")) == "dft"
    # ... but not for a complex spectrogram, a two-sided config or a complex window
    assert common.resolve_backend("auto", odd, torch.from_numpy(w2), torch.device("cuda"),
                               is_complex=True) == "fft"
    two, w3 = canonicalize(400, np.float32, hop_length=100, onesided=False)
    assert common.resolve_backend("auto", two, torch.from_numpy(w3), torch.device("cuda")) == "fft"
    cwin = np.hanning(401)[:-1].astype(np.complex64)
    cplx, w4 = canonicalize(400, np.float32, hop_length=100, window=cwin)
    assert common.resolve_backend("auto", cplx, torch.from_numpy(w4), torch.device("cuda")) == "fft"
    with pytest.raises(ValueError):
        common.resolve_backend("kernel", odd, torch.from_numpy(w2), torch.device("cuda"))
    with pytest.raises(ValueError):
        common.resolve_backend("pallas4", cfg, win, torch.device("cuda"))
    mag = torch.rand(129, 20)
    # pack on the CPU's resolved 'fft': JAX's message (it is taken on 'kernel')
    with pytest.raises(ValueError, match="pack applies to the whole-run pallas4 kernel only"):
        st.griffin_lim(mag, max_iter=2, verbose=False, pack=2)
    for bad in (dict(loss_psum_axes=("data",)), dict(precision="bf16x2")):
        with pytest.raises(ValueError):
            st.griffin_lim(mag, max_iter=2, verbose=False, **bad)
    with pytest.raises(TypeError):
        st.griffin_lim(mag, max_iter=2, verbose=False, hop_lenght=64)


@pytest.mark.parametrize("name", ["griffin_lim", "ADMM"])
def test_pack_follows_jax_rule(name):
    """``pack`` as JAX takes it: on a resolved 'kernel' (the JAX 'pallas4')
    any k >= 1 that divides B is accepted and changes nothing (JAX's packed
    run is bitwise equal to pack=1); any other k raises JAX's message, and so
    does every pack on another backend."""
    fn = getattr(st, name)
    mag = torch.from_numpy(np.random.default_rng(3).random((2, 129, 12)).astype(np.float32))
    kw = dict(max_iter=3, tol=0.0, verbose=False)
    base = fn(mag, backend="kernel", **kw)
    for k in (1, 2, np.int64(2)):
        assert torch.equal(fn(mag, backend="kernel", pack=k, **kw), base)
    cfg, w = st.canonicalize(129, np.float32)
    cuda = torch.device("cuda")
    assert common.resolve_backend("auto", cfg, torch.from_numpy(w), cuda) == "kernel"
    common.check_pack(2, "kernel", 2)  # what 'auto' resolves to on the card
    for bad in (0, 3, -2, 1.0, True):
        with pytest.raises(ValueError, match="must be >= 1 and divide the batch size 2"):
            fn(mag, backend="kernel", pack=bad, **kw)
        with pytest.raises(ValueError, match="must be >= 1 and divide the batch size 2"):
            common.check_pack(bad, "kernel", 2)
    for backend in ("fft", "dft", "auto"):  # 'auto' is 'fft' on the CPU
        with pytest.raises(ValueError, match="pack applies to the whole-run pallas4 kernel only"):
            fn(mag, backend=backend, pack=2, **kw)
    with pytest.raises(ValueError, match="pack applies to the whole-run pallas4 kernel only"):
        getattr(si, name)(mag.numpy(), backend="fft", pack=2, **kw)


def test_precision_default_runs_on_fft():
    """``precision='default'`` on 'fft' runs and equals None, as JAX's XLA
    backends ignore it; on 'kernel' it raises."""
    mag = torch.from_numpy(np.random.default_rng(4).random((257, 20)).astype(np.float32))
    kw = dict(max_iter=3, tol=0.0, verbose=False)
    base = st.griffin_lim(mag, **kw)
    for p in ("default", "DEFAULT"):
        assert torch.equal(st.griffin_lim(mag, precision=p, **kw), base)
        assert torch.equal(st.ADMM(mag, precision=p, **kw), st.ADMM(mag, **kw))
    with pytest.raises(ValueError, match="single bf16 pass"):
        st.griffin_lim(mag, backend="kernel", precision="default", **kw)


def test_output_layout_and_dtypes():
    mag = torch.from_numpy(_mag(make_signal((4000,)), 256))
    y = st.griffin_lim(mag, max_iter=2, verbose=False)
    assert y.ndim == 1 and y.dtype == torch.float64
    y3 = st.griffin_lim(mag[None], max_iter=2, verbose=False)
    assert y3.shape == (1, y.shape[0])
    yb = st.griffin_lim(mag.to(torch.bfloat16), max_iter=2, verbose=False)
    assert yb.dtype == torch.float32 and torch.isfinite(yb).all()
    yk = st.griffin_lim(mag.float(), max_iter=2, verbose=False, backend="kernel")
    assert yk.dtype == torch.float32 and yk.shape == y.shape
    spec = torch.from_numpy(torch_stft(make_signal((4000,)), 256))
    assert st.griffin_lim(spec, max_iter=2, verbose=False).shape == y.shape


def test_port_imports_no_jax():
    code = ("import sys, specinv_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'specinv_tpu' not in sys.modules, 'specinv_tpu imported'")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("backend", ["matmul", "matmul4"])
def test_xla_dft_backends_name_the_ports_counterpart(backend):
    """JAX's XLA lowerings of the DFT run in the JAX package; the port has
    none and raises, naming 'fft' and 'dft', rather than run another path."""
    mag = np.abs(torch_stft(make_signal((4000,)), 256)).astype(np.float32)  # matmul4: float32
    assert np.isfinite(np.asarray(si.griffin_lim(mag, max_iter=2, verbose=False,
                                                 backend=backend))).all()
    with pytest.raises(ValueError, match="the port's counterpart is 'fft'.*'dft'"):
        st.griffin_lim(torch.from_numpy(mag), max_iter=2, verbose=False, backend=backend)
