"""The RTISI-LA path as a whole: specinv_tpu_torch.RTISI_LA and RTISIStreamer
on the CPU against specinv_tpu's.

* backend='fft' against the JAX fft backend in float64, atol 1e-10 over 12
  frames: the bar of the JAX package's own parity test against the torch
  reference.  RTISI's causal recursion roughly doubles a last-bit
  difference per committed frame, so exact comparison holds over a short
  horizon only.
* backend='kernel' (the CUDA kernel's plain version on CPU tensors) against
  the JAX pallas4 kernel in interpret mode at precision=HIGHEST, float32,
  with the band derived in test_kernel_path_matches_jax_pallas4.
* The streamer against the offline call and against the JAX streamer, in
  float64, on interior samples (the edges are normalised differently by
  design).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st

from .helpers import make_signal, torch_stft

jrt = importlib.import_module("specinv_tpu.models.rtisi_la")
trt = importlib.import_module("specinv_tpu_torch.models.rtisi_la")

F64_ATOL = 1e-10

FFT_CASES = {
    **{f"la{la}-{'asym' if asym else 'sym'}": dict(look_ahead=la, asymmetric_window=asym)
       for la in (-1, 2, 0) for asym in (False, True)},
    "pad_constant": dict(stft=dict(pad_mode="constant")),
    "pad_replicate": dict(stft=dict(pad_mode="replicate"), asymmetric_window=True),
    "pad_circular": dict(stft=dict(pad_mode="circular")),
    "normalized": dict(stft=dict(normalized=True), look_ahead=2),
    "win_length": dict(stft=dict(win_length=200, window=np.hanning(200)), asymmetric_window=True),
    "center_false": dict(stft=dict(center=False, hop_length=96)),
    "twosided": dict(stft=dict(onesided=False), look_ahead=1),
}


def _mag(x, n_fft, **stft_kw):
    kw = dict(stft_kw)
    if "win_length" in kw:  # torch.stft wants the window at win_length, as given
        kw["window"] = torch.from_numpy(kw["window"])
    return np.abs(torch_stft(x, n_fft, **kw))


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_path_matches_jax_f64(case):
    c = dict(FFT_CASES[case])
    stft_kw = c.pop("stft", {})
    mag = _mag(make_signal((4410,)), 256, **stft_kw)[:, :12]
    kw = dict(c, max_iter=4, verbose=False, **stft_kw)
    ref = np.asarray(si.RTISI_LA(mag, backend="fft", **kw))
    ours = st.RTISI_LA(torch.from_numpy(mag), backend="fft", **kw)
    assert ours.dtype == torch.float64 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=F64_ATOL, rtol=0)


def test_config3_width_fft_path():
    """Config 3's width (n_fft 2048, hop 512, hann, la 3) on 16 frames of the
    speech-like clip, 3 refinements, float64, held by quality.  A waveform
    bar is out of reach here: the zero-phase seed under a hann window gives
    bins whose |S| is tiny against the target, so the projection's phase is
    set by rounding, and the first step's in-flight frames already differ by
    1e-10 between the two packages' FFTs; the recursion amplifies that.  The
    SCs ended 0.146 dB apart (measured on the CPU); the bar is the JAX package's own
    quality-parity bar against the reference, 0.3 dB."""
    from specinv_tpu_torch.utils.corpus import make_speech_like

    win = np.hanning(2049)[:-1]
    mag = _mag(make_speech_like(220500, seed=0), 2048, hop_length=512,
               window=torch.from_numpy(win))
    assert mag.shape == (1025, 431)
    mag = np.ascontiguousarray(mag[:, 200:216])
    kw = dict(look_ahead=3, max_iter=3, verbose=False, hop_length=512, window=win)
    ref = np.asarray(si.RTISI_LA(mag, backend="fft", **kw))
    ours = st.RTISI_LA(torch.from_numpy(mag), backend="fft", **kw)
    assert ours.shape == ref.shape

    def sc_db(y):
        got = np.abs(torch_stft(np.asarray(y), 2048, hop_length=512, window=torch.from_numpy(win)))
        return float(st.sc(torch.from_numpy(got), torch.from_numpy(mag)))

    assert abs(sc_db(ours) - sc_db(ref)) < 0.3


# The kernel path against JAX pallas4, float32 on both sides, 8 frames of
# n_fft 512 / hop 128, look-ahead 3, 3 refinements.  Anchor: the port's fft
# path in float64.  Measured on the CPU: the port's float32 kernel path lies
# 3.5e-6 of the max from it (frames_per_launch 8 and 1), the JAX kernel
# 7.9e-6; they lie 9.3e-6 / 9.7e-6 apart.  The band is twice the sum of the
# two drifts, rounded up: 3e-5 of the max, inside the 2e-4 the JAX package
# holds its own kernel to.  The port's own drift is held to half the band.
KERNEL_REL = 3e-5


def _kernel_case():
    x = make_signal((4410,), dtype=np.float32)
    return np.abs(torch_stft(x, 512)).astype(np.float32)[:, :8]


@pytest.mark.parametrize("fpl", [8, 1])
def test_kernel_path_matches_jax_pallas4(fpl):
    """frames_per_launch=1 sends JAX to rtisi_fused4._kernel (K7) and the
    port to the same kernel as 8 does (K5): one kernel closes both."""
    mag = _kernel_case()
    kw = dict(look_ahead=3, max_iter=3, verbose=False, frames_per_launch=fpl)
    ref = np.asarray(si.RTISI_LA(mag, backend="pallas4",
                                 precision=jax.lax.Precision.HIGHEST, **kw))
    ours = st.RTISI_LA(torch.from_numpy(mag), backend="kernel", **kw)
    anchor = st.RTISI_LA(torch.from_numpy(mag).double(), look_ahead=3, max_iter=3,
                         verbose=False, backend="fft").numpy()
    scale = np.abs(anchor).max()
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert np.abs(ours.numpy() - anchor).max() <= KERNEL_REL / 2 * scale
    np.testing.assert_allclose(ours.numpy(), ref, atol=KERNEL_REL * scale, rtol=0)


# The kernel path at Whisper's 400 / 160 (kernel D's mixed-radix instance on
# the card) against the JAX package's fft path there, float32 on both sides,
# 8 frames, look-ahead 2, anchored on the port's fft path in float64.  One
# refinement: at this geometry the newest frame's projection is
# ill-conditioned, and with 2 or 3 refinements one float32 rounding moves
# each package 1e-3 to 3e-1 of the max from float64 (the port's float32 fft
# path as far as its kernel path), so the comparison would measure that,
# not the path.  Measured on the CPU: the port's kernel path 6.0e-5 from
# the anchor, JAX 2.5e-5, 6.8e-5 apart; the band is twice the sum of the
# drifts, rounded up, and the port's own drift is held to half of it.
KERNEL_400_REL = 2e-4


def test_kernel_path_at_400_160_matches_jax_fft():
    win = np.hanning(401)[:-1]
    x = make_signal((4000,), dtype=np.float32)
    mag = np.abs(torch_stft(x, 400, hop_length=160, window=win.astype(np.float32)))
    mag = np.ascontiguousarray(mag.astype(np.float32)[:, :8])
    kw = dict(look_ahead=2, max_iter=1, verbose=False, hop_length=160)
    ref = np.asarray(si.RTISI_LA(mag, backend="fft", window=win.astype(np.float32), **kw))
    ours = st.RTISI_LA(torch.from_numpy(mag), backend="kernel", window=win.astype(np.float32),
                       **kw)
    anchor = st.RTISI_LA(torch.from_numpy(mag).double(), backend="fft", window=win, **kw).numpy()
    scale = np.abs(anchor).max()
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert np.abs(ours.numpy() - anchor).max() <= KERNEL_400_REL / 2 * scale
    np.testing.assert_allclose(ours.numpy(), ref, atol=KERNEL_400_REL * scale, rtol=0)


def test_frames_per_launch_and_chunk_rows_are_bitwise_on_cpu():
    """The kernel path's launch folding and batch chunking change no bit of
    the plain version's result (the card's check is in
    test_torch_cuda_kernels.py)."""
    x = make_signal((3, 3000), dtype=np.float32)
    mag = torch.from_numpy(np.abs(torch_stft(x, 512)).astype(np.float32)[..., :9])
    kw = dict(look_ahead=2, max_iter=2, verbose=False, backend="kernel")
    base = st.RTISI_LA(mag, **kw)
    for extra in (dict(frames_per_launch=1), dict(frames_per_launch=3),
                  dict(chunk_rows=3), dict(chunk_rows=6, frames_per_launch=4)):
        torch.testing.assert_close(st.RTISI_LA(mag, **extra, **kw), base, rtol=0, atol=0)


def _stream(mag, **kw):
    """Push every frame of ``mag`` ((F, T) or (B, F, T)), then flush."""
    s = st.RTISIStreamer(num_freqs=mag.shape[-2], **kw)
    outs = [s.push(mag[..., t]) for t in range(mag.shape[-1])]
    return torch.cat([o for o in outs if o is not None] + [s.flush()], dim=1)


def _interior(offline, stream, n_fft):
    p = n_fft // 2
    n = min(offline.shape[-1], stream.shape[-1] - p)
    return offline[..., n_fft : n - n_fft], stream[..., p + n_fft : p + n - n_fft]


@pytest.mark.parametrize("la,asym", [(3, False), (2, True)])
def test_streamer_matches_offline_and_jax(la, asym):
    """Over 16 frames: on longer streams the recursion amplifies the two
    packages' FFT rounding past 1e-8 (3.4e-7 after 32 frames)."""
    x = make_signal((2000,))
    mag = torch.from_numpy(np.abs(torch_stft(x, 256))[:, :16])
    kw = dict(look_ahead=la, asymmetric_window=asym, max_iter=4)
    offline = st.RTISI_LA(mag, verbose=False, backend="fft", **kw)
    stream = _stream(mag, dtype=torch.float64, **kw)[0]
    a, b = _interior(offline, stream, 256)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-8)

    js = jrt.RTISIStreamer(num_freqs=mag.shape[0], dtype=jnp.float64, backend="fft", **kw)
    chunks = [js.push(mag.numpy()[:, t]) for t in range(mag.shape[1])]
    ref = np.asarray(jnp.concatenate([c for c in chunks if c is not None] + [js.flush()],
                                     axis=1))[0]
    assert ref.shape == stream.shape
    np.testing.assert_allclose(stream.numpy()[256:-256], ref[256:-256], atol=1e-8, rtol=0)


def test_streamer_kernel_backend_matches_offline_kernel():
    """The streamer's kernel path (one step per launch) commits what the
    offline kernel path commits: the interior samples agree to float32
    rounding of the two OLAs."""
    x = make_signal((6000,), dtype=np.float32)
    mag = torch.from_numpy(np.abs(torch_stft(x, 512)).astype(np.float32)[:, :24])
    kw = dict(look_ahead=3, max_iter=3)
    offline = st.RTISI_LA(mag, verbose=False, backend="kernel", **kw)
    stream = _stream(mag, backend="kernel", **kw)[0]
    a, b = _interior(offline, stream, 512)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(a.abs().max()))


def test_streamer_batched_warmup_and_flush():
    s = st.RTISIStreamer(num_freqs=129, look_ahead=2, max_iter=2, batch=3)
    hop = s.cfg.hop_length
    outs = [s.push(torch.from_numpy(np.abs(make_signal((3, 129), np.float32, seed=t))))
            for t in range(6)]
    # the first look_ahead pushes commit warm-up frames, which are dropped
    assert outs[0] is None and outs[1] is None
    assert all(o.shape == (3, hop) and o.dtype == torch.float32 for o in outs[2:])
    tail = s.flush()
    assert tail.shape[0] == 3 and tail.shape[1] > 0 and bool(torch.isfinite(tail).all())
    single = st.RTISIStreamer(num_freqs=129, look_ahead=1, max_iter=2)
    assert single.push(torch.ones(129)) is None
    assert single.push(torch.ones(129)).shape == (1, hop)


def test_streamer_chunk_rows_is_bitwise():
    x = make_signal((3, 3000), dtype=np.float32)
    mag = torch.from_numpy(np.abs(torch_stft(x, 512)).astype(np.float32)[..., :6])
    kw = dict(look_ahead=2, max_iter=2, batch=3, backend="kernel")
    ref = _stream(mag, **kw)
    for rows in (3, 6):
        torch.testing.assert_close(_stream(mag, chunk_rows=rows, **kw), ref, rtol=0, atol=0)


def test_gradient_kernel_path_matches_jax_pallas4():
    """torch.autograd through the kernel path's plain version against
    jax.grad through pallas4 (its custom_vjp replays the XLA twin), at the
    band of the JAX package's own check of that gradient: 2e-3 of the max."""
    x = make_signal((3500,), dtype=np.float32)
    mag = np.abs(torch_stft(x, 512)).astype(np.float32)[:, :6]
    kw = dict(look_ahead=2, max_iter=2, verbose=False)

    def jloss(m):
        y = si.RTISI_LA(m, backend="pallas4", precision=jax.lax.Precision.HIGHEST, **kw)
        return jnp.sum(y * y)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(mag)))
    m = torch.from_numpy(mag).requires_grad_(True)
    (st.RTISI_LA(m, backend="kernel", **kw) ** 2).sum().backward()
    assert np.isfinite(m.grad.numpy()).all()
    np.testing.assert_allclose(m.grad.numpy(), ref, atol=2e-3 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_gradient_fft_path_matches_jax_f64(remat):
    x = make_signal((2000,))
    mag = np.abs(torch_stft(x, 128))[:, :10]
    kw = dict(look_ahead=2, asymmetric_window=True, max_iter=3, verbose=False, backend="fft")

    def jloss(m):
        y = si.RTISI_LA(m, **kw)
        return jnp.mean((y - jnp.asarray(x[: y.shape[0]])) ** 2)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(mag)))
    m = torch.from_numpy(mag).requires_grad_(True)
    y = st.RTISI_LA(m, remat=remat, **kw)
    torch.mean((y - torch.from_numpy(x[: y.shape[0]])) ** 2).backward()
    np.testing.assert_allclose(m.grad.numpy(), ref, atol=1e-9 * np.abs(ref).max(), rtol=0)


def test_backend_dispatch():
    from specinv_tpu_torch.config import canonicalize

    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def resolve(bins, backend="auto", dtype=torch.float32, device=cuda, **kw):
        cfg, w = canonicalize(bins, np.float32, **kw)
        return trt._resolve_backend(backend, cfg, w, dtype, device, kw.get("precision"))

    assert resolve(1025, hop_length=512) == "kernel"
    assert resolve(1025, hop_length=500) == "kernel"       # any hop <= n_fft
    assert resolve(1025, device=cpu) == "fft"
    assert resolve(1025, dtype=torch.float64) == "fft"
    assert resolve(1024, onesided=False) == "fft"
    assert resolve(201) == "kernel"                         # n_fft 400: n/2 = 2^3 5^2
    assert resolve(442) == "fft"                            # n_fft 882: n/2 = 3^2 7^2
    assert resolve(1025, device=None) == "auto"             # a streamer not yet bound
    for bad in (dict(onesided=False, bins=1024), dict(bins=442), dict(dtype=torch.float64)):
        bins = bad.pop("bins", 1025)
        with pytest.raises(ValueError):
            resolve(bins, backend="kernel", **bad)
    cfg, w = canonicalize(1025, np.float32)
    with pytest.raises(ValueError, match="pallas"):
        trt._resolve_backend("pallas", cfg, w, torch.float32, cuda)
    with pytest.raises(ValueError, match="precision"):
        trt._resolve_backend("fft", cfg, w, torch.float32, cuda, "highest")
    with pytest.raises(ValueError, match="precision"):
        trt._resolve_backend("kernel", cfg, w, torch.float32, cuda, "bf16x2")
    assert trt._resolve_backend("kernel", cfg, w, torch.float32, cpu, "HIGH") == "kernel"


def test_validation():
    mag = torch.from_numpy(_kernel_case()[:, :6])
    kw = dict(max_iter=2, verbose=False)
    with pytest.raises(ValueError, match="kernel"):
        st.RTISI_LA(mag, backend="fft", chunk_rows=64, **kw)
    with pytest.raises(ValueError, match="kernel"):
        st.RTISI_LA(mag, frames_per_launch=4, **kw)        # auto is fft on the CPU
    with pytest.raises(ValueError, match=">= 1"):
        st.RTISI_LA(mag, backend="kernel", chunk_rows=0, **kw)
    with pytest.raises(ValueError, match=">= 1"):
        st.RTISI_LA(mag, backend="kernel", frames_per_launch=0, **kw)
    with pytest.raises(ValueError, match="precision"):
        st.RTISI_LA(mag, precision="highest", **kw)
    with pytest.raises(ValueError, match="magnitude"):
        st.RTISI_LA(mag.to(torch.complex64), **kw)
    with pytest.raises(TypeError):
        st.RTISI_LA(mag, hop_lenght=64, **kw)
    with pytest.raises(ValueError):
        st.RTISI_LA(mag, max_iter=0, verbose=False)
    with pytest.raises(ValueError, match="kernel"):
        st.RTISIStreamer(257, backend="fft", chunk_rows=8)
    s = st.RTISIStreamer(257, chunk_rows=8)                # auto: decided at the first push
    with pytest.raises(ValueError, match="kernel"):
        s.push(torch.ones(257))                            # ... which binds it to the CPU: fft


def test_output_layout_and_dtypes():
    mag = torch.from_numpy(np.abs(torch_stft(make_signal((3000,)), 256)))
    y = st.RTISI_LA(mag, max_iter=2, verbose=False)
    assert y.ndim == 1 and y.dtype == torch.float64
    assert st.RTISI_LA(mag[None], max_iter=2, verbose=False).shape == (1, y.shape[0])
    yb = st.RTISI_LA(mag.to(torch.bfloat16), max_iter=2, verbose=False)
    assert yb.dtype == torch.float32 and yb.shape == y.shape
    assert st.rtisi_la is st.RTISI_LA


def test_verbose_reports_progress(monkeypatch):
    msgs = []
    monkeypatch.setattr(trt, "_progress_sink", msgs.append)
    spec = torch.from_numpy(np.abs(make_signal((129, 12), np.float32)))
    for backend, fpl in (("fft", None), ("kernel", 3)):
        msgs.clear()
        st.RTISI_LA(spec, look_ahead=1, max_iter=2, verbose=True, backend=backend,
                    frames_per_launch=fpl)
        assert msgs and all("rtisi-la frame" in m for m in msgs), msgs
        assert msgs[-1].endswith(f"/{12 + 1}")
        assert len(msgs) <= 17
    msgs.clear()
    st.RTISI_LA(spec[None].expand(3, -1, -1), look_ahead=1, max_iter=2, verbose=True,
                backend="kernel", chunk_rows=4)
    assert msgs == ["rtisi-la chunk 1/2", "rtisi-la chunk 2/2"]


@pytest.mark.parametrize("backend", ["matmul", "matmul4"])
def test_xla_dft_backends_name_the_ports_counterpart(backend):
    """RTISI_LA and RTISIStreamer: JAX runs the XLA lowering, the port
    raises naming 'fft'."""
    mag = _mag(make_signal((2000,)), 256)[:, :8].astype(np.float32)  # matmul4: float32
    kw = dict(look_ahead=2, max_iter=2, backend=backend)
    assert np.isfinite(np.asarray(si.RTISI_LA(mag, verbose=False, **kw))).all()
    jax_stream = si.RTISIStreamer(num_freqs=mag.shape[0], **kw)
    jax_stream.push(mag[:, 0])
    with pytest.raises(ValueError, match="the port's counterpart is 'fft'"):
        st.RTISI_LA(torch.from_numpy(mag), verbose=False, **kw)
    with pytest.raises(ValueError, match="the port's counterpart is 'fft'"):
        st.RTISIStreamer(num_freqs=mag.shape[0], **kw)
