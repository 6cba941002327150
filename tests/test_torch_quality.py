"""The port's quality on the speech-like clip of tests/test_quality.py, on the
CPU: ``make_speech_like(int(1.2 * 22050), sr=22050, seed=11)`` at n_fft 512
(the JAX defaults: hop 128, no window), from the port's own
``utils/corpus``.

* The self-golden cases (``tests/goldens/self_quality.json``, recorded
  through the JAX package's float64 XLA path) replayed through the port's
  float64 ``torch.fft`` path, SC / SNR / SER in dB.  Griffin-Lim and 25
  iterations of ADMM hold the goldens' 1e-5 dB band (they read 1e-7 dB or
  less).  ADMM at 200 iterations and RTISI-LA are chaotic in float64: the
  JAX package's own run moves by up to 0.420, 0.661 and 1.093 dB (admm_200,
  rtisi_sym_8, rtisi_asym_32) when the magnitude is perturbed by 1e-15 of
  itself (``scripts/quality_chaos.py``, 16 draws), so no other FFT
  implementation can replay them inside 1e-5 dB; they are held at twice that
  move, rounded up to one digit (the port reads 0.113, 0.164 and 0.324 dB
  from the goldens).  ``lbfgs_20x10`` (``l_bfgs`` on ``|stft|``, 20 outer
  steps of 10 fixed-step iterations, history 10) starts from the golden's
  own start, the JAX package's ``PRNGKey(0)`` draw, passed as ``init_x0``;
  L-BFGS is chaotic in float64 too (the JAX package's own run moves up to
  0.018 dB under the same perturbation, 16 draws), so it is held at 0.04 dB
  (the port reads 0.0038 dB from the golden).
* Griffin-Lim for 1000 iterations in float32 and in float64 through both
  packages (JAX ``griffin_lim``, the port's ``'fft'`` path): the two float64
  runs agree within 1e-6 dB (they read 1.2e-10), and the port's float32 gap
  from its float64 run lies within twice the JAX package's own float32 gap
  (read 0.000901 dB against JAX's 0.005216): the float32 gap is float32's,
  not the port's.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu_torch.utils.corpus import make_speech_like

N_FFT = 512
CLIP = make_speech_like(int(1.2 * 22050), sr=22050, seed=11)
GOLDENS = json.loads((Path(__file__).parent / "goldens" / "self_quality.json").read_text())
SELF_BAND_DB = {
    "gl_10": 1e-5, "gl_100": 1e-5, "gl_500": 1e-5, "admm_25": 1e-5,
    "admm_200": 0.9, "rtisi_sym_8": 2.0, "rtisi_asym_32": 3.0, "lbfgs_20x10": 0.04,
}
QUALITY_ITERS = 1000
F64_AGREE_DB = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and more threads only
    contend with the suite's other workers (3x slower under a loaded host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mag():
    return st.stft(torch.from_numpy(np.asarray(CLIP, np.float64)), N_FFT).abs()


def _metrics(y, mag):
    m = st.stft(torch.as_tensor(np.asarray(y)).double(), N_FFT).abs()
    return {k: float(getattr(st, k)(m, mag)) for k in ("sc", "snr", "ser")}


def _lbfgs_start():
    """The JAX package's default L-BFGS start for the clip (``PRNGKey(0)``,
    float64), which the golden ran from."""
    import jax

    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (CLIP.size,), dtype=np.float64))


def _case(name, mag):
    if name == "lbfgs_20x10":
        return st.l_bfgs(mag, lambda x: st.stft(x, N_FFT).abs(),
                         init_x0=torch.from_numpy(_lbfgs_start() * 1e-6), outer_max_iter=20,
                         tol=0.0, verbose=False, max_iter=10, lr=1.0, history_size=10)
    algo, n = name.rsplit("_", 1)
    kw = dict(max_iter=int(n), verbose=False)
    if algo == "gl":
        return st.griffin_lim(mag, tol=0.0, **kw)
    if algo == "admm":
        return st.admm(mag, tol=0.0, **kw)
    return st.rtisi_la(mag, look_ahead=3, asymmetric_window=algo == "rtisi_asym", **kw)


@pytest.mark.parametrize("name", sorted(SELF_BAND_DB))
def test_self_golden_replayed_in_float64(name):
    mag = _mag()
    got = _metrics(_case(name, mag), mag)
    for k in ("sc", "snr", "ser"):
        assert abs(got[k] - GOLDENS[name][k]) < SELF_BAND_DB[name], (name, k, got, GOLDENS[name])


def test_float32_gap_at_1000_iterations_is_float32s():
    import jax.numpy as jnp

    mag = _mag()
    sc = {}
    for dt in (np.float32, np.float64):
        m = mag.numpy().astype(dt)
        y_jax = np.asarray(si.griffin_lim(jnp.asarray(m), max_iter=QUALITY_ITERS, tol=0.0,
                                          verbose=False))
        y_port = st.griffin_lim(torch.from_numpy(m), max_iter=QUALITY_ITERS, tol=0.0,
                                verbose=False, backend="fft")
        assert y_jax.dtype == dt and y_port.dtype == torch.from_numpy(m).dtype
        sc[dt] = (_metrics(y_jax, mag)["sc"], _metrics(y_port, mag)["sc"])
    assert abs(sc[np.float64][0] - sc[np.float64][1]) < F64_AGREE_DB
    gap_jax = abs(sc[np.float32][0] - sc[np.float64][0])
    gap_port = abs(sc[np.float32][1] - sc[np.float64][1])
    assert gap_port <= 2 * gap_jax, (gap_port, gap_jax)
