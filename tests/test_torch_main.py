"""The port's command line (``python -m specinv_tpu_torch``) against the
JAX package's ``main.py`` on the CPU (``--device cpu``), in-process.

Each algorithm runs on the same synthetic signal at n_fft 512 through both,
writes its reconstruction as a WAV (read back through the port's codec),
and the port's printed spectral convergence lies within ``SC_BAND_DB`` of
``main.py``'s.  Both run float32 through different FFT libraries (and
L-BFGS from different seeded starts with different line searches): at these
sizes they read -27.24 / -27.21 dB (GL), -29.43 / -29.25 (ADMM), -26.55 /
-26.08 (RTISI-LA) and -0.76 / -0.73 (L-BFGS, 2 x 10 iterations) at
``--max-iter 20``; the band is about twice the largest gap, 1 dB.
"""
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import main as jax_demo  # noqa: E402

from specinv_tpu_torch import __main__ as demo  # noqa: E402
from specinv_tpu_torch.io import read_wav, write_wav  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and more threads only
    contend with the suite's other workers (3x slower under a loaded host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SC_BAND_DB = 1.0
LINE = re.compile(r"^(\w+): [\d.]+s, output \((\d+),\), spectral convergence (-?[\d.]+) dB$",
                  re.M)


def _sc(text, algorithm):
    m = LINE.search(text)
    assert m and m.group(1) == algorithm, text
    return int(m.group(2)), float(m.group(3))


def _jax_main(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
    assert jax_demo.main() == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("algorithm", ["griffin_lim", "admm", "rtisi_la", "l_bfgs"])
def test_cli_matches_main_py(tmp_path, monkeypatch, capsys, algorithm):
    argv = [algorithm, "--n-fft", "512", "--max-iter", "20"]
    out = tmp_path / "recon.wav"
    assert demo.main(argv + ["--device", "cpu", "--output", str(out)]) == 0
    text = capsys.readouterr().out
    n, sc = _sc(text, algorithm)
    assert f"wrote {out}" in text
    n_ref, sc_ref = _sc(_jax_main(argv, monkeypatch, capsys), algorithm)
    assert n == n_ref
    assert abs(sc - sc_ref) < SC_BAND_DB, (sc, sc_ref)
    y, sr = read_wav(str(out))
    assert sr == 22050 and y.shape == (n,) and np.isfinite(y).all()


def test_cli_input_wav_round_trip(tmp_path, monkeypatch, capsys):
    sr = 16000
    t = np.linspace(0, 1.0, sr, dtype=np.float32)
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    write_wav(str(src), np.stack([x, 0.5 * x]), sr)  # stereo: downmixed to mono
    argv = ["admm", "--n-fft", "512", "--max-iter", "8", "--input", str(src)]
    assert demo.main(argv + ["--device", "cpu", "--output", str(out)]) == 0
    n, sc = _sc(capsys.readouterr().out, "admm")
    _, sc_ref = _sc(_jax_main(argv, monkeypatch, capsys), "admm")
    assert abs(sc - sc_ref) < SC_BAND_DB, (sc, sc_ref)
    y, sr2 = read_wav(str(out))
    assert sr2 == sr and y.size == n >= x.size - 512 and np.isfinite(y).all()


def test_cli_plot(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    png = tmp_path / "fig.png"
    assert demo.main(["griffin_lim", "--n-fft", "512", "--max-iter", "4", "--device", "cpu",
                      "--plot", str(png)]) == 0
    assert png.stat().st_size > 1000


def test_cli_plot_without_matplotlib_is_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with pytest.raises(SystemExit) as exit_:
        demo.main(["griffin_lim", "--device", "cpu", "--plot", str(tmp_path / "f.png")])
    assert exit_.value.code == 2
    assert "--plot needs matplotlib" in capsys.readouterr().err


def test_cli_cuda_without_a_card_is_an_error(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        demo.main(["griffin_lim", "--max-iter", "2"])
    assert "--device cpu" in capsys.readouterr().err
