"""The benchmark's plain references against the JAX package, float64 on the
CPU at a small size: Griffin-Lim with the SPSI seed and its stop rule, and
RTISI-LA offline and as a stream.  The test imports both packages; the
references import neither, nor anything of the port."""
import ast
import os
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import specinv_tpu  # noqa: E402
from specinv_tpu.utils.corpus import make_speech_like  # noqa: E402

from portbench.reference import griffin_lim as ref_gl  # noqa: E402
from portbench.reference import rtisi_la as ref_rt  # noqa: E402

N, HOP = 512, 128
WINDOW = np.hanning(N + 1)[:-1]


def magnitudes(count, n_samples):
    clips = np.stack([make_speech_like(n_samples, seed=s) for s in range(count)])
    spec = torch.stft(torch.from_numpy(clips), N, HOP, window=torch.from_numpy(WINDOW),
                      return_complex=True)
    return spec.abs().numpy()


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("max_iter,tol", [(30, 1e-6), (60, 1e-2)])
def test_griffin_lim_matches_the_jax_package(max_iter, tol):
    mag = magnitudes(3, 8000)
    ours = ref_gl.invert(torch.from_numpy(mag), torch.from_numpy(WINDOW), HOP, max_iter, tol,
                         10, 0.99)
    theirs = specinv_tpu.griffin_lim(mag, max_iter=max_iter, tol=tol, verbose=False,
                                     window=WINDOW, hop_length=HOP)
    assert rel(ours.numpy(), theirs) < 1e-9


def test_spsi_seed_matches_the_jax_package():
    mag = magnitudes(2, 8000)
    ours = ref_gl.spsi(torch.from_numpy(mag).transpose(-1, -2), N, HOP)
    theirs = np.angle(np.asarray(specinv_tpu.phase_init(mag, window=WINDOW, hop_length=HOP)))
    d = np.angle(np.exp(1j * (ours.transpose(-1, -2).numpy() - theirs)))
    assert np.abs(d)[mag > 1e-6 * mag.max()].max() < 1e-9


def jax_rtisi(mag):
    return np.asarray(specinv_tpu.RTISI_LA(mag, look_ahead=3, max_iter=10, verbose=False,
                                           window=WINDOW, hop_length=HOP))


def chaos(mag):
    """How far the JAX package's own float64 RTISI-LA moves when the
    magnitudes move by 1e-15 of themselves: the recursion amplifies a
    rounding about twice per frame, so two float64 implementations that
    round differently lie about this far apart (16 frames: 1.5e-6)."""
    return rel(jax_rtisi(mag * (1 + 1e-15)) / (1 + 1e-15), jax_rtisi(mag))


def test_rtisi_la_offline_matches_the_jax_package():
    mag = magnitudes(2, 2000)  # 16 frames
    ours = ref_rt.offline(torch.from_numpy(mag), torch.from_numpy(WINDOW), HOP, 3, 10, 0.99)
    theirs = jax_rtisi(mag)
    assert ours.shape == theirs.shape
    assert rel(ours.numpy(), theirs) < 10 * chaos(mag)


def test_rtisi_stream_matches_the_jax_streamer():
    mag = magnitudes(2, 2000)
    B, F, T = mag.shape
    st = specinv_tpu.RTISIStreamer(F, look_ahead=3, max_iter=10, batch=B, dtype=np.float64,
                                   window=WINDOW, hop_length=HOP)
    theirs = [np.asarray(o) for t in range(T) if (o := st.push(mag[:, :, t])) is not None]
    theirs = np.concatenate(theirs + [np.asarray(st.flush())], axis=1)
    m = torch.from_numpy(mag)
    w = torch.from_numpy(WINDOW)
    state = ref_rt.initial_state(m[:, :, 0], 3, HOP)
    pending = [torch.zeros_like(m[:, :, 0])] * 3
    ola, warmup, out = torch.zeros(B, N, dtype=torch.float64), 3, []
    for t in range(T):
        pending.append(m[:, :, t])
        state, committed = ref_rt.step(state, torch.stack(pending, 1), w, HOP, 10, 0.99)
        pending.pop(0)
        if warmup:
            warmup -= 1
            continue
        samples, ola = ref_rt.emit(ola, committed, w, HOP)
        out.append(samples)
    out.append(ref_rt.flush(state, ola, torch.stack(pending, 1), warmup, w, HOP, 10, 0.99))
    ours = torch.cat(out, 1).numpy()
    assert ours.shape == theirs.shape
    assert rel(ours, theirs) < 10 * chaos(mag)


def test_references_import_nothing_of_either_package():
    folder = Path(__file__).resolve().parents[1] / "reference"
    for path in folder.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "specinv_tpu", "specinv_tpu_torch"), \
                    f"{path.name} imports {name}"
