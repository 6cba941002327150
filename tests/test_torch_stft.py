"""STFT layer of specinv_tpu_torch against specinv_tpu in float64, and the
ops layer's imports.

Tolerance: atol 1e-10 relative to the max of the JAX output (both sides use
pocketfft-class float64 FFTs; the differences are summation order).
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specinv_tpu import transforms as jtr
from specinv_tpu.config import canonicalize as jcanon
from specinv_tpu.ops import framing as jfr
from specinv_tpu.ops import stft as jst
from specinv_tpu_torch import transforms as ttr
from specinv_tpu_torch.config import canonicalize as tcanon
from specinv_tpu_torch.ops import framing as tfr
from specinv_tpu_torch.ops import stft as tst

from .helpers import make_signal

REL = 1e-10


def _close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=REL * max(np.abs(ref).max(), 1e-300), rtol=0)


def _configs(bins, **kw):
    jc, w = jcanon(bins, np.float64, **kw)
    tc, _ = tcanon(bins, np.float64, **kw)
    return jc, tc, w


@pytest.mark.parametrize("nfft", [128, 256, 512])
@pytest.mark.parametrize("center,pad_mode", [
    (True, "reflect"), (True, "constant"), (True, "replicate"), (True, "circular"),
    (False, "reflect"),
])
def test_stft_istft_envelope(nfft, center, pad_mode):
    x = make_signal((2, 4410))
    win = np.hanning(nfft + 1)[:-1]
    jc, tc, w = _configs(nfft // 2 + 1, window=win, center=center, pad_mode=pad_mode)
    js = jst.stft(jnp.asarray(x), jc, jnp.asarray(w))
    ts = tst.stft(torch.from_numpy(x), tc, torch.from_numpy(w))
    _close(ts, js)
    T = js.shape[-2]
    _close(tst.make_envelope(tc, torch.from_numpy(w), T), jst.make_envelope(jc, jnp.asarray(w), T))
    _close(tst.istft(ts, tc, torch.from_numpy(w)), jst.istft(js, jc, jnp.asarray(w)))


@pytest.mark.parametrize("hop", [None, 100])
@pytest.mark.parametrize("win_length", [None, 300])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("onesided", [True, False])
def test_public_transforms_kwarg_grid(hop, win_length, normalized, onesided):
    x = make_signal((2, 4410))
    kw = dict(hop_length=hop, win_length=win_length, normalized=normalized, onesided=onesided)
    js = jtr.stft(jnp.asarray(x), 512, **kw)
    ts = ttr.stft(torch.from_numpy(x), 512, **kw)
    _close(ts, js)
    _close(ttr.istft(ts, **kw), jtr.istft(js, **kw))
    _close(ttr.istft(ts, length=4410, **kw), jtr.istft(js, length=4410, **kw))


def test_stft_matches_torch_stft():
    x = make_signal((4410,))
    win = torch.hann_window(512, dtype=torch.float64)
    ref = torch.stft(torch.from_numpy(x), 512, window=win, return_complex=True)
    ours = ttr.stft(torch.from_numpy(x), 512, window=win)
    torch.testing.assert_close(ours, ref, atol=1e-8, rtol=0)


def test_framing_primitives():
    x = make_signal((3, 1000))
    jc, tc, _ = _configs(257, hop_length=96, pad_mode="replicate")
    _close(tfr.pad_center(torch.from_numpy(x), tc), jfr.pad_center(jnp.asarray(x), jc))
    fr = jfr.frame(jnp.asarray(x), 300, 96)
    _close(tfr.frame(torch.from_numpy(x), 300, 96), fr)
    _close(tfr.overlap_add(torch.from_numpy(np.asarray(fr)), 96), jfr.overlap_add(fr, 96))
    w2 = np.hanning(300) ** 2
    _close(tfr.ola_envelope(torch.from_numpy(w2), 9, 96), jfr.ola_envelope(jnp.asarray(w2), 9, 96))


def test_zero_envelope_warns_and_is_guarded():
    """hann + center=False leaves a zero envelope at sample 0: the port warns
    with the JAX package's message and divides by 1 there, as JAX does."""
    x = make_signal((4410,))
    win = np.hanning(257)[:-1]
    jc, tc, w = _configs(129, window=win, center=False)
    js = jst.stft(jnp.asarray(x), jc, jnp.asarray(w))
    with pytest.warns(RuntimeWarning, match="OLA envelope contains zeros"):
        ours = tst.istft(torch.from_numpy(np.asarray(js)), tc, torch.from_numpy(w))
    _close(ours, jst.istft(js, jc, jnp.asarray(w)))


def test_istft_rejects_real_input():
    with pytest.raises(TypeError):
        ttr.istft(torch.zeros(257, 10))


ENTRY_POINTS = ("stft", "istft", "griffin_lim", "ADMM", "phase_init", "RTISI_LA",
                "RTISIStreamer")


def _call_entry(name, to):
    """Call the public entry point ``name`` on a small input passed through
    ``to`` (numpy array -> the argument)."""
    import specinv_tpu_torch as st

    x = make_signal((2000,), dtype=np.float32)
    spec = ttr.stft(torch.from_numpy(x), 256).numpy()
    mag = np.abs(spec)
    quiet = dict(max_iter=1, verbose=False)
    calls = {
        "stft": lambda: ttr.stft(to(x), 256),
        "istft": lambda: ttr.istft(to(spec)),
        "griffin_lim": lambda: st.griffin_lim(to(mag), **quiet),
        "ADMM": lambda: st.ADMM(to(mag), **quiet),
        "phase_init": lambda: st.phase_init(to(mag)),
        "RTISI_LA": lambda: st.RTISI_LA(to(mag), **quiet),
        "RTISIStreamer": lambda: st.RTISIStreamer(129, look_ahead=0, max_iter=1).push(
            to(mag[:, 0])),
    }
    return calls[name]()


class _Placed(Exception):
    """Raised by the spy below in place of a tensor on the card."""


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_array_input_goes_to_the_card(monkeypatch, name):
    """With a card, an array input is placed on it, and a CPU tensor stays
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    as_tensor = torch.as_tensor

    def spy(data, *args, device=None, **kwargs):
        if device is not None and torch.device(device).type == "cuda":
            raise _Placed(torch.device(device))
        return as_tensor(data, *args, device=device, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", spy)
    with pytest.raises(_Placed) as placed:
        _call_entry(name, lambda a: a)
    assert placed.value.args[0].type == "cuda"
    out = _call_entry(name, torch.from_numpy)
    assert out.device.type == "cpu"


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_array_input_without_card_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="pass a CPU tensor"):
        _call_entry(name, lambda a: a)


@pytest.mark.parametrize("n", [2048, 400, 255])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_real_ends_only_moves_what_the_cpu_irfft_ignores(n, dtype):
    """``fourier.inverse`` zeroes the imaginary parts of the DC and Nyquist
    bins only on the card: the CPU's ``irfft`` never reads them, so there
    the zeroed and the raw spectrum give the same bits, and their gradients
    agree; the mask touches nothing else."""
    from specinv_tpu_torch.ops import fourier

    gen = torch.Generator().manual_seed(n)
    spec = torch.randn(3, 17, n // 2 + 1, dtype=dtype, generator=gen)
    ends = fourier._real_ends(spec, n)
    changed = (ends != spec).any(dim=(0, 1))
    assert changed.nonzero().flatten().tolist() == ([0, n // 2] if n % 2 == 0 else [0])
    assert not ends.imag[..., 0].any() and torch.equal(ends.real, spec.real)
    assert torch.equal(torch.fft.irfft(ends, n=n), torch.fft.irfft(spec, n=n))
    grads = []
    for f in (lambda s: fourier._real_ends(s, n), lambda s: s):
        s = spec.clone().requires_grad_()
        torch.fft.irfft(f(s), n=n).square().sum().backward()
        grads.append(s.grad)
    assert torch.equal(*grads)


def test_public_transforms_take_jax_precision():
    """``stft`` / ``istft`` name their parameters as JAX does, in JAX's
    order; every precision JAX's XLA rule accepts gives the outputs of None
    (torch.fft ignores it), and every one it rejects raises ValueError in
    both (``fourier.check_precision``)."""
    import inspect

    from specinv_tpu.ops import fourier as jfourier

    for ours, ref in ((ttr.stft, jtr.stft), (ttr.istft, jtr.istft)):
        assert list(inspect.signature(ours).parameters) == list(inspect.signature(ref).parameters)
    x = torch.from_numpy(make_signal((2, 3000), np.float32, seed=5))
    spec = ttr.stft(x, 512)
    y = ttr.istft(spec, length=3000)
    for p in ("default", "high", "highest", "HIGH", "Default"):
        assert torch.equal(ttr.stft(x, 512, precision=p), spec)
        assert torch.equal(ttr.istft(spec, length=3000, precision=p), y)
    for bad in ("bf16x2", "bf16x2t", "tf32", ("high", "high")):
        with pytest.raises(ValueError):
            jfourier.check_precision(bad, "fft")
        with pytest.raises(ValueError):
            ttr.stft(x, 512, precision=bad)
        with pytest.raises(ValueError):
            ttr.istft(spec, precision=bad)


@pytest.mark.parametrize("backend", ["matmul", "matmul4"])
def test_xla_dft_backends_name_the_ports_counterpart(backend):
    """stft / istft: JAX computes the DFT as its XLA lowering, the port
    raises naming 'fft'."""
    x = make_signal((2, 3000), np.float32, seed=5)
    spec = jtr.stft(jnp.asarray(x), 256, backend=backend)
    assert np.isfinite(np.asarray(jtr.istft(spec, length=3000, backend=backend))).all()
    with pytest.raises(ValueError, match="the port's counterpart is 'fft'"):
        ttr.stft(torch.from_numpy(x), 256, backend=backend)
    with pytest.raises(ValueError, match="the port's counterpart is 'fft'"):
        ttr.istft(ttr.stft(torch.from_numpy(x), 256), length=3000, backend=backend)


# The one import of the model layer from below it: ``mel_to_audio`` runs the
# port's ``griffin_lim``, imported inside the function when it is called.
LAZY_UPWARD = {("mel.py", "specinv_tpu_torch.models.griffin_lim")}


def _imports(path: Path, package: list):
    """``(module, inside a function)`` for each import in ``path``, relative
    imports resolved against ``package``."""
    tree = ast.parse(path.read_text())
    nested = {id(n) for f in ast.walk(tree)
              if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
              for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(package[: len(package) - node.level + 1] if node.level else [])
            module = ".".join(p for p in (base, node.module) if p)
            names = [module, *(f"{module}.{a.name}" for a in node.names)]
        else:
            continue
        for name in names:
            yield name, id(node) in nested


def test_ops_import_nothing_from_models():
    """No module under ``specinv_tpu_torch/ops/`` imports
    ``specinv_tpu_torch.models``: the kernel wrappers and their plain twins
    sit below the drivers that call them.  Only ``LAZY_UPWARD`` is exempt,
    and only inside a function."""
    ops = Path(tst.__file__).resolve().parent
    upward = set()
    for path in sorted(ops.rglob("*.py")):
        rel = path.relative_to(ops)
        package = ["specinv_tpu_torch", "ops", *rel.parts[:-1]]
        for name, lazy in _imports(path, package):
            if name.split(".")[:2] == ["specinv_tpu_torch", "models"] and not (lazy and any(
                    f == rel.as_posix() and (name + ".").startswith(m + ".")
                    for f, m in LAZY_UPWARD)):
                upward.add((rel.as_posix(), name))
    assert not upward, f"ops/ imports the model layer: {sorted(upward)}"

