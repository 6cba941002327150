"""The port's utilities against the JAX package's: checkpoints
(``utils/checkpoint``: round trip, structure mismatch, dict leaf order, and
an ``ADMMState`` saved by either package loaded by the other), the
throughput timer and the trace (``utils/profiling``), and the debug guards
(``utils/guards``: the zero-envelope check planted in ``istft`` raises in
both packages on the same window / hop inside ``debug_checks()`` and not
outside it; ``checked`` raises on a non-finite output)."""
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu.models.admm import ADMMState as JADMMState
from specinv_tpu.utils import checkpoint as jck
from specinv_tpu.utils import guards as jguards
from specinv_tpu_torch.models.admm import ADMMState
from specinv_tpu_torch.utils import checkpoint as ck
from specinv_tpu_torch.utils import guards, profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and more threads only
    contend with the suite's other workers (3x slower under a loaded host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _admm_state(rng, pkg):
    planes = [rng.standard_normal((1, 4, 5)) + 1j * rng.standard_normal((1, 4, 5))
              for _ in range(3)]
    x = rng.standard_normal((1, 24))
    if pkg == "jax":
        return JADMMState(*(jnp.asarray(a) for a in (*planes, x)))
    return ADMMState(*(torch.from_numpy(a) for a in (*planes, x)))


def test_checkpoint_roundtrip(tmp_path):
    state = (torch.arange(10.0), {"b": torch.ones(2, 3, dtype=torch.complex64) * (1 + 2j),
                                  "a": torch.tensor(3, dtype=torch.int64)})
    p = tmp_path / "ck.npz"
    ck.save_state(p, state)
    like = (torch.zeros(10), {"b": torch.zeros(2, 3, dtype=torch.complex64),
                              "a": torch.zeros((), dtype=torch.int64)})
    restored = ck.load_state(p, like)
    assert list(restored[1]) == ["b", "a"]  # the template's key order
    for got, want in zip(torch.utils._pytree.tree_leaves(restored),
                         torch.utils._pytree.tree_leaves(state)):
        assert got.dtype == want.dtype and got.device == torch.device("cpu")
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_checkpoint_structure_mismatch(tmp_path):
    p = tmp_path / "ck.npz"
    ck.save_state(p, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="1 leaves"):
        ck.load_state(p, {"a": torch.zeros(3), "b": torch.zeros(2)})


def test_checkpoint_dict_order_is_jaxs(tmp_path):
    """Dict leaves in sorted-key order, as jax.tree_util flattens them."""
    state = {"z": np.arange(3.0), "a": np.arange(2.0), "m": {"y": np.ones(1), "b": np.zeros(4)}}
    ck.save_state(tmp_path / "port.npz", torch.utils._pytree.tree_map(torch.from_numpy, state))
    jck.save_state(str(tmp_path / "jax.npz"), state)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_admm_state_crosses_packages(tmp_path, direction):
    rng = np.random.default_rng(0)
    p = str(tmp_path / "admm.npz")
    if direction == "jax to port":
        state = _admm_state(rng, "jax")
        jck.save_state(p, state)
        got = ck.load_state(p, _admm_state(np.random.default_rng(1), "port"))
        assert isinstance(got, ADMMState)
    else:
        state = _admm_state(rng, "port")
        ck.save_state(p, state)
        got = jck.load_state(p, _admm_state(np.random.default_rng(1), "jax"))
        assert isinstance(got, JADMMState)
    for name in ADMMState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(state, name)))


def test_throughput_timer():
    tp = profiling.Throughput()
    out = tp.measure(lambda: torch.ones(4) * 2, iters=100)
    assert tp.iters_per_sec > 0 and tp.seconds > 0
    torch.testing.assert_close(out, 2 * torch.ones(4))
    assert tp.iters_per_sec == pytest.approx(100 / tp.seconds)


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("block"):
            torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and "block" in files[0].read_text()
    assert any(e.name == "block" for e in prof.events())
    json.loads(files[0].read_text())


# hop > win_length leaves gaps between frames: the envelope has zeros (n_fft
# 128 from the 65 bins; the JAX package also takes n_fft=128, the port
# refuses an n_fft keyword)
GAPPY = dict(win_length=64, hop_length=100, center=False, max_iter=2, tol=0.0, verbose=False)


def test_zero_envelope_check_raises_in_both_packages():
    mag = np.abs(np.random.default_rng(0).standard_normal((65, 12)))
    with jguards.debug_checks():
        with pytest.raises(Exception, match="envelope contains zeros"):
            jguards.checked(lambda m: si.griffin_lim(m, n_fft=128, **GAPPY))(jnp.asarray(mag))
    with guards.debug_checks():
        assert guards.debug_checks_enabled()
        with pytest.raises(guards.CheckError, match="envelope contains zeros"):
            guards.checked(lambda m: st.griffin_lim(m, **GAPPY))(torch.from_numpy(mag))
    assert not guards.debug_checks_enabled()
    # outside debug_checks() the envelope's zeros are replaced by 1, as before
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        y = guards.checked(lambda m: st.griffin_lim(m, **GAPPY))(torch.from_numpy(mag))
    assert bool(torch.isfinite(y).all())
    # and a healthy configuration passes inside
    with guards.debug_checks():
        y = guards.checked(lambda m: st.griffin_lim(m, max_iter=2, tol=0.0,
                                                    verbose=False))(torch.from_numpy(mag))
    assert bool(torch.isfinite(y).all())


def test_check_and_checked():
    guards.check(False, "never read outside debug_checks")
    with guards.debug_checks():
        guards.check(torch.tensor(True), "fine")
        with pytest.raises(guards.CheckError, match="bad 3"):
            guards.check(torch.tensor(False), "bad {n}", n=3)
    with pytest.raises(guards.CheckError, match="non-finite"):
        guards.checked(lambda: (torch.ones(2), torch.tensor([1.0, float("nan")])))()
    assert guards.checked(lambda: torch.ones(2))().sum() == 2


def test_exports_cover_the_jax_package():
    assert set(si.__all__) <= set(st.__all__)
    for name in si.__all__:
        assert getattr(st, name) is not None


def test_port_imports_no_jax():
    """Every module of the port (the CLI, io and utilities included) imports
    without JAX or the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import specinv_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'specinv_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'specinv_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=str(root)))
