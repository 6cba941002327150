"""How kernels E and F count the products they launch, on the CPU.

``ops/cuda/_dft.Launch`` counts each iteration in its kernel module's
``launches`` and the iteration's products on the persistent kernel
(``csrc/dft_iter.cuh`` ``persistent_split_gemm_kernel``: every product in a
bf16 scheme; 'highest' runs ``split_gemm_kernel``) in
``persistent_products``.  Here the C library is a stand-in that takes the
arguments and launches nothing, so no card is needed.
"""
import types

import numpy as np
import pytest
import torch

import specinv_tpu_torch as st
from specinv_tpu_torch.config import canonicalize
from specinv_tpu_torch.ops import dft, twins
from specinv_tpu_torch.ops.cuda import _build, _dft, admm_fused, gl_fused


def _launch(monkeypatch, mod, precision, scalars):
    """One iteration of ``mod``'s kernel through :class:`_dft.Launch` on CPU
    tensors (n_fft 64, hop 16, 2 clips), against a library whose entry
    point records its arguments.  Returns ``(launches, products, n_args)``
    counted by that iteration."""
    calls = []
    entry = mod.KERNEL.entry
    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        **{entry: lambda *args: calls.append(args) or 0}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    cfg, w = canonicalize(33, np.float32, window=np.hanning(65)[:-1], hop_length=16)
    T = 9
    geo = twins.make_geometry(cfg, T)
    window = torch.from_numpy(w).float()
    target = torch.rand(2, T, 33)
    inv_env = twins.make_inv_env(cfg, window, T, geo)
    run = _dft.Launch(mod.KERNEL, target, window, inv_env, cfg, precision, True, scalars)
    before = mod.launches, mod.persistent_products
    run(torch.zeros(2, geo.lp), torch.zeros(2, T, 33, dtype=torch.complex64))
    return mod.launches - before[0], mod.persistent_products - before[1], len(calls[0])


@pytest.mark.parametrize("inv", dft.SCHEMES)
@pytest.mark.parametrize("fwd", dft.SCHEMES)
def test_griffin_lim_counts_each_bf16_product(monkeypatch, fwd, inv):
    """Every (forward, inverse) pair: one launch, a product on the persistent
    kernel for each scheme that is not 'highest', and the C entry point's
    arguments as its signature lists them."""
    got = _launch(monkeypatch, gl_fused, (fwd, inv), (0.5,))
    expect = (fwd != "highest") + (inv != "highest")
    assert got == (1, expect, len(_build._SIGNATURES[gl_fused.KERNEL.entry]))


@pytest.mark.parametrize("scheme", dft.SCHEMES)
def test_admm_counts_each_bf16_product(monkeypatch, scheme):
    got = _launch(monkeypatch, admm_fused, scheme, (0.1, 0))
    expect = 0 if scheme == "highest" else 2
    assert got == (1, expect, len(_build._SIGNATURES[admm_fused.KERNEL.entry]))


@pytest.mark.parametrize("algo,mod", [(st.griffin_lim, gl_fused), (st.ADMM, admm_fused)])
def test_the_cpu_dft_path_counts_no_products(algo, mod):
    """On the CPU the 'dft' backend runs the kernels' plain versions: no
    launch, no product."""
    rng = np.random.default_rng(0)
    mag = torch.from_numpy(np.abs(rng.standard_normal((2, 201, 40))).astype(np.float32))
    before = mod.launches, mod.persistent_products
    algo(mag, max_iter=2, tol=0.0, verbose=False, backend="dft", hop_length=160,
         window=torch.hann_window(400))
    assert (mod.launches, mod.persistent_products) == before
