"""The module that holds the direct-DFT ADMM kernel, on the CPU, and the
slice's path ADMM(backend='dft') as a whole.

The port's fused_admm_iteration takes its plain version for CPU tensors; it
is held against the JAX kernel admm_fused.fused_admm_iteration run in Pallas
interpret mode, from one state carried across by convert.dft_state_from_jax
(the setup of tests/test_torch_gl_fused.py: n_fft 512, hop 128, B=2, 61
frames of white noise, a random-phase Y plane, rho 0.1), at 1 and 3 chained
iterations, in the tiers JAX computes as written on the CPU (HIGH,
'bf16x2', 'bf16x2t', HIGHEST), in every pad mode, with center=False, with
normalized=True, and with valid_t = T and T - 5.

Tolerances, relative to the largest value of the JAX output, come from a
float64 run of the port's plain version with the same splits: each is twice
the largest sum, over these cases, of the JAX kernel's and the port's
float32 distance from it, rounded up to one digit.  ADMM's dual integrates
rounding, so Y drifts most: after 3 iterations under HIGH the JAX kernel and
the port lie 7.2e-4 / 3.9e-4 of the max from float64 (x 1.9e-5 / 1.9e-5),
and under 'bf16x2', which rounds Y'w to bf16 for the inverse, 3.3e-2 /
4.3e-2.  The DEFAULT tier is held against numpy (one bf16 pass, float64 sums).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st
from specinv_tpu.ops.pallas import admm_fused as j_admm_fused
from specinv_tpu_torch import convert
from specinv_tpu_torch.ops import twins
from specinv_tpu_torch.ops.cuda import admm_fused
from specinv_tpu_torch.ops.framing import pad_center
from specinv_tpu_torch.ops.stft import istft

from .test_torch_gl_fused import (
    B, CASES, HIGH, HIGHEST, HOP, N_FFT, _close, _setup, _spec_pair, _twin_vjp_case,
    numpy_default_iteration,
)

tadmm = importlib.import_module("specinv_tpu_torch.models.admm")

RHO = 0.1

# JAX precision, the port's, and the limits {iterations: (x, |R|, Y)}
TIERS = {
    "high": (HIGH, "high", {1: (2e-5, 4e-6, 2e-4), 3: (8e-5, 3e-4, 3e-3)}),
    "bf16x2": ("bf16x2", "bf16x2", {1: (5e-4, 2e-6, 3e-5), 3: (2e-2, 2e-2, 2e-1)}),
    "bf16x2t": ("bf16x2t", "bf16x2t", {1: (2e-5, 4e-6, 2e-4), 3: (3e-4, 4e-4, 7e-3)}),
    "highest": (HIGHEST, "highest", {1: (2e-5, 3e-6, 1e-4), 3: (3e-5, 4e-5, 6e-4)}),
}


def _check(tier, case, drop):
    jprec, tprec, limits = TIERS[tier]
    jc, tc, w, T, geo, (jx, jy_re, jy_im, tp, j_env), (x, y, tgt, win, env) = _setup(CASES[case])
    valid_t = T - drop
    for it in (1, 2, 3):
        jx, jmag, jy_re, jy_im = j_admm_fused.fused_admm_iteration(
            jx, jy_re, jy_im, tp, jnp.asarray(w), j_env, jnp.float32(RHO), jc, valid_t, geo.e,
            block_t=geo.block_t, interpret=True, precision=jprec)
        x, mag, y = admm_fused.fused_admm_iteration(x, y, tgt, win, env, RHO, tc, valid_t, tprec)
        if it in limits:
            rx, ry, rmag = convert.dft_state_from_jax(jx, jy_re, jy_im, jmag, N_FFT, T)
            lx, lmag, ly = limits[it]
            _close(x.numpy(), rx, lx, f"x after {it}")
            _close(mag.numpy(), rmag, lmag, f"|R| after {it}")
            _close(y.numpy(), ry, ly, f"Y after {it}")
    if drop:
        assert not y[:, valid_t:].any()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_iteration_matches_jax_kernel(tier, case):
    _check(tier, case, 0)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_valid_t_below_T_matches_jax_kernel(tier):
    """Frames past valid_t get Y' = 0 on both sides, and the inverse drops
    them."""
    _check(tier, "reflect", 5)


def test_default_tier_matches_numpy_one_bf16_pass():
    """One bf16 pass (JAX computes DEFAULT in float32 on the CPU, so numpy is
    the reference): x within 2e-4 of the max, |R| within 1e-5 and Y within
    2e-4 (P = Y'w is float32 on the port's side, float64 in numpy, so a bin
    may round to the neighbouring bf16 value; measured 3e-5, 8e-7, 3e-5)."""
    for case, drop in (("reflect", 0), ("circular", 0), ("normalized", 3)):
        _, tc, _, T, _, _, (x, y, tgt, win, env) = _setup(CASES[case])
        ox, omag, oy = admm_fused.fused_admm_iteration(x, y, tgt, win, env, RHO, tc, T - drop,
                                                       "default")
        rx, rmag, ry = numpy_default_iteration(
            x.numpy(), y.numpy().astype(np.complex128), tgt.numpy().astype(np.float64),
            win.numpy().astype(np.float64), env.numpy().astype(np.float64), RHO, tc,
            twins.make_geometry(tc, T), admm=True, valid_t=T - drop)
        _close(ox.numpy(), rx, 2e-4, f"{case} x")
        _close(omag.numpy(), rmag, 1e-5, f"{case} |R|")
        _close(oy.numpy(), ry, 2e-4, f"{case} Y")


@pytest.mark.parametrize("kw", [
    dict(max_iter=6, tol=0.0),
    dict(max_iter=12, tol=1.0, eva_iter=3),
], ids=["tol0", "early_stop"])
def test_dft_backend_matches_jax_pallas(kw):
    """ADMM(backend='dft') against the JAX backend='pallas' (interpret mode)
    from the same complex seed of speech-like clips, at HIGH: within 7e-4 of
    the largest sample, twice the sum of both sides' distance from a float64
    run of the 'fft' path after 6 iterations (1.7e-4 JAX, 1.8e-4 port).  The
    early-stopping run stops at its second evaluation, iteration 6: ADMM's
    dual integrates rounding, and by 10 iterations every float32 path, the
    'fft' path included, lies about 1e-2 from float64."""
    spec, win = _spec_pair()
    kw = dict(kw, rho=RHO, hop_length=HOP, window=win, verbose=False)
    ref = np.asarray(si.ADMM(spec, backend="pallas", precision=HIGH, **kw))
    ours = st.ADMM(torch.from_numpy(spec), backend="dft", **kw)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=7e-4 * np.abs(ref).max(), rtol=0)


def test_dft_modes_agree_and_early_stop_freezes():
    spec, win = _spec_pair(1)
    mag = torch.from_numpy(np.abs(spec))
    kw = dict(max_iter=60, tol=1.0, eva_iter=5, verbose=False, hop_length=HOP, window=win,
              backend="dft")
    a = st.ADMM(mag, mode="fori", **kw)
    b = st.ADMM(mag, mode="while", **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = st.ADMM(mag, **dict(kw, max_iter=10, tol=0.0))
    torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_precision_pairs_raise():
    """The JAX ADMM kernel hands precision to every product whole, and
    lax.dot_general refuses a pair that holds a scheme string; the port
    raises for every pair."""
    spec, win = _spec_pair(1)
    mag = torch.from_numpy(np.abs(spec))
    kw = dict(max_iter=2, verbose=False, hop_length=HOP, window=win, backend="dft")
    with pytest.raises(ValueError, match="pair"):
        st.ADMM(mag, precision=("high", "bf16x2"), **kw)
    with pytest.raises(ValueError):
        si.ADMM(np.abs(spec), precision=(HIGH, "bf16x2"),
                **dict(kw, backend="pallas", window=win))
    _, tc, _, T, _, _, (x, y, tgt, w, env) = _setup({})
    with pytest.raises(ValueError, match="pair"):
        admm_fused.fused_admm_iteration(x, y, tgt, w, env, RHO, tc, T, ("high", "high"))
    assert st.ADMM(mag, precision="bf16x2", **kw).shape[-1] > 0


def test_iteration_gradient_is_the_highest_twin():
    _, tc, _, T, _, _, (x, y, tgt, win, env) = _setup({})
    geo = twins.make_geometry(tc, T)
    rng = np.random.default_rng(1)
    cx = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    cy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.complex64))

    def loss(xo, yo):  # linear: its gradient does not depend on the forward values
        return (xo * cx).sum() + (yo * cy).real.sum()

    grads = []
    for run in ("kernel_wrapper", "twin"):
        x0 = x.clone().requires_grad_(True)
        t0 = tgt.clone().requires_grad_(True)
        if run == "twin":
            (xo, yo), _ = twins.admm_dft_twin((x0, y), t0, win, env, RHO, tc, geo, T - 2, "highest")
        else:
            xo, _mag, yo = admm_fused.fused_admm_iteration(x0, y, t0, win, env, RHO, tc, T - 2,
                                                           "bf16x2t")
        grads.append(torch.autograd.grad(loss(xo, yo), (x0, t0)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_twin_vjp_matches_jax_twin_f64():
    """The backward of one iteration, admm_dft_twin at 'highest', against
    jax.vjp of the JAX backward rule admm_xla_twin at HIGHEST, in float64
    from the same state and cotangent, with valid_t = T - 3: within 1e-7 of
    the largest entry (float64 rounding, amplified where |T'| is small;
    measured 1.2e-9)."""
    from specinv_tpu.models._pallas_driver import admm_xla_twin

    jc, tc, w, T, geo, jstate, jtp, j_env, (cx, cp), (x, y, tgt, win, env) = _twin_vjp_case()
    _, vjp = jax.vjp(lambda s, t: admm_xla_twin(s, t, jnp.asarray(w, jnp.float64), j_env, RHO,
                                                jc, geo, T - 3, HIGHEST)[0], jstate, jtp)
    (jgx, _, _), jgt = vjp((jnp.asarray(cx), jnp.asarray(cp[0]), jnp.asarray(cp[1])))
    x.requires_grad_(True)
    tgt.requires_grad_(True)
    (xo, yo), _ = twins.admm_dft_twin((x, y), tgt, win, env, RHO, tc, twins.make_geometry(tc, T),
                                      T - 3, "highest")
    lp, F = x.shape[-1], tgt.shape[-1]
    cy = torch.complex(*(torch.from_numpy(c[:, :T, :F]) for c in cp))
    gx, gt = torch.autograd.grad((xo, yo), (x, tgt), (torch.from_numpy(cx[:, :lp]), cy))
    _close(gx.numpy(), np.asarray(jgx)[:, :lp], 1e-7, "d/dx")
    _close(gt.numpy(), np.asarray(jgt)[:, :T, :F], 1e-7, "d/dtarget")


def test_dft_path_gradient_is_the_highest_twin_chain():
    """A gradient through ADMM's 'dft' path (run_tm_dft, 3 iterations at
    'highest') equals plain autograd through 3 calls of the twin."""
    _, tc, _, T, _, _, (_, y0, tgt, win, _) = _setup({})
    geo = twins.make_geometry(tc, T)
    c = torch.from_numpy(np.random.default_rng(2).standard_normal((B, geo.l_out)).astype(np.float32))
    grads = []
    for how in ("path", "twin"):
        t = tgt.clone().requires_grad_(True)
        if how == "path":
            y = tadmm.run_tm_dft(t, y0, win, RHO, 0.0, tc, max_iter=3, precision="highest")
        else:
            env = twins.make_inv_env(tc, win, T, geo)
            state = (pad_center(istft(y0, tc, win), tc), y0)
            for _ in range(3):
                state, _mag = twins.admm_dft_twin(state, t, win, env, RHO, tc, geo, T, "highest")
            y = state[0][..., geo.p_amt : geo.p_amt + geo.l_out]
        grads.append(torch.autograd.grad((y * c).sum(), t)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6 * float(grads[1].abs().max()))
