"""sc / snr / ser of specinv_tpu_torch against specinv_tpu in float64
(atol 1e-10 relative to the value: both are a few float64 reductions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import specinv_tpu as si
import specinv_tpu_torch as st


@pytest.mark.parametrize("name", ["sc", "snr", "ser", "spectral_convergence"])
@pytest.mark.parametrize("shape", [(257, 40), (3, 129, 20)])
def test_metric_matches_jax(name, shape):
    rng = np.random.default_rng(3)
    tgt = np.abs(rng.standard_normal(shape))
    inp = tgt + 0.1 * rng.standard_normal(shape)
    ref = float(getattr(si, name)(jnp.asarray(inp), jnp.asarray(tgt)))
    ours = float(getattr(st, name)(torch.from_numpy(inp), torch.from_numpy(tgt)))
    assert abs(ours - ref) <= 1e-10 * abs(ref)


def test_snr_target_norm_quirk():
    """Both sides are normalized by the TARGET norm: scaling the input moves
    the SNR, as in the reference."""
    tgt = torch.ones(4, 4, dtype=torch.float64)
    assert float(st.snr(2 * tgt, tgt)) == pytest.approx(-10 * np.log10(1.0))


def test_get_metric_rejects_unknown():
    from specinv_tpu_torch.metrics import get_metric

    with pytest.raises(ValueError):
        get_metric("lsd")
