#!/usr/bin/env python3
"""How far the JAX package's own float64 CPU trajectories move under a
perturbation of one rounding: the self-golden cases of
``tests/test_quality.py`` (``tests/goldens/self_quality.json``) rerun with the
magnitude times ``1 + 1e-15 * noise``, noise standard normal from numpy
(seeds 0 to ``--draws`` - 1).

The cases whose final SC moves by far more than the goldens' 1e-5 dB band
here are chaotic in float64: no other FFT implementation (the port's
``torch.fft``) can replay them inside that band, and
``tests/test_torch_quality.py`` holds the port there at twice the largest
move this script prints, rounded up to one digit.

``lbfgs_20x10`` is ``l_bfgs`` on ``|stft|`` (20 outer steps of 10 fixed-step
iterations, history 10) from the golden's own start, the ``PRNGKey(0)`` draw.

Run from the root of a checkout on the CPU: ``python3 scripts/quality_chaos.py
[--draws 8] [--cases lbfgs_20x10 ...]``.  Prints one line per case and draw,
then one JSON object with each case's largest move in dB.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CASES = ("gl_500", "admm_25", "admm_200", "rtisi_sym_8", "rtisi_asym_32", "lbfgs_20x10")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=8)
    parser.add_argument("--cases", nargs="+", choices=CASES, default=CASES)
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import specinv_tpu as si
    from specinv_tpu.metrics import sc
    from specinv_tpu.utils.corpus import make_speech_like

    n_fft = 512
    clip = make_speech_like(int(1.2 * 22050), sr=22050, seed=11)
    mag = np.asarray(jnp.abs(si.stft(jnp.asarray(clip, jnp.float64), n_fft=n_fft)))
    golden = json.loads((Path(__file__).resolve().parents[1] / "tests" / "goldens"
                         / "self_quality.json").read_text())
    runs = {
        "gl_500": lambda m: si.griffin_lim(m, max_iter=500, tol=0.0, verbose=False),
        "admm_25": lambda m: si.admm(m, max_iter=25, tol=0.0, verbose=False),
        "admm_200": lambda m: si.admm(m, max_iter=200, tol=0.0, verbose=False),
        "rtisi_sym_8": lambda m: si.rtisi_la(m, look_ahead=3, asymmetric_window=False,
                                             max_iter=8, verbose=False),
        "rtisi_asym_32": lambda m: si.rtisi_la(m, look_ahead=3, asymmetric_window=True,
                                               max_iter=32, verbose=False),
        "lbfgs_20x10": lambda m: si.l_bfgs(
            m, lambda x: jnp.abs(si.stft(x, n_fft=n_fft)), [clip.size], outer_max_iter=20,
            tol=0.0, verbose=False, max_iter=10, lr=1.0, history_size=10),
    }
    worst = {}
    for name in args.cases:
        for seed in range(args.draws):
            noise = np.random.default_rng(seed).standard_normal(mag.shape)
            y = runs[name](mag * (1 + 1e-15 * noise))
            got = float(sc(jnp.abs(si.stft(jnp.asarray(np.asarray(y)), n_fft=n_fft)),
                           jnp.asarray(mag)))
            move = got - golden[name]["sc"]
            worst[name] = max(worst.get(name, 0.0), abs(move))
            print(f"{name} draw {seed}: SC {got:.9f} dB, {move:+.3e} dB from the golden",
                  flush=True)
    print(json.dumps({"largest move (dB)": worst}))


if __name__ == "__main__":
    main()
