"""``specinv_tpu_torch.graft_entry`` against the JAX package's
``__graft_entry__.py``.

* ``entry()``: the four Griffin-Lim iterations on the flagship config, run
  on the port's CPU tensors, against JAX's ``entry()`` on the same inputs
  (the same seeded draws), within float32's 1e-4 of the max (read 4.7e-5).
* ``dryrun_multichip(8, device='cpu')`` in a subprocess (8 gloo ranks, a
  2 x 4 mesh): it exits 0 and prints one line naming all eleven variants;
  the mesh and the ten shapes that JAX's own dry run prints (run in-process
  on the 8 virtual devices of ``tests/conftest.py`` while the subprocess
  runs, its line captured) are the port's, with ``'kernel'`` for
  ``'pallas4'``; the port's line adds the global-stop variant.
* A rank that fails makes the call raise.
"""
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from specinv_tpu_torch import graft_entry

ROOT = Path(__file__).resolve().parents[1]
DRYRUN_TIMEOUT_S = 300
VARIANT = re.compile(r"([\w-]+) (\([\d, ]*\))")


def test_entry_matches_jax():
    jfn, jargs = jentry.entry()
    fn, args = graft_entry.entry(device="cpu")
    for ours, ref in zip(args, jargs):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ref = np.asarray(jax.jit(jfn)(*jargs))
    out = fn(*args)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_entry_points_need_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(ValueError, match="device='cpu'"):
        graft_entry.dryrun_multichip(2)


def _parse(line: str):
    """``(mesh, {variant: shape})`` of a dry run's line."""
    head, _, rest = line.partition(", ")
    return head.split("mesh ")[-1], dict(VARIANT.findall(rest))


def test_dryrun_multichip_matches_jax(capsys, monkeypatch):
    proc = subprocess.Popen(
        [sys.executable, "-m", "specinv_tpu_torch.graft_entry", "8", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        monkeypatch.setenv("XLA_FLAGS", "")  # JAX's dry run appends to it
        jentry.dryrun_multichip(8)
        jax_line = capsys.readouterr().out.strip().splitlines()[-1]
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK: ")]
    assert len(lines) == 1, out
    mesh, shapes = _parse(lines[0])
    jax_mesh, jax_shapes = _parse(jax_line)
    assert mesh == jax_mesh == "data=2 x seq=4"
    assert len(shapes) == 11 and len(jax_shapes) == 10
    assert shapes.pop("dp-GL-global-stop") == shapes["dp-GL"]
    assert {name.replace("-kernel", "-pallas4"): s for name, s in shapes.items()} == jax_shapes


def test_dryrun_raises_when_a_rank_fails():
    # one rank on the meta device: no real values, so its first check fails
    with pytest.raises(RuntimeError, match=r"exited with \[1\]"):
        graft_entry.dryrun_multichip(1, device="meta")
