#!/usr/bin/env python3
"""Rebuild the RTISI checks' starting states, ``chip_smoke_rtisi_states.npz``.

chip_smoke.py's RTISI checks (phase 3) start from the states the kernel of
commit 789c5b1 reached, where their limits were derived.  This script
reaches them again on a CUDA card, from a checkout of that commit:

    mkdir -p build/parent && git archive 789c5b1 | tar -x -C build/parent
    python3 scripts/torch_rtisi_check_states.py build/parent [out.npz]

It imports that checkout's ``chip_smoke`` and package (whose kernels it
builds there), advances each check's state as that commit's ``chip_smoke``
did (config 3 by 100 steps at batch 1 and 16; each geometry of
``RTISI_SMALL`` by 12 steps, none at hop == n_fft, at batch 2; 8 steps per
launch), writes the states to ``out.npz`` (default
``build/rtisi_check_states.npz``) and compares each array with this
checkout's file, bit for bit.  Exits 1 if one differs.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch_rtisi_check_states: needs a CUDA card")
    parent = Path(sys.argv[1]).resolve()
    out = Path(sys.argv[2]) if len(sys.argv) == 3 else ROOT / "build" / "rtisi_check_states.npz"
    sys.path.insert(0, str(parent))
    import chip_smoke as old  # that commit's, with its package

    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)

    dev = torch.device("cuda", 0)
    states = {}
    for batch in (1, 16):
        cfg, la, tgt, win, st = old.rtisi_state(old.N_FFT, old.HOP, old.N_SAMPLES, batch, dev)
        states[f"cfg3_b{batch}"] = old.rtisi_advance(cfg, la, tgt, win, st, 100)
    for idx, (n_fft, hop, extra) in enumerate(here.RTISI_SMALL):
        extra = {"window": "hamming", **extra}
        cfg, la, tgt, win, st = old.rtisi_state(n_fft, hop, max(7800, 8 * n_fft), 2, dev, **extra)
        states[f"small{idx}"] = old.rtisi_advance(cfg, la, tgt, win, st,
                                                  0 if hop == n_fft else 12)
    arrays = {f"{name}_{part}": t.cpu().numpy()
              for name, st in states.items() for part, t in zip(("keep", "upd", "pre"), st)}
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    stored = here.rtisi_check_states(torch.device("cpu"))
    differ = [name for name, st in states.items()
              if name not in stored or not all(torch.equal(a.cpu(), b)
                                               for a, b in zip(st, stored[name]))]
    print(f"wrote {len(arrays)} arrays to {out}; against {here.RTISI_STATES.name}: "
          + (f"differ in {differ}" if differ or len(stored) != len(states)
             else "every array bit for bit"), flush=True)
    if differ or len(stored) != len(states):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
