"""What the drivers share: the window, the magnitudes, the program's entry,
the seeded choice of what the check compares, the program's internals that
a check reads (``internal``, ``Tap``) and the memory kept for it.

The benchmark makes every input itself on the run's device and hands the
same to the program and to the reference: a periodic hann window rounded to
float32 (the reference reads the same values in float64) and the float32
magnitudes of the clips' STFT, taken in float64.
"""
from __future__ import annotations

import math

import torch

from .reference._signal import stft
from .traffic import speech


def sync(run) -> None:
    """Wait for the card (a call's output is ready only then)."""
    if run.device == "cuda":
        torch.cuda.synchronize()


def hann(n: int, device):
    """The periodic hann window: ``(float32, the same values in float64)``."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    w32 = (0.5 - 0.5 * torch.cos(2 * math.pi * k / n)).float()
    return w32, w32.double()


def clip_samples(config: dict) -> int:
    return round(config["clip_seconds"] * config["sample_rate"])


def magnitudes(config: dict, count: int, seed: int, device) -> torch.Tensor:
    """``count`` distinct clips' magnitudes ``(count, F, T)``, float32."""
    clips = speech.clips(count, clip_samples(config), seed, device, config["sample_rate"])
    _, w64 = hann(config["n_fft"], device)
    mag = stft(clips, w64, config["hop_length"]).abs()
    return mag.transpose(-1, -2).float().contiguous()


def entry(config: dict, driver: str):
    """The program's entry point that the configuration runs under
    ``driver`` (``config["entry"][driver]``)."""
    import specinv_tpu_torch

    return getattr(specinv_tpu_torch, config["entry"][driver])


def internal(obj, name: str, what: str):
    """``obj.name``, an internal of the program that a check reads; fails
    with the check's need spelled out where the program no longer has it."""
    if not hasattr(obj, name):
        raise RuntimeError(f"portbench's check reads {what} as {type(obj).__name__}.{name}, "
                           f"which the program no longer has: the check needs updating")
    return getattr(obj, name)


class Tap:
    """While installed, keeps the arguments and the result of every call of
    the function ``name`` of the program's module ``module`` (a dotted
    name) that the program calls through that module."""

    def __init__(self, module: str, name: str):
        import importlib

        self.module = importlib.import_module(module)
        self.inner = internal(self.module, name, f"the launches of {module}")
        self.name, self.calls = name, []

    def __enter__(self):
        def tapped(*args):
            out = self.inner(*args)
            self.calls.append((args, out))
            return out
        setattr(self.module, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def chosen(seed: int, rate: float, count: int = 1 << 20) -> set:
    """Which of the first ``count`` calls or pushes the check compares: a
    seeded draw at ``rate``, independent of how fast the window runs."""
    gen = torch.Generator().manual_seed((int(seed) * 2654435761 + 97) % (1 << 63))
    return set(torch.nonzero(torch.rand(count, generator=gen) < rate).flatten().tolist())


def reserve(device, sizes, copies: int) -> None:
    """Let the caching allocator hold ``copies`` blocks of each of ``sizes``
    bytes more, so that what the check keeps from the window (outputs and
    states the program would free) is not allocated from the driver inside
    it.  The blocks take the sizes of what is kept, since the allocator
    serves blocks up to 1 MB from a pool of their own.  The peak of
    allocated memory is counted from here on."""
    if device != "cuda":
        return
    blocks = [torch.empty(size, dtype=torch.uint8, device=device)
              for size in sizes for _ in range(copies)]
    del blocks
    torch.cuda.reset_peak_memory_stats()
