"""The cells at a size a CPU test holds: the configurations' geometry
(n_fft 2048, hop 512, the same iterations), short clips, two clips or
streams.  On the CPU the port runs its kernels' plain versions; the calls
ask for the kernel path by name, since ``'auto'`` picks the ``torch.fft``
path there."""
import torch

from portbench import core

SMALL = {
    "gl2048_batch64": dict(clip_seconds=0.5, batch=2, pool=2, check_calls=2, warmup_calls=1,
                           call=dict(max_iter=100, verbose=False, backend="kernel")),
    "rtisi2048_stream16": dict(clip_seconds=0.3, streams=2, pool=2, warmup_pushes=4,
                               check_rate=0.5, start_rate=1.0, flush_rate=1.0,
                               call=dict(look_ahead=3, max_iter=25, alpha=0.99,
                                         asymmetric_window=False, backend="kernel")),
    # 0.3 s: 13 frames, 16 steps, two launches of the kernel path (8 steps each).  The
    # kernel's plain version transforms in float32, which eight chained steps amplify to a
    # chain_p50 of about 0.6 (the card's kernel transforms in FP64: 0.15-0.18), so the CPU
    # holds that number at 1.0; the control reads 1.3-1.4 there and fails the others.
    "rtisi2048_batch16": dict(clip_seconds=0.3, batch=2, pool=2, check_calls=2, warmup_calls=1,
                              units_per_call=16,
                              call=dict(look_ahead=3, max_iter=25, alpha=0.99,
                                        asymmetric_window=False, backend="kernel"),
                              limits=dict(feed_dist=1e-4, step_p75=1e-4, chain_p50=1.0,
                                          wave_dist=1e-4)),
}


def run_small(cell, seed=2**31 + 3, seconds=3.0, trace=False):
    """``(result, checks, run)`` of one run of ``cell`` on the CPU at a small size,
    on one thread (as ``run.py`` runs), so that parallel test workers do not
    starve each other's windows."""
    torch.set_num_threads(1)
    return core.execute(cell, seed, seconds, trace, device="cpu", overrides=SMALL[cell],
                        log=lambda *_: None)
