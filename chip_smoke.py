#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: Griffin-Lim
(config 1) and ADMM (config 2) through the whole-run kernels and through the
direct-DFT kernels, Griffin-Lim at n_fft 400 / hop 160 through 'auto',
RTISI-LA offline and streaming (config 3, and at 400 / 160), L-BFGS on a 128-band log-mel
spectrogram (config 4), mel_to_audio, the WAV codec, the command line and
the throughput timer, and the parallel layer: the sequence-parallel
Griffin-Lim and ADMM on a 10-minute clip at world size 1 and 2, their
gradients, batched Griffin-Lim over 256 clips at world size 2, and the
dry run of ``specinv_tpu_torch.graft_entry`` over 8 ranks.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` and no network, and fails (nonzero exit, no result line)
without them.  Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the path from ``specinv_tpu_torch/csrc``;
3. hold each kernel against its plain PyTorch version on the card: the
   device FFT (``csrc/fft.cu``, the half-length real FFT of
   ``csrc/rfft.cuh`` that the whole-run kernels inline), the whole-run
   Griffin-Lim kernel
   (``csrc/gl_fullrun.cu``) and the whole-run ADMM kernel
   (``csrc/admm_fullrun.cu``) at the main paths' shapes (n_fft 2048, hop
   512, 431 frames; 1 and 5 iterations) and, at a batch of 2 small clips, in
   every pad mode, with ``center=False``, with hops that do not divide n_fft,
   ``normalized=True`` and ``onesided=False``; the direct-DFT kernels
   (``csrc/gl_fused.cu``, ``csrc/admm_fused.cu`` on ``csrc/dft_iter.cuh``)
   at config 1 in every precision tier ('high', 'bf16x2', 'bf16x2t',
   'highest', 'default', and a ('high', 'bf16x2') pair for GL) and at batch
   2 on small clips (every pad mode, ``center=False``, ``normalized=True``
   and the C7 geometries 400/160, 512/160, 1024/240) and at 'high' at the
   ``gl400_16k_batch32`` cell's shape (32 chunks of 30 s at 400/160, many
   tiles a CTA of the persistent product kernel; 1 iteration there), 1
   and 5 iterations, each beside a float64 run of the plain version; the
   RTISI-LA kernel
   (``csrc/rtisi_fused.cu``) over 8 steps from a real mid-clip state at
   config 3 (batch 1 and 16) and at small geometries (batch 2), from the
   states of ``chip_smoke_rtisi_states.npz``, and on its mixed-radix
   instance at the ``rtisi400_16k_batch32`` cell's shape (32 chunks of 30 s
   at 16 kHz, 400 / 160, look-ahead 2) from the state after 100 float64
   plain steps, each step a one-step launch
   from the plain version's state beside a float64 run of the plain step,
   and a launch of 8 steps bit for bit against 8 one-step launches; the raw
   per-iteration dispatch of the whole-run
   kernels (the port of ``gl_fused4._kernel`` and
   ``admm_fused4._kernel_iter``) at the world-1 shape of the 10-minute clip
   (25843 frames, ``valid_t`` 25840), at its world-2 shards (12922 frames;
   ADMM with ``valid_t`` of all, 12918 and 0 frames) and on the small set
   with hop 384, 1 and 5 launches beside a float64 plain run;
4. the main paths, each on a 10 s speech-like clip (22.05 kHz, hann, n_fft
   2048, hop 512), with the launch counts set to 0 just before and read
   just after, and the final spectral convergence held against the
   ``torch.fft`` path: ``specinv_tpu_torch.griffin_lim`` and then
   ``specinv_tpu_torch.ADMM`` (rho 0.1), 100 iterations, tol 0, then the
   same call with early stopping, through the whole-run kernels
   (``backend='auto'``) and through the direct-DFT kernels
   (``backend='dft'``, precision 'high'), with the float64 ``torch.fft``
   path's SC beside them; then both for 1000 iterations through
   ``backend='kernel'`` and ``backend='dft'``, each final SC held against
   the float64 ``torch.fft`` path's; ``griffin_lim(backend='auto')`` at n_fft 400 /
   hop 160, which must launch ``gl_fused`` and nothing else;
   ``specinv_tpu_torch.RTISI_LA`` (look-ahead 3, 25 refinements: 55
   launches), then ``RTISIStreamer`` over the same frames (434 launches, the
   offline path's committed frames bit for bit), and both again on 'auto' at
   n_fft 400 / hop 160 (look-ahead 2) on the 10 s clip: every launch on the
   kernel's mixed-radix instance (``rtisi_fused.mixed_radix_launches``),
   the final SC held against the ``torch.fft`` path's, the streamer's
   committed frames the offline path's bit for bit; BASELINE config 4:
   ``specinv_tpu_torch.L_BFGS`` on the clip's 128-band log-mel spectrogram,
   10 outer steps of 20 strong-Wolfe iterations, history 100, float32, again
   with the history in bf16 and with the fixed step, each launching no
   kernel of the port (``torch.fft`` with autograd) and held by its final
   relative log-mel loss against float64 runs of the same path from 5 seeded
   starts, with its ms per outer step, closure evaluations per inner
   iteration, peak memory and idle share (``torch.profiler``);
   ``mel_to_audio`` (128 mels, NNLS 200 iterations, 100 Griffin-Lim
   iterations through ``'auto'``), which must launch kernel A exactly as
   ``griffin_lim`` does, its SC held against a float64 call, its NNLS time
   beside its Griffin-Lim time; the native WAV codec (a round trip of the
   clip), ``python -m specinv_tpu_torch l_bfgs --max-iter 20 --output ...``
   in a subprocess on the card, and ``utils.profiling.Throughput`` against
   CUDA events around the same call; then on a 10-minute clip
   (utils/corpus seed 0, 25840 frames, made with the 256 clips below in
   worker processes during phases 2-3) ``parallel.griffin_lim_seq`` and
   ``admm_seq`` (``'auto'``: one raw launch per iteration, exactly 100, and
   no other kernel), tol 0 and tol 1e-6, at world size 1 in this process
   and at world size 2 in two spawned processes on ``cuda:0`` over gloo (a
   file store under ``build/``; the kernels are built before the spawn),
   world 1 held against the unsharded whole-run call and world 2 against
   world 1 after 5 iterations, and every final SC against a float64 seq
   run; ``batched(griffin_lim)`` at world size 2 over 256 ten-second clips
   bit for bit against one unsharded call, and with ``global_stop`` stopping
   on the unsharded call's iteration; the seq gradients at full width, d
   mean((y - clip)^2) / d spec of 5 iterations (tol 0) from the 10-minute
   clip's SPSI seed: through ``'kernel'`` (exactly 5 raw launches in the
   forward pass and no other kernel; the backward replays the plain twin)
   and ``'fft'`` at world size 1, ``'kernel'`` with ``remat=True``, the
   unsharded ``griffin_lim`` / ``ADMM`` through ``'kernel'``, and in the two
   ranks of world size 2 (the same gradient on both, bit for bit), held
   against each other at limits derived from a float64 ``'fft'`` seq
   gradient and ``'kernel'`` against that gradient at JAX's 5e-2, with the
   forward and backward times per iteration and the peak memory; then
   ``graft_entry.dryrun_multichip(8)``, 8 ranks on ``cuda:0`` over gloo in
   a subprocess, its eleven variants and wall time;
5. marginal microseconds per iteration of the kernel, 'dft' ('high' and
   'highest') and ``torch.fft`` paths of GL and ADMM, and of the 'dft' and
   ``torch.fft`` paths at 400/160, from CUDA events, by differencing 200 and
   100 iterations, and each kernel against its plain version (the
   stand-alone FFT as a CUDA graph of its calls beside the same graph of
   ``torch.fft``, since its device time is below the host's; a direct-DFT
   iteration at config 1/2 and at 400/160, as a CUDA graph and as called,
   beside cuBLAS products of the same shapes timed alike, HIGH's six bf16
   ones and HIGHEST's two float32 ones, a yardstick the port never calls);
   RTISI-LA microseconds per output frame of both
   paths at batch 1 and 16 (a 10 s against a 5 s clip), microseconds per
   streamer push, and the RTISI kernel per launch of 8 steps at batch 1
   and 16 (against its plain version at batch 1), beside its bound over
   the whole card and over the SMs of one stream's thread-block cluster;
   the seq paths' marginal microseconds per iteration (kernel, fft, world 1
   and 2; world 2 time-shares the card, so it is the exchange's cost), the
   batched rate, and one raw launch at the world-1 shape and at the shard
   against its plain version.

The line before the last is ``nvidia-smi``'s name and power limit, the one
before it a JSON object with each kernel's launches, error, times and bound;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
import json
import multiprocessing as mp
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# Clips made in the background, the two ranks' file store and results.
SMOKE_DIR = ROOT / "build" / "chip_smoke"

N_FFT, HOP, N_SAMPLES = 2048, 512, 220500  # 10 s at 22.05 kHz
MAIN_ITERS = 100

# Kernel against plain version, float32 on the card.  Relative to the
# largest value of the plain output: x at 5e-5 (the JAX package's HIGHEST
# band), the state and magnitude planes at 1e-4 (float32 rounding of two
# FFT orders, about 2.5e-5 after 5 iterations in the CPU tests), the eval
# sums at 1e-4, the stand-alone FFT at 1e-5.
X_LIMIT, PLANE_LIMIT, SUM_LIMIT, FFT_LIMIT = 5e-5, 1e-4, 1e-4, 1e-5
# Final SC (dB) of the kernel path against the torch.fft path after 100
# iterations: the same algorithm in float32 through two FFT implementations
# (they agreed within 1e-4 dB on an H100).
SC_BAND_DB = 0.01
# Quality floor of the main path (the repo's check: SC well below -15 dB).
SC_CEILING_DB = -15.0
# ADMM kernel against its plain version, float32, relative to the max.
# ADMM drifts about 10x more than Griffin-Lim because its dual integrates
# rounding, most at 512/160.  A float64 run of the plain version on an H100
# is the anchor: there the kernel lies at most x 3.6e-4, Y 7.8e-4, |R|
# 1.3e-4 from it and the plain float32 version (cuFFT) x 4.6e-4, Y 1.5e-3,
# |R| 3.1e-4, eval sums 1.8e-6 / 3.6e-6 (relative; config 2 at 1 and 5
# iterations and the small set).  Each limit is twice the sum of the two
# sides, rounded up to one digit.  A wrong sign in the update moves x by
# 0.94 of its max (tests/test_torch_admm_fullrun.py).
ADMM_X_LIMIT, ADMM_PLANE_LIMIT, ADMM_SUM_LIMIT = 2e-3, 5e-3, 2e-5
# Final SC (dB) of the ADMM kernel path against the torch.fft path after 100
# iterations.  The kernel path is the DR one-variable form, the fft path the
# literal (X, Y, U, x) chain; over 100 iterations the chain amplifies any
# rounding difference into a different trajectory of about the same
# quality.  On the CPU the two paths ended 0.198 dB apart in float32 and
# 0.067 dB apart in float64; the band is three times the float32 gap.
ADMM_SC_BAND_DB = 0.6
# ADMM quality ceiling: the port's float64 CPU run of the same call ends at
# -27.82 dB; float32 runs of the two paths ended 1.4-1.6 dB from it on the
# CPU, so the ceiling allows 2 dB.
ADMM_SC_CEILING_DB = -25.8
ADMM_RHO = 0.1

# RTISI-LA, BASELINE config 3: look-ahead 3, 25 refinements, alpha 0.99.
RTISI_LA_FRAMES, RTISI_ITERS = 3, 25
# RTISI kernel against its plain version, float32, relative to the plain
# output's max.  RTISI's recursion roughly doubles a rounding difference per
# committed frame, so chained steps would measure chaos, not the kernel:
# each of 8 steps from a real state runs alone, as a one-step launch from
# the plain version's state before it, beside the plain step and a float64
# plain step from the same state; a launch of 8 steps must then equal 8
# chained one-step launches bit for bit.  Even one step of 25 refinements
# leaves some bins whose phase rounding decides (where |S| is small), so
# the float32 sides lie this far from the float64 step at most, kernel /
# plain (cuFFT), over steps 100-107 (measured on one NVIDIA H100 80GB HBM3,
# 700 W):
#   config 3, B=1:  committed frames 7.6e-5 / 5.3e-5, committed buffer
#                   5.9e-5 / 4.2e-5, in flight 9.6e-5 / 5.4e-5, momentum
#                   1.4e-4 / 4.5e-5;
#   config 3, B=16: 9.2e-4 / 4.1e-3, 8.0e-4 / 3.6e-3, 1.1e-2 / 1.1e-2,
#                   1.0e-2 / 1.4e-2 (other clips than B=1's seed 0);
#   small (batch 2, steps 12-19, worst case): 1.3e-6 / 4.5e-6 (256/32),
#                   1.2e-6 / 4.1e-6 (256/32), 6.8e-4 / 6.9e-4 (circular),
#                   4.9e-4 / 4.9e-4 (circular).
# Each limit is twice the sum of the two sides, rounded up to one digit.
RTISI_LIMITS = {
    1: {"committed": 3e-4, "keeped": 3e-4, "update": 3e-4, "pre": 4e-4},
    16: {"committed": 2e-2, "keeped": 9e-3, "update": 5e-2, "pre": 5e-2},
}
RTISI_SMALL_LIMITS = {"committed": 2e-5, "keeped": 2e-5, "update": 3e-3, "pre": 2e-3}
# The small geometries, batch 2, hamming unless named: every pad mode,
# center False, asymmetric windows, look-ahead 0 and 7, normalized, a hop
# that does not divide n_fft, the largest n_fft.  At hop == n_fft a frame
# meets no neighbour, so under a tapered window its phase is pinned only
# where the window is large: from one step on the card, the plain float32
# step lay 6.8e-1 (committed frame) and 1.1 (momentum) of the max from
# float64 under hann, the kernel 8.2e-2 and 1.1e-1 (same card).  A
# rectangular window makes every frame's spectrum consistent, so the
# comparison there measures the kernel's arithmetic.
RTISI_SMALL = [*((512, 128, dict(pad_mode=m)) for m in ("reflect", "constant", "replicate",
                                                          "circular")),
               (512, 128, dict(center=False)), (512, 128, dict(asym=True)),
               (512, 128, dict(look_ahead=0)), (512, 512, dict(window="ones")),
               (512, 128, dict(normalized=True)), (512, 160, dict(asym=True)),
               (4096, 1024, dict(asym=True)), (256, 32, dict(look_ahead=7))]
# The checks' starting states, the ones those limits were derived at: config
# 3 after 100 steps (batch 1 and 16) and each small geometry after its i0
# steps (12; 0 at hop == n_fft), as the kernel of commit 789c5b1 (one block
# per stream, a complex radix-2 FFT in float32) reached them from the
# zero-phase seed; the plain float32 version lies as far from float64 there
# as the comments above record, and scripts/torch_rtisi_check_states.py
# rebuilds them from a checkout of that commit.  The checks do not start
# from the state the kernel under test reaches: that state moves with every
# rounding of the steps before it, and the limits hold only where they were
# derived.  Elsewhere a step can sit where one float32 rounding decides some
# bins' phases, so that the kernel or the plain float32 version lands far
# outside the limits from float64 while float64 itself moves as far under
# a perturbation of one rounding (scripts/torch_rtisi_phases.py, section 2).
# Keys: cfg3_b{1,16}_* and small{i}_* (i indexes RTISI_SMALL), * = keep,
# upd, pre.
RTISI_STATES = ROOT / "chip_smoke_rtisi_states.npz"
RTISI_STATES_SHA256 = "08386d5d549e2b13ae33c0b3eb202bdb51211f43fdac57a5cd54798a11f32eca"
# Final SC (dB) of RTISI_LA's kernel path against its torch.fft path, and
# the quality ceiling.  scripts/torch_profile.py runs config 3 on 16 clips:
# the float64 fft path ended at -22.49 dB or below on each, and the float32
# runs lay at most 0.28 dB (kernel) and 0.44 dB (fft) from it (same card).
# The band is twice the sum, 1.5 dB; the ceiling the worst float64 SC plus
# twice the larger drift, rounded up.
RTISI_SC_BAND_DB = 1.5
RTISI_SC_CEILING_DB = -21.5
# Kernel D's mixed-radix instance (n_fft 400: n/2 = 200, one radix-8 and two
# radix-5 stages) at the rtisi400_16k_batch32 cell's shape, 8 single steps
# from the state of mixed_rtisi_state (after MIXED_RTISI_I0 float64 steps),
# held as RTISI_LIMITS are.  Kernel / plain (cuFFT) from the float64 step,
# over the 32 chunks (one NVIDIA H100 80GB HBM3, 700 W): committed frames
# 1.56e-6 / 2.76e-6, committed buffer 1.26e-6 / 2.36e-6, in flight 5.44e-6 /
# 6.71e-6, momentum 2.81e-5 / 3.06e-5; the kernel lay 2.81e-6, 2.30e-6,
# 1.21e-5 and 5.86e-5 from the plain step.  Each limit is twice the sum of
# the two sides, rounded up to one digit.
MIXED_RTISI_I0 = 100
RTISI_MIXED_LIMITS = {"committed": 9e-6, "keeped": 8e-6, "update": 3e-5, "pre": 2e-4}
# RTISI_LA and RTISIStreamer on 'auto' at 400/160 (look-ahead 2, 25
# refinements): final SC of the kernel path against the float32 'fft'
# path's, and the ceiling, derived as config 3's.  On the 10 s clips of seeds
# 0-3 (the drive's is seed 0) the float64 fft path ended at -16.95 dB or
# below, and the float32 runs lay at most 0.076 dB (kernel) and 0.130 dB
# (fft) from it (same card): the band is twice the sum, 0.5 dB; the ceiling
# the worst float64 SC plus twice the larger drift, rounded up.
C7_RTISI_SC_BAND_DB = 0.5
C7_RTISI_SC_CEILING_DB = -16.6

# The direct-DFT kernels (gl_fused.cu, admm_fused.cu) against their plain
# versions, float32, relative to the largest value of the plain output: each
# runs 5 chained iterations from the same state beside the plain version in
# float32 and in float64 with the same bf16 splits (the anchor), checked
# after 1 and 5, at config 1/2 and the small set (limits per tier, the worst
# case over all of them).  Readings on one NVIDIA H100 80GB HBM3, 700 W, as
# the kernel's / the plain float32 version's distance from float64, x / |S|
# / state:
#   GL   high     1 it 1.6e-5/6.6e-6  3.3e-6/2.9e-7  5.8e-6/5.6e-7
#                 5 it 1.0e-4/8.0e-5  8.2e-5/6.1e-5  1.5e-4/9.2e-5
#        bf16x2   1 it 1.4e-4/3.9e-5  3.3e-6/2.7e-7  5.8e-6/5.5e-7
#                 5 it 1.8e-2/1.5e-2  1.6e-2/1.1e-2  3.4e-2/3.0e-2
#        bf16x2t  1 it 3.1e-5/3.6e-5  3.2e-6/2.8e-7  5.8e-6/5.6e-7
#                 5 it 4.8e-4/1.9e-4  8.4e-5/4.0e-5  1.2e-4/7.3e-5
#        highest  1 it 2.9e-6/3.5e-6  1.4e-6/4.0e-7  2.7e-6/7.1e-7
#                 5 it 4.1e-5/2.5e-5  1.6e-5/3.8e-5  3.2e-5/3.9e-5
#        default  1 it 5.4e-4/5.4e-4  3.2e-6/2.9e-7  5.7e-6/5.0e-7
#                 5 it 1.4e-2/1.9e-2  8.5e-3/4.8e-3  1.3e-2/9.5e-3
#        pair     1 it 1.4e-4/3.9e-5  3.3e-6/2.9e-7  5.8e-6/5.6e-7
#                 5 it 8.2e-4/5.2e-4  6.8e-4/5.7e-4  1.8e-3/9.3e-4
#   ADMM high     1 it 1.4e-5/1.2e-5  3.3e-6/2.9e-7  5.1e-5/2.9e-5
#                 5 it 1.4e-3/1.4e-3  6.5e-4/9.2e-4  3.1e-3/8.7e-3
#        bf16x2   1 it 2.7e-4/7.7e-5  3.3e-6/2.7e-7  5.3e-5/4.2e-6
#                 5 it 1.1e-2/1.2e-2  1.4e-2/1.5e-2  4.5e-2/4.7e-2
#        bf16x2t  1 it 4.7e-6/3.4e-6  3.2e-6/2.8e-7  1.7e-5/1.2e-5
#                 5 it 1.3e-4/1.6e-4  5.5e-5/6.2e-5  4.2e-4/9.0e-4
#        highest  1 it 2.8e-6/6.0e-6  1.4e-6/4.0e-7  1.4e-5/1.4e-5
#                 5 it 3.7e-5/4.7e-5  4.7e-5/3.1e-5  2.0e-4/1.4e-4
#        default  1 it 6.7e-5/1.6e-5  3.2e-6/2.9e-7  1.7e-5/6.3e-6
#                 5 it 1.3e-2/8.8e-3  1.1e-2/3.8e-3  4.7e-2/3.2e-2
# Each limit is twice the sum of the two sides, rounded up to one digit.
# The tiers that round an operand to one bf16 half ('bf16x2' drops the
# data's low half in the inverse, 'default' both) let an ulp of difference
# in float32 move a value to the neighbouring bf16 value, and over 5
# iterations that compounds: their 5-iteration limits are wide, and their
# 1-iteration limits are what holds the kernel's arithmetic.
DFT_TIERS = ("high", "bf16x2", "bf16x2t", "highest", "default", ("high", "bf16x2"))
DFT_LIMITS = {  # {tier: {iterations: (x, |S|, state)}}
    "high": {1: (5e-5, 8e-6, 2e-5), 5: (4e-4, 3e-4, 5e-4)},
    "bf16x2": {1: (4e-4, 8e-6, 2e-5), 5: (7e-2, 6e-2, 2e-1)},
    "bf16x2t": {1: (2e-4, 7e-6, 2e-5), 5: (2e-3, 3e-4, 4e-4)},
    "highest": {1: (2e-5, 4e-6, 7e-6), 5: (2e-4, 2e-4, 2e-4)},
    "default": {1: (3e-3, 7e-6, 2e-5), 5: (7e-2, 3e-2, 5e-2)},
    ("high", "bf16x2"): {1: (4e-4, 8e-6, 2e-5), 5: (3e-3, 3e-3, 6e-3)},
}
DFT_ADMM_LIMITS = {
    "high": {1: (6e-5, 8e-6, 2e-4), 5: (6e-3, 4e-3, 3e-2)},
    "bf16x2": {1: (7e-4, 8e-6, 2e-4), 5: (5e-2, 6e-2, 2e-1)},
    "bf16x2t": {1: (2e-5, 7e-6, 6e-5), 5: (6e-4, 3e-4, 3e-3)},
    "highest": {1: (2e-5, 4e-6, 6e-5), 5: (2e-4, 2e-4, 7e-4)},
    "default": {1: (2e-4, 7e-6, 5e-5), 5: (5e-2, 3e-2, 2e-1)},
}
# Final SC (dB) of the 'dft' paths (precision 'high') against the torch.fft
# paths after 100 iterations.  Beside them the torch.fft path in float64 from
# the same magnitude (its own float64 SPSI seed) is the anchor: on an H100 the
# 'dft' / float32 fft paths ended 0.0240 / 0.0239 dB from it for GL at config
# 1, 0.1182 / 0.0326 dB for ADMM at config 2 and 0.0031 / 0.0031 dB for GL
# at 400/160.  Each band is twice the sum, rounded up to one digit.
DFT_SC_BAND_DB, DFT_ADMM_SC_BAND_DB, C7_SC_BAND_DB = 0.1, 0.4, 0.02
# The 1000-iteration quality of the kernel paths: the final SC of
# griffin_lim (config 1) and ADMM (config 2, rho 0.1) through 'kernel' and
# through 'dft' (HIGH) against the port's float64 torch.fft path (its own
# float64 SPSI seed) after QUALITY_ITERS iterations.  The North star's bar is
# 1e-3 dB.  On the tree before the half-length transform
# (scripts/torch_sc_1000.py, NVIDIA H100 80GB HBM3, 700 W) GL lay 0.0143 dB
# from float64, as far as the float32 fft path (0.0144 dB): float32 itself
# misses the bar (the JAX package's float32 run lies farther from its
# float64 one than the port's, tests/test_torch_quality.py), so GL is held as
# ADMM is, at twice that tree's gap rounded up to one digit (ADMM: 0.4149 dB
# there).  'dft' at twice the gap of the tree before the wgmma engine (same
# script, same card): GL 0.014541, ADMM 0.354940 dB.
QUALITY_ITERS = 1000
QUALITY_BAND_DB = {"griffin_lim": 0.03, "ADMM": 0.9, "griffin_lim dft": 0.03, "ADMM dft": 0.8}
# C7 geometry of the 'auto' drive: n_fft 400, hop 160 (no whole-run kernel)
C7_N_FFT, C7_HOP = 400, 160
# The Whisper cell gl400_16k_batch32: 32 chunks of 30 s at 16 kHz
WHISPER_CHUNKS, WHISPER_SAMPLES = 32, 480000

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): device
# memory bandwidth, FP32 rate outside the tensor cores and dense bf16 rate
# of the tensor cores.
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, PEAK_BF16_FLOPS = 3.35e12, 67e12, 989e12
PEAK_FP64_FLOPS = 34e12  # outside the tensor cores (NVIDIA's data sheet, SXM)
# bf16 tensor-core passes of each direct-DFT tier ('highest' is float32)
DFT_PASSES = {"default": 1, "high": 3, "bf16x2": 2, "bf16x2t": 2, "highest": 1}


# The sequence-parallel main path: a 10-minute speech-like clip
# (utils/corpus, seed 0) at config 1's widths, 25840 frames, split over 2
# shards of 12922 frames; and batched Griffin-Lim over 256 ten-second clips
# (seeds 0-255, BASELINE config 5's batch at n_fft 2048) over 2 ranks.
SEQ_SAMPLES, SEQ_FRAMES, SEQ_SHARDS, SEQ_SHARD_FRAMES = 13_230_000, 25840, 2, 12922
SEQ_W1_FRAMES = 25843  # world 1: T padded by ceil(n_fft / hop) - 1 frames
BATCH_CLIPS, CLIP_CHUNK = 256, 43
# The raw Griffin-Lim dispatch against its plain version at the seq shard
# (12922 frames), 5 launches chained through the envelope divide: there the
# plain float32 version drifts from a float64 run faster than at config 1
# (on an H100 80GB HBM3, 700 W, after 5 launches, kernel / plain from
# float64: x 2.7e-5 / 1.7e-4, state 9.5e-5 / 6.3e-4, |S| 4.8e-5 / 3.1e-4).
# Twice the sum, rounded up to one digit; the eval sums keep SUM_LIMIT.  The
# ADMM readings lie inside ADMM_X_LIMIT / ADMM_PLANE_LIMIT.
RAW_GL_LIMITS = (4e-4, 2e-3, 1e-4)
# The same at the world-1 shape (the whole clip in one launch, 25843 frames,
# valid_t 25840), 5 launches, kernel / plain from float64 on the same card:
# GL x 3.8e-5 / 1.7e-4, state 9.5e-5 / 6.3e-4, |S| 4.8e-5 / 3.1e-4; ADMM x
# 3.4e-5 / 1.2e-4, state 2.6e-4 / 9.1e-4, |S| 8.4e-5 / 3.9e-5.  Twice the
# sum, rounded up to one digit; the eval sums (read 1.9e-7) keep SUM_LIMIT
# and ADMM_SUM_LIMIT.
RAW_W1_GL_LIMITS = (5e-4, 2e-3, 1e-4)
RAW_W1_ADMM_LIMITS = (4e-4, 3e-3, 2e-5)
# World 2 against world 1 after FEW_ITERS iterations (x, relative to the
# max): both start from the same window bits (seq_window), so they differ
# only in the float32 order of the sums at the shard boundary and are held
# at the raw dispatch's limits after 5 launches (Griffin-Lim, ADMM).  After
# 100 iterations the seq runs are held by SC: each float32 seq run (worlds
# 1 and 2, tol 0 and 1e-6) and the unsharded call against the float64 seq
# run (fft path) of the same call.  The bands are twice the sum of the two
# worlds' distances from float64 in the first reading on an H100 80GB HBM3,
# 700 W, rounded up to one digit: Griffin-Lim 0.0547 (world 1) and 0.0287
# dB (world 2), ADMM 0.2833 and 0.5998 dB, world 2 then started from a
# window made on the card (1.5 of the max from world 1 after 5 iterations).
# With one window: Griffin-Lim 0.0547 dB in both worlds and unsharded, ADMM
# 0.2833, 0.2838 and 0.2771 dB; world 2 2.0e-7 (GL) and 4.9e-7 (ADMM) of
# the max from world 1 after 5 iterations.
SEQ_X_LIMITS = {"griffin_lim_seq": 4e-4, "admm_seq": 2e-3}
# World 1 against the unsharded whole-run call after FEW_ITERS iterations
# (x, relative to the max): the same kernel on the same frames, apart from
# the envelope divide (PyTorch's y / env against the kernel's y * (1 / env))
# and the seq path's 3 padding frames (zero target, inert), so they are held
# at the world-1 raw dispatch's x limit after 5 launches; read 2.0e-5 (GL)
# and 1.5e-4 (ADMM) on the same card.  A float64 seq run cannot anchor this:
# its own SPSI seed starts 1.3 of the max away after 5 iterations.
SEQ_WHOLE_LIMITS = {"griffin_lim_seq": RAW_W1_GL_LIMITS[0], "admm_seq": RAW_W1_ADMM_LIMITS[0]}
SEQ_SC_BAND_DB, SEQ_ADMM_SC_BAND_DB = 0.2, 2.0
# The launch counters of the port's kernel wrappers (module, attribute).
COUNTERS = (("gl_fullrun", "launches"), ("gl_fullrun", "iteration_launches"),
            ("admm_fullrun", "launches"), ("admm_fullrun", "iteration_launches"),
            ("fft", "launches"), ("rtisi_fused", "launches"),
            ("rtisi_fused", "mixed_radix_launches"), ("gl_fused", "launches"),
            ("admm_fused", "launches"))


# BASELINE config 4 (BASELINE.json configs[3], the settings of
# bench.py:546-551): L_BFGS on the 128-band log-mel spectrogram of the 10 s
# clip (n_fft 2048, hop 512, hann), 10 outer steps of 20 strong-Wolfe
# iterations, history 100, float32; the same with the history in bf16, and
# with the fixed step.  L-BFGS on a non-convex loss is chaotic across types,
# so each float32 run is held by its final relative log-mel loss (mean
# squared error over the target's mean square, under the float64
# transform) against the float64 run of the same path from the same start,
# in decades: within twice the spread of the float64 runs' losses over the
# starts of LBFGS_SEEDS, rounded up to one digit.  On an NVIDIA H100 80GB
# HBM3, 700 W, the float64 strong-Wolfe runs ended at 6.265e-2 to 6.430e-2
# (0.0113 decades; the float32 runs lay 0.0000 and 0.0019 decades, bf16
# history, from seed 0's), the fixed-step runs at 0.94 to 17.3 (1.2666
# decades: the fixed step lr = 1 climbs on this loss, in the JAX package
# too; the float32 run lay 0.56 decades from seed 0's).
SR, N_MELS = 22050, 128
LBFGS_OUTER, LBFGS_INNER, LBFGS_HISTORY = 10, 20, 100
LBFGS_SEEDS = range(5)
LBFGS_BAND_DECADES = {"strong_wolfe": 0.03, "fixed": 3.0}
LBFGS_CEILING = 0.1  # the relative loss the strong-Wolfe runs must end below
# mel_to_audio at config 1's geometry: the clip's 128-band power mel, NNLS
# (200 iterations), then griffin_lim (100 iterations, 'auto': kernel A).
# Its final SC against the float64 NNLS magnitude is held against the same
# call in float64 ('fft' path): the first reading on the same card was
# 0.0146 dB apart (-16.0753 against -16.0607 dB); twice that, rounded up.
MEL_NNLS_ITERS = 200
MEL_SC_BAND_DB = 0.03
# Throughput's reading of a config-1 griffin_lim call against this script's
# own CUDA events around the same call (event_ms): relative.
THROUGHPUT_AGREE = 0.10


def _kernel_module(name: str):
    return importlib.import_module(f"specinv_tpu_torch.ops.cuda.{name}")


def reset_counts() -> None:
    for mod, attr in COUNTERS:
        setattr(_kernel_module(mod), attr, 0)


def read_counts() -> dict:
    return {f"{mod}.{attr}": getattr(_kernel_module(mod), attr) for mod, attr in COUNTERS}


def check_counts(label: str, expected: dict) -> None:
    """Every counter 0 except those of ``expected``, which must match."""
    got = read_counts()
    if got != {key: expected.get(key, 0) for key in got}:
        raise AssertionError(f"{label}: launches {({k: v for k, v in got.items() if v})}, "
                             f"expected {expected}")


def make_clips(path: str, n_samples: int, seeds) -> str:
    """Speech-like clips of ``seeds`` (float32) saved to ``path``: run in a
    worker process while the card checks the kernels."""
    from specinv_tpu_torch.utils.corpus import make_speech_like

    np.save(path, np.stack([make_speech_like(n_samples, seed=s) for s in seeds])
            .astype(np.float32))
    return path


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def check(name: str, err: float, limit: float) -> None:
    print(f"  {name}: max rel err {err:.3e} (limit {limit:.0e})", flush=True)
    if not err <= limit:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {limit:.0e}")


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events.  For work
    whose device time is below the host's time to launch it (a stand-alone
    transform of 431 frames), where :func:`time_ms` measures the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def kernel_state(n_fft, hop, n_samples, batch, dev, **stft_kwargs):
    """A real starting state of a whole-run kernel: the speech clip's
    magnitude, the SPSI seed (Griffin-Lim's momentum, ADMM's Y0) and
    ``istft(seed)`` in padded coordinates."""
    from specinv_tpu_torch.config import canonicalize
    from specinv_tpu_torch.models.phase_init import phase_init_tm
    from specinv_tpu_torch.ops import stft as stft_ops
    from specinv_tpu_torch.ops import twins
    from specinv_tpu_torch.ops.framing import pad_center
    from specinv_tpu_torch.utils.corpus import make_speech_like

    win_np = torch.hann_window(n_fft).numpy()
    bins = n_fft if stft_kwargs.get("onesided") is False else n_fft // 2 + 1
    cfg, w = canonicalize(bins, np.float32, window=win_np, hop_length=hop, **stft_kwargs)
    clips = np.stack([make_speech_like(n_samples, seed=s) for s in range(batch)])
    x = torch.from_numpy(clips.astype(np.float32)).to(dev)
    win = torch.from_numpy(w).to(dev)
    mag = stft_ops.stft(x, cfg, win).abs().contiguous()
    seed = phase_init_tm(mag, cfg).to(torch.complex64)
    T = mag.shape[-2]
    geo = twins.make_geometry(cfg, T)
    x_pad = pad_center(stft_ops.istft(seed, cfg, win), cfg).contiguous()
    return cfg, (x_pad, seed, mag, win, twins.make_inv_env(cfg, win, T, geo))


def check_kernel(label, mod, run, scalar, cfg, state, n_iters, limits):
    """Kernel ``mod.<run>`` against ``mod.<run>_reference``; returns the max
    abs error of x."""
    x_lim, plane_lim, sum_lim = limits
    flags = dict(emit_state=True, with_mag=True, with_loss=True)
    ours = getattr(mod, run)(*state, scalar, cfg, n_iters, **flags)
    ref = getattr(mod, f"{run}_reference")(*state, scalar, cfg, n_iters, **flags)
    torch.cuda.synchronize()
    x, st, mag, stats = ours
    rx, rst, rmag, rstats = ref
    check(f"{label} x", rel_err(x, rx), x_lim)
    check(f"{label} state", rel_err(torch.view_as_real(st), torch.view_as_real(rst)), plane_lim)
    check(f"{label} |S|", rel_err(mag, rmag), plane_lim)
    check(f"{label} eval sums", float(((stats - rstats).abs() / rstats.abs()).max()), sum_lim)
    return abs_err(x, rx)


def bound(n_bytes: float, flops: float, peak: float = PEAK_FP32_FLOPS, fp64_flops: float = 0.0):
    """The least time the card could take for work that moves ``n_bytes``
    and does ``flops`` operations at the rate ``peak`` (FP32 unless given)
    beside ``fp64_flops`` FP64 operations (their own units, so the larger
    of the two times counts): ``(ms, "bytes" or "operations")``."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = max(flops / peak, fp64_flops / PEAK_FP64_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fft_flops(n: int) -> float:
    """2.5 N log2 N per real-to-complex or complex-to-real transform of N
    points (half the 5 N log2 N of a complex one): every transform of these
    functions has a real signal on one side."""
    return 2.5 * n * (n.bit_length() - 1)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def event_ms(fn) -> float:
    """Device milliseconds of one ``fn()`` (CUDA events, no warm-up)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def rtisi_state(n_fft, hop, n_samples, batch, dev, window="hann", look_ahead=-1,
                asym=False, seed0=0, sr=22050.0, **stft_kwargs):
    """RTISI-LA's starting state for ``batch`` speech-like clips at ``sr``
    (seeds ``seed0`` onwards): the padded target ``(B, T + 2 la, F)``, the
    windows and ``(keeped, update, pre)`` with the zero-phase seed as the
    newest in-flight frame."""
    import importlib

    from specinv_tpu_torch.config import canonicalize
    from specinv_tpu_torch.ops import stft as stft_ops
    from specinv_tpu_torch.utils.corpus import make_speech_like

    rt = importlib.import_module("specinv_tpu_torch.models.rtisi_la")
    win_np = {"hann": np.hanning, "hamming": np.hamming, "ones": np.ones}[window](n_fft + 1)[:-1]
    cfg, w = canonicalize(n_fft // 2 + 1, np.float32, window=win_np.astype(np.float32),
                          hop_length=hop, **stft_kwargs)
    clips = np.stack([make_speech_like(n_samples, sr=sr, seed=seed0 + s) for s in range(batch)])
    win = torch.from_numpy(w).to(dev)
    mag = stft_ops.stft(torch.from_numpy(clips.astype(np.float32)).to(dev), cfg, win).abs()
    num_keep = (n_fft - 1) // hop
    la = num_keep if look_ahead < 0 else look_ahead
    target = torch.nn.functional.pad(mag, (0, 0, la, la)).contiguous()
    state = (torch.zeros(batch, num_keep, n_fft, device=dev), rt._seed_update(target, la, cfg),
             torch.zeros(batch, la + 1, n_fft // 2 + 1, dtype=torch.complex64, device=dev))
    return cfg, la, target, rt.rtisi_windows(win, cfg, asym), state


def rtisi_check_states(dev) -> dict:
    """The checks' starting states (``RTISI_STATES``), digest checked:
    ``name -> (keeped, update, pre)`` on ``dev``."""
    import hashlib

    data = RTISI_STATES.read_bytes()
    if hashlib.sha256(data).hexdigest() != RTISI_STATES_SHA256:
        raise AssertionError(f"{RTISI_STATES.name}: unexpected contents")
    with np.load(RTISI_STATES) as npz:
        names = {key.rsplit("_", 1)[0] for key in npz.files}
        return {name: tuple(torch.from_numpy(npz[f"{name}_{part}"]).to(dev)
                            for part in ("keep", "upd", "pre")) for name in names}


def mixed_rtisi_state(dev):
    """Kernel D's mixed-radix check at the ``rtisi400_16k_batch32`` cell's
    shape: 32 speech-like chunks of 30 s at 16 kHz, n_fft 400, hop 160, a
    periodic hann window, look-ahead 2; the state after
    ``MIXED_RTISI_I0`` plain steps in float64 from the zero-phase seed,
    narrowed to the kernel's types.  The float64 steps make the same state
    on every run, so the limits hold where they were derived."""
    from specinv_tpu_torch.ops.cuda import rtisi_fused

    cfg, la, target, windows, state = rtisi_state(C7_N_FFT, C7_HOP, WHISPER_SAMPLES,
                                                  WHISPER_CHUNKS, dev, sr=16000.0)
    w64 = type(windows)(*(w.double() for w in windows))
    _, *state64 = rtisi_fused.fused_rtisi_steps_reference(
        *map(wide, (*state, target[:, : MIXED_RTISI_I0 + la])), w64, 0.99 / 1.99, cfg,
        RTISI_ITERS)
    return cfg, la, target, windows, tuple(a.to(b.dtype) for a, b in zip(state64, state))


def frozen_state(states: dict, name: str, fresh) -> tuple:
    """``states[name]``, which must match the layout of ``fresh`` (the state
    ``rtisi_state`` starts from)."""
    state = states[name]
    for ours, ref in zip(state, fresh):
        if ours.shape != ref.shape or ours.dtype != ref.dtype:
            raise AssertionError(f"{name}: stored {ours.dtype} {tuple(ours.shape)}, expected "
                                 f"{ref.dtype} {tuple(ref.shape)}")
    return state


def check_rtisi(label, cfg, la, target, windows, state, i0, limits, k=8):
    """Steps ``i0 .. i0 + k - 1``, each alone: a one-step kernel launch from
    the plain version's state before the step against the plain step
    (float32 on the card), with a float64 plain step from the same state
    beside them.  Then a launch of ``k`` steps from ``state`` against ``k``
    chained one-step launches, bit for bit.  Returns the max abs error of
    the committed frames."""
    from specinv_tpu_torch.ops.cuda import rtisi_fused

    def err(a, b):
        a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
        return float((a.double() - b.double()).abs().max() / max(float(b.abs().max()), 1e-30))

    def wide(t):
        return t.to(torch.complex128 if t.is_complex() else torch.float64)

    lr, w64 = 0.99 / 1.99, type(windows)(*(w.double() for w in windows))
    worst = {name: [0.0, 0.0, 0.0] for name in limits}  # kernel-plain, kernel-f64, plain-f64
    plain, com_err = state, 0.0
    for s in range(k):
        tgt = target[:, i0 + s : i0 + s + 1 + la].contiguous()
        ours = rtisi_fused.fused_rtisi_steps(*plain, tgt, windows, lr, cfg, RTISI_ITERS)
        ref = rtisi_fused.fused_rtisi_steps_reference(*plain, tgt, windows, lr, cfg, RTISI_ITERS)
        anchor = rtisi_fused.fused_rtisi_steps_reference(*map(wide, (*plain, tgt)), w64, lr, cfg,
                                                         RTISI_ITERS)
        for name, a, b, c in zip(limits, ours, ref, anchor):
            if a.numel():
                worst[name] = [max(x, y) for x, y in zip(worst[name],
                                                         (err(a, b), err(a, c), err(b, c)))]
        com_err = max(com_err, abs_err(ours[0], ref[0]))
        plain = ref[1:]
    print(f"  rtisi {label}, {k} single steps: " + "; ".join(
        f"{name} {e[0]:.2e} (kernel/plain from float64 {e[1]:.2e}/{e[2]:.2e})"
        for name, e in worst.items()), flush=True)
    for name, e in worst.items():
        check(f"rtisi {label} {name}", e[0], limits[name])
    whole = rtisi_fused.fused_rtisi_steps(*state, target[:, i0 : i0 + k + la], windows, lr, cfg,
                                          RTISI_ITERS)
    coms, chain = [], state
    for s in range(k):
        com, *chain = rtisi_fused.fused_rtisi_steps(*chain, target[:, i0 + s : i0 + s + 1 + la],
                                                    windows, lr, cfg, RTISI_ITERS)
        coms.append(com)
    if not all(torch.equal(a, b) for a, b in zip(whole, (torch.cat(coms), *chain))):
        raise AssertionError(f"rtisi {label}: a launch of {k} steps differs from {k} one-step "
                             "launches")
    return com_err


def rel64(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max |a - b| / max |b|`` in float64 (complex as pairs of reals)."""
    a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def check_dft(label, mod, run, scalar, cfg, state, precision, extra, limits, n_iters=5):
    """``n_iters`` chained iterations of the kernel ``mod.<run>``, of its
    plain version in float32 and of its plain version in float64 (the
    anchor), each from ``state``; after 1 and ``n_iters`` iterations the
    kernel is held to the plain float32 version within ``limits[it]``.
    Prints kernel-plain, kernel-f64 and plain-f64 distances; returns the
    max abs error of x and those readings ``{it: [(k-p, k-a, p-a) for x,
    |S|, state]}``."""
    fn, ref_fn = getattr(mod, run), getattr(mod, f"{run}_reference")
    x, plane, tgt, win, env = state
    tgt64, win64, env64 = wide(tgt), wide(win), wide(env)
    k = p = (x, plane)
    a = (wide(x), wide(plane))
    readings, x_err = {}, 0.0
    for it in range(1, n_iters + 1):
        kx, km, ks = fn(*k, tgt, win, env, scalar, cfg, *extra, precision=precision)
        px, pm, ps = ref_fn(*p, tgt, win, env, scalar, cfg, *extra, precision=precision)
        ax, am, as_ = ref_fn(*a, tgt64, win64, env64, scalar, cfg, *extra, precision=precision)
        k, p, a = (kx, ks), (px, ps), (ax, as_)
        if it in (1, n_iters):
            torch.cuda.synchronize()
            readings[it] = [(rel64(u, v), rel64(u, w), rel64(v, w))
                            for u, v, w in ((kx, px, ax), (km, pm, am), (ks, ps, as_))]
            x_err = max(x_err, abs_err(kx, px))
    for it, rows in readings.items():
        print(f"  {label} {precision}, {it} it: " + "; ".join(
            f"{q} {r[0]:.2e} (kernel/plain from float64 {r[1]:.2e}/{r[2]:.2e})"
            for q, r in zip(("x", "|S|", "state"), rows)), flush=True)
        for q, r, lim in zip(("x", "|S|", "state"), rows, limits[it]):
            check(f"{label} {precision} {q} after {it}", r[0], lim)
    return x_err, readings


def seq_shard_state(mag, cfg, win, shard, n=SEQ_SHARDS):
    """Shard ``shard`` of ``n``'s starting state as ``parallel/seq`` builds
    it from ``mag (B, T, F)``: the signal with its right halo ``(B, C +
    H)``, the SPSI-seeded plane and the target rows ``(B, Ts, F)``, and the
    shard's true-frame count."""
    import torch.nn.functional as F

    from specinv_tpu_torch.models.phase_init import phase_init_tm
    from specinv_tpu_torch.ops import stft as stft_ops
    from specinv_tpu_torch.ops.framing import pad_center
    from specinv_tpu_torch.parallel.seq import _geometry

    T = mag.shape[-2]
    Ts, T_pad, C, H, Lp, *_ = _geometry(cfg, T, n)
    seed = phase_init_tm(mag, cfg).to(torch.complex64)
    x_pad = F.pad(pad_center(stft_ops.istft(seed, cfg, win), cfg), (0, n * C + H - Lp))
    rows = slice(shard * Ts, (shard + 1) * Ts)

    def plane(a):
        return F.pad(a, (0, 0, 0, T_pad - T))[:, rows].contiguous()

    state = (x_pad[:, shard * C : shard * C + C + H].contiguous(), plane(seed), plane(mag), win)
    return state, min(max(T - shard * Ts, 0), Ts)


def check_raw(label, mod, run, scalar, cfg, state, valid, n_iters, limits):
    """``n_iters`` raw launches of ``mod.<run>``, each followed by the
    envelope divide of the seq path, against the plain
    version in float32 and beside a float64 plain run (the anchor), from
    ``state = (x, plane, target, window)``; checked after 1 and ``n_iters``
    launches at ``limits = (x, planes, eval sums)``.  Returns the max abs
    error of x."""
    from specinv_tpu_torch.ops import twins

    fn, ref_fn = getattr(mod, run), getattr(mod, f"{run}_reference")
    x, plane, tgt, win = state
    inv = twins.make_inv_env(cfg, win, tgt.shape[-2], twins.raw_geometry(cfg, tgt.shape[-2]))
    # the first and last n_fft - hop samples lack the frames a neighbour
    # shard adds; under a tapered window their envelope falls to ~1e-6, and
    # dividing by it would amplify rounding 1e5 times: they start the next
    # launch at 0
    h, lp = cfg.n_fft - cfg.hop_length, inv.shape[-1]
    inv[:h] = 0
    inv[lp - h:] = 0
    flags = dict(with_mag=True, with_loss=True, valid_t=valid)
    tgt64, win64, inv64 = wide(tgt), wide(win), wide(inv)
    k = p = (x, plane)
    a = (wide(x), wide(plane))
    x_err = 0.0

    def rel(u, v):  # relative to the max of v; absolute where v is all zero (valid_t 0)
        return rel64(u, v) if float(v.abs().max()) > 0 else float(u.abs().max())

    for it in range(1, n_iters + 1):
        kx, ks, km, kst = fn(*k, tgt, win, scalar, cfg, **flags)
        px, ps, pm, pst = ref_fn(*p, tgt, win, scalar, cfg, **flags)
        ax, as_, am, ast = ref_fn(*a, tgt64, win64, scalar, cfg, **flags)
        if it in (1, n_iters):
            torch.cuda.synchronize()
            rows = [(rel(u, v), rel(u, w), rel(v, w))
                    for u, v, w in ((kx, px, ax), (ks, ps, as_), (km, pm, am))]
            print(f"  {label}, {it} it: " + "; ".join(
                f"{q} {r[0]:.2e} (kernel/plain from float64 {r[1]:.2e}/{r[2]:.2e})"
                for q, r in zip(("x", "state", "|S|"), rows)), flush=True)
            for q, r, lim in zip(("x", "state", "|S|"), rows, (limits[0], *limits[1:2] * 2)):
                check(f"{label} {q} after {it}", r[0], lim)
            if bool(pst.any()):
                check(f"{label} eval sums after {it}",
                      float(((kst - pst).abs() / pst.abs()).max()), limits[2])
            elif bool(kst.any()):
                raise AssertionError(f"{label}: eval sums over no frame are not 0")
            x_err = max(x_err, abs_err(kx, px))
        k, p, a = (kx * inv, ks), (px * inv, ps), (ax * inv64, as_)
    return x_err


def run_seq(label, fn, spec, mesh, counter, **kw):
    """One seq main-path call with every launch count set to 0 just before
    and read just after: ``counter`` must show ``MAIN_ITERS`` launches and
    every other counter none.  Returns the waveform and that count."""
    reset_counts()
    y = fn(spec, mesh, max_iter=MAIN_ITERS, **kw)
    torch.cuda.synchronize()
    launches = read_counts()[counter]
    check_counts(label, {counter: MAIN_ITERS})
    expected = (spec.shape[-1] - 1) * kw["hop_length"]
    if y.shape != (expected,) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{label}: bad output {tuple(y.shape)}")
    return y, launches


def seq_us(fn, spec, mesh, kw, barrier=None):
    """Marginal microseconds per iteration of a seq call: (t(100) -
    t(50)) / 50 on the host clock, each call synchronised (and, across
    ranks, started together)."""
    t = {}
    for n in (MAIN_ITERS, MAIN_ITERS // 2):
        if barrier:
            barrier()
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn(spec, mesh, max_iter=n, **kw)
        torch.cuda.synchronize()
        t[n] = time.perf_counter() - start
    return (t[MAIN_ITERS] - t[MAIN_ITERS // 2]) / (MAIN_ITERS - MAIN_ITERS // 2) * 1e6


def seq_window(dev) -> torch.Tensor:
    """The seq and batched phases' hann window, made on the host so that
    every process has the same bits: a window computed on the card differs
    from it in the last bit, and over the 10-minute clip's 25840 frames the
    SPSI seed's cumulative phase turns such a difference into another
    starting point."""
    return torch.hann_window(N_FFT).to(dev)


def load_magnitudes(paths, window):
    """``|stft|`` of the clips saved at ``paths``, on the card: ``(B, F, T)``."""
    import specinv_tpu_torch as st

    x = torch.from_numpy(np.concatenate([np.load(p) for p in paths])).to(window.device)
    return st.stft(x, N_FFT, hop_length=HOP, window=window).abs()


SEQ_TOL = 1e-6          # the early-stopping seq runs (eva_iter 10)
FEW_ITERS = 5           # world 2 against world 1, sample by sample
GLOBAL_STOP_TOL = 5e-2  # the batched global-stop run: fires before 100 iterations


# Seq gradients at full width (phase 4): d mean((y - clip)^2) / d spec of
# FEW_ITERS iterations at tol 0 on the 10-minute clip (y and the clip cut to
# their common length), spec the clip's complex SPSI seed (float32, made
# once on the card; the float64 runs take it widened).  From the magnitude
# a float32 gradient carries the seed's float32 phase sums over 25840
# frames: on an H100 80GB HBM3, 700 W, it lay 2.4 (GL) and 1.2 (ADMM) of
# the max from the float64 one.  Seq 'kernel' against seq 'fft' at JAX's
# band (test_sharding.py:252; the kernel's plain twin takes |S| as
# sqrt(re^2 + im^2 + 1e-30) where the fft path takes abs), the fft side in
# float64: the float32 fft ADMM gradient itself lay 0.94 of the max from
# the float64 one (kernel 1.3e-2), a few entries where the projection's
# 1/|Tz| magnifies float32 rounding; GL's float32 pair read 2.7e-2.
GRAD_KERNEL_FFT_BAND = 5e-2
# World 2 against world 1, remat against none and seq against unsharded
# 'kernel': each limit twice the sum of the two sides' distances from the
# float64 'fft' seq gradient, rounded up to one digit.  Readings (same card,
# relative to the max): GL kernel 1.030e-2, world 2 1.030e-2, remat
# 1.030e-2, unsharded 2.755e-2; ADMM kernel 1.336e-2, world 2 1.336e-2,
# remat 1.336e-2, unsharded 4.995e-2.  The pairs read: world 2 2.5e-8 /
# 4.7e-7, remat 0 (bit for bit), unsharded 3.2e-2 / 4.1e-2.
GRAD_LIMITS = {
    ("griffin_lim_seq", "world 2"): 5e-2, ("griffin_lim_seq", "remat"): 5e-2,
    ("griffin_lim_seq", "unsharded"): 8e-2,
    ("admm_seq", "world 2"): 6e-2, ("admm_seq", "remat"): 6e-2, ("admm_seq", "unsharded"): 0.2,
}
# The dry run on the card: graft_entry.dryrun_multichip over DRYRUN_RANKS
# ranks on cuda:0 (a 2 x 4 mesh), in a subprocess.
DRYRUN_RANKS, DRYRUN_TIMEOUT_S = 8, 300
DRYRUN_VARIANTS = 11


def seq_grad(call, spec, clip, expected, label):
    """d mean((y - clip)^2) / d spec of ``y = call(spec)``.  Every launch
    count is set to 0 just before the forward pass and read just after: it
    must equal ``expected``.  Returns the gradient, the device times of the
    forward and the backward pass (CUDA events, ms), the peak memory above
    what was allocated before the call (bytes) and the launch counts of
    both passes (the backward's: a remat run's recomputed launches)."""
    s = spec.detach().clone().requires_grad_()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ev[0].record()
    y = call(s)
    n = min(y.shape[-1], clip.shape[-1])
    loss = ((y[..., :n] - clip[..., :n]) ** 2).mean()
    ev[1].record()
    torch.cuda.synchronize()
    fwd = read_counts()
    check_counts(f"{label}, forward", expected)
    reset_counts()
    ev[2].record()
    loss.backward()
    ev[3].record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(s.grad).all()):
        raise AssertionError(f"{label}: non-finite gradient")
    return dict(grad=s.grad, fwd_ms=ev[0].elapsed_time(ev[1]), bwd_ms=ev[2].elapsed_time(ev[3]),
                peak=torch.cuda.max_memory_allocated() - base, fwd_launches=fwd,
                bwd_launches=read_counts())


def seq_grad_rank(rank, mesh, spec, clip, kw):
    """The world-2 ranks' seq gradients through 'kernel' (GL and ADMM):
    each rank saves its own gradient under ``SMOKE_DIR``."""
    from specinv_tpu_torch.parallel import admm_seq, griffin_lim_seq

    for name, fn, counter, extra in (
        ("griffin_lim_seq", griffin_lim_seq, "gl_fullrun.iteration_launches", {}),
        ("admm_seq", admm_seq, "admm_fullrun.iteration_launches", {"rho": ADMM_RHO}),
    ):
        r = seq_grad(lambda s, fn=fn, extra=extra: fn(s, mesh, max_iter=FEW_ITERS, tol=0.0,
                                                       backend="kernel", **extra, **kw),
                     spec, clip, {counter: FEW_ITERS}, f"{name} gradient rank {rank}")
        np.save(SMOKE_DIR / f"{name}_grad_world2_rank{rank}.npy", r["grad"].cpu().numpy())


def grad_phase(spec, clip, window, smi) -> dict:
    """The seq gradients at world 1 in this process, GL and ADMM: through
    'kernel' (FEW_ITERS raw launches in the forward pass and no other kernel)
    and 'fft', each after a warm-up call and again at twice FEW_ITERS for
    the times per iteration; 'kernel' with ``remat=True``; the unsharded
    call through 'kernel'; and the float64 'fft' seq gradient, the anchor
    of the limits.  Prints the times, peak memory and distances; returns
    ``{name: {run: result}}`` and the launches of the phase
    (``'launches'``)."""
    import specinv_tpu_torch as st
    from specinv_tpu_torch.parallel import admm_seq, griffin_lim_seq, make_mesh

    mesh = make_mesh()
    kw = dict(hop_length=HOP, window=window)
    spec64 = spec.to(torch.complex128 if spec.is_complex() else torch.float64)
    out = {"launches": {}}
    for name, fn, counter, whole, whole_counter, extra in (
        ("griffin_lim_seq", griffin_lim_seq, "gl_fullrun.iteration_launches", st.griffin_lim,
         "gl_fullrun.launches", {}),
        ("admm_seq", admm_seq, "admm_fullrun.iteration_launches", st.ADMM,
         "admm_fullrun.launches", {"rho": ADMM_RHO}),
    ):
        def seq(backend, iters=FEW_ITERS, remat=False, fn=fn, extra=extra, kw=kw):
            return lambda s: fn(s, mesh, max_iter=iters, tol=0.0, backend=backend, remat=remat,
                                **extra, **kw)

        def unsharded(s, whole=whole, extra=extra):
            return whole(s, max_iter=FEW_ITERS, tol=0.0, verbose=False, backend="kernel",
                         **extra, **kw)

        runs = {
            "kernel": (seq("kernel"), spec, clip, {counter: FEW_ITERS}),
            "kernel 2x": (seq("kernel", 2 * FEW_ITERS), spec, clip, {counter: 2 * FEW_ITERS}),
            "fft": (seq("fft"), spec, clip, {}),
            "fft 2x": (seq("fft", 2 * FEW_ITERS), spec, clip, {}),
            "remat": (seq("kernel", remat=True), spec, clip, {counter: FEW_ITERS}),
            "unsharded": (unsharded, spec, clip, {whole_counter: FEW_ITERS}),
            "float64": (seq("fft", kw=dict(hop_length=HOP, window=window.double())), spec64,
                        clip.double(), {}),
        }
        # the first backward pass of a shape pays its set-up (cuFFT plans, the
        # allocator): a warm-up call of each backend, counted but not timed
        for warm in ("kernel", "fft"):
            r = seq_grad(*runs[warm], f"{name} {warm} warm-up")
            for key, v in r["fwd_launches"].items():
                out["launches"][key] = out["launches"].get(key, 0) + v
            del r
        res = {}
        for run, args in runs.items():
            res[run] = r = seq_grad(*args, f"{name} {run}")
            for counts in (r["fwd_launches"], r["bwd_launches"]):
                for key, v in counts.items():
                    out["launches"][key] = out["launches"].get(key, 0) + v
            if run.endswith("2x"):
                del r["grad"]
        for backend in ("kernel", "fft"):
            one, two = res[backend], res[f"{backend} 2x"]
            print(f"  {name} gradient, world 1, '{backend}': forward "
                  f"{(two['fwd_ms'] - one['fwd_ms']) / FEW_ITERS:.3f} ms/iter, backward "
                  f"{(two['bwd_ms'] - one['bwd_ms']) / FEW_ITERS:.3f} ms/iter "
                  f"({2 * FEW_ITERS} - {FEW_ITERS} iterations); whole call at {FEW_ITERS}: "
                  f"forward {one['fwd_ms']:.3f} ms, backward {one['bwd_ms']:.3f} ms, peak "
                  f"memory {one['peak'] / 2**20:.1f} MiB ({2 * FEW_ITERS}: "
                  f"{two['peak'] / 2**20:.1f}) on {smi}", flush=True)
        g64 = res["float64"]["grad"]
        print(f"  {name} gradient, world 1: 'kernel' against 'fft' "
              f"{rel_err(res['kernel']['grad'], res['fft']['grad']):.3e} of the max; from the "
              f"float64 'fft' gradient: " + ", ".join(
                  f"{run} {rel64(res[run]['grad'], g64):.3e}"
                  for run in ("kernel", "fft", "remat", "unsharded"))
              + f"; remat's backward launches {res['remat']['bwd_launches'][counter]}, float64 "
                f"peak {res['float64']['peak'] / 2**20:.1f} MiB", flush=True)
        out[name] = res
    return out


def check_grads(grads) -> None:
    """The seq gradients against each other (``grad_phase``'s and the
    world-2 ranks'): both ranks hold the same gradient, bit for bit; seq
    'kernel' against the float64 seq 'fft' gradient at JAX's band; world 2
    against world 1, remat against none and seq against unsharded 'kernel'
    at GRAD_LIMITS."""
    for name in ("griffin_lim_seq", "admm_seq"):
        res = grads[name]
        g64, kernel = res["float64"]["grad"], res["kernel"]["grad"]
        ranks = [torch.from_numpy(np.load(SMOKE_DIR / f"{name}_grad_world2_rank{r}.npy"))
                 .to(kernel.device) for r in range(SEQ_SHARDS)]
        if not all(torch.equal(g, ranks[0]) for g in ranks[1:]):
            raise AssertionError(f"{name}: the world-2 ranks' gradients differ")
        print(f"  {name} gradient, 'kernel' against float32 'fft': "
              f"{rel64(kernel, res['fft']['grad']):.3e}", flush=True)
        check(f"{name} gradient, 'kernel' against float64 'fft'", rel64(kernel, g64),
              GRAD_KERNEL_FFT_BAND)
        pairs = {"world 2": (ranks[0], kernel), "remat": (res["remat"]["grad"], kernel),
                 "unsharded": (kernel, res["unsharded"]["grad"])}
        for pair, (a, b) in pairs.items():
            print(f"  {name} gradient, {pair}: from float64 {rel64(a, g64):.3e} and "
                  f"{rel64(b, g64):.3e}", flush=True)
            check(f"{name} gradient, {pair} against its pair", rel64(a, b),
                  GRAD_LIMITS[(name, pair)])


def dryrun_phase() -> float:
    """``python -m specinv_tpu_torch.graft_entry 8`` in a subprocess (its
    own process group, killed whole on a time-out): it must exit 0 and print the
    line of all eleven variants.  Returns its wall time in seconds."""
    import signal

    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "specinv_tpu_torch.graft_entry", str(DRYRUN_RANKS)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    wall = time.perf_counter() - start
    lines = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK: ")]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"dry run exited with {proc.returncode}:\n{out[-2000:]}\n"
                             f"{err[-4000:]}")
    n_variants = len(re.findall(r"[\w-]+ \([\d, ]*\)", lines[0]))
    print(f"  {lines[0]}", flush=True)
    if n_variants != DRYRUN_VARIANTS:
        raise AssertionError(f"dry run printed {n_variants} variants")
    return wall


def seq_rank(rank, world, store, clip_path, batch_paths):
    """One of the two ranks of the world-2 phase, both on ``cuda:0`` over
    gloo (a file store): the seq main path of both algorithms (launch
    counts checked here, waveforms saved by rank 0), its times, then
    ``batched(griffin_lim)`` over the 256 clips, held by rank 0 bit for bit
    against one unsharded call, and a global-stop run whose stop iteration
    (``mode='while'``: the launch count) rank 0 holds against the unsharded
    call's.  A failed check raises, and the process exits nonzero."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    # a collective waits at most 3 minutes for a rank that failed
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=180))
    try:
        import specinv_tpu_torch as st
        from specinv_tpu_torch.parallel import admm_seq, batched, griffin_lim_seq, make_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        res = {}
        mesh = make_mesh(seq=world)
        window = seq_window(mesh.device)
        kw = dict(hop_length=HOP, window=window)
        mag = load_magnitudes([clip_path], window)[0]
        for name, fn, counter, extra in (
            ("griffin_lim_seq", griffin_lim_seq, "gl_fullrun.iteration_launches", {}),
            ("admm_seq", admm_seq, "admm_fullrun.iteration_launches", {"rho": ADMM_RHO}),
        ):
            y, launches = run_seq(f"{name} rank {rank}", fn, mag, mesh, counter, tol=0.0,
                                  **extra, **kw)
            y_es, _ = run_seq(f"{name} tol rank {rank}", fn, mag, mesh, counter, tol=SEQ_TOL,
                              eva_iter=10, **extra, **kw)
            y_few = fn(mag, mesh, max_iter=FEW_ITERS, **extra, **kw)
            if rank == 0:
                for tag, out in (("", y), ("_tol", y_es), ("_few", y_few)):
                    np.save(SMOKE_DIR / f"{name}{tag}_world{world}.npy", out.cpu().numpy())
            res[f"{name} launches"] = launches
            for backend in ("kernel", "fft"):
                res[f"{name} {backend} us/iter"] = seq_us(
                    fn, mag, mesh, dict(kw, backend=backend, **extra), dist.barrier)
        seed = torch.from_numpy(np.load(SMOKE_DIR / "grad_seed.npy")).to(mesh.device)
        clip = torch.from_numpy(np.load(clip_path)[0]).to(mesh.device)
        seq_grad_rank(rank, mesh, seed, clip, kw)
        del seed, clip

        mags = load_magnitudes(batch_paths, window)
        data_mesh = make_mesh(data=world)
        gl_kw = dict(max_iter=MAIN_ITERS, verbose=False, **kw)
        reset_counts()
        dist.barrier()
        start = time.perf_counter()
        yb = batched(st.griffin_lim, data_mesh)(mags, tol=0.0, **gl_kw)
        torch.cuda.synchronize()
        res["batched s"] = time.perf_counter() - start
        check_counts(f"batched rank {rank}", {"gl_fullrun.launches": MAIN_ITERS})
        reset_counts()
        yg = batched(st.griffin_lim, data_mesh, global_stop=True)(
            mags, tol=GLOBAL_STOP_TOL, eva_iter=10, mode="while", **gl_kw)
        res["global stop iterations"] = _kernel_module("gl_fullrun").launches
        if rank == 0:
            torch.cuda.synchronize()
            start = time.perf_counter()
            ref = st.griffin_lim(mags, tol=0.0, **gl_kw)
            torch.cuda.synchronize()
            res["unsharded s"] = time.perf_counter() - start
            res["batched bitwise"] = bool(torch.equal(yb, ref))
            res["batched rel err"] = rel_err(yb, ref)
            reset_counts()
            ref_g = st.griffin_lim(mags, tol=GLOBAL_STOP_TOL, eva_iter=10, mode="while", **gl_kw)
            res["unsharded stop iterations"] = _kernel_module("gl_fullrun").launches
            res["global stop rel err"] = rel_err(yg, ref_g)
            if not bool(torch.isfinite(yb).all()) or yb.shape != ref.shape:
                raise AssertionError("batched: bad output")
        (SMOKE_DIR / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_share(fn) -> float:
    """The device's idle share of one ``fn()`` under ``torch.profiler``: 1
    - the union of its kernels' intervals over the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler saw no device kernel")
    return 1.0 - busy_us((e.time_range.start, e.time_range.end) for e in kernels) / wall_us


def config4_phase(clip, window, smi) -> None:
    """BASELINE config 4 through L_BFGS at full width (see LBFGS_*): three
    float32 runs from the start of seed 0 beside float64 runs from every
    seed of LBFGS_SEEDS, no kernel of the port launched, each final loss in
    its band; then ms per outer step, closure evaluations per inner
    iteration, the peak memory of the call and its history, and the idle
    share under torch.profiler."""
    import specinv_tpu_torch as st
    from specinv_tpu_torch.models import lbfgs

    fn = st.log_mel_transform(n_fft=N_FFT, n_mels=N_MELS, sample_rate=SR, hop_length=HOP,
                              window=window)
    mel32, mel64 = fn(clip), fn(clip.double())
    if mel32.shape != (N_MELS, N_SAMPLES // HOP + 1) or mel32.dtype != torch.float32:
        raise AssertionError(f"log-mel target {tuple(mel32.shape)} {mel32.dtype}")

    def rel_loss(y):  # under the float64 transform
        with torch.no_grad():
            d = fn(y.double()) - mel64
            return float((d * d).mean() / (mel64 * mel64).mean())

    def start(seed):
        gen = torch.Generator(device=clip.device).manual_seed(seed)
        return torch.randn(N_SAMPLES, generator=gen, dtype=torch.float64,
                           device=clip.device) * 1e-6

    runs = {"compact": dict(line_search_fn="strong_wolfe"),
            "bf16 history": dict(line_search_fn="strong_wolfe", history_dtype="bfloat16"),
            "fixed step": dict(line_search_fn=None)}
    common = dict(outer_max_iter=LBFGS_OUTER, max_iter=LBFGS_INNER, history_size=LBFGS_HISTORY,
                  tol=0.0, verbose=False)

    def call(mel, x0, **kw):
        return st.L_BFGS(mel, fn, init_x0=x0, **common, **kw)

    loss64 = {}
    for path in ("strong_wolfe", "fixed"):
        kw = runs["compact" if path == "strong_wolfe" else "fixed step"]
        loss64[path] = [rel_loss(call(mel64, start(s), **kw)) for s in LBFGS_SEEDS]
        decades = np.log10(loss64[path])
        print(f"  float64 {path}: relative log-mel loss over the starts of seeds "
              f"{list(LBFGS_SEEDS)}: {[f'{v:.6e}' for v in loss64[path]]}; spread "
              f"{decades.max() - decades.min():.4f} decades", flush=True)
    for name, kw in runs.items():
        path = "fixed" if name == "fixed step" else "strong_wolfe"
        x0 = start(0).float()
        call(mel32, x0, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        evals0, inner0 = lbfgs.evaluations, lbfgs.inner_iterations
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        y = call(mel32, x0, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        check_counts(f"L_BFGS {name}", {})  # torch.fft and cuBLAS only: no kernel of the port
        evals, inner = lbfgs.evaluations - evals0, lbfgs.inner_iterations - inner0
        if y.shape != (N_SAMPLES,) or y.dtype != torch.float32 or not y.is_cuda \
                or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"L_BFGS {name}: bad output {tuple(y.shape)} {y.dtype} {y.device}")
        loss = rel_loss(y)
        gap = abs(np.log10(loss) - np.log10(loss64[path][0]))
        history = 2 * LBFGS_HISTORY * N_SAMPLES * (2 if "bf16" in name else 4)
        idle = idle_share(lambda: call(mel32, x0, **kw))
        print(f"  L_BFGS {name}: relative log-mel loss {loss:.6e} (float64 from the same start "
              f"{loss64[path][0]:.6e}, {gap:.4f} decades, band {LBFGS_BAND_DECADES[path]}); "
              f"{seconds * 1e3 / LBFGS_OUTER:.2f} ms per outer step, {inner} inner iterations, "
              f"{evals} closure evaluations ({evals / inner:.3f} per inner iteration); peak "
              f"memory of the call {peak / 1e6:.1f} MB, the history {history / 1e6:.1f} MB; idle "
              f"share {100 * idle:.1f} % (torch.profiler) on {smi}", flush=True)
        if not gap <= LBFGS_BAND_DECADES[path]:
            raise AssertionError(f"L_BFGS {name}: {gap:.4f} decades from float64")
        if path == "strong_wolfe" and not loss < LBFGS_CEILING:
            raise AssertionError(f"L_BFGS {name}: relative loss {loss:.3e}")


def mel_phase(clip, window, smi) -> int:
    """mel_to_audio at config 1's geometry: it must launch kernel A exactly
    as griffin_lim does for MAIN_ITERS iterations, and its SC (against the
    float64 NNLS magnitude) lie within MEL_SC_BAND_DB of the float64 call's;
    prints the NNLS time beside the Griffin-Lim time.  Returns the
    launches."""
    import specinv_tpu_torch as st

    fn = st.log_mel_transform(n_fft=N_FFT, n_mels=N_MELS, sample_rate=SR, hop_length=HOP,
                              window=window)
    mel = torch.clamp(torch.exp(fn(clip)) - 1e-6, min=0.0)  # the clip's power mel
    kw = dict(hop_length=HOP, window=window, nnls_iter=MEL_NNLS_ITERS, max_iter=MAIN_ITERS,
              tol=0.0)
    st.mel_to_audio(mel, N_FFT, SR, **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    y = st.mel_to_audio(mel, N_FFT, SR, **kw)
    torch.cuda.synchronize()
    launches = _kernel_module("gl_fullrun").launches
    check_counts("mel_to_audio", {"gl_fullrun.launches": MAIN_ITERS})
    if y.shape != (N_SAMPLES // HOP * HOP,) or not y.is_cuda or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"mel_to_audio: bad output {tuple(y.shape)} on {y.device}")
    w64 = window.double()
    lin64 = st.mel_to_linear(mel.double(), N_FFT, SR, max_iter=MEL_NNLS_ITERS)
    y64 = st.mel_to_audio(mel.double(), N_FFT, SR, **dict(kw, window=w64), backend="fft")

    def sc_db(out):
        return float(st.sc(st.stft(out.double(), N_FFT, hop_length=HOP, window=w64).abs(), lin64))

    sc32, sc64 = sc_db(y), sc_db(y64)
    lin = st.mel_to_linear(mel, N_FFT, SR, max_iter=MEL_NNLS_ITERS)
    nnls_ms = time_ms(lambda: st.mel_to_linear(mel, N_FFT, SR, max_iter=MEL_NNLS_ITERS), 3)
    gl_ms = time_ms(lambda: st.griffin_lim(lin, hop_length=HOP, window=window,
                                           max_iter=MAIN_ITERS, tol=0.0, verbose=False), 3)
    call_ms = time_ms(lambda: st.mel_to_audio(mel, N_FFT, SR, **kw), 3)
    print(f"  mel_to_audio: {launches} launches of gl_fullrun (as griffin_lim's {MAIN_ITERS} "
          f"iterations), no other kernel; SC against the float64 NNLS magnitude {sc32:.4f} dB, "
          f"float64 call {sc64:.4f} dB, gap {abs(sc32 - sc64):.4f} dB (band {MEL_SC_BAND_DB}); "
          f"NNLS ({MEL_NNLS_ITERS} iterations) {nnls_ms:.3f} ms, griffin_lim ({MAIN_ITERS} "
          f"iterations) {gl_ms:.3f} ms, the call {call_ms:.3f} ms on {smi}", flush=True)
    if not abs(sc32 - sc64) <= MEL_SC_BAND_DB:
        raise AssertionError(f"mel_to_audio: SC {sc32:.4f} dB, float64 {sc64:.4f} dB")
    if not sc32 < SC_CEILING_DB:
        raise AssertionError(f"mel_to_audio: SC {sc32:.2f} dB is not below {SC_CEILING_DB} dB")
    return launches


def edges_phase(clip, mag, window, smi) -> None:
    """io (the native codec, a round trip of the clip), the command line in
    a subprocess on the card, and Throughput against event_ms."""
    import specinv_tpu_torch as st
    from specinv_tpu_torch import io as sio
    from specinv_tpu_torch.utils.profiling import Throughput

    if sio.backend() != "native":
        raise AssertionError(f"io backend {sio.backend()!r}, expected 'native'")
    host = clip.cpu().numpy()
    for pcm16, limit in ((False, 0.0), (True, 2 / 32768)):
        path = SMOKE_DIR / f"clip_pcm16_{pcm16}.wav"
        sio.write_wav(str(path), host, SR, pcm16=pcm16)
        back, sr = sio.read_wav(str(path))
        err = float(np.abs(back - np.clip(host, -1, 1)).max())
        if sr != SR or back.shape != host.shape or not err <= limit:
            raise AssertionError(f"io round trip (pcm16={pcm16}): sr {sr}, {back.shape}, {err}")
    print(f"  io: backend {sio.backend()} ({sio.library_path().name}); the clip written and read "
          "back, float32 bit for bit, PCM16 within 2/32768", flush=True)

    out = SMOKE_DIR / "cli_l_bfgs.wav"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "specinv_tpu_torch", "l_bfgs", "--max-iter", "20", "--output",
         str(out)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=600)
    line = re.search(r"^l_bfgs: [\d.]+s, output \((\d+),\), spectral convergence (-?[\d.]+) dB$",
                     proc.stdout, re.M)
    print(f"  python -m specinv_tpu_torch l_bfgs --max-iter 20: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s: {proc.stdout.strip().splitlines()[:1]}", flush=True)
    if proc.returncode != 0 or not line:
        raise AssertionError(f"the command line failed: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-2000:]}")
    back, sr = sio.read_wav(str(out))
    if sr != SR or back.shape != (int(line.group(1)),) or not np.isfinite(back).all():
        raise AssertionError(f"the command line's WAV: sr {sr}, shape {back.shape}")

    kw = dict(hop_length=HOP, window=window, max_iter=MAIN_ITERS, tol=0.0, verbose=False)
    tp = Throughput()
    readings, own = [], []
    for _ in range(9):  # in turns: the call is host-paced, and the host is shared
        tp.measure(lambda: st.griffin_lim(mag, **kw), iters=MAIN_ITERS)
        readings.append(tp.seconds * 1e3)
        own.append(event_ms(lambda: st.griffin_lim(mag, **kw)))
    tp_ms, own = float(np.median(readings)), float(np.median(own))
    print(f"  Throughput on griffin_lim (config 1, {MAIN_ITERS} iterations): {tp_ms:.3f} ms per "
          f"call (median of 9; {MAIN_ITERS / tp_ms * 1e3:.1f} it/s), CUDA events around the "
          f"call {own:.3f} ms (median of 9), {abs(tp_ms - own) / own:.3f} apart (limit "
          f"{THROUGHPUT_AGREE}) on {smi}", flush=True)
    if not abs(tp_ms - own) <= THROUGHPUT_AGREE * own:
        raise AssertionError("Throughput disagrees with the CUDA-event timing")


def marginal_us(fn):
    """Marginal microseconds per iteration of ``fn(n_iters)``: CUDA-event
    medians of 3 runs at 200 and at 100 iterations, differenced."""
    t = {n: [] for n in (100, 200)}
    for _ in range(3):
        for n in (100, 200):
            t[n].append(time_ms(lambda: fn(n), 2))
    return (float(np.median(t[200])) - float(np.median(t[100]))) / 100 * 1000


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    if not (ROOT / "specinv_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    # The corpus clips of the seq and batched phases take a minute of numpy
    # on the host: worker processes make them while the card runs phases 2-3.
    with ProcessPoolExecutor(max_workers=7, mp_context=mp.get_context("spawn")) as pool:
        clip_job = pool.submit(make_clips, str(SMOKE_DIR / "clip10m.npy"), SEQ_SAMPLES, [0])
        batch_jobs = [pool.submit(make_clips, str(SMOKE_DIR / f"clips{i}.npy"), N_SAMPLES,
                                  range(i, min(i + CLIP_CHUNK, BATCH_CLIPS)))
                      for i in range(0, BATCH_CLIPS, CLIP_CHUNK)]
        try:
            smoke(clip_job, batch_jobs)
        finally:
            for job in (clip_job, *batch_jobs):
                job.cancel()


def smoke(clip_job, batch_jobs) -> None:
    """Phases 1-5 (the module docstring); the clips come from the jobs."""
    import specinv_tpu_torch as st
    from specinv_tpu_torch.ops.cuda import (
        _build, admm_fullrun, admm_fused, fft, gl_fullrun, gl_fused, rtisi_fused,
    )
    from specinv_tpu_torch.utils.corpus import make_speech_like

    t_start = time.perf_counter()

    def since() -> str:
        return f"(t = {time.perf_counter() - t_start:.1f} s)"
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[1] device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    print(f"[2] built {[p.name for p in _build._sources()]} with nvcc in "
          f"{_build.last_build_seconds:.2f} s (build + load {time.perf_counter() - t0:.2f} s)",
          flush=True)

    print(f"[3] kernels against their plain versions (float32, on the card) {since()}",
          flush=True)
    frames = torch.from_numpy(
        make_speech_like(431 * N_FFT, seed=3).astype(np.float32)).reshape(431, N_FFT).to(dev)
    spec_k, spec_r = fft.fft(frames), fft.fft_reference(frames)
    back_k, back_r = fft.ifft(spec_r.contiguous(), N_FFT), fft.ifft_reference(spec_r, N_FFT)
    torch.cuda.synchronize()
    check("fft.cu forward (431 x 2048)", rel_err(spec_k, spec_r), FFT_LIMIT)
    check("fft.cu inverse (431 x 2048)", rel_err(back_k, back_r), FFT_LIMIT)
    fft_err = max(abs_err(spec_k, spec_r), abs_err(back_k, back_r))
    # The plain versions' inverse (ops/fourier.inverse) zeroes the imaginary
    # parts of the DC and Nyquist bins before torch.fft.irfft: cuFFT's
    # complex-to-real transform assumes them real, and at the seq shard's
    # 12922 frames its float32 result moved with them (a momentum state and
    # the phase seed have them non-zero).
    from specinv_tpu_torch.ops import fourier

    gen = torch.Generator(device=dev).manual_seed(0)
    for n_frames in (431, SEQ_SHARD_FRAMES):
        spec = torch.randn(1, n_frames, N_FFT // 2 + 1, dtype=torch.complex64, device=dev,
                           generator=gen)
        ref64 = torch.fft.irfft(fourier._real_ends(spec.to(torch.complex128), N_FFT), n=N_FFT)
        as_is = rel64(torch.fft.irfft(spec, n=N_FFT), ref64)
        check(f"irfft of {n_frames} frames with real DC / Nyquist against float64 (as is "
              f"{as_is:.1e})", rel64(torch.fft.irfft(fourier._real_ends(spec, N_FFT), n=N_FFT),
                                     ref64), FFT_LIMIT)

    lr = 0.99 / 1.99
    gl_limits = (X_LIMIT, PLANE_LIMIT, SUM_LIMIT)
    admm_limits = (ADMM_X_LIMIT, ADMM_PLANE_LIMIT, ADMM_SUM_LIMIT)
    cfg1, state1 = kernel_state(N_FFT, HOP, N_SAMPLES, 1, dev)
    if state1[2].shape != (1, 431, 1025):
        raise AssertionError(f"config 1 target shape {tuple(state1[2].shape)}")
    gl_err = admm_err = 0.0
    for n_iters in (1, 5):
        gl_err = max(gl_err, check_kernel(f"gl config 1, {n_iters} it", gl_fullrun,
                                          "fused_gl_run", lr, cfg1, state1, n_iters, gl_limits))
    for n_iters in (1, 5):
        admm_err = max(admm_err, check_kernel(
            f"admm config 2, {n_iters} it", admm_fullrun, "fused_admm_run", ADMM_RHO, cfg1,
            state1, n_iters, admm_limits))
    small = [(512, 128, dict(pad_mode=m)) for m in ("reflect", "constant", "replicate", "circular")]
    small += [(512, 128, dict(center=False)), (512, 160, {}),
              (512, 128, dict(normalized=True)), (256, 64, dict(onesided=False))]
    for n_fft, hop, extra in small + [(512, 384, {})]:
        cfg, state = kernel_state(n_fft, hop, 7800, 2, dev, **extra)
        check_kernel(f"gl {n_fft}/{hop} {extra or 'defaults'}, 5 it", gl_fullrun,
                     "fused_gl_run", lr, cfg, state, 5, gl_limits)
    for n_fft, hop, extra in small:
        cfg, state = kernel_state(n_fft, hop, 7800, 2, dev, **extra)
        check_kernel(f"admm {n_fft}/{hop} {extra or 'defaults'}, 5 it", admm_fullrun,
                     "fused_admm_run", ADMM_RHO, cfg, state, 5, admm_limits)

    print(f"[3] gl_fused.cu / admm_fused.cu (direct DFT: wgmma, and FFMA for 'highest'): 1 and 5 iterations "
          f"beside a float64 plain run {since()}", flush=True)
    gl_dft_err = admm_dft_err = 0.0
    dft_readings = {}

    def note(key, readings):  # the worst reading per (algorithm, tier, iterations)
        for it, rows in readings.items():
            old = dft_readings.setdefault((*key, it), rows)
            dft_readings[(*key, it)] = [tuple(map(max, a, b)) for a, b in zip(old, rows)]

    for tier in DFT_TIERS:
        err, r = check_dft("gl config 1", gl_fused, "fused_gl_iteration", lr, cfg1, state1, tier,
                           (), DFT_LIMITS[tier])
        gl_dft_err = max(gl_dft_err, err)
        note(("gl", str(tier)), r)
        if isinstance(tier, tuple):
            continue
        err, r = check_dft("admm config 2", admm_fused, "fused_admm_iteration", ADMM_RHO, cfg1,
                           state1, tier, (0,), DFT_ADMM_LIMITS[tier])
        admm_dft_err = max(admm_dft_err, err)
        note(("admm", tier), r)
    dft_small = small[:4] + [(512, 128, dict(center=False)), (512, 128, dict(normalized=True)),
                             (400, 160, {}), (512, 160, {}), (1024, 240, {})]
    for n_fft, hop, extra in dft_small:
        cfg, state = kernel_state(n_fft, hop, 7800, 2, dev, **extra)
        tiers = DFT_TIERS if n_fft == 400 else ("high",)  # every tier at the C7 400/160
        for tier in tiers:
            label = f"{n_fft}/{hop} {extra or 'defaults'}"
            err, r = check_dft(f"gl {label}", gl_fused, "fused_gl_iteration", lr, cfg, state,
                               tier, (), DFT_LIMITS[tier])
            gl_dft_err = max(gl_dft_err, err)
            note(("gl", str(tier)), r)
            if isinstance(tier, tuple):
                continue
            err, r = check_dft(f"admm {label}", admm_fused, "fused_admm_iteration", ADMM_RHO,
                               cfg, state, tier, (0,), DFT_ADMM_LIMITS[tier])
            admm_dft_err = max(admm_dft_err, err)
            note(("admm", tier), r)
    # The Whisper cell's shape: 6,016 tiles a product, about 46 a CTA of the
    # persistent kernel on an H100 (the shapes above have one or fewer);
    # both products on it, 2 an iteration.  One iteration, at the limits
    # that hold the kernel's arithmetic: over 5 the float32 plain version
    # itself drifts from float64 as far as the 5-iteration limits (x 9.0e-4
    # on an H100 80GB HBM3, 700 W, the kernel 1.2e-3, against 4e-4) at
    # 96,032 frames.
    cfg16, state16 = kernel_state(C7_N_FFT, C7_HOP, WHISPER_SAMPLES, WHISPER_CHUNKS, dev)
    whisper_products = {}
    for name, mod, run, scalar, extra, limits in (
            ("gl", gl_fused, "fused_gl_iteration", lr, (), DFT_LIMITS),
            ("admm", admm_fused, "fused_admm_iteration", ADMM_RHO, (0,), DFT_ADMM_LIMITS)):
        mod.persistent_products = 0
        err, r = check_dft(f"{name} {C7_N_FFT}/{C7_HOP} {WHISPER_CHUNKS} x 30 s", mod, run,
                           scalar, cfg16, state16, "high", extra, limits["high"], n_iters=1)
        whisper_products[name] = mod.persistent_products
        if whisper_products[name] != 2:
            raise AssertionError(f"{name} at the Whisper shape: {whisper_products[name]} "
                                 f"products on the persistent kernel, expected 2")
        if name == "gl":
            gl_dft_err = max(gl_dft_err, err)
        else:
            admm_dft_err = max(admm_dft_err, err)
        note((name, "high"), r)
    print(f"  persistent products at the Whisper shape (1 iteration): {whisper_products}",
          flush=True)
    del state16
    print("  worst readings (kernel-plain, kernel-f64, plain-f64; x / |S| / state):", flush=True)
    for key, rows in dft_readings.items():
        print(f"    {key}: " + " / ".join(f"({r[0]:.1e}, {r[1]:.1e}, {r[2]:.1e})" for r in rows),
              flush=True)

    print(f"[3] rtisi_fused.cu: 8 single steps from a real state, then a launch of 8 "
          f"{since()}", flush=True)
    rtisi_err, rtisi_mid = 0.0, {}
    rtisi_states = rtisi_check_states(dev)
    for batch in (1, 16):  # config 3, from step 100 of the clip
        cfg3, la3, tgt3, win3, st3 = rtisi_state(N_FFT, HOP, N_SAMPLES, batch, dev)
        if tgt3.shape != (batch, 431 + 2 * RTISI_LA_FRAMES, 1025):
            raise AssertionError(f"config 3 target shape {tuple(tgt3.shape)}")
        st3 = frozen_state(rtisi_states, f"cfg3_b{batch}", st3)
        rtisi_mid[batch] = (cfg3, la3, tgt3, win3, st3)
        rtisi_err = max(rtisi_err, check_rtisi(f"config 3, B={batch}", cfg3, la3, tgt3, win3,
                                               st3, 100, RTISI_LIMITS[batch]))
    # Small geometries at batch 2 under a hamming window, from step 12 (step
    # 0 where frames do not overlap: then only the first frame is seeded).
    for idx, (n_fft, hop, extra) in enumerate(RTISI_SMALL):
        extra = {"window": "hamming", **extra}
        cfg, la, tgt, win, state = rtisi_state(n_fft, hop, max(7800, 8 * n_fft), 2, dev, **extra)
        i0 = 0 if hop == n_fft else 12
        state = frozen_state(rtisi_states, f"small{idx}", state)
        rtisi_err = max(rtisi_err, check_rtisi(f"{n_fft}/{hop} {extra}", cfg, la, tgt, win,
                                               state, i0, RTISI_SMALL_LIMITS))
    # The mixed-radix instance at the rtisi400_16k_batch32 cell's shape: every
    # one of check_rtisi's 17 launches runs it.
    cfg, la, tgt, win, state = mixed_rtisi_state(dev)
    reset_counts()
    rtisi_err = max(rtisi_err, check_rtisi(
        f"{C7_N_FFT}/{C7_HOP}, {WHISPER_CHUNKS} x 30 s at 16 kHz", cfg, la, tgt, win, state,
        MIXED_RTISI_I0, RTISI_MIXED_LIMITS))
    if (rtisi_fused.launches, rtisi_fused.mixed_radix_launches) != (17, 17):
        raise AssertionError(f"rtisi {C7_N_FFT}/{C7_HOP}: {rtisi_fused.launches} launches, "
                             f"{rtisi_fused.mixed_radix_launches} mixed-radix, expected 17")
    del cfg, la, tgt, win, state

    print(f"[3] the raw per-iteration dispatch (K4 gl_fused4._kernel, K6 "
          f"admm_fused4._kernel_iter): shard 0 and 1 of the 10-minute clip at 2 shards "
          f"({SEQ_SHARD_FRAMES} frames) and the whole clip at 1 ({SEQ_W1_FRAMES} frames), 1 "
          f"and 5 launches beside a float64 plain run {since()}", flush=True)
    win1 = seq_window(dev)
    clip10 = torch.from_numpy(np.load(clip_job.result())[0]).to(dev)
    mag10 = st.stft(clip10, N_FFT, hop_length=HOP, window=win1).abs()  # (F, T)
    if mag10.shape != (N_FFT // 2 + 1, SEQ_FRAMES):
        raise AssertionError(f"10-minute spectrogram shape {tuple(mag10.shape)}")
    mag10_tm = mag10.T[None].contiguous()
    shard0, valid0 = seq_shard_state(mag10_tm, cfg1, win1, 0)
    shard1, valid1 = seq_shard_state(mag10_tm, cfg1, win1, 1)
    if shard0[2].shape[-2] != SEQ_SHARD_FRAMES or (valid0, valid1) != (12922, 12918):
        raise AssertionError(f"shard geometry {tuple(shard0[2].shape)}, valid {valid0}/{valid1}")
    gl_raw_err = check_raw("gl raw, shard 0", gl_fullrun, "fused_gl_iteration", lr, cfg1,
                           shard0, valid0, 5, RAW_GL_LIMITS)
    admm_raw_err = max(
        check_raw("admm raw, shard 0 (valid_t all)", admm_fullrun, "fused_admm_iteration",
                  ADMM_RHO, cfg1, shard0, valid0, 5, admm_limits),
        check_raw("admm raw, shard 1 (valid_t 12918 of 12922)", admm_fullrun,
                  "fused_admm_iteration", ADMM_RHO, cfg1, shard1, valid1, 1, admm_limits),
        check_raw("admm raw, shard 0 at valid_t 0", admm_fullrun, "fused_admm_iteration",
                  ADMM_RHO, cfg1, shard0, 0, 1, admm_limits))
    # world 1: the whole padded clip in one launch, as the in-process seq run
    # of phase 4 gives it
    whole1, valid_w1 = seq_shard_state(mag10_tm, cfg1, win1, 0, n=1)
    if whole1[2].shape[-2] != SEQ_W1_FRAMES or valid_w1 != SEQ_FRAMES:
        raise AssertionError(f"world-1 geometry {tuple(whole1[2].shape)}, valid {valid_w1}")
    gl_raw_err = max(gl_raw_err, check_raw(
        f"gl raw, world 1 ({SEQ_W1_FRAMES} frames)", gl_fullrun, "fused_gl_iteration", lr, cfg1,
        whole1, valid_w1, 5, RAW_W1_GL_LIMITS))
    admm_raw_err = max(admm_raw_err, check_raw(
        f"admm raw, world 1 (valid_t {SEQ_FRAMES} of {SEQ_W1_FRAMES})", admm_fullrun,
        "fused_admm_iteration", ADMM_RHO, cfg1, whole1, valid_w1, 5, RAW_W1_ADMM_LIMITS))
    for n_fft, hop, extra in small + [(512, 384, {})]:
        cfg, state = kernel_state(n_fft, hop, 7800, 2, dev, **extra)
        label = f"{n_fft}/{hop} {extra or 'defaults'}"
        gl_raw_err = max(gl_raw_err, check_raw(f"gl raw {label}", gl_fullrun,
                                               "fused_gl_iteration", lr, cfg, state[:4], None,
                                               5, gl_limits))
        admm_raw_err = max(admm_raw_err, check_raw(f"admm raw {label}", admm_fullrun,
                                                   "fused_admm_iteration", ADMM_RHO, cfg,
                                                   state[:4], None, 5, admm_limits))

    clip = torch.from_numpy(make_speech_like(N_SAMPLES, seed=0).astype(np.float32)).to(dev)
    window = torch.hann_window(N_FFT, device=dev)
    mag = st.stft(clip, N_FFT, hop_length=HOP, window=window).abs()
    if mag.shape != (N_FFT // 2 + 1, 431):
        raise AssertionError(f"main-path spectrogram shape {tuple(mag.shape)}")
    kw = dict(hop_length=HOP, window=window, verbose=False)
    expected_len = (431 - 1) * HOP

    def sc_db(y):
        return float(st.sc(st.stft(y, N_FFT, hop_length=HOP, window=window).abs(), mag))

    scs = {}

    persistent = {}  # the 'dft' main paths' products on the persistent kernel

    def drive(name, fn, mod, band, ceiling, spec=mag, sc_of=sc_db, kw=kw):
        """One main path: 100 iterations through the kernel (launch count
        read), SC against the torch.fft path, then with early stopping."""
        expected = (spec.shape[-1] - 1) * kw["hop_length"]
        reset_counts()
        if hasattr(mod, "persistent_products"):
            mod.persistent_products = 0
        y = fn(spec, max_iter=MAIN_ITERS, tol=0.0, **kw)
        torch.cuda.synchronize()
        launches = mod.launches
        if hasattr(mod, "persistent_products"):  # both products in 'high'
            persistent[name] = mod.persistent_products
            if persistent[name] != 2 * MAIN_ITERS:
                raise AssertionError(f"{name}: {persistent[name]} products on the persistent "
                                     f"kernel, expected {2 * MAIN_ITERS}")
        if y.shape != (expected,) or y.device != clip.device or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"bad output: {tuple(y.shape)} on {y.device}")
        # this kernel MAIN_ITERS times, no other kernel of the port
        check_counts(name, {f"{mod.__name__.rsplit('.', 1)[-1]}.launches": MAIN_ITERS})
        y_fft = fn(spec, max_iter=MAIN_ITERS, tol=0.0, backend="fft", **kw)
        sc_k, sc_f = sc_of(y), sc_of(y_fft)
        scs[name] = (sc_k, sc_f)
        print(f"  kernel launches {launches} (expected {MAIN_ITERS}); products on the persistent "
              f"kernel {persistent.get(name, 'none')}; output {tuple(y.shape)} finite", flush=True)
        print(f"  SC after {MAIN_ITERS} it: kernel {sc_k:.4f} dB, fft {sc_f:.4f} dB, "
              f"diff {abs(sc_k - sc_f):.4f} dB (band {band})", flush=True)
        if not abs(sc_k - sc_f) <= band:
            raise AssertionError(f"{name}: kernel and fft paths disagree on SC")
        if not sc_k < ceiling:
            raise AssertionError(f"{name}: SC {sc_k:.2f} dB is not below {ceiling} dB")
        before = mod.launches
        y_es = fn(spec, max_iter=MAIN_ITERS, tol=1e-6, eva_iter=10, **kw)
        es_launches = mod.launches - before
        print(f"  tol=1e-6, eva_iter=10: {es_launches} launches, SC {sc_of(y_es):.4f} dB", flush=True)
        if es_launches != MAIN_ITERS or not bool(torch.isfinite(y_es).all()):
            raise AssertionError(f"{name}: early-stopping run went wrong")
        return launches

    def sc_anchor(fn, spec=mag, n_fft=N_FFT, kw=kw, iters=MAIN_ITERS):
        """Final SC (dB) of the torch.fft path in float64 from ``spec``."""
        w64 = kw["window"].double()
        k64 = dict(kw, window=w64)
        y64 = fn(spec.double(), max_iter=iters, tol=0.0, backend="fft", **k64)
        return float(st.sc(st.stft(y64, n_fft, hop_length=kw["hop_length"], window=w64).abs(),
                           spec.double()))

    print(f"[4] main path: griffin_lim, 10 s clip, n_fft 2048, hop 512, 100 iterations "
          f"{since()}", flush=True)
    gl_launches = drive("griffin_lim", st.griffin_lim, gl_fullrun, SC_BAND_DB, SC_CEILING_DB)

    def admm(spec, **k):
        return st.ADMM(spec, rho=ADMM_RHO, **k)

    print(f"[4] main path: ADMM, rho {ADMM_RHO}, 10 s clip, n_fft 2048, hop 512, 100 iterations",
          flush=True)
    admm_launches = drive("ADMM", admm, admm_fullrun, ADMM_SC_BAND_DB, ADMM_SC_CEILING_DB)

    def gl_dft(spec, backend="dft", **k):
        return st.griffin_lim(spec, backend=backend, **k)

    def admm_dft(spec, backend="dft", **k):
        return st.ADMM(spec, rho=ADMM_RHO, backend=backend, **k)

    print(f"[4] main path: griffin_lim(backend='dft'), config 1, {MAIN_ITERS} iterations, "
          f"precision {st.ops.fourier.default_precision()} {since()}", flush=True)
    gl_dft_launches = drive("griffin_lim dft", gl_dft, gl_fused, DFT_SC_BAND_DB, SC_CEILING_DB)
    print(f"[4] main path: ADMM(backend='dft'), rho {ADMM_RHO}, config 2, {MAIN_ITERS} "
          f"iterations {since()}", flush=True)
    admm_dft_launches = drive("ADMM dft", admm_dft, admm_fused, DFT_ADMM_SC_BAND_DB,
                              ADMM_SC_CEILING_DB)
    sc64 = {"griffin_lim": sc_anchor(st.griffin_lim), "ADMM": sc_anchor(admm_dft)}
    for name in ("griffin_lim", "ADMM"):
        print(f"  {name} float64 fft path SC {sc64[name]:.4f} dB; distance from it: kernel "
              f"{abs(scs[name][0] - sc64[name]):.4f}, dft {abs(scs[name + ' dft'][0] - sc64[name]):.4f}"
              f", float32 fft {abs(scs[name][1] - sc64[name]):.4f} dB", flush=True)

    print(f"[4] {QUALITY_ITERS} iterations of griffin_lim and ADMM through 'kernel' and 'dft' "
          f"beside the float64 torch.fft path {since()}", flush=True)
    for name, fn, mod, anchor_fn, backend in (
            ("griffin_lim", st.griffin_lim, gl_fullrun, st.griffin_lim, "kernel"),
            ("ADMM", admm, admm_fullrun, admm_dft, "kernel"),
            ("griffin_lim dft", gl_dft, gl_fused, st.griffin_lim, "dft"),
            ("ADMM dft", admm_dft, admm_fused, admm_dft, "dft")):
        reset_counts()
        y = fn(mag, max_iter=QUALITY_ITERS, tol=0.0, backend=backend, **kw)
        torch.cuda.synchronize()
        check_counts(f"{name} {QUALITY_ITERS} it",
                     {f"{mod.__name__.rsplit('.', 1)[-1]}.launches": QUALITY_ITERS})
        if y.shape != (expected_len,) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name} {QUALITY_ITERS} it: bad output {tuple(y.shape)}")
        sc_k, sc_a = sc_db(y), sc_anchor(anchor_fn, iters=QUALITY_ITERS)
        gap = abs(sc_k - sc_a)
        print(f"  {name}: SC {backend} {sc_k:.6f} dB, float64 fft path {sc_a:.6f} dB, gap "
              f"{gap:.6f} dB (band {QUALITY_BAND_DB[name]}; the North star's bar 1e-3)",
              flush=True)
        if not gap <= QUALITY_BAND_DB[name]:
            raise AssertionError(f"{name}: {QUALITY_ITERS}-iteration SC gap {gap:.6f} dB exceeds "
                                 f"{QUALITY_BAND_DB[name]} dB")

    c7_window = torch.hann_window(C7_N_FFT, device=dev)
    c7_kw = dict(hop_length=C7_HOP, window=c7_window, verbose=False)
    c7_mag = st.stft(clip, C7_N_FFT, hop_length=C7_HOP, window=c7_window).abs()

    def c7_sc(y):
        return float(st.sc(st.stft(y, C7_N_FFT, hop_length=C7_HOP, window=c7_window).abs(),
                           c7_mag))

    print(f"[4] main path: griffin_lim(backend='auto'), 10 s clip, n_fft {C7_N_FFT}, hop "
          f"{C7_HOP} ({c7_mag.shape[-1]} frames, F {c7_mag.shape[0]}): the direct-DFT kernel "
          f"{since()}", flush=True)
    drive("griffin_lim auto 400/160", st.griffin_lim, gl_fused, C7_SC_BAND_DB, SC_CEILING_DB,
          spec=c7_mag, sc_of=c7_sc, kw=c7_kw)
    c7_sc64 = sc_anchor(st.griffin_lim, c7_mag, C7_N_FFT, c7_kw)
    print(f"  float64 fft path SC {c7_sc64:.4f} dB; distance from it: dft "
          f"{abs(scs['griffin_lim auto 400/160'][0] - c7_sc64):.4f}, float32 fft "
          f"{abs(scs['griffin_lim auto 400/160'][1] - c7_sc64):.4f} dB", flush=True)

    import importlib

    rt = importlib.import_module("specinv_tpu_torch.models.rtisi_la")
    rtisi_kw = dict(look_ahead=RTISI_LA_FRAMES, max_iter=RTISI_ITERS, **kw)
    rtisi_expected = -(-(431 + RTISI_LA_FRAMES) // 8)
    print(f"[4] main path: RTISI_LA, look-ahead {RTISI_LA_FRAMES}, {RTISI_ITERS} refinements, "
          f"10 s clip, n_fft 2048, hop 512 {since()}", flush=True)
    recorded, synthesize = {}, rt.synthesize

    def record(frames, *args):  # the committed frames the offline call synthesizes
        recorded["frames"] = frames
        return synthesize(frames, *args)

    reset_counts()
    rt.synthesize = record
    try:
        y = st.RTISI_LA(mag, **rtisi_kw)
        torch.cuda.synchronize()
    finally:
        rt.synthesize = synthesize
    rtisi_launches = rtisi_fused.launches
    if y.shape != (expected_len,) or y.device != clip.device or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"RTISI_LA: bad output {tuple(y.shape)} on {y.device}")
    if (rtisi_launches, rtisi_fused.mixed_radix_launches) != (rtisi_expected, 0):
        raise AssertionError(f"RTISI_LA: {rtisi_launches} launches "
                             f"({rtisi_fused.mixed_radix_launches} mixed-radix), expected "
                             f"{rtisi_expected} (0)")
    sc_k, sc_f = sc_db(y), sc_db(st.RTISI_LA(mag, backend="fft", **rtisi_kw))
    print(f"  kernel launches {rtisi_launches} (expected {rtisi_expected}); output "
          f"{tuple(y.shape)} finite", flush=True)
    print(f"  SC: kernel {sc_k:.4f} dB, fft {sc_f:.4f} dB, diff {abs(sc_k - sc_f):.4f} dB "
          f"(band {RTISI_SC_BAND_DB}, ceiling {RTISI_SC_CEILING_DB})", flush=True)
    if not abs(sc_k - sc_f) <= RTISI_SC_BAND_DB:
        raise AssertionError("RTISI_LA: kernel and fft paths disagree on SC")
    if not sc_k < RTISI_SC_CEILING_DB:
        raise AssertionError(f"RTISI_LA: SC {sc_k:.2f} dB is not below {RTISI_SC_CEILING_DB} dB")

    class RecordingStreamer(st.RTISIStreamer):
        def _emit(self, committed):
            self.committed.append(committed)
            return super()._emit(committed)

    print(f"[4] main path: RTISIStreamer over the same 431 frames, then flush {since()}",
          flush=True)
    reset_counts()
    streamer = RecordingStreamer(N_FFT // 2 + 1, look_ahead=RTISI_LA_FRAMES,
                                 max_iter=RTISI_ITERS, hop_length=HOP, window=window)
    streamer.committed = []
    chunks = [streamer.push(mag[:, t]) for t in range(mag.shape[1])]
    chunks = [c for c in chunks if c is not None] + [streamer.flush()]
    torch.cuda.synchronize()
    stream_launches = rtisi_fused.launches
    streamed = torch.cat(chunks, dim=1)
    print(f"  kernel launches {stream_launches} (expected {431 + RTISI_LA_FRAMES}); "
          f"{streamed.shape[1]} samples", flush=True)
    if stream_launches != 431 + RTISI_LA_FRAMES or not bool(torch.isfinite(streamed).all()):
        raise AssertionError("RTISIStreamer: wrong launch count or non-finite samples")
    if not torch.equal(torch.stack(streamer.committed), recorded["frames"]):
        raise AssertionError("RTISIStreamer: committed frames differ from the offline path's")
    print("  committed frames equal the offline kernel path's, bit for bit", flush=True)

    c7_frames, c7_la = c7_mag.shape[-1], (C7_N_FFT - 1) // C7_HOP
    c7_expected = -(-(c7_frames + c7_la) // 8)
    c7_rtisi_kw = dict(look_ahead=c7_la, max_iter=RTISI_ITERS, **c7_kw)  # the entry's default
    print(f"[4] main path: RTISI_LA and RTISIStreamer on 'auto' at n_fft {C7_N_FFT}, hop "
          f"{C7_HOP}, look-ahead {c7_la}, {RTISI_ITERS} refinements, the 10 s clip "
          f"({c7_frames} frames): kernel D's mixed-radix instance {since()}", flush=True)
    reset_counts()
    rt.synthesize = record
    try:
        y = st.RTISI_LA(c7_mag, **c7_rtisi_kw)
        torch.cuda.synchronize()
    finally:
        rt.synthesize = synthesize
    if (rtisi_fused.launches, rtisi_fused.mixed_radix_launches) != (c7_expected,) * 2:
        raise AssertionError(f"RTISI_LA {C7_N_FFT}/{C7_HOP}: {rtisi_fused.launches} launches, "
                             f"{rtisi_fused.mixed_radix_launches} mixed-radix, expected "
                             f"{c7_expected}")
    if y.shape != ((c7_frames - 1) * C7_HOP,) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"RTISI_LA {C7_N_FFT}/{C7_HOP}: bad output {tuple(y.shape)}")
    sc_k, sc_f = c7_sc(y), c7_sc(st.RTISI_LA(c7_mag, backend="fft", **c7_rtisi_kw))
    print(f"  kernel launches {c7_expected}, each mixed-radix; SC: kernel {sc_k:.4f} dB, fft "
          f"{sc_f:.4f} dB, diff {abs(sc_k - sc_f):.4f} dB (band {C7_RTISI_SC_BAND_DB}, ceiling "
          f"{C7_RTISI_SC_CEILING_DB})", flush=True)
    if not abs(sc_k - sc_f) <= C7_RTISI_SC_BAND_DB:
        raise AssertionError(f"RTISI_LA {C7_N_FFT}/{C7_HOP}: kernel and fft paths disagree on SC")
    if not sc_k < C7_RTISI_SC_CEILING_DB:
        raise AssertionError(f"RTISI_LA {C7_N_FFT}/{C7_HOP}: SC {sc_k:.2f} dB is not below "
                             f"{C7_RTISI_SC_CEILING_DB} dB")
    reset_counts()
    streamer = RecordingStreamer(C7_N_FFT // 2 + 1, look_ahead=c7_la, max_iter=RTISI_ITERS,
                                 hop_length=C7_HOP, window=c7_window)
    streamer.committed = []
    chunks = [streamer.push(c7_mag[:, t]) for t in range(c7_frames)]
    chunks = [c for c in chunks if c is not None] + [streamer.flush()]
    torch.cuda.synchronize()
    if (rtisi_fused.launches, rtisi_fused.mixed_radix_launches) != (c7_frames + c7_la,) * 2:
        raise AssertionError(f"RTISIStreamer {C7_N_FFT}/{C7_HOP}: {rtisi_fused.launches} "
                             f"launches, {rtisi_fused.mixed_radix_launches} mixed-radix, "
                             f"expected {c7_frames + c7_la}")
    if not bool(torch.isfinite(torch.cat(chunks, dim=1)).all()):
        raise AssertionError(f"RTISIStreamer {C7_N_FFT}/{C7_HOP}: non-finite samples")
    if not torch.equal(torch.stack(streamer.committed), recorded["frames"]):
        raise AssertionError(f"RTISIStreamer {C7_N_FFT}/{C7_HOP}: committed frames differ from "
                             "the offline path's")
    c7_rtisi_launches = c7_expected + c7_frames + c7_la
    print(f"  streamer: {c7_frames + c7_la} launches, each mixed-radix; committed frames equal "
          f"the offline kernel path's, bit for bit", flush=True)

    print(f"[4] main path: BASELINE config 4, L_BFGS on the {N_MELS}-band log-mel of the 10 s "
          f"clip, {LBFGS_OUTER} x {LBFGS_INNER} iterations, history {LBFGS_HISTORY} {since()}",
          flush=True)
    config4_phase(clip, window, smi)
    print(f"[4] main path: mel_to_audio, {N_MELS} mels, NNLS {MEL_NNLS_ITERS} iterations, "
          f"griffin_lim {MAIN_ITERS} iterations ('auto') {since()}", flush=True)
    mel_launches = mel_phase(clip, window, smi)
    print(f"[4] io, the command line and Throughput {since()}", flush=True)
    edges_phase(clip, mag, window, smi)

    from specinv_tpu_torch.parallel import admm_seq, griffin_lim_seq, make_mesh

    print(f"[4] main path: griffin_lim_seq and admm_seq (rho {ADMM_RHO}), 10-minute clip "
          f"({SEQ_SAMPLES} samples, {SEQ_FRAMES} frames), n_fft 2048, hop 512, {MAIN_ITERS} "
          f"iterations, backend 'auto': world size 1 (the 1x1 mesh, in this process) "
          f"{since()}", flush=True)
    mesh1 = make_mesh()
    seq_kw = dict(hop_length=HOP, window=win1)
    window64 = win1.double()

    def sc10(y):
        w = window64 if y.dtype == torch.float64 else win1
        ref = mag10.double() if y.dtype == torch.float64 else mag10
        return float(st.sc(st.stft(y, N_FFT, hop_length=HOP, window=w).abs(), ref))

    seq_paths = (
        ("griffin_lim_seq", griffin_lim_seq, "gl_fullrun.iteration_launches", {}, st.griffin_lim),
        ("admm_seq", admm_seq, "admm_fullrun.iteration_launches", {"rho": ADMM_RHO}, st.ADMM),
    )
    seq1 = {}
    for name, fn, counter, extra, whole in seq_paths:
        y, launches = run_seq(name, fn, mag10, mesh1, counter, tol=0.0, **extra, **seq_kw)
        y_es, _ = run_seq(f"{name} tol", fn, mag10, mesh1, counter, tol=SEQ_TOL, eva_iter=10,
                          **extra, **seq_kw)
        y_whole = whole(mag10, max_iter=MAIN_ITERS, tol=0.0, verbose=False, **extra, **seq_kw)
        y64 = fn(mag10.double(), mesh1, max_iter=MAIN_ITERS, backend="fft", hop_length=HOP,
                 window=window64, **extra)
        y_few = fn(mag10, mesh1, max_iter=FEW_ITERS, **extra, **seq_kw)
        y_whole_few = whole(mag10, max_iter=FEW_ITERS, tol=0.0, verbose=False, **extra, **seq_kw)
        seq1[name] = dict(y=y, y_few=y_few, launches=launches, sc=sc10(y), sc_es=sc10(y_es),
                          sc_whole=sc10(y_whole), sc64=sc10(y64), whole_err=rel_err(y, y_whole),
                          whole_few=rel_err(y_few, y_whole_few))
        r = seq1[name]
        print(f"  {name}: {launches} raw launches, no other kernel; SC seq {r['sc']:.4f} dB, "
              f"tol {SEQ_TOL} {r['sc_es']:.4f}, unsharded {whole.__name__} {r['sc_whole']:.4f}, "
              f"float64 seq (fft) {r['sc64']:.4f} dB; x against the unsharded call "
              f"{r['whole_err']:.3e} of its max after {MAIN_ITERS} iterations, "
              f"{r['whole_few']:.3e} after {FEW_ITERS}", flush=True)
        check(f"{name} world 1 against the unsharded call, x after {FEW_ITERS}",
              r["whole_few"], SEQ_WHOLE_LIMITS[name])

    print(f"[4] seq gradients at full width: d mean((y - clip)^2) / d spec, {FEW_ITERS} "
          f"iterations, tol 0, from the SPSI seed of the 10-minute clip; world size 1 "
          f"{since()}", flush=True)
    grad_seed = st.phase_init(mag10, hop_length=HOP, window=win1)  # also the ranks' input
    np.save(SMOKE_DIR / "grad_seed.npy", grad_seed.cpu().numpy())
    grads = grad_phase(grad_seed, clip10, win1, smi)
    del grad_seed

    print(f"[4] main path at world size 2: two processes on cuda:0 over gloo (file store under "
          f"build/), griffin_lim_seq / admm_seq, then batched(griffin_lim) over "
          f"{BATCH_CLIPS} clips {since()}", flush=True)
    batch_paths = [job.result() for job in batch_jobs]
    store = SMOKE_DIR / "store"
    for stale in (store, *SMOKE_DIR.glob("rank*.json")):
        stale.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    ranks = [ctx.Process(target=seq_rank, args=(r, SEQ_SHARDS, str(store), clip_job.result(),
                                                 batch_paths)) for r in range(SEQ_SHARDS)]
    for proc in ranks:
        proc.start()
    for proc in ranks:
        proc.join(420)
    for proc in ranks:
        if proc.is_alive():
            proc.kill()
            proc.join()
    codes = [proc.exitcode for proc in ranks]
    if codes != [0] * SEQ_SHARDS:
        raise AssertionError(f"world-2 ranks exited with {codes}")
    res2 = [json.loads((SMOKE_DIR / f"rank{r}.json").read_text()) for r in range(SEQ_SHARDS)]
    for name, *_ in seq_paths:
        y2 = torch.from_numpy(np.load(SMOKE_DIR / f"{name}_world2.npy")).to(dev)
        y2_es = torch.from_numpy(np.load(SMOKE_DIR / f"{name}_tol_world2.npy")).to(dev)
        y2_few = torch.from_numpy(np.load(SMOKE_DIR / f"{name}_few_world2.npy")).to(dev)
        r = seq1[name]
        r.update(sc2=sc10(y2), sc2_es=sc10(y2_es), w2_err=rel_err(y2_few, r["y_few"]),
                 w2_err_main=rel_err(y2, r["y"]))
        print(f"  {name}, world 2: {MAIN_ITERS} raw launches per rank, no other kernel; SC "
              f"{r['sc2']:.4f} dB (tol {SEQ_TOL}: {r['sc2_es']:.4f}); against world 1: x "
              f"{r['w2_err']:.3e} of its max after {FEW_ITERS} iterations, "
              f"{r['w2_err_main']:.3e} after {MAIN_ITERS}; SC {abs(r['sc2'] - r['sc']):.4f} dB",
              flush=True)
    for name, band, ceiling in (("griffin_lim_seq", SEQ_SC_BAND_DB, SC_CEILING_DB),
                                ("admm_seq", SEQ_ADMM_SC_BAND_DB, ADMM_SC_CEILING_DB)):
        r = seq1[name]
        check(f"{name} world 2 against world 1, x after {FEW_ITERS}", r["w2_err"],
              SEQ_X_LIMITS[name])
        for label, sc in (("world 1", r["sc"]), ("world 2", r["sc2"]),
                          ("world 1 tol", r["sc_es"]), ("world 2 tol", r["sc2_es"]),
                          ("unsharded", r["sc_whole"])):
            print(f"  {name} {label}: SC {sc:.4f} dB, {abs(sc - r['sc64']):.4f} dB from the "
                  f"float64 seq run (band {band})", flush=True)
            if not abs(sc - r["sc64"]) <= band:
                raise AssertionError(f"{name} {label}: SC {sc:.4f} dB, float64 {r['sc64']:.4f}")
            if not sc < ceiling:
                raise AssertionError(f"{name} {label}: SC {sc:.2f} dB is not below {ceiling}")
    b0 = res2[0]
    print(f"  batched(griffin_lim), {BATCH_CLIPS} clips over 2 ranks: {MAIN_ITERS} launches "
          f"of kernel A per rank, no other kernel; against one unsharded call: bit for bit "
          f"{b0['batched bitwise']} (max rel err {b0['batched rel err']:.3e}); global stop "
          f"(tol {GLOBAL_STOP_TOL}) after {b0['global stop iterations']} iterations, the "
          f"unsharded call after {b0['unsharded stop iterations']}", flush=True)
    if not b0["batched bitwise"]:
        raise AssertionError("batched(griffin_lim) differs from the unsharded call")
    stops = {res["global stop iterations"] for res in res2}
    unsharded_stop = b0["unsharded stop iterations"]
    if stops != {unsharded_stop} or not unsharded_stop < MAIN_ITERS:
        raise AssertionError(f"global stop after {stops} iterations, unsharded after "
                             f"{b0['unsharded stop iterations']}")
    check("batched global stop against the unsharded call, x", b0["global stop rel err"],
          X_LIMIT)
    check_grads(grads)

    print(f"[4] the dry run on the card: graft_entry.dryrun_multichip({DRYRUN_RANKS}) in a "
          f"subprocess, {DRYRUN_RANKS} ranks on cuda:0 over gloo {since()}", flush=True)
    dry_s = dryrun_phase()
    print(f"  dry run: exit 0 in {dry_s:.1f} s (wall, spawn and set-up included) on {smi}",
          flush=True)

    print(f"[5] marginal time per iteration (CUDA events, 200 - 100 iterations) {since()}",
          flush=True)
    paths = (("griffin_lim", st.griffin_lim), ("ADMM", admm))
    variants = {"fft": dict(backend="fft"), "kernel": dict(backend="kernel"),
                "dft": dict(backend="dft", precision="high"),
                "dft highest": dict(backend="dft", precision="highest")}
    us = {}
    # both algorithms in each turn; the turns run forward, then backward
    for variant in ("fft", "kernel", "dft", "dft highest", "dft highest", "dft", "kernel", "fft"):
        for name, fn in paths:
            us.setdefault((name, variant), []).append(marginal_us(
                lambda n: fn(mag, max_iter=n, tol=0.0, **variants[variant], **kw)))
    for variant in ("fft", "dft", "dft", "fft"):  # the C7 geometry, 400/160
        us.setdefault(("griffin_lim 400/160", variant), []).append(marginal_us(
            lambda n: st.griffin_lim(c7_mag, max_iter=n, tol=0.0, **variants[variant], **c7_kw)))
    us = {key: float(np.mean(v)) for key, v in us.items()}
    for name, _ in paths:
        print(f"  {name}: " + ", ".join(
            f"{v} path {us[(name, v)]:.2f} us/iter ({1e6 / us[(name, v)]:.1f} it/s)"
            for v in variants) + f" on {smi}", flush=True)
    print("  griffin_lim 400/160: " + ", ".join(
        f"{v} path {us[('griffin_lim 400/160', v)]:.2f} us/iter" for v in ("dft", "fft"))
          + f" on {smi}", flush=True)

    x_pad, seed, tgt, win, inv_env = state1

    def per_iter_ms(fn, scalar):
        return time_ms(lambda: fn(x_pad, seed, tgt, win, inv_env, scalar, cfg1, 100), 3) / 100

    gl_ms = per_iter_ms(gl_fullrun.fused_gl_run, lr)
    gl_plain_ms = per_iter_ms(gl_fullrun.fused_gl_run_reference, lr)
    admm_ms = per_iter_ms(admm_fullrun.fused_admm_run, ADMM_RHO)
    admm_plain_ms = per_iter_ms(admm_fullrun.fused_admm_run_reference, ADMM_RHO)
    # B's device time is below the host's time to call its wrappers: timed
    # as a CUDA graph of the calls, beside the same graph of its plain version
    # (torch.fft, also its library call), and each as called (the host's pace)
    fft_ms = graph_ms(lambda: fft.ifft(fft.fft(frames), N_FFT))
    fft_plain_ms = graph_ms(lambda: fft.ifft_reference(fft.fft_reference(frames), N_FFT))
    fft_call_ms = time_ms(lambda: fft.ifft(fft.fft(frames), N_FFT), 50)
    fft_plain_call_ms = time_ms(lambda: fft.ifft_reference(fft.fft_reference(frames), N_FFT), 50)
    print(f"  whole-run GL kernel {gl_ms * 1000:.2f} us/iter vs plain {gl_plain_ms * 1000:.2f}; "
          f"whole-run ADMM kernel {admm_ms * 1000:.2f} us/iter vs plain "
          f"{admm_plain_ms * 1000:.2f}; fft.cu fwd+inv {fft_ms * 1000:.2f} us vs torch.fft "
          f"{fft_plain_ms * 1000:.2f} (CUDA graphs; as called {fft_call_ms * 1000:.2f} vs "
          f"{fft_plain_call_ms * 1000:.2f}) on {smi}", flush=True)

    # E and F at config 1 and E at 400/160: each iteration as a CUDA graph of
    # 20 calls (the device's time) and as called (the host's pace), beside
    # the plain version as called
    c7_cfg, c7_state = kernel_state(C7_N_FFT, C7_HOP, N_SAMPLES, 1, dev)

    def dft_call(mod, run, scalar, extra, tier, plain=False, state=state1, cfg=cfg1):
        fn = getattr(mod, f"{run}_reference" if plain else run)
        return lambda: fn(*state, scalar, cfg, *extra, precision=tier)

    dft_times = {}  # (name, tier) -> (graph ms, as-called ms, plain ms)
    for name, mod, run, scalar, extra, tiers, kw_ in (
            ("gl_fused", gl_fused, "fused_gl_iteration", lr, (), ("high", "highest"), {}),
            ("admm_fused", admm_fused, "fused_admm_iteration", ADMM_RHO, (0,),
             ("high", "highest"), {}),
            ("gl_fused 400/160", gl_fused, "fused_gl_iteration", lr, (), ("high",),
             dict(state=c7_state, cfg=c7_cfg))):
        for tier in tiers:
            call = dft_call(mod, run, scalar, extra, tier, **kw_)
            dft_times[(name, tier)] = (graph_ms(call), time_ms(call, 20),
                                       time_ms(dft_call(mod, run, scalar, extra, tier, True,
                                                        **kw_), 5))
            g, c, pl = (v * 1000 for v in dft_times[(name, tier)])
            print(f"  {name} ({tier}), one iteration: {g:.2f} us (CUDA graph), {c:.2f} us as "
                  f"called, plain {pl:.2f} us on {smi}", flush=True)

    # Yardsticks only (the port never calls them): torch.matmul (cuBLAS) of
    # the same products at the same shapes, timed as E and F are: HIGH's six
    # bf16 products (three passes of the forward (T, n) @ (n, 2F) and of the
    # inverse (T, 2F) @ (2F, n)) and HIGHEST's two float32 ones (TF32 off).
    from specinv_tpu_torch.ops import dft as dft_ops
    from specinv_tpu_torch.ops.framing import frame as frame_of

    def yardsticks(state, cfg):
        x_pad_, seed_, _, win_, _ = state
        cos, sin, _ = dft_ops.table_tensors(cfg.n_fft, False, dev, torch.float32)
        b = torch.cat([cos, sin], 1)
        bt = b.t().contiguous()
        a = (frame_of(x_pad_, cfg.n_fft, cfg.hop_length) * win_)[0].contiguous()
        p = torch.view_as_real(seed_[0]).reshape(-1, 2 * seed_.shape[-1]).contiguous()
        (a_hi, a_lo), (b_hi, b_lo) = dft_ops.split_bf16(a), dft_ops.split_bf16(b)
        (p_hi, p_lo), (bt_hi, bt_lo) = dft_ops.split_bf16(p), dft_ops.split_bf16(bt)

        def high():
            return (a_hi @ b_hi, a_hi @ b_lo, a_lo @ b_hi, p_hi @ bt_hi, p_hi @ bt_lo,
                    p_lo @ bt_hi)

        def highest():
            return a @ b, p @ bt

        out = {tier: {"graph_ms": graph_ms(fn), "called_ms": time_ms(fn, 20)}
               for tier, fn in (("high", high), ("highest", highest))}
        print(f"  yardstick at {tuple(a.shape)} @ {tuple(b.shape)} and {tuple(p.shape)} @ "
              f"{tuple(bt.shape)}: cuBLAS HIGH's 6 bf16 products "
              f"{out['high']['graph_ms'] * 1000:.2f} us (CUDA graph), "
              f"{out['high']['called_ms'] * 1000:.2f} us as called; HIGHEST's 2 float32 "
              f"products {out['highest']['graph_ms'] * 1000:.2f} / "
              f"{out['highest']['called_ms'] * 1000:.2f} us on {smi}", flush=True)
        return out

    yard = {"config 1": yardsticks(state1, cfg1), "400/160": yardsticks(c7_state, c7_cfg)}

    print(f"[5] RTISI-LA per output frame: 10 s against 5 s clip, median of 3 {since()}",
          flush=True)
    half = N_SAMPLES // 2
    clips16 = torch.from_numpy(np.stack([make_speech_like(N_SAMPLES, seed=s)
                                         for s in range(16)]).astype(np.float32)).to(dev)
    mags = {}
    for batch, x in ((1, clip[None]), (16, clips16)):
        mags[batch] = [st.stft(x[:, :n], N_FFT, hop_length=HOP, window=window).abs()
                       for n in (N_SAMPLES, half)]
    steps = [m.shape[-1] + RTISI_LA_FRAMES for m in mags[1]]
    t_run = {}
    for _ in range(3):
        for backend in ("fft", "kernel"):
            for batch in (1, 16):
                for i, m in enumerate(mags[batch]):
                    t_run.setdefault((backend, batch, i), []).append(event_ms(
                        lambda: st.RTISI_LA(m, backend=backend, **rtisi_kw)))
    rtisi_rates = {}
    for backend in ("kernel", "fft"):
        for batch in (1, 16):
            t10, t5 = (float(np.median(t_run[(backend, batch, i)])) for i in (0, 1))
            us_frame = (t10 - t5) / (steps[0] - steps[1]) * 1000
            rtisi_rates[(backend, batch)] = us_frame
            print(f"  {backend} path, B={batch}: {us_frame:.2f} us per output frame step, "
                  f"{batch * 1e6 / us_frame:.1f} frames/s (10 s call {t10:.1f} ms, 5 s call "
                  f"{t5:.1f} ms) on {smi}", flush=True)

    for batch in (1, 16):
        s16 = st.RTISIStreamer(N_FFT // 2 + 1, look_ahead=RTISI_LA_FRAMES, max_iter=RTISI_ITERS,
                               batch=batch, hop_length=HOP, window=window)
        frames_in = mags[batch][0]
        for t in range(RTISI_LA_FRAMES + 2):  # warm-up and the look-ahead fill
            s16.push(frames_in[..., t])
        n_push = 64
        push_ms = event_ms(lambda: [s16.push(frames_in[..., 10 + t]) for t in range(n_push)])
        print(f"  streamer, B={batch}: {push_ms / n_push * 1000:.2f} us per push "
              f"({batch * n_push / push_ms * 1000:.1f} frames/s) on {smi}", flush=True)

    rtisi_launch_ms = {}
    for batch in (1, 16):
        cfg3, la3, tgt3, win3, st3 = rtisi_mid[batch]
        tgt8 = tgt3[:, 100 : 108 + la3].contiguous()
        rtisi_launch_ms[batch] = time_ms(lambda: rtisi_fused.fused_rtisi_steps(
            *st3, tgt8, win3, lr, cfg3, RTISI_ITERS), 10)
        print(f"  rtisi_fused.cu, one launch of 8 steps at config 3, B={batch}: "
              f"{rtisi_launch_ms[batch] * 1000:.1f} us, "
              f"{rtisi_launch_ms[batch] * 1000 / 8:.2f} us per step on {smi}", flush=True)
    rtisi_ms = rtisi_launch_ms[1]  # B = 1 from here on: the kernels line's shape
    cfg3, la3, tgt3, win3, st3 = rtisi_mid[1]
    tgt8 = tgt3[:, 100 : 108 + la3].contiguous()
    rtisi_plain_ms = time_ms(lambda: rtisi_fused.fused_rtisi_steps_reference(
        *st3, tgt8, win3, lr, cfg3, RTISI_ITERS), 2)
    # one step (k = 1, the streamer's launch, K7's counterpart) of the plain
    # version from the same state
    rtisi_step_plain_ms = time_ms(lambda: rtisi_fused.fused_rtisi_steps_reference(
        *st3, tgt8[:, : 1 + la3].contiguous(), win3, lr, cfg3, RTISI_ITERS), 3)
    print(f"  rtisi plain version, 8 steps at B=1: {rtisi_plain_ms * 1000:.1f} us; one step: "
          f"{rtisi_step_plain_ms * 1000:.1f} us {since()}", flush=True)

    # Bounds: the bytes each function must move (inputs read once, outputs
    # written once) over the memory rate, or its operations over the rate of
    # their type (FP32; FP64 for the transforms of rfft.cuh in A, B, C and D),
    # whichever is larger.  GL and ADMM: one iteration of the 100-iteration
    # call that was timed, so the call's bytes count 1/100.
    T1, F1, lp1 = tgt.shape[-2], tgt.shape[-1], x_pad.shape[-1]
    frame_tw = fft.twiddles(N_FFT, dev, torch.complex128)
    call_bytes = nbytes(x_pad, seed, tgt, win, inv_env, frame_tw) + nbytes(x_pad, seed)
    it_fft = T1 * 2 * fft_flops(N_FFT)
    it_flops = T1 * 2 * N_FFT + lp1 * (-(-N_FFT // HOP) + 1)
    # the middles: GL's momentum and projection, ADMM's DR update
    gl_bound = bound(call_bytes / 100, it_flops + T1 * F1 * 12, fp64_flops=it_fft)
    admm_bound = bound(call_bytes / 100, it_flops + T1 * F1 * 20, fp64_flops=it_fft)
    fft_bound = bound(2 * nbytes(frames) + 2 * nbytes(spec_k), 0.0,
                      fp64_flops=2 * frames.shape[0] * fft_flops(N_FFT))
    k8, R3, nk3 = 8, la3 + 1, st3[0].shape[1]
    rtisi_out = rtisi_fused.fused_rtisi_steps(*st3, tgt8, win3, lr, cfg3, RTISI_ITERS)
    # D's transforms run in FP64 (rfft.cuh), the rest of a refinement in FP32
    rtisi_fft_flops = k8 * RTISI_ITERS * R3 * 2 * fft_flops(N_FFT)
    rtisi_flops = k8 * (RTISI_ITERS * R3 * (14 * (N_FFT // 2 + 1) + 4 * N_FFT) + 2 * nk3 * N_FFT)
    rtisi_bound = bound(nbytes(*st3, tgt8, *win3, fft.twiddles(N_FFT, dev, torch.complex128))
                        + nbytes(*rtisi_out), rtisi_flops, fp64_flops=rtisi_fft_flops)
    # one thread-block cluster per stream: at B = 1 the kernel has the
    # cluster's SMs, plan.cluster / n_sm of each peak
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rtisi_plan = rtisi_fused.plan(N_FFT, R3)
    rtisi_cluster_us = max(rtisi_flops / PEAK_FP32_FLOPS, rtisi_fft_flops / PEAK_FP64_FLOPS) \
        / k8 * n_sm / rtisi_plan.cluster * 1e6
    print(f"  bounds (ms): gl {gl_bound}, admm {admm_bound}, fft {fft_bound}, rtisi {rtisi_bound}"
          f" (whole card, a launch of 8 steps); rtisi operations per step over one stream's "
          f"cluster of {rtisi_plan.cluster} of {n_sm} SMs: {rtisi_cluster_us} us "
          f"({rtisi_launch_ms[1] * 1000 / 8 / rtisi_cluster_us:.1f}x at B=1); plan "
          f"{rtisi_plan}", flush=True)

    def dft_bound(tier):
        """One direct-DFT iteration at config 1: each input read once (x,
        the state, the target, window, envelope, fold weights and the tables
        the tier reads), each output written once (x, the state, |S|); the
        tier's tensor-core passes, 8 T n F operations each (both products, re
        and im), at the bf16 rate, or at the FP32 rate for 'highest'.  The
        middle's ~20 FP32 operations per bin run beside them and are left
        out."""
        n_bins = F1
        halves = 2 if tier in ("high", "bf16x2") else 1  # bf16 halves of cos and sin read
        table_bytes = 2 * N_FFT * n_bins * (4 if tier == "highest" else 2 * halves)
        io = nbytes(x_pad, seed, tgt, win, inv_env) + nbytes(x_pad, seed, tgt) + 4 * n_bins
        flops = DFT_PASSES[tier] * 8 * T1 * N_FFT * n_bins
        return bound(io + table_bytes, flops,
                     PEAK_FP32_FLOPS if tier == "highest" else PEAK_BF16_FLOPS)

    dft_bounds = {tier: dft_bound(tier) for tier in ("high", "highest")}
    print(f"  direct-DFT bounds per iteration (ms): {dft_bounds}", flush=True)
    # HIGHEST (float32 FFMA from the TMA ring) beside cuBLAS's two float32
    # products and its bound
    highest_yard = yard["config 1"]["highest"]
    print("  HIGHEST at config 1, one iteration: " + "; ".join(
        f"{name} {dft_times[(name, 'highest')][0] * 1000:.2f} us (CUDA graph), "
        f"{dft_times[(name, 'highest')][1] * 1000:.2f} us as called"
        for name in ("gl_fused", "admm_fused"))
        + f"; cuBLAS's two float32 products {highest_yard['graph_ms'] * 1000:.2f} us (CUDA "
        f"graph), {highest_yard['called_ms'] * 1000:.2f} us as called; bound "
        f"{dft_bounds['highest'][0] * 1000:.2f} us ({dft_bounds['highest'][1]}) on {smi}",
        flush=True)

    print(f"[5] the seq paths on the 10-minute clip, marginal us/iter ((t(100) - t(50)) / "
          f"50, host clock) {since()}", flush=True)
    seq_times = {}
    for name, fn, _, extra, whole in seq_paths:
        for backend in ("kernel", "fft"):
            seq_times[(name, backend)] = seq_us(fn, mag10, mesh1,
                                                dict(seq_kw, backend=backend, **extra))

        def whole_call(spec, _mesh, max_iter, whole=whole, extra=extra):
            return whole(spec, max_iter=max_iter, tol=0.0, verbose=False, **extra, **seq_kw)

        seq_times[(name, "unsharded")] = seq_us(whole_call, mag10, None, {})
        print(f"  {name}, world 1: kernel {seq_times[(name, 'kernel')]:.2f} us/iter, fft "
              f"{seq_times[(name, 'fft')]:.2f}; the unsharded whole-run kernel "
              f"{seq_times[(name, 'unsharded')]:.2f}; world 2 (two ranks time-sharing one "
              f"card, the exchange's cost, not a speed-up): kernel "
              f"{res2[0][f'{name} kernel us/iter']:.2f}, fft {res2[0][f'{name} fft us/iter']:.2f} "
              f"us/iter (rank 0) on {smi}", flush=True)
    batched_us = res2[0]["batched s"] / MAIN_ITERS * 1e6
    unsharded_us = res2[0]["unsharded s"] / MAIN_ITERS * 1e6
    print(f"  batched(griffin_lim), {BATCH_CLIPS} clips, 2 ranks on one card: {batched_us:.2f} "
          f"us/iter for the batch ({BATCH_CLIPS * 1e6 / batched_us:.1f} clip-it/s), call "
          f"{res2[0]['batched s']:.3f} s; one unsharded call {unsharded_us:.2f} us/iter, "
          f"{res2[0]['unsharded s']:.3f} s (host clock, set-up included) on {smi}", flush=True)

    # one raw launch at the world-1 shape (the kernels line's, where phase 4
    # counted its launches) and at a world-2 shard
    raw_times, raw_bounds = {}, {}
    for shape, (st_, valid_) in (("world 1", (whole1, valid_w1)), ("shard", (shard0, valid0))):
        for name, mod, run, scalar in (("gl_iteration", gl_fullrun, "fused_gl_iteration", lr),
                                       ("admm_iteration", admm_fullrun, "fused_admm_iteration",
                                        ADMM_RHO)):

            def raw_call(fn, mod=mod, scalar=scalar, st_=st_, valid_=valid_):
                return getattr(mod, fn)(*st_, scalar, cfg1, valid_t=valid_)

            raw_times[(name, shape)] = (time_ms(lambda: raw_call(run), 20),
                                        time_ms(lambda: raw_call(f"{run}_reference"), 3))
            print(f"  {run} (raw), one launch at {st_[2].shape[-2]} frames ({shape}): "
                  f"{raw_times[(name, shape)][0] * 1000:.2f} us vs plain "
                  f"{raw_times[(name, shape)][1] * 1000:.2f} us on {smi}", flush=True)
        # x (C + H) and the state read and written, the target, window and
        # twiddles read; both FFTs of every frame, the windows, the OLA's
        # ceil(n_fft / hop) adds per sample and the middle
        t_s, lp_s = st_[2].shape[-2], st_[0].shape[-1]
        raw_bytes = nbytes(*st_, frame_tw) + nbytes(st_[0], st_[1])
        raw_fft = t_s * 2 * fft_flops(N_FFT)
        raw_flops = t_s * 2 * N_FFT + lp_s * -(-N_FFT // HOP)
        raw_bounds[("gl_iteration", shape)] = bound(raw_bytes, raw_flops + t_s * F1 * 12,
                                                    fp64_flops=raw_fft)
        raw_bounds[("admm_iteration", shape)] = bound(raw_bytes, raw_flops + t_s * F1 * 20,
                                                      fp64_flops=raw_fft)
    print(f"  raw dispatch bounds per launch (ms): {raw_bounds}", flush=True)

    grad_launches = grads["launches"]

    def timing(ms, plain_ms, bnd, library_ms=None):
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    def highest(name):  # E / F at 'highest', timed as at HIGH
        ms, called_ms, plain_ms = dft_times[(name, "highest")]
        return {**timing(ms, plain_ms, dft_bounds["highest"]), "called_ms": called_ms,
                "yardstick_ms": yard["config 1"]["highest"]}

    kernels = [
        {"name": "gl_fullrun", "route": "cuda", "source": "specinv_tpu_torch/csrc/gl_fullrun.cu",
         "replaces": "specinv_tpu/ops/pallas/fullrun_lane.py:377 (algo='gl'); "
                     "specinv_tpu/ops/pallas/gl_fullrun4.py:223",
         # launches: griffin_lim's and mel_to_audio's main-path runs and the
         # unsharded gradient's forward pass
         "launches": gl_launches + mel_launches + grad_launches["gl_fullrun.launches"],
         "max_abs_err": gl_err,
         **timing(gl_ms, gl_plain_ms, gl_bound)},
        {"name": "admm_fullrun", "route": "cuda", "source": "specinv_tpu_torch/csrc/admm_fullrun.cu",
         "replaces": "specinv_tpu/ops/pallas/fullrun_lane.py:377 (algo='admm'); "
                     "specinv_tpu/ops/pallas/admm_fused4.py:275",
         "launches": admm_launches + grad_launches["admm_fullrun.launches"],
         "max_abs_err": admm_err,
         **timing(admm_ms, admm_plain_ms, admm_bound)},
        # the transform of fft.cu (rfft.cuh) runs inside every gl_fullrun
        # and admm_fullrun launch (the RTISI kernel runs it too, in its own
        # launch plan); its library call is
        # torch.fft.rfft + irfft
        {"name": "fft", "route": "cuda", "source": "specinv_tpu_torch/csrc/fft.cu",
         "replaces": "specinv_tpu/ops/pallas/fft4.py:322; specinv_tpu/ops/pallas/fft4.py:367",
         "launches": gl_launches + admm_launches + grad_launches["gl_fullrun.launches"]
         + grad_launches["admm_fullrun.launches"],
         "max_abs_err": fft_err, **timing(fft_ms, fft_plain_ms, fft_bound, fft_plain_ms)},
        # launches: RTISI_LA's and then the streamer's, on the main path, at
        # config 3 and at 400/160; mixed_radix_launches: those at 400/160, on
        # the mixed-radix instance; ms and bound: one launch of 8 steps at
        # B = 1 at config 3; plan: its cluster
        {"name": "rtisi_fused", "route": "cuda", "source": "specinv_tpu_torch/csrc/rtisi_fused.cu",
         "replaces": "specinv_tpu/ops/pallas/rtisi_fused4.py:274; "
                     "specinv_tpu/ops/pallas/rtisi_fused4.py:61",
         "launches": rtisi_launches + stream_launches + c7_rtisi_launches,
         "mixed_radix_launches": c7_rtisi_launches, "max_abs_err": rtisi_err,
         **timing(rtisi_ms, rtisi_plain_ms, rtisi_bound), "plan": rtisi_plan._asdict()},
        # one iteration at config 1 in the default tier (HIGH), ms as a CUDA
        # graph (called_ms as called); launches: the 'dft' main path's (the
        # 400/160 'auto' drive launched it too); no one PyTorch call computes
        # the iteration: yardstick_ms is cuBLAS's HIGH products, timed alike;
        # "highest": the same at 'highest' beside cuBLAS's float32 products
        # persistent_products: the main path's products on the persistent
        # kernel; whisper_persistent_products: those of phase 3's iteration at
        # the gl400_16k_batch32 cell's shape
        {"name": "gl_fused", "route": "cuda", "source": "specinv_tpu_torch/csrc/gl_fused.cu",
         "replaces": "specinv_tpu/ops/pallas/gl_fused.py:193",
         "launches": gl_dft_launches, "max_abs_err": gl_dft_err,
         **timing(dft_times[("gl_fused", "high")][0], dft_times[("gl_fused", "high")][2],
                  dft_bounds["high"]),
         "called_ms": dft_times[("gl_fused", "high")][1], "yardstick_ms": yard["config 1"]["high"],
         "highest": highest("gl_fused"),
         "persistent_products": persistent["griffin_lim dft"],
         "whisper_persistent_products": whisper_products["gl"]},
        {"name": "admm_fused", "route": "cuda", "source": "specinv_tpu_torch/csrc/admm_fused.cu",
         "replaces": "specinv_tpu/ops/pallas/admm_fused.py:41",
         "launches": admm_dft_launches, "max_abs_err": admm_dft_err,
         **timing(dft_times[("admm_fused", "high")][0], dft_times[("admm_fused", "high")][2],
                  dft_bounds["high"]),
         "called_ms": dft_times[("admm_fused", "high")][1],
         "yardstick_ms": yard["config 1"]["high"], "highest": highest("admm_fused"),
         "persistent_products": persistent["ADMM dft"],
         "whisper_persistent_products": whisper_products["admm"]},
        # the raw dispatch of kernels A and C: one launch per iteration and
        # shard; launches: counted on the world-1 seq main path (tol 0) and
        # in the world-1 gradient phase (forward passes, and the remat
        # run's recomputation in its backward pass), ms and bound: one
        # launch at that path's shape, the whole 10-minute clip (25843
        # frames); max_abs_err: every raw check of phase 3
        {"name": "gl_iteration", "route": "cuda",
         "source": "specinv_tpu_torch/csrc/gl_fullrun.cu",
         "replaces": "specinv_tpu/ops/pallas/gl_fused4.py:110",
         "launches": seq1["griffin_lim_seq"]["launches"]
         + grad_launches["gl_fullrun.iteration_launches"], "max_abs_err": gl_raw_err,
         **timing(*raw_times[("gl_iteration", "world 1")],
                  raw_bounds[("gl_iteration", "world 1")])},
        {"name": "admm_iteration", "route": "cuda",
         "source": "specinv_tpu_torch/csrc/admm_fullrun.cu",
         "replaces": "specinv_tpu/ops/pallas/admm_fused4.py:89",
         "launches": seq1["admm_seq"]["launches"]
         + grad_launches["admm_fullrun.iteration_launches"], "max_abs_err": admm_raw_err,
         **timing(*raw_times[("admm_iteration", "world 1")],
                  raw_bounds[("admm_iteration", "world 1")])},
    ]
    print(f"  done {since()}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
