"""The layout of kernel A and C's frame launch, on the CPU.

``ops/cuda/_fullrun.frame_plan`` takes the frames of a launch (``B * T``)
and n_fft and gives frames per block, threads per block and dynamic shared
memory, which the kernels check against their own layout
(``csrc/rfft.cuh``): the one-wave plan while the frames fit in one wave of
its blocks on an H100 (132 SMs, 228 KB of shared memory each, 1 KB of it
kept per block), else the many-wave plan, twice the frames per block in the
same shared memory.  No card is needed.
"""
import pytest

from specinv_tpu_torch.ops.cuda import _fullrun

SIZES = [1 << k for k in range(4, 13)]
SM_SHARED, BLOCK_RESERVED, SMS = 233472, 1024, 132
BLOCK_SHARED_MAX = 232448  # 227 KB: the most dynamic shared memory a block takes


def _wave(n_fft: int) -> int:
    """Frames in one wave of one-wave blocks, from their shared memory."""
    one = _fullrun.frame_plan(1, n_fft)
    return SMS * one.frames_per_block * (SM_SHARED // (one.smem + BLOCK_RESERVED))


def test_config_1_keeps_the_one_wave_plan():
    """431 frames (one 10 s clip at n_fft 2048, hop 512) fill less than a
    wave: one frame, 128 threads and 53,248 B a block, as before."""
    assert _fullrun.frame_plan(431, 2048) == (1, 128, 53248, False)


@pytest.mark.parametrize("rows", [27584, 25843])
def test_many_wave_launches_take_two_frames_a_block(rows):
    """64 clips of 431 frames, and the seq path's 10-minute clip at world 1:
    two frames, 256 threads and the same 53,248 B a block."""
    assert _fullrun.frame_plan(rows, 2048) == (2, 256, 53248, True)


@pytest.mark.parametrize("n_fft", [n for n in SIZES if n <= 2048])
def test_the_plan_turns_at_one_wave(n_fft):
    """The one-wave plan up to a wave of its blocks (528 frames at n_fft
    2048), the many-wave plan from there on, with twice the frames per block
    and the same shared memory."""
    wave = _wave(n_fft)
    one, before, at = (_fullrun.frame_plan(r, n_fft) for r in (1, wave - 1, wave))
    assert before == one and not one.many_wave
    assert at.many_wave
    assert (at.frames_per_block, at.threads, at.smem) == (
        2 * one.frames_per_block, 2 * one.threads, one.smem)
    assert _fullrun.frame_plan(100 * wave, n_fft) == at


@pytest.mark.parametrize("rows", [1, 264, 431, 25843, 27584, 1 << 20])
def test_n_fft_4096_keeps_the_one_wave_plan(rows):
    """At n_fft 4096 a many-wave block of 512 threads holds an SM alone at
    the kernel's register bound: one frame, 256 threads and 106,496 B a
    block at every size."""
    assert _fullrun.frame_plan(rows, 4096) == (1, 256, 106496, False)


@pytest.mark.parametrize("rows", [1, 431, 25843, 27584, 1 << 20])
@pytest.mark.parametrize("n_fft", SIZES)
def test_every_plan_fits_a_block(n_fft, rows):
    """Whole warps of n_fft / 16 threads a frame, at most 1024 threads and
    227 KB a block, and the kernels' layout: the twiddle table, then per
    frame one buffer (many waves) or two (one wave) of n_fft / 2 FP64
    points with one padding point per eight."""
    plan = _fullrun.frame_plan(rows, n_fft)
    h = n_fft // 2
    assert plan.threads == plan.frames_per_block * n_fft // 16
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.smem <= BLOCK_SHARED_MAX
    buffers = 1 if plan.many_wave else 2
    assert plan.smem == 16 * (h + buffers * plan.frames_per_block * (h + h // 8))


def test_shared_memory_holds_twice_the_frames_at_n_fft_2048():
    """By shared memory, an SM holds four blocks of either plan at n_fft
    2048: four frames (16 warps) on the one-wave plan, eight (32 warps) on
    the many-wave plan (whose register bound then leaves it three blocks,
    six frames)."""
    held = {}
    for rows in (431, 27584):
        plan = _fullrun.frame_plan(rows, 2048)
        blocks = SM_SHARED // (plan.smem + BLOCK_RESERVED)
        held[plan.many_wave] = (blocks * plan.frames_per_block, blocks * plan.threads // 32)
    assert held == {False: (4, 16), True: (8, 32)}
