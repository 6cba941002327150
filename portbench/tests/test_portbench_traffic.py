"""The speech-like traffic: deterministic per seed, peak 0.9, and the
structure of ``make_speech_like`` (the same voiced source, gate and
onsets; other noise)."""
import numpy as np
import torch

from portbench.traffic import speech
from specinv_tpu_torch.utils.corpus import make_speech_like

N = 22050


def test_same_seed_same_clips_other_seed_other_clips():
    a = speech.clips(3, N, 2**31 + 5, "cpu")
    assert torch.equal(a, speech.clips(3, N, 2**31 + 5, "cpu"))
    assert not torch.equal(a, speech.clips(3, N, 2**31 + 6, "cpu"))
    assert a.dtype == torch.float64 and a.shape == (3, N)
    assert len({tuple(c[:1000].tolist()) for c in a}) == 3  # distinct clips


def test_peak_is_0_9():
    a = speech.clips(4, N, 12345, "cpu")
    assert torch.allclose(a.abs().amax(dim=-1), torch.full((4,), 0.9, dtype=torch.float64))


def test_keeps_the_structure_of_make_speech_like():
    ours = speech.clips(2, 2 * N, 7, "cpu").numpy()
    theirs = make_speech_like(2 * N, seed=0)
    for clip in ours:
        assert np.corrcoef(clip, theirs)[0, 1] > 0.8  # the same voiced source under the gate
        # the same syllable gate: silence-free voiced stretches at the same places
        env_ours = np.abs(clip).reshape(-1, 441).max(1)
        env_theirs = np.abs(theirs).reshape(-1, 441).max(1)
        assert np.corrcoef(env_ours, env_theirs)[0, 1] > 0.8
