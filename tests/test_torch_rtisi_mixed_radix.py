"""Kernel D off the powers of two: RTISI-LA at Whisper's STFT (n_fft 400,
hop 160) and other n_fft whose half is 2^a 3^b 5^c.

The kernel cannot run here, so its transform is modelled: the stages of
``csrc/rfft.cuh`` in the order of its plan (``radices``), with its
index arithmetic, its twiddles from ``fft.twiddles`` and its padded layout,
against ``torch.fft`` in float64; at the powers of two the plan and the
indices are those of the power-of-two stages that A, B, C and D ran
before.  Beside it: which configs the kernels take, how ``'auto'`` resolves
at 400/160, and the kernel's plain twin held to the benchmark's float64
reference (``portbench/reference/rtisi_la.py``).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from portbench.reference import rtisi_la as reference
from portbench.reference._signal import stft
from specinv_tpu_torch.config import canonicalize
from specinv_tpu_torch.models.common import resolve_backend
from specinv_tpu_torch.ops import twins
from specinv_tpu_torch.ops.cuda import _fullrun, fft, rtisi_fused
from specinv_tpu_torch.utils.corpus import make_speech_like

rtisi_la = importlib.import_module("specinv_tpu_torch.models.rtisi_la")

MIXED = [10, 40, 120, 160, 200, 240, 600, 1000, 1500]
POWERS = [1 << e for e in range(3, 12)]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- a model of csrc/rfft.cuh's stages --------------------------------------


def radices(h: int) -> tuple | None:
    """rfft::plan's radices for an h-point complex FFT, in order: 8 while
    three or more factors of two remain, then one 4 or 2, then a 5 per
    factor of five and a 3 per factor of three; None where h has another
    prime factor."""
    counts = {}
    for p in (2, 5, 3):
        counts[p] = 0
        while h > 1 and h % p == 0:
            h //= p
            counts[p] += 1
    if h != 1:
        return None
    twos = counts[2]
    return ((8,) * (twos // 3) + ((1 << twos % 3,) if twos % 3 else ()) + (5,) * counts[5]
            + (3,) * counts[3])


def at(i):
    """rfft::at: one padding point after every eight."""
    return i + i // 8


def padded(h: int) -> int:
    return h + h // 8


def twiddle(tw, m, h):
    """rfft::twiddle: exp(-2 pi i m / h) from the n/2-entry table."""
    j = 2 * m
    t = tw[j % h]
    return np.where(j < h, t, -t)


def powers(w, R):
    """rfft::powers: w^1 .. w^(R-1) by the kernel's products."""
    wr = [None, w]
    if R > 2:
        wr.append(w * w)
    if R > 3:
        wr.append(wr[2] * w)
    if R > 4:
        wr.append(wr[2] * wr[2])
    if R > 5:
        wr += [wr[4] * w, wr[4] * wr[2], wr[4] * wr[3]]
    return wr


def dft4(v0, v1, v2, v3):
    t0, t1, t2, t3 = v0 + v2, v0 - v2, v1 + v3, -1j * (v1 - v3)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def dft8(v):
    c = np.sqrt(0.5)
    e, o = dft4(*v[0::2]), dft4(*v[1::2])
    o = [o[0], c * (o[1].real + o[1].imag) + 1j * c * (o[1].imag - o[1].real), -1j * o[2],
         c * (o[3].imag - o[3].real) - 1j * c * (o[3].real + o[3].imag)]
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


def dft3(v):
    s = np.sin(2 * np.pi / 3)
    t = v[1] + v[2]
    m = v[0] - 0.5 * t
    d = -1j * (s * (v[1] - v[2]))
    return [v[0] + t, m + d, m - d]


def dft5(v):
    c1, c2 = np.cos(2 * np.pi / 5), np.cos(4 * np.pi / 5)
    s1, s2 = np.sin(2 * np.pi / 5), np.sin(4 * np.pi / 5)
    a1, b1, a2, b2 = v[1] + v[4], v[1] - v[4], v[2] + v[3], v[2] - v[3]
    m1, m2 = v[0] + c1 * a1 + c2 * a2, v[0] + c2 * a1 + c1 * a2
    d1, d2 = -1j * (s1 * b1 + s2 * b2), -1j * (s2 * b1 - s1 * b2)
    return [v[0] + a1 + a2, m1 + d1, m2 + d2, m2 - d2, m1 - d1]


DFT = {2: lambda v: [v[0] + v[1], v[0] - v[1]], 3: dft3, 4: lambda v: dft4(*v), 5: dft5, 8: dft8}


def stage_indices(h, ns, R):
    """rfft::mixed_stage's indices over its butterflies j: the points each
    loads (per r), the twiddle index, the points each stores (per r)."""
    nb = h // R
    j = np.arange(nb)
    k = j % ns
    base = (j - k) * R + k
    return ([j + r * nb for r in range(R)], k * (h // (ns * R)),
            [base + r * ns for r in range(R)])


def model_fft(z, tw):
    """rfft::fft_mixed on one frame z (h points) in the padded layout:
    each stage loads from one buffer and stores to the other."""
    h = z.shape[0]
    src = np.full(padded(h), np.nan, dtype=complex)
    src[at(np.arange(h))] = z
    ns = 1
    for R in radices(h):
        loads, tidx, stores = stage_indices(h, ns, R)
        v = [src[at(i)] for i in loads]
        if ns > 1:
            wr = powers(twiddle(tw, tidx, h), R)
            v = [v[0]] + [v[r] * wr[r] for r in range(1, R)]
        v = DFT[R](v)
        dst = np.full(padded(h), np.nan, dtype=complex)
        written = np.concatenate(stores)
        assert np.array_equal(np.sort(written), np.arange(h))  # each point once
        for i, x in zip(stores, v):
            dst[at(i)] = x
        src, ns = dst, ns * R
    return src[at(np.arange(h))]


def table(h):
    """fft.twiddles of n = 2h points as the kernels read it (FP64)."""
    return fft.twiddles(2 * h, torch.device("cpu"), torch.complex128).numpy()


def power_of_two_plan(h):
    """The stages of rfft::fft_from: radix 8 while three or more factors of
    two remain, then one radix-4 or radix-2 stage."""
    bits, plan = h.bit_length() - 1, []
    while bits:
        log2r = min(3, bits)
        plan.append(1 << log2r)
        bits -= log2r
    return tuple(plan)


@pytest.mark.parametrize("h", MIXED + POWERS)
def test_model_of_the_stages_is_the_fft(h):
    rng = np.random.default_rng(h)
    z = rng.standard_normal(h) + 1j * rng.standard_normal(h)
    ours = model_fft(z, table(h))
    expected = torch.fft.fft(torch.from_numpy(z)).numpy()
    assert np.abs(ours - expected).max() <= 1e-13 * np.abs(expected).max()


@pytest.mark.parametrize("h", POWERS)
def test_powers_of_two_keep_their_plan_and_indices(h):
    """At a power of two the plan is fft_from's and the mixed stage's
    divisions give rfft::stage's shifts, index for index."""
    assert radices(h) == power_of_two_plan(h)
    log2h, log2ns = h.bit_length() - 1, 0
    for R in radices(h):
        log2r = R.bit_length() - 1
        loads, tidx, stores = stage_indices(h, 1 << log2ns, R)
        j = np.arange(h >> log2r)
        k = j & ((1 << log2ns) - 1)
        for r in range(R):
            assert np.array_equal(loads[r], j + (r << (log2h - log2r)))
            assert np.array_equal(stores[r], ((j - k) << log2r) + k + (r << log2ns))
        assert np.array_equal(tidx, k << (log2h - log2ns - log2r))
        log2ns += log2r


@pytest.mark.parametrize("h,plan", [(200, (8, 5, 5)), (160, (8, 4, 5)), (240, (8, 2, 5, 3)),
                                    (600, (8, 5, 5, 3)), (1500, (4, 5, 5, 5, 3)),
                                    (225, (5, 5, 3, 3)), (441, None), (7, None)])
def test_plan_order(h, plan):
    """Radix 8 (then 4 or 2) over the twos, then the fives, then the threes;
    none where another prime divides h."""
    assert radices(h) == plan


def quarter_warp_wavefronts(points):
    """The most 16-byte slots any bank of eight serves in one request of
    eight consecutive threads (rfft::at positions of FP64 complex points)."""
    pos = at(np.asarray(points))
    worst = 1
    for g in range(0, len(pos), 8):
        group = pos[g : g + 8]
        worst = max(worst, *(len(set(group[group % 8 == b])) for b in set(group % 8)))
    return worst


@pytest.mark.parametrize("h", [40, 120, 160, 200, 240, 600, 1000])
def test_radix_5_and_3_stages_keep_off_one_bank(h):
    """Where 8 divides h, the padded layout puts each radix-5 and radix-3
    stage's loads and stores of eight consecutive butterflies in eight
    distinct banks; only the first (radix-8) stage's loads meet one bank
    twice, and without the padding its stores would meet one bank 8 times."""
    ns = 1
    for s, R in enumerate(radices(h)):
        loads, _, stores = stage_indices(h, ns, R)
        if R in (3, 5):
            assert max(map(quarter_warp_wavefronts, loads + stores)) == 1, (h, R)
        if s == 0:
            assert max(map(quarter_warp_wavefronts, stores)) == 1
            assert max(map(quarter_warp_wavefronts, loads)) <= 2
        ns *= R


def split_forward(zk, zc, w):
    e, d = 0.5 * (zk + np.conj(zc)), 0.5 * (zk - np.conj(zc))
    wo = w * (-1j * d)
    return e + wo, np.conj(e - wo)


def split_inverse(yk, yc, w):
    e, o = yk + np.conj(yc), (yk - np.conj(yc)) * np.conj(w)
    return np.conj(e + 1j * o), np.conj(np.conj(e) + 1j * np.conj(o))


@pytest.mark.parametrize("h", [200, 160, 225, 45])
def test_kernel_ds_bin_pairs_give_the_real_transforms(h):
    """D's pass over the bin pairs (kk, h - kk), kk <= h/2 (the pair
    kk = h/2 one bin where h is even, none where it is odd): the split
    post-pass of the modelled FFT is torch's rfft, and the pre-pass,
    the FFT and the unpacking are its irfft."""
    n, tw = 2 * h, table(h)
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n)
    Z = model_fft(x[0::2] + 1j * x[1::2], tw)
    X = np.full(h + 1, np.nan, dtype=complex)
    Y = torch.fft.rfft(torch.from_numpy(rng.standard_normal(n))).numpy()
    Zi = np.full(h, np.nan, dtype=complex)
    for kk in range(h // 2 + 1):
        kc = 0 if kk == 0 else h - kk
        xk, xc = split_forward(Z[kk], Z[kc], tw[kk])
        X[kk] = xk
        zk, zc = split_inverse(Y[kk], Y[h - kk], tw[kk])
        Zi[kk] = zk
        if 2 * kk != h:
            X[h - kk] = xc
            if kk:
                Zi[kc] = zc
    expected = torch.fft.rfft(torch.from_numpy(x)).numpy()
    assert np.abs(X - expected).max() <= 1e-13 * np.abs(expected).max()
    r = model_fft(Zi, tw)
    y = np.empty(n)
    y[0::2], y[1::2] = r.real / n, -r.imag / n
    expected = torch.fft.irfft(torch.from_numpy(Y), n).numpy()
    assert np.abs(y - expected).max() <= 1e-13 * np.abs(expected).max()


# --- which configs the kernels take -----------------------------------------


def config(n_fft, hop, **kw):
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    return canonicalize(n_fft // 2 + 1, np.float32, window=win, hop_length=hop, **kw)


@pytest.mark.parametrize("n_fft,hop", [(400, 160), (320, 80), (480, 120), (1200, 300),
                                       (2048, 512), (16, 4), (4096, 1024)])
def test_kernel_d_takes_even_n_fft_of_twos_threes_and_fives(n_fft, hop):
    cfg, w = config(n_fft, hop)
    assert rtisi_fused.supports(cfg, w)
    assert not rtisi_fused.supports(dataclasses.replace(cfg, hop_length=n_fft + 1), w)
    assert not rtisi_fused.supports(cfg, w.astype(np.complex64))


def test_kernel_d_refuses_other_sizes():
    cfg, w = config(882, 220)  # n/2 = 441 = 3^2 7^2
    assert not rtisi_fused.supports(cfg, w)
    for n in (401, 399, 15, 4097):  # odd n_fft
        assert not rtisi_fused.supported_size(n)
        assert not rtisi_fused.supports(dataclasses.replace(cfg, n_fft=n), np.ones(n))
    for n in (14, 4098, 4100, 882, 14 * 16):  # out of range, or a 7 in n/2
        assert not rtisi_fused.supported_size(n)
    assert rtisi_fused.supported_size(400) and rtisi_fused.supported_size(450)


def test_sizes_and_the_mixed_radix_count_follow_the_plan():
    """supported_size is the model plan's domain over [16, 4096], and a
    launch counts as mixed-radix exactly where the plan has a radix-5 or
    radix-3 stage."""
    for n in range(16, 4097, 2):
        plan = radices(n // 2)
        assert rtisi_fused.supported_size(n) == (plan is not None), n
        if plan is not None:
            assert rtisi_fused.mixed_radix(n) == bool({3, 5} & set(plan)), n


@pytest.mark.parametrize("n_fft", [400, 320, 480, 1200, 882, 2048])
def test_whole_run_kernels_and_kernel_b_keep_the_powers_of_two(n_fft):
    cfg, w = config(n_fft, n_fft // 4)
    assert _fullrun.supports(cfg, w) == (n_fft == 2048)
    assert fft.supported_size(n_fft) == (n_fft == 2048)


@pytest.mark.parametrize("is_complex", [False, True])
def test_gl_and_admm_still_take_the_direct_dft_at_400(is_complex):
    cfg, w = config(400, 160)
    expected = "fft" if is_complex else "dft"
    assert resolve_backend("auto", cfg, w, torch.device("cuda"), is_complex) == expected


def test_rtisi_auto_takes_kernel_d_at_400():
    cfg, w = config(400, 160)
    cuda = torch.device("cuda")
    assert rtisi_la._resolve_backend("auto", cfg, w, torch.float32, cuda) == "kernel"
    assert rtisi_la._resolve_backend("kernel", cfg, w, torch.float32, cuda) == "kernel"
    assert rtisi_la._resolve_backend("auto", cfg, w, torch.float64, cuda) == "fft"
    assert rtisi_la._resolve_backend("auto", cfg, w, torch.float32, torch.device("cpu")) == "fft"
    assert rtisi_la._resolve_backend("auto", cfg, w, torch.float32, None) == "auto"


def test_plan_sizes_shared_memory_for_the_padded_half():
    p = rtisi_fused.plan(400, 3)  # look-ahead 2
    assert (p.cluster, p.frames_per_cta, p.group, p.resident, p.threads) == (3, 1, 1, True, 128)
    resident = 4 * (2 * 3 * 400 + (400 + 3 * 201))
    assert p.smem == 16 * 200 + 4 * 400 + 32 * padded(200) + resident


def test_plain_twin_matches_the_float64_reference_at_400():
    """Kernel D's plain twin at 400/160 with look-ahead 2 and 25
    refinements, 2 streams of speech-like 16 kHz magnitudes, against the
    benchmark's reference, both in float64, over 20 steps: each step from
    the twin's own state (as the benchmark's check follows the program),
    and the 20 steps of one call the same bits as the 20 single steps.
    From one state the committed frames lie within a few ulps (the same
    arithmetic in other sum orders).  The newest in-flight frame, 25
    refinements from its zero-phase start, and a whole chained clip are no
    test here: at this geometry they carry such a rounding to 0.3 of the
    frame's largest sample within one step."""
    n, hop, la, steps, iters, alpha = 400, 160, 2, 20, 25, 0.99
    cfg, w = config(n, hop)
    w64 = torch.from_numpy(w.astype(np.float64))
    clips = np.stack([make_speech_like(4000, sr=16000, seed=s) for s in (5, 6)])
    mag = stft(torch.from_numpy(clips), w64, hop).abs()[:, :steps]
    target = torch.nn.functional.pad(mag, (0, 0, la, la))
    windows = rtisi_la.rtisi_windows(w64, cfg, False)
    lr = alpha / (1 + alpha)
    start = state = reference.initial_state(target[:, la], la, hop)
    committed = []
    for i in range(steps):
        rows = target[:, i : i + la + 1]
        frame, *twin = twins.rtisi_steps_twin(*state, rows, windows, lr, cfg, iters)
        expected, frame64 = reference.step(state, rows, w64, hop, iters, alpha)
        for a, b in ((frame[0], frame64), (twin[0], expected[0])):  # committed, kept
            assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1e-300)
        committed.append(frame[0])
        state = twin
    chained = twins.rtisi_steps_twin(*start, target[:, : steps + la], windows, lr, cfg, iters)
    assert torch.equal(chained[0], torch.stack(committed))
    assert all(torch.equal(a, b) for a, b in zip(chained[1:], state))
