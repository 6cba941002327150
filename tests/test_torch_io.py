"""The port's WAV codec (``specinv_tpu_torch.io``): the cases of
``tests/test_io.py``, the port's native writer against the JAX package's
``write_wav`` byte for byte, its numpy codec against its native codec bit
for bit, and where its library is built (``build/specinv_tpu_torch/``, from
the port's own ``native/wav_io.cpp``)."""
import ctypes
import struct
from pathlib import Path

import numpy as np
import pytest

from specinv_tpu import io as jio
from specinv_tpu_torch import io as tio

ROOT = Path(__file__).resolve().parents[1]
requires_native = pytest.mark.skipif(tio.backend() != "native",
                                     reason="no C++ compiler: the numpy codec is the only one")


@pytest.fixture(scope="module")
def tone():
    rng = np.random.default_rng(3)
    t = np.linspace(0, 1, 8000, dtype=np.float32)
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(8000).astype(np.float32))


def test_roundtrip_pcm16(tmp_path, tone):
    p = str(tmp_path / "a.wav")
    tio.write_wav(p, tone, 22050, pcm16=True)
    y, sr = tio.read_wav(p)
    assert sr == 22050 and y.shape == tone.shape and y.dtype == np.float32
    # encode scales by 32767, decode divides by 32768
    np.testing.assert_allclose(y, np.clip(tone, -1, 1), atol=2 / 32768)


def test_roundtrip_float32_exact(tmp_path, tone):
    p = str(tmp_path / "a.wav")
    tio.write_wav(p, tone, 16000, pcm16=False)
    y, sr = tio.read_wav(p)
    assert sr == 16000
    np.testing.assert_array_equal(y, tone)


def test_roundtrip_stereo(tmp_path, tone):
    p = str(tmp_path / "a.wav")
    stereo = np.stack([tone, -tone])
    tio.write_wav(p, stereo, 48000, pcm16=False)
    y, sr = tio.read_wav(p)
    assert y.shape == stereo.shape and sr == 48000
    np.testing.assert_array_equal(y, stereo)


def _write_pcm24(path, samples_i32, sr=22050):
    """Hand-rolled PCM24 writer (the top 24 bits of the int32 values)."""
    data_bytes = 3 * len(samples_i32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 3, 3, 24))
        f.write(b"data" + struct.pack("<I", data_bytes))
        for v in samples_i32:
            f.write(struct.pack("<i", int(v))[1:])


def test_pcm24_decode(tmp_path):
    vals = np.asarray([0, 1 << 8, -(1 << 8), 1 << 30, -(1 << 30), (1 << 31) - 256], np.int64)
    p = str(tmp_path / "c.wav")
    _write_pcm24(p, vals)
    ref = ((vals & ~0xFF).astype(np.float32) / 2147483648.0).astype(np.float32)
    np.testing.assert_array_equal(tio.read_wav(p)[0], ref)
    np.testing.assert_array_equal(tio._np_read(p)[0], ref)


@requires_native
def test_native_reader_matches_numpy(tmp_path, tone):
    for pcm16 in (True, False):
        p = str(tmp_path / f"n{pcm16}.wav")
        tio.write_wav(p, tone, 22050, pcm16=pcm16)
        y_native, sr = tio.read_wav(p)
        y_np, ch, sr2 = tio._np_read(p)
        assert (sr, 1) == (sr2, ch)
        np.testing.assert_array_equal(y_native, y_np)


@requires_native
@pytest.mark.parametrize("pcm16", [True, False])
def test_writers_match_native_and_jax(tmp_path, tone, pcm16):
    """The port's native writer, its numpy writer and the JAX package's
    write_wav give the same bytes (mono and stereo, out-of-range samples
    clipped alike)."""
    loud = np.concatenate([tone, np.asarray([1.5, -1.5, 1.0, -1.0, 0.0], np.float32)])
    for data in (loud, np.stack([loud, -0.5 * loud])):
        native, numpy_, ref = (str(tmp_path / f"{k}.wav") for k in ("native", "numpy", "jax"))
        tio.write_wav(native, data, 22050, pcm16=pcm16)
        channels = 1 if data.ndim == 1 else data.shape[0]
        flat = np.ascontiguousarray(data.T).reshape(-1) if data.ndim == 2 else data
        tio._np_write(numpy_, flat, data.shape[-1], channels, 22050, pcm16)
        jio.write_wav(ref, data, 22050, pcm16=pcm16)
        got = Path(native).read_bytes()
        assert got == Path(numpy_).read_bytes() == Path(ref).read_bytes()


@requires_native
def test_library_is_the_ports_own_build():
    path = tio.library_path()
    assert path.parent == ROOT / "build" / "specinv_tpu_torch" and path.exists()
    assert tio._SRC == ROOT / "specinv_tpu_torch" / "native" / "wav_io.cpp"


def test_bad_file_raises(tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"not a wav at all")
    with pytest.raises(ValueError):
        tio.read_wav(str(p))
    with pytest.raises(ValueError):
        tio._np_read(str(p))


def test_truncated_fmt_chunk_raises_valueerror(tmp_path):
    p = str(tmp_path / "trunc.wav")
    with open(p, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 20) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", 8) + b"\x01\x00\x01\x00abcd")
    with pytest.raises(ValueError):
        tio._np_read(p)
    with pytest.raises(ValueError):
        tio.read_wav(p)


def test_lying_data_size_clamped(tmp_path, tone):
    p = tmp_path / "lie.wav"
    tio.write_wav(str(p), tone, 22050, pcm16=True)
    raw = bytearray(p.read_bytes())
    assert raw[36:40] == b"data"
    raw[40:44] = struct.pack("<I", 0xFFFFFFFF)
    p.write_bytes(bytes(raw))
    data, ch, sr = tio._np_read(str(p))
    assert sr == 22050 and ch == 1 and data.shape[0] == tone.shape[0]
    # truncated mid-sample: the whole frames, the ragged tail dropped
    p2 = tmp_path / "trunc.wav"
    p2.write_bytes(bytes(raw[: 44 + 2 * 100 + 1]))
    assert tio._np_read(str(p2))[0].shape[0] == 100


def test_write_too_large_raises_valueerror(tmp_path):
    p = tmp_path / "big.wav"
    with pytest.raises(ValueError, match="RIFF uint32 limit"):
        tio._np_write(str(p), np.zeros(4, np.float32), 2**31, 1, 22050, False)
    lib = tio._load()
    if lib is not None:
        buf = np.zeros(4, np.float32)
        rc = lib.wav_write_f32(str(p).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               2**31, 1, 22050, 0)
        assert rc == -10  # checked before any write: the small buffer is never read
        assert not p.exists()


def test_write_rejects_three_dimensions(tmp_path):
    with pytest.raises(ValueError, match="channels, frames"):
        tio.write_wav(str(tmp_path / "x.wav"), np.zeros((1, 2, 3), np.float32), 8000)
