"""Audio file I/O: a native C++ WAV codec with a numpy codec beside it.

Counterpart of ``specinv_tpu/io.py``: ``read_wav`` / ``write_wav`` decode
PCM16 / PCM24 / PCM32 / float32 and encode PCM16 / float32.  The codec is the
port's own ``native/wav_io.cpp``, compiled with ``g++`` at first use into
``build/specinv_tpu_torch/`` at the checkout root (named by a hash of the
source, so an edited source rebuilds) and driven through ``ctypes``.  On a
host without a compiler the numpy codec below, with the same semantics
(``tests/test_torch_io.py`` holds the two bit for bit), takes over with a
warning; :func:`backend` says which one is in use.  Audio stays on the host:
these functions take and return numpy arrays.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "wav_io.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "specinv_tpu_torch"
_GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_backend = None  # "native" | "numpy"


def library_path() -> Path:
    """Where the compiled codec lives: named by a hash of its source and
    flags."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_GXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"libwav_io-{digest[:16]}.so"


def _try_build() -> Optional[Path]:
    """Compile ``wav_io.cpp`` unless its library is there already."""
    try:
        path = library_path()
        if path.exists():
            return path
        path.parent.mkdir(parents=True, exist_ok=True)
        # Build to a temporary name, then rename: concurrent builders stay safe.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", *_GXX_FLAGS, "-o", tmp, str(_SRC)], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path
    except Exception as exc:  # noqa: BLE001 - any failure -> numpy codec
        warnings.warn(f"native wav codec unavailable ({exc}); using numpy")
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _backend
    if _backend is not None:
        return _lib
    path = _try_build()
    if path is None:
        _backend = "numpy"
        return None
    try:
        lib = ctypes.CDLL(str(path))
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.wav_info.argtypes = [ctypes.c_char_p, i64p, i32p, i32p, i32p, i32p]
        lib.wav_info.restype = ctypes.c_int
        lib.wav_read_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
        lib.wav_read_f32.restype = ctypes.c_int
        lib.wav_write_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int32,
                                      ctypes.c_int32, ctypes.c_int32]
        lib.wav_write_f32.restype = ctypes.c_int
        _lib, _backend = lib, "native"
    except OSError as exc:
        warnings.warn(f"native wav codec failed to load ({exc}); using numpy")
        _lib, _backend = None, "numpy"
    return _lib


def backend() -> str:
    """``'native'`` (the C++ codec) or ``'numpy'``."""
    _load()
    return _backend


# ---------------------------------------------------------------- numpy path

def _np_read(path: str) -> Tuple[np.ndarray, int, int]:
    with open(path, "rb") as f:
        if f.read(4) != b"RIFF":
            raise ValueError(f"{path}: not a RIFF file")
        f.read(4)
        if f.read(4) != b"WAVE":
            raise ValueError(f"{path}: not a WAVE file")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk")
            cid, sz = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                payload = f.read(sz + (sz & 1))
                if len(payload) < 16:
                    raise ValueError(f"{path}: truncated fmt chunk")
                tag, ch, sr = struct.unpack("<HHI", payload[:8])
                bits = struct.unpack("<H", payload[14:16])[0]
                if tag == 0xFFFE:  # extensible: the real tag leads SubFormat
                    if len(payload) < 26:
                        raise ValueError(f"{path}: truncated extensible fmt chunk")
                    tag = struct.unpack("<H", payload[24:26])[0]
                fmt = (tag, ch, sr, bits)
            elif cid == b"data":
                # Streaming encoders write sz=0xFFFFFFFF, and truncated files
                # declare more than they hold: read what the file has left.
                pos = f.tell()
                end = f.seek(0, 2)
                f.seek(pos)
                raw = f.read(min(sz, max(end - pos, 0)))
                break
            else:
                f.seek(sz + (sz & 1), 1)
        if fmt is None:
            raise ValueError(f"{path}: no fmt chunk")
        tag, ch, sr, bits = fmt
        # a truncated tail that is not a whole frame is dropped
        frame_bytes = max((bits // 8) * ch, 1)
        raw = raw[: len(raw) - (len(raw) % frame_bytes)]
        if tag == 3 and bits == 32:
            data = np.frombuffer(raw, "<f4").astype(np.float32)
        elif tag == 1 and bits == 16:
            data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif tag == 1 and bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            v = (
                (b[:, 0].astype(np.int32) << 8)
                | (b[:, 1].astype(np.int32) << 16)
                | (b[:, 2].astype(np.int8).astype(np.int32) << 24)
            )
            data = v.astype(np.float32) / 2147483648.0
        elif tag == 1 and bits == 32:
            data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported format tag={tag} bits={bits}")
        return data.astype(np.float32), ch, sr


def _np_write(path, flat, frames, channels, sr, pcm16):
    bytes_per = 2 if pcm16 else 4
    data_bytes = frames * channels * bytes_per
    if data_bytes > 0xFFFFFFFF - 36:
        # RIFF sizes are uint32, as the native codec checks
        raise ValueError(
            f"{path}: audio too large for WAV ({data_bytes} data bytes "
            "exceeds the RIFF uint32 limit)"
        )
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + data_bytes) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1 if pcm16 else 3, channels, sr,
                            sr * channels * bytes_per, channels * bytes_per,
                            16 if pcm16 else 32))
        f.write(b"data" + struct.pack("<I", data_bytes))
        if pcm16:
            clipped = np.clip(flat, -1.0, 1.0) * 32767.0
            q = np.where(clipped >= 0, clipped + 0.5, clipped - 0.5)
            f.write(q.astype("<i2").tobytes())
        else:
            f.write(flat.astype("<f4").tobytes())


# --------------------------------------------------------------- public API

def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to float32.

    Returns ``(data, sample_rate)``: ``data`` is ``(frames,)`` for mono or
    ``(channels, frames)`` for more channels, the layout the inversion
    entry points take (``torch.from_numpy`` for a CPU run).
    """
    lib = _load()
    if lib is None:
        data, ch, sr = _np_read(path)
    else:
        frames, ch32, sr32 = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
        bits, tag = ctypes.c_int32(), ctypes.c_int32()
        rc = lib.wav_info(path.encode(), ctypes.byref(frames), ctypes.byref(ch32),
                          ctypes.byref(sr32), ctypes.byref(bits), ctypes.byref(tag))
        if rc != 0:
            raise ValueError(f"{path}: wav_info failed (code {rc})")
        n = frames.value * ch32.value
        data = np.empty(n, np.float32)
        rc = lib.wav_read_f32(path.encode(),
                              data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        if rc != 0:
            raise ValueError(f"{path}: wav_read_f32 failed (code {rc})")
        ch, sr = ch32.value, sr32.value
    if ch > 1:
        data = data.reshape(-1, ch).T.copy()
    return data, int(sr)


def write_wav(path: str, data, sample_rate: int, pcm16: bool = True) -> None:
    """Encode float32 audio: ``(frames,)`` mono or ``(channels, frames)``.

    ``pcm16=True`` (default) clips to [-1, 1] and quantizes with
    round-half-away (both codecs alike); ``pcm16=False`` stores IEEE
    float32 as it is.
    """
    arr = np.asarray(data, np.float32)
    if arr.ndim == 1:
        channels, frames = 1, arr.shape[0]
        flat = np.ascontiguousarray(arr)
    elif arr.ndim == 2:
        channels, frames = arr.shape
        flat = np.ascontiguousarray(arr.T).reshape(-1)
    else:
        raise ValueError("data must be (frames,) or (channels, frames)")
    lib = _load()
    if lib is None:
        _np_write(path, flat, frames, channels, sample_rate, pcm16)
        return
    rc = lib.wav_write_f32(path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           frames, channels, sample_rate, 1 if pcm16 else 0)
    if rc != 0:
        raise ValueError(f"{path}: wav_write_f32 failed (code {rc})")
