"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``specinv_tpu_torch/csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which ``ctypes`` loads.  The
library lands in ``build/specinv_tpu_torch/`` at the checkout root, named by
a hash of the sources and flags, so a change to any source rebuilds it.
Nothing here runs at import: importing the package needs no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "specinv_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the entry points (every one returns a cudaError_t as int)
_SIGNATURES = {
    "specinv_fft_r2c": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "specinv_fft_c2r": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "specinv_gl_iteration": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,   # buffers
        _I, _I, _I, _I, _I, _I, _I, _I,           # B T n log2n hop n_bins lp onesided
        _I, _I, _I,                               # p_amt e pad_mode
        _F, _F, _F, _I,                           # lr fscale iscale valid_t
        _I, _I, _I,                               # the plan: fpb threads smem
        _P,                                       # stream
    ],
    "specinv_admm_iteration": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,   # buffers
        _I, _I, _I, _I, _I, _I, _I, _I,           # B T n log2n hop n_bins lp onesided
        _I, _I, _I,                               # p_amt e pad_mode
        _F, _F, _F, _I,                           # rho fscale iscale valid_t
        _I, _I, _I,                               # the plan: fpb threads smem
        _P,                                       # stream
    ],
    "specinv_gl_dft_iteration": [
        *[_P] * 22,                               # x_in x_out st_in st_out target window w
                                                  # fwd inv fwd_hi fwd_lo inv_hi inv_lo
                                                  # inv_env frames mag frame_f32 frame_hi
                                                  # frame_lo p_f32 p_hi p_lo
        *[_I] * 11,                               # B T n hop n_bins lp p_amt e pad_mode
                                                  # fwd_scheme inv_scheme
        _F,                                       # lr
        _P,                                       # stream
    ],
    "specinv_admm_dft_iteration": [
        *[_P] * 22,                               # as specinv_gl_dft_iteration
        *[_I] * 11,
        _F, _I,                                   # rho valid_t
        _P,                                       # stream
    ],
    "specinv_rtisi_steps": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P,       # keep upd pre target window awf awr synth tw
        _P, _P,                                   # com scratch
        _I, _I, _I, _I, _I, _I, _I,               # B k R nk n hop max_iter
        _I, _I, _I, _I, _I, _I, ctypes.c_longlong,  # the plan: cluster fpc group resident
                                                  # threads smem stride
        _F, _F, _F,                               # lr fscale iscale
        _P,                                       # stream
    ],
}

# Seconds the last nvcc run of this process took (0.0 until one ran);
# chip_smoke.py reports it.
last_build_seconds = 0.0


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists
    (``force`` compiles anyway)."""
    global last_build_seconds
    out = BUILD_DIR / f"libspecinv_{_digest()}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    start = time.perf_counter()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failures = [], []
    for cmd, obj, proc in jobs:
        log = proc.communicate()[0]
        objs.append(str(obj))
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    try:
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    last_build_seconds = time.perf_counter() - start
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.specinv_error_string.argtypes = [ctypes.c_int]
    lib.specinv_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().specinv_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def check_tensors(device, checks) -> None:
    """Raise unless each ``(name, tensor, dtype, shape)`` of ``checks`` has
    that type and shape on ``device``: what a C entry point's pointers must
    hold."""
    for name, t, dtype, shape in checks:
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
