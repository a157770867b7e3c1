"""Host-side frame I/O in C++ through ctypes (port of vtoonify_tpu/native/).

Two of the JAX package's functions, the two the port calls: `rgb_to_bgr`
(the video reader's and writer's channel swap) and `depth_to_space2_u8`
(the finish of a packed pipeline's output, fused with the writer's
RGB->BGR swap). `chip_smoke.py`'s `pipeline_options` times both against
their numpy versions on a 1024 px frame (PERF.md).

`frameio.cpp` is built with g++ at first use into the package's `_build/`
directory (keyed by a hash of the source and flags). Unlike the JAX package,
a failed build or load raises: nothing falls back to numpy on the quiet.
Only `VTOONIFY_NO_NATIVE=1` selects the numpy versions, on purpose;
`backend()` says which one runs. The numpy versions compute the same bytes
and are what the tests hold the C++ against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "frameio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()


def backend() -> str:
    """"numpy" when VTOONIFY_NO_NATIVE=1, else "native" (the C++ library,
    built and loaded on this call if it is not yet)."""
    if os.environ.get("VTOONIFY_NO_NATIVE") == "1":
        return "numpy"
    lib()
    return "native"


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libframeio_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile frameio.cpp (no-op when the library for this source exists).
    Raises with g++'s output when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native: cannot build {_SRC.name}: {e}; set "
                           "VTOONIFY_NO_NATIVE=1 for the numpy versions") from e
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native: g++ failed:\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded ctypes library (built at the first call); raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            L.rgb_to_bgr.argtypes = [u8, u8, i64]
            L.depth_to_space2_u8.argtypes = [u8, u8, i64, i64, i64, i64]
            for fn in (L.rgb_to_bgr, L.depth_to_space2_u8):
                fn.restype = None
            _lib = L
    return _lib


def _native():
    return None if os.environ.get("VTOONIFY_NO_NATIVE") == "1" else lib()


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u8(a):
    return np.ascontiguousarray(a, np.uint8)


def rgb_to_bgr(src: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 with its channels reversed (either way round)."""
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"rgb_to_bgr takes (H, W, 3), not {src.shape}")
    L = _native()
    if L is None:
        return np.ascontiguousarray(src[..., ::-1])
    src = _u8(src)
    out = np.empty_like(src)
    L.rgb_to_bgr(_u8p(src), _u8p(out), src.shape[0] * src.shape[1])
    return out


def depth_to_space2_u8(src: np.ndarray, bgr: bool = False) -> np.ndarray:
    """(H, W, 4C) phase-major packed uint8 -> (2H, 2W, C): out[2i+a, 2j+b,
    c] = src[i, j, (2a+b)C + c]. bgr=True fuses the writer's RGB->BGR swap
    (C must be 3)."""
    if src.ndim != 3 or src.shape[2] % 4:
        raise ValueError(f"depth_to_space2_u8 takes (H, W, 4C), not {src.shape}")
    h, w, c4 = src.shape
    c = c4 // 4
    if bgr and c != 3:
        raise ValueError(f"bgr=True needs 3 channels, not {c}")
    L = _native()
    if L is None:
        out = src.reshape(h, w, 2, 2, c).transpose(0, 2, 1, 3, 4).reshape(
            2 * h, 2 * w, c)
        return np.ascontiguousarray(out[..., ::-1] if bgr else out)
    src = _u8(src)
    out = np.empty((2 * h, 2 * w, c), np.uint8)
    L.depth_to_space2_u8(_u8p(src), _u8p(out), h, w, c, int(bgr))
    return out

