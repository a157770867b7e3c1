"""The port's four hand-written Hopper kernels, each beside its plain version.

| kernel              | replaces (vtoonify_tpu/ops/pallas_kernels.py)  | source              |
| ------------------- | ---------------------------------------------- | ------------------- |
| `modconv3x3`        | B1 `modconv3x3_fused_pallas`                   | csrc/modconv3x3.cu  |
| `fused_leaky_relu`  | B2 `fused_leaky_relu_pallas`                   | csrc/fused_lrelu.cu |
| `upfirdn2d`         | B3 `blur_same_pallas` (generalised)            | csrc/upfirdn2d.cu   |
| `depth_to_space2`   | B4 `depth_to_space2_pallas` (+ phase-minor)    | csrc/d2s2.cu        |

Each wrapper dispatches on where its tensor lies and nowhere else: a CPU
tensor takes the plain PyTorch version (`*_plain`, the tests' oracle); a CUDA
tensor launches the kernel or raises. The CUDA sources are compiled with
`nvcc` for `sm_90a` into one shared library with a plain C interface, at
first use, into `vtoonify_tpu_torch/_build/` (keyed by a hash of the
sources), and bound with `ctypes`. Each wrapper counts its launches in a
plain integer attribute, `<wrapper>.launches`.

Layouts: activations are NCHW and contiguous; the kernels compute in float32
and load and store float32 or bfloat16.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_CU_FILES = ("modconv3x3.cu", "fused_lrelu.cu", "upfirdn2d.cu", "d2s2.cu")
_HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


# ---------------------------------------------------------------------------
# build and bind


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc): cannot "
                           "build the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in _HEADERS + _CU_FILES + NVCC_FLAGS:
        digest.update(name.encode())
        path = CSRC / name
        if path.exists():
            digest.update(path.read_bytes())
    return BUILD_DIR / f"libvtoonify_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu for sm_90a into the shared library (no-op when the
    library for these exact sources exists). Raises with nvcc's output if
    the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / f) for f in _CU_FILES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.vt_modconv3x3.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f, i, p]
        lib.vt_fused_lrelu.argtypes = [p, p, p, ll, i, ll, f, f, i, p]
        lib.vt_upfirdn2d.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i, i,
                                     i, i, i, p]
        lib.vt_d2s2.argtypes = [p, p, i, i, i, i, i, i, p]
        for fn in (lib.vt_modconv3x3, lib.vt_fused_lrelu, lib.vt_upfirdn2d,
                   lib.vt_d2s2):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        # the C launchers run on the calling thread's current device
        raise RuntimeError(f"tensor on {x.device}, current device is "
                           f"cuda:{torch.cuda.current_device()}")
    return False


def _check(name, x, *others):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"({tuple(_DTYPE_CODE)})")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    for t in others:
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: operands must share device and dtype "
                             f"({t.device}/{t.dtype} vs {x.device}/{x.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# B1: styled 3x3 conv, fused demod + bias + leaky-ReLU epilogue


def modconv3x3_plain(x, w, s=None, d=None, bias=None,
                     negative_slope: float = 0.2, gain: float = SQRT2):
    """Plain version of `modconv3x3`: the JAX modulated_conv2d +
    fused_leaky_relu chain (vtoonify_tpu/nn/layers.py) in eager torch."""
    if s is not None:
        x = x * s[:, :, None, None]
    y = F.conv2d(x, w.permute(3, 2, 0, 1), padding=1)
    if d is not None:
        y = y * d[:, :, None, None]
    if bias is not None:
        y = fused_leaky_relu_plain(y, bias, negative_slope, gain)
    return y


def modconv3x3(x, w, s=None, d=None, bias=None, negative_slope: float = 0.2,
               gain: float = SQRT2):
    """lrelu(d * conv3x3(x * s, w) + bias) * gain, stride 1, same padding.

    x: (B, Cin, H, W) NCHW; w: (3, 3, Cin, Cout) HWIO; s: (B, Cin) or None;
    d: (B, Cout) or None; bias: (Cout,) or None (None: no activation, the
    raw conv out). Returns (B, Cout, H, W) in x's dtype (float32/bfloat16).
    """
    if _on_cpu(x):
        return modconv3x3_plain(x, w, s, d, bias, negative_slope, gain)
    _check("modconv3x3", x, w, s, d, bias)
    b, cin, h, wd = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, cin, cout):
        raise ValueError(f"modconv3x3: w {tuple(w.shape)} is not (3,3,{cin},Cout)")
    if s is not None and tuple(s.shape) != (b, cin):
        raise ValueError(f"modconv3x3: s {tuple(s.shape)} != {(b, cin)}")
    if d is not None and tuple(d.shape) != (b, cout):
        raise ValueError(f"modconv3x3: d {tuple(d.shape)} != {(b, cout)}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"modconv3x3: bias {tuple(bias.shape)} != {(cout,)}")
    if b > 65535:
        raise ValueError("modconv3x3: batch above 65535")
    y = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = _library().vt_modconv3x3(
        _ptr(x), _ptr(w), _ptr(s), _ptr(d), _ptr(bias), _ptr(y), b, cin, cout,
        h, wd, negative_slope, gain, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "modconv3x3")
    modconv3x3.launches += 1
    return y


# ---------------------------------------------------------------------------
# B2: fused bias + leaky-ReLU x gain


def fused_leaky_relu_plain(x, bias=None, negative_slope: float = 0.2,
                           gain: float = SQRT2):
    """Plain version of `fused_leaky_relu`."""
    if bias is not None:
        x = x + bias.view((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, negative_slope) * gain


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     gain: float = SQRT2):
    """leaky_relu(x + bias, slope) * gain with the bias on dim 1.

    x: (N, C, ...) — NCHW activations or (N, C) linear outputs; bias: (C,)
    in x's dtype, or None. Returns a new tensor of x's shape and dtype.
    """
    if _on_cpu(x):
        return fused_leaky_relu_plain(x, bias, negative_slope, gain)
    _check("fused_leaky_relu", x, bias)
    c = x.shape[1] if x.ndim > 1 else 1
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"fused_leaky_relu: bias {tuple(bias.shape)} != {(c,)}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    inner = x[0, 0].numel() if x.ndim > 1 else 1
    rc = _library().vt_fused_lrelu(
        _ptr(x), _ptr(bias), _ptr(y), x.numel(), c, inner, negative_slope,
        gain, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "fused_leaky_relu")
    fused_leaky_relu.launches += 1
    return y


# ---------------------------------------------------------------------------
# B3: upfirdn2d


def upfirdn2d_plain(x, k2d, up=(1, 1), down=(1, 1), pad=(0, 0, 0, 0)):
    """Plain version of `upfirdn2d`: zero-stuff, pad/crop, depthwise conv
    with the flipped taps, subsample (the reference's upfirdn2d_native)."""
    up_x, up_y = up
    down_x, down_y = down
    px0, px1, py0, py1 = pad
    n, c, h, w = x.shape
    kh, kw = k2d.shape
    t = x.reshape(n * c, 1, h, 1, w, 1)
    t = F.pad(t, [0, up_x - 1, 0, 0, 0, up_y - 1])
    t = t.reshape(n * c, 1, h * up_y, w * up_x)
    t = F.pad(t, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    t = t[:, :, max(-py0, 0):t.shape[2] - max(-py1, 0),
          max(-px0, 0):t.shape[3] - max(-px1, 0)]
    wk = torch.flip(k2d, (0, 1)).reshape(1, 1, kh, kw).to(x.device, x.dtype)
    t = F.conv2d(t, wk)[:, :, ::down_y, ::down_x]
    return t.reshape(n, c, t.shape[2], t.shape[3])


def upfirdn2d(x, k2d, up=(1, 1), down=(1, 1), pad=(0, 0, 0, 0)):
    """Per-plane up-FIR-down resampling.

    x: (N, C, H, W) NCHW; k2d: (kh, kw) float32 taps in convolution
    orientation, kh, kw <= 8; up, down: (x, y) factors in {1, 2};
    pad: (x0, x1, y0, y1), negative pads crop.
    """
    if _on_cpu(x):
        return upfirdn2d_plain(x, k2d, up, down, pad)
    _check("upfirdn2d", x)
    up_x, up_y = up
    down_x, down_y = down
    px0, px1, py0, py1 = pad
    kh, kw = k2d.shape
    if not ({up_x, up_y, down_x, down_y} <= {1, 2} and kh <= 8 and kw <= 8):
        raise ValueError(f"upfirdn2d kernel takes up, down in {{1, 2}} and "
                         f"taps <= 8 (got up={up}, down={down}, k={kh}x{kw})")
    n, c, h, w = x.shape
    oh = (h * up_y + py0 + py1 - kh + down_y) // down_y
    ow = (w * up_x + px0 + px1 - kw + down_x) // down_x
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    taps = k2d.to(device=x.device, dtype=torch.float32).contiguous()
    rc = _library().vt_upfirdn2d(
        _ptr(x), _ptr(taps), _ptr(y), n * c, h, w, oh, ow, up_x, up_y,
        down_x, down_y, px0, py0, kh, kw, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "upfirdn2d")
    upfirdn2d.launches += 1
    return y


# ---------------------------------------------------------------------------
# B4: depth-to-space x2


def depth_to_space2_plain(x, phase_minor: bool = False):
    """Plain version of `depth_to_space2`."""
    n, c4, h, w = x.shape
    c = c4 // 4
    if phase_minor:
        t = x.reshape(n, c, 2, 2, h, w)
    else:
        t = x.reshape(n, 2, 2, c, h, w).permute(0, 3, 1, 2, 4, 5)
    return t.permute(0, 1, 4, 2, 5, 3).reshape(n, c, 2 * h, 2 * w)


def depth_to_space2(x, phase_minor: bool = False):
    """(B, 4C, H, W) -> (B, C, 2H, 2W), NCHW, any dtype of 1, 2 or 4 bytes.

    phase_minor: input channel o*4 + a*2 + e (the polyphase up conv's
    packing); else (a*2 + e)*C + o (phase-major).
    """
    if _on_cpu(x):
        return depth_to_space2_plain(x, phase_minor)
    if not x.is_contiguous():
        raise ValueError("depth_to_space2: input must be contiguous")
    n, c4, h, w = x.shape
    if c4 % 4:
        raise ValueError(f"depth_to_space2: channels {c4} not divisible by 4")
    if x.element_size() not in (1, 2, 4):
        raise TypeError(f"depth_to_space2: dtype {x.dtype} not supported")
    y = torch.empty((n, c4 // 4, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = _library().vt_d2s2(_ptr(x), _ptr(y), n, c4 // 4, h, w,
                            x.element_size(), int(phase_minor), _stream(x))
    _raise_on(rc, "depth_to_space2")
    depth_to_space2.launches += 1
    return y


KERNELS = (modconv3x3, fused_leaky_relu, upfirdn2d, depth_to_space2)
reset_launch_counts()
