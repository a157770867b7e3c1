"""The port's hand-written Hopper kernels, each beside its plain version.

Every TPU kernel of the JAX package (each function that reaches
`pl.pallas_call` in vtoonify_tpu/ops/pallas_kernels.py) and its port:

| # | TPU kernel (file:line) | computes | port |
| --- | --- | --- | --- |
| B1 | `modconv3x3_fused_pallas` :214 (`_modconv3x3_kernel` :152, call :256) | `lrelu(d * conv3x3(x * s, w) + b) * sqrt2`, stride 1, same pad | `modconv3x3`, csrc/modconv3x3.cu (float32), csrc/modconv3x3_mma.cu (bfloat16) |
| B2 | `fused_leaky_relu_pallas` :44 (`_fused_lrelu_kernel` :37, call :58) | `(x + b)` -> lrelu 0.2 -> x sqrt2 | `fused_leaky_relu`, csrc/fused_lrelu.cu |
| B3 | `blur_same_pallas` :109 (`_blur_kernel` :79, call :122) | separable same-size FIR, generalised to upfirdn2d | `upfirdn2d`, csrc/upfirdn2d.cu |
| B4 | `depth_to_space2_pallas` :600 (`_d2s2_kernel` :591, call :617) | (B,H,W,4C) -> (B,2H,2W,C) | `depth_to_space2` (+ phase-minor), csrc/d2s2.cu |
| B5 | `affine_warp_bilinear_pallas` :470 (`_affine_warp_kernel` :351, call :542) | bilinear sampling, zero padding, along a pixel-space affine | `affine_warp`, csrc/affine_warp.cu |

Each wrapper first checks its operands against the kernel's rule (dtype,
one device and dtype for all, shapes, contiguity, the kernel's limits) on
every device, so that a CPU run refuses what the card refuses; then it
dispatches on where its tensor lies and nowhere else: a CPU tensor takes the
plain PyTorch version (`*_plain`, the tests' oracle); a CUDA tensor launches
the kernel or raises. The CUDA sources are compiled with
`nvcc` for `sm_90a` into one shared library with a plain C interface, at
first use, into `vtoonify_tpu_torch/_build/` (keyed by a hash of the
sources), and bound with `ctypes`. Each wrapper counts its launches in a
plain integer attribute, `<wrapper>.launches`.

Gradients: each wrapper runs through a `torch.autograd.Function` whose
forward dispatches as above; B2, B3, B4 and B5 take their Function only where
autograd records the op (B1 always does). The JAX package has no backward
Pallas kernel, so the backwards are plain PyTorch on every device, except
B3's, whose adjoint is upfirdn2d again and launches its kernel. Every
Function is differentiable twice, as JAX differentiates these functions
(R1 and the path-length penalty differentiate a gradient):
  * B1 recomputes its plain version on views of the saved inputs and
    calls `torch.autograd.grad` with `create_graph` exactly when the caller
    asked for it (grad mode is on inside a backward only then), so the
    gradient carries its history to them;
  * B2's backward is a `where` on the saved output and a sum, B4's the
    inverse permutation: plain ops, twice differentiable as they stand;
  * B3's backward calls the Function again (no operand check: the
    forward's holds), so the adjoint of the adjoint is a third launch of
    the same kernel on the card;
  * B5's image gradient W(coef)^T g is linear in g: `_AffineWarpAdjoint`
    computes it (the F.grid_sample VJP) and its backward is the B5 forward
    again (in g) and the coef gradient of the warp of the incoming gradient
    (in coef). The coef gradient `_AffineWarpCoefGrad` is differentiated by
    recomputing it through `affine_warp_gather_plain` (torch 2.11 has no
    derivative of grid_sampler_2d_backward), with `create_graph` exactly
    when the caller asked, as B1's backward is.
The forward stays the kernel whether or not a graph is recorded.

Layouts and arithmetic: activations are NCHW and contiguous, in float32 or
bfloat16. B2-B5 compute in float32 and load and store the caller's dtype.
B3 takes its taps from the host and passes them to the kernel by value.
B1 has one kernel per dtype: bfloat16 multiplies bf16 operands on the tensor
cores (mma.sync) into float32 accumulators; float32 stays on the CUDA cores
in exact float32 (TF32 tensor cores would miss the float32 tolerances).
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

from vtoonify_tpu_torch.utils.profiling import span

SQRT2 = math.sqrt(2.0)
MAX_TAPS = 12  # upfirdn2d filter taps per axis (csrc/upfirdn2d.cu MAX_TAPS)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_CU_FILES = ("modconv3x3.cu", "modconv3x3_mma.cu", "fused_lrelu.cu",
             "upfirdn2d.cu", "d2s2.cu", "affine_warp.cu")
_HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

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
    library for these exact sources exists): one nvcc per source, all started
    together, then one link. Raises with nvcc's output if a step fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(f).stem}.o" for f in _CU_FILES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / f)]
            for f, o in zip(_CU_FILES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    failed = [(c, log) for c, p, log in zip(cmds, procs, logs) if p.returncode]
    if not failed:
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *(str(o) for o in objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode:
            failed = [(link, res.stdout + res.stderr)]
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)}\n{log}" for c, log in failed))
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.vt_modconv3x3.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f, i, p]
        lib.vt_fused_lrelu.argtypes = [p, p, p, ll, i, ll, f, f, i, p]
        lib.vt_upfirdn2d.argtypes = [p, ctypes.POINTER(f), p, i, i, i, i, i, i,
                                     i, i, i, i, i, i, i, i, p]
        lib.vt_d2s2.argtypes = [p, p, i, i, i, i, i, i, p]
        lib.vt_affine_warp.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        for fn in (lib.vt_modconv3x3, lib.vt_fused_lrelu, lib.vt_upfirdn2d,
                   lib.vt_d2s2, lib.vt_affine_warp):
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
    """The kernels' dtype rule: float32 or bfloat16, every operand in x's
    dtype and on its device. Part of each wrapper's operand rule, held on
    every device with contiguity (`_contiguous`)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"({tuple(_DTYPE_CODE)})")
    for t in others:
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise ValueError(f"{name}: operands must share device and dtype "
                             f"({t.device}/{t.dtype} vs {x.device}/{x.dtype})")


def _contiguous(name, *ts):
    """The kernels take contiguous operands; the plain versions are held to
    the same rule so that a CPU run finds a caller that breaks it."""
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    # the raw handle of the current stream, without building a Stream object
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


def _records_grad(*ts):
    """Whether autograd records an op on these operands. B2-B5 take their
    Function only then: its host overhead is a good part of a small launch's
    time, and serving runs without gradients."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _grads_by_recompute(plain, ctx, tensors, grad_out, *consts):
    """Backward of `plain(*tensors, *consts)` by recomputing it under
    enable_grad: the gradient of every tensor input that needs one. Each such
    input enters through a view of itself, so that the gradient w.r.t. one
    input counts only the paths through it (B1's d is a function of s:
    `torch.autograd.grad` w.r.t. s itself would also count the path through
    d, which autograd adds again at d). Inside a backward grad mode is on
    exactly when the caller passed `create_graph`; then the gradient is built
    with a graph back to the inputs and `grad_out` (a double backward)."""
    need = ctx.needs_input_grad[:len(tensors)]
    with torch.enable_grad():
        leaves = [t.view_as(t) if n and t is not None else t
                  for t, n in zip(tensors, need)]
        y = plain(*leaves, *consts)
    wanted = [t for t, n in zip(leaves, need) if n and t is not None]
    got = iter(torch.autograd.grad(y, wanted, grad_out,
                                   create_graph=torch.is_grad_enabled())
               if wanted else ())
    return tuple(next(got) if n and t is not None else None
                 for t, n in zip(leaves, need))


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


def _modconv3x3_args(x, w, s, d, bias):
    """B1's operand rule, held on every device."""
    _contiguous("modconv3x3", x, w, s, d, bias)
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


def _modconv3x3_cuda(x, w, s, d, bias, negative_slope, gain):
    b, cin, h, wd = x.shape
    cout = w.shape[-1]
    y = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = _library().vt_modconv3x3(
        _ptr(x), _ptr(w), _ptr(s), _ptr(d), _ptr(bias), _ptr(y), b, cin, cout,
        h, wd, negative_slope, gain, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "modconv3x3")
    modconv3x3.launches += 1
    return y


class _ModConv3x3(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    recomputes the plain version under enable_grad and takes
    torch.autograd.grad, for x, w, s, d and bias, with a graph when the
    caller asked for one (`_grads_by_recompute`)."""

    @staticmethod
    def forward(ctx, x, w, s, d, bias, negative_slope, gain):
        ctx.save_for_backward(x, w, s, d, bias)
        ctx.consts = (negative_slope, gain)
        if _on_cpu(x):
            return modconv3x3_plain(x, w, s, d, bias, negative_slope, gain)
        return _modconv3x3_cuda(x, w, s, d, bias, negative_slope, gain)

    @staticmethod
    def backward(ctx, g):
        grads = _grads_by_recompute(modconv3x3_plain, ctx, ctx.saved_tensors,
                                    g, *ctx.consts)
        return grads + (None, None)


def modconv3x3(x, w, s=None, d=None, bias=None, negative_slope: float = 0.2,
               gain: float = SQRT2):
    """lrelu(d * conv3x3(x * s, w) + bias) * gain, stride 1, same padding.

    x: (B, Cin, H, W) NCHW; w: (3, 3, Cin, Cout) HWIO; s: (B, Cin) or None;
    d: (B, Cout) or None; bias: (Cout,) or None (None: no activation, the
    raw conv out). Returns (B, Cout, H, W) in x's dtype (float32/bfloat16).
    """
    _modconv3x3_args(x, w, s, d, bias)
    return _ModConv3x3.apply(x, w, s, d, bias, negative_slope, gain)


# ---------------------------------------------------------------------------
# B2: fused bias + leaky-ReLU x gain


def fused_leaky_relu_plain(x, bias=None, negative_slope: float = 0.2,
                           gain: float = SQRT2):
    """Plain version of `fused_leaky_relu`."""
    if bias is not None:
        x = x + bias.view((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, negative_slope) * gain


def _fused_leaky_relu_args(x, bias):
    """B2's operand rule, held on every device: the kernel indexes inside a
    plane (or, for the (N, C) form, the whole tensor) in 32 bits."""
    _contiguous("fused_leaky_relu", x, bias)
    _check("fused_leaky_relu", x, bias)
    c = x.shape[1] if x.ndim > 1 else 1
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"fused_leaky_relu: bias {tuple(bias.shape)} != {(c,)}")
    if x.ndim > 2:
        if math.prod(x.shape[2:]) >= 2**31:
            raise ValueError("fused_leaky_relu: planes of 2^31 elements or more")
    elif x.numel() >= 2**31:
        raise ValueError("fused_leaky_relu: (N, C) of 2^31 elements or more")


def _fused_leaky_relu_cuda(x, bias, negative_slope, gain):
    c = x.shape[1] if x.ndim > 1 else 1
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    inner = math.prod(x.shape[2:])
    rc = _library().vt_fused_lrelu(
        _ptr(x), _ptr(bias), _ptr(y), x.numel(), c, inner, negative_slope,
        gain, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "fused_leaky_relu")
    fused_leaky_relu.launches += 1
    return y


def _fused_leaky_relu_forward(x, bias, negative_slope, gain):
    with span("fused_leaky_relu"):
        if _on_cpu(x):
            return fused_leaky_relu_plain(x, bias, negative_slope, gain)
        return _fused_leaky_relu_cuda(x, bias, negative_slope, gain)


class _FusedLeakyReLU(torch.autograd.Function):
    """Backward by hand from the saved output (its sign is the
    pre-activation's): dx = g * gain * (1 if y > 0 else slope), and
    dbias = dx summed over every dim but 1."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, gain):
        y = _fused_leaky_relu_forward(x, bias, negative_slope, gain)
        ctx.save_for_backward(y)
        ctx.consts = (negative_slope, gain)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        slope, gain = ctx.consts
        gx = torch.where(y > 0, g * gain, g * (slope * gain))
        gb = None
        if ctx.needs_input_grad[1]:
            dims = [i for i in range(gx.ndim) if i != 1]
            gb = gx.sum(dim=dims, dtype=torch.promote_types(gx.dtype, torch.float32))
            gb = gb.to(gx.dtype)
        return (gx if ctx.needs_input_grad[0] else None), gb, None, None


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     gain: float = SQRT2):
    """leaky_relu(x + bias, slope) * gain with the bias on dim 1.

    x: (N, C, ...) — NCHW activations or (N, C) linear outputs; bias: (C,)
    in x's dtype, or None. Returns a new tensor of x's shape and dtype.
    """
    _fused_leaky_relu_args(x, bias)
    if _records_grad(x, bias):
        return _FusedLeakyReLU.apply(x, bias, negative_slope, gain)
    return _fused_leaky_relu_forward(x, bias, negative_slope, gain)


# ---------------------------------------------------------------------------
# B3: upfirdn2d


def upfirdn2d_plain(x, k2d, up=(1, 1), down=(1, 1), pad=(0, 0, 0, 0)):
    """Plain version of `upfirdn2d`: zero-stuff, pad/crop, depthwise conv
    with the flipped taps, subsample (the reference's upfirdn2d_native);
    contiguous, as the kernel's output is."""
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
    return t.reshape(n, c, t.shape[2], t.shape[3]).contiguous()


def _upfirdn2d_out_hw(h, w, kh, kw, up, down, pad):
    px0, px1, py0, py1 = pad
    return ((h * up[1] + py0 + py1 - kh + down[1]) // down[1],
            (w * up[0] + px0 + px1 - kw + down[0]) // down[0])


def _upfirdn2d_args(x, k2d, up, down, pad):
    """B3's operand rule and limits, held on every device by the wrapper
    (the backward's call inherits the forward's): contiguous float32 or
    bfloat16 input, planes indexed in 32 bits, up, down in {1, 2}, taps a
    (kh, kw) tensor on the CPU with kh, kw <= 12. The launcher passes their
    values to the kernel by value, as float32; taps on a device would have to
    be read back first, a hidden wait on it, so they raise."""
    _contiguous("upfirdn2d", x)
    if k2d.device.type != "cpu" or k2d.ndim != 2:
        raise ValueError(f"upfirdn2d takes its taps as a 2-D tensor on the CPU "
                         f"(passed to the kernel by value); got "
                         f"{tuple(k2d.shape)} on {k2d.device}")
    kh, kw = k2d.shape
    if not (set(up) | set(down) <= {1, 2} and kh <= MAX_TAPS and kw <= MAX_TAPS):
        raise ValueError(f"upfirdn2d kernel takes up, down in {{1, 2}} and "
                         f"taps <= {MAX_TAPS} (got up={up}, down={down}, "
                         f"k={kh}x{kw})")
    _check("upfirdn2d", x)
    h, w = x.shape[2:]
    oh, ow = _upfirdn2d_out_hw(h, w, kh, kw, up, down, pad)
    if max(h * w, oh * ow) >= 2**31:
        raise ValueError("upfirdn2d: planes of 2^31 elements or more")


def _upfirdn2d_cuda(x, k2d, up, down, pad):
    up_x, up_y = up
    down_x, down_y = down
    px0, _, py0, _ = pad
    kh, kw = k2d.shape
    n, c, h, w = x.shape
    oh, ow = _upfirdn2d_out_hw(h, w, kh, kw, up, down, pad)
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    taps = (ctypes.c_float * (kh * kw))(*k2d.reshape(-1).tolist())  # by value
    rc = _library().vt_upfirdn2d(
        _ptr(x), taps, _ptr(y), n * c, h, w, oh, ow, up_x, up_y,
        down_x, down_y, px0, py0, kh, kw, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(rc, "upfirdn2d")
    upfirdn2d.launches += 1
    return y


def _upfirdn2d_forward(x, k2d, up, down, pad):
    with span("upfirdn2d"):
        if _on_cpu(x):
            return upfirdn2d_plain(x, k2d, up, down, pad)
        return _upfirdn2d_cuda(x, k2d, up, down, pad)


class _UpFirDn2d(torch.autograd.Function):
    """Backward by hand: the adjoint of upfirdn2d(x, k, up, down, pad) is
    upfirdn2d(g, flip(k), up=down, down=up) with the pads that give back the
    input size (the reference's UpFirDn2dBackward): the same kernel on the
    card, the plain version on the CPU. It goes through this Function again
    where autograd records (a double backward), so the adjoint of the
    adjoint is the kernel too. The taps are constants (no gradient)."""

    @staticmethod
    def forward(ctx, x, k2d, up, down, pad):
        y = _upfirdn2d_forward(x, k2d, up, down, pad)
        ctx.save_for_backward(k2d)
        ctx.args = (x.shape[2:], y.shape[2:], up, down, pad)
        return y

    @staticmethod
    def backward(ctx, g):
        (k2d,) = ctx.saved_tensors
        (h, w), (oh, ow), (up_x, up_y), (down_x, down_y), (px0, _, py0, _) = ctx.args
        kh, kw = k2d.shape
        gpad = (kw - px0 - 1, w * up_x - ow * down_x + px0 - up_x + 1,
                kh - py0 - 1, h * up_y - oh * down_y + py0 - up_y + 1)
        gx = _upfirdn2d_call(g.contiguous(), torch.flip(k2d, (0, 1)),
                             (down_x, down_y), (up_x, up_y), gpad)
        return gx, None, None, None, None


def _upfirdn2d_call(*args):
    """`upfirdn2d` after its operand check: the Function where autograd
    records, else the forward alone."""
    if _records_grad(args[0]):
        return _UpFirDn2d.apply(*args)
    return _upfirdn2d_forward(*args)


def upfirdn2d(x, k2d, up=(1, 1), down=(1, 1), pad=(0, 0, 0, 0)):
    """Per-plane up-FIR-down resampling.

    x: (N, C, H, W) NCHW; k2d: (kh, kw) float32 taps on the CPU, in
    convolution orientation, kh, kw <= 12 (per-axis filters are (1, k) or
    (k, 1)); the kernel takes their values by value, and taps on any other
    device raise;
    up, down: (x, y) factors in {1, 2}; pad: (x0, x1, y0, y1), negative pads
    crop.
    """
    args = (x, k2d, tuple(up), tuple(down), tuple(pad))
    _upfirdn2d_args(*args)
    return _upfirdn2d_call(*args)


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


def space_to_depth2_plain(y, phase_minor: bool = False):
    """Inverse of `depth_to_space2_plain`: (N, C, 2H, 2W) -> (N, 4C, H, W)."""
    n, c, h2, w2 = y.shape
    t = y.reshape(n, c, h2 // 2, 2, w2 // 2, 2).permute(0, 1, 3, 5, 2, 4)
    if not phase_minor:
        t = t.permute(0, 2, 3, 1, 4, 5)
    return t.reshape(n, 4 * c, h2 // 2, w2 // 2)


def _depth_to_space2_args(x):
    """B4's operand rule, held on every device."""
    _contiguous("depth_to_space2", x)
    if x.shape[1] % 4:
        raise ValueError(f"depth_to_space2: channels {x.shape[1]} not divisible by 4")
    if x.element_size() not in (1, 2, 4):
        raise TypeError(f"depth_to_space2: dtype {x.dtype} not supported")


def _depth_to_space2_cuda(x, phase_minor):
    n, c4, h, w = x.shape
    y = torch.empty((n, c4 // 4, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rc = _library().vt_d2s2(_ptr(x), _ptr(y), n, c4 // 4, h, w,
                            x.element_size(), int(phase_minor), _stream(x))
    _raise_on(rc, "depth_to_space2")
    depth_to_space2.launches += 1
    return y


def _depth_to_space2_forward(x, phase_minor):
    if _on_cpu(x):
        return depth_to_space2_plain(x, phase_minor)
    return _depth_to_space2_cuda(x, phase_minor)


class _DepthToSpace2(torch.autograd.Function):
    """Backward by hand: the inverse permutation (space_to_depth2_plain)."""

    @staticmethod
    def forward(ctx, x, phase_minor):
        ctx.phase_minor = phase_minor
        return _depth_to_space2_forward(x, phase_minor)

    @staticmethod
    def backward(ctx, g):
        return space_to_depth2_plain(g, ctx.phase_minor), None


def depth_to_space2(x, phase_minor: bool = False):
    """(B, 4C, H, W) -> (B, C, 2H, 2W), NCHW, any dtype of 1, 2 or 4 bytes.

    phase_minor: input channel o*4 + a*2 + e (the polyphase up conv's
    packing); else (a*2 + e)*C + o (phase-major).
    """
    _depth_to_space2_args(x)
    if _records_grad(x):
        return _DepthToSpace2.apply(x, bool(phase_minor))
    return _depth_to_space2_forward(x, bool(phase_minor))


# ---------------------------------------------------------------------------
# B5: affine bilinear warp


def affine_warp_grid(coef, out_hw, in_hw):
    """The normalized F.grid_sample grid (N, Ho, Wo, 2), align_corners=False,
    of the pixel-space affine coef (N, 6) = [ax, bx, cx, ay, by, cy]: output
    pixel (row j, column i) samples (fx, fy) = (ax*i + bx*j + cx,
    ay*i + by*j + cy)."""
    ho, wo = out_hw
    h, w = in_hw
    coef = coef.to(torch.promote_types(coef.dtype, torch.float32))
    i = torch.arange(wo, dtype=coef.dtype, device=coef.device)[None, None, :]
    j = torch.arange(ho, dtype=coef.dtype, device=coef.device)[None, :, None]
    ax, bx, cx, ay, by, cy = (v[:, None, None] for v in coef.unbind(1))
    fx = ax * i + bx * j + cx
    fy = ay * i + by * j + cy
    return torch.stack([(2 * fx + 1) / w - 1, (2 * fy + 1) / h - 1], dim=-1)


def affine_warp_plain(img, coef, out_hw):
    """Plain version of `affine_warp`: F.grid_sample (bilinear, zeros,
    align_corners=False) on the grid of the same affine, in at least float32,
    cast back to img's dtype, contiguous as the kernel's output is (the CPU
    grid_sample may return another layout)."""
    dt = torch.promote_types(img.dtype, torch.float32)
    grid = affine_warp_grid(coef, out_hw, img.shape[2:]).to(dt)
    out = F.grid_sample(img.to(dt), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.to(img.dtype).contiguous()


def affine_warp_gather_plain(img, coef, out_hw):
    """The warp of `affine_warp_plain` by explicit gathers of the four
    neighbours on the pixel coordinates (the kernel's own arithmetic),
    differentiable twice in img and coef on every torch version (torch 2.11
    has no derivative of grid_sampler_2d_backward): `_AffineWarpCoefGrad`'s
    backward recomputes the coef gradient through it, and it is the card's
    second-order oracle of B5."""
    n, c, h, w = img.shape
    ho, wo = out_hw
    dt = torch.promote_types(img.dtype, torch.float32)
    coef = coef.to(dt)
    i = torch.arange(wo, dtype=dt, device=img.device)[None, None, :]
    j = torch.arange(ho, dtype=dt, device=img.device)[None, :, None]
    ax, bx, cx, ay, by, cy = (v[:, None, None] for v in coef.unbind(1))
    fx, fy = ax * i + bx * j + cx, ay * i + by * j + cy
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    flat = img.to(dt).reshape(n, c, h * w)
    out = 0
    for dy, dx, wt in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                       (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = flat.gather(2, idx.reshape(n, 1, ho * wo).expand(n, c, ho * wo))
        out = out + vals.reshape(n, c, ho, wo) * (wt * inside)[:, None]
    return out.to(img.dtype)


def _affine_warp_args(img, coef, out_hw):
    """B5's operand rule, held on every device: float32 coefficients
    (N, 6) beside the image, planes indexed in 32 bits."""
    _contiguous("affine_warp", img, coef)
    _check("affine_warp", img)
    n, c, h, w = img.shape
    ho, wo = out_hw
    if (coef.dtype != torch.float32 or tuple(coef.shape) != (n, 6)
            or coef.device != img.device):
        raise ValueError(f"affine_warp: coef must be a contiguous ({n}, 6) "
                         f"float32 tensor on {img.device}")
    if max(h * w, ho * wo) >= 2**31:
        raise ValueError("affine_warp: planes of 2^31 elements or more")


def _affine_warp_cuda(img, coef, out_hw):
    n, c, h, w = img.shape
    ho, wo = out_hw
    y = torch.empty((n, c, ho, wo), dtype=img.dtype, device=img.device)
    if y.numel() == 0:
        return y
    rc = _library().vt_affine_warp(_ptr(img), _ptr(coef), _ptr(y), n, c, h, w,
                                   ho, wo, _DTYPE_CODE[img.dtype], _stream(img))
    _raise_on(rc, "affine_warp")
    affine_warp.launches += 1
    return y


def _affine_warp_forward(img, coef, out_hw):
    with span("affine_warp"):
        if _on_cpu(img):
            return affine_warp_plain(img, coef, out_hw)
        return _affine_warp_cuda(img, coef, out_hw)


class _AffineWarp(torch.autograd.Function):
    """Backward: the F.grid_sample VJP, as the JAX package's custom_vjp
    takes it. The image gradient goes through `_AffineWarpAdjoint`, the
    coef gradient through `_AffineWarpCoefGrad`; both are differentiable
    again, in every input."""

    @staticmethod
    def forward(ctx, img, coef, out_hw):
        ctx.save_for_backward(img, coef)
        ctx.out_hw = out_hw
        return _affine_warp_forward(img, coef, out_hw)

    @staticmethod
    def backward(ctx, g):
        img, coef = ctx.saved_tensors
        gimg = gcoef = None
        if ctx.needs_input_grad[0]:
            gimg = _AffineWarpAdjoint.apply(g, coef, img.detach(), ctx.out_hw)
        if ctx.needs_input_grad[1]:
            gcoef = _AffineWarpCoefGrad.apply(g, img, coef, ctx.out_hw)
        return gimg, gcoef, None


class _AffineWarpAdjoint(torch.autograd.Function):
    """W(coef)^T g, the image gradient of B5 (the F.grid_sample VJP, plain
    PyTorch on every device). It is linear in g and does not depend on the
    image's values (`img` gives its shape and dtype). Its backward in g is
    the B5 forward again (the kernel on the card); in coef it is
    d<gg, W(coef)^T g>/dcoef = d<W(coef) gg, g>/dcoef, the coef gradient of
    the warp of gg."""

    @staticmethod
    def forward(ctx, g, coef, img, out_hw):
        ctx.save_for_backward(g, coef)
        ctx.out_hw = out_hw
        with torch.enable_grad():
            leaf = img.detach().requires_grad_()
            y = affine_warp_plain(leaf, coef.detach(), out_hw)
        return torch.autograd.grad(y, leaf, g)[0]

    @staticmethod
    def backward(ctx, gg):
        g, coef = ctx.saved_tensors
        gg = gg.contiguous()
        dg = dcoef = None
        if ctx.needs_input_grad[0]:
            dg = _affine_warp_call(gg, coef, ctx.out_hw)
        if ctx.needs_input_grad[1]:
            dcoef = _AffineWarpCoefGrad.apply(g, gg, coef, ctx.out_hw)
        return dg, dcoef, None, None


def _coef_grad_gather(g, img, coef, out_hw):
    """d<g, W(coef) img>/dcoef through `affine_warp_gather_plain`, with its
    graph back to g, img and coef."""
    if not coef.requires_grad:  # a constant: differentiated only through g, img
        coef = coef.detach().requires_grad_()
    y = affine_warp_gather_plain(img, coef, out_hw)
    return torch.autograd.grad((y * g).sum(), coef, create_graph=True)[0]


class _AffineWarpCoefGrad(torch.autograd.Function):
    """d<g, W(coef) img>/dcoef, the coef gradient of B5 (the F.grid_sample
    VJP). Its backward recomputes it through `affine_warp_gather_plain`,
    which is twice differentiable in coef on every torch version."""

    @staticmethod
    def forward(ctx, g, img, coef, out_hw):
        ctx.save_for_backward(g, img, coef)
        ctx.out_hw = out_hw
        with torch.enable_grad():
            leaf = coef.detach().requires_grad_()
            y = affine_warp_plain(img.detach(), leaf, out_hw)
        return torch.autograd.grad(y, leaf, g)[0]

    @staticmethod
    def backward(ctx, gg):
        return (*_grads_by_recompute(_coef_grad_gather, ctx, ctx.saved_tensors,
                                     gg, ctx.out_hw), None)


def _affine_warp_call(img, coef, out_hw):
    """`affine_warp` after its operand check: the Function where autograd
    records, else the forward alone."""
    if _records_grad(img, coef):
        return _AffineWarp.apply(img, coef, out_hw)
    return _affine_warp_forward(img, coef, out_hw)


def affine_warp(img, coef, out_hw):
    """Bilinear warp with zero padding: img (N, C, H, W) float32/bfloat16;
    coef (N, 6) float32 pixel-space affine [ax, bx, cx, ay, by, cy] (see
    `affine_warp_grid`); returns (N, C, Ho, Wo) in img's dtype. No bound on
    the affine's scale. Differentiable twice in img and coef."""
    out_hw = tuple(int(v) for v in out_hw)
    _affine_warp_args(img, coef, out_hw)
    return _affine_warp_call(img, coef, out_hw)


KERNELS = (modconv3x3, fused_leaky_relu, upfirdn2d, depth_to_space2,
           affine_warp)
reset_launch_counts()
