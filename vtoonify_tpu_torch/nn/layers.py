"""StyleGAN2-family building blocks (port of vtoonify_tpu/nn/layers.py).

Each block is an `nn.Module` that holds the parameters under the JAX
package's names, plus a function of the same name as the JAX apply function
that takes the module as `p`:

    p = StyledConv(in_ch, out_ch, 3, style_dim, generator=g)
    y = styled_conv(p, x, style, upsample=True)

Parameters are stored RAW, as the reference stores them; the equalized-LR
scales (1/sqrt(fan_in) * lr_mul) are applied at call time. Layouts are
PyTorch's: activations NCHW, conv weights OIHW, linear weights (out, in).
Constructors draw from an explicit `torch.Generator` on the CPU, with the
JAX `init_*` distributions; move the module with `.to(device, dtype)`.
Parameters are frozen (`requires_grad=False`) unless a trainer marks a
subtree with `set_trainable`.

The styled 3x3 convs (plain and polyphase x2 up) run in kernel B1 with their
bias + leaky-ReLU epilogue fused; with noise injection B1 runs raw and the
noise add is followed by kernel B2. The up conv's interleave runs in kernel
B4; ToRGB's skip upsample, conv_layer's downsampling blur and the blurs of
the non-fused up and down modulated convs in kernel B3; conv_layer's
activation in kernel B2. All five carry gradients, twice.
The serving path's layers also take a row-sharded activation
(`parallel.spatial`: one frame's rows split over an 'sp' mesh): the convs
read halo rows from the neighbouring slabs, B1 runs on each slab with its
halo rows and drops the output rows they give, and `instance_norm_2d` sums
its statistics over the slabs.
Not ported (TPU-only): the space-to-depth packed stage variants and the
cat2-split weight storage (fusion convs and the discriminator's final conv
hold one merged weight).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
from torch import nn

from vtoonify_tpu_torch.ops import kernels
from vtoonify_tpu_torch.ops.convs import conv2d, conv_transpose2d
from vtoonify_tpu_torch.ops.fused_act import fused_leaky_relu
from vtoonify_tpu_torch.ops.upfirdn2d import blur, make_kernel, upsample_2x
from vtoonify_tpu_torch.parallel import spatial

BLUR_KERNEL = (1.0, 3.0, 3.0, 1.0)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _blur_1d(blur_kernel: tuple) -> torch.Tensor:
    """The normalized 1-D blur taps, a CPU float32 constant built once per
    kernel: B3 takes its taps from the host, by value. Made outside
    inference mode, so a first call under it leaves a constant that
    autograd may save."""
    return make_kernel(blur_kernel)


@functools.lru_cache(maxsize=None)
@torch.inference_mode(False)
def _upsample_blur_taps(blur_kernel: tuple, device, dtype) -> torch.Tensor:
    """`_compose_upsample_kernel`'s scatter of the x4-gain 2-D blur, on the
    weight's device, made once: a copy from pageable memory per call would
    block the host until the stream drains; this pinned one does not. Made
    outside inference mode: the up conv's weight gradient saves it, and a
    serving call under inference mode may be the first to ask for it."""
    bk1 = make_kernel(blur_kernel)
    bk = torch.outer(bk1, bk1) * 4.0
    kt = bk.shape[0]
    taps = torch.zeros((3, 3, 3 + kt - 1, 3 + kt - 1))
    for a in range(3):
        for b in range(3):
            taps[a, b, a:a + kt, b:b + kt] = bk
    taps = taps.to(dtype)
    if device.type == "cpu":
        return taps
    return taps.pin_memory().to(device, non_blocking=True)


# (B, 4C, H, W) -> (B, C, 2H, 2W), kernel B4; phase-major unless phase_minor
depth_to_space2 = kernels.depth_to_space2


def _uniform(generator, shape, bound):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def _param(t):
    return nn.Parameter(t, requires_grad=False)


def set_trainable(module: nn.Module, trainable: bool = True) -> nn.Module:
    """Mark every parameter of `module` as trainable (or frozen again)."""
    for p in module.parameters():
        p.requires_grad_(trainable)
    return module


# ---------------------------------------------------------------------------
# elementwise


def pixel_norm(x, eps: float = 1e-8):
    """reference model.py:13-18 (channel dim 1)."""
    return x * torch.rsqrt(torch.mean(x.square(), dim=1, keepdim=True) + eps)


# ---------------------------------------------------------------------------
# equalized-LR linear / conv


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, bias=True, bias_init=0.0, lr_mul=1.0,
                 generator=None):
        super().__init__()
        self.weight = _param(torch.randn((out_dim, in_dim), generator=generator)
                             / lr_mul)
        self.bias = _param(torch.full((out_dim,), float(bias_init))) if bias else None


def equal_linear(p, x, lr_mul: float = 1.0, activation: bool = False):
    """reference model.py:133-162."""
    scale = (1.0 / math.sqrt(p.weight.shape[1])) * lr_mul
    out = x @ (p.weight * scale).to(x.dtype).t()
    b = p.bias
    if activation:
        return fused_leaky_relu(out, None if b is None else b * lr_mul)
    if b is not None:
        out = out + (b * lr_mul).to(out.dtype)
    return out


class EqualConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, ksize, bias=True, generator=None):
        super().__init__()
        self.weight = _param(torch.randn((out_ch, in_ch, ksize, ksize),
                                         generator=generator))
        self.bias = _param(torch.zeros(out_ch)) if bias else None


def equal_conv2d(p, x, stride=1, padding=0, dilation=1):
    """reference model.py:93-124 (incl. the VToonify dilation modification)."""
    cout, cin, kh, kw = p.weight.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    out = conv2d(x, (p.weight * scale).to(x.dtype), stride=stride,
                 padding=padding, dilation=dilation)
    if p.bias is not None:
        out = out + p.bias.to(out.dtype)[None, :, None, None]
    return out


# ---------------------------------------------------------------------------
# ConvLayer = [Blur?] -> EqualConv2d -> [FusedLeakyReLU?]
# (reference model.py:593-637)


class ConvLayer(nn.Module):
    def __init__(self, in_ch, out_ch, ksize, bias=True, activate=True,
                 generator=None):
        super().__init__()
        self.conv = EqualConv2d(in_ch, out_ch, ksize, bias=bias and not activate,
                                generator=generator)
        self.act_bias = _param(torch.zeros(out_ch)) if activate and bias else None


def conv_layer(p, x, ksize, downsample=False, activate=True, dilation=1,
               blur_kernel: Sequence[float] = BLUR_KERNEL):
    if downsample:
        pd = (len(blur_kernel) - 2) + (ksize - 1)
        x = blur(x, _blur_1d(tuple(blur_kernel)), pad=((pd + 1) // 2, pd // 2))
        out = equal_conv2d(p.conv, x, stride=2, padding=0)
    else:
        out = equal_conv2d(p.conv, x, stride=1, padding=ksize // 2 + dilation - 1,
                           dilation=dilation)
    if activate:
        out = fused_leaky_relu(out, p.act_bias)
    return out


class ResBlock(nn.Module):
    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        g = generator
        self.conv1 = ConvLayer(in_ch, in_ch, 3, generator=g)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, generator=g)
        self.skip = ConvLayer(in_ch, out_ch, 1, bias=False, activate=False,
                              generator=g)


def res_block(p, x):
    """reference model.py:640-658 (the discriminator's downsampling block)."""
    out = conv_layer(p.conv1, x, 3)
    out = conv_layer(p.conv2, out, 3, downsample=True)
    skip = conv_layer(p.skip, x, 1, downsample=True, activate=False)
    return (out + skip) / math.sqrt(2)


# ---------------------------------------------------------------------------
# modulated conv


class ModulatedConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, ksize, style_dim, generator=None):
        super().__init__()
        self.weight = _param(torch.randn((out_ch, in_ch, ksize, ksize),
                                         generator=generator))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0,
                                      generator=generator)


def _compose_upsample_kernel(w_scaled, blur_kernel):
    """Fold the x2-upsample blur into the transposed-conv kernel.

    conv_transpose(stride 2, k=3) -> Blur (4-tap, x4 gain) is linear, so it
    equals ONE 6-tap kernel on the zero-stuffed input:
    c = conv_full(flip(W), 4 * blur2d). w_scaled: (3, 3, cin, cout) HWIO;
    returns (6, 6, cin, cout)."""
    g = torch.flip(w_scaled, (0, 1))
    taps = _upsample_blur_taps(tuple(blur_kernel), g.device, g.dtype)
    return torch.einsum("abio,abpq->pqio", g, taps)


def _fused_upsample_weight(w_scaled, blur_kernel):
    """(3, 3, cin, cout) HWIO -> the (3, 3, cin, 4*cout) polyphase weight of
    the x2 up conv at INPUT resolution, phase-MINOR packing (output channel
    o*4 + a*2 + b holds output pixel (2u+a, 2v+b) of channel o)."""
    c = _compose_upsample_kernel(w_scaled, blur_kernel)
    phases = [c[1::2, 1::2], c[1::2, 0::2], c[0::2, 1::2], c[0::2, 0::2]]
    cin, cout = c.shape[2], c.shape[3]
    return torch.stack(phases, dim=-1).reshape(3, 3, cin, 4 * cout)


def modulated_conv2d(p, x, style, demodulate=True, upsample=False,
                     downsample=False, act_bias=None,
                     blur_kernel: Sequence[float] = BLUR_KERNEL,
                     eps: float = 1e-8, fuse_upsample: bool = True):
    """reference model.py:170-306, scale-activations formulation, with the
    JAX package's shared-style weight fold (style batch 1, frame batch > 1).
    The 3x3 conv and its polyphase x2 up conv (`fuse_upsample`, a 4-tap
    blur) run in B1, the up conv's interleave in B4. Every other form is
    plain torch around B3: the non-fused up conv (a stride-2 transposed
    conv, then the x4-gain blur), the downsampling conv (the blur, then a
    stride-2 conv) and the 1x1 and other sizes. `act_bias` adds
    styled_conv's bias + leaky-ReLU: in B1's epilogue, or B2 after the
    other forms."""
    w = p.weight
    cout, cin, kh, kw = w.shape
    scale = 1.0 / math.sqrt(cin * kh * kw)
    s = equal_linear(p.modulation, style)  # (B, cin)
    d = None
    if demodulate:
        # d_b,o = rsqrt(sum_i s_bi^2 * (scale^2 * sum_hw W_oihw^2) + eps)
        w2 = (scale * scale) * w.square().sum(dim=(2, 3)).t()  # (cin, cout)
        d = torch.rsqrt(s.float().square() @ w2.float() + eps)  # f32

    # shared-style fold (one style code for a batch of frames): modulation
    # and demodulation go into the kernel, not the activations
    fold = s.shape[0] == 1 and x.shape[0] != 1
    if fold:
        wf = (w * scale) * s[0].float()[None, :, None, None]
        if d is not None:
            wf = wf * d[0][:, None, None, None]
        wsc, s_x, d_x = wf.to(x.dtype), None, None
    else:
        wsc = (w * scale).to(x.dtype)
        s_x = s.to(x.dtype).contiguous()
        d_x = None if d is None else d.to(x.dtype).contiguous()
    bias = None if act_bias is None else act_bias.to(x.dtype).contiguous()

    fused_up = fuse_upsample and len(blur_kernel) == 4
    if kh == 3 and not downsample and (fused_up or not upsample):
        w_hwio = wsc.permute(2, 3, 1, 0)
        if not upsample:
            w_k, d_k, b_k = w_hwio.contiguous(), d_x, bias
        else:
            w_k = _fused_upsample_weight(w_hwio, blur_kernel).contiguous()
            # per-output-channel epilogue operands repeat per phase (o*4 + phase)
            d_k = None if d_x is None else d_x.repeat_interleave(4, dim=1)
            b_k = None if bias is None else bias.repeat_interleave(4)

        def conv(t, *operands):
            y = kernels.modconv3x3(t, *operands)
            return depth_to_space2(y, phase_minor=True) if upsample else y

        if isinstance(x, spatial.RowSharded):
            return spatial.same_conv3x3(x, lambda t: conv(t, *(
                spatial.local(v, t.device) for v in (w_k, s_x, d_k, b_k))), upsample)
        return conv(x.contiguous(), w_k, s_x, d_k, b_k)

    if s_x is not None:
        x = x * s_x[:, :, None, None]
    if upsample:
        out = conv_transpose2d(x, wsc.transpose(0, 1), stride=2, padding=0)
        pd = (len(blur_kernel) - 2) - (kh - 1)
        out = blur(out.contiguous(), _blur_1d(tuple(blur_kernel)),
                   pad=((pd + 1) // 2 + 1, pd // 2 + 1), upsample_factor=2)
    elif downsample:
        pd = (len(blur_kernel) - 2) + (kh - 1)
        x = blur(x.contiguous(), _blur_1d(tuple(blur_kernel)),
                 pad=((pd + 1) // 2, pd // 2))
        out = conv2d(x, wsc, stride=2)
    else:  # ToRGB's 1x1 conv, and any other size: an XLA conv in JAX
        out = conv2d(x, wsc, padding=kh // 2)
    if d_x is not None:
        out = out * d_x[:, :, None, None]
    return out if bias is None else fused_leaky_relu(out, bias)


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = _param(torch.zeros(()))


def noise_injection(p, x, noise):
    """reference model.py:309-320; noise (B, 1, H, W) or None."""
    if noise is None:
        return x
    return x + p.weight.to(x.dtype) * noise.to(x.dtype)


class StyledConv(nn.Module):
    def __init__(self, in_ch, out_ch, ksize, style_dim, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, ksize, style_dim,
                                    generator=generator)
        self.noise = NoiseInjection()
        self.act_bias = _param(torch.zeros(out_ch))


def styled_conv(p, x, style, noise=None, upsample=False, demodulate=True):
    """reference model.py:336-370. Without noise (VToonify runs with zero
    noise, vtoonify.py:266-267) the bias + leaky-ReLU fuse into B1's
    epilogue; with noise (B, 1, H', W') B1 runs raw (then B4 for the up
    conv), the noise is added, then B2."""
    if noise is None:
        return modulated_conv2d(p.conv, x, style, demodulate=demodulate,
                                upsample=upsample, act_bias=p.act_bias)
    out = modulated_conv2d(p.conv, x, style, demodulate=demodulate,
                           upsample=upsample)
    return fused_leaky_relu(noise_injection(p.noise, out, noise), p.act_bias)


class ToRGB(nn.Module):
    def __init__(self, in_ch, style_dim, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, generator=generator)
        self.bias = _param(torch.zeros((1, 3, 1, 1)))


def to_rgb(p, x, style, skip=None, blur_kernel: Sequence[float] = BLUR_KERNEL):
    """reference model.py:373-392 (1x1 mod conv without demodulation)."""
    out = modulated_conv2d(p.conv, x, style, demodulate=False)
    out = out + p.bias.to(out.dtype)
    if skip is not None:
        out = out + upsample_2x(skip.contiguous(), _blur_1d(tuple(blur_kernel)))
    return out


# ---------------------------------------------------------------------------
# plain torch-style layers (VToonify encoder / BiSeNet)


class Conv2dTorch(nn.Module):
    """nn.Conv2d default init: kaiming_uniform(a=sqrt(5)) + uniform bias."""

    def __init__(self, in_ch, out_ch, ksize, bias=True, generator=None):
        super().__init__()
        fan_in = in_ch * ksize * ksize
        self.weight = _param(_uniform(generator, (out_ch, in_ch, ksize, ksize),
                                      math.sqrt(6.0 / ((1 + 5.0) * fan_in))))
        self.bias = (_param(_uniform(generator, (out_ch,), 1.0 / math.sqrt(fan_in)))
                     if bias else None)


def conv2d_torch(p, x, stride=1, padding=0, dilation=1, groups=1):
    out = conv2d(x, p.weight.to(x.dtype), stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    if p.bias is not None:
        out = out + p.bias.to(out.dtype)[None, :, None, None]
    return out


def conv2d_torch_cat2(p, x1, x2, padding=0):
    """conv2d_torch(p, cat([x1, x2], channels)) — the JAX package splits the
    contraction per operand for GSPMD; one merged weight here."""
    return conv2d_torch(p, torch.cat([x1, x2], dim=1), padding=padding)


class LinearTorch(nn.Module):
    def __init__(self, in_dim, out_dim, bias=True, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.weight = _param(_uniform(generator, (out_dim, in_dim),
                                      math.sqrt(6.0 / ((1 + 5.0) * in_dim))))
        self.bias = _param(_uniform(generator, (out_dim,), bound)) if bias else None


def linear_torch(p, x):
    out = x @ p.weight.to(x.dtype).t()
    if p.bias is not None:
        out = out + p.bias.to(out.dtype)
    return out


class PReLU(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.weight = _param(torch.full((ch,), 0.25))


def prelu(p, x):
    """torch nn.PReLU with a per-channel weight (channel dim 1)."""
    return torch.where(x >= 0, x, p.weight.to(x.dtype)[None, :, None, None] * x)


def instance_norm_2d(x, eps: float = 1e-5):
    """nn.InstanceNorm2d(affine=False) — per (N, C) spatial stats. On row
    slabs the mean and then the biased variance are sums over the slabs, in
    float32 (float64 for float64), cast to x's dtype as torch's are."""
    if isinstance(x, spatial.RowSharded):
        n = x.shape[2] * x.shape[3]
        acc = torch.promote_types(x.dtype, torch.float32)
        mean = spatial.all_reduce_sum([t.to(acc).sum((2, 3), keepdim=True)
                                       for t in x.parts]) / n
        var = spatial.all_reduce_sum([(t.to(acc) - m).square().sum((2, 3), keepdim=True)
                                      for t, m in zip(x.parts, mean.parts)]) / n
        return (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class BatchNorm2d(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.weight = _param(torch.ones(ch))
        self.bias = _param(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))


def batch_norm_2d(p, x, eps: float = 1e-5):
    """nn.BatchNorm2d in eval mode (running stats)."""
    inv = torch.rsqrt(p.running_var + eps) * p.weight
    shift = p.bias - p.running_mean * inv
    return (x * inv.to(x.dtype)[None, :, None, None]
            + shift.to(x.dtype)[None, :, None, None])


def batch_norm_2d_train(p, x, momentum: float = 0.1, eps: float = 1e-5):
    """nn.BatchNorm2d in train mode: normalize with the biased batch
    statistics, computed in float32 (float64 for a float64 x; gradients
    flow through them), and
    update `p`'s running buffers in place with the unbiased variance at
    momentum 0.1 (RAFT trains its context encoder's batch norm on the
    'chairs' stage, reference model/raft/train.py:146-147)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))  # biased
    inv = torch.rsqrt(var + eps) * p.weight
    shift = p.bias - mean * inv
    y = (x * inv.to(x.dtype)[None, :, None, None]
         + shift.to(x.dtype)[None, :, None, None])
    n = x.shape[0] * x.shape[2] * x.shape[3]
    with torch.no_grad():
        p.running_mean.mul_(1 - momentum).add_(momentum * mean)
        p.running_var.mul_(1 - momentum).add_(momentum * var * (n / max(n - 1, 1)))
    return y


# ---------------------------------------------------------------------------
# AdaIN + ModRes (reference model/dualstylegan.py:6-45)


class AdaptiveInstanceNorm(nn.Module):
    def __init__(self, fin, style_dim=512, generator=None):
        super().__init__()
        self.style = LinearTorch(style_dim, fin * 2, generator=generator)
        with torch.no_grad():
            self.style.bias[:fin] = 1.0
            self.style.bias[fin:] = 0.0


def adaptive_instance_norm(p, x, style):
    fin = x.shape[1]
    st = linear_torch(p.style, style)  # (B, 2*fin)
    return (st[:, :fin, None, None] * instance_norm_2d(x)
            + st[:, fin:, None, None])


class AdaResBlock(nn.Module):
    def __init__(self, fin, style_dim=512, generator=None):
        super().__init__()
        self.conv1 = ConvLayer(fin, fin, 3, generator=generator)
        self.conv2 = ConvLayer(fin, fin, 3, generator=generator)
        self.norm1 = AdaptiveInstanceNorm(fin, style_dim, generator=generator)
        self.norm2 = AdaptiveInstanceNorm(fin, style_dim, generator=generator)
        # near-zero conv init -> negligible residual at start
        # (dualstylegan.py:35-36)
        with torch.no_grad():
            self.conv1.conv.weight.mul_(0.01)
            self.conv2.conv.weight.mul_(0.01)


def ada_res_block(p, x, style, w=1.0, dilation=1):
    """reference dualstylegan.py:24-45. The weight `w` (the style degree)
    is cast to the activation dtype so a bf16 graph stays bf16."""
    if isinstance(w, (int, float)) and w == 0:
        return x
    out = conv_layer(p.conv1, adaptive_instance_norm(p.norm1, x, style), 3,
                     dilation=dilation)
    out = conv_layer(p.conv2, adaptive_instance_norm(p.norm2, out, style), 3,
                     dilation=dilation)
    return out * torch.as_tensor(w, dtype=out.dtype, device=out.device) + x
