"""The plain reference of the frame graph: VToonify-D / VToonify-T behind
BiSeNet, in plain PyTorch, on upstream's state-dict names.

It follows the upstream repository (github.com/williamyang1991/VToonify):
style_transfer.py's per-frame path (normalise to [-1, 1], BiSeNet on the 2x
bilinear frame at gain 2, nearest x0.5 of its logits, concat at weight 1/16,
VToonify, clamp), model/vtoonify.py (encoder, ModRes blocks, fusion, the
synthesis walk from 32 px), model/dualstylegan.py (T_c, T_s, AdaResBlock),
model/stylegan/model.py (equalized-LR layers, modulated convs with the
transposed x2 up conv and its blur, ToRGB skips) and model/bisenet/model.py.
It imports nothing of the program. Departures, each of which leaves the
image unchanged: the per-video style code is one W+ code for every frame, so
each modulated weight is built once for the batch and run as one plain conv
(upstream's grouped conv computes the same sums per frame); BiSeNet's two
auxiliary heads, which the frame graph discards, are not computed; the
styled convs' noise strengths are zero, so no noise is drawn. The uint8
output rounds half to even, as the program states it quantizes (upstream's
save_image truncates).

`precision="float32"` computes in float32 with TF32 off. `precision="fp8"`
is the control: the same graph with the operands of every convolution and
linear layer rounded to float8 e4m3 with a per-tensor scale (amax / 448),
accumulating in float32: the step below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from gpubench.weights import encoder_res, log2i

SQRT2 = math.sqrt(2.0)
LEAKY = 0.2
BLUR = (1.0, 3.0, 3.0, 1.0)
E4M3_MAX = 448.0


def _fp8(t):
    amax = t.abs().amax().float().clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Ref:
    """The reference graph over a state dict `sd` (upstream names, float32
    tensors) for a config file's "vtoonify" group `cfg`."""

    def __init__(self, sd: dict, cfg: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.sd, self.cfg = sd, cfg
        self.q = _fp8 if precision == "fp8" else (lambda t: t)

    # -- primitives --------------------------------------------------------

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding, dilation, groups)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def plain_conv(self, name, x, stride=1, padding=None, bias=True):
        w = self.sd[f"{name}.weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        return self.conv(x, w, self.sd.get(f"{name}.bias") if bias else None, stride, pad)

    def equal_linear(self, name, x, lr_mul=1.0, activate=False):
        w, b = self.sd[f"{name}.weight"], self.sd[f"{name}.bias"]
        w = w * (lr_mul / math.sqrt(w.shape[1]))
        if activate:
            return fused_lrelu(self.linear(x, w), b * lr_mul)
        return self.linear(x, w, b * lr_mul)

    # -- StyleGAN2 layers ---------------------------------------------------

    def modulated_weight(self, name, style, demodulate=True):
        """(1, cout, cin, k, k) upstream weight * scale * s (and demod) for a
        (1, 512) style -> a (cout, cin, k, k) conv weight."""
        w = self.sd[f"{name}.weight"][0]
        cout, cin, k, _ = w.shape
        s = self.equal_linear(f"{name}.modulation", style)[0]
        w = w * (1.0 / math.sqrt(cin * k * k)) * s[None, :, None, None]
        if demodulate:
            w = w * torch.rsqrt(w.square().sum((1, 2, 3)) + 1e-8)[:, None, None, None]
        return w

    def styled_conv(self, name, x, style, upsample=False):
        w = self.modulated_weight(f"{name}.conv", style)
        if upsample:
            out = F.conv_transpose2d(self.q(x), self.q(w).transpose(0, 1), stride=2)
            out = upfirdn2d(out, _kernel2d(BLUR, 4.0), pad=(1, 1))
        else:
            out = self.conv(x, w, padding=1)
        # noise strength is zero in these weights: no noise term
        return fused_lrelu(out, self.sd[f"{name}.activate.bias"])

    def to_rgb(self, name, x, style, skip):
        w = self.modulated_weight(f"{name}.conv", style, demodulate=False)
        out = self.conv(x, w) + self.sd[f"{name}.bias"]
        return out + upfirdn2d(skip, _kernel2d(BLUR, 4.0), up=2, pad=(2, 1))

    def adain(self, name, x, style):
        st = self.linear(style, self.sd[f"{name}.style.weight"], self.sd[f"{name}.style.bias"])
        gamma, beta = st[:, :, None, None].chunk(2, 1)
        return gamma * instance_norm(x) + beta

    def conv_layer(self, name, x, dilation=1):
        """upstream ConvLayer (as VToonify modifies it: a dilation) with its
        FusedLeakyReLU; no bias on the conv itself."""
        w = self.sd[f"{name}.0.weight"]
        w = w * (1.0 / math.sqrt(w[0].numel()))
        return fused_lrelu(self.conv(x, w, padding=dilation, dilation=dilation),
                           self.sd[f"{name}.1.bias"])

    def ada_res_block(self, name, x, style, w, dilation):
        out = self.conv_layer(f"{name}.conv", self.adain(f"{name}.norm", x, style), dilation)
        out = self.conv_layer(f"{name}.conv2", self.adain(f"{name}.norm2", out, style), dilation)
        return out * w + x

    # -- VToonify -------------------------------------------------------------

    def fusion(self, k, f_g, f_e, d_s):
        p = f"fusion_out.{k}"
        label = torch.full((1, 1), float(d_s), device=f_g.device)
        label = F.leaky_relu(self.linear(label, self.sd[f"{p}.linear.0.weight"],
                                         self.sd[f"{p}.linear.0.bias"]), LEAKY)
        label = F.leaky_relu(self.linear(label, self.sd[f"{p}.linear.2.weight"],
                                         self.sd[f"{p}.linear.2.bias"]), LEAKY)
        out = torch.cat([f_g, torch.abs(f_g - f_e)], 1)
        m_e = torch.tanh(F.relu(self.plain_conv(f"{p}.conv2", self.adain(f"{p}.norm", out, label))))
        return self.plain_conv(f"{p}.conv", torch.cat([f_g, f_e * m_e], 1)), m_e

    def vtoonify(self, x, style, d_s):
        """x (B, 22, H, W) in [-1, 1] and logits / 16; style (1, n_latent,
        512) W+ -> (B, 3, 4H, 4W)."""
        cfg = self.cfg
        is_d = cfg["backbone"] == "dualstylegan"
        n_latent = log2i(cfg["out_size"]) * 2 - 2
        gp = "generator.generator" if is_d else "generator"
        ada = [style[:, i] for i in range(n_latent)]
        res = None
        if is_d:
            # T_c on every layer's code, for the encoder's ModRes blocks
            r = style[0] * torch.rsqrt(style[0].square().mean(1, keepdim=True) + 1e-8)
            for i in range(cfg["num_mlps"] - 6):
                r = self.equal_linear(f"generator.style.{i + 1}", r, lr_mul=0.01, activate=True)
            res = [r[i:i + 1] for i in range(n_latent)]
            # T_s on the codes of layers 7 and up
            for i in range(7, n_latent):
                ada[i] = self.equal_linear(f"generator.res.{i}", ada[i])

        lrelu = lambda t: F.leaky_relu(t, LEAKY)  # noqa: E731
        feat = lrelu(self.plain_conv("encoder.0.0", x))
        feat = lrelu(self.plain_conv("encoder.0.2", feat))
        feats = [feat]
        n_down = sum(1 for r_ in encoder_res(cfg) if r_ > 32)
        for i in range(1, n_down + 1):
            feat = lrelu(self.plain_conv(f"encoder.{i}.0", feat, stride=2))
            feat = lrelu(self.plain_conv(f"encoder.{i}.2", feat))
            feats.append(feat)
        feats = feats[::-1]
        for j in range(cfg["num_res_layers"]):
            pre = f"encoder.{n_down + 1}.{j}"
            out = lrelu(self.plain_conv(f"{pre}.conv", feat))
            out = lrelu(self.plain_conv(f"{pre}.conv2", out))
            feat = (out + feat) / SQRT2
            if is_d:
                feat = self.ada_res_block(f"res.{j + 1}", feat, res[j + 1], d_s,
                                          dilation=2 ** (2 - j // 2))
        out = feat
        skip = self.plain_conv(f"encoder.{n_down + 2}", feat)

        idx = 1
        for pair in range(3, log2i(cfg["out_size"]) - 2):
            if 2 ** (5 + (idx - 1) // 2) <= cfg["in_size"]:
                k = (idx - 1) // 2
                f_e = feats[k]
                if is_d:
                    out, m_e = self.fusion(k, out, f_e, d_s)
                    skip = self.plain_conv(f"fusion_skip.{k}", torch.cat([skip, f_e * m_e], 1))
                else:
                    out = self.plain_conv(f"fusion_out.{k}", torch.cat([out, f_e], 1))
                    skip = self.plain_conv(f"fusion_skip.{k}", torch.cat([skip, f_e], 1))
            out = self.styled_conv(f"{gp}.convs.{2 * pair}", out, ada[idx + 6], upsample=True)
            out = self.styled_conv(f"{gp}.convs.{2 * pair + 1}", out, ada[idx + 7])
            skip = self.to_rgb(f"{gp}.to_rgbs.{pair}", out, ada[idx + 8], skip)
            idx += 2
        return skip


# -- elementwise and resampling ---------------------------------------------


def fused_lrelu(x, bias):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return F.leaky_relu(x + bias.view(shape), LEAKY) * SQRT2


def instance_norm(x, eps=1e-5):
    mean = x.mean((2, 3), keepdim=True)
    var = x.var((2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _kernel2d(k, gain):
    k = torch.tensor(k, dtype=torch.float32)
    k = torch.outer(k, k)
    return k / k.sum() * gain


def upfirdn2d(x, k2d, up=1, pad=(0, 0)):
    """upstream upfirdn2d (down 1): zero-stuff by `up`, pad by (pad0, pad1)
    on both axes, true 2-D convolution with k2d, per channel."""
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(b, c, h * up, w * up)
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.flip(k2d, (0, 1)).to(x)[None, None].expand(c, 1, *k2d.shape)
    return F.conv2d(x, k, groups=c)


# -- BiSeNet -----------------------------------------------------------------


class RefBiSeNet:
    """upstream BiSeNet (ResNet-18 context path, ARMs, FFM), batch norms in
    eval mode; the main head only."""

    def __init__(self, sd: dict, ref: Ref):
        self.sd, self.r = sd, ref

    def bn(self, name, x):
        sd = self.sd
        inv = torch.rsqrt(sd[f"{name}.running_var"] + 1e-5) * sd[f"{name}.weight"]
        shift = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]

    def conv(self, name, x, stride=1, padding=None):
        w = self.sd[f"{name}.weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        return self.r.conv(x, w, None, stride, pad)

    def cbr(self, name, x, padding=None):
        return F.relu(self.bn(f"{name}.bn", self.conv(f"{name}.conv", x, padding=padding)))

    def basic(self, pre, x, stride):
        r = F.relu(self.bn(f"{pre}.bn1", self.conv(f"{pre}.conv1", x, stride)))
        r = self.bn(f"{pre}.bn2", self.conv(f"{pre}.conv2", r))
        s = x
        if f"{pre}.downsample.0.weight" in self.sd:
            s = self.bn(f"{pre}.downsample.1", self.conv(f"{pre}.downsample.0", x, stride))
        return F.relu(s + r)

    def arm(self, name, x):
        feat = self.cbr(f"{name}.conv", x)
        atten = self.conv(f"{name}.conv_atten", feat.mean((2, 3), keepdim=True))
        return feat * torch.sigmoid(self.bn(f"{name}.bn_atten", atten))

    def __call__(self, x):
        h, w = x.shape[2:]
        rn = "cp.resnet"
        t = F.relu(self.bn(f"{rn}.bn1", self.conv(f"{rn}.conv1", x, stride=2, padding=3)))
        t = F.max_pool2d(t, 3, 2, 1)
        feats = []
        for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2), ("layer4", 2)):
            t = self.basic(f"{rn}.{layer}.1", self.basic(f"{rn}.{layer}.0", t, stride), 1)
            feats.append(t)
        feat8, feat16, feat32 = feats[1:]
        avg = self.cbr("cp.conv_avg", feat32.mean((2, 3), keepdim=True), padding=0)
        feat32_sum = self.arm("cp.arm32", feat32) + avg
        feat32_up = self.cbr("cp.conv_head32",
                             F.interpolate(feat32_sum, feat16.shape[2:], mode="nearest"))
        feat16_sum = self.arm("cp.arm16", feat16) + feat32_up
        feat16_up = self.cbr("cp.conv_head16",
                             F.interpolate(feat16_sum, feat8.shape[2:], mode="nearest"))
        feat = self.cbr("ffm.convblk", torch.cat([feat8, feat16_up], 1), padding=0)
        atten = F.relu(self.conv("ffm.conv1", feat.mean((2, 3), keepdim=True)))
        atten = torch.sigmoid(self.conv("ffm.conv2", atten))
        feat = feat * atten + feat
        out = self.conv("conv_out.conv_out", self.cbr("conv_out.conv", feat))
        return F.interpolate(out, (h, w), mode="bilinear", align_corners=True)


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def frame_image(vt_sd, bs_sd, cfg, frames_u8, s_w, d_s, precision="float32"):
    """uint8 frames (B, H, W, 3) on the reference's device -> the float
    image (B, 3, 4H, 4W) after the clamp (style_transfer.py:165-177)."""
    ref = Ref(vt_sd, cfg, precision)
    with torch.inference_mode(), no_tf32():
        x = frames_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        h, w = x.shape[2:]
        x2 = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        logits = RefBiSeNet(bs_sd, ref)(2.0 * x2)
        x_p = F.interpolate(logits, size=(h, w), mode="nearest")
        y = ref.vtoonify(torch.cat([x, x_p / 16.0], 1), s_w.float(), d_s)
        return torch.clamp(y, -1.0, 1.0)


def quantize(y):
    """[-1, 1] image (B, 3, H, W) -> uint8 (B, H, W, 3), round half to even."""
    return torch.round((y + 1.0) * 127.5).to(torch.uint8).permute(0, 2, 3, 1)
