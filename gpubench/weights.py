"""Seeded random weights in the upstream repository's state-dict layout.

`vtoonify_layout(cfg)` and `bisenet_layout(cfg)` list every tensor of
upstream's `VToonify(...).state_dict()` and `BiSeNet(19).state_dict()` by its
upstream name and shape, with the rule its values are drawn by. `make_state`
draws them all on one device from one seed, in one normal draw, and hands out
views of it. The same dict feeds the plain reference (`gpubench.reference`,
which reads upstream names) and the program (whose own loader converts a
released checkpoint in this layout).

Rules (`kind`): "normal" is N(0, 1) times `scale`, plus `shift`; "positive"
is exp(0.2 N(0, 1)), a batch norm's running variance; "zero" is 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from gpubench.seeds import derive_seed

# The layers that make the RGB image (ToRGB, the encoder's skip, the fusion
# skips) draw their weights at this gain, so that the image before the clamp
# has a spread near 0.5 and is seldom clamped: an image mostly at +-1 would
# hide most gaps from the output check.
RGB_GAIN = 0.25


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    kind: str = "normal"
    scale: float = 1.0
    shift: float = 0.0

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def channels(cfg: dict) -> dict:
    """Upstream Generator.channels, capped at channel_max."""
    cm, cmax = cfg["channel_multiplier"], cfg["channel_max"]
    base = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
            256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}
    return {r: min(c, cmax) for r, c in base.items()}


def log2i(n: int) -> int:
    return int(round(math.log2(n)))


def encoder_res(cfg: dict) -> list:
    return [2 ** i for i in range(log2i(cfg["in_size"]), 4, -1)]


def _plain_conv(name, cout, cin, k, bias=True, gain=1.0):
    out = [Leaf(f"{name}.weight", (cout, cin, k, k), scale=gain / math.sqrt(cin * k * k))]
    if bias:
        out.append(Leaf(f"{name}.bias", (cout,), scale=0.1))
    return out


def _linear(name, dout, din, bias_shift=0.0):
    return [Leaf(f"{name}.weight", (dout, din), scale=1.0 / math.sqrt(din)),
            Leaf(f"{name}.bias", (dout,), scale=0.1, shift=bias_shift)]


def _equal_linear(name, dout, din, lr_mul=1.0, bias_shift=0.0):
    # raw equalized-LR storage: the 1/sqrt(din) * lr_mul scale is applied at
    # run time, so the stored weight is N(0, 1) / lr_mul (upstream's init)
    return [Leaf(f"{name}.weight", (dout, din), scale=1.0 / lr_mul),
            Leaf(f"{name}.bias", (dout,), scale=0.1 / lr_mul, shift=bias_shift / lr_mul)]


def _modconv(name, cout, cin, k, style_dim, gain=1.0):
    return [Leaf(f"{name}.weight", (1, cout, cin, k, k), scale=gain),
            *_equal_linear(f"{name}.modulation", cin, style_dim, bias_shift=1.0)]


def _styled_conv(name, cin, cout, style_dim):
    return [*_modconv(f"{name}.conv", cout, cin, 3, style_dim),
            Leaf(f"{name}.noise.weight", (1,), kind="zero"),
            Leaf(f"{name}.activate.bias", (cout,), scale=0.5)]


def _to_rgb(name, cin, style_dim):
    return [*_modconv(f"{name}.conv", 3, cin, 1, style_dim, gain=RGB_GAIN),
            Leaf(f"{name}.bias", (1, 3, 1, 1), scale=0.1)]


def _adain(name, fin, style_dim):
    # gamma half of the bias around 1, beta half around 0
    return [Leaf(f"{name}.style.weight", (2 * fin, style_dim), scale=1.0 / math.sqrt(style_dim)),
            Leaf(f"{name}.style.bias.gamma", (fin,), scale=0.1, shift=1.0),
            Leaf(f"{name}.style.bias.beta", (fin,), scale=0.1)]


def _ada_res_block(name, fin, style_dim=512):
    return [Leaf(f"{name}.conv.0.weight", (fin, fin, 3, 3)),
            Leaf(f"{name}.conv.1.bias", (fin,), scale=0.1),
            Leaf(f"{name}.conv2.0.weight", (fin, fin, 3, 3)),
            Leaf(f"{name}.conv2.1.bias", (fin,), scale=0.1),
            *_adain(f"{name}.norm", fin, style_dim),
            *_adain(f"{name}.norm2", fin, style_dim)]


def _generator(prefix, cfg):
    ch, sd = channels(cfg), cfg["style_channels"]
    log_size = log2i(cfg["out_size"])
    out = []
    for i in range(cfg["num_mlps"]):
        out += _equal_linear(f"{prefix}.style.{i + 1}", sd, sd, lr_mul=0.01)
    out.append(Leaf(f"{prefix}.input.input", (1, ch[4], 4, 4)))
    out += _styled_conv(f"{prefix}.conv1", ch[4], ch[4], sd)
    out += _to_rgb(f"{prefix}.to_rgb1", ch[4], sd)
    cin = ch[4]
    for i in range(3, log_size + 1):
        cout = ch[2 ** i]
        j = i - 3
        out += _styled_conv(f"{prefix}.convs.{2 * j}", cin, cout, sd)
        out += _styled_conv(f"{prefix}.convs.{2 * j + 1}", cout, cout, sd)
        out += _to_rgb(f"{prefix}.to_rgbs.{j}", cout, sd)
        cin = cout
    for i in range((log_size - 2) * 2 + 1):
        s = 2 ** ((i + 5) // 2)
        out.append(Leaf(f"{prefix}.noises.noise_{i}", (1, 1, s, s)))
    return out


def _dualstylegan(prefix, cfg):
    ch, sd = channels(cfg), cfg["style_channels"]
    log_size = log2i(cfg["out_size"])
    res_index = 6  # upstream DualStyleGAN's default, floored to even
    out = []
    for i in range(cfg["num_mlps"] - 6):  # T_c: PixelNorm + 2 EqualLinear(lr 0.01)
        out += _equal_linear(f"{prefix}.style.{i + 1}", sd, sd, lr_mul=0.01)
    out += _generator(f"{prefix}.generator", cfg)
    out += _ada_res_block(f"{prefix}.res.0", ch[4])
    j = 1
    for i in range(3, log_size + 1):
        for _ in range(2):
            out += (_ada_res_block(f"{prefix}.res.{j}", ch[2 ** i]) if i < 3 + res_index // 2
                    else _equal_linear(f"{prefix}.res.{j}", sd, sd))
            j += 1
    out += _equal_linear(f"{prefix}.res.{j}", sd, sd)
    return out


def vtoonify_layout(cfg: dict) -> list:
    """Every tensor of upstream VToonify(...).state_dict() for `cfg` (the
    config file's "vtoonify" group), as Leafs."""
    ch = channels(cfg)
    is_d = cfg["backbone"] == "dualstylegan"
    out = _dualstylegan("generator", cfg) if is_d else _generator("generator", cfg)
    img, n_in = cfg["img_channels"], cfg["img_channels"] + cfg["parsing_channels"]
    out += _plain_conv("encoder.0.0", 32, n_in, 3)
    out += _plain_conv("encoder.0.2", ch[cfg["in_size"]], 32, 3)
    n_down = 0
    for res in encoder_res(cfg):
        if res > 32:
            n_down += 1
            out += _plain_conv(f"encoder.{n_down}.0", ch[res // 2], ch[res], 3)
            out += _plain_conv(f"encoder.{n_down}.2", ch[res // 2], ch[res // 2], 3)
        else:
            for j in range(cfg["num_res_layers"]):
                out += _plain_conv(f"encoder.{n_down + 1}.{j}.conv", ch[res], ch[res], 3)
                out += _plain_conv(f"encoder.{n_down + 1}.{j}.conv2", ch[res], ch[res], 3)
            out += _plain_conv(f"encoder.{n_down + 2}", img, ch[res], 1, gain=RGB_GAIN)
    for k, res in enumerate(encoder_res(cfg)[::-1]):
        c = ch[res]
        if is_d:
            out += _plain_conv(f"fusion_out.{k}.conv", c, 2 * c, 3)
            out += _adain(f"fusion_out.{k}.norm", 2 * c, 128)
            out += _plain_conv(f"fusion_out.{k}.conv2", 1, 2 * c, 3)
            out += _linear(f"fusion_out.{k}.linear.0", 64, 1)
            out += _linear(f"fusion_out.{k}.linear.2", 128, 64)
        else:
            out += _plain_conv(f"fusion_out.{k}", c, 2 * c, 3)
        out += _plain_conv(f"fusion_skip.{k}", img, img + c, 3, gain=RGB_GAIN)
    if is_d:
        out += _ada_res_block("res.0", ch[4])
        for i in range(3, 6):
            out += _ada_res_block(f"res.{2 * i - 5}", ch[2 ** i])
            out += _ada_res_block(f"res.{2 * i - 4}", ch[2 ** i])
    return out


def _bn(name, c):
    return [Leaf(f"{name}.weight", (c,), scale=0.1, shift=1.0),
            Leaf(f"{name}.bias", (c,), scale=0.1),
            Leaf(f"{name}.running_mean", (c,), scale=0.1),
            Leaf(f"{name}.running_var", (c,), kind="positive")]


def _cbr(name, cin, cout, k):
    return [*_plain_conv(f"{name}.conv", cout, cin, k, bias=False), *_bn(f"{name}.bn", cout)]


RESNET18 = (("layer1", 64, 64, 1), ("layer2", 64, 128, 2), ("layer3", 128, 256, 2),
            ("layer4", 256, 512, 2))


def bisenet_layout(cfg: dict) -> list:
    """Every tensor of upstream BiSeNet(n_classes).state_dict() but the
    batch norms' num_batches_tracked counters."""
    n = cfg["n_classes"]
    rn = "cp.resnet"
    out = [*_plain_conv(f"{rn}.conv1", 64, 3, 7, bias=False), *_bn(f"{rn}.bn1", 64)]
    for layer, cin, cout, stride in RESNET18:
        for b in range(2):
            pre, ci = f"{rn}.{layer}.{b}", (cin if b == 0 else cout)
            out += _plain_conv(f"{pre}.conv1", cout, ci, 3, bias=False)
            out += _bn(f"{pre}.bn1", cout)
            out += _plain_conv(f"{pre}.conv2", cout, cout, 3, bias=False)
            out += _bn(f"{pre}.bn2", cout)
            if b == 0 and (cin != cout or stride != 1):
                out += _plain_conv(f"{pre}.downsample.0", cout, cin, 1, bias=False)
                out += _bn(f"{pre}.downsample.1", cout)
    for arm, cin in (("arm16", 256), ("arm32", 512)):
        out += _cbr(f"cp.{arm}.conv", cin, 128, 3)
        out += _plain_conv(f"cp.{arm}.conv_atten", 128, 128, 1, bias=False)
        out += _bn(f"cp.{arm}.bn_atten", 128)
    out += _cbr("cp.conv_head32", 128, 128, 3)
    out += _cbr("cp.conv_head16", 128, 128, 3)
    out += _cbr("cp.conv_avg", 512, 128, 1)
    out += _cbr("ffm.convblk", 256, 256, 1)
    out += _plain_conv("ffm.conv1", 64, 256, 1, bias=False)
    out += _plain_conv("ffm.conv2", 256, 64, 1, bias=False)
    for head, cin, mid in (("conv_out", 256, 256), ("conv_out16", 128, 64),
                           ("conv_out32", 128, 64)):
        out += _cbr(f"{head}.conv", cin, mid, 3)
        out += _plain_conv(f"{head}.conv_out", n, mid, 1, bias=False)
    return out


def make_state(layout: list, seed: int, device, stream: int = 0) -> dict:
    """{upstream name: float32 tensor on `device`}: one N(0, 1) draw for all
    leaves from `torch.Generator(device)`, each leaf a view of it, scaled in
    place. The AdaIN biases, drawn as gamma and beta halves, are joined into
    upstream's one `.style.bias`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, stream))
    flat = torch.randn(sum(leaf.numel for leaf in layout), generator=gen, device=device)
    state, at = {}, 0
    for leaf in layout:
        t = flat[at:at + leaf.numel].view(leaf.shape)
        at += leaf.numel
        if leaf.kind == "zero":
            t.zero_()
        elif leaf.kind == "positive":
            t.mul_(0.2).exp_()
        else:
            t.mul_(leaf.scale).add_(leaf.shift)
        state[leaf.name] = t
    for name in [n for n in state if n.endswith(".style.bias.gamma")]:
        base = name[: -len(".gamma")]
        state[base] = torch.cat([state.pop(name), state.pop(base + ".beta")])
    return state
