"""The benchmark's yardstick for work: the card's peaks, the roofline bound,
and the operations of the frame graph counted from a configuration and a
frame size, never read from the program.

Counted: every convolution, transposed convolution and FIR blur of the
frame graph, as upstream computes them (2 FLOPs a multiply-add). Not counted:
elementwise work, norms, resizes and the linear layers on the style codes
(under 0.01% of a frame). A styled 3x3 up conv is upstream's: a stride-2
transposed 3x3 conv (9 taps an input pixel), then the 4x4 blur on its
output; however the program computes it.
"""

from __future__ import annotations

from dataclasses import dataclass

from gpubench.weights import channels, encoder_res, log2i

# NVIDIA H100 SXM data sheet: dense bfloat16 tensor-core rate, HBM3 rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: max(bytes / HBM rate, FLOPs /
    peak for the dtype)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def conv_flops(cin, cout, k, h_out, w_out, groups=1):
    return 2 * cout * h_out * w_out * (cin // groups) * k * k


def _out(n, k, stride, pad):
    return (n + 2 * pad - k) // stride + 1


@dataclass(frozen=True)
class StyledConv:
    """One logical styled 3x3 conv of the synthesis walk, for one frame."""
    cin: int
    cout: int
    h_in: int
    w_in: int
    up: bool

    @property
    def h_out(self):
        return 2 * self.h_in if self.up else self.h_in

    @property
    def w_out(self):
        return 2 * self.w_in if self.up else self.w_in

    @property
    def flops(self):
        conv = conv_flops(self.cin, self.cout, 3, self.h_in, self.w_in)
        blur = conv_flops(1, 1, 4, self.h_out, self.w_out) * self.cout if self.up else 0
        return conv + blur

    def bytes(self, batch: int, dtype: str) -> int:
        """Activations in and out for `batch` frames, and the weight once."""
        e = DTYPE_BYTES[dtype]
        act = batch * (self.cin * self.h_in * self.w_in + self.cout * self.h_out * self.w_out)
        return e * (act + self.cout * self.cin * 9)


def styled_convs(cfg: dict, h: int, w: int) -> list:
    """The synthesis walk's styled 3x3 convs for an (h, w) frame, in launch
    order: per stage from the 32 px features, the x2 up conv and the conv."""
    ch = channels(cfg)
    n_down = sum(1 for r in encoder_res(cfg) if r > 32)
    sh, sw = h >> n_down, w >> n_down  # the encoder's 32 px stage
    out = []
    for pair in range(3, log2i(cfg["out_size"]) - 2):
        cin, cout = ch[2 ** (pair + 2)], ch[2 ** (pair + 3)]
        out.append(StyledConv(cin, cout, sh, sw, True))
        sh, sw = 2 * sh, 2 * sw
        out.append(StyledConv(cout, cout, sh, sw, False))
    return out


def b1_bound_s(cfg: dict, h: int, w: int, batch: int, dtype: str) -> float:
    """Sum over one batch's logical styled 3x3 convs of each conv's bound."""
    return sum(bound_s(c.bytes(batch, dtype), batch * c.flops, dtype)
               for c in styled_convs(cfg, h, w))


def bisenet_flops(h: int, w: int, n_classes: int = 19) -> dict:
    """BiSeNet on an (h, w) input (the frame's 2x): ResNet-18, the context
    path and the main head; the auxiliary heads are discarded, not counted."""
    f = {}
    h2, w2 = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    f["resnet.stem"] = conv_flops(3, 64, 7, h2, w2)
    h2, w2 = _out(h2, 3, 2, 1), _out(w2, 3, 2, 1)
    sizes = {}
    for layer, cin, cout, stride in (("layer1", 64, 64, 1), ("layer2", 64, 128, 2),
                                     ("layer3", 128, 256, 2), ("layer4", 256, 512, 2)):
        ho, wo = _out(h2, 3, stride, 1), _out(w2, 3, stride, 1)
        n = conv_flops(cin, cout, 3, ho, wo) + 3 * conv_flops(cout, cout, 3, ho, wo)
        if cin != cout or stride != 1:
            n += conv_flops(cin, cout, 1, ho, wo)
        f[f"resnet.{layer}"] = n
        h2, w2 = ho, wo
        sizes[layer] = (ho, wo)
    (h8, w8), (h16, w16), (h32, w32) = sizes["layer2"], sizes["layer3"], sizes["layer4"]
    f["context"] = (conv_flops(512, 128, 1, 1, 1)                    # conv_avg
                    + conv_flops(512, 128, 3, h32, w32) + conv_flops(128, 128, 1, 1, 1)
                    + conv_flops(128, 128, 3, h16, w16)              # conv_head32
                    + conv_flops(256, 128, 3, h16, w16) + conv_flops(128, 128, 1, 1, 1)
                    + conv_flops(128, 128, 3, h8, w8))               # conv_head16
    f["ffm"] = (conv_flops(256, 256, 1, h8, w8) + conv_flops(256, 64, 1, 1, 1)
                + conv_flops(64, 256, 1, 1, 1))
    f["head"] = conv_flops(256, 256, 3, h8, w8) + conv_flops(256, n_classes, 1, h8, w8)
    return f


def vtoonify_flops(cfg: dict, h: int, w: int) -> dict:
    """VToonify on one (h, w) frame (plus its parsing channels), by part."""
    ch = channels(cfg)
    is_d = cfg["backbone"] == "dualstylegan"
    f = {}
    n_in = cfg["img_channels"] + cfg["parsing_channels"]
    c0 = ch[cfg["in_size"]]
    f["encoder"] = conv_flops(n_in, 32, 3, h, w) + conv_flops(32, c0, 3, h, w)
    sh, sw = h, w
    for res in encoder_res(cfg):
        if res > 32:
            sh, sw = _out(sh, 3, 2, 1), _out(sw, 3, 2, 1)
            f["encoder"] += (conv_flops(ch[res], ch[res // 2], 3, sh, sw)
                             + conv_flops(ch[res // 2], ch[res // 2], 3, sh, sw))
    c32 = ch[32]
    f["resblocks"] = 2 * cfg["num_res_layers"] * conv_flops(c32, c32, 3, sh, sw)
    if is_d:
        f["modres"] = 2 * cfg["num_res_layers"] * conv_flops(c32, c32, 3, sh, sw)
    f["encoder"] += conv_flops(c32, cfg["img_channels"], 1, sh, sw)
    f["fusion"] = 0
    fh, fw = sh, sw
    for res in encoder_res(cfg)[::-1]:
        c = ch[res]
        f["fusion"] += (conv_flops(2 * c, c, 3, fh, fw)
                        + conv_flops(cfg["img_channels"] + c, cfg["img_channels"], 3, fh, fw))
        if is_d:
            f["fusion"] += conv_flops(2 * c, 1, 3, fh, fw)
        fh, fw = 2 * fh, 2 * fw
    f["styled_convs"] = sum(c.flops for c in styled_convs(cfg, h, w))
    f["to_rgb"] = 0
    for c in styled_convs(cfg, h, w)[1::2]:
        # the 1x1 conv to RGB, and the x2 upsample of the incoming skip (a
        # 4x4 FIR over the zero-stuffed skip, as upstream's upfirdn2d runs it)
        f["to_rgb"] += (conv_flops(c.cout, 3, 1, c.h_out, c.w_out)
                        + 3 * conv_flops(1, 1, 4, c.h_out, c.w_out))
    return f


def frame_flops(config: dict, h: int, w: int) -> int:
    """All counted FLOPs of the frame graph for one (h, w) frame."""
    return (sum(bisenet_flops(2 * h, 2 * w, config["bisenet"]["n_classes"]).values())
            + sum(vtoonify_flops(config["vtoonify"], h, w).values()))
