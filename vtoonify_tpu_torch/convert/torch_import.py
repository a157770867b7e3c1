"""Reference PyTorch state dicts -> the JAX package's parameter layout, in
numpy (port of vtoonify_tpu/convert/torch_import.py: `flatten_torch_state`,
`convert_generator`, `convert_dualstylegan`, `convert_vtoonify`,
`convert_bisenet`, `convert_psp_encoder`, `load_psp_standalone`,
`convert_raft`; and the JAX models' `convert_vgg19` and `convert_psp`).

The port's modules carry the JAX package's parameter names, so a reference
checkpoint reaches them in two steps: these converters map the reference's
keys to the JAX-layout tree of float32 numpy arrays, and
`convert.from_jax.load_jax_params` loads that tree strictly. The JAX
package's cat2-split conv storage (for GSPMD) is not made: each conv keeps
one `weight`, which `load_jax_params` takes as is.

Layout rules (as the JAX package's):
  linear  (out, in)        -> (in, out)
  conv    (O, I, kh, kw)   -> (kh, kw, I, O)
  modconv (1, O, I, kh, kw)-> (kh, kw, I, O)
  NCHW buffers             -> NHWC
"""

from __future__ import annotations

import numpy as np


def flatten_torch_state(obj) -> dict:
    """torch Module / state_dict / nested ckpt dict -> {key: np.ndarray}."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _j(a):
    # float32, and a view where it is one: the leaf is copied once, where
    # the tree becomes a state dict (convert/from_jax.py::jax_state_dict)
    return np.asarray(a, dtype=np.float32)


def _linear(sd, p):
    out = {"weight": _j(sd[f"{p}.weight"].T)}
    if f"{p}.bias" in sd:
        out["bias"] = _j(sd[f"{p}.bias"])
    return out


def _conv(sd, p):
    out = {"weight": _j(np.transpose(sd[f"{p}.weight"], (2, 3, 1, 0)))}
    if f"{p}.bias" in sd:
        out["bias"] = _j(sd[f"{p}.bias"])
    return out


def convert_conv_layer(sd, prefix):
    """A ConvLayer without downsampling, an nn.Sequential of the conv and
    its FusedLeakyReLU (reference model.py:593-637)."""
    out = {"conv": _conv(sd, f"{prefix}.0")}
    if f"{prefix}.1.bias" in sd:
        out["act_bias"] = _j(sd[f"{prefix}.1.bias"])
    return out


def convert_modulated_conv2d(sd, prefix):
    w = sd[f"{prefix}.weight"][0]  # (O, I, kh, kw)
    return {"weight": _j(np.transpose(w, (2, 3, 1, 0))),
            "modulation": _linear(sd, f"{prefix}.modulation")}


def convert_styled_conv(sd, prefix):
    return {"conv": convert_modulated_conv2d(sd, f"{prefix}.conv"),
            "noise": {"weight": _j(sd[f"{prefix}.noise.weight"].reshape(()))},
            "act_bias": _j(sd[f"{prefix}.activate.bias"])}


def convert_to_rgb(sd, prefix):
    return {"conv": convert_modulated_conv2d(sd, f"{prefix}.conv"),
            "bias": _j(np.transpose(sd[f"{prefix}.bias"], (0, 2, 3, 1)))}


def convert_generator(sd, cfg, prefix=""):
    """StyleGAN2 Generator state_dict -> params (cfg: GeneratorConfig)."""
    p = prefix + "." if prefix else ""
    n_res = cfg.log_size - 2
    return {
        # style.0 is the parameterless PixelNorm
        "style": [_linear(sd, f"{p}style.{i + 1}") for i in range(cfg.n_mlp)],
        "input": _j(np.transpose(sd[f"{p}input.input"], (0, 2, 3, 1))),
        "conv1": convert_styled_conv(sd, f"{p}conv1"),
        "to_rgb1": convert_to_rgb(sd, f"{p}to_rgb1"),
        "convs": [convert_styled_conv(sd, f"{p}convs.{i}") for i in range(2 * n_res)],
        "to_rgbs": [convert_to_rgb(sd, f"{p}to_rgbs.{i}") for i in range(n_res)],
        "noises": [_j(np.transpose(sd[f"{p}noises.noise_{i}"], (0, 2, 3, 1)))
                   for i in range(cfg.num_layers)],
    }


def convert_batch_norm(sd, prefix):
    return {k: _j(sd[f"{prefix}.{k}"])
            for k in ("weight", "bias", "running_mean", "running_var")}


def convert_adain(sd, prefix):
    return {"style": _linear(sd, f"{prefix}.style")}


def convert_ada_res_block(sd, prefix):
    """reference dualstylegan.py AdaResBlock: conv/conv2/norm/norm2."""
    return {"conv1": convert_conv_layer(sd, f"{prefix}.conv"),
            "conv2": convert_conv_layer(sd, f"{prefix}.conv2"),
            "norm1": convert_adain(sd, f"{prefix}.norm"),
            "norm2": convert_adain(sd, f"{prefix}.norm2")}


def convert_dualstylegan(sd, cfg, prefix=""):
    """DualStyleGAN state_dict -> params (cfg: DualStyleGANConfig)."""
    p = prefix + "." if prefix else ""
    ri = cfg.res_index_eff
    res = [convert_ada_res_block(sd, f"{p}res.0")]
    j = 1
    for i in range(3, cfg.log_size + 1):
        for _ in range(2):
            res.append(convert_ada_res_block(sd, f"{p}res.{j}") if i < 3 + ri // 2
                       else _linear(sd, f"{p}res.{j}"))
            j += 1
    res.append(_linear(sd, f"{p}res.{j}"))
    return {
        "style": [_linear(sd, f"{p}style.{i + 1}") for i in range(cfg.n_mlp - 6)],
        "generator": convert_generator(sd, cfg.generator, prefix=f"{p}generator"),
        "res": res,
    }


def convert_fusion(sd, prefix):
    return {"conv": _conv(sd, f"{prefix}.conv"),
            "norm": convert_adain(sd, f"{prefix}.norm"),
            "conv2": _conv(sd, f"{prefix}.conv2"),
            "linear": [_linear(sd, f"{prefix}.linear.0"),
                       _linear(sd, f"{prefix}.linear.2")]}


def convert_vtoonify(sd, cfg, prefix=""):
    """VToonify state_dict -> params (cfg: VToonifyConfig). Handles both the
    full model dict and partial ones (missing submodules are skipped)."""
    p = prefix + "." if prefix else ""
    is_d = cfg.backbone == "dualstylegan"
    out = {}
    if any(k.startswith(f"{p}generator.") for k in sd):
        out["generator"] = (
            convert_dualstylegan(sd, cfg.dualstylegan, prefix=f"{p}generator")
            if is_d else convert_generator(sd, cfg.generator, prefix=f"{p}generator"))
    if any(k.startswith(f"{p}encoder.") for k in sd):
        n_down = sum(1 for r in cfg.encoder_res if r > 32)
        out["encoder"] = {
            "stem": [_conv(sd, f"{p}encoder.0.0"), _conv(sd, f"{p}encoder.0.2")],
            "down": [[_conv(sd, f"{p}encoder.{i + 1}.0"),
                      _conv(sd, f"{p}encoder.{i + 1}.2")] for i in range(n_down)],
            "resblocks": [{"conv1": _conv(sd, f"{p}encoder.{n_down + 1}.{j}.conv"),
                           "conv2": _conv(sd, f"{p}encoder.{n_down + 1}.{j}.conv2")}
                          for j in range(cfg.num_res_layers)],
            "final": _conv(sd, f"{p}encoder.{n_down + 2}"),
        }
    if any(k.startswith(f"{p}fusion_out.") for k in sd):
        n_fuse = len(cfg.encoder_res)
        out["fusion_out"] = [
            convert_fusion(sd, f"{p}fusion_out.{i}") if is_d
            else _conv(sd, f"{p}fusion_out.{i}") for i in range(n_fuse)]
        out["fusion_skip"] = [_conv(sd, f"{p}fusion_skip.{i}") for i in range(n_fuse)]
    if is_d and any(k.startswith(f"{p}res.") for k in sd):
        out["res"] = [convert_ada_res_block(sd, f"{p}res.{j}") for j in range(7)]
    return out


# --- pSp encoder (reference model/encoder/encoders/psp_encoders.py) ----------


def convert_psp_encoder(sd, cfg, prefix=""):
    """GradualStyleEncoder state_dict -> params (cfg: PSPEncoderConfig).

    Accepts either a bare encoder state_dict or the full pSp checkpoint's
    `state_dict` with `encoder.` prefixes (pass prefix="encoder")."""
    p = prefix + "." if prefix else ""

    def bottleneck(i):
        b = f"{p}body.{i}"
        out = {
            "bn0": convert_batch_norm(sd, f"{b}.res_layer.0"),
            "conv1": _conv(sd, f"{b}.res_layer.1"),
            "prelu": {"weight": _j(sd[f"{b}.res_layer.2.weight"])},
            "conv2": _conv(sd, f"{b}.res_layer.3"),
            "bn2": convert_batch_norm(sd, f"{b}.res_layer.4"),
            "se": {"fc1": _conv(sd, f"{b}.res_layer.5.fc1"),
                   "fc2": _conv(sd, f"{b}.res_layer.5.fc2")},
        }
        if f"{b}.shortcut_layer.0.weight" in sd:
            out["shortcut_conv"] = _conv(sd, f"{b}.shortcut_layer.0")
            out["shortcut_bn"] = convert_batch_norm(sd, f"{b}.shortcut_layer.1")
        return out

    def style_block(j):
        s = f"{p}styles.{j}"
        convs = []
        i = 0
        while f"{s}.convs.{i}.weight" in sd:
            convs.append(_conv(sd, f"{s}.convs.{i}"))
            i += 2  # LeakyReLU in between
        return {"convs": convs, "linear": _linear(sd, f"{s}.linear")}

    n_body = 0
    while f"{p}body.{n_body}.res_layer.1.weight" in sd:
        n_body += 1
    return {
        "input_conv": _conv(sd, f"{p}input_layer.0"),
        "input_bn": convert_batch_norm(sd, f"{p}input_layer.1"),
        "input_prelu": {"weight": _j(sd[f"{p}input_layer.2.weight"])},
        "body": [bottleneck(i) for i in range(n_body)],
        "styles": [style_block(j) for j in range(cfg.n_styles)],
        "latlayer1": _conv(sd, f"{p}latlayer1"),
        "latlayer2": _conv(sd, f"{p}latlayer2"),
    }


def load_psp_standalone(ckpt: dict, cfg):
    """Reference util.py:143-161: strip `encoder.` keys, keep latent_avg.

    ckpt: a pSp checkpoint flattened to numpy (`state_dict` -> flat dict,
    `latent_avg`). Returns (params, latent_avg or None)."""
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sub = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    latent_avg = _j(ckpt["latent_avg"]) if "latent_avg" in ckpt else None
    return convert_psp_encoder(sub, cfg), latent_avg


def convert_psp(sd, cfg):
    """Full pSp checkpoint (`encoder.*`, `decoder.*`, `latent_avg`) ->
    params (cfg: models.psp.PSPConfig); JAX models/psp.py::convert_psp."""
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    return {"encoder": convert_psp_encoder(enc, cfg.encoder),
            "decoder": convert_generator(dec, cfg.decoder),
            "latent_avg": (_j(sd["latent_avg"]) if "latent_avg" in sd
                           else np.zeros((cfg.n_styles, 512), np.float32))}


# --- VGG19 (torchvision `features.*`; JAX models/vgg.py::convert_vgg19) -----


def convert_vgg19(sd):
    """torchvision vgg19 `features.*` -> params: five slices of convs, the
    pools marked "pool"."""
    per_slice = [(0,), (2, None, 5), (7, None, 10), (12, 14, 16, None, 19),
                 (21, 23, 25, None, 28)]
    return [["pool" if i is None else _conv(sd, f"features.{i}") for i in sl]
            for sl in per_slice]


# --- BiSeNet (reference model/bisenet/model.py) -------------------------------


def convert_bisenet(sd, prefix=""):
    p = prefix + "." if prefix else ""

    def cbr(pre):
        return {"conv": _conv(sd, f"{pre}.conv"),
                "bn": convert_batch_norm(sd, f"{pre}.bn")}

    def basic(pre):
        out = {"conv1": _conv(sd, f"{pre}.conv1"),
               "bn1": convert_batch_norm(sd, f"{pre}.bn1"),
               "conv2": _conv(sd, f"{pre}.conv2"),
               "bn2": convert_batch_norm(sd, f"{pre}.bn2")}
        if f"{pre}.downsample.0.weight" in sd:
            out["down_conv"] = _conv(sd, f"{pre}.downsample.0")
            out["down_bn"] = convert_batch_norm(sd, f"{pre}.downsample.1")
        return out

    def arm(pre):
        return {"conv": cbr(f"{pre}.conv"),
                "conv_atten": _conv(sd, f"{pre}.conv_atten"),
                "bn_atten": convert_batch_norm(sd, f"{pre}.bn_atten")}

    def head(pre):
        return {"conv": cbr(f"{pre}.conv"), "conv_out": _conv(sd, f"{pre}.conv_out")}

    rn = f"{p}cp.resnet"
    resnet = {"conv1": _conv(sd, f"{rn}.conv1"),
              "bn1": convert_batch_norm(sd, f"{rn}.bn1")}
    for layer in ("layer1", "layer2", "layer3", "layer4"):
        resnet[layer] = [basic(f"{rn}.{layer}.0"), basic(f"{rn}.{layer}.1")]
    return {
        "resnet": resnet,
        "arm16": arm(f"{p}cp.arm16"),
        "arm32": arm(f"{p}cp.arm32"),
        "conv_head32": cbr(f"{p}cp.conv_head32"),
        "conv_head16": cbr(f"{p}cp.conv_head16"),
        "conv_avg": cbr(f"{p}cp.conv_avg"),
        "ffm": {"convblk": cbr(f"{p}ffm.convblk"),
                "conv1": _conv(sd, f"{p}ffm.conv1"),
                "conv2": _conv(sd, f"{p}ffm.conv2")},
        "conv_out": head(f"{p}conv_out"),
        "conv_out16": head(f"{p}conv_out16"),
        "conv_out32": head(f"{p}conv_out32"),
    }


# --- RAFT (reference model/raft/core) -----------------------------------------


def convert_raft(sd, prefix=""):
    """RAFT (basic) state dict -> params. Strips the 'module.' DataParallel
    prefix of the released raft-things.pth."""
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    p = prefix + "." if prefix else ""

    def res_block(pre, batch_norm):
        out = {"conv1": _conv(sd, f"{pre}.conv1"), "conv2": _conv(sd, f"{pre}.conv2")}
        if f"{pre}.downsample.0.weight" in sd:
            out["down"] = _conv(sd, f"{pre}.downsample.0")
        if batch_norm:
            norms = {"norm1": convert_batch_norm(sd, f"{pre}.norm1"),
                     "norm2": convert_batch_norm(sd, f"{pre}.norm2")}
            if f"{pre}.norm3.weight" in sd:
                norms["norm3"] = convert_batch_norm(sd, f"{pre}.norm3")
            out["norms"] = norms
        return out

    def encoder(pre, batch_norm):
        out = {"conv1": _conv(sd, f"{pre}.conv1"), "conv2": _conv(sd, f"{pre}.conv2"),
               "layers": [[res_block(f"{pre}.layer{li + 1}.0", batch_norm),
                           res_block(f"{pre}.layer{li + 1}.1", batch_norm)]
                          for li in range(3)]}
        if batch_norm:
            out["bn1"] = convert_batch_norm(sd, f"{pre}.norm1")
        return out

    ub = f"{p}update_block"
    return {
        "fnet": encoder(f"{p}fnet", batch_norm=False),
        "cnet": encoder(f"{p}cnet", batch_norm=True),
        "update": {
            "enc": {k: _conv(sd, f"{ub}.encoder.{k}")
                    for k in ("convc1", "convc2", "convf1", "convf2", "conv")},
            "gru": {k: _conv(sd, f"{ub}.gru.{k}")
                    for k in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")},
            "flow_head": {"conv1": _conv(sd, f"{ub}.flow_head.conv1"),
                          "conv2": _conv(sd, f"{ub}.flow_head.conv2")},
            "mask": {"conv1": _conv(sd, f"{ub}.mask.0"),
                     "conv2": _conv(sd, f"{ub}.mask.2")},
        },
    }
