"""The port's modules -> reference-PyTorch checkpoints (port of
vtoonify_tpu/convert/torch_export.py: `export_generator`,
`export_dualstylegan`, `export_vtoonify`, `save_reference_checkpoint`).

The exact inverse of `convert/torch_import.py`: a module's state is laid out
as the JAX package's parameter tree (`params_tree`, the inverse of
`convert/from_jax.py::load_jax_params`' layout rules), then mapped to the
reference's keys and layouts. The trainers' `--export_pt` writes these
files, which the reference stack (`style_transfer.py --ckpt`, its demo) and
the port's `utils/checkpoint.py::load_reference_vtoonify` read. The port
stores every conv weight whole, so no cat2 merge is needed. torch only.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def params_tree(module: nn.Module):
    """A module's state as a JAX-layout tree of float32 numpy arrays:
    nested dicts, ModuleList entries as lists; 4-D conv `weight` OIHW ->
    HWIO, other 4-D leaves NCHW -> NHWC, 2-D linear `weight` (out, in) ->
    (in, out)."""
    root = {}
    for k, v in module.state_dict().items():
        *path, name = k.split(".")
        a = v.detach().cpu().float().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0) if name == "weight" else a.transpose(0, 2, 3, 1)
        elif a.ndim == 2 and name == "weight":
            a = a.T
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        return ([t[str(i)] for i in range(len(t))]
                if t and all(k.isdigit() for k in t) else t)

    return lists(root)


def _tree(params):
    """A module, or a mapping of names to modules (a partial VToonify such
    as {'encoder': ...}), as a JAX-layout tree; trees pass through."""
    if isinstance(params, nn.Module):
        return params_tree(params)
    if isinstance(params, Mapping):
        return {k: _tree(v) for k, v in params.items()}
    return params


def _n(a):
    return np.asarray(a, dtype=np.float32)


def _fir_kernel(gain: float = 1.0) -> np.ndarray:
    """make_kernel([1,3,3,1]) (model.py:21-28), the Blur / Upsample buffer,
    scaled by factor^2 on upsample paths."""
    k = np.array([1.0, 3.0, 3.0, 1.0])
    k = np.outer(k, k)
    return (k / k.sum() * gain).astype(np.float32)


def _linear(out, prefix, p):
    out[f"{prefix}.weight"] = _n(p["weight"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = _n(p["bias"])


def _conv(out, prefix, p):
    out[f"{prefix}.weight"] = np.transpose(_n(p["weight"]), (3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = _n(p["bias"])


def _conv_layer(out, prefix, p):
    _conv(out, f"{prefix}.0", p["conv"])
    if "act_bias" in p:
        out[f"{prefix}.1.bias"] = _n(p["act_bias"])


def _modulated_conv(out, prefix, p):
    w = np.transpose(_n(p["weight"]), (3, 2, 0, 1))  # (O, I, kh, kw)
    out[f"{prefix}.weight"] = w[None]                # reference (1,O,I,kh,kw)
    _linear(out, f"{prefix}.modulation", p["modulation"])


def _styled_conv(out, prefix, p):
    _modulated_conv(out, f"{prefix}.conv", p["conv"])
    out[f"{prefix}.noise.weight"] = _n(p["noise"]["weight"]).reshape(1)
    out[f"{prefix}.activate.bias"] = _n(p["act_bias"])


def _to_rgb(out, prefix, p):
    _modulated_conv(out, f"{prefix}.conv", p["conv"])
    out[f"{prefix}.bias"] = np.transpose(_n(p["bias"]), (0, 3, 1, 2))


def export_generator(params, cfg, prefix=""):
    """A StyleGAN2 Generator (module or tree) -> reference state-dict
    entries {key: np.ndarray}."""
    params = _tree(params)
    p = prefix + "." if prefix else ""
    out = {}
    for i, lin in enumerate(params["style"]):  # style.0 is PixelNorm
        _linear(out, f"{p}style.{i + 1}", lin)
    out[f"{p}input.input"] = np.transpose(_n(params["input"]), (0, 3, 1, 2))
    _styled_conv(out, f"{p}conv1", params["conv1"])
    _to_rgb(out, f"{p}to_rgb1", params["to_rgb1"])
    for i, c in enumerate(params["convs"]):
        _styled_conv(out, f"{p}convs.{i}", c)
        if i % 2 == 0:  # upsampling conv: Blur buffer, x factor^2 gain
            out[f"{p}convs.{i}.conv.blur.kernel"] = _fir_kernel(4.0)
    for i, t in enumerate(params["to_rgbs"]):
        _to_rgb(out, f"{p}to_rgbs.{i}", t)
        out[f"{p}to_rgbs.{i}.upsample.kernel"] = _fir_kernel(4.0)
    for i, nz in enumerate(params["noises"]):
        out[f"{p}noises.noise_{i}"] = np.transpose(_n(nz), (0, 3, 1, 2))
    return out


def _ada_res_block(out, prefix, p):
    _conv_layer(out, f"{prefix}.conv", p["conv1"])
    _conv_layer(out, f"{prefix}.conv2", p["conv2"])
    _linear(out, f"{prefix}.norm.style", p["norm1"]["style"])
    _linear(out, f"{prefix}.norm2.style", p["norm2"]["style"])


def export_dualstylegan(params, cfg, prefix=""):
    """A DualStyleGAN (module or tree) -> reference state-dict entries."""
    params = _tree(params)
    p = prefix + "." if prefix else ""
    out = {}
    for i, lin in enumerate(params["style"]):
        _linear(out, f"{p}style.{i + 1}", lin)
    out.update(export_generator(params["generator"], cfg.generator,
                                prefix=f"{p}generator"))
    ri = cfg.res_index_eff
    res = params["res"]
    _ada_res_block(out, f"{p}res.0", res[0])
    j = 1
    for i in range(3, cfg.log_size + 1):
        for _ in range(2):
            if i < 3 + ri // 2:
                _ada_res_block(out, f"{p}res.{j}", res[j])
            else:
                _linear(out, f"{p}res.{j}", res[j])
            j += 1
    _linear(out, f"{p}res.{j}", res[j])
    return out


def _fusion(out, prefix, p):
    _conv(out, f"{prefix}.conv", p["conv"])
    _linear(out, f"{prefix}.norm.style", p["norm"]["style"])
    _conv(out, f"{prefix}.conv2", p["conv2"])
    _linear(out, f"{prefix}.linear.0", p["linear"][0])
    _linear(out, f"{prefix}.linear.2", p["linear"][1])


def export_vtoonify(params, cfg, prefix="") -> dict:
    """A VToonify (module, mapping of its child modules by name, or tree)
    -> reference state dict {key: np.ndarray}. A partial model exports
    partially (an encoder-only stage-1 checkpoint), the mirror of
    `convert_vtoonify`'s partial handling."""
    params = _tree(params)
    p = prefix + "." if prefix else ""
    is_d = cfg.backbone == "dualstylegan"
    out = {}

    if "generator" in params:
        out.update(export_dualstylegan(params["generator"], cfg.dualstylegan,
                                       prefix=f"{p}generator") if is_d else
                   export_generator(params["generator"], cfg.generator,
                                    prefix=f"{p}generator"))

    if "encoder" in params:
        enc = params["encoder"]
        n_down = sum(1 for r in cfg.encoder_res if r > 32)
        _conv(out, f"{p}encoder.0.0", enc["stem"][0])
        _conv(out, f"{p}encoder.0.2", enc["stem"][1])
        for i, pair in enumerate(enc.get("down", [])):  # no state at in_size 32
            _conv(out, f"{p}encoder.{i + 1}.0", pair[0])
            _conv(out, f"{p}encoder.{i + 1}.2", pair[1])
        for j, rb in enumerate(enc["resblocks"]):
            _conv(out, f"{p}encoder.{n_down + 1}.{j}.conv", rb["conv1"])
            _conv(out, f"{p}encoder.{n_down + 1}.{j}.conv2", rb["conv2"])
        _conv(out, f"{p}encoder.{n_down + 2}", enc["final"])

    if "fusion_out" in params:
        for i, f in enumerate(params["fusion_out"]):
            if is_d:
                _fusion(out, f"{p}fusion_out.{i}", f)
            else:
                _conv(out, f"{p}fusion_out.{i}", f)
        for i, f in enumerate(params["fusion_skip"]):
            _conv(out, f"{p}fusion_skip.{i}", f)

    if is_d and "res" in params:
        for j, rb in enumerate(params["res"]):
            _ada_res_block(out, f"{p}res.{j}", rb)
    return out


def save_reference_checkpoint(path: str, params, cfg, key: str = "g_ema"):
    """torch.save({key: state_dict}, path) in the reference layout. `params`
    is a VToonify, a mapping of its child modules (the trainers pass the
    frozen backbone and the EMA trainables), or {'encoder': ...} alone: the
    last is saved as the bare encoder state dict, as the reference's
    stage-1 checkpoints are (train_vtoonify_d.py:169-175)."""
    sd = export_vtoonify(params, cfg)
    if isinstance(params, Mapping) and set(params) == {"encoder"}:
        sd = {k[len("encoder."):]: v for k, v in sd.items()}
    torch.save({key: {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in sd.items()}}, path)
    return path
