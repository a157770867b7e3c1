"""Reference-format checkpoints -> the port's modules (port of
vtoonify_tpu/utils/checkpoint.py: `infer_vtoonify_config`,
`load_reference_vtoonify`, `load_reference_dualstylegan`,
`load_reference_stylegan`, `load_reference_faceparsing`,
`load_reference_psp`, `load_reference_raft`, `load_exstyle_bank`,
`load_directions`,
`save_train_state` / `load_train_state`, and the trainers' g_ema files in
place of its Orbax `save_pytree` / `load_pytree`).

Each loader reads a released PyTorch artifact (vtoonify_*.pt,
generator.pt, encoder.pt, faceparsing.pth, exstyle_code.npy,
directions.npy, raft-things.pth), maps its keys with `convert/torch_import.py` and loads the
result strictly (`convert/from_jax.py::jax_state_dict`: every parameter
and buffer set, every converted leaf used) into a module built on the meta
device, so that it holds the loaded CPU tensors and no random init.
Move it to the card with `.to("cuda")` or through `ToonifyPipeline`.

The trainers' own files are `torch.save` dicts of tensors, numbers and
state dicts, read back with `torch.load(weights_only=True)`: the full train
state (`save_train_state`: trainable modules, EMA, D, both Adams, the
color-jitter carry, the step), so `--resume` continues exactly, and the EMA
weights (`save_g_ema`).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
from torch import nn

from vtoonify_tpu_torch.convert import torch_import as TI
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict
from vtoonify_tpu_torch.models.bisenet import init_bisenet
from vtoonify_tpu_torch.models.dualstylegan import init_dualstylegan
from vtoonify_tpu_torch.models.generator import init_generator
from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig, init_psp_encoder
from vtoonify_tpu_torch.models.raft import RAFTConfig, init_raft
from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig, init_vtoonify
from vtoonify_tpu_torch.parallel.tensor import load_optimizer_state_dict, optimizer_state_dict


def _torch_load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _init_generator():
    # the loaders build on the meta device, where the init draws nothing;
    # its own generator keeps the global RNG untouched all the same
    return torch.Generator().manual_seed(0)


def _built_from(init, tree):
    """The module init(generator) builds, filled strictly from the converted
    `tree` (every parameter and buffer set, every leaf used). It is built on
    the meta device and given the loaded tensors, so that no random init is
    drawn only to be overwritten."""
    with torch.device("meta"):
        module = init(_init_generator())
    module.load_state_dict(jax_state_dict(tree), strict=True, assign=True)
    return module


# channels[res] = _CH_BASE[res] * channel_multiplier for res > 32
# (reference model/stylegan/model.py Generator.channels)
_CH_BASE = {64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}


def infer_vtoonify_config(sd):
    """Derive the VToonifyConfig from a reference state_dict's shapes.

    Signals (reference model/vtoonify.py:128-205):
      * backbone: top-level `res.*` AdaResBlocks exist only for dualstylegan
      * out_size: the synthesis trunk has 2*(log2(out)-2) StyledConvs
      * channel_multiplier: width of the last StyledConv vs the base table
      * in_size: #encoder modules = log2(in) - 2
      * num_res_layers: #VToonifyResBlocks in the penultimate encoder module
    """
    backbone = ("dualstylegan" if any(k.startswith("res.") for k in sd)
                else "toonify")
    pre = ("generator.generator.convs."
           if backbone == "dualstylegan" else "generator.convs.")
    conv_ids = {int(m.group(1)) for k in sd
                for m in [re.match(re.escape(pre) + r"(\d+)\.", k)] if m}
    if not conv_ids:
        raise ValueError("not a VToonify checkpoint: no synthesis convs")
    out_size = 2 ** (len(conv_ids) // 2 + 2)
    last_w = sd[f"{pre}{max(conv_ids)}.conv.weight"]
    cm = (int(last_w.shape[1]) // _CH_BASE[out_size]
          if out_size in _CH_BASE else 2)
    enc_mods = {int(k.split(".")[1]) for k in sd if k.startswith("encoder.")}
    in_size = 2 ** (len(enc_mods) + 2)
    res_stage = max(enc_mods) - 1
    num_res_layers = len(
        {k.split(".")[2] for k in sd if k.startswith(f"encoder.{res_stage}.")})
    if backbone == "dualstylegan" and num_res_layers > 6:
        # the reference's `self.res` ModuleList always has 7 entries
        # (model/vtoonify.py:203-209), so its forward fails past 6 encoder
        # resblocks (`self.res[ii+1]`, :236-239)
        raise ValueError(
            f"checkpoint has {num_res_layers} encoder resblocks; the "
            "dualstylegan backbone supports at most 6 (the ModRes bank has "
            "7 entries, matching the reference)")
    return VToonifyConfig(in_size=in_size, out_size=out_size,
                          channel_multiplier=cm,
                          num_res_layers=num_res_layers, backbone=backbone)


def load_reference_vtoonify(path: str, cfg=None):
    """vtoonify_*.pt ({'g_ema': state_dict}) -> (VToonify, cfg); the config
    is inferred from the checkpoint when not given."""
    ckpt = _torch_load(path)
    sd = TI.flatten_torch_state(ckpt.get("g_ema", ckpt))
    if cfg is None:
        cfg = infer_vtoonify_config(sd)
    return _built_from(lambda g: init_vtoonify(cfg, g), TI.convert_vtoonify(sd, cfg)), cfg


def load_reference_dualstylegan(path: str, cfg):
    """generator.pt ({'g_ema': state_dict}) -> DualStyleGAN."""
    ckpt = _torch_load(path)
    sd = TI.flatten_torch_state(ckpt.get("g_ema", ckpt))
    return _built_from(lambda g: init_dualstylegan(cfg, g), TI.convert_dualstylegan(sd, cfg))


def load_reference_stylegan(path: str, cfg):
    """A StyleGAN2 generator ({'g_ema': state_dict}) -> Generator."""
    ckpt = _torch_load(path)
    sd = TI.flatten_torch_state(ckpt.get("g_ema", ckpt))
    return _built_from(lambda g: init_generator(cfg, g), TI.convert_generator(sd, cfg))


def load_reference_faceparsing(path: str):
    """faceparsing.pth (a bare state_dict) -> BiSeNet."""
    sd = TI.flatten_torch_state(_torch_load(path))
    return _built_from(lambda g: init_bisenet(generator=g), TI.convert_bisenet(sd))


def load_reference_psp(path: str, cfg=None):
    """encoder.pt (pSp ckpt with state_dict + latent_avg) -> (PSPEncoder,
    latent_avg float32 tensor, cfg). n_styles is inferred from the
    checkpoint when cfg is None (released checkpoints carry 18 style heads)."""
    ckpt = _torch_load(path)
    sd = TI.flatten_torch_state(ckpt["state_dict"])
    if cfg is None:
        n_styles = len({k.split(".")[2] for k in sd
                        if k.startswith("encoder.styles.")})
        cfg = PSPEncoderConfig(n_styles=n_styles or 18)
    params, latent_avg = TI.load_psp_standalone(
        {"state_dict": sd, "latent_avg": np.asarray(ckpt["latent_avg"])}, cfg)
    psp = _built_from(lambda g: init_psp_encoder(cfg, g), params)
    return psp, torch.from_numpy(latent_avg), cfg


def load_reference_raft(path: str, cfg=RAFTConfig()):
    """raft-things.pth (a bare state dict, keys with or without the
    'module.' prefix) -> RAFT."""
    sd = TI.flatten_torch_state(_torch_load(path))
    return _built_from(lambda g: init_raft(cfg, g), TI.convert_raft(sd))


def load_exstyle_bank(path: str):
    """exstyle_code.npy -> ({name: (1, n_latent, 512) z+ code}, ordered names)."""
    bank = np.load(path, allow_pickle=True).item()
    return {k: np.asarray(v) for k, v in bank.items()}, list(bank.keys())


def load_directions(path: str):
    return np.asarray(np.load(path))


# ---------------------------------------------------------------------------
# the trainers' own files


# the module each optimizer of a train state steps
_OPTIMIZED = {"g_opt": "trainable", "d_opt": "d"}


def save_train_state(path: str, state) -> None:
    """Persist a PretrainState / TrainDState / TrainTState exactly: module
    state dicts, the optimizers' state by parameter name
    (`parallel.tensor.optimizer_state_dict`), tensors and the step. Weights
    split over a 'tp' row are saved whole, so the file is the same at any
    tp."""
    out = {"kind": type(state).__name__}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.optim.Optimizer):
            v = optimizer_state_dict(v, getattr(state, _OPTIMIZED[f.name]))
        elif isinstance(v, nn.Module):
            v = v.state_dict()
        out[f.name] = v
    torch.save(out, path)


def load_train_state(path: str, template, device=None):
    """Load a saved state into `template` (the same kind of state, from the
    same init, at any tp) in place and return it. Tensors are mapped onto
    `device` (None: the device of the template's trainable parameters) and
    split again where the template's weights are split."""
    if device is None:
        device = next(template.trainable.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    if saved.get("kind") != type(template).__name__:
        raise ValueError(f"{path} holds a {saved.get('kind')}, not a "
                         f"{type(template).__name__}")
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if isinstance(v, torch.optim.Optimizer):
            load_optimizer_state_dict(v, getattr(template, _OPTIMIZED[f.name]),
                                      saved[f.name])
        elif isinstance(v, nn.Module):
            v.load_state_dict(saved[f.name])
        else:
            setattr(template, f.name, saved[f.name])
    return template


def save_g_ema(path: str, modules: dict) -> None:
    """{'g_ema': {name: state_dict}} of the EMA modules (the trainers'
    `pretrain.ckpt` and `vtoonify*.ckpt`)."""
    torch.save({"g_ema": {k: m.state_dict() for k, m in modules.items()}}, path)


def load_g_ema(path: str) -> dict:
    """{name: state_dict} of a `save_g_ema` file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)["g_ema"]
