"""Load a JAX package parameter pytree into the port's modules.

`load_jax_params(module, params)` takes the pytree an `vtoonify_tpu` init or
checkpoint produces (nested dicts and lists whose leaves are arrays; any
array type `np.asarray` accepts, so no JAX import is needed) and fills the
matching port module. It is strict both ways: every port parameter and
buffer is set, and every JAX leaf is used (`load_state_dict(strict=True)`
reports missing or unexpected keys and mismatched shapes).

Layout rules, by leaf:
  * cat2-split conv weights `weight_a` / `weight_b` (GSPMD storage in the
    JAX package) merge into one `weight` along the input-channel axis;
  * 4-D `weight` (conv, HWIO) -> OIHW;
  * any other 4-D leaf (image-like: the generator's constant input, its
    noise images, ToRGB's bias) NHWC -> NCHW;
  * 2-D `weight` (linear, (in, out)) -> (out, in);
  * a string leaf (a marker such as VGG19's "pool") holds no array and is
    skipped;
  * everything else as is.

A transposed-conv weight (the JAX package's (kh, kw, Cout // groups, Cin))
takes the 4-D rule too, and lands in torch's (Cin, Cout // groups, kh, kw).
"""

from __future__ import annotations

import numpy as np
import torch


def _convert(name: str, a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1) if name == "weight" else a.transpose(0, 3, 1, 2)
    if a.ndim == 2 and name == "weight":
        return a.T
    return a


def _flatten(tree, prefix: str, out: dict):
    if isinstance(tree, dict):
        tree = dict(tree)
        if "weight_a" in tree:
            tree["weight"] = np.concatenate(
                [np.asarray(tree.pop("weight_a")), np.asarray(tree.pop("weight_b"))],
                axis=2)
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif isinstance(tree, str):
        return
    else:
        name = prefix.rsplit(".", 1)[-1]
        out[prefix] = torch.from_numpy(
            np.array(_convert(name, np.asarray(tree, np.float32)), order="C"))
        return
    for k, v in items:
        _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)


def jax_state_dict(params) -> dict:
    """The port-layout state dict (float32 CPU tensors) of a JAX pytree."""
    out = {}
    _flatten(params, "", out)
    return out


def load_jax_params(module_or_tree, params):
    """Fill `module_or_tree` (an nn.Module of the port) from the JAX pytree
    `params`, strictly. Returns the module."""
    module_or_tree.load_state_dict(jax_state_dict(params), strict=True)
    return module_or_tree
