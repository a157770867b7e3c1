"""PyTorch + CUDA port of vtoonify_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (ops/, nn/layers.py, models/, pipeline/,
train/, convert/). Imports torch, never jax. The hand-written kernels live in
csrc/ and are bound in ops/kernels.py. Entry points (`ToonifyPipeline`,
`train.steps.init_train_d_state`) run on the card unless the caller passes
`device="cpu"`.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """An entry point's device: None means the card (`cuda`). Raises when
    the card is asked for and torch sees none; there is no silent fallback
    to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "false); pass device='cpu' to run on the CPU")
    return device
