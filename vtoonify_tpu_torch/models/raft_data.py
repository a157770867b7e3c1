"""RAFT input padding (port of vtoonify_tpu/models/raft_data.py:
`InputPadder`, which the flow demo needs). The flow-file readers, the
dataset walkers and the validators belong to the RAFT evaluation tooling
and are not ported yet."""

from __future__ import annotations

import torch.nn.functional as F


class InputPadder:
    """Replicate-pad NCHW images so H and W are multiples of 8
    (raft/core/utils/utils.py InputPadder): 'sintel' mode pads both sides
    evenly, any other mode (KITTI's) pads the bottom only in H. `shape` is
    the images' shape, (..., H, W)."""

    def __init__(self, shape, mode: str = "sintel"):
        h, w = shape[-2], shape[-1]
        ph = (-h) % 8
        pw = (-w) % 8
        if mode == "sintel":
            self._pad = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
        else:
            self._pad = (pw // 2, pw - pw // 2, 0, ph)

    def pad(self, *images):
        out = [F.pad(im, self._pad, mode="replicate") for im in images]
        return out if len(out) > 1 else out[0]

    def unpad(self, x):
        left, right, top, bottom = self._pad
        h, w = x.shape[-2], x.shape[-1]
        return x[..., top:h - bottom, left:w - right]
