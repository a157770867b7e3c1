"""Image conversion helpers ([-1,1] float <-> uint8, reference util.py:18-46;
a copy of vtoonify_tpu/utils/image.py). cv2 is imported only by the file
helpers."""

from __future__ import annotations

import numpy as np


def to_unit(frame_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC/NHWC -> float32 in [-1, 1]."""
    return frame_u8.astype(np.float32) / 127.5 - 1.0


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8, TRUNCATING like the reference's save path
    (util.py:24-26 casts (x+1)*127.5 straight to uint8); the frame graph
    rounds instead (pipeline/toonify.py)."""
    return ((np.clip(img, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)


def save_image(img, filename):
    """[-1,1] float HWC RGB -> file (reference util.py:24-26)."""
    import cv2

    cv2.imwrite(filename, cv2.cvtColor(to_uint8(np.asarray(img)), cv2.COLOR_RGB2BGR))


def load_image(filename) -> np.ndarray:
    """file -> (1, H, W, 3) float32 in [-1,1] (reference util.py:28-36)."""
    import cv2

    img = cv2.cvtColor(cv2.imread(filename), cv2.COLOR_BGR2RGB)
    return to_unit(img)[None]
