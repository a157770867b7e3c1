"""Crop parameterization + FFHQ alignment (host CPU, exact reference math;
a copy of vtoonify_tpu/pipeline/crop.py).

  * get_video_crop_parameter — reference util.py:163-188: rescale so the eye
    distance is 64 px, crop box = eye center ± padding floored to /8.
  * align_face — reference model/encoder/align_all_parallel.py:59-150 (FFHQ
    canonical alignment): shrink → crop → reflect-pad+blur → QUAD transform
    to 256×256. PIL semantics are load-bearing (the pSp style code is computed
    from this image).

PIL, scipy and cv2 are imported only inside the functions that use them, so
importing this module needs none of them (a serving host may lack cv2 or
Pillow).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

EYE_DISTANCE_PX = 64.0  # canonical eye distance after rescale
CROP_MULTIPLE = 8  # crop bounds floored to multiples of 8


def crop_parameter_from_landmarks(
    lm: np.ndarray,
    image_hw: Tuple[int, int],
    padding: Sequence[int] = (200, 200, 200, 200),
):
    """reference util.py:163-188 (landmarks already detected).

    Returns (h, w, top, bottom, left, right, scale)."""
    lm_eye_left = lm[36:42]
    lm_eye_right = lm[42:48]
    scale = EYE_DISTANCE_PX / (
        np.mean(lm_eye_right[:, 0]) - np.mean(lm_eye_left[:, 0])
    )
    center = (
        (np.mean(lm_eye_right, axis=0) + np.mean(lm_eye_left, axis=0)) / 2
    ) * scale
    h, w = round(image_hw[0] * scale), round(image_hw[1] * scale)
    m = CROP_MULTIPLE
    left = max(round(center[0] - padding[0]), 0) // m * m
    right = min(round(center[0] + padding[1]), w) // m * m
    top = max(round(center[1] - padding[2]), 0) // m * m
    bottom = min(round(center[1] + padding[3]), h) // m * m
    return h, w, top, bottom, left, right, scale


def get_video_crop_parameter(image, landmarker, padding=(200, 200, 200, 200)):
    lm = landmarker(image)
    if lm is None:
        return None
    return crop_parameter_from_landmarks(lm, image.shape[:2], padding)


def align_face_from_landmarks(image: np.ndarray, lm: np.ndarray,
                              output_size: int = 256) -> np.ndarray:
    """FFHQ alignment; returns an (output_size, output_size, 3) uint8 array."""
    import PIL.Image
    import scipy.ndimage

    lanczos = PIL.Image.Resampling.LANCZOS
    lm_eye_left = lm[36:42]
    lm_eye_right = lm[42:48]
    lm_mouth_outer = lm[48:60]

    eye_left = np.mean(lm_eye_left, axis=0)
    eye_right = np.mean(lm_eye_right, axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm_mouth_outer[0] + lm_mouth_outer[6]) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2

    img = PIL.Image.fromarray(image)
    transform_size = output_size

    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (
            int(np.rint(float(img.size[0]) / shrink)),
            int(np.rint(float(img.size[1]) / shrink)),
        )
        img = img.resize(rsize, lanczos)
        quad /= shrink
        qsize /= shrink

    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (
        int(np.floor(min(quad[:, 0]))),
        int(np.floor(min(quad[:, 1]))),
        int(np.ceil(max(quad[:, 0]))),
        int(np.ceil(max(quad[:, 1]))),
    )
    crop = (
        max(crop[0] - border, 0),
        max(crop[1] - border, 0),
        min(crop[2] + border, img.size[0]),
        min(crop[3] + border, img.size[1]),
    )
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad -= crop[0:2]

    pad = (
        int(np.floor(min(quad[:, 0]))),
        int(np.floor(min(quad[:, 1]))),
        int(np.ceil(max(quad[:, 0]))),
        int(np.ceil(max(quad[:, 1]))),
    )
    pad = (
        max(-pad[0] + border, 0),
        max(-pad[1] + border, 0),
        max(pad[2] - img.size[0] + border, 0),
        max(pad[3] - img.size[1] + border, 0),
    )
    if max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(
            np.float32(img), ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)),
            "reflect",
        )
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / pad[0],
                             np.float32(w - 1 - xx) / pad[2]),
            1.0 - np.minimum(np.float32(yy) / pad[1],
                             np.float32(h - 1 - yy) / pad[3]),
        )
        blur = qsize * 0.02
        arr += (
            scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr
        ) * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = PIL.Image.fromarray(
            np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB"
        )
        quad += pad[:2]

    img = img.transform(
        (transform_size, transform_size), PIL.Image.QUAD,
        (quad + 0.5).flatten(), PIL.Image.Resampling.BILINEAR,
    )
    if output_size < transform_size:
        img = img.resize((output_size, output_size), lanczos)
    return np.asarray(img)


def align_face(image, landmarker, output_size: int = 256) -> Optional[np.ndarray]:
    lm = landmarker(image)
    if lm is None:
        return None
    return align_face_from_landmarks(image, lm, output_size)


# --- frame-level host preprocessing (reference style_transfer.py:97,124-156) --

PREBLUR_KERNEL_1D = np.array(
    [[0.125], [0.375], [0.375], [0.125]], dtype=np.float32
)


def preprocess_frame(frame: np.ndarray, crop_params, scale_image: bool = True):
    """Per-frame host path: optional HR pre-blur (once if scale ≤ 0.75, twice
    if ≤ 0.375) → resize to (w, h) → crop to [top:bottom, left:right]. The
    unscaled path returns the frame as is, without cv2."""
    if not scale_image or crop_params is None:
        return frame
    import cv2

    h, w, top, bottom, left, right, scale = crop_params
    if scale <= 0.75:
        frame = cv2.sepFilter2D(frame, -1, PREBLUR_KERNEL_1D, PREBLUR_KERNEL_1D)
    if scale <= 0.375:
        frame = cv2.sepFilter2D(frame, -1, PREBLUR_KERNEL_1D, PREBLUR_KERNEL_1D)
    return cv2.resize(frame, (w, h))[top:bottom, left:right]
