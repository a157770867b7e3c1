"""Programmatic Model API — the Gradio/HF-Spaces `Model` class equivalent
(port of vtoonify_tpu/pipeline/model_api.py: `STYLE_TYPES`,
`dynamic_batch_size`, the frame limits, `Model`).

Capability-parity with reference vtoonify_model.py:25-279: a style-type
registry mapping names to (checkpoint, style id), lazy per-style model
loading with caching, detect-and-align helpers, image/video toonify with the
resolution-aware dynamic batch-size heuristic and frame limits. Checkpoints
are local paths; any frontend can wrap this class. Models run on the card
unless `device="cpu"`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vtoonify_tpu_torch import resolve_device
from vtoonify_tpu_torch.pipeline import crop as crop_mod
from vtoonify_tpu_torch.pipeline.landmarks import make_landmarker
from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
from vtoonify_tpu_torch.pipeline.video import toonify_video
from vtoonify_tpu_torch.utils import checkpoint as ckpt_util

# style registry (reference vtoonify_model.py:30-53); paths relative to
# checkpoint root, value = (relative ckpt path, style_id)
STYLE_TYPES = {
    "cartoon1": ("vtoonify_d_cartoon/vtoonify_s026_d0.5.pt", 26),
    "cartoon1-d": ("vtoonify_d_cartoon/vtoonify_s_d.pt", 26),
    "cartoon2-d": ("vtoonify_d_cartoon/vtoonify_s_d.pt", 64),
    "cartoon3-d": ("vtoonify_d_cartoon/vtoonify_s_d.pt", 153),
    "cartoon4": ("vtoonify_d_cartoon/vtoonify_s299_d0.5.pt", 299),
    "cartoon4-d": ("vtoonify_d_cartoon/vtoonify_s_d.pt", 299),
    "cartoon5-d": ("vtoonify_d_cartoon/vtoonify_s_d.pt", 8),
    "comic1-d": ("vtoonify_d_comic/vtoonify_s_d.pt", 28),
    "comic2-d": ("vtoonify_d_comic/vtoonify_s_d.pt", 18),
    "arcane1": ("vtoonify_d_arcane/vtoonify_s000_d0.5.pt", 0),
    "arcane1-d": ("vtoonify_d_arcane/vtoonify_s_d.pt", 0),
    "arcane2": ("vtoonify_d_arcane/vtoonify_s077_d0.5.pt", 77),
    "arcane2-d": ("vtoonify_d_arcane/vtoonify_s_d.pt", 77),
    "caricature1": ("vtoonify_d_caricature/vtoonify_s039_d0.5.pt", 39),
    "caricature2": ("vtoonify_d_caricature/vtoonify_s068_d0.5.pt", 68),
    "pixar": ("vtoonify_d_pixar/vtoonify_s052_d0.5.pt", 52),
    "pixar-d": ("vtoonify_d_pixar/vtoonify_s_d.pt", 52),
    "illustration1-d": ("vtoonify_d_illustration/vtoonify_s054_d_c.pt", 54),
    "illustration2-d": ("vtoonify_d_illustration/vtoonify_s004_d_c.pt", 4),
    "illustration3-d": ("vtoonify_d_illustration/vtoonify_s009_d_c.pt", 9),
    "illustration4-d": ("vtoonify_d_illustration/vtoonify_s043_d_c.pt", 43),
    "illustration5-d": ("vtoonify_d_illustration/vtoonify_s086_d_c.pt", 86),
}

VIDEO_FRAME_LIMIT_CPU = 100   # reference vtoonify_model.py:66-67
VIDEO_FRAME_LIMIT_GPU = 300


def dynamic_batch_size(width: int, height: int, on_accelerator: bool = True):
    """Resolution-aware batch heuristic (reference vtoonify_model.py:246-252).

    On the card: ~16 frames of 400x360-class pixels per dispatch, capped at
    16, the count scaled down for larger crops so that a batch's device
    memory stays bounded. The values are the JAX package's; no batch sweep
    has been run on the H100 yet, so the cap of 16 is not a measured peak
    there (chip_smoke.py times batches 1 and 16 only)."""
    if width == 0 or height == 0:
        return 1
    if not on_accelerator:
        return max(1, int(4 * 256 * 256 / width / height))
    return min(max(1, int(16 * 400 * 360 / width / height)), 16)


@dataclass
class Model:
    """High-level toonification service object.

    Usage:
        m = Model(checkpoint_root="./checkpoint")
        frame, aligned, msg = m.detect_and_align_image("face.jpg")
        out = m.image_toonify(frame, aligned, style_degree=0.5,
                              style_type="cartoon1")
    """

    checkpoint_root: str = "./checkpoint"
    landmark_model_path: Optional[str] = None
    landmarks: Optional[object] = None  # (68,2) array, (N,68,2), or .npy path
    device: Optional[str] = None  # None: the card
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        resolve_device(self.device)  # no card and no device="cpu": raise now
        self._pipelines = {}
        path = self.landmark_model_path or os.path.join(
            self.checkpoint_root, "shape_predictor_68_face_landmarks.dat")
        self._landmarker = make_landmarker(
            predictor_path=path if os.path.exists(path) and
            self.landmarks is None else None,
            landmarks=self.landmarks)
        self._parsing = ckpt_util.load_reference_faceparsing(
            os.path.join(self.checkpoint_root, "faceparsing.pth"))
        self._psp, self._latent_avg, self._psp_cfg = ckpt_util.load_reference_psp(
            os.path.join(self.checkpoint_root, "encoder.pt"))

    # -- model loading --------------------------------------------------------

    def load_model(self, style_type: str) -> ToonifyPipeline:
        """Build (and cache) the pipeline for a registry style."""
        if style_type in self._pipelines:
            return self._pipelines[style_type]
        rel, style_id = STYLE_TYPES[style_type]
        ckpt_path = os.path.join(self.checkpoint_root, rel)
        vt, cfg = ckpt_util.load_reference_vtoonify(ckpt_path)
        bank, names = ckpt_util.load_exstyle_bank(
            os.path.join(os.path.dirname(ckpt_path), "exstyle_code.npy"))
        pipe = ToonifyPipeline(
            vt, cfg, self._parsing, psp_params=self._psp, psp_cfg=self._psp_cfg,
            latent_avg=self._latent_avg, exstyle=bank[names[style_id]],
            dtype=self.dtype, device=self.device)
        self._pipelines[style_type] = pipe
        return pipe

    # -- preprocessing --------------------------------------------------------

    def detect_and_align_image(self, image_path: str,
                               padding=(200, 200, 200, 200)):
        """-> (cropped frame, aligned 256² face, message) — reference
        vtoonify_model.py:146 detect_and_align_image."""
        import cv2

        if image_path is None:
            return None, None, "Error: fail to load empty file."
        bgr = cv2.imread(image_path)
        if bgr is None:
            return None, None, "Error: fail to load the image."
        frame = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        return self.detect_and_align_frame(frame, padding)

    def detect_and_align_video(self, video_path: str,
                               padding=(200, 200, 200, 200)):
        """Align the video's FIRST frame (for style-code extraction) —
        reference vtoonify_model.py:156 detect_and_align_video."""
        import cv2

        if video_path is None:
            return None, None, "Error: fail to load empty file."
        cap = cv2.VideoCapture(video_path)
        ok, bgr = cap.read()
        cap.release()
        if not ok or bgr is None:
            return None, None, "Error: fail to load the video."
        frame = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        return self.detect_and_align_frame(frame, padding)

    def detect_and_align_frame(self, frame_rgb_u8: np.ndarray,
                               padding=(200, 200, 200, 200)):
        """In-memory variant of detect_and_align_image (RGB uint8 HWC)."""
        params = crop_mod.get_video_crop_parameter(frame_rgb_u8,
                                                   self._landmarker, padding)
        if params is None:
            return None, None, "Error: no face detected"
        frame = crop_mod.preprocess_frame(frame_rgb_u8, params, True)
        aligned = crop_mod.align_face(frame, self._landmarker)
        return frame, aligned, "Success"

    # -- inference ------------------------------------------------------------

    def image_toonify(self, frame_u8, aligned_u8, style_degree=0.5,
                      style_type="cartoon1", color_transfer=False):
        pipe = self.load_model(style_type)
        s_w = pipe.compute_style(aligned_u8, color_transfer)
        return pipe.process_image(frame_u8, s_w, style_degree)

    def video_toonify(self, video_path, output_path, style_degree=0.5,
                      style_type="cartoon1", color_transfer=False,
                      scale_image=True, padding=(200, 200, 200, 200)):
        import cv2

        pipe = self.load_model(style_type)
        on_card = pipe.device.type == "cuda"
        cap = cv2.VideoCapture(video_path)
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.release()
        return toonify_video(
            pipe, video_path, output_path, style_degree=style_degree,
            color_transfer=color_transfer, landmarker=self._landmarker,
            scale_image=scale_image, padding=padding,
            batch_size=dynamic_batch_size(w, h, on_card),
            frame_limit=VIDEO_FRAME_LIMIT_GPU if on_card else VIDEO_FRAME_LIMIT_CPU)
