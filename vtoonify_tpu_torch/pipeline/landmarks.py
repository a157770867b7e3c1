"""Host-side 68-point face landmark detection (dlib-compatible); a copy of
vtoonify_tpu/pipeline/landmarks.py.

The reference drives cropping/alignment with dlib (style_transfer.py:70-77,
align_all_parallel.py:32-56). dlib never runs on the accelerator there and it
stays host-side here. Because dlib may be absent in hermetic environments,
this module exposes a provider interface:

  * DlibLandmarker  — uses dlib if importable (same detector + predictor)
  * StaticLandmarker — precomputed landmarks (np.ndarray / .npy path),
    the hermetic path for tests/benchmarks and for callers that run their own
    detector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class LandmarkError(RuntimeError):
    pass


class StaticLandmarker:
    """Serve precomputed (68, 2) landmark arrays (one, or one per call)."""

    def __init__(self, landmarks):
        if isinstance(landmarks, str):
            landmarks = np.load(landmarks)
        self._lm = np.asarray(landmarks)
        self._i = 0

    def __call__(self, image) -> Optional[np.ndarray]:
        if self._lm.ndim == 2:
            return self._lm
        lm = self._lm[min(self._i, len(self._lm) - 1)]
        self._i += 1
        return lm


PREDICTOR_URL = ("http://dlib.net/files/"
                 "shape_predictor_68_face_landmarks.dat.bz2")


def ensure_predictor(predictor_path: str) -> str:
    """Fetch-on-first-use parity with the reference (style_transfer.py:70-77
    wgets + bunzip2s the dlib 68-landmark model when missing). Zero-egress
    environments get a clear instruction instead of a stack trace. Set
    VTOONIFY_NO_DOWNLOAD=1 to forbid the fetch."""
    import bz2
    import os

    if os.path.exists(predictor_path):
        return predictor_path
    if os.environ.get("VTOONIFY_NO_DOWNLOAD") == "1":
        raise LandmarkError(
            f"dlib predictor not found at {predictor_path} and downloads "
            "are disabled (VTOONIFY_NO_DOWNLOAD=1)")
    try:
        import urllib.request

        os.makedirs(os.path.dirname(predictor_path) or ".", exist_ok=True)
        with urllib.request.urlopen(PREDICTOR_URL, timeout=30) as r:
            data = bz2.decompress(r.read())
        tmp = predictor_path + ".part"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, predictor_path)
        return predictor_path
    except Exception as e:
        raise LandmarkError(
            f"dlib predictor not found at {predictor_path} and the "
            f"auto-download from {PREDICTOR_URL} failed ({e}). Fetch it "
            f"manually:\n  wget {PREDICTOR_URL}\n  bzip2 -d "
            "shape_predictor_68_face_landmarks.dat.bz2\nor pass precomputed "
            "landmarks (--landmarks <file.npy>, shape (68, 2))."
        ) from e


class DlibLandmarker:
    """dlib frontal detector + 68-landmark shape predictor (reference
    align_all_parallel.py:32-56); the model file is fetched on first use
    like the reference (style_transfer.py:70-77)."""

    def __init__(self, predictor_path: str):
        import dlib  # optional dependency

        self._detector = dlib.get_frontal_face_detector()
        self._predictor = dlib.shape_predictor(
            ensure_predictor(predictor_path))

    def __call__(self, image) -> Optional[np.ndarray]:
        dets = self._detector(image, 1)
        if len(dets) == 0:
            return None
        shape = None
        for d in dets:
            shape = self._predictor(image, d)
        return np.array([[pt.x, pt.y] for pt in shape.parts()])


def make_landmarker(predictor_path: Optional[str] = None, landmarks=None):
    if landmarks is not None:
        return StaticLandmarker(landmarks)
    if predictor_path is None:
        raise LandmarkError(
            "need either a dlib predictor path or precomputed landmarks"
        )
    return DlibLandmarker(predictor_path)
