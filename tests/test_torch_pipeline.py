"""The port's host pipeline (CPU): mean_latent, process_batch_with_parsing,
crop and alignment against the JAX package; the video engine against
process_batch; the cv2 round trip; and the host modules importing where
cv2 and Pillow are missing.

JAX params come from the JAX init at the tiny configuration of
tests/test_torch_models.py (T backbone, channel_max 128) and reach the port
through `load_jax_params`. The engine tests need no JAX: a tiny VToonify-D
from the port's own seeded init, with random styled-conv and ToRGB biases
so the uint8 frames have contrast.
"""

import functools
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.models import generator as JG
from vtoonify_tpu.models import vtoonify as JV
from vtoonify_tpu.pipeline import crop as JC
from vtoonify_tpu.pipeline import toonify as JT
from vtoonify_tpu_torch.convert.from_jax import load_jax_params
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.pipeline import crop as C
from vtoonify_tpu_torch.pipeline import toonify as T
from vtoonify_tpu_torch.pipeline import video
from vtoonify_tpu_torch.pipeline.landmarks import StaticLandmarker
from vtoonify_tpu_torch.utils.profiling import StageTimer

TINY = dict(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)


@functools.lru_cache(maxsize=None)
def _t_pair():
    jcfg = JV.VToonifyConfig(backbone="toonify", channel_max=128, **TINY)
    jp = jax.tree_util.tree_map(np.asarray, JV.init_vtoonify(jax.random.PRNGKey(3), jcfg))
    rng = np.random.RandomState(9)
    for blk in jp["generator"]["convs"]:
        blk["act_bias"] = (rng.randn(*blk["act_bias"].shape) * 0.5).astype(np.float32)
    for blk in jp["generator"]["to_rgbs"]:
        blk["bias"] = (rng.randn(*blk["bias"].shape) * 0.5).astype(np.float32)
    cfg = V.VToonifyConfig(backbone="toonify", channel_max=128, **TINY)
    return jcfg, jp, cfg, load_jax_params(V.init_vtoonify(cfg), jp)


def test_mean_latent_matches_jax():
    """The mean w over the same z: JAX style_mlp's mean against the port's
    mean_latent, whose z come from the given torch.Generator (float32
    mapping MLP on both sides: float32 rounding only)."""
    jcfg, jp, cfg, p = _t_pair()
    z = torch.randn((64, 512), generator=torch.Generator().manual_seed(5))
    ref = np.asarray(JG.style_mlp(jp["generator"], jcfg.generator, jnp.asarray(z.numpy()))
                     ).mean(0, keepdims=True)
    got = G.mean_latent(p.generator, cfg.generator, torch.Generator().manual_seed(5), 64)
    assert got.shape == (1, 512)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_process_batch_with_parsing_matches_jax():
    """float32, precomputed parsing maps: within 1 uint8 LSB (float32
    rounding may move a value across one quantization step), mean 0.05."""
    jcfg, jp, cfg, p = _t_pair()
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (2, 32, 40, 3)).astype(np.uint8)
    x_p = rng.randn(2, 32, 40, 19).astype(np.float32) * 4
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    jpipe = JT.ToonifyPipeline(jp, jcfg, {}, dtype=jnp.float32)
    ref = np.asarray(jpipe.process_batch_with_parsing(frames, x_p, s_w, 0.5))
    pipe = T.ToonifyPipeline(p, cfg, B.init_bisenet(), dtype=torch.float32, device="cpu")
    got = pipe.process_batch_with_parsing(frames, x_p, s_w, 0.5).numpy()
    assert got.shape == (2, 128, 160, 3) and got.dtype == np.uint8 and got.std() > 10
    diff = np.abs(got.astype(np.int32) - ref)
    assert diff.max() <= 1 and diff.mean() <= 0.05, (diff.max(), diff.mean())


def _landmarks(rng, eye_dist):
    lm = np.zeros((68, 2))
    lm[0:17] = np.stack([np.linspace(80, 220, 17),
                         160 + 60 * np.sin(np.linspace(0, np.pi, 17))], axis=1)
    lm[36:42] = [150 - eye_dist / 2, 120] + rng.rand(6, 2) * 8
    lm[42:48] = [150 + eye_dist / 2, 120] + rng.rand(6, 2) * 8
    lm[48:60] = [150, 200] + rng.rand(12, 2) * 20
    return lm


@pytest.mark.parametrize("eye_dist", [40, 100, 190])  # scale 1.6, 0.64, 0.34
def test_crop_and_align_match_jax(eye_dist):
    """The same copy of the reference math: exactly equal, at a crop scale
    above 0.75 (no pre-blur), below it (one) and below 0.375 (two)."""
    rng = np.random.RandomState(43)
    img = rng.randint(0, 256, (300, 280, 3)).astype(np.uint8)
    lm = _landmarks(rng, eye_dist)
    params = C.get_video_crop_parameter(img, StaticLandmarker(lm))
    assert params == JC.get_video_crop_parameter(img, StaticLandmarker(lm))
    frame = C.preprocess_frame(img, params, True)
    np.testing.assert_array_equal(frame, JC.preprocess_frame(img, params, True))
    assert C.preprocess_frame(img, params, False) is img
    aligned = C.align_face(img, StaticLandmarker(lm))
    assert aligned.shape == (256, 256, 3)
    np.testing.assert_array_equal(aligned, JC.align_face(img, StaticLandmarker(lm)))


# ---------------------------------------------------------------------------
# the video engine (port only)


@functools.lru_cache(maxsize=None)
def _pipe():
    g = torch.Generator().manual_seed(21)
    cfg = V.VToonifyConfig(channel_max=256, **TINY)
    vt = V.init_vtoonify(cfg, g)
    with torch.no_grad():
        for blk in vt.generator.generator.convs:
            blk.act_bias.normal_(0.0, 0.5, generator=g)
        for blk in vt.generator.generator.to_rgbs:
            blk.bias.normal_(0.0, 0.5, generator=g)
    pipe = T.ToonifyPipeline(vt, cfg, B.init_bisenet(generator=g), dtype=torch.float32,
                             device="cpu")
    s_w = torch.randn((1, cfg.n_latent, 512), generator=g).numpy() * 0.5
    return pipe, s_w


@pytest.mark.parametrize("batch_size,parsing,frame_limit", [
    (4, False, None),   # 11 frames: batches 4, 4, 3
    (4, True, None),    # precomputed parsing maps
    (3, False, 7),      # frame_limit: batches 3, 3, 1
    (None, False, None),  # auto batch on the CPU: 256 at 32 px, one batch
])
def test_engine_matches_process_batch(batch_size, parsing, frame_limit):
    pipe, s_w = _pipe()
    rng = np.random.RandomState(22)
    frames = rng.randint(0, 256, (11, 32, 32, 3)).astype(np.uint8)
    maps = rng.randn(11, 32, 32, 19).astype(np.float32) * 4 if parsing else None
    writer = video.MemoryWriter()
    timer = StageTimer()
    result = video.toonify_frames(
        pipe, ((25.0, f) for f in frames), lambda fps, size: writer,
        scale_image=False, batch_size=batch_size, max_in_flight=2, s_w=s_w,
        parsing_maps=maps, frame_limit=frame_limit, timer=timer)
    n = frame_limit or len(frames)
    assert result.frames_written == n == len(writer.frames)
    assert result.crop_params is None
    assert {"decode", "dispatch", "fetch", "preprocess"} <= set(result.stages)
    step = batch_size or n
    for i in range(0, n, step):
        chunk = frames[i:min(i + step, n)]
        want = (pipe.process_batch_with_parsing(chunk, maps[i:i + len(chunk)], s_w, 0.5)
                if parsing else pipe.process_batch(chunk, s_w, 0.5)).numpy()
        for k, w in enumerate(want):
            assert writer.frames[i + k].shape == (128, 128, 3)
            np.testing.assert_array_equal(writer.frames[i + k], w)


class _KeepingWriter:
    """Keeps every frame as the engine hands it over (its view into the
    batch's host copy) beside a copy taken when it was written."""

    def __init__(self):
        self.views, self.copies = [], []

    def write(self, frame):
        self.views.append(frame)
        self.copies.append(frame.copy())

    def close(self):
        return len(self.views)


@pytest.mark.parametrize("max_in_flight", [1, 3])
def test_engine_kept_frames_outlive_later_batches(max_in_flight):
    """A writer that keeps the engine's frames: after the run, that is
    after every later batch was fetched and written, each kept view still
    holds what it held when written, and that is its batch's output
    (11 frames in batches of 3: 3, 3, 3 and a short 2)."""
    pipe, s_w = _pipe()
    frames = np.random.RandomState(31).randint(0, 256, (11, 32, 32, 3)).astype(np.uint8)
    writer = _KeepingWriter()
    result = video.toonify_frames(
        pipe, ((25.0, f) for f in frames), lambda fps, size: writer,
        scale_image=False, batch_size=3, max_in_flight=max_in_flight, s_w=s_w)
    assert result.frames_written == 11
    for i in range(0, 11, 3):
        want = pipe.process_batch(frames[i:i + 3], s_w, 0.5).numpy()
        for k, w in enumerate(want):
            np.testing.assert_array_equal(writer.views[i + k], writer.copies[i + k])
            np.testing.assert_array_equal(writer.views[i + k], w)


def test_toonify_video_cv2_round_trip(tmp_path):
    """A 6-frame mp4 written with cv2: the stylized mp4 holds 6 frames at 4x
    the size, and the crop video 6 frames at the input size."""
    pipe, s_w = _pipe()
    src = str(tmp_path / "in.mp4")
    wr = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 24))
    rng = np.random.RandomState(42)
    for _ in range(6):
        wr.write(rng.randint(0, 256, (24, 32, 3)).astype(np.uint8))
    wr.release()
    out, crops = str(tmp_path / "out.mp4"), str(tmp_path / "crop.mp4")
    result = video.toonify_video(pipe, src, out, s_w=s_w, scale_image=False,
                                 batch_size=4, crop_out_path=crops,
                                 timer=StageTimer())
    assert result.frames_written == 6 and "encode" in result.stages
    for path, size in ((out, (128, 96)), (crops, (32, 24))):
        cap = cv2.VideoCapture(path)
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
        assert (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))) == size
        cap.release()


def test_host_modules_import_and_engine_run_without_cv2_and_pil():
    """With cv2 and Pillow missing, as on a serving host without them, the
    host modules import and the engine runs over in-memory frames
    (scale_image=False: no resize, no alignment)."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np, torch\n"
        "import vtoonify_tpu_torch.pipeline.model_api\n"
        "import vtoonify_tpu_torch.cli.style_transfer\n"
        "from vtoonify_tpu_torch.pipeline import video\n"
        "from vtoonify_tpu_torch.models import bisenet as B, vtoonify as V\n"
        "from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline\n"
        "cfg = V.VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1,\n"
        "                       channel_max=128, num_res_layers=1, backbone='toonify')\n"
        "pipe = ToonifyPipeline(V.init_vtoonify(cfg), cfg, B.init_bisenet(),\n"
        "                       dtype=torch.float32, device='cpu')\n"
        "w = video.MemoryWriter()\n"
        "frames = ((25.0, np.zeros((32, 32, 3), np.uint8)) for _ in range(3))\n"
        "r = video.toonify_frames(pipe, frames, lambda fps, size: w,\n"
        "                         scale_image=False, batch_size=2,\n"
        "                         s_w=np.zeros((1, cfg.n_latent, 512), np.float32))\n"
        "assert r.frames_written == 3 and w.frames[0].shape == (128, 128, 3)\n"
        "assert not [m for m in sys.modules if m.startswith(('cv2', 'PIL'))\n"
        "            and sys.modules[m] is not None]\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
