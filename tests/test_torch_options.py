"""The port's pipeline options (size bucketing, bucket_margin, packed output
and the packed video writer), its native host library and BiSeNet's
auxiliary heads vs the JAX package's (CPU, float32).

The tiny VToonify-D and BiSeNet pair of tests/test_torch_models.py (JAX
init, carried into the port by `load_jax_params`); numpy-seeded frames.
Tolerances: the port's bucketed and packed outputs within 1 uint8 LSB max /
0.05 LSB mean of JAX's on the same frames (float32 rounding may move a
value across one quantization step; 1 LSB is also JAX's own packed-vs-
unpacked bound, tests/test_packed_out.py); the port's packed output, once
unpacked, bit-equal to its unpacked output; the native C++ functions
bit-equal to their numpy versions; BiSeNet's heads within 1e-4 (relative to
the largest logit) of JAX's.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import _nchw, _vtoonify_pair, bisenet_pair  # noqa: F401
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401
from vtoonify_tpu.models import bisenet as JB
from vtoonify_tpu.pipeline import toonify as JT
from vtoonify_tpu_torch import native
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.pipeline import toonify as T
from vtoonify_tpu_torch.pipeline import video

MAX_LSB, MEAN_LSB = 1, 0.05


def _pipes(bisenet_pair, **options):
    jcfg, jp, cfg, p = _vtoonify_pair("dualstylegan")
    jbp, bp = bisenet_pair
    return (JT.ToonifyPipeline(jp, jcfg, jbp, dtype=jnp.float32, **options),
            T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, device="cpu", **options),
            cfg)


def _within_lsb(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    assert d.max() <= MAX_LSB and d.mean() <= MEAN_LSB, (d.max(), d.mean())


@pytest.mark.parametrize("bucket,margin", [(32, 0), (32, 8)])
def test_bucketed_matches_jax(bisenet_pair, bucket, margin):
    """24x40 frames pad to 32x64 (with an 8 px margin: 40x56 -> 64x64); the
    port and JAX on the same bucketed input, cropped back to the exact
    output."""
    jpipe, pipe, cfg = _pipes(bisenet_pair, size_bucket=bucket, bucket_margin=margin)
    rng = np.random.RandomState(21)
    frames = rng.randint(0, 256, (2, 24, 40, 3)).astype(np.uint8)
    s_w = (rng.randn(1, cfg.n_latent, 512) * 0.3).astype(np.float32)
    want = np.asarray(jpipe.process_batch(frames, jnp.asarray(s_w), 0.5))
    got = pipe.process_batch(frames, s_w, 0.5).numpy()
    assert got.shape == want.shape == (2, 96, 160, 3) and got.dtype == np.uint8
    assert got.std() > 10
    _within_lsb(got, want)


def test_packed_output(bisenet_pair):
    """packed_output: unpack_frame of the port's packed frames is bit-equal
    to its unpacked frames (also bucketed, where the crop is in packed
    rows, and with precomputed parsing maps), and the packed bytes are
    within 1 LSB of JAX's packed pipeline."""
    jpacked, packed, cfg = _pipes(bisenet_pair, packed_output=True)
    _, plain, _ = _pipes(bisenet_pair)
    rng = np.random.RandomState(22)
    frames = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    s_w = (rng.randn(1, cfg.n_latent, 512) * 0.3).astype(np.float32)
    got = packed.process_batch(frames, s_w, 0.5).numpy()
    want = plain.process_batch(frames, s_w, 0.5).numpy()
    assert got.shape == (2, 64, 64, 12) and want.shape == (2, 128, 128, 3)
    for k in range(2):
        np.testing.assert_array_equal(T.ToonifyPipeline.unpack_frame(got[k]), want[k])
        np.testing.assert_array_equal(T.ToonifyPipeline.unpack_frame(got[k], bgr=True),
                                      want[k][..., ::-1])
    np.testing.assert_array_equal(packed.process_image(frames[0], s_w, 0.5),
                                  plain.process_image(frames[0], s_w, 0.5))
    _within_lsb(got, jpacked.process_batch(frames, jnp.asarray(s_w), 0.5))

    x_p = rng.randn(2, 32, 32, 19).astype(np.float32)
    got_p = packed.process_batch_with_parsing(frames, x_p, s_w, 0.5).numpy()
    want_p = plain.process_batch_with_parsing(frames, x_p, s_w, 0.5).numpy()
    np.testing.assert_array_equal(T.ToonifyPipeline.unpack_frame(got_p[1]), want_p[1])

    # bucketed: 24x28 pads to 32x32; the output crops back in packed rows
    _, bucketed_packed, _ = _pipes(bisenet_pair, packed_output=True, size_bucket=32)
    _, bucketed, _ = _pipes(bisenet_pair, size_bucket=32)
    small = frames[:1, :24, :28]
    got_b = bucketed_packed.process_batch(small, s_w, 0.5).numpy()
    assert got_b.shape == (1, 48, 56, 12)
    np.testing.assert_array_equal(T.ToonifyPipeline.unpack_frame(got_b[0]),
                                  bucketed.process_batch(small, s_w, 0.5).numpy()[0])


def test_packed_video_writer(bisenet_pair, tmp_path):
    """toonify_video through a packed pipeline writes the same mp4 bytes as
    through an unpacked one (the writer finishes the packed frames with
    native.depth_to_space2_u8), and toonify_frames hands the packed frames
    to its writer."""
    _, packed, cfg = _pipes(bisenet_pair, packed_output=True)
    _, plain, _ = _pipes(bisenet_pair)
    rng = np.random.RandomState(23)
    clip = rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (32, 32))
    for f in clip:
        w.write(f)
    w.release()
    s_w = (rng.randn(1, cfg.n_latent, 512) * 0.3).astype(np.float32)
    outs = {}
    for name, pipe in (("packed", packed), ("plain", plain)):
        res = video.toonify_video(pipe, src, str(tmp_path / f"{name}.mp4"),
                                  scale_image=False, s_w=s_w, batch_size=2)
        assert res.frames_written == 3
        outs[name] = (tmp_path / f"{name}.mp4").read_bytes()
    assert outs["packed"] == outs["plain"]

    kept = {}
    for name, pipe in (("packed", packed), ("plain", plain)):
        kept[name] = video.MemoryWriter()
        video.toonify_frames(pipe, ((10.0, f) for f in clip),
                             lambda fps, size, k=kept[name]: k,
                             scale_image=False, s_w=s_w, batch_size=2)
    assert kept["packed"].frames[0].shape == (64, 64, 12)
    for a, b in zip(kept["packed"].frames, kept["plain"].frames):
        np.testing.assert_array_equal(T.ToonifyPipeline.unpack_frame(a), b)


def test_native_matches_numpy(monkeypatch):
    """Each C++ function bit-equal to its numpy version; backend() names
    the one that runs."""
    monkeypatch.delenv("VTOONIFY_NO_NATIVE", raising=False)
    assert native.backend() == "native"
    rng = np.random.RandomState(24)
    packed = rng.randint(0, 256, (5, 7, 12)).astype(np.uint8)
    packed16 = rng.randint(0, 256, (3, 4, 16)).astype(np.uint8)
    frame = rng.randint(0, 256, (6, 9, 3)).astype(np.uint8)

    def run():
        return [native.depth_to_space2_u8(packed), native.depth_to_space2_u8(packed, True),
                native.depth_to_space2_u8(packed16), native.rgb_to_bgr(frame),
                native.rgb_to_bgr(frame[:, ::2])]

    got = run()
    monkeypatch.setenv("VTOONIFY_NO_NATIVE", "1")
    assert native.backend() == "numpy"
    want = run()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(want[0][1::2, ::2], packed[:, :, 6:9])  # phase (1, 0)
    np.testing.assert_array_equal(want[3], frame[..., ::-1])


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A g++ failure raises; nothing falls back to numpy on the quiet."""
    monkeypatch.delenv("VTOONIFY_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.rgb_to_bgr(np.zeros((2, 2, 3), np.uint8))
    assert native._lib is None and not list(tmp_path.iterdir())


def test_bisenet_heads_match_jax(bisenet_pair):
    jp, p = bisenet_pair
    x = np.random.RandomState(25).uniform(-2, 2, (2, 64, 48, 3)).astype(np.float32)
    want = jax.jit(JB.bisenet_apply, static_argnums=2)(jp, jnp.asarray(x), 3)
    got = B.bisenet_apply(p, _nchw(x), heads=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (2, 19, 64, 48)
        np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    np.testing.assert_array_equal(got[0].numpy(), B.bisenet_apply(p, _nchw(x)).numpy())
