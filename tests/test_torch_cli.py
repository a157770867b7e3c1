"""The port's style-transfer CLI and Model API end to end on the CPU, from
the reference-format checkpoints of tests/test_torch_checkpoint.py (its
`zoo` fixture: tiny random-weight VToonify-D/T, BiSeNet, pSp and an
exemplar bank), against the port's pipeline on the same files and JAX's
float32 pipeline on the same crop and style.
"""

import shutil

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import N_LATENT, _pipelines, zoo  # noqa: F401
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu_torch.cli import style_transfer as cli
from vtoonify_tpu_torch.pipeline import crop as C
from vtoonify_tpu_torch.pipeline import model_api as M
from vtoonify_tpu_torch.pipeline import toonify as T
from vtoonify_tpu_torch.pipeline.landmarks import StaticLandmarker
from vtoonify_tpu_torch.utils import checkpoint as CK

PADDING = (16, 16, 16, 16)


def _portrait(rng):
    """A 320x320 RGB image and landmarks with a 128 px eye distance (crop
    scale 0.5: one pre-blur and a resize), for the original frame and for
    its 32x32 crop at PADDING (a StaticLandmarker serves them in turn)."""
    img = rng.randint(0, 256, (320, 320, 3)).astype(np.uint8)
    lm = np.zeros((68, 2), np.float32)
    lm[0:17] = np.stack([np.linspace(60, 260, 17),
                         200 + 60 * np.sin(np.linspace(0, np.pi, 17))], axis=1)
    lm[36:42] = [96, 128] + rng.rand(6, 2) * 4
    lm[42:48] = [224, 128] + rng.rand(6, 2) * 4
    lm[27:36] = [160, 180]
    lm[48:68] = [160, 240] + rng.rand(20, 2) * 10
    h, w, top, bottom, left, right, scale = C.crop_parameter_from_landmarks(
        lm, img.shape[:2], PADDING)
    assert (bottom - top, right - left) == (32, 32) and scale < 0.75
    lm_crop = lm * scale - np.array([left, top], np.float32)
    return img, np.stack([lm, lm_crop])


def test_cli_image_end_to_end(zoo, tmp_path):
    """--cpu --fp32 --scale_image --landmarks on the D model: the written
    stylized JPEG is byte-for-byte cv2.imwrite of the port pipeline's
    output on the same crop and style, and that output is within 1 uint8
    LSB of JAX's float32 process_image (float32 rounding may move a value
    across one quantization step, as in tests/test_torch_models.py)."""
    img, lms = _portrait(np.random.RandomState(13))
    content = tmp_path / "face.png"
    cv2.imwrite(str(content), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.save(tmp_path / "lm.npy", lms)
    out_dir = tmp_path / "out"
    argv = ["--content", str(content), "--ckpt", zoo["dualstylegan"],
            "--faceparsing_path", zoo["faceparsing"],
            "--style_encoder_path", zoo["psp"], "--exstyle_path", zoo["bank"],
            "--landmarks", str(tmp_path / "lm.npy"), "--scale_image",
            "--padding", *map(str, PADDING), "--style_id", "2",
            "--output_path", str(out_dir), "--cpu", "--fp32"]
    prec = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    try:
        cli.main(argv)
    finally:
        torch.backends.cudnn.allow_tf32 = prec[0]
        torch.set_float32_matmul_precision(prec[1])

    # the same crop and style through the port pipeline
    pipe, jpipe = _pipelines(zoo, "dualstylegan", style_id=2)
    lmk = StaticLandmarker(lms)
    params = C.get_video_crop_parameter(img, lmk, PADDING)
    frame = C.preprocess_frame(img, params, True)
    s_w = pipe.compute_style(C.align_face(frame, lmk))
    out = pipe.process_image(frame, s_w, 0.5)
    assert out.shape == (128, 128, 3) and out.std() > 10
    for name, want in (("face_input.jpg", frame), ("face_vtoonify_d.jpg", out)):
        cv2.imwrite(str(tmp_path / name), cv2.cvtColor(want, cv2.COLOR_RGB2BGR))
        assert (out_dir / name).read_bytes() == (tmp_path / name).read_bytes(), name

    ref = np.asarray(jpipe.process_image(frame, s_w.numpy(), 0.5))
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and diff.mean() <= 0.05, (diff.max(), diff.mean())


@pytest.mark.parametrize("extra,message", [
    # (the id kept from when --sp and --dp were both refused as not ported)
    pytest.param(["--sp", "2"], "north star", id="extra0-not ported yet"),
    (["--style_id", "5"], r"--style_id 5 out of range.*styles 0\.\.2"),
    (["--dp", "2"], "--dp 2 but only 0 devices are visible"),
])
def test_cli_refusals(zoo, tmp_path, extra, message):
    content = tmp_path / "face.png"
    cv2.imwrite(str(content), np.zeros((64, 64, 3), np.uint8))
    argv = ["--content", str(content), "--ckpt", zoo["dualstylegan"],
            "--faceparsing_path", zoo["faceparsing"],
            "--style_encoder_path", zoo["psp"], "--exstyle_path", zoo["bank"],
            "--output_path", str(tmp_path), "--cpu", *extra]
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)


def test_model_image_toonify(zoo, tmp_path):
    """Model on a checkpoint root laid out as STYLE_TYPES expects: detect,
    align and toonify equal the pipeline built from the same files."""
    rel, style_id = M.STYLE_TYPES["cartoon1"]
    (tmp_path / rel).parent.mkdir(parents=True)
    shutil.copy(zoo["dualstylegan"], tmp_path / rel)
    rng = np.random.RandomState(14)
    bank = {f"s{i:03d}.jpg": (rng.randn(1, N_LATENT, 512) * 0.3).astype(np.float32)
            for i in range(style_id + 1)}
    np.save(str((tmp_path / rel).parent / "exstyle_code.npy"), bank, allow_pickle=True)
    shutil.copy(zoo["faceparsing"], tmp_path / "faceparsing.pth")
    shutil.copy(zoo["psp"], tmp_path / "encoder.pt")
    img, lms = _portrait(np.random.RandomState(13))

    model = M.Model(checkpoint_root=str(tmp_path), landmarks=lms, device="cpu",
                    dtype=torch.float32)
    frame, aligned, msg = model.detect_and_align_frame(img, PADDING)
    assert msg == "Success" and frame.shape == (32, 32, 3)
    assert aligned.shape == (256, 256, 3)
    got = model.image_toonify(frame, aligned, 0.5, "cartoon1")
    assert model.load_model("cartoon1") is model.load_model("cartoon1")

    vt, cfg = CK.load_reference_vtoonify(str(tmp_path / rel))
    psp, latent_avg, pcfg = CK.load_reference_psp(zoo["psp"])
    pipe = T.ToonifyPipeline(vt, cfg, CK.load_reference_faceparsing(zoo["faceparsing"]),
                             psp_params=psp, psp_cfg=pcfg, latent_avg=latent_avg,
                             exstyle=bank[f"s{style_id:03d}.jpg"],
                             dtype=torch.float32, device="cpu")
    want = pipe.process_image(frame, pipe.compute_style(aligned), 0.5)
    np.testing.assert_array_equal(got, want)
    assert M.dynamic_batch_size(256, 256) == 16
    assert M.dynamic_batch_size(256, 256, on_accelerator=False) == 4


def _console_scripts():
    import tomllib
    from pathlib import Path

    text = (Path(__file__).resolve().parent.parent / "pyproject.toml").read_text()
    return tomllib.loads(text)["project"]["scripts"]


_JAX_SCRIPTS = sorted(k for k in _console_scripts() if not k.startswith("vtoonify-torch-"))


@pytest.mark.parametrize("name", _JAX_SCRIPTS)
def test_console_script_twins_resolve_and_print_help(name, capsys):
    """Each JAX console script has a `vtoonify-torch-*` twin naming the
    port's module of the same path; its `main` is callable and `--help`
    exits 0."""
    import importlib

    scripts = _console_scripts()
    twin = name.replace("vtoonify-", "vtoonify-torch-", 1)
    module, func = scripts[twin].split(":")
    assert module == scripts[name].split(":")[0].replace("vtoonify_tpu.", "vtoonify_tpu_torch.", 1)
    main = getattr(importlib.import_module(module), func)
    assert callable(main)
    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code in (0, None)
    assert "usage" in capsys.readouterr().out.lower()
