"""The port's apps on the CPU: the HTTP server (cli/serve.py), the inference
playground (cli/inference_playground.py) and the release gate
(cli/validate_release.py).

All run over the reference-format random files of the `zoo` fixture of
tests/test_torch_checkpoint.py (tiny VToonify-D and -T, BiSeNet, pSp, the
exemplar bank), linked into the checkpoint layout that `Model` and the gate
read; the gate's D case needs style id 26, so its directory gets a bank of
27 random codes. A 128x128 synthetic portrait with one set of 68 landmarks
(eye distance 112 px: scale 0.57, a 72x72 crop, 288x288 out) stands in for
a photograph.

The server's stylized bodies must be byte-equal to cv2.imencode of the
Model's own output on the same upload. The gate's goldens are made by the
JAX package's style-transfer CLI (through its own gate) on the same files
and inputs: the port's gate must pass them at >= 35 dB, so the two
packages agree through the gate itself; a perturbed golden must fail it.
"""

import http.client
import json
import os
import shutil
import threading

import cv2
import numpy as np
import pytest

from tests.test_torch_checkpoint import N_LATENT, zoo  # noqa: F401
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401
from vtoonify_tpu_torch.cli import inference_playground as playground
from vtoonify_tpu_torch.cli import serve
from vtoonify_tpu_torch.cli import validate_release as vr
from vtoonify_tpu_torch.models import raft_viz
from vtoonify_tpu_torch.pipeline import smooth_parsing
from vtoonify_tpu_torch.pipeline.model_api import Model

STYLE = "arcane1-d"  # vtoonify_d_arcane/vtoonify_s_d.pt, style id 0


def _landmarks():
    lm = np.zeros((68, 2), np.float32)
    lm[0:17] = np.stack([np.linspace(10, 118, 17),
                         70 + 40 * np.sin(np.linspace(0, np.pi, 17))], axis=1)
    lm[36:42] = [8, 56]
    lm[42:48] = [120, 56]
    lm[27:36] = [64, 80]
    lm[48:68] = [64, 104]
    lm[48], lm[54] = [44, 104], [84, 104]
    return lm


def _portrait(seed):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    img = cv2.resize(base, (128, 128), interpolation=cv2.INTER_LINEAR)
    return np.clip(img.astype(np.int16) + rng.randint(-20, 21, img.shape), 0, 255
                   ).astype(np.uint8)


@pytest.fixture(scope="module")
def ckpt_root(zoo, tmp_path_factory):  # noqa: F811
    """The zoo's files under the names Model and the release cases read."""
    root = tmp_path_factory.mktemp("checkpoint")
    links = {"faceparsing.pth": zoo["faceparsing"], "encoder.pt": zoo["psp"],
             "vtoonify_d_arcane/vtoonify_s_d.pt": zoo["dualstylegan"],
             "vtoonify_d_arcane/vtoonify_s000_d0.5.pt": zoo["dualstylegan"],
             "vtoonify_d_arcane/exstyle_code.npy": zoo["bank"],
             "vtoonify_d_cartoon/vtoonify_s_d.pt": zoo["dualstylegan"],
             "vtoonify_t_arcane/vtoonify.pt": zoo["toonify"]}
    for name, target in links.items():
        (root / name).parent.mkdir(exist_ok=True)
        os.symlink(target, root / name)
    rng = np.random.RandomState(31)
    np.save(str(root / "vtoonify_d_cartoon/exstyle_code.npy"),
            {f"style{i}.png": (rng.randn(1, N_LATENT, 512) * 0.3).astype(np.float32)
             for i in range(27)}, allow_pickle=True)
    return root


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_server_endpoints(ckpt_root):
    """/, /styles, /toonify and the error codes: 400 (bad style, empty
    body, bad degree, undecodable body), 404 (unknown path, a registry style
    not installed), 422 (no face), 500 (a style id past the bank)."""
    model = Model(checkpoint_root=str(ckpt_root), landmarks=_landmarks(), device="cpu")
    server = serve.build_server(model, "127.0.0.1", 0, default_style=STYLE)
    serve.serve_forever_in_thread(server)
    port = server.server_address[1]
    try:
        status, page = _request(port, "GET", "/")
        assert status == 200 and f'<option value="{STYLE}" selected>' in page.decode()
        status, styles = _request(port, "GET", "/styles")
        assert status == 200 and STYLE in json.loads(styles) and "cartoon1" in json.loads(styles)
        assert _request(port, "GET", "/nope")[0] == 404

        img = _portrait(32)
        ok, png = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        assert ok
        status, body = _request(port, "POST",
                                f"/toonify?style_type={STYLE}&style_degree=0.7", png.tobytes())
        assert status == 200, body[:200]
        frame, aligned, msg = model.detect_and_align_frame(img)
        assert msg == "Success" and frame.shape == (72, 72, 3)
        want = model.image_toonify(frame, aligned, style_degree=0.7, style_type=STYLE)
        assert want.shape == (288, 288, 3) and want.std() > 10
        ok, enc = cv2.imencode(".jpg", cv2.cvtColor(want, cv2.COLOR_RGB2BGR))
        assert body == enc.tobytes()
        status, body = _request(port, "POST", f"/toonify?style_type={STYLE}&color_transfer=1",
                                png.tobytes())
        assert status == 200 and cv2.imdecode(np.frombuffer(body, np.uint8),
                                              cv2.IMREAD_COLOR).shape == (288, 288, 3)

        for path, payload, code in (
                ("/toonify?style_type=nope", png.tobytes(), 400),
                (f"/toonify?style_type={STYLE}", b"", 400),
                (f"/toonify?style_type={STYLE}&style_degree=abc", png.tobytes(), 400),
                (f"/toonify?style_type={STYLE}", b"not an image", 400),
                ("/elsewhere", png.tobytes(), 404),
                ("/toonify?style_type=cartoon1", png.tobytes(), 404),
                ("/toonify?style_type=arcane2-d", png.tobytes(), 500)):
            status, body = _request(port, "POST", path, payload)
            assert status == code, (path, status, body[:200])

        model._landmarker = lambda image: None  # no face found
        status, body = _request(port, "POST", f"/toonify?style_type={STYLE}", png.tobytes())
        assert status == 422 and b"no face" in body
    finally:
        server.shutdown()
        server.server_close()


def test_server_runs_requests_on_its_worker_pool():
    """Requests run on the server's fixed pool of long-lived threads (so a
    thread's torch caches serve the requests after its first), never on a
    thread of their own: 8 requests use at most the pool's 4 threads."""
    seen = []

    class FakeModel:
        def detect_and_align_frame(self, image):
            seen.append(threading.current_thread())
            return image, image, "Success"

        def image_toonify(self, frame, aligned, **kw):
            return np.repeat(np.repeat(frame, 2, axis=0), 2, axis=1)

    server = serve.build_server(FakeModel(), "127.0.0.1", 0, default_style=STYLE)
    thread = serve.serve_forever_in_thread(server)
    ok, png = cv2.imencode(".png", _portrait(35))
    try:
        for _ in range(8):
            status, body = _request(server.server_address[1], "POST",
                                    f"/toonify?style_type={STYLE}", png.tobytes())
            assert status == 200
            assert cv2.imdecode(np.frombuffer(body, np.uint8),
                                cv2.IMREAD_COLOR).shape == (256, 256, 3)
    finally:
        server.shutdown()
        server.server_close()
    thread.join(timeout=60)
    assert serve.PooledHTTPServer.workers == 4
    assert len(seen) == 8 and 1 <= len(set(seen)) <= 4
    assert all(t.name.startswith("serve") and t is not thread for t in seen)
    assert not any(t.is_alive() for t in seen)  # server_close ends the pool


def test_playground_all_parts(ckpt_root, tmp_path):
    content = tmp_path / "face.png"
    cv2.imwrite(str(content), cv2.cvtColor(_portrait(33), cv2.COLOR_RGB2BGR))
    np.save(tmp_path / "lm.npy", _landmarks())
    out = tmp_path / "out"
    playground.main(["--checkpoint_root", str(ckpt_root), "--content", str(content),
                     "--out", str(out), "--landmarks", str(tmp_path / "lm.npy"),
                     "--style_type", STYLE, "--model", STYLE,
                     "--styles", f"{STYLE},arcane1", "--cpu"])
    names = [f"demo_{STYLE}.jpg", "walkthrough_ds0.0.jpg", "walkthrough_ds0.5.jpg",
             "walkthrough_ds1.0.jpg", f"style_{STYLE}.jpg", "style_arcane1.jpg",
             "style_color_transfer.jpg"]
    assert sorted(os.listdir(out)) == sorted(names)
    imgs = {n: cv2.imread(str(out / n)) for n in names}
    assert all(im.shape == (288, 288, 3) for im in imgs.values())
    # part 1 at degree 0.5 is part 2's 0.5 step: the same model and style
    assert (out / f"demo_{STYLE}.jpg").read_bytes() == (out / "walkthrough_ds0.5.jpg").read_bytes()
    assert (imgs["walkthrough_ds0.0.jpg"] != imgs["walkthrough_ds1.0.jpg"]).any()


GATE_CASES = ["077436_vtoonify_d", "038648_vtoonify_t"]


def test_release_gate_passes_jax_goldens(ckpt_root, tmp_path):
    from vtoonify_tpu.cli import validate_release as jvr

    data, lms = tmp_path / "data", tmp_path / "landmarks"
    data.mkdir()
    lms.mkdir()
    for i, stem in enumerate(("077436", "038648")):
        cv2.imwrite(str(data / f"{stem}.jpg"), cv2.cvtColor(_portrait(40 + i), cv2.COLOR_RGB2BGR))
        np.save(lms / f"{stem}.npy", _landmarks())
    common = ["--checkpoint_root", str(ckpt_root), "--data_root", str(data),
              "--landmarks_root", str(lms), "--cases", *GATE_CASES, "--skip_video", "--cpu"]

    # goldens: the JAX package's CLI through its own gate (which fails here,
    # its goldens missing), its outputs installed under the golden names
    golden = tmp_path / "golden"
    assert jvr.main(common + ["--golden_root", str(golden),
                              "--output_path", str(tmp_path / "jax")]) == 1
    golden.mkdir()
    for name in GATE_CASES:
        stem, _, b = name.split("_")
        shutil.copy(tmp_path / "jax" / f"{stem}_vtoonify_{b}.jpg", golden / f"{name}.jpg")

    report = tmp_path / "report.json"
    assert vr.main(common + ["--golden_root", str(golden), "--output_path",
                             str(tmp_path / "port"), "--json_out", str(report)]) == 0
    results = json.loads(report.read_text())["results"]
    assert [r["case"] for r in results] == GATE_CASES
    assert all(r["pass"] and r["psnr_db"] >= vr.MIN_PSNR_DB for r in results), results
    assert all(r["detail"] == "288x288" for r in results), results

    # a perturbed golden fails the gate
    g = cv2.imread(str(golden / f"{GATE_CASES[0]}.jpg")).astype(np.int16)
    noise = np.random.RandomState(34).randint(-60, 61, g.shape)
    cv2.imwrite(str(golden / f"{GATE_CASES[0]}.jpg"), np.clip(g + noise, 0, 255).astype(np.uint8))
    assert vr.main(common + ["--golden_root", str(golden), "--output_path",
                             str(tmp_path / "port2"), "--json_out", str(report)]) == 1
    results = json.loads(report.read_text())["results"]
    assert [r["pass"] for r in results] == [False, True]
    assert results[0]["psnr_db"] < vr.MIN_PSNR_DB

    with pytest.raises(SystemExit, match="unknown case"):
        vr.main(["--cases", "nope", "--cpu", "--output_path", str(tmp_path / "x")])


def test_apps_refuse_without_a_card(ckpt_root, tmp_path, monkeypatch):
    """Without a card and without --cpu, every entry point of this slice
    raises before it loads anything: none carries on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = ["--checkpoint_root", str(ckpt_root)]
    for main, argv in (
            (serve.main, root),
            (playground.main, root + ["--content", str(tmp_path / "face.png"),
                                      "--out", str(tmp_path / "out")]),
            (vr.main, root + ["--output_path", str(tmp_path / "gate")]),
            (smooth_parsing.main, ["--video_path", str(tmp_path / "in.mp4")]),
            (raft_viz.main, ["--model", str(tmp_path / "raft.pth"),
                             "--path", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not (tmp_path / "gate").exists()
