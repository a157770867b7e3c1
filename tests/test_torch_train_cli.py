"""The port's trainer CLIs, exporters, LPIPS loader, training guards and
logging (CPU).

Both CLIs run both stages on the CPU (`--cpu --tiny --allow_random_lpips`)
on the reference-format random files of tests/test_torch_checkpoint.py's
`zoo` (plus a style-finetuned StyleGAN for VToonify-T, written by the
port's exporter): stage 1 for 2 iterations, resumed to 3; stage 2 for 1
iteration at batch 1, resumed to 2; `--export_pt` throughout. The exported
checkpoint must load strictly through `load_reference_vtoonify` and run in
`ToonifyPipeline`. The exporters are held to the JAX package's on the same
parameters; the guards and logging cases are the port's copies of
tests/test_guards.py and tests/test_logging.py.
"""

import glob
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import TINY, jax_layout, zoo  # noqa: F401
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401
from vtoonify_tpu.convert import torch_export as JE
from vtoonify_tpu.models import lpips as JLP
from vtoonify_tpu.models import vtoonify as JV
from vtoonify_tpu_torch.cli import train_d, train_t
from vtoonify_tpu_torch.convert import torch_export as E
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict
from vtoonify_tpu_torch.models import lpips as LP
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
from vtoonify_tpu_torch.train import guards as GD
from vtoonify_tpu_torch.train import logging as LG
from vtoonify_tpu_torch.utils import checkpoint as CK
from vtoonify_tpu_torch.utils.profiling import StepTrace


# ---------------------------------------------------------------------------
# the trainer CLIs


@pytest.fixture(scope="module")
def files(zoo):
    """The `zoo` files, removed with the module (about 1.2 GB on disk)."""
    yield zoo
    shutil.rmtree(zoo["root"], ignore_errors=True)


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def _metrics(name):
    return [json.loads(line) for line in open(f"log/{name}/metrics.jsonl")]


def _check_exported(path, zoo, backbone):
    """The exported g_ema loads strictly in the port and toonifies."""
    vt, cfg = CK.load_reference_vtoonify(path)
    assert cfg.backbone == backbone and cfg.out_size == 128
    pipe = ToonifyPipeline(vt, cfg, CK.load_reference_faceparsing(zoo["faceparsing"]),
                           dtype=torch.float32, device="cpu")
    frames = np.random.RandomState(0).randint(0, 256, (1, 32, 32, 3), np.uint8)
    s_w = np.random.RandomState(1).randn(1, cfg.n_latent, 512).astype(np.float32) * 0.3
    out = pipe.process_batch(frames, s_w, 0.5)
    assert tuple(out.shape) == (1, 128, 128, 3) and out.dtype == torch.uint8


def _stages(main, common, name, capsys, resume_stage2=True):
    """Stage 1 for 2 iterations, resumed to 3; stage 2 for 1, resumed to 2
    (or for 1 only)."""
    base = [*common, "--name", name, "--export_pt", "--cpu", "--tiny",
            "--allow_random_lpips", "--log_every", "10"]
    out = _run(main, [*base, "--pretrain", "--iter", "2", "--batch", "2"], capsys)
    assert "iter 1:" in out
    out = _run(main, [*base, "--pretrain", "--iter", "3", "--batch", "2", "--resume"],
               capsys)
    assert "resumed pretrain state at step 2" in out and "iter 2:" in out
    assert [r["step"] for r in _metrics(name)] == [0, 1, 2]
    _run(main, [*base, "--iter", "1", "--batch", "1"], capsys)
    if resume_stage2:
        out = _run(main, [*base, "--iter", "2", "--batch", "1", "--resume"], capsys)
        assert "resumed full train state at step 1" in out and "iter 1:" in out
    recs = _metrics(name)
    assert [r["step"] for r in recs] == [0, 1, 2, 0, 1][:4 + resume_stage2]
    assert all(np.isfinite(v) for r in recs for k, v in r.items() if k != "step")
    return recs


def _t_common(files, tmp_path):
    zoo = files
    finetune = str(tmp_path / "finetune.pt")
    gen = zoo["made"]["toonify"].generator
    torch.save({"g_ema": {k: torch.from_numpy(v) for k, v in E.export_generator(
        gen, V.VToonifyConfig(backbone="toonify", **TINY).generator).items()}}, finetune)
    return ["--stylegan_path", zoo["stylegan"], "--finetunegan_path", finetune,
            "--faceparsing_path", zoo["faceparsing"], "--style_encoder_path",
            zoo["psp"], "--direction_path", zoo["directions"],
            "--weight", *["0.75"] * 7, *["1"] * 11]


def test_train_d_cli_both_stages(files, tmp_path, monkeypatch, capsys):
    zoo = files
    monkeypatch.chdir(tmp_path)
    common = ["--stylegan_path", zoo["generator"], "--faceparsing_path",
              zoo["faceparsing"], "--style_encoder_path", zoo["psp"],
              "--exstyle_path", zoo["bank"], "--direction_path", zoo["directions"],
              "--style_id", "1"]
    recs = _stages(train_d.main, common, "d", capsys)
    assert set(recs[-1]) >= {"g", "gr", "gf", "tp", "msk", "d", "d_s"}
    files = {os.path.basename(f) for f in glob.glob("checkpoint/d/*")}
    assert files == {"pretrain.ckpt", "pretrain.pt", "pretrain_state.ckpt",
                     "vtoonify_s_d_c.ckpt", "vtoonify_s_d_c.pt", "train_state.ckpt"}
    assert {"00001.jpg", "00002.jpg"} <= set(os.listdir("log/d"))
    state = torch.load("checkpoint/d/train_state.ckpt", weights_only=True)
    assert state["kind"] == "TrainDState" and state["step"] == 2
    pre = torch.load("checkpoint/d/pretrain.pt", weights_only=True)["g_ema"]
    assert "0.0.weight" in pre and not any(k.startswith("encoder.") for k in pre)
    _check_exported("checkpoint/d/vtoonify_s_d_c.pt", zoo, "dualstylegan")
    shutil.rmtree("checkpoint")  # ~1 GB of checkpoints


def test_train_t_cli_both_stages(files, tmp_path, monkeypatch, capsys):
    zoo = files
    common = _t_common(zoo, tmp_path)
    monkeypatch.chdir(tmp_path)
    # stage 2 once: its resume is the loop and state file D's test resumes
    recs = _stages(train_t.main, common, "t", capsys, resume_stage2=False)
    assert set(recs[-1]) >= {"g", "gr", "gf", "tp", "d"} and "msk" not in recs[-1]
    files = {os.path.basename(f) for f in glob.glob("checkpoint/t/*")}
    assert files == {"pretrain.ckpt", "pretrain.pt", "pretrain_state.ckpt",
                     "vtoonify.ckpt", "vtoonify.pt", "train_state.ckpt"}
    assert "00000.jpg" in os.listdir("log/t")
    _check_exported("checkpoint/t/vtoonify.pt", zoo, "toonify")
    shutil.rmtree("checkpoint")


def _state_rel_l2(a, b):
    """The largest relative L2 gap over a saved train state's module state
    dicts and optimizer moments (the same keys and names asserted)."""
    worst = 0.0
    for f in ("trainable", "ema", "d"):
        if f in b:
            assert set(a[f]) == set(b[f])
            num = sum(((a[f][k] - b[f][k]) ** 2).sum() for k in b[f])
            worst = max(worst, (num / sum((b[f][k] ** 2).sum() for k in b[f])).sqrt().item())
    for f in ("g_opt", "d_opt"):
        if f in b:
            assert sorted(a[f]["names"]) == sorted(b[f]["names"])
            for n, st in b[f]["state"].items():
                for k in ("exp_avg", "exp_avg_sq"):
                    gap = (a[f]["state"][n][k] - st[k]).norm() / max(st[k].norm(), 1e-30)
                    worst = max(worst, gap.item())
    return worst


@pytest.mark.parametrize("cli", ["train_d", "train_t"])
def test_trainer_cli_tp2_matches_tp1(cli, files, tmp_path, monkeypatch, capsys):
    """`--tiny --cpu --tp 2` (the wide weights split over the CPU named
    twice) against `--tp 1`: stage 1 for one iteration at batch 2, then
    stage 2 for one at batch 1 from the same stage-1 encoder; each saved
    train state (split weights saved whole, the optimizers by name) within
    1e-5 relative L2 of the tp-1 run's, as the 2-rank CLI runs are held
    (float32: a split conv may round its sums in another order)."""
    zoo = files
    main = {"train_d": train_d.main, "train_t": train_t.main}[cli]
    common = (["--stylegan_path", zoo["generator"], "--faceparsing_path",
               zoo["faceparsing"], "--style_encoder_path", zoo["psp"],
               "--exstyle_path", zoo["bank"], "--direction_path", zoo["directions"],
               "--style_id", "1"] if cli == "train_d" else _t_common(files, tmp_path))
    monkeypatch.chdir(tmp_path)
    base = [*common, "--cpu", "--tiny", "--allow_random_lpips", "--log_every", "10"]
    for tp in ("1", "2"):
        _run(main, [*base, "--name", f"tp{tp}", "--tp", tp, "--pretrain", "--iter", "1",
                    "--batch", "2"], capsys)
        _run(main, [*base, "--name", f"tp{tp}", "--tp", tp, "--iter", "1", "--batch", "1",
                    "--encoder_path", "checkpoint/tp1/pretrain.ckpt"], capsys)
    for name in ("pretrain_state.ckpt", "train_state.ckpt"):
        a, b = (torch.load(f"checkpoint/tp{tp}/{name}", weights_only=True) for tp in "21")
        assert a["kind"] == b["kind"] and a["step"] == b["step"] == 1
        assert _state_rel_l2(a, b) <= 1e-5, name
    shutil.rmtree("checkpoint")


@pytest.mark.parametrize("cli", ["train_d", "train_t"])
@pytest.mark.parametrize("argv,raises,match", [
    # (the first two ids kept from when both were refused as not ported;
    # the first is now the refusal of --tp 2 with one card visible)
    pytest.param(["--tp", "2"], SystemExit, "needs cards cuda:0-1 .*1 visible",
                 id="argv0-SystemExit-queue A item 10"),
    pytest.param(["--multihost", "--cpu"], ValueError, "coordinator",
                 id="argv1-SystemExit-not ported yet"),
    ([], RuntimeError, "no CUDA device"),
])
def test_trainer_refusals(cli, argv, raises, match, monkeypatch, tmp_path):
    """--tp 2 with one card visible is refused, naming the count;
    --multihost with no coordinator and no launcher raises before any
    process group starts; without --cpu and without a card the trainers
    raise instead of running on the CPU."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "VTOONIFY_COORDINATOR", "VTOONIFY_NUM_PROCESSES", "VTOONIFY_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    one_card = "--tp" in argv  # a card is visible, one short of the row
    monkeypatch.setattr(torch.cuda, "is_available", lambda: one_card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: int(one_card))
    main = {"train_d": train_d.main, "train_t": train_t.main}[cli]
    with pytest.raises(raises, match=match):
        main(argv)


def test_capability_suffix_and_parser_parity():
    """Checkpoint names as the reference's (train_vtoonify_d.py:193-200),
    and every option of the JAX trainers' parsers is accepted."""
    from vtoonify_tpu.cli import train_d as jd
    from vtoonify_tpu.cli import train_t as jt

    p = train_d.build_parser()
    assert train_d.capability_suffix(p.parse_args([])) == "_s_d_c"
    assert train_d.capability_suffix(p.parse_args(
        ["--fix_style", "--style_id", "7", "--fix_degree", "--style_degree",
         "0.3", "--fix_color"])) == "_s007_d0.3"
    for ours, theirs in ((train_d, jd), (train_t, jt)):
        opts = {a.option_strings[0] for a in ours.build_parser()._actions}
        want = {a.option_strings[0] for a in theirs.build_parser()._actions}
        assert want <= opts and opts - want == {"--cpu"}, want ^ opts


# ---------------------------------------------------------------------------
# exporters and the LPIPS loader


@pytest.mark.parametrize("what", ["generator", "dualstylegan", "vtoonify_d",
                                  "vtoonify_t"])
def test_exporters_match_jax(files, what, tmp_path):
    """The port's export of a module equals the JAX package's export of the
    same parameters (keys and arrays, exactly); the VToonify file round
    trips through the port's loader to the same state."""
    made = files["made"]
    cfg_d = V.VToonifyConfig(**TINY)
    jcfg_d = JV.VToonifyConfig(**TINY)
    if what == "generator":
        mod = made["dualstylegan"].generator.generator
        got = E.export_generator(mod, cfg_d.generator)
        want = JE.export_generator(jax_layout(mod), jcfg_d.generator)
    elif what == "dualstylegan":
        mod = made["dualstylegan"].generator
        got = E.export_dualstylegan(mod, cfg_d.dualstylegan)
        want = JE.export_dualstylegan(jax_layout(mod), jcfg_d.dualstylegan)
    else:
        backbone = "dualstylegan" if what == "vtoonify_d" else "toonify"
        mod = made[backbone]
        cfg = V.VToonifyConfig(backbone=backbone, **TINY)
        got = E.export_vtoonify(mod, cfg)
        tree = jax_layout(mod)
        tree["encoder"]["down"] = []  # in_size 32: no state
        want = JE.export_vtoonify(tree, JV.VToonifyConfig(backbone=backbone, **TINY))
        # a partial model (the stage-1 checkpoint) exports partially
        part = E.export_vtoonify({"encoder": mod.encoder}, cfg)
        assert set(part) == {k for k in got if k.startswith("encoder.")}
        assert all(np.array_equal(part[k], got[k]) for k in part)
        path = E.save_reference_checkpoint(str(tmp_path / "vt.pt"), mod, cfg)
        back, back_cfg = CK.load_reference_vtoonify(path)
        assert back_cfg == cfg
        want_sd = mod.state_dict()
        for k, v in back.state_dict().items():
            assert torch.equal(v, want_sd[k]), k
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


def test_load_lpips_matches_jax(tmp_path, monkeypatch):
    """VGG16 (torchvision keys) and lin-head files load into the port's
    LPIPS as into JAX's; without --vgg_path it raises unless allowed, and
    the lin heads come only from --lpips_lin_path or $VTOONIFY_LPIPS_LIN."""
    rng = np.random.RandomState(2)
    plan = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
            (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512),
            (21, 512, 512), (24, 512, 512), (26, 512, 512), (28, 512, 512)]
    vgg = {}
    for i, cin, cout in plan:
        vgg[f"features.{i}.weight"] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05)
        vgg[f"features.{i}.bias"] = torch.from_numpy(rng.randn(cout).astype(np.float32))
    lin = {f"lin{k}.model.1.weight": torch.from_numpy(rng.rand(1, c, 1, 1).astype(np.float32))
           for k, c in enumerate((64, 128, 256, 512, 512))}
    torch.save(vgg, str(tmp_path / "vgg16.pth"))
    torch.save(lin, str(tmp_path / "lin.pth"))
    monkeypatch.delenv("VTOONIFY_LPIPS_LIN", raising=False)

    net, desc = LP.load_lpips(str(tmp_path / "vgg16.pth"), str(tmp_path / "lin.pth"))
    jparams, _ = JLP.load_lpips(str(tmp_path / "vgg16.pth"), str(tmp_path / "lin.pth"))
    want = jax_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    got = net.state_dict()
    assert set(got) == set(want) and "lin heads" in desc
    assert all(torch.equal(got[k], want[k]) for k in want)

    with pytest.raises(ValueError, match="--allow_random_lpips"):
        LP.load_lpips()
    with pytest.raises(ValueError, match="lin-head weights not found"):
        LP.load_lpips(str(tmp_path / "vgg16.pth"))
    assert LP.find_lin_weights() is None
    monkeypatch.setenv("VTOONIFY_LPIPS_LIN", str(tmp_path / "lin.pth"))
    net, desc = LP.load_lpips(allow_random=True)
    assert desc.startswith("random VGG16 + real lin heads")
    assert torch.equal(net.lins[3].weight, lin["lin3.model.1.weight"])


# ---------------------------------------------------------------------------
# guards (the cases of tests/test_guards.py)


def test_preemption_guard_catches_sigterm_and_chains():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        guard = GD.PreemptionGuard()
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and guard.signum == signal.SIGTERM
        assert seen == [signal.SIGTERM]  # previous handler still ran
    finally:
        guard.uninstall()
        signal.signal(signal.SIGTERM, prev)


def test_handle_preemption_saves_once_and_reports():
    guard = GD.PreemptionGuard(signals=())
    saves = []
    assert not GD.handle_preemption(guard, lambda: saves.append(1), step=3)
    assert saves == []
    guard.requested = True
    guard.signum = signal.SIGTERM
    assert GD.handle_preemption(guard, lambda: saves.append(1), step=3)
    assert saves == [1]


def test_check_finite_metrics():
    GD.check_finite_metrics({"g": torch.tensor(0.1), "d": 2.0}, step=7)
    with pytest.raises(FloatingPointError, match="step 9.*'d'.*--debug_nans"):
        GD.check_finite_metrics({"g": 0.1, "d": float("nan")}, step=9)
    with pytest.raises(FloatingPointError, match="inf"):
        GD.check_finite_metrics({"g": float("inf")}, step=1)


def test_enable_nan_debugging(monkeypatch):
    flags = []
    monkeypatch.setattr(torch.autograd, "set_detect_anomaly", flags.append)
    GD.enable_nan_debugging()
    assert flags == [True]


# ---------------------------------------------------------------------------
# logging (the cases of tests/test_logging.py)


def test_to_uint8_rounds_half_up():
    out = LG.to_uint8(np.array([-1.0, 0.0, 1.0, -1.0 + 0.5 / 127.5]))
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, [0, 128, 255, 1])


def test_save_image_grid_layout(tmp_path):
    from PIL import Image

    imgs = np.zeros((6, 3, 16, 16), np.float32)
    imgs[0] = 1.0  # white first tile
    path = str(tmp_path / "grid.jpg")
    LG.save_image_grid(path, imgs, nrow=3, pad=2)
    grid = np.asarray(Image.open(path))
    assert grid.shape == (2 * 16 + 3 * 2, 3 * 16 + 4 * 2, 3)
    assert grid[2 + 8, 2 + 8, 0] > 200
    assert grid[2 + 8, 2 + 16 + 2 + 8, 0] < 150


def test_metrics_logger_jsonl(tmp_path):
    mlog = LG.MetricsLogger(str(tmp_path))
    mlog.log(3, {"d": torch.tensor(0.5), "g": 1.25}, d_s=0.4)
    mlog.log(4, {"d": 0.25, "g": 1.0})
    lines = [json.loads(line) for line in open(mlog.path)]
    assert [rec["step"] for rec in lines] == [3, 4]
    assert lines[0]["d"] == 0.5 and lines[0]["d_s"] == 0.4
    assert "wall_s" in lines[1]


@pytest.mark.parametrize("fix_degree,use_degree,nrows",
                         [(False, True, 3), (True, True, 2), (False, False, 2)])
def test_sample_grid_logger(tmp_path, fix_degree, use_degree, nrows):
    from PIL import Image

    backbone = "dualstylegan" if use_degree else "toonify"
    cfg = V.VToonifyConfig(backbone=backbone, **TINY)
    vt = V.init_vtoonify(cfg, torch.Generator().manual_seed(0))
    b = 2
    rng = np.random.RandomState(0)
    batch_data = {
        "real_input": torch.from_numpy(rng.randn(b, 22, 32, 32).astype(np.float32) * 0.1),
        "real_output": torch.from_numpy(rng.randn(b, 3, 128, 128).astype(np.float32)),
        "xl": torch.from_numpy(rng.randn(b, cfg.n_latent, 512).astype(np.float32) * 0.1),
    }
    glog = LG.SampleGridLogger(str(tmp_path), cfg, fix_degree=fix_degree,
                               use_degree=use_degree)
    glog.seed(batch_data, 0.5)
    glog.seed(batch_data, 0.9)  # only the first seed sticks
    assert glog._fixed["d_s"] == 0.5
    path = glog.log(7, dict(vt.named_children()), 0.8)
    grid = np.asarray(Image.open(path))
    assert path.endswith("00007.jpg")
    assert grid.shape == (nrows * 256 + (nrows + 1) * 2, b * 256 + (b + 1) * 2, 3)


def test_step_trace_writes_window_and_flushes_truncated(tmp_path):
    """--profile N: the window's trace is written at its last step, and
    close() writes one cut short by the end of the loop."""
    logdir = str(tmp_path / "trace")
    tr = StepTrace(logdir, first_step=1, n_steps=2)
    for step in range(4):
        tr.before(step)
        torch.ones(4).sum()
        tr.after(step)
    assert not tr._active and glob.glob(logdir + "/steps_1-2.json")
    tr = StepTrace(logdir, first_step=0, n_steps=10)
    tr.before(0)
    tr.after(0)
    tr.close()
    assert not tr._active and glob.glob(logdir + "/steps_0-9.json")
    tr.close()  # idempotent
