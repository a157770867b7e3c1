"""The port's RAFT training (models/raft_train.py, train-mode batch norm) vs
the JAX package's (CPU, float32).

RAFT at the raft-things widths (hidden 128, 256-channel encoders), frames
(2, 3, 48, 64), 2 refinement iterations, as JAX's own tests/test_raft_train.py
runs it. JAX's `init_raft` params (batch norms given random statistics) go
into the port through `load_jax_params`; the port's `RaftTrainDraws` is
filled from JAX's own key splits. One JAX jit per BN mode (`jax_run`) serves
every assertion on it.

Tolerances: train-mode batch norm within 1e-5 (its output relative, both
buffers absolute); the sequence loss and its metrics within 1e-5 relative;
the schedule within 1e-6 relative (JAX evaluates it in float32); one and
two steps: loss and metrics within 1e-5 relative, the new params within
1e-4 relative L2, the update (new - old) within 1e-2 relative L2 and the
trained BN buffers within 1e-5, all from float32 sums ordered differently;
frozen BN buffers bit-unchanged. The augmentors, the batch iterator, the
indexers and `fetch_stage` bit-equal (the same numpy/cv2 code on the same
seed).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_raft import _randomize_bn, _reference_state
from tests.test_torch_train_stage1 import lean_worker, release_memory  # noqa: F401
from vtoonify_tpu.models import raft as JR
from vtoonify_tpu.models import raft_train as JT
from vtoonify_tpu.nn import layers as JL
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict, load_jax_params
from vtoonify_tpu_torch.models import raft as R
from vtoonify_tpu_torch.models import raft_data as RD
from vtoonify_tpu_torch.models import raft_train as T
from vtoonify_tpu_torch.nn import layers as L

RTOL = 1e-5
PARAMS_REL_L2, UPDATE_REL_L2 = 1e-4, 1e-2
SHAPE = (2, 48, 64)
# clip 0.5 binds in both modes: the gradient's global norm is 0.85-1.2 here
TCFG = dict(lr=1e-4, num_steps=10, iters=2, add_noise=True, clip=0.5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tree_rel(got: dict, want: dict, keys):
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in keys)
    return np.sqrt(num / sum(float((want[k] ** 2).sum()) for k in keys))


def test_batch_norm_train_matches_jax():
    rng = np.random.RandomState(90)
    c = 5
    jp = {"weight": rng.randn(c).astype(np.float32),
          "bias": rng.randn(c).astype(np.float32),
          "running_mean": np.zeros(c, np.float32), "running_var": np.ones(c, np.float32)}
    bn = load_jax_params(L.BatchNorm2d(c), jp)
    L.set_trainable(bn)
    for i in range(2):
        x = (rng.randn(3, 8, 6, c) * 2 + i).astype(np.float32)
        jy, jp = JL.batch_norm_2d_train(jp, jnp.asarray(x))
        xt = _nchw(x).requires_grad_(True)
        y = L.batch_norm_2d_train(bn, xt)
        assert _rel(np.moveaxis(y.detach().numpy(), 1, -1), np.asarray(jy)) <= RTOL
        y.square().sum().backward()  # gradients flow through the batch stats
        assert xt.grad is not None and bn.weight.grad is not None
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(jp[k]),
                                       atol=1e-5, rtol=0)
    assert not bn.running_var.requires_grad


def test_sequence_loss_matches_jax():
    rng = np.random.RandomState(80)
    b, h, w, n = 2, 12, 16, 4
    preds = [rng.randn(b, h, w, 2).astype(np.float32) * 3 for _ in range(n)]
    gt = rng.randn(b, h, w, 2).astype(np.float32) * 3
    gt[0, 0, 0] = 500.0  # beyond MAX_FLOW
    valid = (rng.rand(b, h, w) > 0.3).astype(np.float32)
    jl, jm = JT.sequence_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt),
                              jnp.asarray(valid), gamma=0.8)
    tl, tm = T.sequence_loss([_nchw(p) for p in preds], _nchw(gt),
                             torch.from_numpy(valid), gamma=0.8)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert set(tm) == set(jm) == {"epe", "1px", "3px", "5px"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)


def test_schedule_matches_jax():
    """Every step of a 50-step run (scheduled over 150, as the trainer
    does): the rise to the peak at step 6.5 and the fall after it."""
    lr, num_steps = 4e-4, 50
    js = JT.onecycle_linear_lr(lr, num_steps + 100)
    ts = T.onecycle_linear_lr(lr, num_steps + 100)
    for k in range(num_steps):
        np.testing.assert_allclose(ts(k), float(js(k)), rtol=1e-6, err_msg=f"step {k}")


def _inputs():
    rng = np.random.RandomState(85)
    b, h, w = SHAPE
    return ((rng.rand(b, h, w, 3) * 255).astype(np.float32),
            (rng.rand(b, h, w, 3) * 255).astype(np.float32),
            (rng.randn(b, h, w, 2) * 3).astype(np.float32),
            (rng.rand(b, h, w) > 0.2).astype(np.float32))


@pytest.fixture(scope="module", params=[False, True], ids=["frozen_bn", "train_bn"])
def jax_run(request):
    """Two JAX steps from randomized-BN params (one jit), their params,
    metrics, learning rates and the draws of each step."""
    train_bn = request.param
    jp = _randomize_bn(jax.tree_util.tree_map(np.asarray, JR.init_raft(jax.random.PRNGKey(0))),
                       np.random.RandomState(1))
    tcfg = JT.RaftTrainConfig(train_bn=train_bn, **TCFG)
    im1, im2, flow, valid = _inputs()
    state = JT.init_raft_train_state(jax.tree_util.tree_map(jnp.asarray, jp), tcfg)
    step = jax.jit(JT.raft_train_step, static_argnames=("cfg", "tcfg"))
    sched = JT.onecycle_linear_lr(tcfg.lr, tcfg.num_steps + 100)
    out = {"train_bn": train_bn, "params0": jp, "params": [], "metrics": [], "draws": [],
           "lr": [float(sched(i)) for i in range(3)]}
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        state, m = step(state, *(jnp.asarray(a) for a in (im1, im2, flow, valid)),
                        JR.RAFTConfig(), tcfg, key)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(jax_state_dict(jax.tree_util.tree_map(np.asarray, state.params)))
        k1, k2, k3 = jax.random.split(key, 3)
        out["draws"].append(T.RaftTrainDraws(
            torch.tensor(float(jax.random.uniform(k1) * 5.0)),
            _nchw(np.asarray(jax.random.normal(k2, im1.shape))),
            _nchw(np.asarray(jax.random.normal(k3, im2.shape)))))
    del state, step
    release_memory()
    return out


def test_raft_train_step_matches_jax(jax_run):
    """One and two steps of the port against JAX's, with JAX's draws and a
    clip that binds: loss and metrics, params, the update, the BN buffers
    (trained: moved as JAX's; frozen: bit-unchanged) and the learning rate
    each step used (a third step's too: JAX reads the schedule at the step
    count before its increment)."""
    jp0 = jax_run["params0"]
    model = load_jax_params(R.init_raft(), jp0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = T.RaftTrainConfig(train_bn=jax_run["train_bn"], **TCFG)
    state = T.init_raft_train_state(model, tcfg, device="cpu")
    im1, im2, flow, valid = _inputs()
    bn_keys = [k for k in before if "running" in k]
    assert len(bn_keys) == 2 * 15 and all(k.startswith("cnet.") for k in bn_keys)
    prev = jax_state_dict(jp0)
    for i in range(2):
        m = T.raft_train_step(state, _nchw(im1), _nchw(im2), _nchw(flow),
                              torch.from_numpy(valid), R.RAFTConfig(), tcfg,
                              draws=jax_run["draws"][i])
        assert state.step == i + 1
        assert state.opt.param_groups[0]["lr"] == pytest.approx(jax_run["lr"][i], rel=1e-6)
        # the clip bound: the gradients AdamW took have the clip's norm
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in model.parameters()])).item()
        assert norm == pytest.approx(TCFG["clip"], rel=1e-5)
        want_m = jax_run["metrics"][i]
        assert set(m) == set(want_m) == {"loss", "epe", "1px", "3px", "5px"}
        for k, v in want_m.items():
            np.testing.assert_allclose(float(m[k]), v, rtol=RTOL, err_msg=f"step {i} {k}")
        got, want = model.state_dict(), jax_run["params"][i]
        assert got.keys() == want.keys()
        trained = [k for k in got if k not in bn_keys]
        assert _tree_rel(got, want, trained) <= PARAMS_REL_L2
        upd = {k: got[k] - prev[k] for k in trained}
        jupd = {k: want[k] - prev[k] for k in trained}
        assert _tree_rel(upd, jupd, trained) <= UPDATE_REL_L2
        for k in bn_keys:
            if jax_run["train_bn"]:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0)
                assert not torch.equal(got[k], before[k]), k
            else:
                assert torch.equal(got[k], before[k]), k
        prev = want
    T.raft_train_step(state, _nchw(im1), _nchw(im2), _nchw(flow), torch.from_numpy(valid),
                      R.RAFTConfig(), tcfg, draws=jax_run["draws"][1])
    assert state.opt.param_groups[0]["lr"] == pytest.approx(jax_run["lr"][2], rel=1e-6)


def test_raft_apply_train_bn_updates_only_the_cnet(jax_run):
    """raft_apply(test_mode=False, train_bn=True) moves cnet's buffers in
    place and returns the training list; test mode leaves them alone."""
    model = load_jax_params(R.init_raft(), jax_run["params0"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x1, x2 = (_nchw(a) for a in _inputs()[:2])
    with torch.no_grad():
        R.raft_apply(model, x1, x2, iters=1, train_bn=True)  # test mode
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
        flows = R.raft_apply(model, x1, x2, iters=2, test_mode=False,
                             train_bn=jax_run["train_bn"])
    assert len(flows) == 2 and flows[-1].shape == (2, 2, 48, 64)
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    assert moved == ({k for k in before if "running" in k} if jax_run["train_bn"] else set())


def test_raft_train_step_runs_in_float64(jax_run):
    """A float64 model steps in float64 throughout (the correlation
    pyramid, the coordinates, train-mode BN statistics, the sequence loss):
    the gate that tells float32 rounding from a fault runs the step so. Its
    loss and metrics within 1e-5 relative of JAX's float32 step, its new
    params within 1e-4 relative L2 (float32 against float64)."""
    model = load_jax_params(R.init_raft(), jax_run["params0"]).double()
    tcfg = T.RaftTrainConfig(train_bn=jax_run["train_bn"], **TCFG)
    state = T.init_raft_train_state(model, tcfg, device="cpu")
    d = jax_run["draws"][0]
    im1, im2, flow, valid = (torch.from_numpy(a).double() for a in _inputs())
    m = T.raft_train_step(state, im1.permute(0, 3, 1, 2), im2.permute(0, 3, 1, 2),
                          flow.permute(0, 3, 1, 2), valid, R.RAFTConfig(), tcfg,
                          draws=T.RaftTrainDraws(*(t.double() for t in (d.stdv, d.noise1,
                                                                        d.noise2))))
    assert {v.dtype for v in m.values()} == {torch.float64}
    assert {v.dtype for v in model.state_dict().values()} == {torch.float64}
    for k, v in jax_run["metrics"][0].items():
        np.testing.assert_allclose(float(m[k]), v, rtol=RTOL, err_msg=k)
    got, want = model.state_dict(), jax_run["params"][0]
    trained = [k for k in got if "running" not in k]
    assert _tree_rel({k: got[k].float() for k in trained}, want, trained) <= PARAMS_REL_L2


def test_corr_pyramid_stays_float32_under_autocast():
    """--mixed_precision: the correlation matmul runs in bfloat16, the
    pyramid the 12 lookups sample stays float32 (as JAX's einsum with a
    float32 result), so no lookup casts it again."""
    rng = np.random.RandomState(7)
    f1, f2 = (torch.from_numpy(rng.randn(1, 32, 8, 12).astype(np.float32)) for _ in range(2))
    with torch.autocast("cpu", torch.bfloat16):
        pyr = R.build_corr_pyramid(f1, f2)
    want = R.build_corr_pyramid(f1, f2)
    assert [p.dtype for p in pyr] == [torch.float32] * 4
    assert [p.shape for p in pyr] == [p.shape for p in want]
    assert _rel(pyr[0].numpy(), want[0].numpy()) <= 1e-2  # bfloat16 products


# --- the host data code ----------------------------------------------------------


def _frames(rng, h, w):
    return (rng.randint(0, 255, (h, w, 3), np.uint8), rng.randint(0, 255, (h, w, 3), np.uint8))


def test_augmentors_match_jax():
    rng = np.random.RandomState(81)
    img1, img2 = _frames(rng, 60, 80)
    flow = rng.randn(60, 80, 2).astype(np.float32) * 4
    valid = (rng.rand(60, 80) > 0.5).astype(np.float32)
    pairs = [(T.FlowAugmentor((40, 56), seed=5), JT.FlowAugmentor((40, 56), seed=5), ()),
             (T.FlowAugmentor((56, 72), -0.1, 1.0, True, 3),
              JT.FlowAugmentor((56, 72), -0.1, 1.0, True, 3), ()),
             (T.SparseFlowAugmentor((40, 56), seed=6),
              JT.SparseFlowAugmentor((40, 56), seed=6), (valid,)),
             (T.SparseFlowAugmentor((40, 56), -0.3, 0.5, True, 7),
              JT.SparseFlowAugmentor((40, 56), -0.3, 0.5, True, 7), (valid,))]
    for taug, jaug, extra in pairs:
        for _ in range(10):  # across the flip / scale / jitter / eraser draws
            got = taug(img1, img2, flow, *extra)
            want = jaug(img1, img2, flow, *extra)
            assert len(got) == len(want) == 4
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    f2, v2 = T.SparseFlowAugmentor.resize_sparse_flow_map(flow, valid, fx=1.7, fy=1.3)
    jf2, jv2 = JT.SparseFlowAugmentor.resize_sparse_flow_map(flow, valid, fx=1.7, fy=1.3)
    np.testing.assert_array_equal(f2, jf2)
    np.testing.assert_array_equal(v2, jv2)


def _write_pfm(path, data):
    """Little-endian colour PFM, rows bottom-up (frame_utils.writePFM)."""
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode())
        f.write(np.flipud(data).astype("<f4").tobytes())


def _data_tree(root, rng, h=40, w=56):
    """Synthetic FlyingChairs (with a split file), FlyingThings3D (PFM flow,
    both passes), Sintel (clean and final), KITTI and HD1K trees under
    `root`, the trainer's --data_root layout."""
    import cv2

    def img(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, rng.randint(0, 255, (h, w, 3), np.uint8))

    chairs = os.path.join(root, "FlyingChairs_release", "data")
    for i in (1, 2, 3):
        for t in (1, 2):
            img(os.path.join(chairs, f"{i:05d}_img{t}.ppm"))
        RD.write_flo(os.path.join(chairs, f"{i:05d}_flow.flo"),
                     rng.randn(h, w, 2).astype(np.float32))
    with open(os.path.join(root, "chairs_split.txt"), "w") as f:
        f.write("1\n1\n2\n")
    things = os.path.join(root, "FlyingThings3D")
    for seq in ("A/0000", "B/0001"):
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            for i in range(3):
                img(os.path.join(things, dstype, "TRAIN", seq, "left", f"{i:04d}.png"))
        for direction in ("into_future", "into_past"):
            d = os.path.join(things, "optical_flow", "TRAIN", seq, direction, "left")
            os.makedirs(d, exist_ok=True)
            for i in range(3):
                _write_pfm(os.path.join(d, f"OpticalFlowInto_{i:04d}.pfm"),
                           rng.randn(h, w, 3).astype(np.float32))
    for dstype in ("clean", "final"):
        for i in (1, 2, 3):
            img(os.path.join(root, "Sintel", "training", dstype, "alley_1",
                             f"frame_{i:04d}.png"))
    os.makedirs(os.path.join(root, "Sintel", "training", "flow", "alley_1"))
    for i in (1, 2):
        RD.write_flo(os.path.join(root, "Sintel", "training", "flow", "alley_1",
                                  f"frame_{i:04d}.flo"), rng.randn(h, w, 2).astype(np.float32))
    os.makedirs(os.path.join(root, "KITTI", "training", "flow_occ"))
    for i in ("000000", "000001"):
        for t in ("10", "11"):
            img(os.path.join(root, "KITTI", "training", "image_2", f"{i}_{t}.png"))
        RD.write_kitti_flow(os.path.join(root, "KITTI", "training", "flow_occ", f"{i}_10.png"),
                            rng.randn(h, w, 2).astype(np.float32),
                            rng.rand(h, w) > 0.3)
    os.makedirs(os.path.join(root, "HD1k", "hd1k_flow_gt", "flow_occ"))
    for i in range(3):
        img(os.path.join(root, "HD1k", "hd1k_input", "image_2", f"000000_{i:04d}.png"))
        RD.write_kitti_flow(os.path.join(root, "HD1k", "hd1k_flow_gt", "flow_occ",
                                         f"000000_{i:04d}.png"),
                            rng.randn(h, w, 2).astype(np.float32))
    return {"chairs": chairs, "chairs_split": os.path.join(root, "chairs_split.txt"),
            "things": things, "sintel": os.path.join(root, "Sintel"),
            "kitti": os.path.join(root, "KITTI"), "hd1k": os.path.join(root, "HD1k")}


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raft_data"))
    return root, _data_tree(root, np.random.RandomState(83))


def test_indexers_and_fetch_stage_match_jax(data_tree):
    _, roots = data_tree
    for t_fn, j_fn, args in (
            (T.index_flying_chairs, JT.index_flying_chairs,
             (roots["chairs"], "training", roots["chairs_split"])),
            (T.index_flying_chairs, JT.index_flying_chairs,
             (roots["chairs"], "validation", roots["chairs_split"])),
            (T.index_flying_things, JT.index_flying_things, (roots["things"],)),
            (T.index_flying_things, JT.index_flying_things,
             (roots["things"], "frames_finalpass")),
            (T.index_sintel, JT.index_sintel, (roots["sintel"], "final")),
            (T.index_kitti, JT.index_kitti, (roots["kitti"],)),
            (T.index_hd1k, JT.index_hd1k, (roots["hd1k"],))):
        got, want = t_fn(*args), j_fn(*args)
        assert got and got == want, t_fn.__name__
    for stage in ("chairs", "things", "sintel", "kitti"):
        got = T.fetch_stage(stage, (32, 48), roots, seed=3)
        want = JT.fetch_stage(stage, (32, 48), roots, seed=3)
        assert [e for e, _ in got] == [e for e, _ in want]
        for (_, ta), (_, ja) in zip(got, want):
            assert type(ta).__name__ == type(ja).__name__
            assert {k: v for k, v in vars(ta).items() if k != "rng"} == \
                   {k: v for k, v in vars(ja).items() if k != "rng"}
    with pytest.raises(ValueError, match="unknown stage"):
        T.fetch_stage("nope", (32, 48), {})


def test_batch_iterator_matches_jax(data_tree):
    """Three batches over the 'sintel' stage (dense and sparse augmentors,
    FlyingThings, Sintel, KITTI and HD1K entries): bit-equal NHWC stacks."""
    _, roots = data_tree
    got_it = T.batch_iterator(T.fetch_stage("sintel", (32, 48), roots, seed=3), 4, seed=9)
    want_it = JT.batch_iterator(JT.fetch_stage("sintel", (32, 48), roots, seed=3), 4, seed=9)
    for _ in range(3):
        got, want = next(got_it), next(want_it)
        assert got[0].shape == (4, 32, 48, 3) and got[3].shape == (4, 32, 48)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_trainer_cli_chains_stages(data_tree, tmp_path, monkeypatch, capsys):
    """--stage chairs with --validation chairs, its .ckpt restored into
    --stage things under --mixed_precision, and a reference .pth restored
    into --stage kitti with --alt_corr, all on the CPU; without --cpu the
    command raises where torch sees no card."""
    root, _ = data_tree
    monkeypatch.chdir(tmp_path)
    common = ["--num_steps", "2", "--batch_size", "1", "--image_size", "32", "48",
              "--iters", "2", "--data_root", root, "--cpu"]
    out = T.main(["--stage", "chairs", "--name", "stage1", "--validation", "chairs",
                  "--val_freq", "1"] + common)
    assert out["checkpoint"] == "checkpoints/stage1.ckpt" and len(out["step_seconds"]) == 2
    for f in ("1_stage1.ckpt", "2_stage1.ckpt", "stage1.ckpt"):
        assert (tmp_path / "checkpoints" / f).exists()
    text = capsys.readouterr().out
    assert "Training with 2 image pairs" in text and "'epe'" in text
    sd = torch.load(tmp_path / "checkpoints" / "stage1.ckpt", weights_only=True)
    fresh = R.init_raft(generator=torch.Generator().manual_seed(1234))
    moved = [k for k, v in fresh.state_dict().items() if not torch.equal(v, sd[k])]
    assert any("running_var" in k for k in moved)  # chairs trains BN

    T.main(["--stage", "things", "--name", "stage2", "--mixed_precision",
            "--restore_ckpt", str(tmp_path / "checkpoints" / "stage1.ckpt")] + common)
    sd2 = torch.load(tmp_path / "checkpoints" / "stage2.ckpt", weights_only=True)
    for k, v in sd2.items():
        if "running" in k:  # things freezes BN
            assert torch.equal(v, sd[k]), k
    assert "Training with 16 image pairs" in capsys.readouterr().out

    ref = load_jax_params(R.init_raft(), JR.init_raft(jax.random.PRNGKey(4)))
    torch.save({"module." + k: v for k, v in _reference_state(ref).items()},
               str(tmp_path / "raft-things.pth"))
    T.main(["--stage", "kitti", "--name", "stage3", "--alt_corr",
            "--restore_ckpt", str(tmp_path / "raft-things.pth")] + common)
    assert (tmp_path / "checkpoints" / "stage3.ckpt").exists()

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.main(["--stage", "chairs", "--num_steps", "1", "--data_root", root])
