"""The port's RAFT evaluation (models/raft_data.py, models/raft_eval.py) vs
the JAX package's (CPU, float32).

The flow files round-trip and cross-read with the JAX package's writers and
readers, bit for bit; `forward_interpolate` equal. The validators, the
submissions and the eval command run RAFT at the raft-things widths with
JAX's `init_raft` params (random BN statistics) on synthetic Sintel, KITTI
and FlyingChairs trees of 36 x 52 frames (the padder pads them to 40 x 56:
Sintel's on both sides, KITTI's at the bottom), 2 refinement iterations. Tolerances: the
metrics within 1e-4 absolute of JAX's; the Sintel submission's flows
within 1e-3 absolute; the KITTI submission's 16-bit pngs hold flows on a
1/64 px grid, so theirs within 1e-3 or one grid step where float32 sums in
another order round across a step.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_raft import _randomize_bn, _reference_state
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401
from vtoonify_tpu.models import raft as JR
from vtoonify_tpu.models import raft_data as JRD
from vtoonify_tpu.models import raft_eval as JE
from vtoonify_tpu_torch.convert.from_jax import load_jax_params
from vtoonify_tpu_torch.models import raft as R
from vtoonify_tpu_torch.models import raft_data as RD
from vtoonify_tpu_torch.models import raft_eval as E

METRIC_ATOL, FLOW_ATOL = 1e-4, 1e-3
H, W = 36, 52


@pytest.fixture(scope="module")
def raft_pair():
    jp = _randomize_bn(jax.tree_util.tree_map(np.asarray, JR.init_raft(jax.random.PRNGKey(5))),
                       np.random.RandomState(6))
    return jp, load_jax_params(R.init_raft(), jp)


def test_flow_files_round_trip_and_cross_read(tmp_path):
    rng = np.random.RandomState(70)
    flow = (rng.randn(12, 17, 2) * 20).astype(np.float32)
    RD.write_flo(str(tmp_path / "port.flo"), flow)
    JRD.write_flo(str(tmp_path / "jax.flo"), flow)
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "jax.flo").read_bytes()
    for name in ("port.flo", "jax.flo"):
        np.testing.assert_array_equal(RD.read_flo(str(tmp_path / name)), flow)
        np.testing.assert_array_equal(JRD.read_flo(str(tmp_path / name)), flow)
        got, valid = RD.read_flow_file(str(tmp_path / name))
        assert valid is None
        np.testing.assert_array_equal(got, flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        RD.read_flo(str(tmp_path / "bad.flo"))

    valid = rng.rand(12, 17) > 0.3
    RD.write_kitti_flow(str(tmp_path / "port.png"), flow, valid)
    JRD.write_kitti_flow(str(tmp_path / "jax.png"), flow, valid)
    RD.write_kitti_flow(str(tmp_path / "dense.png"), flow)
    for name in ("port.png", "jax.png"):
        f, v = RD.read_kitti_flow(str(tmp_path / name))
        jf, jv = JRD.read_kitti_flow(str(tmp_path / name))
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(v, valid)
        np.testing.assert_array_equal(jv, valid)
        assert np.abs(f - flow).max() <= 0.5 / 64 + 1e-6  # the 1/64 px grid
        g, gv = RD.read_flow_file(str(tmp_path / name))
        np.testing.assert_array_equal(g, f)
        np.testing.assert_array_equal(gv, v)
    assert RD.read_kitti_flow(str(tmp_path / "dense.png"))[1].all()

    data = rng.randn(12, 17, 3).astype(np.float32)
    for header, scale, dtype, arr in ((b"PF", b"-1.0", "<f4", data),
                                      (b"PF", b"1.0", ">f4", data),
                                      (b"Pf", b"-1.0", "<f4", data[..., 0])):
        path = str(tmp_path / "flow.pfm")
        with open(path, "wb") as f:
            f.write(header + b"\n17 12\n" + scale + b"\n")
            f.write(np.flipud(arr).astype(dtype).tobytes())
        np.testing.assert_array_equal(RD.read_pfm(path), arr)
        np.testing.assert_array_equal(RD.read_pfm(path), JRD.read_pfm(path))
        if header == b"PF":  # FlyingThings3D's flow: the third channel dropped
            got, valid = RD.read_flow_file(path)
            assert valid is None
            np.testing.assert_array_equal(got, arr[..., :2])
    with pytest.raises(ValueError, match="unknown flow format"):
        RD.read_flow_file(str(tmp_path / "flow.bin"))


def test_forward_interpolate_matches_jax():
    rng = np.random.RandomState(71)
    flow = (rng.randn(9, 14, 2) * 3).astype(np.float32)
    flow[0, :4] = 50.0  # pushed off the grid: dropped before the fill
    got = RD.forward_interpolate(flow)
    assert got.shape == (9, 14, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JRD.forward_interpolate(flow))


def _write_trees(root, rng):
    """Sintel (training with flow, test clean and final, two scenes),
    KITTI (training and testing) and FlyingChairs (with a split file)."""
    import cv2

    def img(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        base = rng.randint(0, 255, (H + 6, W + 6, 3), np.uint8)
        cv2.imwrite(path, base[3:3 + H, 3:3 + W])

    for scene in ("alley_1", "cave_2"):
        for i in (1, 2, 3):
            img(os.path.join(root, "Sintel", "training", "clean", scene, f"frame_{i:04d}.png"))
            for dstype in ("clean", "final"):
                img(os.path.join(root, "Sintel", "test", dstype, scene, f"frame_{i:04d}.png"))
        d = os.path.join(root, "Sintel", "training", "flow", scene)
        os.makedirs(d)
        for i in (1, 2):
            RD.write_flo(os.path.join(d, f"frame_{i:04d}.flo"),
                         (rng.randn(H, W, 2) * 2).astype(np.float32))
    for split in ("training", "testing"):
        for i in ("000000", "000001"):
            for t in ("10", "11"):
                img(os.path.join(root, "KITTI", split, "image_2", f"{i}_{t}.png"))
    os.makedirs(os.path.join(root, "KITTI", "training", "flow_occ"))
    for i in ("000000", "000001"):
        RD.write_kitti_flow(os.path.join(root, "KITTI", "training", "flow_occ", f"{i}_10.png"),
                            (rng.randn(H, W, 2) * 2).astype(np.float32), rng.rand(H, W) > 0.4)
    chairs = os.path.join(root, "FlyingChairs_release", "data")
    for i in (1, 2, 3):
        for t in (1, 2):
            img(os.path.join(chairs, f"{i:05d}_img{t}.ppm"))
        RD.write_flo(os.path.join(chairs, f"{i:05d}_flow.flo"),
                     (rng.randn(H, W, 2) * 2).astype(np.float32))
    with open(os.path.join(root, "chairs_split.txt"), "w") as f:
        f.write("1\n2\n2\n")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raft_eval"))
    _write_trees(root, np.random.RandomState(72))
    return root


def _close_metrics(got, want):
    assert set(got) == set(want) == {"epe", "1px", "3px", "5px"}
    for k, v in want.items():
        assert abs(got[k] - v) <= METRIC_ATOL, (k, got[k], v)


def test_validators_match_jax(raft_pair, trees):
    jp, m = raft_pair
    root = trees
    for port, jax_fn, args in (
            (RD.validate_sintel, JRD.validate_sintel, (os.path.join(root, "Sintel"),)),
            (RD.validate_kitti, JRD.validate_kitti, (os.path.join(root, "KITTI"),))):
        _close_metrics(port(m, *args, iters=2), jax_fn(jp, *args, iters=2))
    chairs = os.path.join(root, "FlyingChairs_release", "data")
    split = os.path.join(root, "chairs_split.txt")
    _close_metrics(RD.validate_chairs(m, chairs, split_file=split, iters=2),
                   JRD.validate_chairs(jp, chairs, split_file=split, iters=2))
    # evaluate_pairs and end_point_error on arrays, masked and not
    rng = np.random.RandomState(73)
    im1 = rng.randint(0, 255, (1, 40, 64, 3)).astype(np.float32)
    im2 = np.roll(im1, 2, axis=2)
    gt = (rng.randn(1, 40, 64, 2) * 2).astype(np.float32)
    _close_metrics(E.evaluate_pairs(m, [(im1, im2, gt)], iters=2),
                   JE.evaluate_pairs(jp, [(im1, im2, gt)], iters=2))
    valid = rng.rand(1, 40, 64) > 0.5
    pred = gt + rng.randn(*gt.shape).astype(np.float32) * 3
    _close_metrics(E.end_point_error(torch.from_numpy(np.moveaxis(pred, -1, 1)),
                                     torch.from_numpy(np.moveaxis(gt, -1, 1)),
                                     torch.from_numpy(valid)),
                   JE.end_point_error(pred, gt, valid))


def _rel_files(out_dir):
    return sorted(os.path.relpath(os.path.join(d, f), out_dir)
                  for d, _, files in os.walk(out_dir) for f in files)


def test_submissions_match_jax(raft_pair, trees, tmp_path):
    jp, m = raft_pair
    root = trees
    for warm in (True, False):
        got = RD.create_sintel_submission(m, os.path.join(root, "Sintel"),
                                          str(tmp_path / f"port_{warm}"), iters=2,
                                          warm_start=warm)
        want = JRD.create_sintel_submission(jp, os.path.join(root, "Sintel"),
                                            str(tmp_path / f"jax_{warm}"), iters=2,
                                            warm_start=warm)
        assert len(got) == len(want) == 8  # 2 passes x 2 scenes x 2 pairs
        assert _rel_files(tmp_path / f"port_{warm}") == _rel_files(tmp_path / f"jax_{warm}")
        for g, w in zip(got, want):
            a, b = RD.read_flo(g), RD.read_flo(w)
            assert a.shape == (H, W, 2)
            np.testing.assert_allclose(a, b, atol=FLOW_ATOL, rtol=0)
    # warm start feeds the previous frame's flow into the second pair only
    cold = RD.read_flo(str(tmp_path / "port_False" / "clean" / "alley_1" / "frame0002.flo"))
    warm = RD.read_flo(str(tmp_path / "port_True" / "clean" / "alley_1" / "frame0002.flo"))
    assert np.abs(cold - warm).max() > 1e-3
    got = RD.create_kitti_submission(m, os.path.join(root, "KITTI"), str(tmp_path / "pk"),
                                     iters=2)
    want = JRD.create_kitti_submission(jp, os.path.join(root, "KITTI"), str(tmp_path / "jk"),
                                       iters=2)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "000000_10.png", "000001_10.png"]
    for g, w in zip(got, want):
        (a, av), (b, bv) = RD.read_kitti_flow(g), RD.read_kitti_flow(w)
        assert a.shape == (H, W, 2) and av.all() and bv.all()
        d = np.abs(a - b)
        assert np.all((d <= FLOW_ATOL) | (np.abs(d - 1 / 64) <= FLOW_ATOL))
        assert np.mean(d > FLOW_ATOL) <= 1e-3


def test_eval_cli_matches_jax(raft_pair, trees, tmp_path, capsys):
    """vtoonify-raft-eval on a reference-format .pth ('module.' keys, as
    raft-things.pth): the Sintel validation equal to the JAX command's, the
    submission with --warm_start, the refusals; without --cpu it raises
    where torch sees no card."""
    import json

    _, m = raft_pair
    ckpt = str(tmp_path / "raft-things.pth")
    torch.save({"module." + k: v for k, v in _reference_state(m).items()}, ckpt)
    common = ["--model", ckpt, "--data_root", trees, "--iters", "2"]
    got = E.main(common + ["--dataset", "sintel", "--cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "dataset": "sintel", **got}
    _close_metrics(got, JE.main(common + ["--dataset", "sintel"]))
    _close_metrics(E.main(common + ["--dataset", "chairs", "--cpu", "--alternate_corr"]),
                   JE.main(common + ["--dataset", "chairs", "--alternate_corr"]))
    out = E.main(common + ["--dataset", "sintel", "--cpu", "--submission",
                           str(tmp_path / "sub"), "--warm_start"])
    assert out == {"files": 8} and len(_rel_files(tmp_path / "sub")) == 8
    assert E.main(common + ["--dataset", "kitti", "--cpu", "--submission",
                            str(tmp_path / "ksub")]) == {"files": 2}
    for bad in (["--dataset", "sintel", "--small"],
                ["--dataset", "chairs", "--submission", str(tmp_path / "x")]):
        with pytest.raises(SystemExit):
            E.main(common + bad + ["--cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            E.main(common + ["--dataset", "sintel"])
