"""The port's RAFT, its loader, the flow visualizer and the parsing-map
smoother vs the JAX package's (CPU, float32).

JAX's `init_raft` params (batch norms given random statistics) are carried
into the port by `load_jax_params`; inputs are numpy-seeded. Tolerances:
the flows and the smoothed maps within 1e-4 relative L2 of JAX's (float32
sums ordered differently through the encoders and the GRU steps); the
lookups within 1e-5; the port's alt lookup against its all-pairs lookup
within JAX's own bounds (tests/test_raft.py: atol 1e-3 on the 1/8 flow,
1e-2 on the upsampled one); the loader's state and the flow images exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401
from vtoonify_tpu.convert import torch_import as JTI
from vtoonify_tpu.models import bisenet as JB
from vtoonify_tpu.models import raft as JR
from vtoonify_tpu.models import raft_data as JRD
from vtoonify_tpu.models import raft_viz as JRV
from vtoonify_tpu.pipeline import smooth_parsing as JSP
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict, load_jax_params
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import raft as R
from vtoonify_tpu_torch.models import raft_data as RD
from vtoonify_tpu_torch.models import raft_viz as RV
from vtoonify_tpu_torch.pipeline import smooth_parsing as SP
from vtoonify_tpu_torch.utils import checkpoint as CK

FLOW_REL_L2 = 1e-4
LOOKUP_REL_L2 = 1e-5


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _randomize_bn(tree, rng):
    if isinstance(tree, dict):
        if "running_var" in tree:
            c = tree["running_var"].shape[0]
            tree.update(weight=(rng.rand(c) + 0.5).astype(np.float32),
                        bias=(rng.randn(c) * 0.1).astype(np.float32),
                        running_mean=(rng.randn(c) * 0.1).astype(np.float32),
                        running_var=(rng.rand(c) + 0.5).astype(np.float32))
        for v in tree.values():
            _randomize_bn(v, rng)
    elif isinstance(tree, list):
        for v in tree:
            _randomize_bn(v, rng)
    return tree


@pytest.fixture(scope="module")
def raft_pair():
    jp = _randomize_bn(jax.tree_util.tree_map(np.asarray, JR.init_raft(jax.random.PRNGKey(0))),
                       np.random.RandomState(1))
    return jp, load_jax_params(R.init_raft(), jp)


@pytest.fixture(scope="module")
def bisenet_pair():
    jp = _randomize_bn(jax.tree_util.tree_map(np.asarray, JB.init_bisenet(jax.random.PRNGKey(2))),
                       np.random.RandomState(3))
    return jp, load_jax_params(B.init_bisenet(), jp)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _image_pair(seed, h=64, w=64):
    rng = np.random.RandomState(seed)
    im1 = rng.randint(0, 256, (2, h, w, 3)).astype(np.float32)
    im2 = np.roll(im1, (3, -2), axis=(1, 2)) + rng.uniform(-8, 8, im1.shape).astype(np.float32)
    return im1, np.clip(im2, 0, 255)


@pytest.mark.parametrize("impl", ["allpairs", "alt"])
def test_raft_apply_matches_jax(raft_pair, impl):
    jp, m = raft_pair
    im1, im2 = _image_pair(4)
    jl, ju = jax.jit(JR.raft_apply, static_argnums=(3, 4))(
        jp, jnp.asarray(im1), jnp.asarray(im2), JR.RAFTConfig(corr_impl=impl), 3)
    with torch.no_grad():
        tl, tu = R.raft_apply(m, _nchw(im1), _nchw(im2), R.RAFTConfig(corr_impl=impl),
                              iters=3)
    assert tl.shape == (2, 2, 8, 8) and tu.shape == (2, 2, 64, 64)
    for got, want in ((tl, jl), (tu, ju)):
        assert _rel(_nhwc(got), np.asarray(want)) <= FLOW_REL_L2
    # a warm start, and the training-mode list of upsampled flows
    init = np.asarray(jl) * 0.5
    jflows = JR.raft_apply(jp, jnp.asarray(im1), jnp.asarray(im2),
                           JR.RAFTConfig(corr_impl=impl), iters=2, test_mode=False,
                           flow_init=jnp.asarray(init))
    with torch.no_grad():
        tflows = R.raft_apply(m, _nchw(im1), _nchw(im2), R.RAFTConfig(corr_impl=impl),
                              iters=2, test_mode=False, flow_init=_nchw(init))
    assert len(tflows) == len(jflows) == 2
    for got, want in zip(tflows, jflows):
        assert _rel(_nhwc(got), np.asarray(want)) <= FLOW_REL_L2


def _lookup_inputs(seed):
    rng = np.random.RandomState(seed)
    b, h, w, c = 2, 16, 24, 32
    f1 = rng.randn(b, h, w, c).astype(np.float32)
    f2 = rng.randn(b, h, w, c).astype(np.float32)
    # coords spread past the borders, into the zero padding
    coords = (rng.uniform(-6, 6, (b, h, w, 2)).astype(np.float32)
              + np.stack(np.meshgrid(np.arange(w), np.arange(h)), axis=-1).astype(np.float32))
    return f1, f2, coords


def test_lookups_match_jax():
    """Both lookups against JAX's directly: the window's channel order (x
    offset on the first window axis) is what convc1's weights see."""
    f1, f2, coords = _lookup_inputs(5)
    want = np.asarray(JR.lookup_corr(JR.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)),
                                     jnp.asarray(coords)))
    want_alt = np.asarray(JR.lookup_corr_alt(jnp.asarray(f1),
                                             JR.build_fmap_pyramid(jnp.asarray(f2)),
                                             jnp.asarray(coords)))
    got = R.lookup_corr(R.build_corr_pyramid(_nchw(f1), _nchw(f2)), _nchw(coords))
    got_alt = R.lookup_corr_alt(_nchw(f1), R.build_fmap_pyramid(_nchw(f2)), _nchw(coords))
    assert got.shape == got_alt.shape == (2, 4 * 81, 16, 24)
    assert _rel(_nhwc(got), want) <= LOOKUP_REL_L2
    assert _rel(_nhwc(got_alt), want_alt) <= LOOKUP_REL_L2


@pytest.mark.parametrize("chunk", [9, 81, 5])  # 5 falls back to a divisor of 81
def test_alt_lookup_matches_allpairs(chunk):
    f1, f2, coords = _lookup_inputs(6)
    want = R.lookup_corr(R.build_corr_pyramid(_nchw(f1), _nchw(f2)), _nchw(coords))
    got = R.lookup_corr_alt(_nchw(f1), R.build_fmap_pyramid(_nchw(f2)), _nchw(coords),
                            offset_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=1e-4)


def test_raft_alt_matches_allpairs(raft_pair):
    _, m = raft_pair
    im1, im2 = _image_pair(7, 64, 96)
    with torch.no_grad():
        lr_a, up_a = R.raft_apply(m, _nchw(im1), _nchw(im2), R.RAFTConfig(), iters=4)
        lr_b, up_b = R.raft_apply(m, _nchw(im1), _nchw(im2),
                                  R.RAFTConfig(corr_impl="alt"), iters=4)
    np.testing.assert_allclose(lr_b.numpy(), lr_a.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(up_b.numpy(), up_a.numpy(), atol=1e-2, rtol=1e-3)


def test_raft_refuses_an_unknown_corr_impl(raft_pair):
    _, m = raft_pair
    x = torch.zeros((1, 3, 32, 32))
    with pytest.raises(ValueError, match="corr_impl"):
        R.raft_apply(m, x, x, R.RAFTConfig(corr_impl="cuda"), iters=1)


def _reference_state(module):
    """A port RAFT's state under the reference RAFT's keys (the inverse of
    convert_raft's key map), with the BatchNorms' counters."""
    sd = {}
    for k, v in module.state_dict().items():
        parts = k.split(".")
        if parts[0] in ("fnet", "cnet"):
            if parts[1] == "layers":
                parts[1:3] = [f"layer{int(parts[2]) + 1}"]
                parts = [p for p in parts if p != "norms"]
                parts = ["downsample.0" if p == "down" else p for p in parts]
            elif parts[1] == "bn1":
                parts[1] = "norm1"
        else:
            sub = {"enc": "encoder", "gru": "gru", "flow_head": "flow_head",
                   "mask": "mask"}[parts[1]]
            parts[0:2] = ["update_block", sub]
            if sub == "mask":
                parts[2] = {"conv1": "0", "conv2": "2"}[parts[2]]
        key = ".".join(parts)
        sd[key] = v.clone()
        if key.endswith("running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(3)
    return sd


@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_reference_raft_matches_jax(raft_pair, tmp_path, prefix):
    _, m = raft_pair
    sd = {prefix + k: v for k, v in _reference_state(m).items()}
    path = tmp_path / "raft-things.pth"
    torch.save(sd, str(path))
    loaded = CK.load_reference_raft(str(path))
    want = jax_state_dict(JTI.convert_raft({k: v.numpy() for k, v in sd.items()}))
    got = loaded.state_dict()
    assert got.keys() == want.keys() == m.state_dict().keys()
    for k, v in got.items():
        assert torch.equal(v, want[k]) and torch.equal(v, m.state_dict()[k]), k


def test_smooth_parsing_matches_jax(raft_pair, bisenet_pair):
    """4 frames of 32 px, window 1, 2 RAFT iterations: the port's maps
    within 1e-4 relative L2 of JAX's, with both corr impls."""
    jr, r = raft_pair
    jb, b = bisenet_pair
    rng = np.random.RandomState(8)
    base = rng.randint(0, 256, (40, 40, 3)).astype(np.uint8)
    frames = np.stack([base[i:i + 32, 2 * i:2 * i + 32] for i in range(4)])
    want = JSP.smooth_video_parsing_maps(jr, jb, frames, window=1, iters=2)
    got = SP.smooth_video_parsing_maps(r, b, frames, window=1, iters=2, device="cpu")
    assert got.shape == want.shape == (4, 32, 32, 19) and got.dtype == np.float32
    assert _rel(got, np.asarray(want)) <= FLOW_REL_L2
    got_alt = SP.smooth_video_parsing_maps(r, b, frames, window=1, iters=2,
                                           alt_corr=True, device="cpu")
    assert _rel(got_alt, np.asarray(want)) <= FLOW_REL_L2


def test_warp_and_padding_match_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 20, 27, 5).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 20, 27, 2)).astype(np.float32)
    jw, jm = JSP.warp_backward(jnp.asarray(x), jnp.asarray(flow))
    tw, tm = SP.warp_backward(_nchw(x), _nchw(flow))
    np.testing.assert_allclose(_nhwc(tw), np.asarray(jw), atol=1e-5)
    np.testing.assert_array_equal(_nhwc(tm), np.asarray(jm))
    jp, jpads = JSP._pad_div8(jnp.asarray(x))
    tp, tpads = SP._pad_div8(_nchw(x))
    assert tpads == jpads
    np.testing.assert_array_equal(_nhwc(tp), np.asarray(jp))
    np.testing.assert_array_equal(_nhwc(SP._unpad(tp, tpads)), x)
    for mode in ("sintel", "kitti"):
        jpad = JRD.InputPadder(x.shape, mode=mode)
        tpad = RD.InputPadder(_nchw(x).shape, mode=mode)
        np.testing.assert_array_equal(_nhwc(tpad.pad(_nchw(x))),
                                      np.asarray(jpad.pad(jnp.asarray(x))))
        np.testing.assert_array_equal(_nhwc(tpad.unpad(tpad.pad(_nchw(x)))), x)


def test_flow_to_image_matches_jax():
    rng = np.random.RandomState(10)
    flow = rng.randn(24, 40, 2).astype(np.float32) * 5
    flow[0, 0] = 0.0
    for kw in ({}, {"bgr": True}, {"clip_flow": 3.0}):
        np.testing.assert_array_equal(RV.flow_to_image(flow, **kw),
                                      JRV.flow_to_image(flow, **kw))
    np.testing.assert_array_equal(RV.make_colorwheel(), JRV.make_colorwheel())
    u, v = rng.uniform(-1.5, 1.5, (2, 16, 16))  # past radius 1: the dimmed arc
    np.testing.assert_array_equal(RV.colorize_flow_uv(u, v), JRV.colorize_flow_uv(u, v))


def test_demo_directory_and_cli(raft_pair, tmp_path):
    """raft_viz.main --cpu over three frames: two [frame; flow] stacks, the
    first equal to demo_directory's on the same module."""
    from PIL import Image

    _, m = raft_pair
    rng = np.random.RandomState(11)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    base = rng.randint(0, 256, (68, 84, 3)).astype(np.uint8)
    for i in range(3):  # 60x76: the padder pads to 64x80
        Image.fromarray(base[i:i + 60, 2 * i:2 * i + 76]).save(frames_dir / f"{i:03d}.png")
    torch.save(_reference_state(m), str(tmp_path / "raft.pth"))
    RV.main(["--model", str(tmp_path / "raft.pth"), "--path", str(frames_dir),
             "--out", str(tmp_path / "cli"), "--iters", "2", "--cpu"])
    written = RV.demo_directory(m, str(frames_dir), str(tmp_path / "api"), iters=2,
                                device="cpu")
    assert len(written) == 2
    cli0 = np.asarray(Image.open(tmp_path / "cli" / "flow_0000.png"))
    assert cli0.shape == (120, 76, 3)
    np.testing.assert_array_equal(cli0, np.asarray(Image.open(written[0])))
