"""One frame split by rows over an 'sp' mesh of CPU devices
(vtoonify_tpu_torch/parallel/spatial.py, `make_spatial_mesh`,
`ToonifyPipeline(mesh=make_spatial_mesh(...))`, `style_transfer --sp`)
against the same ops and graph without a mesh, and against the JAX package.

Tolerances:
* each sharded op in float64 against the op on the whole frame, at 2, 3, 4
  and 8 slabs, on heights that do not split evenly (5 rows over 8 slabs
  leaves three empty): 1e-12 relative L2. A missed halo row or a padding
  applied at a slab edge shows as O(1); rounding as 1e-16;
* the kernel wrappers refuse float64, so the wrapper path on slabs (B1, B1
  with B4, B2, B3) runs in float32: 1e-6 of the output's largest value;
* the tiny frame graph in float32 on one 64 x 64 frame (as
  tests/test_sharding.py runs JAX's spatial partitioning): the image out of
  `vtoonify_apply` within 1e-5 relative L2 and 1e-4 on every output row of
  the port without a mesh (the bound per row keeps a halo missed in a few
  rows from hiding in the mean);
* uint8 output of the pipeline over 8 CPU slabs within 1 LSB (mean 0.05) of
  JAX's float32 frame_graph (float32 rounding may move a value across one
  quantization step, as in tests/test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_models import _vtoonify_pair, bisenet_pair  # noqa: F401
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.pipeline import toonify as JT
from vtoonify_tpu_torch.cli import style_transfer as cli
from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops import interp as I
from vtoonify_tpu_torch.ops import kernels as K
from vtoonify_tpu_torch.ops import upfirdn2d as U
from vtoonify_tpu_torch.parallel import mesh as M
from vtoonify_tpu_torch.parallel import spatial as S
from vtoonify_tpu_torch.pipeline import toonify as T

SLABS = (2, 3, 4, 8)
HEIGHTS = (5, 13, 16)  # 5 over 8 slabs: three empty; 13: uneven everywhere


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _whole(y):
    return y.parts[0] if isinstance(y, S.Replicated) else S.gather(y)


def _t(g, *shape, dtype=torch.float64):
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _conv(g, cin, cout, k, bias=True):
    p = L.Conv2dTorch(cin, cout, k, bias=bias, generator=g)
    return p.double()


def _fir(x, k2d, up, down, pad):
    if isinstance(x, S.RowSharded):
        return U.upfirdn2d_rows(x, k2d, up, down, pad, fir=K.upfirdn2d_plain)
    return K.upfirdn2d_plain(x, k2d, up, down, pad)


def _b1(x, w, s, d, b, up=False):
    def conv(t):
        y = K.modconv3x3_plain(t, w, s, d, b)
        return K.depth_to_space2_plain(y, phase_minor=True) if up else y

    return S.same_conv3x3(x, conv, up) if isinstance(x, S.RowSharded) else conv(x)


def _float64_ops(g, h):
    """(name, fn) pairs: each fn takes the whole (2, 6, h, 11) input or its
    slabs. The conv forms of the frame graph (same 3x3, dilation 4, stride 2
    with 3x3, 7x7 and 1x1 windows, 1x1, the fusion's two-operand conv,
    equal_conv2d and conv_layer with a dilation), B1's and B3's plain
    versions, both bilinear modes, nearest both ways, max_pool, the global
    pool and instance_norm_2d."""
    c3, c7, c1, cc = _conv(g, 6, 5, 3), _conv(g, 6, 5, 7, False), _conv(g, 6, 5, 1), _conv(g, 12, 4, 3)
    eq = L.EqualConv2d(6, 5, 3, generator=g).double()
    with torch.no_grad():
        eq.bias.normal_(generator=g)
    cl = L.ConvLayer(6, 5, 3, bias=False, activate=False, generator=g).double()
    k4 = torch.outer(*[U.make_kernel([1, 3, 3, 1])] * 2)
    k6 = torch.randn((6, 1), generator=g)
    wh = _t(g, 3, 3, 6, 5)
    wu = L._fused_upsample_weight(wh, (1, 3, 3, 1))
    s, d, b = _t(g, 2, 6).abs() + 0.5, _t(g, 2, 5).abs() + 0.5, _t(g, 5)
    d4, b4 = d.repeat_interleave(4, 1), b.repeat_interleave(4)
    return [
        ("conv3x3", lambda x: L.conv2d_torch(c3, x, padding=1)),
        ("conv3x3_dilation4", lambda x: L.conv2d_torch(c3, x, padding=4, dilation=4)),
        ("conv3x3_stride2", lambda x: L.conv2d_torch(c3, x, stride=2, padding=1)),
        ("conv7x7_stride2", lambda x: L.conv2d_torch(c7, x, stride=2, padding=3)),
        ("conv1x1_stride2", lambda x: L.conv2d_torch(c1, x, stride=2)),
        ("conv1x1", lambda x: L.conv2d_torch(c1, x)),
        ("conv_cat2", lambda x: L.conv2d_torch_cat2(cc, x, 2.0 * x, padding=1)),
        ("equal_conv2d_dilation2", lambda x: L.equal_conv2d(eq, x, padding=2, dilation=2)),
        ("conv_layer_dilation4", lambda x: L.conv_layer(cl, x, 3, activate=False, dilation=4)),
        ("b1_plain", lambda x: _b1(x, wh, s, d, b)),
        ("b1_plain_up_b4", lambda x: _b1(x, wu, s, d4, b4, up=True)),
        ("b3_plain_upsample_2x", lambda x: _fir(x, k4 * 4, (2, 2), (1, 1), (2, 1, 2, 1))),
        ("b3_plain_blur", lambda x: _fir(x, k4, (1, 1), (1, 1), (2, 1, 2, 1))),
        ("b3_plain_down", lambda x: _fir(x, k4, (1, 1), (2, 2), (1, 1, 1, 1))),
        ("b3_plain_y_up_6tap", lambda x: _fir(x, k6, (1, 2), (1, 1), (0, 0, 3, 2))),
        ("bilinear_x2", lambda x: I.resize_bilinear(x, (2 * h, 23))),
        ("bilinear_corners_x8", lambda x: I.resize_bilinear(x, (8 * h, 40), align_corners=True)),
        ("bilinear_corners_down", lambda x: I.resize_bilinear(x, (h // 2 + 1, 7),
                                                              align_corners=True)),
        ("nearest_x2", lambda x: I.resize_nearest(x, (2 * h, 22))),
        ("nearest_half", lambda x: I.resize_nearest(x, (max(h // 2, 1), 5))),
        ("nearest_x3_plus_1", lambda x: I.resize_nearest(x, (3 * h + 1, 11))),
        ("max_pool", lambda x: I.max_pool(x, 3, stride=2, padding=1)),
        ("global_pool", lambda x: I.adaptive_avg_pool(x, 1)),
        ("instance_norm", lambda x: L.instance_norm_2d(x)),
    ]


_OP_NAMES = [name for name, _ in _float64_ops(torch.Generator().manual_seed(0), 8)]


@pytest.mark.parametrize("name", _OP_NAMES)
def test_sharded_op_float64_matches_whole_frame(name):
    for h in HEIGHTS:
        g = torch.Generator().manual_seed(h)
        fn = dict(_float64_ops(g, h))[name]
        x = _t(g, 2, 6, h, 11) + 0.3
        want = fn(x)
        for n in SLABS:
            got = _whole(fn(S.shard_rows(x, ["cpu"] * n)))
            assert got.shape == want.shape, (name, h, n)
            assert _rel(got, want) <= 1e-12, (name, h, n, _rel(got, want))


_WINDOWED = [n for n in _OP_NAMES if n.startswith(("conv", "equal", "b1", "b3", "max"))]


@pytest.mark.parametrize("name", _WINDOWED)
def test_one_slab_runs_the_whole_frame_op(name):
    """On a mesh of one slab a conv, a pool, B1 and B3 gather no row and pad
    only at the frame's edges, as on the whole frame: the same call, bit for
    bit."""
    g = torch.Generator().manual_seed(3)
    fn = dict(_float64_ops(g, 13))[name]
    x = _t(g, 2, 6, 13, 11)
    assert torch.equal(_whole(fn(S.shard_rows(x, ["cpu"]))), fn(x))


def _wrapper_cases(g):
    """modulated_conv2d through B1 (folded and per-sample styles, plain and
    x2 up with B4), to_rgb with its B3 skip upsample, upsample_2x, conv_layer
    with B2 (and its downsampling blur), ada_res_block with its instance
    norms, in float32."""
    sc = L.StyledConv(6, 5, 3, 16, generator=g)
    up = L.StyledConv(6, 5, 3, 16, generator=g)
    rgb = L.ToRGB(6, 16, generator=g)
    act = L.ConvLayer(6, 5, 3, generator=g)
    down = L.ConvLayer(6, 5, 3, generator=g)
    ada = L.AdaResBlock(6, 16, generator=g)
    for m in (sc, up, act, down):
        with torch.no_grad():
            for p in m.parameters():
                if p.ndim == 1:
                    p.normal_(generator=g)
    s1, s2 = torch.randn((1, 16), generator=g), torch.randn((2, 16), generator=g)
    k = L._blur_1d(L.BLUR_KERNEL)
    return {
        "styled_conv_folded": lambda x, skip: L.styled_conv(sc, x, s1),
        "styled_conv_per_sample": lambda x, skip: L.styled_conv(sc, x, s2),
        "styled_conv_up_folded": lambda x, skip: L.styled_conv(up, x, s1, upsample=True),
        "styled_conv_up_per_sample": lambda x, skip: L.styled_conv(up, x, s2, upsample=True),
        "to_rgb_skip": lambda x, skip: L.to_rgb(rgb, x, s1, skip),
        "upsample_2x": lambda x, skip: U.upsample_2x(x.contiguous(), k),
        "conv_layer_b2": lambda x, skip: L.conv_layer(act, x, 3, dilation=2),
        "conv_layer_downsample": lambda x, skip: L.conv_layer(down, x, 3, downsample=True),
        "ada_res_block_dilation4": lambda x, skip: L.ada_res_block(ada, x, s2, 0.5, dilation=4),
    }


@pytest.mark.parametrize("name", list(_wrapper_cases(torch.Generator().manual_seed(0))))
def test_sharded_wrappers_float32_match_whole_frame(name):
    """The kernel wrappers' path on slabs (their plain versions on the CPU),
    float32, 1e-6 of the output's largest value."""
    for h in (6, 13):
        g = torch.Generator().manual_seed(h)
        fn = _wrapper_cases(g)[name]
        x = torch.randn((2, 6, h, 10), generator=g)
        skip = torch.randn((2, 3, h // 2, 5), generator=g)
        if name == "to_rgb_skip":
            x = torch.randn((2, 6, 2 * (h // 2), 10), generator=g)
        want = fn(x, skip)
        for n in SLABS:
            got = _whole(fn(S.shard_rows(x, ["cpu"] * n), S.shard_rows(skip, ["cpu"] * n)))
            assert got.shape == want.shape, (name, h, n)
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= 1e-6, (name, h, n, err)


def test_no_sharded_form_raises_and_slabs_stay_on_their_mesh():
    """An op with no row-sharded form, a concat along the rows, a whole-
    height operand against slabs and a move off the mesh raise rather than
    compute on a slab as if it were the frame."""
    x = S.shard_rows(torch.randn(1, 2, 8, 4), ["cpu"] * 2)
    for fn in (lambda: F.avg_pool2d(x, 2), lambda: torch.cat([x, x], dim=2),
               lambda: x + torch.randn(1, 2, 8, 4), lambda: x.to("cpu"),
               lambda: I.adaptive_avg_pool(x, 2)):
        with pytest.raises((TypeError, ValueError)):
            fn()
    y = x * torch.randn(1, 2, 1, 4) + 1.0
    assert isinstance(y, S.RowSharded) and y.shape == (1, 2, 8, 4)


def test_spatial_mesh_helpers():
    """make_spatial_mesh takes every visible card by default and raises
    without one; shard_spatial gives the rows of each device (the last ones
    none when there are fewer rows than devices); a spatial mesh splits no
    batch, and a pipeline whose device is not the mesh's first is
    refused."""
    mesh = M.make_spatial_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {"sp": 3} and mesh.axis == "sp"
    assert M.shard_spatial(mesh, 8) == [slice(0, 3), slice(3, 6), slice(6, 8)]
    assert M.shard_spatial(M.make_spatial_mesh(devices=["cpu"] * 8), 4) == (
        [slice(i, i + 1) for i in range(4)] + [slice(4, 4)] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_spatial_mesh()
    with pytest.raises(ValueError, match="splits rows"):
        M.shard_batch(mesh, 3)
    with pytest.raises(ValueError, match="not the mesh's first"):
        T.ToonifyPipeline(None, None, None, mesh=M.make_spatial_mesh(devices=["cpu"] * 2),
                          device="cuda")


@pytest.fixture(scope="module")
def tiny_d(bisenet_pair):  # noqa: F811
    jcfg, jp, cfg, p = _vtoonify_pair("dualstylegan")
    jbp, bp = bisenet_pair
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    s_w = (rng.randn(1, cfg.n_latent, 512) * 0.5).astype(np.float32)
    return jcfg, jp, cfg, p, jbp, bp, frames, s_w


def test_frame_graph_over_slabs_matches_one_device(tiny_d):
    """The tiny VToonify-D and BiSeNet (weights carried from JAX) on one
    64 x 64 frame over 8, 2 and 3 CPU slabs: the float32 image out of
    vtoonify_apply (before quantization) against the port without a mesh.
    At 8 slabs BiSeNet's 1/32 stage has 4 rows: four slabs own them."""
    _, _, cfg, p, _, bp, frames, s_w = tiny_d
    sw = torch.from_numpy(s_w)
    with torch.inference_mode():
        want = T.stylized_image(p, cfg, bp, torch.from_numpy(frames), sw, 0.5, torch.float32)
        for n in (8, 2, 3):
            S.reset_stats()
            slabs = M.shard_array_spatial(frames, M.make_spatial_mesh(devices=["cpu"] * n))
            got = T.stylized_image(p, cfg, bp, slabs, sw, 0.5, torch.float32)
            assert isinstance(got, S.RowSharded) and got.shape == (1, 3, 256, 256)
            assert S.stats()["halo_copies"] > 0 and S.stats()["reduce_copies"] > 0
            got = S.gather(got)
            row_err = (got - want).abs().amax(dim=(0, 1, 3))
            assert _rel(got, want) <= 1e-5 and row_err.max() <= 1e-4, (
                n, _rel(got, want), row_err.max())


def test_pipeline_over_spatial_mesh_matches_jax(tiny_d):
    """ToonifyPipeline over make_spatial_mesh(devices=["cpu"] * 8), float32:
    the uint8 frame within 1 LSB (mean 0.05) of JAX's frame_graph, packed
    output the same bytes permuted, and process_batch_with_parsing within 1
    LSB of JAX's frame_graph_with_parsing; a batch of 2 frames splits by rows
    too."""
    jcfg, jp, cfg, p, jbp, bp, frames, s_w = tiny_d
    f32 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), t)  # noqa: E731
    ref = np.asarray(jax.jit(JT.frame_graph, static_argnums=(1, 6))(
        f32(jp), jcfg, f32(jbp), jnp.asarray(frames), jnp.asarray(s_w),
        jnp.asarray(0.5, jnp.float32), jnp.float32))
    x_p = np.random.RandomState(5).randn(1, 64, 64, 19).astype(np.float32) * 4
    ref_p = np.asarray(jax.jit(JT.frame_graph_with_parsing, static_argnums=(1, 6))(
        f32(jp), jcfg, jnp.asarray(frames), jnp.asarray(x_p), jnp.asarray(s_w),
        jnp.asarray(0.5, jnp.float32), jnp.float32))
    mesh = M.make_spatial_mesh(devices=["cpu"] * 8)
    sp = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, mesh=mesh, device="cpu")
    packed = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, mesh=mesh, device="cpu",
                               packed_output=True)
    got = sp.process_batch(frames, s_w, 0.5).numpy()
    got_p = sp.process_batch_with_parsing(frames, x_p, s_w, 0.5).numpy()
    assert got.shape == (1, 256, 256, 3) and got.dtype == np.uint8 and ref.std() > 30
    for g, r in ((got, ref), (got_p, ref_p)):
        diff = np.abs(g.astype(np.int32) - r.astype(np.int32))
        assert diff.max() <= 1 and diff.mean() <= 0.05, (diff.max(), diff.mean())
    pk = packed.process_batch(frames, s_w, 0.5).numpy()
    assert pk.shape == (1, 128, 128, 12)
    np.testing.assert_array_equal(packed.unpack_frame(pk[0]), got[0])
    two = np.concatenate([frames, frames[:, ::-1]])
    out2 = sp.process_batch(two, s_w, 0.5).numpy()
    one = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, device="cpu")
    diff = np.abs(out2.astype(np.int32) - one.process_batch(two, s_w, 0.5).numpy())
    assert diff.max() <= 1 and diff.mean() <= 0.05, (diff.max(), diff.mean())


def test_engine_over_a_spatial_mesh():
    """The video engine over a pipeline of two CPU slabs: 5 frames at batch
    2 (the last batch of one frame is not topped up) give the frames of the
    spatial pipeline's process_batch on the same batches bit for bit, and
    those of the engine without a mesh within 1 LSB (float32 sums over
    slabs in another order)."""
    from tests.test_torch_pipeline import _pipe
    from vtoonify_tpu_torch.pipeline import video

    pipe, s_w = _pipe()
    sp = T.ToonifyPipeline(pipe.vt, pipe.vt_cfg, pipe.parsing, dtype=pipe.dtype,
                           mesh=M.make_spatial_mesh(devices=["cpu"] * 2))
    frames = np.random.RandomState(23).randint(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    written = []
    for p in (pipe, sp):
        writer = video.MemoryWriter()
        result = video.toonify_frames(p, ((25.0, f) for f in frames), lambda fps, size: writer,
                                      scale_image=False, batch_size=2, s_w=s_w)
        assert result.frames_written == 5 == len(writer.frames)
        written.append(np.stack(writer.frames))
    want = np.concatenate([sp.process_batch(frames[i:i + 2], s_w, 0.5).numpy()
                           for i in (0, 2, 4)])
    np.testing.assert_array_equal(written[1], want)
    diff = np.abs(written[1].astype(np.int32) - written[0])
    assert diff.max() <= 1 and diff.mean() <= 0.05, (diff.max(), diff.mean())


@pytest.mark.parametrize("extra,message", [
    (["--sp", "2", "--dp", "2"], "--sp and --dp are mutually exclusive"),
    (["--sp", "2"], "--sp 2 but only 0 devices are visible"),
])
def test_cli_sp_refusals(tmp_path, extra, message):
    """As JAX's CLI: --sp with --dp, and --sp with fewer visible cards (none
    with --cpu), exit before anything is loaded."""
    argv = ["--content", str(tmp_path / "face.png"), "--ckpt", str(tmp_path / "vt.pt"),
            "--output_path", str(tmp_path), "--cpu", *extra]
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)
