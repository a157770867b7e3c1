"""Port ops and kernel plain versions vs the JAX package (CPU).

Inputs are made with numpy seeds and fed to both packages; the port is NCHW
where the JAX package is NHWC, so results are transposed before comparing.
Each kernel's plain version (the port's CPU path and its on-card oracle) is
also held to the JAX Pallas kernel it replaces, run in interpret mode as
tests/test_pallas.py runs it. Float32 tolerances are float32 rounding of
differently ordered sums; permutations are compared exactly.
"""

import importlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.nn import layers as JL
from vtoonify_tpu.ops import fused_act as jfa
from vtoonify_tpu.ops import interp as jinterp
from vtoonify_tpu.ops import pallas_kernels as jpk
from vtoonify_tpu_torch.nn import layers
from vtoonify_tpu_torch.ops import fused_act, interp, kernels, upfirdn2d

# vtoonify_tpu.ops re-exports the function under the module's name
jup = importlib.import_module("vtoonify_tpu.ops.upfirdn2d")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


@pytest.mark.parametrize("c", [3, 32])
@pytest.mark.parametrize("kernel,up,down,pad", [
    ([1, 3, 3, 1], 1, 1, (2, 1)),            # blur
    ([1, 3, 3, 1], 2, 1, (2, 1)),            # ToRGB's upsample_2x
    ([1, 3, 3, 1], 1, 2, (1, 1)),            # downsample_2x
    ([1, 2, 1], 2, 2, (-1, 2)),              # negative pad crops
    ([1, 3, 3, 1], (2, 1), (1, 2), (2, 1, 0, -1)),  # per-axis factors, pad4
    ([[1, 2, 1], [2, 4, 0], [1, 0, 3]], 2, 1, (1, 1)),  # non-separable 2-D
])
def test_upfirdn2d_matches_jax(kernel, up, down, pad, c):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, c).astype(np.float32)
    k = upfirdn2d.make_kernel(kernel)
    ref = jup.upfirdn2d(jnp.asarray(x), jup.make_kernel(kernel), up=up,
                        down=down, pad=pad)
    got = upfirdn2d.upfirdn2d(_nchw(x), k, up=up, down=down, pad=pad)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_upsample_2x_and_blur_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 8, 8, 3).astype(np.float32)
    kj, kt = jup.make_kernel([1, 3, 3, 1]), upfirdn2d.make_kernel([1, 3, 3, 1])
    np.testing.assert_allclose(
        _nhwc(upfirdn2d.upsample_2x(_nchw(x), kt)),
        np.asarray(jup.upsample_2x(jnp.asarray(x), kj)), atol=1e-5)
    np.testing.assert_allclose(
        _nhwc(upfirdn2d.blur(_nchw(x), kt, pad=(2, 1), upsample_factor=2)),
        np.asarray(jup.blur(jnp.asarray(x), kj, pad=(2, 1),
                            upsample_factor=2)), atol=1e-5)


@pytest.mark.parametrize("shape,with_bias", [
    ((2, 5, 7, 16), True), ((3, 512), True), ((2, 4, 4, 8), False),
    # the kernel's paths (JAX layout; the port's plane is H*W): planes of a
    # multiple of 8 elements (16-byte bf16 vectors), planes off it (scalar
    # accesses, the port's (2, 7, 5, 3)), and the (N, C) form with C a
    # multiple of 8 and not
    ((2, 4, 4, 16), True), ((2, 5, 3, 7), True), ((4, 24), True),
    ((3, 13), True), ((3, 13), False)])
def test_fused_leaky_relu_matches_jax(shape, with_bias):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32) if with_bias else None
    ref = np.asarray(jfa.fused_leaky_relu(
        jnp.asarray(x), None if b is None else jnp.asarray(b)))
    xt = _nchw(x) if x.ndim == 4 else torch.from_numpy(x)
    got = fused_act.fused_leaky_relu(xt, None if b is None else torch.from_numpy(b))
    got = _nhwc(got) if x.ndim == 4 else got.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("phase_minor", [False, True])
def test_depth_to_space2_matches_jax(phase_minor):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 6, 12).astype(np.float32)
    jfn = JL._depth_to_space2_phase_minor if phase_minor else JL.depth_to_space2
    got = layers.depth_to_space2(_nchw(x), phase_minor=phase_minor)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jfn(jnp.asarray(x))))


@pytest.mark.parametrize("size,align", [
    ((18, 22), False), ((18, 22), True), ((5, 7), False), ((20, 30), False)])
def test_resize_bilinear_matches_jax(size, align):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    ref = jinterp.resize_bilinear(jnp.asarray(x), size, align_corners=align)
    got = interp.resize_bilinear(_nchw(x), size, align_corners=align)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("size", [(4, 5), (9, 11), (18, 22), (7, 3)])
def test_resize_nearest_matches_jax(size):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 10, 4).astype(np.float32)
    ref = jinterp.resize_nearest(jnp.asarray(x), size)
    got = interp.resize_nearest(_nchw(x), size)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


def test_pools_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, 10, 4).astype(np.float32)
    xj, xt = jnp.asarray(x), _nchw(x)
    np.testing.assert_array_equal(
        _nhwc(interp.max_pool(xt, 3, stride=2, padding=1)),
        np.asarray(jinterp.max_pool(xj, 3, stride=2, padding=1)))
    for size in (1, (3, 5)):
        np.testing.assert_allclose(
            _nhwc(interp.adaptive_avg_pool(xt, size)),
            np.asarray(jinterp.adaptive_avg_pool(xj, size)), atol=1e-6)


# ---------------------------------------------------------------------------
# kernel plain versions vs the Pallas kernels they replace (interpret mode)


@pytest.mark.parametrize("path", ["modulated", "folded", "raw"])
def test_modconv3x3_plain_matches_pallas(path):
    rng = np.random.RandomState(7)
    b, h, w_, c, cout = 2, 16, 24, 8, 16
    x = rng.randn(b, h, w_, c).astype(np.float32)
    w = (rng.randn(3, 3, c, cout) * 0.2).astype(np.float32)
    s = (rng.randn(b, c) * 0.5 + 1.0).astype(np.float32)
    d = (rng.randn(b, cout) * 0.1 + 1.0).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    if path != "modulated":
        s = d = None
    if path == "raw":
        bias = None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    ref = jpk.modconv3x3_fused_pallas(j(x), j(w), j(s), j(d), j(bias), rows=8,
                                      interpret=True)
    got = kernels.modconv3x3_plain(_nchw(x), t(w), t(s), t(d), t(bias))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_fused_leaky_relu_plain_matches_pallas():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 8, 16, 128).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    ref = jpk.fused_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(b),
                                      interpret=True)
    got = kernels.fused_leaky_relu_plain(_nchw(x), torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("c", [1, 6])
def test_affine_warp_plain_matches_pallas_channels(c):
    """B5 through its wrapper (the plain version on the CPU) vs
    affine_warp_bilinear_pallas in interpret mode (HIGHEST precision) at one
    channel and at the augment's six, on an output row of 29 px (off the
    kernel's 4-column vector, so its scalar tail path's shape) from a
    rotated, scaled, shifted affine that maps part of the output outside the
    image. 1e-3, as tests/test_torch_train.py holds the two formulations:
    the plain version goes through the normalized grid and back (float32
    roundings of coordinates below 50 px) on N(0, 1) pixels."""
    from vtoonify_tpu.train import augment as JA
    from vtoonify_tpu_torch.train import augment as A

    rng = np.random.RandomState(13)
    n, h, w, ho, wo = 2, 40, 46, 23, 29
    img = rng.randn(n, h, w, c).astype(np.float32)
    theta = np.tile(np.eye(2, 3, dtype=np.float32), (n, 1, 1))
    for i, (a, s, t) in enumerate(((0.3, 1.1, (0.25, -0.3)), (-0.2, 0.8, (-0.4, 0.1)))):
        theta[i, :2, :2] = np.array([[np.cos(a), -np.sin(a)],
                                     [np.sin(a), np.cos(a)]]) * s
        theta[i, :, 2] = t
    coef = np.asarray(JA._pixel_affine_coefs(jnp.asarray(theta), (ho, wo), (h, w)))
    ref = jpk.affine_warp_bilinear_pallas(jnp.asarray(img), jnp.asarray(coef),
                                          (ho, wo), interpret=True)
    coef_t = A._pixel_affine_coefs(torch.from_numpy(theta), (ho, wo), (h, w))
    got = kernels.affine_warp(_nchw(img), coef_t.contiguous(), (ho, wo))
    assert got.shape == (n, c, ho, wo) and got.is_contiguous()
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-3)
    assert (np.asarray(ref) == 0).any()  # some samples fall outside


def test_upfirdn2d_plain_matches_blur_pallas():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    k = jup.make_kernel((1.0, 3.0, 3.0, 1.0))
    ref = jpk.blur_same_pallas(jnp.asarray(x), k, pad=(2, 1), interpret=True)
    kt = upfirdn2d.make_kernel((1.0, 3.0, 3.0, 1.0))
    got = kernels.upfirdn2d_plain(_nchw(x), torch.outer(kt, kt), pad=(2, 1, 2, 1))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def test_depth_to_space2_plain_matches_pallas():
    rng = np.random.RandomState(10)
    x = rng.randn(2, 16, 8, 12).astype(np.float32)
    ref = jpk.depth_to_space2_pallas(jnp.asarray(x), interpret=True)
    got = kernels.depth_to_space2_plain(_nchw(x), phase_minor=False)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    """A CPU tensor takes each wrapper's plain version and never touches a
    launch counter."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(2, 8, 6, 5).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 8, 4).astype(np.float32))
    bias4 = torch.from_numpy(rng.randn(4).astype(np.float32))
    bias8 = torch.from_numpy(rng.randn(8).astype(np.float32))
    k2 = torch.outer(upfirdn2d.make_kernel([1, 3, 3, 1]),
                     upfirdn2d.make_kernel([1, 3, 3, 1]))
    coef = torch.tensor([[0.9, 0.1, 0.3, -0.1, 1.1, -0.2]] * 2)
    kernels.reset_launch_counts()
    pairs = [
        (kernels.modconv3x3(x, w, bias=bias4),
         kernels.modconv3x3_plain(x, w, bias=bias4)),
        (kernels.fused_leaky_relu(x, bias8),
         kernels.fused_leaky_relu_plain(x, bias8)),
        (kernels.upfirdn2d(x, k2, up=(2, 2), pad=(2, 1, 2, 1)),
         kernels.upfirdn2d_plain(x, k2, up=(2, 2), pad=(2, 1, 2, 1))),
        (kernels.depth_to_space2(x, phase_minor=True),
         kernels.depth_to_space2_plain(x, phase_minor=True)),
        (kernels.affine_warp(x, coef, (5, 7)),
         kernels.affine_warp_plain(x, coef, (5, 7))),
    ]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.launch_counts() == {
        "modconv3x3": 0, "fused_leaky_relu": 0, "upfirdn2d": 0,
        "depth_to_space2": 0, "affine_warp": 0}


@pytest.mark.parametrize("name", ["modconv3x3", "fused_leaky_relu", "upfirdn2d",
                                  "depth_to_space2", "affine_warp"])
def test_wrappers_refuse_strided_input_and_return_contiguous(name):
    """The kernels take contiguous operands and write contiguous outputs; on
    the CPU each wrapper holds its caller to the same rule (a channel slice
    is refused, not copied) and its plain version keeps the output layout,
    so a chain of wrappers that runs on the CPU runs on the card."""
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(2, 8, 10, 9).astype(np.float32))
    k2 = torch.outer(upfirdn2d.make_kernel([1, 3, 3, 1]),
                     upfirdn2d.make_kernel([1, 3, 3, 1]))
    w = torch.from_numpy(rng.randn(3, 3, 4, 4).astype(np.float32))
    coef = torch.tensor([[0.6, 0.1, 0.3, -0.1, 0.5, -0.2]] * 2)
    call = {
        "modconv3x3": lambda t: kernels.modconv3x3(t, w),
        "fused_leaky_relu": lambda t: kernels.fused_leaky_relu(t),
        "upfirdn2d": lambda t: kernels.upfirdn2d(t, k2, down=(2, 2),
                                                 pad=(1, 1, 1, 1)),
        "depth_to_space2": lambda t: kernels.depth_to_space2(t, phase_minor=True),
        "affine_warp": lambda t: kernels.affine_warp(t, coef, (7, 6)),
    }[name]
    with pytest.raises(ValueError, match="contiguous"):
        call(x[:, 2:6])
    assert call(x[:, 2:6].contiguous()).is_contiguous()


def _refusal_cases():
    """(wrapper, what is wrong, call, exception): operands the card refuses,
    one wrong thing each, built on the CPU."""
    x = torch.zeros(2, 8, 5, 6)
    w = torch.zeros(3, 3, 8, 4)
    k2 = torch.ones(4, 4)
    coef = torch.zeros(2, 6)
    bf = torch.bfloat16
    return [
        ("modconv3x3", "w in another dtype",
         lambda: kernels.modconv3x3(x, w.to(bf)), ValueError),
        ("modconv3x3", "bias in another dtype",
         lambda: kernels.modconv3x3(x, w, bias=torch.zeros(4, dtype=bf)), ValueError),
        ("modconv3x3", "s of the wrong shape",
         lambda: kernels.modconv3x3(x, w, s=torch.ones(2, 4)), ValueError),
        ("modconv3x3", "d of the wrong shape",
         lambda: kernels.modconv3x3(x, w, d=torch.ones(2, 8)), ValueError),
        ("modconv3x3", "bias of the wrong shape",
         lambda: kernels.modconv3x3(x, w, bias=torch.zeros(8)), ValueError),
        ("modconv3x3", "w of the wrong shape",
         lambda: kernels.modconv3x3(x, torch.zeros(3, 3, 4, 4)), ValueError),
        ("modconv3x3", "float64",
         lambda: kernels.modconv3x3(x.double(), w.double()), TypeError),
        ("modconv3x3", "batch above 65535",
         lambda: kernels.modconv3x3(torch.zeros(65536, 1, 1, 1),
                                    torch.zeros(3, 3, 1, 1)), ValueError),
        ("fused_leaky_relu", "float32 bias on bfloat16",
         lambda: kernels.fused_leaky_relu(x.to(bf), torch.zeros(8)), ValueError),
        ("fused_leaky_relu", "bias of the wrong shape",
         lambda: kernels.fused_leaky_relu(x, torch.zeros(5)), ValueError),
        ("fused_leaky_relu", "(N, C) bias of the wrong shape",
         lambda: kernels.fused_leaky_relu(torch.zeros(3, 16), torch.zeros(3)),
         ValueError),
        ("fused_leaky_relu", "float64",
         lambda: kernels.fused_leaky_relu(x.double()), TypeError),
        ("fused_leaky_relu", "float16",
         lambda: kernels.fused_leaky_relu(x.half(), torch.zeros(8).half()), TypeError),
        ("upfirdn2d", "float64",
         lambda: kernels.upfirdn2d(x.double(), k2, pad=(2, 1, 2, 1)), TypeError),
        ("upfirdn2d", "float16",
         lambda: kernels.upfirdn2d(x.half(), k2, pad=(2, 1, 2, 1)), TypeError),
        ("depth_to_space2", "channels not divisible by 4",
         lambda: kernels.depth_to_space2(torch.zeros(2, 6, 3, 3)), ValueError),
        ("depth_to_space2", "8-byte elements",
         lambda: kernels.depth_to_space2(x.double()), TypeError),
        ("affine_warp", "float64 coef",
         lambda: kernels.affine_warp(x, coef.double(), (4, 4)), ValueError),
        ("affine_warp", "coef of the wrong shape",
         lambda: kernels.affine_warp(x, torch.zeros(2, 5), (4, 4)), ValueError),
        ("affine_warp", "coef for another batch",
         lambda: kernels.affine_warp(x, torch.zeros(3, 6), (4, 4)), ValueError),
        ("affine_warp", "bfloat16 coef",
         lambda: kernels.affine_warp(x.to(bf), coef.to(bf), (4, 4)), ValueError),
        ("affine_warp", "float64 image",
         lambda: kernels.affine_warp(x.double(), coef, (4, 4)), TypeError),
    ]


@pytest.mark.parametrize("case", range(len(_refusal_cases())),
                         ids=[f"{n}-{why}" for n, why, _, _ in _refusal_cases()])
def test_wrappers_refuse_on_cpu_what_the_card_refuses(case):
    """Each wrapper holds its operands to the kernel's rule (dtype, one
    device and dtype for all, shapes, limits) on every device before it
    dispatches: the CPU raises where the card would, instead of promoting
    (a bf16 x with a float32 bias would come back float32 from the plain
    version) or computing what the card refuses."""
    name, _, call, exc = _refusal_cases()[case]
    kernels.reset_launch_counts()
    with pytest.raises(exc):
        call()
    assert kernels.launch_counts()[name] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipeline_leaves_the_callers_modules_untouched(dtype):
    """ToonifyPipeline holds copies of vt and parsing in both dtypes: not the
    caller's objects, no parameter storage shared with them, and the
    caller's parameters unchanged (values, dtype, device) after the
    pipeline has run."""
    from vtoonify_tpu_torch.models import vtoonify as V
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    cfg = V.VToonifyConfig(in_size=32, out_size=64, channel_multiplier=1,
                           channel_max=32, num_res_layers=1)
    g = torch.Generator().manual_seed(0)
    vt, parsing = V.init_vtoonify(cfg, g), init_bisenet(generator=g)
    before = {k: v.clone() for k, v in vt.state_dict().items()}
    pipe = ToonifyPipeline(vt, cfg, parsing, dtype=dtype, device="cpu")
    assert pipe.vt is not vt and pipe.parsing is not parsing
    theirs = {p.data_ptr() for p in [*vt.parameters(), *parsing.parameters()]}
    assert not theirs & {p.data_ptr() for p in [*pipe.vt.parameters(),
                                                *pipe.parsing.parameters()]}
    out = pipe.process_image(np.zeros((32, 32, 3), np.uint8),
                             np.zeros((1, cfg.n_latent, 512), np.float32), 0.5)
    assert out.shape == (64, 64, 3)
    after = vt.state_dict()
    assert before.keys() == after.keys()
    for k, v in before.items():
        assert after[k].dtype == v.dtype and after[k].device == v.device
        assert torch.equal(after[k], v), k


@pytest.mark.parametrize("name", ["fused_leaky_relu", "upfirdn2d",
                                  "depth_to_space2", "affine_warp"])
def test_wrappers_take_their_function_only_where_autograd_records(name, monkeypatch):
    """B2-B5 skip their autograd Function under inference_mode and no_grad
    (serving), and on inputs that need no gradient; they take it where
    autograd records the op. Decided before the device dispatch, so the CPU
    shows the card's routing."""
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(2, 8, 6, 5).astype(np.float32)).requires_grad_()
    bias = torch.zeros(8, requires_grad=True)
    k2 = torch.ones(4, 4) / 16
    coef = torch.tensor([[0.9, 0.1, 0.3, -0.1, 1.1, -0.2]] * 2)
    fn, call = {
        "fused_leaky_relu": ("_FusedLeakyReLU",
                             lambda t: kernels.fused_leaky_relu(t, bias)),
        "upfirdn2d": ("_UpFirDn2d",
                      lambda t: kernels.upfirdn2d(t, k2, pad=(2, 1, 2, 1))),
        "depth_to_space2": ("_DepthToSpace2", lambda t: kernels.depth_to_space2(t)),
        "affine_warp": ("_AffineWarp", lambda t: kernels.affine_warp(t, coef, (4, 3))),
    }[name]
    taken = call(x)
    assert fn.lstrip("_") in type(taken.grad_fn).__name__

    def refuse(*args):
        raise AssertionError("autograd Function taken")

    with monkeypatch.context() as m:
        m.setattr(getattr(kernels, fn), "apply", refuse)
        for mode in (torch.inference_mode, torch.no_grad):
            with mode():
                assert call(x).grad_fn is None
        if name != "fused_leaky_relu":  # B2's bias still needs a gradient
            assert call(x.detach()).grad_fn is None
    torch.testing.assert_close(call(x.detach()), taken.detach(), rtol=0, atol=0)


def test_upfirdn2d_refuses_taps_off_the_cpu():
    """B3 takes its taps by value from the host: taps on any other device
    raise on every device, before any launch (a `meta` tensor stands in for
    the card's here)."""
    x = torch.zeros(1, 2, 8, 8)
    k = torch.ones(4, 4, device="meta")
    with pytest.raises(ValueError, match="on the CPU"):
        kernels.upfirdn2d(x, k, up=(2, 2), pad=(2, 1, 2, 1))
    with pytest.raises(ValueError, match="on the CPU"):
        upfirdn2d.upfirdn2d(x, torch.ones(4, device="meta"), down=2, pad=(1, 1))


def test_b3_callers_pass_host_float32_taps(monkeypatch):
    """Every caller of B3 on the serving and training paths (to_rgb's skip
    upsample, conv_layer's downsample blur in D, synth.down, the augment's
    SYM6 passes in both dtypes) hands it CPU float32 taps: recorded through
    the wrapper on a tiny configuration. The augment's taps are SYM6 rounded
    through the image dtype on the host."""
    from vtoonify_tpu_torch.models import vtoonify as V
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
    from vtoonify_tpu_torch.train import augment, synth

    seen = []
    real = kernels.upfirdn2d

    def recording(x, k2d, *a, **kw):
        seen.append(k2d)
        return real(x, k2d, *a, **kw)

    monkeypatch.setattr(kernels, "upfirdn2d", recording)
    cfg = V.VToonifyConfig(in_size=32, out_size=64, channel_multiplier=1,
                           channel_max=32, num_res_layers=1)
    g = torch.Generator().manual_seed(0)
    vt, parsing = V.init_vtoonify(cfg, g), init_bisenet(generator=g)
    dcfg = V.CondDiscriminatorConfig(size=64, channel_multiplier=1, channel_max=32,
                                     use_condition=True, style_num=2)
    d = V.init_cond_discriminator(dcfg, g)
    pipe = ToonifyPipeline(vt, cfg, parsing, dtype=torch.float32, device="cpu")
    pipe.process_image(np.zeros((32, 32, 3), np.uint8),
                       np.zeros((1, cfg.n_latent, 512), np.float32), 0.5)
    n_calls = [len(seen)]
    V.cond_discriminator_apply(d, dcfg, torch.zeros(2, 3, 64, 64),
                               torch.zeros(2, 1), torch.tensor([0, 1]))
    n_calls.append(len(seen))
    synth.down(torch.zeros(1, 3, 16, 16, dtype=torch.bfloat16))
    n_calls.append(len(seen))
    for dt in (torch.float32, torch.bfloat16):
        augment.random_apply_affine(torch.zeros(1, 3, 16, 16, dtype=dt), 0.2,
                                    G=torch.eye(3)[None], max_pad=8)
    assert 0 < n_calls[0] < n_calls[1] < n_calls[2] == len(seen) - 8
    assert all(k.device.type == "cpu" and k.dtype == torch.float32 for k in seen)
    sym6_bf16 = augment.SYM6.to(torch.bfloat16).float()
    for k, want in zip(seen[-4:], (sym6_bf16[None, :], sym6_bf16[:, None],
                                   sym6_bf16.flip(0)[None, :],
                                   sym6_bf16.flip(0)[:, None])):
        assert torch.equal(k, want)


def test_port_imports_no_jax():
    """The port package never imports jax (checked in a fresh interpreter,
    and by a search of its sources and chip_smoke.py for the imports)."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = [*sorted((root / "vtoonify_tpu_torch").rglob("*.py")),
             root / "chip_smoke.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax|vtoonify_tpu)(\.|\s|$)", re.M)
    bad = [str(f.relative_to(root)) for f in files if pat.search(f.read_text())]
    assert not bad, bad
    code = (
        "import sys\n"
        "import vtoonify_tpu_torch.pipeline.toonify\n"
        "import vtoonify_tpu_torch.convert.from_jax\n"
        "import vtoonify_tpu_torch.ops.kernels\n"
        "import vtoonify_tpu_torch.train.steps\n"
        "import vtoonify_tpu_torch.cli.style_transfer\n"
        "import vtoonify_tpu_torch.pipeline.video\n"
        "import vtoonify_tpu_torch.pipeline.crop\n"
        "import vtoonify_tpu_torch.pipeline.landmarks\n"
        "import vtoonify_tpu_torch.pipeline.model_api\n"
        "import vtoonify_tpu_torch.utils.checkpoint\n"
        "import vtoonify_tpu_torch.train.synth\n"
        "import vtoonify_tpu_torch.train.guards\n"
        "import vtoonify_tpu_torch.train.logging\n"
        "import vtoonify_tpu_torch.utils.blend\n"
        "import vtoonify_tpu_torch.utils.profiling\n"
        "import vtoonify_tpu_torch.models.lpips\n"
        "import vtoonify_tpu_torch.convert.torch_export\n"
        "import vtoonify_tpu_torch.cli.train_d\n"
        "import vtoonify_tpu_torch.cli.train_t\n"
        "import vtoonify_tpu_torch.native\n"
        "import vtoonify_tpu_torch.models.raft\n"
        "import vtoonify_tpu_torch.models.raft_data\n"
        "import vtoonify_tpu_torch.models.raft_viz\n"
        "import vtoonify_tpu_torch.pipeline.smooth_parsing\n"
        "import vtoonify_tpu_torch.cli.serve\n"
        "import vtoonify_tpu_torch.cli.inference_playground\n"
        "import vtoonify_tpu_torch.cli.validate_release\n"
        "import vtoonify_tpu_torch.parallel.mesh\n"
        "import vtoonify_tpu_torch.parallel.collectives\n"
        "import vtoonify_tpu_torch.parallel.multihost\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'vtoonify_tpu.')))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
