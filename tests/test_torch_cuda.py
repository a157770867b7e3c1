"""The port's CUDA kernels vs their plain versions, on the card.

Marked `cuda`; every test skips where torch sees no GPU (decided inside the
fixture, never at import). The shapes here are the awkward ones the main path
does not reach: ragged tiles, channel counts off the kernel's tile sizes,
signed pads and 12-tap filters, every up/down pair, rows on and off the
16-byte vector, more than 65535 planes, both depth-to-space orders, 1-byte
elements, warps of non-square images onto ragged outputs partly outside the
image; and
each autograd Function's backward on the card; and the stage-1 and T
training steps at the --tiny size, card against CPU. The main-path shapes are
checked by chip_smoke.py. Run on a machine with an H100 (it has no
JAX, so skip the suite's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: float32 runs with TF32 off and differs from cuDNN only in the
order of float32 sums; bfloat16 outputs round once in the kernel and after
each op in the plain version, a few bf16 steps (2^-8 relative) at most.
"""

import numpy as np
import pytest
import torch

from vtoonify_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(np.float32))


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    ref = max(1.0, want.float().abs().max().item())
    assert err <= TOL[dtype] * ref, (err, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,h,w,modulated,act", [
    (2, 5, 7, 9, 13, True, True),       # everything ragged
    (1, 16, 64, 8, 16, True, False),    # exact tiles, raw conv
    (3, 24, 96, 17, 33, False, True),   # folded form, partial Cout tile
    (1, 8, 3, 1, 1, True, True),        # single pixel
    # bf16 runs the tensor-core kernel: 8x16 px tiles, 32-channel K chunks,
    # BN of 32/64/128 output channels from Cout
    (1, 40, 64, 16, 16, True, True),    # Cin not a multiple of 16 or 32
    (2, 64, 72, 12, 20, False, True),   # Cout not a multiple of BN
    (1, 512, 2048, 6, 10, True, True),  # the up conv's Cout = 4 * 512
    (2, 96, 128, 28, 28, True, True),   # 28 x 28: ragged against the tile
    (1, 48, 40, 17, 33, True, False),   # 17 x 33, raw conv with s and d
    (3, 64, 96, 20, 24, True, True),    # batch 3 with s, d and bias
])
def test_modconv3x3(dev, dtype, b, cin, cout, h, w, modulated, act):
    rng = np.random.RandomState(0)
    x = _rand(rng, b, cin, h, w)
    wt = _rand(rng, 3, 3, cin, cout, scale=1.0 / np.sqrt(9 * cin))
    s = _rand(rng, b, cin, scale=0.5, shift=1.0) if modulated else None
    d = _rand(rng, b, cout, scale=0.1, shift=1.0) if modulated else None
    bias = _rand(rng, cout, scale=0.1) if act else None
    args = [None if t is None else t.to(dev, dtype) for t in (x, wt, s, d, bias)]
    _close(kernels.modconv3x3(*args), kernels.modconv3x3_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,with_bias,misalign", [
    ((2, 7, 5, 3), True, False),      # planes off the 16-byte vector: scalars
    ((18, 512), True, False),         # (N, C) form, C on the vector
    ((3, 4, 2, 2), False, False),     # 4-element planes: f32 vector, bf16 scalar
    ((2, 32, 16, 16), True, False),   # planes on the vector, several chunks
    ((2, 3, 40, 40), True, False),    # 1600-element planes, ragged last chunk
    ((1, 65540, 2, 4), True, False),  # more than 65535 planes, vectors
    ((1, 65537, 3), True, False),     # more than 65535 planes, scalars
    ((5, 24), True, False),           # (N, C) form, C a multiple of 8
    ((5, 13), True, False),           # (N, C) form, C off the vector
    ((5, 13), False, False),
    ((2, 8, 4, 4), True, True),       # a contiguous view off 16-byte alignment
    ((6, 16), True, True),
])
def test_fused_leaky_relu(dev, dtype, shape, with_bias, misalign):
    rng = np.random.RandomState(1)
    x = _rand(rng, *shape).to(dev, dtype)
    if misalign:  # same values, one element into a fresh allocation
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(shape)
        assert x.data_ptr() % 16 and x.is_contiguous()
    bias = _rand(rng, shape[1]).to(dev, dtype) if with_bias else None
    _close(kernels.fused_leaky_relu(x, bias),
           kernels.fused_leaky_relu_plain(x, bias), dtype)


_UP_DOWN = [(u, d) for u in ((1, 1), (2, 1), (1, 2), (2, 2))
            for d in ((1, 1), (2, 1), (1, 2), (2, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kt,up,down,pad", [
    ((2, 3, 19, 22), 4, (2, 2), (1, 1), (2, 1, 2, 1)),    # ToRGB's upsample_2x
    ((2, 3, 19, 22), 4, (1, 1), (1, 1), (2, 1, 2, 1)),    # blur
    ((2, 3, 19, 22), 4, (1, 1), (2, 2), (1, 1, 1, 1)),    # downsample_2x
    ((2, 3, 19, 22), 3, (2, 1), (1, 2), (-1, 2, 0, -1)),  # per-axis, negative pads
    ((2, 3, 19, 22), 8, (2, 2), (2, 2), (3, 4, 4, 3)),    # 8 taps
    ((2, 3, 19, 22), 12, (2, 2), (1, 1), (6, 5, -2, 7)),  # widest taps, signed pads
    ((2, 3, 19, 22), (1, 12), (2, 1), (1, 1), (6, 5, 0, 0)),     # augment SYM6 x-up
    ((2, 3, 19, 22), (12, 1), (1, 1), (1, 2), (0, 0, -1, -1)),   # augment SYM6 y-down
    ((2, 3, 19, 22), (12, 5), (1, 2), (2, 1), (-3, -1, 4, -2)),  # mixed, negative pads
    # every (up, down) pair the wrapper admits, on a 17 x 33 plane (ragged
    # against the tiles' 8-row and 32-column steps), signed pads
    *[((1, 2, 17, 33), 4, u, d, (2, -1, -1, 2)) for u, d in _UP_DOWN],
    # 2060 x 28 planes (the augment's height, a width off the 16-byte vector)
    ((1, 2, 2060, 28), (1, 12), (2, 1), (1, 1), (6, 5, 0, 0)),
    ((1, 2, 2060, 28), (12, 1), (1, 2), (1, 1), (0, 0, 6, 5)),
    ((1, 2, 2060, 28), (12, 5), (1, 1), (1, 2), (-1, 3, -1, -1)),
    ((1, 2, 2060, 28), 4, (2, 2), (1, 1), (2, 1, 2, 1)),
    # rows on the 16-byte vector in and out (16-byte loads and stores)
    ((2, 2, 24, 64), (12, 1), (1, 2), (1, 1), (0, 0, 6, 5)),
    ((2, 2, 40, 128), (1, 12), (1, 1), (2, 1), (-1, -1, 0, 0)),
    ((1, 3, 33, 256), 4, (1, 1), (1, 1), (2, 2, 2, 2)),
    # more than 65535 planes (the grid's z dimension folds into a loop)
    ((1, 65540, 2, 3), 4, (2, 2), (1, 1), (2, 1, 2, 1)),
])
def test_upfirdn2d(dev, dtype, shape, kt, up, down, pad):
    rng = np.random.RandomState(2)
    x = _rand(rng, *shape).to(dev, dtype)
    kt = (kt, kt) if isinstance(kt, int) else kt
    k = torch.from_numpy(rng.rand(*kt).astype(np.float32))
    _close(kernels.upfirdn2d(x, k, up, down, pad),
           kernels.upfirdn2d_plain(x, k, up, down, pad), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("phase_minor", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 12, 5, 7),         # odd width: single-element words
    (2, 8, 3, 28),         # the temporal crop's 28 px rows: 8-byte bf16 words
    (1, 16, 4, 32),        # rows on the 16-byte vector for every dtype
    (2, 4 * 32770, 1, 1),  # more than 65535 planes of 1 x 1 input pixels
])
def test_depth_to_space2(dev, dtype, phase_minor, shape):
    x = torch.arange(int(np.prod(shape)), device=dev).reshape(shape)
    x = (x % 251).to(dtype)
    got = kernels.depth_to_space2(x, phase_minor)
    assert torch.equal(got, kernels.depth_to_space2_plain(x, phase_minor))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,ho,wo,scale,shift", [
    (2, 6, 37, 53, 23, 29, 1.3, 0.0),     # ragged output, non-square input
    (1, 3, 64, 40, 70, 90, 0.6, 0.4),     # affine partly outside the image
    (3, 1, 17, 17, 5, 300, 4.0, -0.2),    # strong minification, long rows
    # the kernel's paths: rows of a multiple of 4 outputs (packed stores) and
    # ragged ones (scalar tail); the 6-channel instance and the runtime
    # channel count (1, 3, 7)
    (2, 6, 40, 52, 24, 32, 1.1, 0.1),     # C = 6, packed stores
    (2, 6, 40, 52, 24, 30, 0.9, -0.1),    # C = 6, ragged rows
    (1, 1, 33, 35, 16, 36, 1.2, 0.3),     # C = 1, packed stores
    (2, 3, 33, 35, 17, 21, 0.7, 0.0),     # C = 3, ragged rows
    (1, 7, 29, 31, 19, 28, 1.0, 0.2),     # C = 7, packed stores
    (65537, 1, 3, 3, 2, 4, 1.0, 0.1),     # more than 65535 samples
])
def test_affine_warp(dev, dtype, n, c, h, w, ho, wo, scale, shift):
    """Against the plain version (F.grid_sample on the same affine's grid):
    [-1, 1] images, so float32 differs by coordinate rounding only (values
    within 1e-4) and bf16 by one output rounding."""
    rng = np.random.RandomState(3)
    img = torch.tanh(_rand(rng, n, c, h, w)).to(dev, dtype)
    theta = torch.from_numpy(rng.randn(n, 2, 3).astype(np.float32) * 0.2)
    theta[:, 0, 0] += scale
    theta[:, 1, 1] += scale
    theta[:, :, 2] += shift
    from vtoonify_tpu_torch.train.augment import _pixel_affine_coefs

    coef = _pixel_affine_coefs(theta, (ho, wo), (h, w)).to(dev).contiguous()
    got = kernels.affine_warp(img, coef, (ho, wo))
    assert got.shape == (n, c, ho, wo) and got.dtype == dtype
    _close(got, kernels.affine_warp_plain(img, coef, (ho, wo)), dtype)
    if shift:
        assert (got == 0).any() and (got != 0).any()  # some samples outside


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 3])
def test_affine_warp_non_finite_coefs_give_zeros(dev, dtype, c):
    """NaN, infinite and huge coefficients map every output outside the
    image: zeros, and no read out of bounds (it would fault at the
    synchronize). The image is small, so that a wild gather lands outside
    its allocation."""
    img = torch.ones(4, c, 5, 7, device=dev, dtype=dtype)
    nan, inf = float("nan"), float("inf")
    coef = torch.tensor([[nan] * 6,
                         [1.0, 0.0, nan, 0.0, 1.0, 0.0],
                         [inf, 0.0, 1.0, -inf, 0.0, 1.0],
                         [1.0, 0.0, 1e30, 0.0, 1.0, -1e30]], device=dev)
    got = kernels.affine_warp(img, coef, (6, 8))
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


def test_inference_mode_launches_without_a_graph_node(dev, monkeypatch):
    """B2 and B5 launch their kernels without their autograd Functions where
    autograd does not record (inference_mode, no_grad), and take them
    where it does."""
    x = torch.randn(2, 8, 4, 4, device=dev, requires_grad=True)
    bias = torch.zeros(8, device=dev, requires_grad=True)
    img = torch.randn(2, 6, 9, 9, device=dev, requires_grad=True)
    coef = torch.tensor([[1.0, 0.0, 0.5, 0.0, 1.0, 0.5]] * 2, device=dev)

    def refuse(*args):
        raise AssertionError("autograd Function taken")

    kernels.reset_launch_counts()
    with monkeypatch.context() as m:
        m.setattr(kernels._FusedLeakyReLU, "apply", refuse)
        m.setattr(kernels._AffineWarp, "apply", refuse)
        for mode in (torch.inference_mode, torch.no_grad):
            with mode():
                y = kernels.fused_leaky_relu(x, bias)
                z = kernels.affine_warp(img, coef, (5, 5))
            assert y.grad_fn is None and z.grad_fn is None
    assert kernels.launch_counts()["fused_leaky_relu"] == 2
    assert kernels.launch_counts()["affine_warp"] == 2
    y = kernels.fused_leaky_relu(x, bias)
    z = kernels.affine_warp(img, coef, (5, 5))
    assert "FusedLeakyReLU" in type(y.grad_fn).__name__
    assert "AffineWarp" in type(z.grad_fn).__name__
    assert kernels.launch_counts()["fused_leaky_relu"] == 3
    assert kernels.launch_counts()["affine_warp"] == 3


def _backward_matches(dev, kern, plain, inputs):
    grads = []
    for fn in (kern, plain):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        y = fn(*leaves)
        g = torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
        grads.append(torch.autograd.grad(y, leaves, g))
    for a, b in zip(*grads):
        _close(a, b, torch.float32)


def test_backward_on_card(dev):
    """Each autograd Function on CUDA tensors (the kernel forward, the plain
    backward) vs torch.autograd through the plain version, float32."""
    rng = np.random.RandomState(4)
    r = lambda *s, **k: _rand(rng, *s, **k).to(dev)  # noqa: E731
    k2 = torch.from_numpy(rng.rand(4, 4).astype(np.float32))
    k12 = torch.from_numpy(rng.rand(1, 12).astype(np.float32))
    coef = torch.tensor([[1.1, 0.1, -0.4, -0.05, 0.95, 0.7]] * 2, device=dev)
    _backward_matches(dev, kernels.modconv3x3, kernels.modconv3x3_plain,
                      (r(2, 5, 9, 13), r(3, 3, 5, 7, scale=0.2), r(2, 5, shift=1.0),
                       r(2, 7, shift=1.0), r(7)))
    _backward_matches(dev, kernels.fused_leaky_relu, kernels.fused_leaky_relu_plain,
                      (r(2, 7, 5, 3), r(7)))
    for k, up, down, pad in ((k2, (2, 2), (1, 1), (2, 1, 2, 1)),
                             (k12, (1, 1), (2, 1), (-1, -1, 0, 0))):
        _backward_matches(
            dev, lambda x, k=k, u=up, d=down, p=pad: kernels.upfirdn2d(x, k, u, d, p),
            lambda x, k=k, u=up, d=down, p=pad: kernels.upfirdn2d_plain(x, k, u, d, p),
            (r(2, 3, 17, 19),))
    for pm in (False, True):
        _backward_matches(dev, lambda x, pm=pm: kernels.depth_to_space2(x, pm),
                          lambda x, pm=pm: kernels.depth_to_space2_plain(x, pm),
                          (r(2, 12, 5, 7),))
    _backward_matches(dev, lambda x: kernels.affine_warp(x, coef, (11, 13)),
                      lambda x: kernels.affine_warp_plain(x, coef, (11, 13)),
                      (r(2, 3, 15, 17),))


def test_launch_counts_and_refusals(dev):
    kernels.reset_launch_counts()
    x = torch.randn(1, 8, 4, 4, device=dev)
    kernels.fused_leaky_relu(x, torch.zeros(8, device=dev))
    kernels.depth_to_space2(x)
    assert kernels.launch_counts()["fused_leaky_relu"] == 1
    assert kernels.launch_counts()["depth_to_space2"] == 1
    with pytest.raises(TypeError):
        kernels.fused_leaky_relu(x.half())
    with pytest.raises(ValueError):
        kernels.modconv3x3(x, torch.zeros(3, 3, 4, 2, device=dev))
    with pytest.raises(ValueError):
        kernels.upfirdn2d(x, torch.ones(4, 4), up=(4, 4))
    with pytest.raises(ValueError):
        kernels.upfirdn2d(x, torch.ones(1, 13))
    with pytest.raises(ValueError, match="on the CPU"):  # taps go by value
        kernels.upfirdn2d(x, torch.ones(4, 4, device=dev), pad=(2, 1, 2, 1))
    with pytest.raises(ValueError):  # float64 coefficients
        kernels.affine_warp(x, torch.zeros(1, 6, dtype=torch.float64, device=dev),
                            (3, 3))
    kernels.affine_warp(x, torch.zeros(1, 6, device=dev), (3, 3))
    assert kernels.launch_counts()["affine_warp"] == 1


def test_compute_style_card_vs_cpu(dev):
    """ToonifyPipeline.compute_style at the tiny configuration (pSp with
    n_latent styles, the exemplar splice) on the card vs the CPU, float32
    with TF32 off: relative L2 of s_w within 1e-4 (float32 sums in another
    order); the bf16 pipeline prepares its style in float32 too, so both
    card pipelines give the same code (1e-6: the same float32 calls)."""
    from vtoonify_tpu_torch.models import bisenet, psp_encoder, vtoonify
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    g = torch.Generator().manual_seed(3)
    cfg = vtoonify.VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1,
                                  channel_max=256, num_res_layers=2)
    pcfg = psp_encoder.PSPEncoderConfig(n_styles=cfg.n_latent)
    style = dict(psp_params=psp_encoder.init_psp_encoder(pcfg, g), psp_cfg=pcfg,
                 latent_avg=torch.randn((cfg.n_latent, 512), generator=g) * 0.3,
                 exstyle=torch.randn((1, cfg.n_latent, 512), generator=g) * 0.3)
    vt, parsing = vtoonify.init_vtoonify(cfg, g), bisenet.init_bisenet(generator=g)
    pipes = [ToonifyPipeline(vt, cfg, parsing, dtype=dt, device=d, **style)
             for dt, d in ((torch.float32, dev), (torch.bfloat16, dev),
                           (torch.float32, "cpu"))]
    face = np.random.RandomState(3).randint(0, 256, (256, 256, 3)).astype(np.uint8)
    kernels.reset_launch_counts()
    for color in (False, True):
        card, card_bf16, host = (p.compute_style(face, color).cpu() for p in pipes)
        assert card.dtype == card_bf16.dtype == torch.float32
        assert ((card - card_bf16).norm() / card.norm()).item() <= 1e-6
        assert ((card - host).norm() / host.norm()).item() <= 1e-4
    assert kernels.launch_counts()["fused_leaky_relu"] > 0  # the mapping MLP


def _uncond_d_cfg():
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig

    return CondDiscriminatorConfig(size=64, channel_multiplier=1)


def _tiny_train_modules(backbone, g):
    """The trainer's --tiny modules (CPU, float32), noise weights and
    styled-conv biases randomized so the teachers' images are not blind."""
    from vtoonify_tpu_torch.models import bisenet, generator, lpips, psp_encoder, vtoonify

    cfg = vtoonify.VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1,
                                  num_res_layers=2, backbone=backbone)
    pcfg = psp_encoder.PSPEncoderConfig(n_styles=cfg.n_latent)
    mods = dict(vt=vtoonify.init_vtoonify(cfg, g), parsing=bisenet.init_bisenet(generator=g),
                base=generator.init_generator(cfg.generator, g),
                psp=psp_encoder.init_psp_encoder(pcfg, g), lpips=lpips.init_lpips(g),
                d=vtoonify.init_cond_discriminator(_uncond_d_cfg(), g))
    gens = [mods["base"], mods["vt"].generator.generator
            if backbone == "dualstylegan" else mods["vt"].generator]
    with torch.no_grad():
        for gen in gens:
            for blk in [gen.conv1, *gen.convs]:
                blk.noise.weight.fill_(0.1)
                blk.act_bias.normal_(0.0, 0.3, generator=g)
    return cfg, pcfg, mods


def _flat_params(module):
    return torch.cat([p.detach().float().reshape(-1).cpu() for p in module.parameters()])


@pytest.mark.parametrize("which", ["pretrain_d", "pretrain_t", "train_t"])
def test_train_steps_card_vs_cpu(dev, which):
    """The stage-1 steps of VToonify-D and VToonify-T and the T stage-2 step
    at the --tiny configuration, batch 2, float32 with TF32 off, on the card
    and on the CPU from the same modules and draws: metrics within 2e-3
    relative, the gradients (Adam's first moment over 1 - beta1) within
    1e-3 relative L2, Adam's first updates within 2 lr everywhere, and
    every kernel of the step launched on the card."""
    import copy

    from vtoonify_tpu_torch.train import steps as S

    g = torch.Generator().manual_seed(8)
    backbone = "dualstylegan" if which == "pretrain_d" else "toonify"
    cfg, pcfg, mods_cpu = _tiny_train_modules(backbone, g)
    directions = torch.randn((4, cfg.n_latent, 512), generator=g) * 0.1
    style = torch.randn((2, cfg.n_latent, 512), generator=g) * 0.3
    tcfg = S.TrainDConfig(crop_size=96, lpips_size=64, aug_max_pad=40)
    if which == "train_t":
        draws = S.sample_train_t_draws(g, 2, cfg, tcfg, 4)
    else:
        draws = S.sample_pretrain_draws(g, 2, cfg, 4)
    out = {}
    for where in ("cuda", "cpu"):
        m = copy.deepcopy(mods_cpu)
        device = dev if where == "cuda" else "cpu"
        kernels.reset_launch_counts()
        if which == "train_t":
            state = S.init_train_t_state(m["vt"], m["d"], tcfg, device=device)
            _, frozen = S.split_trainable(m["vt"])
            metrics = S.train_t_step(state, frozen, m["base"], m["parsing"], m["psp"],
                                     pcfg, None, m["lpips"], cfg, _uncond_d_cfg(), tcfg,
                                     directions, 2, 0.3, draws=draws.to(device))
        else:
            state = S.init_pretrain_state(m["vt"], device=device)
            _, frozen = S.split_trainable(m["vt"], pretrain=True)
            if which == "pretrain_d":
                metrics = S.pretrain_step(state, frozen, m["parsing"], cfg, directions,
                                          style, 0.6, draws=draws.to(device))
            else:
                metrics = S.pretrain_t_step(state, frozen, m["base"], m["parsing"], cfg,
                                            directions, 2, draws=draws.to(device))
        grads = torch.cat([(state.g_opt.state[p]["exp_avg"] / (1 - S.ADAM_BETA1))
                           .reshape(-1).cpu() for p in state.trainable.parameters()])
        out[where] = ({k: float(v) for k, v in metrics.items()},
                      _flat_params(state.trainable), grads, kernels.launch_counts())
    for k, v in out["cpu"][0].items():
        assert abs(out["cuda"][0][k] - v) <= 2e-3 * abs(v) + 1e-9, k
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 2 * tcfg.lr + 1e-7
    g_card, g_cpu = out["cuda"][2], out["cpu"][2]
    assert ((g_card - g_cpu).norm() / g_cpu.norm()).item() <= 1e-3
    launched = out["cuda"][3]
    want = {"modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"}
    if which == "train_t":
        want.add("affine_warp")
    assert all(launched[k] > 0 for k in want), launched


def test_pipeline_options_on_card(dev):
    """packed_output and size bucketing on the card at the tiny
    configuration: the packed output, unpacked on the host, bit-equal to the
    unpacked pipeline's (bf16 and float32); the bucketed float32 output
    (with and without a margin) the exact crop's shape and within 2 LSB max /
    0.05 mean of the CPU's (float32 sums in another order, TF32 off)."""
    from vtoonify_tpu_torch.models import bisenet, vtoonify
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    g = torch.Generator().manual_seed(5)
    cfg = vtoonify.VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1,
                                  num_res_layers=2)
    vt, parsing = vtoonify.init_vtoonify(cfg, g), bisenet.init_bisenet(generator=g)
    with torch.no_grad():
        for blk in vt.generator.generator.to_rgbs:
            blk.bias.normal_(0.0, 0.5, generator=g)
    rng = np.random.RandomState(5)
    s_w = (rng.randn(1, cfg.n_latent, 512) * 0.3).astype(np.float32)
    frames = rng.randint(0, 256, (3, 40, 56, 3)).astype(np.uint8)
    for dtype in (torch.bfloat16, torch.float32):
        packed = ToonifyPipeline(vt, cfg, parsing, dtype=dtype, packed_output=True)
        plain = ToonifyPipeline(vt, cfg, parsing, dtype=dtype)
        got = packed.process_batch(frames, s_w, 0.5).cpu().numpy()
        want = plain.process_batch(frames, s_w, 0.5).cpu().numpy()
        assert got.shape == (3, 80, 112, 12) and want.shape == (3, 160, 224, 3)
        assert want.std() > 10
        for k in range(3):
            np.testing.assert_array_equal(ToonifyPipeline.unpack_frame(got[k]), want[k])
    crop = frames[:1, :36, :44]
    for margin in (0, 8):
        kw = dict(dtype=torch.float32, size_bucket=32, bucket_margin=margin)
        card = ToonifyPipeline(vt, cfg, parsing, **kw).process_batch(crop, s_w, 0.5)
        host = ToonifyPipeline(vt, cfg, parsing, device="cpu", **kw).process_batch(
            crop, s_w, 0.5)
        assert card.device.type == "cuda" and card.shape == host.shape == (1, 144, 176, 3)
        d = (card.cpu().int() - host.int()).abs().float()
        assert d.max().item() <= 2 and d.mean().item() <= 0.05, (margin, d.max(), d.mean())


def test_raft_and_smoothing_card_vs_cpu(dev):
    """RAFT at the raft-things widths (random weights, float32, TF32 off):
    both lookups card vs CPU within 1e-5 relative L2; the smoother on a
    4-frame 32 px video (window 1, 2 iterations) card vs CPU within 1e-4
    relative L2 (float32 sums in another order), its B3 downsample
    launched on the card; alt vs all-pairs on the card within JAX's bounds
    (tests/test_raft.py: atol 1e-3 on the 1/8 flow, 1e-2 upsampled)."""
    from vtoonify_tpu_torch.models import bisenet, raft
    from vtoonify_tpu_torch.pipeline import smooth_parsing

    rng = np.random.RandomState(6)
    f1, f2 = (_rand(rng, 2, 32, 16, 24) for _ in range(2))
    coords = (torch.from_numpy(rng.uniform(-6, 6, (2, 2, 16, 24)).astype(np.float32))
              + torch.stack(torch.meshgrid(torch.arange(24.0), torch.arange(16.0),
                                           indexing="xy"))[None])
    for fn, args in ((lambda a, b, c: raft.lookup_corr(raft.build_corr_pyramid(a, b), c),
                      (f1, f2, coords)),
                     (lambda a, b, c: raft.lookup_corr_alt(a, raft.build_fmap_pyramid(b), c),
                      (f1, f2, coords))):
        host = fn(*args)
        card = fn(*(a.to(dev) for a in args)).cpu()
        assert ((card - host).norm() / host.norm()).item() <= 1e-5

    g = torch.Generator().manual_seed(6)
    model, parsing = raft.init_raft(raft.RAFTConfig(), g), bisenet.init_bisenet(generator=g)
    base = rng.randint(0, 256, (40, 40, 3)).astype(np.uint8)
    frames = np.stack([base[i:i + 32, 2 * i:2 * i + 32] for i in range(4)])
    kernels.reset_launch_counts()
    card = smooth_parsing.smooth_video_parsing_maps(model, parsing, frames, window=1, iters=2,
                                                    tf32=False)
    assert kernels.launch_counts()["upfirdn2d"] == 4
    host = smooth_parsing.smooth_video_parsing_maps(model, parsing, frames, window=1,
                                                    iters=2, device="cpu")
    assert card.shape == (4, 32, 32, 19)
    assert np.linalg.norm(card - host) / np.linalg.norm(host) <= 1e-4

    m = model.to(dev)
    im1 = torch.from_numpy(rng.randint(0, 256, (1, 3, 64, 96)).astype(np.float32)).to(dev)
    im2 = torch.roll(im1, (2, -3), dims=(2, 3))
    with torch.inference_mode():
        lr_a, up_a = raft.raft_apply(m, im1, im2, raft.RAFTConfig(), iters=4)
        lr_b, up_b = raft.raft_apply(m, im1, im2, raft.RAFTConfig(corr_impl="alt"), iters=4)
    assert torch.allclose(lr_b, lr_a, atol=1e-3, rtol=1e-3)
    assert torch.allclose(up_b, up_a, atol=1e-2, rtol=1e-3)


def _raft_steps_agree(a, b, before, lr, n_valid, bn_trained):
    """Two RAFT train steps from the same params and inputs: loss and EPE
    within 1e-4 relative, the 1/3/5 px accuracies within one pixel's share,
    the clipped gradients within 1e-2 relative L2 (at these 6 x 8 feature
    maps a few ReLU inputs sit within float32 rounding of zero, and each
    one that flips moves the gradient of whole tensors), the new params
    within 1e-4 relative L2; AdamW's first update (about +-lr an element) within 2 lr
    everywhere and, on each tensor's elements whose |g| is above 1e-3 of its
    largest and above 100 eps (where |g| sits at the rounding noise its sign
    may differ; at least 5% of all), all but 0.1% of them within 0.02 lr and
    all but 1% within 1e-3 lr (a flipped ReLU can change single elements'
    gradients wholly); trained
    BN buffers within 1e-4, frozen ones unchanged."""
    (am, ap, ag), (bm, bp, bg) = a, b
    for k in ("loss", "epe"):
        assert am[k] == pytest.approx(bm[k], rel=1e-4), k
    for k in ("1px", "3px", "5px"):
        assert abs(am[k] - bm[k]) <= 1.0 / n_valid + 1e-7, k

    def rel(x, y, keys):
        return (sum(((x[k] - y[k]) ** 2).sum() for k in keys)
                / sum((y[k] ** 2).sum() for k in keys)).sqrt().item()

    assert rel(ag, bg, list(bg)) <= 1e-2
    assert rel(ap, bp, list(bg)) <= 1e-4
    masked = over_2e2 = over_1e3 = 0
    for k, g in bg.items():
        err = (ap[k] - bp[k]).abs()
        assert err.max().item() <= 2 * lr + 1e-7, k
        mask = (g.abs() > 1e-3 * g.abs().max()) & (g.abs() > 1e-6)
        masked += int(mask.sum())
        over_2e2 += int((err[mask] > 0.02 * lr).sum())
        over_1e3 += int((err[mask] > 1e-3 * lr).sum())
    assert masked > 0.05 * sum(g.numel() for g in bg.values())
    assert over_2e2 <= 1e-3 * masked and over_1e3 <= 1e-2 * masked, (over_2e2, over_1e3, masked)
    for k in bp:
        if "running" in k:
            if bn_trained:
                assert torch.allclose(ap[k], bp[k], atol=1e-4, rtol=0), k
            else:
                assert torch.equal(ap[k], before[k]) and torch.equal(bp[k], before[k]), k


@pytest.mark.parametrize("train_bn", [False, True])
def test_raft_train_step_card_vs_cpu(dev, train_bn):
    """One RAFT train step (raft-things widths, (2, 3, 48, 64), 2 iterations,
    noise, a clip that binds) on the card against the CPU from the same
    params and draws, float32 with TF32 off, with both correlations; and
    the alt step against the all-pairs one on the card (`_raft_steps_agree`).
    No B1-B5 launch."""
    import copy

    from vtoonify_tpu_torch.models import raft, raft_train

    rng = np.random.RandomState(9)
    model = raft.init_raft(raft.RAFTConfig(), torch.Generator().manual_seed(9))
    tcfg = raft_train.RaftTrainConfig(lr=1e-4, num_steps=10, iters=2, add_noise=True,
                                      clip=0.5, train_bn=train_bn)
    inputs = (torch.from_numpy((rng.rand(2, 3, 48, 64) * 255).astype(np.float32)),
              torch.from_numpy((rng.rand(2, 3, 48, 64) * 255).astype(np.float32)),
              _rand(rng, 2, 2, 48, 64, scale=3.0),
              torch.from_numpy((rng.rand(2, 48, 64) > 0.2).astype(np.float32)))
    draws = raft_train.sample_raft_train_draws(torch.Generator().manual_seed(10),
                                               inputs[0].shape)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for impl in ("allpairs", "alt"):
        for where in ("cpu", "cuda"):
            state = raft_train.init_raft_train_state(copy.deepcopy(model), tcfg, device=where)
            kernels.reset_launch_counts()
            m = raft_train.raft_train_step(state, *inputs, raft.RAFTConfig(corr_impl=impl),
                                           tcfg, draws=draws)
            assert not any(kernels.launch_counts().values())
            out[impl, where] = ({k: float(v) for k, v in m.items()},
                                {k: v.cpu() for k, v in state.model.state_dict().items()},
                                {k: p.grad.cpu() for k, p in state.model.named_parameters()})
    n_valid = inputs[3].sum().item()
    for a, b in ((("allpairs", "cuda"), ("allpairs", "cpu")), (("alt", "cuda"), ("alt", "cpu")),
                 (("alt", "cuda"), ("allpairs", "cuda"))):
        _raft_steps_agree(out[a], out[b], before, tcfg.lr, n_valid, train_bn)
