"""The port's training modules vs the JAX package (CPU), and the gradients
of its kernel wrappers.

Inputs are numpy-seeded and fed to both packages; JAX params come from the
JAX init functions and reach the port through `load_jax_params`. The port is
NCHW where the JAX package is NHWC. Float32 tolerances are float32 rounding
of differently ordered sums unless a test says otherwise. The whole step is
held to JAX's in tests/test_torch_train_step.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.models import dualstylegan as JD
from vtoonify_tpu.models import generator as JG
from vtoonify_tpu.models import lpips as JLP
from vtoonify_tpu.models import psp_encoder as JP
from vtoonify_tpu.models import vtoonify as JV
from vtoonify_tpu.nn import layers as JL
from vtoonify_tpu.ops import interp as jinterp
from vtoonify_tpu.ops import pallas_kernels as jpk
from vtoonify_tpu.train import augment as JA
from vtoonify_tpu.train import ema as JE
from vtoonify_tpu.train import losses as JLS
from vtoonify_tpu_torch.convert.from_jax import load_jax_params
from vtoonify_tpu_torch.models import dualstylegan as D
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.models import lpips as LP
from vtoonify_tpu_torch.models import psp_encoder as P
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops import interp, kernels
from vtoonify_tpu_torch.ops import upfirdn2d as up
from vtoonify_tpu_torch.train import augment as A
from vtoonify_tpu_torch.train import ema as E
from vtoonify_tpu_torch.train import losses as LS

jup = __import__("vtoonify_tpu.ops.upfirdn2d", fromlist=["upfirdn2d"])

# the generator stages at 64 px (256 ch, JAX unpacked) and 128 px (128 ch,
# JAX space-to-depth packed) are both held to the port's one form
GEN_CFG = dict(size=128, channel_multiplier=1, channel_max=256)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# augment: 12-tap wavelet passes, affine warp (B5), random_apply_affine


@pytest.mark.parametrize("kshape,up_,down,pad", [
    ((1, 12), (2, 1), (1, 1), (6, 5, 0, 0)),     # augment x2 up, x axis
    ((12, 1), (1, 2), (1, 1), (0, 0, 6, 5)),     # ... y axis
    ((1, 12), (1, 1), (2, 1), (-1, -1, 0, 0)),   # augment x2 down, x axis
    ((12, 1), (1, 1), (1, 2), (0, 0, -1, -1)),   # ... y axis
])
def test_upfirdn2d_sym6_matches_jax(kshape, up_, down, pad):
    rng = np.random.RandomState(20)
    x = rng.randn(2, 20, 22, 6).astype(np.float32)
    k = np.asarray(JA.SYM6).reshape(kshape)
    ref = jup.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up_, down=down, pad=pad)
    got = up.upfirdn2d(_nchw(x), torch.from_numpy(k), up=up_, down=down, pad=pad)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-5)


def test_downsample_avg_pool_grid_sample_match_jax():
    rng = np.random.RandomState(21)
    x = rng.randn(2, 16, 12, 5).astype(np.float32)
    k1 = up.make_kernel([1, 3, 3, 1])
    np.testing.assert_allclose(
        _nhwc(up.downsample_2x(_nchw(x), k1)),
        np.asarray(jup.downsample_2x(jnp.asarray(x), jup.make_kernel([1, 3, 3, 1]))),
        atol=1e-5)
    np.testing.assert_allclose(_nhwc(interp.avg_pool(_nchw(x), 4)),
                               np.asarray(jinterp.avg_pool(jnp.asarray(x), 4)), atol=1e-6)
    grid = rng.uniform(-1.2, 1.2, (2, 7, 9, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _nhwc(interp.grid_sample(_nchw(x), torch.from_numpy(grid))),
        np.asarray(jinterp.grid_sample(jnp.asarray(x), jnp.asarray(grid))), atol=1e-5)


def test_affine_warp_plain_matches_pallas():
    """B5's plain version vs affine_warp_bilinear_pallas in interpret mode
    (HIGHEST precision: float32-exact) at tests/test_pallas.py's unaligned
    shape, on the pixel coefficients of the same affine. 1e-3, as
    tests/test_pallas.py holds these two formulations: the plain version
    goes through the normalized grid and back (two more float32 roundings
    of ~200 px coordinates, ~2e-5 px) on N(0, 1) pixels whose neighbours
    differ by up to ~8 (measured max 1.4e-4)."""
    rng = np.random.RandomState(11)
    n, h, w, c = 1, 206, 210, 6
    ho, wo = 101, 103
    img = rng.randn(n, h, w, c).astype(np.float32)
    theta = np.tile(np.eye(2, 3, dtype=np.float32), (n, 1, 1))
    a = 0.2
    theta[0, :2, :2] = np.array([[np.cos(a), -np.sin(a)],
                                 [np.sin(a), np.cos(a)]]) * 1.05
    theta[0, :, 2] = [0.21, -0.13]
    coef = np.asarray(JA._pixel_affine_coefs(jnp.asarray(theta), (ho, wo), (h, w)))
    np.testing.assert_allclose(
        A._pixel_affine_coefs(torch.from_numpy(theta), (ho, wo), (h, w)).numpy(),
        coef, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        A._affine_grid(torch.from_numpy(theta), (ho, wo)).numpy(),
        np.asarray(JA._affine_grid(jnp.asarray(theta), (ho, wo))), atol=1e-6)
    ref = jpk.affine_warp_bilinear_pallas(jnp.asarray(img), jnp.asarray(coef),
                                          (ho, wo), interpret=True)
    got = kernels.affine_warp_plain(_nchw(img), torch.from_numpy(coef), (ho, wo))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=1e-3)


def test_random_apply_affine_matches_jax():
    """The whole augment with a given inverse affine G (the parity hook):
    reflect pad, SYM6 x2 up, warp, SYM6 x2 down. JAX on the CPU warps with
    its XLA grid_sample on the normalized grid, the port with B5's plain
    version on the pixel coefficients: 2e-4 (as tests/test_train.py holds
    JAX to the reference)."""
    rng = np.random.RandomState(50)
    img = rng.randn(2, 32, 32, 6).astype(np.float32)
    Gs = []
    for t in rng.uniform(-0.5, 0.5, size=(2,)):
        c, s = np.cos(t), np.sin(t)
        sc = 1.0 + 0.1 * rng.randn()
        Gs.append(np.linalg.inv(np.array([[c * sc, -s, 0.05], [s, c * sc, -0.03],
                                          [0, 0, 1]])))
    Gm = np.stack(Gs).astype(np.float32)
    ref, _ = JA.random_apply_affine(jnp.asarray(img), 0.2, G=jnp.asarray(Gm), max_pad=31)
    got, g_out = A.random_apply_affine(_nchw(img), 0.2, G=torch.from_numpy(Gm), max_pad=31)
    assert got.shape == (2, 6, 32, 32) and torch.equal(g_out, torch.from_numpy(Gm))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=2e-4, rtol=1e-3)


def test_sample_affine_is_mild():
    g = torch.Generator().manual_seed(0)
    Gm = A.sample_affine(g, 0.2, 64, 32, 32)
    assert Gm.shape == (64, 3, 3) and torch.isfinite(Gm).all()
    dev = torch.linalg.matrix_norm(Gm - torch.eye(3))
    assert float(dev.median()) < 1.5
    assert (dev == 0).float().mean() > 0.05      # p = 0.2: some draws are identity
    img = torch.randn(2, 6, 32, 32, generator=g)
    out, Ginv = A.random_apply_affine(img, 1.0, generator=g, max_pad=31)
    assert out.shape == img.shape and torch.isfinite(out).all() and Ginv.shape == (2, 3, 3)


# ---------------------------------------------------------------------------
# layers and models


def test_styled_conv_noise_res_block_prelu_match_jax():
    rng = np.random.RandomState(22)
    key = jax.random.PRNGKey(22)
    k1, k2 = jax.random.split(key)
    jsc = _np(JL.init_styled_conv(k1, 8, 16, 3, 32))
    jsc["noise"]["weight"] = np.float32(0.3)
    jsc["act_bias"] = rng.randn(16).astype(np.float32)
    sc = load_jax_params(L.StyledConv(8, 16, 3, 32), jsc)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    style = rng.randn(2, 32).astype(np.float32)
    for upsample, size in ((False, 8), (True, 16)):
        noise = rng.randn(2, size, size, 1).astype(np.float32)
        ref = JL.styled_conv(jsc, jnp.asarray(x), jnp.asarray(style),
                             noise=jnp.asarray(noise), upsample=upsample)
        got = L.styled_conv(sc, _nchw(x), torch.from_numpy(style),
                            noise=_nchw(noise), upsample=upsample)
        _close(_nhwc(got), ref)
    jrb = _np(JL.init_res_block(k2, 8, 16))
    rb = load_jax_params(L.ResBlock(8, 16), jrb)
    _close(_nhwc(L.res_block(rb, _nchw(x))), JL.res_block(jrb, jnp.asarray(x)))
    pw = {"weight": rng.rand(8).astype(np.float32)}
    pr = load_jax_params(L.PReLU(8), pw)
    np.testing.assert_array_equal(_nhwc(L.prelu(pr, _nchw(x))),
                                  np.asarray(JL.prelu(pw, jnp.asarray(x))))


@functools.lru_cache(maxsize=None)
def _dualstylegan_pair():
    jcfg = JD.DualStyleGANConfig(**GEN_CFG)
    jp = _np(jax.jit(JD.init_dualstylegan, static_argnums=1)(jax.random.PRNGKey(23), jcfg))
    rng = np.random.RandomState(23)
    gen = jp["generator"]
    for blk in [gen["conv1"], *gen["convs"]]:
        blk["noise"]["weight"] = np.float32(rng.uniform(0.05, 0.3))
        blk["act_bias"] = (rng.randn(*blk["act_bias"].shape) * 0.3).astype(np.float32)
    cfg = D.DualStyleGANConfig(**GEN_CFG)
    return jcfg, jp, cfg, load_jax_params(D.init_dualstylegan(cfg), jp)


def _noise_pair(jp, jcfg, seed, batch=2):
    jn = JG.make_noise(jp, jcfg, jax.random.PRNGKey(seed), randomize=True, batch=batch)
    return jn, [_nchw(n) for n in jn]


@pytest.mark.parametrize("return_feature_ind", [999, 6])
def test_generator_apply_with_noise_matches_jax(return_feature_ind):
    jdcfg, jdp, _, dp = _dualstylegan_pair()
    jcfg, jp, p = jdcfg.generator, jdp["generator"], dp.generator
    cfg = G.GeneratorConfig(**GEN_CFG)
    rng = np.random.RandomState(24)
    latent = rng.randn(2, cfg.n_latent, 512).astype(np.float32)
    jn, tn = _noise_pair(jp, jcfg, 24)
    ref = JG.generator_apply(jp, jcfg, jnp.asarray(latent), noise=jn,
                             return_feature_ind=return_feature_ind)
    got = G.generator_apply(p, cfg, torch.from_numpy(latent), noise=tn,
                            return_feature_ind=return_feature_ind)
    if return_feature_ind == 999:
        ref, got = (ref,), (got,)
    for r, g in zip(ref, got):
        _close(_nhwc(g), r, 1e-3)
    img = G.generate(p, cfg, [torch.from_numpy(latent[:, 0])], noise=tn)
    _close(_nhwc(img), JG.generate(jp, jcfg, [jnp.asarray(latent[:, 0])], noise=jn), 1e-3)


@pytest.mark.parametrize("return_feat", [False, True])
def test_dualstylegan_apply_matches_jax(return_feat):
    jcfg, jp, cfg, p = _dualstylegan_pair()
    rng = np.random.RandomState(25)
    ws = rng.randn(2, cfg.n_latent, 512).astype(np.float32)
    ex = rng.randn(2, cfg.n_latent, 512).astype(np.float32)
    wts = [0.6] * 7 + [0.8] * (cfg.n_latent - 7)
    jn, tn = _noise_pair(jp["generator"], jcfg.generator, 25)
    ref = JD.dualstylegan_apply(jp, jcfg, [jnp.asarray(ws)], jnp.asarray(ex),
                                input_is_latent=True, noise=jn, use_res=True,
                                interp_weights=wts, return_feat=return_feat)
    got = D.dualstylegan_apply(p, cfg, [torch.from_numpy(ws)], torch.from_numpy(ex),
                               input_is_latent=True, noise=tn, use_res=True,
                               interp_weights=wts, return_feat=return_feat)
    if not return_feat:
        ref, got = (ref,), (got,)
    for r, g in zip(ref, got):
        _close(_nhwc(g), r, 1e-3)


def test_vtoonify_return_mask_and_feat_match_jax():
    kw = dict(in_size=32, out_size=128, num_res_layers=2, **GEN_CFG)
    kw.pop("size")
    jcfg = JV.VToonifyConfig(**kw)
    jp = _np(jax.jit(JV.init_vtoonify, static_argnums=1)(jax.random.PRNGKey(26), jcfg))
    cfg = V.VToonifyConfig(**kw)
    p = load_jax_params(V.init_vtoonify(cfg), jp)
    rng = np.random.RandomState(26)
    x = rng.uniform(-1, 1, (2, 32, 32, 22)).astype(np.float32)
    style = rng.randn(2, cfg.n_latent, 512).astype(np.float32)
    img, masks = JV.vtoonify_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(style), 0.5,
                                   return_mask=True)
    got, got_masks = V.vtoonify_apply(p, cfg, _nchw(x), torch.from_numpy(style), 0.5,
                                      return_mask=True)
    _close(_nhwc(got), img, 1e-3)
    assert len(got_masks) == len(masks) == 1
    _close(_nhwc(got_masks[0]), masks[0], 1e-3)
    feat = JV.vtoonify_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(style), 0.5,
                             return_feat=True)
    got_feat = V.vtoonify_apply(p, cfg, _nchw(x), torch.from_numpy(style), 0.5,
                                return_feat=True)
    for r, g in zip(feat, got_feat):
        _close(_nhwc(g), r, 1e-4)


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


def test_psp_encoder_matches_jax():
    """IR-SE-50 + FPN heads at a 64 px input (the heads' stride-2 convs
    bottom out at 1x1), batch 2, with latent_avg."""
    jcfg = JP.PSPEncoderConfig(n_styles=12)
    jp = _np(jax.jit(JP.init_psp_encoder, static_argnums=1)(jax.random.PRNGKey(27), jcfg))
    rng = np.random.RandomState(27)
    _randomize_bn(jp, rng)
    cfg = P.PSPEncoderConfig(n_styles=12)
    p = load_jax_params(P.init_psp_encoder(cfg), jp)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    la = rng.randn(12, 512).astype(np.float32)
    ref = JP.psp_encoder_apply(jp, jcfg, jnp.asarray(x), latent_avg=jnp.asarray(la))
    got = P.psp_encoder_apply(p, cfg, _nchw(x), latent_avg=torch.from_numpy(la))
    assert got.shape == (2, 12, 512)
    _close(got.numpy(), ref, 1e-3)


def test_lpips_matches_jax():
    jp = _np(jax.jit(JLP.init_lpips)(jax.random.PRNGKey(28)))
    p = load_jax_params(LP.init_lpips(), jp)
    rng = np.random.RandomState(28)
    x0, x1 = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    ref = JLP.lpips_apply(jp, jnp.asarray(x0), jnp.asarray(x1))
    got = LP.lpips_apply(p, _nchw(x0), _nchw(x1))
    assert got.shape == (2, 1, 1, 1)
    _close(got.numpy().reshape(-1), np.asarray(ref).reshape(-1), 1e-4)


@pytest.mark.parametrize("use_condition", [True, False])
def test_cond_discriminator_matches_jax(use_condition):
    jcfg = JV.CondDiscriminatorConfig(size=64, channel_multiplier=1,
                                      use_condition=use_condition, style_num=3)
    jp = _np(jax.jit(JV.init_cond_discriminator, static_argnums=1)(
        jax.random.PRNGKey(29), jcfg))
    rng = np.random.RandomState(29)
    for blk in jp["blocks"]:  # zero at init; random values exercise B2's bias
        for cl in (blk["conv1"], blk["conv2"]):
            cl["act_bias"] = (rng.randn(*cl["act_bias"].shape) * 0.3).astype(np.float32)
    cfg = V.CondDiscriminatorConfig(size=64, channel_multiplier=1,
                                    use_condition=use_condition, style_num=3)
    p = load_jax_params(V.init_cond_discriminator(cfg), jp)
    x = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    lab = rng.rand(4, 1).astype(np.float32)
    ind = np.array([0, 2, 1, 2])
    ref = JV.cond_discriminator_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(lab),
                                      jnp.asarray(ind))
    got = V.cond_discriminator_apply(p, cfg, _nchw(x), torch.from_numpy(lab),
                                     torch.from_numpy(ind))
    assert got.shape == (4, 1)
    _close(got.detach().numpy(), ref, 1e-4)


def test_losses_and_ema_match_jax():
    rng = np.random.RandomState(30)
    r, f = (rng.randn(8, 1).astype(np.float32) * 3 for _ in range(2))
    t = torch.from_numpy
    np.testing.assert_allclose(float(LS.d_logistic_loss(t(r), t(f))),
                               float(JLS.d_logistic_loss(r, f)), rtol=1e-6)
    np.testing.assert_allclose(float(LS.g_nonsaturating_loss(t(f))),
                               float(JLS.g_nonsaturating_loss(f)), rtol=1e-6)
    np.testing.assert_allclose(float(LS.mse_loss(t(r), t(f))),
                               float(JLS.mse_loss(r, f)), rtol=1e-6)
    masks = [rng.rand(2, 1, 8, 8).astype(np.float32) for _ in range(3)]
    for d_s in (0.0, 0.6, 1.0):
        np.testing.assert_allclose(
            float(LS.mask_loss([t(m) for m in masks], d_s, 0.0005)),
            float(JLS.mask_loss([jnp.asarray(m) for m in masks], d_s, 0.0005)),
            rtol=1e-6, atol=1e-12)
    e0, p0 = rng.randn(5, 3).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    em, pm = torch.nn.Linear(3, 5), torch.nn.Linear(3, 5)
    with torch.no_grad():
        em.weight.copy_(t(e0))
        pm.weight.copy_(t(p0))
    E.ema_update(em, pm)
    np.testing.assert_allclose(em.weight.detach().numpy(),
                               np.asarray(JE.ema_update({"w": e0}, {"w": p0})["w"]),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# gradients of the kernel wrappers' autograd Functions (float64, CPU: the
# plain forward, the Function's backward). The Functions are called directly:
# the public wrappers hold every device to the kernels' float32/bfloat16 rule,
# and gradcheck needs float64.


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_()


@pytest.mark.parametrize("form", ["modulated", "folded", "raw"])
def test_gradcheck_modconv3x3(form):
    rng = np.random.RandomState(31)
    x, w = _f64(rng, 2, 3, 5, 6), _f64(rng, 3, 3, 3, 4)
    s = _f64(rng, 2, 3) if form == "modulated" else None
    d = _f64(rng, 2, 4) if form == "modulated" else None
    b = _f64(rng, 4) if form != "raw" else None
    args = tuple(a for a in (x, w, s, d, b) if a is not None)

    def fn(*a):
        it = iter(a)
        return kernels._ModConv3x3.apply(next(it), next(it), *(
            next(it) if v is not None else None for v in (s, d, b)), 0.2,
            kernels.SQRT2)
    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("ndim", [2, 4])
def test_gradcheck_fused_leaky_relu(ndim):
    rng = np.random.RandomState(32)
    x = _f64(rng, *((3, 5) if ndim == 2 else (2, 3, 4, 5)))
    b = _f64(rng, x.shape[1])
    assert torch.autograd.gradcheck(
        lambda a, c: kernels._FusedLeakyReLU.apply(a, c, 0.2, kernels.SQRT2), (x, b))


@pytest.mark.parametrize("kshape,up_,down,pad", [
    ((4, 4), (2, 2), (1, 1), (2, 1, 2, 1)),      # ToRGB's upsample_2x
    ((4, 4), (1, 1), (2, 2), (1, 1, 1, 1)),      # synth.down / D blur-down
    ((1, 12), (2, 1), (1, 1), (6, 5, 0, 0)),     # augment SYM6 x2 up
    ((12, 1), (1, 1), (1, 2), (0, 0, -1, -1)),   # augment SYM6 x2 down
    ((5, 3), (1, 2), (2, 1), (-2, 1, 3, -1)),    # mixed, signed pads
])
def test_gradcheck_upfirdn2d(kshape, up_, down, pad):
    rng = np.random.RandomState(33)
    x = _f64(rng, 1, 2, 15, 16)
    k = torch.from_numpy(rng.rand(*kshape))
    assert torch.autograd.gradcheck(
        lambda t: kernels._UpFirDn2d.apply(t, k, up_, down, pad), (x,))


@pytest.mark.parametrize("phase_minor", [False, True])
def test_gradcheck_depth_to_space2(phase_minor):
    x = _f64(np.random.RandomState(34), 2, 8, 3, 5)
    assert torch.autograd.gradcheck(
        lambda t: kernels._DepthToSpace2.apply(t, phase_minor), (x,))


def test_gradcheck_affine_warp():
    """Image and coefficient gradients; the coefficients are kept off the
    integer-coordinate kinks of bilinear sampling by a random offset."""
    rng = np.random.RandomState(35)
    img = _f64(rng, 2, 3, 9, 10)
    coef = torch.tensor([[1.1, 0.2, -0.7, -0.15, 0.9, 0.3],
                         [0.8, -0.1, 1.3, 0.05, 1.2, -0.4]], dtype=torch.float64)
    coef = (coef + torch.from_numpy(rng.rand(2, 6) * 0.02)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, c: kernels._AffineWarp.apply(a, c, (7, 8)), (img, coef))


# ---------------------------------------------------------------------------
# entry points run on the card unless asked for the CPU


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
    from vtoonify_tpu_torch.train.steps import TrainDConfig, init_train_d_state

    cfg = V.VToonifyConfig(in_size=32, out_size=64, channel_multiplier=1,
                           channel_max=32, num_res_layers=1)
    g = torch.Generator().manual_seed(0)
    vt, parsing = V.init_vtoonify(cfg, g), init_bisenet(generator=g)
    d = V.init_cond_discriminator(V.CondDiscriminatorConfig(
        size=64, channel_multiplier=1, channel_max=32, use_condition=True,
        style_num=2), g)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ToonifyPipeline(vt, cfg, parsing)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_d_state(vt, d, 2, cfg, TrainDConfig())
    pipe = ToonifyPipeline(vt, cfg, parsing, dtype=torch.float32, device="cpu")
    out = pipe.process_image(np.zeros((32, 32, 3), np.uint8), np.zeros(
        (1, cfg.n_latent, 512), np.float32), 0.5)
    assert out.shape == (64, 64, 3)
    state = init_train_d_state(vt, d, 2, cfg, TrainDConfig(), device="cpu")
    assert state.wc_prev.device.type == "cpu"
    assert all(p.requires_grad for p in state.trainable.parameters())
    assert all(p.requires_grad for p in state.d.parameters())
    assert not any(p.requires_grad for p in vt.generator.parameters())
    assert not any(p.requires_grad for p in state.ema.parameters())
