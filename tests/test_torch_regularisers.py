"""Second-order gradients through the port's kernels (ops/kernels.py), the
GAN regularisers and their noise (train/losses.py), and the rest of the conv
surface (ops/convs.py::conv_transpose2d, nn/layers.py::modulated_conv2d's
non-fused up and down convs), against the JAX package on the CPU.

* Functions: `torch.autograd.gradgradcheck` in float64 on each autograd
  Function (B5 in the image; its coef has no second derivative and
  raises), and the second-order gradient through each wrapper in float32
  against autograd through its plain version: float32 sums in another
  order, so 1e-5 of the largest value.
* R1 and the path-length penalty: a 32 px Discriminator and Generator at
  narrow widths (channel_max 32), JAX-initialised and carried by
  `load_jax_params`; the penalty and its gradients w.r.t. every parameter
  against `jax.grad` of the JAX function on the same inputs, to 1e-4
  relative (float32 through two backward passes of ~20 layers).
* Convs: against the JAX package's on the same arrays, to 1e-5 (float32
  conv sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.models import generator as JG
from vtoonify_tpu.nn import layers as JL
from vtoonify_tpu.ops import convs as JC
from vtoonify_tpu.ops.fused_act import fused_leaky_relu as j_fused_leaky_relu
from vtoonify_tpu.train import losses as JLS
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict, load_jax_params
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops import convs as C
from vtoonify_tpu_torch.ops import kernels as K
from vtoonify_tpu_torch.train import losses as LS

SQRT2 = 2 ** 0.5
F64 = torch.float64


def _t(rng, *shape, scale=1.0, shift=0.0, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape) * scale + shift).to(dtype)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-12))


# ---------------------------------------------------------------------------
# the Functions, twice differentiated

_K3 = torch.outer(torch.tensor([1.0, 3.0, 3.0, 1.0]),
                  torch.tensor([1.0, 3.0, 2.0, 1.0, 5.0])) / 96
_COEF = ((0.913, 0.217, 0.331, -0.107, 1.119, 0.437),
         (1.213, -0.317, -0.523, 0.251, 0.811, 1.339))


def _function_cases(rng, dtype):
    """name -> (the Function's call, its plain version, inputs): one small
    case of each kernel, with the operands every form takes."""
    t = lambda *s, **kw: _t(rng, *s, dtype=dtype, **kw)  # noqa: E731
    coef = torch.tensor(_COEF, dtype=dtype)
    k3 = _K3.to(dtype)
    return {
        "modconv3x3": (lambda *a: K._ModConv3x3.apply(*a, 0.2, SQRT2),
                       lambda *a: K.modconv3x3_plain(*a, 0.2, SQRT2),
                       (t(2, 3, 5, 6), t(3, 3, 3, 4, scale=0.3),
                        t(2, 3, scale=0.1, shift=1.0), t(2, 4, scale=0.1, shift=1.0),
                        t(4, scale=0.1))),
        "fused_leaky_relu": (lambda x, b: K._FusedLeakyReLU.apply(x, b, 0.2, SQRT2),
                             lambda x, b: K.fused_leaky_relu_plain(x, b, 0.2, SQRT2),
                             (t(2, 3, 4, 5), t(3))),
        "upfirdn2d_up": (lambda x: K._UpFirDn2d.apply(x, k3, (2, 2), (1, 1), (2, 1, 2, 1)),
                         lambda x: K.upfirdn2d_plain(x, k3, (2, 2), (1, 1), (2, 1, 2, 1)),
                         (t(2, 2, 5, 6),)),
        "upfirdn2d_down": (lambda x: K._UpFirDn2d.apply(x, k3, (1, 1), (2, 2), (1, 2, 2, 1)),
                           lambda x: K.upfirdn2d_plain(x, k3, (1, 1), (2, 2), (1, 2, 2, 1)),
                           (t(2, 2, 7, 6),)),
        "upfirdn2d_mixed": (lambda x: K._UpFirDn2d.apply(x, k3, (2, 1), (1, 2), (-1, 2, 1, 1)),
                            lambda x: K.upfirdn2d_plain(x, k3, (2, 1), (1, 2), (-1, 2, 1, 1)),
                            (t(1, 2, 6, 5),)),
        "depth_to_space2": (lambda x: K._DepthToSpace2.apply(x, True),
                            lambda x: K.depth_to_space2_plain(x, True), (t(2, 8, 3, 4),)),
        # the gather form: F.grid_sample is not twice differentiable on
        # every torch version
        "affine_warp": (lambda x: K._AffineWarp.apply(x, coef, (6, 9)),
                        lambda x: K.affine_warp_gather_plain(x, coef, (6, 9)),
                        (t(2, 3, 7, 8),)),
    }


_FUNCTIONS = list(_function_cases(np.random.RandomState(0), F64))


@pytest.mark.parametrize("name", _FUNCTIONS)
def test_functions_pass_gradgradcheck(name):
    """Every Function's double backward (float64, on the Functions
    themselves: the wrappers take float32 and bfloat16 only)."""
    fn, _, inputs = _function_cases(np.random.RandomState(1), F64)[name]
    inputs = tuple(x.requires_grad_() for x in inputs)
    assert torch.autograd.gradgradcheck(fn, inputs)


def test_affine_warp_coef_has_no_second_derivative():
    """B5's coef gradient is right to first order, and its second
    derivative in coef (through the coef gradient and through the image
    gradient's dependence on coef) passes gradgradcheck in float64; the test
    keeps the name it had while that second derivative raised."""
    rng = np.random.RandomState(2)
    img = _t(rng, 2, 3, 7, 8, dtype=F64).requires_grad_()
    coef = torch.tensor(_COEF, dtype=F64, requires_grad=True)
    warp = lambda i, c: K._AffineWarp.apply(i, c, (6, 9))  # noqa: E731
    assert torch.autograd.gradcheck(warp, (img, coef))
    assert torch.autograd.gradgradcheck(warp, (img, coef))
    assert torch.autograd.gradgradcheck(lambda c: warp(img.detach(), c), (coef,))


_THETA = ((( 0.93, -0.21, 0.137), (0.19, 1.08, -0.113)),
          ((1.12, 0.31, -0.261), (-0.27, 0.87, 0.171)))


def test_affine_warp_second_derivative_in_theta_matches_jax(monkeypatch):
    """The second derivative of the augment's warp (train/augment.py::
    _affine_warp) in its affine theta and in the image, through the
    gradient of <warp, v1>, against jax.grad of jax.vjp of the JAX
    package's `_affine_warp` on the same inputs (its Pallas path forced in
    interpret mode, so the custom_vjp's backward is what JAX differentiates
    again). float32 on both sides; within 1e-4 of the largest value. The
    theta keep every sample off the bilinear kinks."""
    import vtoonify_tpu.train.augment as JA
    from vtoonify_tpu_torch.train import augment as A

    rng = np.random.RandomState(5)
    out_hw = (6, 9)
    img = rng.randn(2, 7, 8, 3).astype(np.float32)
    theta = np.asarray(_THETA, np.float32)
    v1 = rng.randn(2, *out_hw, 3).astype(np.float32)
    v2_img = rng.randn(*img.shape).astype(np.float32)
    v2_theta = rng.randn(*theta.shape).astype(np.float32)

    monkeypatch.setattr(JA, "_FORCE_KERNEL", True)
    monkeypatch.setattr(JA, "_INTERPRET", True)

    def inner(a, t):
        _, vjp = jax.vjp(lambda a_, t_: JA._affine_warp(a_, t_, out_hw), a, t)
        ga, gt = vjp(jnp.asarray(v1))
        return (ga * v2_img).sum() + (gt * v2_theta).sum(), (ga, gt)

    (want_img, want_theta), (g1_img, g1_theta) = jax.grad(
        inner, argnums=(0, 1), has_aux=True)(jnp.asarray(img), jnp.asarray(theta))

    leaves = [torch.from_numpy(_nchw(img).numpy()).requires_grad_(),
              torch.from_numpy(theta).requires_grad_()]
    y = A._affine_warp(leaves[0], leaves[1], out_hw)
    gi, gt = torch.autograd.grad((y * _nchw(v1)).sum(), leaves, create_graph=True)
    got_img, got_theta = torch.autograd.grad(
        (gi * _nchw(v2_img)).sum() + (gt * torch.from_numpy(v2_theta)).sum(), leaves)

    assert _rel(gi.detach(), _nchw(g1_img)) <= 1e-4
    assert _rel(gt.detach(), g1_theta) <= 1e-4
    assert _rel(got_img, _nchw(want_img)) <= 1e-4
    assert _rel(got_theta, want_theta) <= 1e-4


def test_affine_warp_gather_plain_matches_grid_sample():
    """B5's second-order oracle (explicit gathers on the pixel coordinates)
    is the plain version's function, value and gradients, in float64, with
    samples outside the image."""
    rng = np.random.RandomState(4)
    img = _t(rng, 2, 3, 9, 11, dtype=F64)
    coef = torch.tensor(_COEF, dtype=F64) * torch.tensor([1.4, 1.4, 3.0, 1.4, 1.4, 3.0],
                                                          dtype=F64)
    outs = []
    for fn in (K.affine_warp_plain, K.affine_warp_gather_plain):
        i, c = img.clone().requires_grad_(), coef.clone().requires_grad_()
        y = fn(i, c, (7, 10))
        outs.append([y, *torch.autograd.grad((y * y).sum(), (i, c))])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _second_order(fn, inputs, v1, v2):
    """d/d(inputs, v1) <d/d(inputs) <fn(inputs), v1>, v2>: the gradient of
    a gradient, as R1 and the path penalty take it, where the incoming
    gradient v1 carries history too (zero where a term vanishes)."""
    leaves = [x.detach().clone().requires_grad_() for x in (*inputs, v1)]
    g1 = torch.autograd.grad((fn(*leaves[:-1]) * leaves[-1]).sum(), leaves[:-1],
                             create_graph=True)
    inner = sum((g * v).sum() for g, v in zip(g1, v2))
    return [g.detach() for g in g1], torch.autograd.grad(
        inner, leaves, allow_unused=True, materialize_grads=True)


_WRAPPERS = {
    "modconv3x3": lambda x, w, s, d, b: K.modconv3x3(x, w, s, d, b),
    "fused_leaky_relu": K.fused_leaky_relu,
    "upfirdn2d_up": lambda x: K.upfirdn2d(x, _K3, (2, 2), (1, 1), (2, 1, 2, 1)),
    "upfirdn2d_down": lambda x: K.upfirdn2d(x, _K3, (1, 1), (2, 2), (1, 2, 2, 1)),
    "upfirdn2d_mixed": lambda x: K.upfirdn2d(x, _K3, (2, 1), (1, 2), (-1, 2, 1, 1)),
    "depth_to_space2": lambda x: K.depth_to_space2(x, True),
    "affine_warp": lambda x: K.affine_warp(x, torch.tensor(_COEF), (6, 9)),
}


@pytest.mark.parametrize("name", _FUNCTIONS)
def test_wrappers_second_order_match_plain(name):
    """Second-order gradients through each wrapper (float32, the CPU
    dispatch) against autograd through its plain version, within 1e-5 of
    the largest value (float32 sums in another order)."""
    rng = np.random.RandomState(3)
    _, plain, inputs = _function_cases(rng, torch.float32)[name]
    out = plain(*inputs)
    v1 = _t(rng, *out.shape)
    v2 = [_t(rng, *x.shape) for x in inputs]
    got = _second_order(_WRAPPERS[name], inputs, v1, v2)
    want = _second_order(plain, inputs, v1, v2)
    for a, b in zip(got[0] + list(got[1]), want[0] + list(want[1])):
        assert _rel(a, b) <= 1e-5, name


# ---------------------------------------------------------------------------
# R1 and the path-length penalty against the JAX package

DCFG = dict(size=32, channel_multiplier=1, channel_max=32)
GCFG = dict(size=32, style_dim=32, n_mlp=2, channel_multiplier=1, channel_max=32)


def _grads_agree(jax_grads, port_module, rtol=1e-4):
    """The JAX gradient tree (laid out for the port by `jax_state_dict`)
    against the port's `.grad`s, parameter by parameter, relative to the
    largest gradient of each. A parameter the penalty does not reach (the
    last biases of R1: the input gradient does not depend on them) has no
    `.grad`, and JAX's is zero.
    """
    want = jax_state_dict(jax.tree_util.tree_map(np.asarray, jax_grads))
    got = dict(port_module.named_parameters())
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k].grad
        if g is None:
            g = torch.zeros(w.shape)
        assert _rel(g, w) <= rtol, (k, _rel(g, w))


def test_d_r1_loss_matches_jax():
    """R1 through the Discriminator (B2 in every conv layer, B3 in every
    downsampling blur, each differentiated twice) and its gradient w.r.t.
    the D parameters, against JAX's d_r1_loss and jax.grad of it."""
    jcfg, cfg = JG.DiscriminatorConfig(**DCFG), G.DiscriminatorConfig(**DCFG)
    params = JG.init_discriminator(jax.random.PRNGKey(3), jcfg)
    d = L.set_trainable(load_jax_params(G.init_discriminator(cfg), params))
    real = np.random.RandomState(4).randn(4, 32, 32, 3).astype(np.float32)

    def loss(ps):
        return JLS.d_r1_loss(lambda q, x: JG.discriminator_apply(q, jcfg, x), ps,
                             jnp.asarray(real))

    want, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    got = LS.d_r1_loss(lambda x: G.discriminator_apply(d, cfg, x), _nchw(real))
    got.backward()
    assert _rel(got.item(), float(want)) <= 1e-4
    _grads_agree(jgrads, d)


def test_g_path_regularize_matches_jax():
    """The path-length penalty through the mapping network and the
    synthesis (B1 plain and polyphase up convs, B4, B2 after the noise, B3
    on the ToRGB skips, each differentiated twice), its new mean and path
    lengths, and the penalty's gradient w.r.t. every generator parameter,
    against JAX's g_path_regularize and jax.grad of it."""
    jcfg, cfg = JG.GeneratorConfig(**GCFG), G.GeneratorConfig(**GCFG)
    params = JG.init_generator(jax.random.PRNGKey(5), jcfg)
    rng = np.random.RandomState(6)
    for blk in [params["conv1"], *params["convs"]]:  # non-zero noise and bias
        blk["noise"]["weight"] = jnp.float32(rng.uniform(0.05, 0.2))
        blk["act_bias"] = jnp.asarray(rng.randn(*blk["act_bias"].shape) * 0.3, jnp.float32)
    gen = L.set_trainable(load_jax_params(G.init_generator(cfg), params))
    z = rng.randn(2, 32).astype(np.float32)
    noise_maps = [rng.randn(2, s, s, 1).astype(np.float32)
                  for s in (2 ** ((i + 5) // 2) for i in range(jcfg.num_layers))]
    img_noise = (rng.randn(2, 32, 32, 3) / 32).astype(np.float32)
    mean0 = 0.7

    def penalty(ps):
        lat = jnp.broadcast_to(JG.style_mlp(ps, jcfg, jnp.asarray(z))[:, None],
                               (2, jcfg.n_latent, 32))
        out = JLS.g_path_regularize(
            lambda w: JG.generator_apply(ps, jcfg, w, noise=[jnp.asarray(n) for n in noise_maps]),
            lat, mean0, noise=jnp.asarray(img_noise))
        return out[0], out[1:]

    (want, (jmean, jlengths)), jgrads = jax.jit(
        jax.value_and_grad(penalty, has_aux=True))(params)
    lat = G.styles_to_latent(gen, cfg, [torch.from_numpy(z)])
    got, mean, lengths = LS.g_path_regularize(
        lambda w: G.generator_apply(gen, cfg, w, noise=[_nchw(n) for n in noise_maps]),
        lat, mean0, noise=_nchw(img_noise))
    assert not mean.requires_grad
    got.backward()
    assert _rel(got.item(), float(want)) <= 1e-4
    assert _rel(mean.item(), float(jmean)) <= 1e-5
    assert _rel(lengths.detach(), jlengths) <= 1e-5
    _grads_agree(jgrads, gen)


def test_up_conv_trains_after_an_inference_mode_call():
    """The polyphase up conv's cached blur scatter, first made under
    torch.inference_mode (a serving call), is saved by autograd in a later
    training call (the path penalty's double backward) without error."""
    L._upsample_blur_taps.cache_clear()
    L._blur_1d.cache_clear()
    rng = np.random.RandomState(11)
    conv = L.StyledConv(4, 4, 3, 8)
    x, style = _t(rng, 2, 4, 5, 5), _t(rng, 2, 8)
    with torch.inference_mode():
        want = L.styled_conv(conv, x, style, upsample=True)
    L.set_trainable(conv)
    got = L.styled_conv(conv, x, style, upsample=True)
    (g,) = torch.autograd.grad(got.square().sum(), conv.conv.weight, create_graph=True)
    g.square().sum().backward()
    torch.testing.assert_close(got.detach(), want)
    assert conv.conv.weight.grad is not None


def test_make_z_noise_and_mixing_noise():
    """Shapes and branches (reference util.py:111-126), from a seeded
    torch.Generator."""
    g = torch.Generator().manual_seed(7)
    assert LS.make_z_noise(g, 4, 16, 1).shape == (4, 16)
    two = LS.make_z_noise(g, 4, 16, 2)
    assert len(two) == 2 and all(z.shape == (4, 16) for z in two)
    assert not torch.equal(two[0], two[1])
    assert len(LS.mixing_noise(g, 4, 16, 0.0)) == 1
    assert len(LS.mixing_noise(g, 4, 16, 1.0)) == 2
    a = LS.mixing_noise(torch.Generator().manual_seed(3), 4, 16, 0.5)
    b = LS.mixing_noise(torch.Generator().manual_seed(3), 4, 16, 0.5)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    counts = [len(LS.mixing_noise(g, 1, 2, 0.9)) for _ in range(200)]
    assert 150 <= counts.count(2) <= 200  # p = 0.9 of two codes


# ---------------------------------------------------------------------------
# the rest of the conv surface


@pytest.mark.parametrize("stride,padding,groups", [(2, 0, 1), (1, 1, 1), (2, 1, 2), (1, 0, 4)])
def test_conv_transpose2d_matches_jax(stride, padding, groups):
    """torch semantics with groups; the JAX (kh, kw, Cout // groups, Cin)
    weight carried to torch's layout by from_jax's 4-D rule."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 6, 7, 8).astype(np.float32)
    w = rng.randn(3, 3, 12 // groups, 8).astype(np.float32)
    want = JC.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                               padding=padding, groups=groups)
    wt = jax_state_dict({"weight": w})["weight"]
    assert wt.shape == (8, 12 // groups, 3, 3)
    got = C.conv_transpose2d(_nchw(x), wt, stride=stride, padding=padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), _nchw(want).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["up", "down"])
@pytest.mark.parametrize("shared_style", [False, True])
def test_modulated_conv2d_unfused_matches_jax(mode, shared_style):
    """The non-fused x2 up conv (transposed conv, then the blur) and the
    downsampling conv (the blur, then a stride-2 conv), per-sample styles
    and the shared-style fold, as JAX's tests/test_style_fold.py runs them;
    with styled_conv's bias + leaky-ReLU after (B2)."""
    rng = np.random.RandomState(9)
    p = JL.init_modulated_conv2d(jax.random.PRNGKey(10), 8, 12, 3, 32)
    port = load_jax_params(L.ModulatedConv2d(8, 12, 3, 32), p)
    x = rng.randn(3, 10, 10, 8).astype(np.float32)
    style = rng.randn(1 if shared_style else 3, 32).astype(np.float32)
    bias = (rng.randn(12) * 0.3).astype(np.float32)
    kw = dict(upsample=mode == "up", downsample=mode == "down")
    want = jax.jit(lambda p, x, s, b: j_fused_leaky_relu(
        JL.modulated_conv2d(p, x, s, fuse_upsample=False, **kw), b))(p, x, style, bias)
    got = L.modulated_conv2d(port, _nchw(x), torch.from_numpy(style), fuse_upsample=False,
                             act_bias=torch.from_numpy(bias), **kw)
    assert got.shape == ((3, 12, 20, 20) if mode == "up" else (3, 12, 5, 5))
    np.testing.assert_allclose(got.numpy(), _nchw(want).numpy(), rtol=1e-5, atol=1e-5)
