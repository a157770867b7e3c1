"""Port nn/layers.py vs the JAX package (CPU, float32).

The JAX init functions make the parameters, `load_jax_params` carries them
into the port's modules, and numpy-seeded inputs go through both. The
tolerances are float32 rounding of differently ordered sums (the port's
polyphase weights are composed in another order; the JAX shared-style fold
and the port's differ only in where float32 products round).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.nn import layers as JL
from vtoonify_tpu_torch.convert.from_jax import load_jax_params
from vtoonify_tpu_torch.nn import layers as L

STYLE_DIM = 64


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _port(module, jparams):
    return load_jax_params(module, jax.tree_util.tree_map(np.asarray, jparams))


def _inputs(seed, batch, cin, size, style_batch):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, size, size, cin).astype(np.float32)
    style = rng.randn(style_batch, STYLE_DIM).astype(np.float32)
    return x, style


@pytest.mark.parametrize("activation,lr_mul", [(False, 1.0), (True, 0.01)])
def test_equal_linear_and_pixel_norm_match_jax(activation, lr_mul):
    jp = JL.init_equal_linear(jax.random.PRNGKey(0), 32, 48, bias_init=0.3,
                              lr_mul=lr_mul)
    p = _port(L.EqualLinear(32, 48), jp)
    x = np.random.RandomState(1).randn(5, 32).astype(np.float32)
    ref = JL.equal_linear(jp, JL.pixel_norm(jnp.asarray(x)), lr_mul=lr_mul,
                          activation=activation)
    got = L.equal_linear(p, L.pixel_norm(torch.from_numpy(x)), lr_mul=lr_mul,
                         activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# (style batch, frame batch): (1, 3) takes the shared-style FOLD, (3, 3) and
# (1, 1) scale the activations (layers.py:304)
@pytest.mark.parametrize("style_batch,batch", [(1, 3), (3, 3), (1, 1)])
@pytest.mark.parametrize("upsample", [False, True])
def test_modulated_conv2d_matches_jax(style_batch, batch, upsample):
    cin, cout = 12, 20
    jp = JL.init_modulated_conv2d(jax.random.PRNGKey(2), cin, cout, 3,
                                  STYLE_DIM)
    p = _port(L.ModulatedConv2d(cin, cout, 3, STYLE_DIM), jp)
    x, style = _inputs(3, batch, cin, 7, style_batch)
    ref = JL.modulated_conv2d(jp, jnp.asarray(x), jnp.asarray(style),
                              upsample=upsample)
    got = L.modulated_conv2d(p, _nchw(x), torch.from_numpy(style),
                             upsample=upsample)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("style_batch,batch", [(1, 2), (2, 2)])
@pytest.mark.parametrize("upsample", [False, True])
def test_styled_conv_matches_jax(style_batch, batch, upsample):
    cin, cout = 16, 8
    jp = JL.init_styled_conv(jax.random.PRNGKey(4), cin, cout, 3, STYLE_DIM)
    jp["act_bias"] = jnp.asarray(np.random.RandomState(5).randn(cout), jnp.float32)
    p = _port(L.StyledConv(cin, cout, 3, STYLE_DIM), jp)
    x, style = _inputs(6, batch, cin, 9, style_batch)
    ref = JL.styled_conv(jp, jnp.asarray(x), jnp.asarray(style),
                         upsample=upsample)
    got = L.styled_conv(p, _nchw(x), torch.from_numpy(style), upsample=upsample)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("style_batch,batch", [(1, 2), (2, 2)])
def test_to_rgb_matches_jax(style_batch, batch):
    cin = 16
    jp = JL.init_to_rgb(jax.random.PRNGKey(7), cin, STYLE_DIM)
    rng = np.random.RandomState(8)
    jp["bias"] = jnp.asarray(rng.randn(1, 1, 1, 3), jnp.float32)
    p = _port(L.ToRGB(cin, STYLE_DIM), jp)
    x, style = _inputs(9, batch, cin, 10, style_batch)
    skip = rng.randn(batch, 5, 5, 3).astype(np.float32)
    ref = JL.to_rgb(jp, jnp.asarray(x), jnp.asarray(style), jnp.asarray(skip))
    got = L.to_rgb(p, _nchw(x), torch.from_numpy(style), _nchw(skip))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dilation,w", [(1, 1.0), (2, 0.7), (4, 0.0)])
def test_ada_res_block_matches_jax(dilation, w):
    fin = 16
    jp = JL.init_ada_res_block(jax.random.PRNGKey(10), fin, STYLE_DIM)
    rng = np.random.RandomState(11)
    # full-scale conv weights and biases so the residual branch matters
    for name in ("conv1", "conv2"):
        jp[name]["conv"]["weight"] = jnp.asarray(
            rng.randn(3, 3, fin, fin), jnp.float32)
        jp[name]["act_bias"] = jnp.asarray(rng.randn(fin), jnp.float32)
    p = _port(L.AdaResBlock(fin, STYLE_DIM), jp)
    x, style = _inputs(12, 2, fin, 11, 2)
    ref = JL.ada_res_block(jp, jnp.asarray(x), jnp.asarray(style), w=w,
                           dilation=dilation)
    got = L.ada_res_block(p, _nchw(x), torch.from_numpy(style), w=w,
                          dilation=dilation)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("ksize,downsample", [(3, False), (3, True), (1, True)])
def test_conv_layer_matches_jax(ksize, downsample):
    jp = JL.init_conv_layer(jax.random.PRNGKey(13), 6, 10, ksize,
                            bias=ksize == 3, activate=ksize == 3)
    p = _port(L.ConvLayer(6, 10, ksize, bias=ksize == 3, activate=ksize == 3), jp)
    x, _ = _inputs(14, 2, 6, 12, 1)
    ref = JL.conv_layer(jp, jnp.asarray(x), ksize, downsample=downsample,
                        activate=ksize == 3)
    got = L.conv_layer(p, _nchw(x), ksize, downsample=downsample,
                       activate=ksize == 3)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_norms_and_torch_layers_match_jax():
    rng = np.random.RandomState(15)
    x = rng.randn(2, 6, 7, 8).astype(np.float32)
    bn = {"weight": rng.rand(8) + 0.5, "bias": rng.randn(8),
          "running_mean": rng.randn(8), "running_var": rng.rand(8) + 0.5}
    bn = {k: jnp.asarray(v, jnp.float32) for k, v in bn.items()}
    p_bn = _port(L.BatchNorm2d(8), bn)
    np.testing.assert_allclose(
        _nhwc(L.batch_norm_2d(p_bn, _nchw(x))),
        np.asarray(JL.batch_norm_2d(bn, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _nhwc(L.instance_norm_2d(_nchw(x))),
        np.asarray(JL.instance_norm_2d(jnp.asarray(x))), rtol=1e-4, atol=1e-4)
    jc = JL.init_conv2d_torch(jax.random.PRNGKey(16), 8, 5, 3)
    pc = _port(L.Conv2dTorch(8, 5, 3), jc)
    np.testing.assert_allclose(
        _nhwc(L.conv2d_torch(pc, _nchw(x), stride=2, padding=1)),
        np.asarray(JL.conv2d_torch(jc, jnp.asarray(x), stride=2, padding=1)),
        rtol=1e-5, atol=1e-5)
    jl = JL.init_linear_torch(jax.random.PRNGKey(17), 8, 3)
    pl_ = _port(L.LinearTorch(8, 3), jl)
    v = x[:, 0, 0, :]
    np.testing.assert_allclose(
        L.linear_torch(pl_, torch.from_numpy(v)).numpy(),
        np.asarray(JL.linear_torch(jl, jnp.asarray(v))), rtol=1e-5, atol=1e-5)
