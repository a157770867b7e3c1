"""Port models and the frame graph vs the JAX package (CPU).

Tiny configuration: 32 px in, 128 px out, channel_multiplier 1 and
channel_max 256, 2 encoder res blocks. The 64 px stage (256 channels) runs
JAX's unpacked path and the 128 px stage (128 channels) its space-to-depth
packed path, so both JAX stage forms are held to the port's one form. JAX
params are made by the JAX init functions, given random styled-conv and
ToRGB biases (zero at init, which leaves a random-weight image nearly flat
grey and the uint8 comparison blind), and carried over with
`load_jax_params`. JAX runs jitted, as its pipeline does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.models import bisenet as JB
from vtoonify_tpu.models import vtoonify as JV
from vtoonify_tpu.pipeline import toonify as JT
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict, load_jax_params
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.parallel.mesh import make_mesh
from vtoonify_tpu_torch.pipeline import toonify as T

TINY = dict(in_size=32, out_size=128, channel_multiplier=1, channel_max=256,
            num_res_layers=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.fixture(scope="module")
def bisenet_pair():
    jp = _np_tree(JB.init_bisenet(jax.random.PRNGKey(1)))
    rng = np.random.RandomState(2)

    def randomize_bn(tree):  # non-trivial running stats and affine params
        if isinstance(tree, dict):
            if "running_var" in tree:
                c = tree["running_var"].shape[0]
                tree.update(weight=(rng.rand(c) + 0.5).astype(np.float32),
                            bias=(rng.randn(c) * 0.1).astype(np.float32),
                            running_mean=(rng.randn(c) * 0.1).astype(np.float32),
                            running_var=(rng.rand(c) + 0.5).astype(np.float32))
            for v in tree.values():
                randomize_bn(v)
        elif isinstance(tree, list):
            for v in tree:
                randomize_bn(v)

    randomize_bn(jp)
    return jp, load_jax_params(B.init_bisenet(), jp)


def _randomize_biases(gp, rng):
    for blk in gp["convs"]:
        blk["act_bias"] = (rng.randn(*blk["act_bias"].shape) * 0.5).astype(np.float32)
    for blk in gp["to_rgbs"]:
        blk["bias"] = (rng.randn(*blk["bias"].shape) * 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _vtoonify_pair(backbone):
    # the T backbone at channel_max 128 (all JAX stages packed) keeps its
    # JAX init short; D covers the unpacked stage
    cfg_kw = dict(TINY, channel_max=256 if backbone == "dualstylegan" else 128)
    jcfg = JV.VToonifyConfig(backbone=backbone, **cfg_kw)
    jp = _np_tree(JV.init_vtoonify(jax.random.PRNGKey(3), jcfg))
    gp = jp["generator"]["generator"] if backbone == "dualstylegan" else jp["generator"]
    _randomize_biases(gp, np.random.RandomState(9))
    cfg = V.VToonifyConfig(backbone=backbone, **cfg_kw)
    return jcfg, jp, cfg, load_jax_params(V.init_vtoonify(cfg), jp)


@pytest.fixture(params=["dualstylegan", "toonify"])
def vtoonify_pair(request):
    return _vtoonify_pair(request.param)


def test_bisenet_apply_matches_jax(bisenet_pair):
    jp, p = bisenet_pair
    x = np.random.RandomState(4).uniform(-2, 2, (2, 64, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JB.bisenet_apply)(jp, jnp.asarray(x)))
    got = B.bisenet_apply(p, _nchw(x)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("style_batch", [1, 2])
def test_vtoonify_apply_matches_jax(vtoonify_pair, style_batch):
    """Both backbones; a batch-1 style takes the shared-style fold."""
    jcfg, jp, cfg, p = vtoonify_pair
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, (2, 32, 32, 22)).astype(np.float32)
    style = rng.randn(style_batch, cfg.n_latent, 512).astype(np.float32)
    ref = np.asarray(jax.jit(JV.vtoonify_apply, static_argnums=1)(
        jp, jcfg, jnp.asarray(x), jnp.asarray(style), 0.5))
    got = V.vtoonify_apply(p, cfg, _nchw(x), torch.from_numpy(style),
                           d_s=0.5).numpy()
    assert got.shape == (2, 3, 128, 128)
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, rtol=1e-3,
                               atol=1e-3 * np.abs(ref).max())


def test_zplus2wplus_matches_jax(vtoonify_pair):
    jcfg, jp, cfg, p = vtoonify_pair
    z = np.random.RandomState(6).randn(1, cfg.n_latent, 512).astype(np.float32)
    ref = np.asarray(JV.zplus2wplus(jp, jcfg, jnp.asarray(z)))
    got = V.zplus2wplus(p, cfg, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


# uint8 output bounds against JAX frame_graph at the tiny config:
# * float32: <= 1 LSB — the two frameworks differ only in float32 rounding,
#   which can move a value across a quantization boundary by one step.
# * bfloat16: each framework rounds every intermediate to bf16 (8 mantissa
#   bits, ~0.4% relative) at different places (the port's kernels keep the
#   conv, demodulation and bias/activation in float32 and round once; JAX
#   rounds after each op), and the random-weight net amplifies the drift
#   through ~20 layers; measured max 5 LSB / mean 0.45 LSB here (image
#   spread ~90 LSB std), bound at 16 LSB max and 1 LSB mean.
_BOUNDS = {"float32": (1, 0.05), "bfloat16": (16, 1.0)}


@pytest.mark.parametrize("dtype,batch", [
    ("float32", 1), ("float32", 2), ("bfloat16", 2)])
def test_frame_graph_matches_jax(bisenet_pair, dtype, batch):
    jcfg, jp, cfg, p = _vtoonify_pair("dualstylegan")
    jbp, bp = bisenet_pair
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (batch, 32, 32, 3)).astype(np.uint8)
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)  # noqa: E731
    ref = np.asarray(jax.jit(JT.frame_graph, static_argnums=(1, 6))(
        cast(jp), jcfg, cast(jbp), jnp.asarray(frames), jnp.asarray(s_w),
        jnp.asarray(0.5, jnp.float32), jdt))
    pipe = T.ToonifyPipeline(p, cfg, bp, dtype=tdt, device="cpu")
    got = pipe.process_batch(frames, s_w, 0.5).numpy()
    assert got.shape == (batch, 128, 128, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    max_lsb, mean_lsb = _BOUNDS[dtype]
    assert ref.std() > 30, "reference image too flat to compare"
    assert diff.max() <= max_lsb and diff.mean() <= mean_lsb, (
        diff.max(), diff.mean())


def test_pipeline_surface(bisenet_pair):
    _, _, cfg, p = _vtoonify_pair("dualstylegan")
    _, bp = bisenet_pair
    rng = np.random.RandomState(8)
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    pipe = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, device="cpu")
    frame = rng.randint(0, 256, (32, 40, 3)).astype(np.uint8)  # non-square
    out = pipe.process_image(frame, s_w, 0.5)
    assert out.shape == (128, 160, 3) and out.dtype == np.uint8
    # the same frame with its parsing maps computed outside the graph
    frames = torch.from_numpy(frame[None])
    x = frames.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    x_p = B.bisenet_apply(pipe.parsing, 2.0 * torch.nn.functional.interpolate(
        x, scale_factor=2, mode="bilinear"))
    x_p = torch.nn.functional.interpolate(x_p, size=(32, 40), mode="nearest")
    via_parsing = T.frame_graph_with_parsing(
        pipe.vt, cfg, frames, x_p.permute(0, 2, 3, 1), torch.from_numpy(s_w),
        0.5, torch.float32)
    np.testing.assert_array_equal(via_parsing[0].numpy(), out)
    # style preparation is ported: tests/test_torch_checkpoint.py holds
    # compute_style and the exemplar style to JAX
    # the pipeline options are ported (tests/test_torch_options.py holds
    # them to JAX), and so is the device mesh (tests/test_torch_parallel.py):
    # a mesh of one device is the pipeline on that device, and a mesh that
    # does not start at the pipeline's device is refused
    mesh = make_mesh(devices=["cpu"])
    one = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, mesh=mesh)
    np.testing.assert_array_equal(one.process_image(frame, s_w, 0.5), out)
    with pytest.raises(ValueError, match="first device"):
        T.ToonifyPipeline(p, cfg, bp, device="cuda", mesh=mesh)
    for option in ({"size_bucket": 32}, {"packed_output": True},
                   {"size_bucket": 32, "bucket_margin": 8}):
        opt = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, device="cpu",
                                **option)
        assert opt.process_image(frame, s_w, 0.5).shape == (128, 160, 3), option


def test_load_jax_params_is_strict():
    _, jp, cfg, _ = _vtoonify_pair("dualstylegan")
    sd = jax_state_dict(jp)
    assert not any(k.endswith(("weight_a", "weight_b")) for k in sd)
    missing = dict(jp, encoder=dict(jp["encoder"], final={}))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(V.init_vtoonify(cfg), missing)
    extra = dict(jp, stray={"weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_params(V.init_vtoonify(cfg), extra)
