"""The port's full ADA augment (train/augment_full.py) and auxiliary models
(models/vgg.py, models/arcface.py, models/psp.py, and their converters in
convert/torch_import.py) against the JAX package on the CPU, float32.

VGG19's params are JAX-initialised; ArcFace's and pSp's come from the
port's init laid out as JAX trees (`_jax_tree`, with JAX's shapes from
`jax.eval_shape`: JAX's own init of their ~150M values takes 10-17 s on a
core); both are carried into the port by `load_jax_params`. Inputs come
from numpy seeds. Tolerances: the colour matrices are one 3x3 product a
pixel (1e-5); the augment's warp is JAX's XLA grid_sample against B5's
plain version on the pixel coefficients (2e-4, as
tests/test_torch_train.py::test_random_apply_affine_matches_jax); the
models differ only in the order of float32 conv sums, through up to 50
layers (VGG19 1e-4, ArcFace's normalized embeddings 1e-4, pSp 1e-4 of the
largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_checkpoint import _PSP_BODY, _PSP_INPUT
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from tests.test_torch_train_step import _jax_tree
from vtoonify_tpu.models import arcface as JAF
from vtoonify_tpu.models import psp as JP
from vtoonify_tpu.models import vgg as JVG
from vtoonify_tpu.train import augment_full as JAU
from vtoonify_tpu_torch.convert import torch_import as TI
from vtoonify_tpu_torch.convert.from_jax import load_jax_params
from vtoonify_tpu_torch.convert.torch_export import export_generator, params_tree
from vtoonify_tpu_torch.models import arcface as AF
from vtoonify_tpu_torch.models import psp as P
from vtoonify_tpu_torch.models import vgg as VG
from vtoonify_tpu_torch.train import augment_full as AU


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _close(got, want, rtol):
    """max |got - want| within rtol of max |want| (NCHW got, NHWC want
    where 4-D)."""
    want = np.asarray(want)
    if want.ndim == 4:
        want = _nchw(want).numpy()
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-12), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# full ADA


def test_apply_color_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 8, 8, 3).astype(np.float32)
    C = jax.jit(JAU.sample_color, static_argnums=(1, 2))(jax.random.PRNGKey(2), 0.9, 2)
    got = AU.apply_color(_nchw(img), torch.from_numpy(np.asarray(C)))
    _close(got, JAU.apply_color(jnp.asarray(img), C), 1e-5)


def test_augment_matches_jax_given_the_matrices():
    """The full augment (affine through B5's plain version, then colour) on
    JAX's own draws: the inverse affine and the colour matrix it returns."""
    rng = np.random.RandomState(1)
    img = rng.randn(2, 16, 16, 3).astype(np.float32)
    want, (Gm, Cm) = jax.jit(JAU.augment, static_argnums=1, static_argnames="max_pad")(
        jnp.asarray(img), 0.9, jax.random.PRNGKey(3), max_pad=15)
    Gt, Ct = torch.from_numpy(np.asarray(Gm)), torch.from_numpy(np.asarray(Cm))
    got, (g_out, c_out) = AU.augment(_nchw(img), 0.9, max_pad=15, G=Gt, C=Ct)
    assert torch.equal(g_out, Gt) and torch.equal(c_out, Ct)
    np.testing.assert_allclose(got.numpy(), _nchw(want).numpy(), atol=2e-4, rtol=1e-3)


def test_augment_draws():
    """The port's own draws: (B, 3, 3) and (B, 4, 4) float32, identity at
    p = 0, and an augment that runs from a torch.Generator alone."""
    g = torch.Generator().manual_seed(4)
    assert torch.equal(AU.sample_affine_full(g, 0.0, 8, 16, 16), torch.eye(3).repeat(8, 1, 1))
    assert torch.equal(AU.sample_color(g, 0.0, 8), torch.eye(4).repeat(8, 1, 1))
    Gm, Cm = AU.sample_affine_full(g, 1.0, 64, 16, 16), AU.sample_color(g, 1.0, 64)
    assert Gm.shape == (64, 3, 3) and Cm.shape == (64, 4, 4)
    assert torch.isfinite(torch.linalg.inv(Gm)).all() and torch.isfinite(Cm).all()
    out, (Ginv, Cd) = AU.augment(torch.randn(2, 3, 16, 16, generator=g), 0.6, generator=g)
    assert out.shape == (2, 3, 16, 16) and torch.isfinite(out).all()
    assert Ginv.shape == (2, 3, 3) and Cd.shape == (2, 4, 4)


def test_adaptive_augment_tunes_as_jax():
    """The same predictions give the same p sequence, up and down."""
    rng = np.random.RandomState(5)
    jada = JAU.AdaptiveAugment(ada_aug_target=0.6, ada_aug_len=200, update_every=4)
    ada = AU.AdaptiveAugment(ada_aug_target=0.6, ada_aug_len=200, update_every=4)
    ps, jps = [], []
    for step in range(64):
        pred = (rng.randn(8, 1) + (1.5 if step < 32 else -1.5)).astype(np.float32)
        jps.append(jada.tune(pred))
        ps.append(ada.tune(torch.from_numpy(pred)))
    assert ps == jps
    assert max(ps) > 0 and ps[-1] < max(ps)


# ---------------------------------------------------------------------------
# VGG19, ArcFace, pSp


def test_vgg19_matches_jax():
    params = JVG.init_vgg19(jax.random.PRNGKey(6))
    vgg = load_jax_params(VG.init_vgg19(), params)
    rng = np.random.RandomState(7)
    x, y = (np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    # the "pool" markers stay outside jit, which takes arrays only
    layout = [[isinstance(i, str) for i in sl] for sl in params]
    convs = [[i for i in sl if not isinstance(i, str)] for sl in params]

    def run(convs, x, y):
        its = [iter(c) for c in convs]
        p = [["pool" if pool else next(it) for pool in sl] for sl, it in zip(layout, its)]
        return JVG.vgg19_features(p, x), JVG.vgg_loss(p, x, y)

    jfeats, jloss = jax.jit(run)(convs, x, y)
    feats = VG.vgg19_features(vgg, _nchw(x))
    assert [f.shape[1] for f in feats] == [64, 128, 256, 512, 512]
    for f, jf in zip(feats, jfeats):
        _close(f, jf, 1e-4)
    _close(VG.vgg_loss(vgg, _nchw(x), _nchw(y)), jloss, 1e-4)


def test_arcface_and_id_loss_match_jax():
    """Embeddings of 112 px faces, and the identity loss on 256 px images
    (the 188 px crop resized to 112), with random BN statistics."""
    rng = np.random.RandomState(9)
    init = AF.init_arcface_backbone(112, torch.Generator().manual_seed(8))
    with torch.no_grad():
        for name, buf in init.named_buffers():
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape) if "var" in name
                                       else rng.randn(*buf.shape) * 0.1))
    params = _jax_tree(init, jax.eval_shape(
        lambda: JAF.init_arcface_backbone(jax.random.PRNGKey(0), 112)))
    net = load_jax_params(init, params)
    x = np.tanh(rng.randn(2, 112, 112, 3)).astype(np.float32)
    a, b = (np.tanh(rng.randn(2, 256, 256, 3)).astype(np.float32) for _ in range(2))
    jemb, jloss = jax.jit(lambda p, x, a, b: (JAF.arcface_apply(p, x), JAF.id_loss(p, a, b)))(
        params, x, a, b)
    emb = AF.arcface_apply(net, _nchw(x))
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=1).numpy(), 1.0, rtol=1e-5)
    _close(emb, jemb, 1e-4)
    _close(AF.id_loss(net, _nchw(a), _nchw(b)), jloss, 1e-4)


def _psp_reference_state(net: P.PSP, cfg: P.PSPConfig) -> dict:
    """The full pSp checkpoint's flat state (`encoder.*` under the
    reference's keys, `decoder.*` as the reference StyleGAN2, `latent_avg`)
    of a port PSP, as numpy."""
    sd = {}
    for k, v in net.encoder.state_dict().items():
        parts = k.split(".")
        if parts[0] in _PSP_INPUT:
            parts[0] = f"input_layer.{_PSP_INPUT.index(parts[0])}"
        elif parts[0] == "body":
            parts[2] = _PSP_BODY[parts[2]]
        elif parts[0] == "styles" and parts[2] == "convs":
            parts[3] = str(2 * int(parts[3]))  # LeakyReLUs in between
        sd["encoder." + ".".join(parts)] = v.numpy()
    sd.update({k: np.asarray(v) for k, v in export_generator(
        params_tree(net.decoder), cfg.decoder, prefix="decoder").items()})
    sd["latent_avg"] = net.latent_avg.numpy()
    return sd


def test_psp_matches_jax():
    """The full pSp at output_size 32 (the smallest JAX accepts: 8 styles,
    the FPN's three groups all used) on 64 px faces: encode, latent_avg
    centring, decode, with the codes returned; then decoding codes given
    as input (mapped row by row, and as z+) with latent_mask / inject_latent
    / alpha mixing and with zeroed columns. `resize` pools to 256 px and
    needs output_size >= 256 (chip_smoke.py runs it at 1024). Then
    `convert_psp` of the same module's reference-format state gives JAX's
    tree leaf for leaf."""
    cfg, jcfg = P.PSPConfig(output_size=32), JP.PSPConfig(output_size=32)
    rng = np.random.RandomState(11)
    init = P.init_psp(cfg, torch.Generator().manual_seed(10))
    with torch.no_grad():
        init.latent_avg.copy_(torch.from_numpy(rng.randn(cfg.n_styles, 512) * 0.3))
    params = _jax_tree(init, jax.eval_shape(
        lambda: JP.init_psp(jax.random.PRNGKey(0), jcfg)))
    net = load_jax_params(init, params)
    x = np.tanh(rng.randn(2, 64, 64, 3)).astype(np.float32)
    inject = rng.randn(2, jcfg.n_styles, 512).astype(np.float32)

    def jrun(p, x, inject):
        img, codes = JP.psp_apply(p, jcfg, x, resize=False, return_latents=True)
        mixed, mcodes = JP.psp_apply(p, jcfg, codes, resize=False, input_code=True,
                                     latent_mask=[1, 3], inject_latent=inject, alpha=0.3,
                                     return_latents=True)
        zeroed = JP.psp_apply(p, jcfg, codes, resize=False, input_code=True,
                              z_plus_latent=True, latent_mask=[2, 5])
        return img, codes, mixed, mcodes, zeroed

    want = jax.jit(jrun)(params, x, inject)
    img, codes = P.psp_apply(net, cfg, _nchw(x), resize=False, return_latents=True)
    mixed, mcodes = P.psp_apply(net, cfg, codes, resize=False, input_code=True,
                                latent_mask=[1, 3], inject_latent=torch.from_numpy(inject),
                                alpha=0.3, return_latents=True)
    zeroed = P.psp_apply(net, cfg, codes, resize=False, input_code=True, z_plus_latent=True,
                         latent_mask=[2, 5])
    assert img.shape == (2, 3, 32, 32) and codes.shape == (2, cfg.n_styles, 512)
    for got, w in zip((img, codes, mixed, mcodes, zeroed), want):
        _close(got, w, 1e-4)

    tree = TI.convert_psp(_psp_reference_state(net, cfg), cfg)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_convert_vgg19_matches_jax():
    """convert_vgg19 (torchvision `features.*`) gives JAX's tree leaf for
    leaf, pools marked alike, and loads."""
    rng = np.random.RandomState(12)
    sd = {}
    for i, (cin, cout) in zip([0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28],
                              [c for s in VG.SLICES for c in s if c != "pool"]):
        sd[f"features.{i}.weight"] = rng.randn(cout, cin, 3, 3).astype(np.float32)
        sd[f"features.{i}.bias"] = rng.randn(cout).astype(np.float32)
    tree, jtree = TI.convert_vgg19(sd), JVG.convert_vgg19(sd)
    assert [["pool" if isinstance(i, str) else "conv" for i in s] for s in tree] == \
        [["pool" if isinstance(i, str) else "conv" for i in s] for s in jtree]
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    load_jax_params(VG.init_vgg19(), tree)
