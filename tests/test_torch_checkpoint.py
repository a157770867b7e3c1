"""Reference-format checkpoints into the port, held to the JAX loaders, and
style preparation against JAX (CPU).

The checkpoint files are written to a tmp dir from random weights, nothing
downloaded (`zoo`, which tests/test_torch_cli.py shares): VToonify-D and
VToonify-T through the JAX package's
`convert/torch_export.py::save_reference_checkpoint`, DualStyleGAN and
StyleGAN generators through its `export_dualstylegan` / `export_generator`,
all from the port's seeded init at the tiny configuration of
tests/test_torch_models.py (with the reference's channel cap of 512, so the
config inferred from the file loads it; styled-conv and ToRGB biases
randomized so the uint8 images have contrast) laid out as JAX trees by
`jax_layout`; BiSeNet and pSp by `bisenet_reference_state` /
`psp_reference_state`, which rename a port module's random state to the
keys that JAX `convert_bisenet` / `convert_psp_encoder` read; the exemplar
bank with `np.save`. Every loader of the port must give exactly
`jax_state_dict` of the JAX loader's tree on the same file, and the state
the file was made from.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.convert import torch_export as JE
from vtoonify_tpu.models import vtoonify as JV
from vtoonify_tpu.pipeline import toonify as JT
from vtoonify_tpu.utils import checkpoint as JCK
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import dualstylegan as D
from vtoonify_tpu_torch.models import psp_encoder as P
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.pipeline import toonify as T
from vtoonify_tpu_torch.utils import checkpoint as CK

TINY = dict(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)
N_LATENT = 12
N_BANK = 3


# ---------------------------------------------------------------------------
# reference-format files


def _randomize_bn(module, rng):
    """Non-trivial BatchNorm statistics and affine params, in place."""
    def draw(c, positive):
        a = rng.rand(c) + 0.5 if positive else rng.randn(c) * 0.1
        return torch.from_numpy(a.astype(np.float32))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, L.BatchNorm2d):
                c = m.weight.shape[0]
                m.weight.copy_(draw(c, True))
                m.bias.copy_(draw(c, False))
                m.running_mean.copy_(draw(c, False))
                m.running_var.copy_(draw(c, True))


def _with_bn_counters(sd):
    """Add the reference BatchNorm's `num_batches_tracked` entries, which the
    converters do not read."""
    out = dict(sd)
    for k in sd:
        if k.endswith("running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    return out


_BISENET_CP = ("resnet", "arm16", "arm32", "conv_head32", "conv_head16", "conv_avg")


def bisenet_reference_state(rng):
    """(port BiSeNet, its state under the reference BiSeNet's keys)."""
    p = B.init_bisenet(generator=torch.Generator().manual_seed(int(rng.randint(1 << 30))))
    _randomize_bn(p, rng)
    sd = {}
    for k, v in p.state_dict().items():
        k = k.replace(".down_conv.", ".downsample.0.").replace(".down_bn.", ".downsample.1.")
        sd[("cp." + k) if k.split(".")[0] in _BISENET_CP else k] = v.clone()
    return p, _with_bn_counters(sd)


_PSP_INPUT = ("input_conv", "input_bn", "input_prelu")
_PSP_BODY = {"bn0": "res_layer.0", "conv1": "res_layer.1", "prelu": "res_layer.2",
             "conv2": "res_layer.3", "bn2": "res_layer.4", "se": "res_layer.5",
             "shortcut_conv": "shortcut_layer.0", "shortcut_bn": "shortcut_layer.1"}


def psp_reference_state(rng, n_styles):
    """(port PSPEncoder, a reference pSp checkpoint dict: `encoder.`-prefixed
    GradualStyleEncoder state and `latent_avg`)."""
    p = P.init_psp_encoder(P.PSPEncoderConfig(n_styles=n_styles),
                           torch.Generator().manual_seed(int(rng.randint(1 << 30))))
    _randomize_bn(p, rng)
    with torch.no_grad():
        for blk in p.body:  # PReLU slopes off their 0.25 init
            blk.prelu.weight.copy_(torch.from_numpy(
                rng.uniform(0.0, 0.5, blk.prelu.weight.shape).astype(np.float32)))
    sd = {}
    for k, v in p.state_dict().items():
        parts = k.split(".")
        if parts[0] in _PSP_INPUT:
            parts[0] = f"input_layer.{_PSP_INPUT.index(parts[0])}"
        elif parts[0] == "body":
            parts[2] = _PSP_BODY[parts[2]]
        elif parts[0] == "styles" and parts[2] == "convs":
            parts[3] = str(2 * int(parts[3]))  # LeakyReLUs in between
        sd["encoder." + ".".join(parts)] = v.clone()
    latent_avg = torch.from_numpy(rng.randn(n_styles, 512).astype(np.float32) * 0.3)
    return p, {"state_dict": _with_bn_counters(sd), "latent_avg": latent_avg}


def jax_layout(module):
    """A port module's state as a JAX-layout tree of numpy arrays: the
    inverse of `load_jax_params`' layout rules, each conv with one merged
    `weight` (the exporters take it as well as a cat2 split)."""
    root = {}
    for k, v in module.state_dict().items():
        *path, name = k.split(".")
        a = v.numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0) if name == "weight" else a.transpose(0, 2, 3, 1)
        elif a.ndim == 2 and name == "weight":
            a = a.T
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)

    def lists(t):  # ModuleList / ParameterList entries are keyed 0..n-1
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        return [t[str(i)] for i in range(len(t))] if all(k.isdigit() for k in t) else t

    return lists(root)


def _vtoonify(backbone, seed):
    g = torch.Generator().manual_seed(seed)
    cfg = V.VToonifyConfig(backbone=backbone, **TINY)
    vt = V.init_vtoonify(cfg, g)
    gen = vt.generator.generator if backbone == "dualstylegan" else vt.generator
    with torch.no_grad():
        for blk in gen.convs:
            blk.act_bias.normal_(0.0, 0.5, generator=g)
        for blk in gen.to_rgbs:
            blk.bias.normal_(0.0, 0.5, generator=g)
    return vt


def _save_g_ema(path, sd):
    torch.save({"g_ema": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """{name: path} of the reference-format files, and the modules they
    were made from under "made"."""
    root = tmp_path_factory.mktemp("zoo")
    rng = np.random.RandomState(11)
    files, made = {"root": root}, {}
    for seed, backbone in enumerate(("dualstylegan", "toonify")):
        made[backbone] = vt = _vtoonify(backbone, seed)
        jcfg = JV.VToonifyConfig(backbone=backbone, **TINY)
        tree = jax_layout(vt)
        tree["encoder"]["down"] = []  # in_size 32: an empty ModuleList, no state
        files[backbone] = JE.save_reference_checkpoint(
            str(root / f"vtoonify_{backbone[0]}.pt"), tree, jcfg)
        if backbone == "dualstylegan":
            dcfg = jcfg.dualstylegan
            files["generator"] = _save_g_ema(
                root / "generator.pt", JE.export_dualstylegan(tree["generator"], dcfg))
            files["stylegan"] = _save_g_ema(
                root / "stylegan.pt",
                JE.export_generator(tree["generator"]["generator"], dcfg.generator))
            files["dualstylegan_cfg"] = dcfg
            del tree
    made["faceparsing"], bisenet_sd = bisenet_reference_state(rng)
    torch.save(bisenet_sd, str(root / "faceparsing.pth"))
    made["psp"], psp_ckpt = psp_reference_state(rng, N_LATENT)
    torch.save(psp_ckpt, str(root / "encoder.pt"))
    bank = {f"style{i}.png": (rng.randn(1, N_LATENT, 512) * 0.3).astype(np.float32)
            for i in range(N_BANK)}
    np.save(str(root / "exstyle_code.npy"), bank, allow_pickle=True)
    np.save(str(root / "directions.npy"), rng.randn(4, N_LATENT, 512).astype(np.float32))
    files.update(faceparsing=str(root / "faceparsing.pth"), psp=str(root / "encoder.pt"),
                 bank=str(root / "exstyle_code.npy"),
                 directions=str(root / "directions.npy"), made=made)
    return files


def _assert_same_state(module, jax_tree):
    """module's state == jax_state_dict(jax_tree), value for value. The
    converters store a styled conv's scalar noise weight as a 1-element
    array (np.ascontiguousarray gives ndim >= 1), which load_state_dict
    takes into the 0-d parameter: the shapes are compared by size."""
    want = jax_state_dict(jax_tree)
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert v.numel() == got[k].numel() and torch.equal(got[k], v.reshape(got[k].shape)), k


def _assert_made_from(module, made):
    """The file's round trip is the identity."""
    want = made.state_dict()
    assert set(module.state_dict()) == set(want)
    for k, v in module.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---------------------------------------------------------------------------
# loaders


@pytest.mark.parametrize("backbone", ["dualstylegan", "toonify"])
def test_load_reference_vtoonify_matches_jax(zoo, backbone):
    vt, cfg = CK.load_reference_vtoonify(zoo[backbone])
    jp, jcfg = JCK.load_reference_vtoonify(zoo[backbone])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.backbone == backbone and cfg.n_latent == N_LATENT
    _assert_same_state(vt, jp)
    _assert_made_from(vt, zoo["made"][backbone])


@pytest.mark.parametrize("which", ["dualstylegan", "stylegan"])
def test_load_reference_generators_match_jax(zoo, which):
    jdcfg = zoo["dualstylegan_cfg"]
    dcfg = D.DualStyleGANConfig(**dataclasses.asdict(jdcfg))
    if which == "dualstylegan":
        got = CK.load_reference_dualstylegan(zoo["generator"], dcfg)
        want = JCK.load_reference_dualstylegan(zoo["generator"], jdcfg)
        made = zoo["made"]["dualstylegan"].generator
    else:
        got = CK.load_reference_stylegan(zoo["stylegan"], dcfg.generator)
        want = JCK.load_reference_stylegan(zoo["stylegan"], jdcfg.generator)
        made = zoo["made"]["dualstylegan"].generator.generator
    _assert_same_state(got, want)
    _assert_made_from(got, made)


def test_load_reference_faceparsing_and_psp_match_jax(zoo):
    parsing = CK.load_reference_faceparsing(zoo["faceparsing"])
    _assert_same_state(parsing, JCK.load_reference_faceparsing(zoo["faceparsing"]))
    _assert_made_from(parsing, zoo["made"]["faceparsing"])

    psp, latent_avg, pcfg = CK.load_reference_psp(zoo["psp"])
    jpsp, jla, jpcfg = JCK.load_reference_psp(zoo["psp"])
    assert pcfg.n_styles == jpcfg.n_styles == N_LATENT
    _assert_same_state(psp, jpsp)
    _assert_made_from(psp, zoo["made"]["psp"])
    assert latent_avg.dtype == torch.float32
    np.testing.assert_array_equal(latent_avg.numpy(), np.asarray(jla))


def test_exstyle_bank_and_directions(zoo):
    bank, names = CK.load_exstyle_bank(zoo["bank"])
    jbank, jnames = JCK.load_exstyle_bank(zoo["bank"])
    assert names == jnames == [f"style{i}.png" for i in range(N_BANK)]
    for k in names:
        np.testing.assert_array_equal(bank[k], jbank[k])
    np.testing.assert_array_equal(CK.load_directions(zoo["directions"]),
                                  JCK.load_directions(zoo["directions"]))


def test_infer_vtoonify_config_refuses_non_vtoonify():
    with pytest.raises(ValueError, match="not a VToonify checkpoint"):
        CK.infer_vtoonify_config({"encoder.0.0.weight": np.zeros((1,))})


# ---------------------------------------------------------------------------
# style preparation: pSp -> zplus2wplus -> exemplar splice, float32


def _pipelines(zoo, backbone, style_id=1):
    vt, cfg = CK.load_reference_vtoonify(zoo[backbone])
    jvt, jcfg = JCK.load_reference_vtoonify(zoo[backbone])
    psp, latent_avg, pcfg = CK.load_reference_psp(zoo["psp"])
    jpsp, jla, jpcfg = JCK.load_reference_psp(zoo["psp"])
    parsing = CK.load_reference_faceparsing(zoo["faceparsing"])
    jparsing = JCK.load_reference_faceparsing(zoo["faceparsing"])
    bank, names = CK.load_exstyle_bank(zoo["bank"])
    exstyle = bank[names[style_id]] if backbone == "dualstylegan" else None
    pipe = T.ToonifyPipeline(vt, cfg, parsing, psp_params=psp, psp_cfg=pcfg,
                             latent_avg=latent_avg, exstyle=exstyle,
                             dtype=torch.float32, device="cpu")
    jpipe = JT.ToonifyPipeline(jvt, jcfg, jparsing, psp_params=jpsp, psp_cfg=jpcfg,
                               latent_avg=jla, exstyle=exstyle, dtype=jnp.float32)
    return pipe, jpipe


# float32 on both sides: pSp's 24 IR-SE units and the 8-layer mapping MLP
# differ only in the order of float32 sums; measured relative L2 8.3e-7 to
# 9.0e-7 here
STYLE_REL_L2 = 1e-5


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


@pytest.mark.parametrize("backbone", ["dualstylegan", "toonify"])
def test_compute_style_matches_jax(zoo, backbone):
    pipe, jpipe = _pipelines(zoo, backbone)
    face = np.random.RandomState(12).randint(0, 256, (256, 256, 3)).astype(np.uint8)
    if backbone == "dualstylegan":
        assert _rel_l2(pipe.exstyle_w.numpy(), jpipe.exstyle_w) <= STYLE_REL_L2
    else:
        assert pipe.exstyle_w is None
    for color_transfer in (False, True):
        s_w = pipe.compute_style(face, color_transfer)
        ref = np.asarray(jpipe.compute_style(face, color_transfer))
        assert s_w.shape == (1, N_LATENT, 512) and s_w.dtype == torch.float32
        assert _rel_l2(s_w.numpy(), ref) <= STYLE_REL_L2, color_transfer
        if backbone == "dualstylegan":  # the exemplar splice, exactly
            n = N_LATENT if color_transfer else 7
            assert torch.equal(s_w[:, :n], pipe.exstyle_w[:, :n])
    if backbone == "dualstylegan":  # structure only: layers 7: from the face
        assert not torch.equal(pipe.compute_style(face)[:, 7:],
                               pipe.exstyle_w[:, 7:])


def test_pipeline_without_psp_refuses_compute_style(zoo):
    vt, cfg = CK.load_reference_vtoonify(zoo["toonify"])
    pipe = T.ToonifyPipeline(vt, cfg, B.init_bisenet(), device="cpu")
    with pytest.raises(RuntimeError, match="without a pSp encoder"):
        pipe.compute_style(np.zeros((256, 256, 3), np.uint8))
