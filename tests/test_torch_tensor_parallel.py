"""The port's tensor parallelism on the CPU (vtoonify_tpu_torch/parallel/
tensor.py: wide weights split over a 'tp' row, `make_mesh(n, tp=k)`,
`ToonifyPipeline` over a (dp, tp) mesh, the steps and state files of the
trainers' --tp) against the JAX package's rule and pipeline and against the
unsplit port.

A 'tp' row here is the CPU named k times (`devices=["cpu"] * k`), which runs
the shards one after the other: the numbers are those of k cards.

Tolerances: every split layer in float64 within 1e-12 of the whole layer,
forward and gradients (the same reduction per output channel; the kernels'
plain versions stand in for the kernels, which take float32 and bfloat16);
the pipeline over make_mesh(devices=["cpu"] * 4, tp=2) in float32 within
JAX's own tp gate of the port's one-device pipeline (1 uint8 LSB on at most
1e-3 of the pixels, tests/test_sharding.py) and within the pipeline tests'
port-vs-JAX bound (1 LSB, mean 0.05) of JAX's ToonifyPipeline over
make_mesh(4, tp=2); one step of each trainer stage at tp 2 against tp 1, in
float64 compute, within 1e-10 relative L2 (parameters, EMA, metrics).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import _vtoonify_pair
from tests.test_torch_train_stage1 import lean_worker  # noqa: F401  (one torch thread)
from vtoonify_tpu.models import vtoonify as JV
from vtoonify_tpu.parallel import mesh as JM
from vtoonify_tpu.pipeline import toonify as JT
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.nn import layers as L
from vtoonify_tpu_torch.ops import kernels as K
from vtoonify_tpu_torch.parallel import mesh as M
from vtoonify_tpu_torch.parallel import tensor as TP
from vtoonify_tpu_torch.pipeline import toonify as T
from vtoonify_tpu_torch.train import steps as S
from vtoonify_tpu_torch.utils import checkpoint as CK

TINY = dict(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)
KERNELS = ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2", "affine_warp")


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernels' plain versions in their place: they take float64."""
    for name in KERNELS:
        monkeypatch.setattr(K, name, getattr(K, name + "_plain"))
    monkeypatch.setattr(L, "depth_to_space2", K.depth_to_space2_plain)


def _row(k):
    return ["cpu"] * k


# ---------------------------------------------------------------------------
# the mesh and the rule


def test_mesh_helpers_match_jax():
    """make_mesh(8, tp=2)'s shape and row-major device order as JAX's; a
    count tp does not divide is refused; a batch splits over the dp rows."""
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = M.make_mesh(devices=devices, tp=2)
    jmesh = JM.make_mesh(8, tp=2)
    assert mesh.shape == dict(jmesh.shape) == {"dp": 4, "tp": 2}
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    assert [[d.index for d in row] for row in mesh.rows] == ids.tolist()
    assert M.make_mesh(6, tp=3, devices=devices).shape == {"dp": 2, "tp": 3}
    with pytest.raises(ValueError, match="8 devices not divisible by tp=3"):
        M.make_mesh(devices=devices, tp=3)
    with pytest.raises(AssertionError, match="not divisible by tp=3"):
        JM.make_mesh(8, tp=3)
    assert M.shard_batch(mesh, 8) == [slice(2 * i, 2 * i + 2) for i in range(4)]
    with pytest.raises(ValueError, match="not divisible by dp width 4"):
        M.shard_batch(mesh, 6)
    cpu = M.make_mesh(devices=_row(4), tp=2)
    chunks = M.shard_array_batch(np.arange(8).reshape(4, 2), cpu)
    assert [c.tolist() for c in chunks] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]


def _port_leaves(module):
    """{name: (shape, split axis or None)} of a port module by the port's
    rule, every parameter (the state dict's order)."""
    return {n: (tuple(t.shape), TP.partition_dim(n.rsplit(".", 1)[-1], t))
            for n, t in module.state_dict().items()}


def _jax_leaves(tree):
    """{port name: (shape, wide?)} of a JAX tree of shapes, by the JAX
    rule; the cat2 pairs weight_a / weight_b become the merged weight
    (wide when both halves are)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        spec = JM.param_partition_spec(leaf)
        wide = len(spec) > 0
        assert not wide or spec[-1] == "tp"
        if name.endswith((".weight_a", ".weight_b")):
            name = name[:-2]
            wide = out.get(name, (None, True))[1] and wide
        out[name] = (tuple(leaf.shape), wide)
    return out


def _assert_rule_matches(jtree, module):
    """The port splits exactly the leaves JAX splits, each on the axis
    convert.from_jax maps JAX's last axis to; returns (JAX wide leaves, JAX
    leaves, split parameters)."""
    jl, pl = _jax_leaves(jtree), _port_leaves(module)
    assert set(jl) == set(pl)
    for name, (shape, dim) in pl.items():
        wide = jl[name][1]
        assert (dim is not None) == wide, name
        if wide:
            last = 0 if name.endswith("weight") else (1 if len(shape) == 4 else len(shape) - 1)
            assert dim == last, name
    n_jax = sum(1 for _, l in jax.tree_util.tree_leaves_with_path(jtree))
    n_wide = sum(1 for _, l in jax.tree_util.tree_leaves_with_path(jtree)
                 if len(JM.param_partition_spec(l)))
    split = sum(int(np.prod(s)) for s, d in pl.values() if d is not None)
    return n_wide, n_jax, split


@pytest.mark.parametrize("which", ["vtoonify_d", "cond_discriminator", "vtoonify_t"])
def test_partition_rule_matches_jax_at_tiny(which):
    """At the JAX tp tests' TINY config (tests/test_sharding.py): the port
    splits the leaves `_assert_tp_sharded` requires split, and
    shard_module makes exactly those parameters Shards."""
    key = jax.random.PRNGKey(0)
    if which == "cond_discriminator":
        jcfg = JV.CondDiscriminatorConfig(size=64, channel_multiplier=1,
                                          use_condition=True, style_num=3)
        jtree = jax.eval_shape(lambda k: JV.init_cond_discriminator(k, jcfg), key)
        module = V.init_cond_discriminator(V.CondDiscriminatorConfig(
            size=64, channel_multiplier=1, use_condition=True, style_num=3))
    else:
        backbone = "dualstylegan" if which == "vtoonify_d" else "toonify"
        jcfg = JV.VToonifyConfig(backbone=backbone, **TINY)
        jtree = jax.eval_shape(lambda k: JV.init_vtoonify(k, jcfg), key)
        module = V.init_vtoonify(V.VToonifyConfig(backbone=backbone, **TINY))
    n_wide, _, split = _assert_rule_matches(jtree, module)
    assert n_wide > 0 and split > 0
    want = {n for n, (_, d) in _port_leaves(module).items() if d is not None}
    TP.shard_module(module, _row(2))
    got = {n for n, m in module.named_modules() if isinstance(m, TP.Shards)}
    assert got == want


def test_partition_rule_matches_jax_at_the_flagship():
    """VToonifyConfig(): JAX splits 135 of its 395 leaves, 162,373,632 of
    166,608,723 parameters; the port (on the meta device) splits the same
    parameters (each of its 12 fusion convs holds one merged weight where
    JAX holds a cat2 pair, 3 of them wide: 132 of 383 leaves)."""
    jtree = jax.eval_shape(lambda k: JV.init_vtoonify(k, JV.VToonifyConfig()),
                           jax.random.PRNGKey(0))
    with torch.device("meta"):
        module = V.init_vtoonify(V.VToonifyConfig())
    n_wide, n_jax, split = _assert_rule_matches(jtree, module)
    assert (n_wide, n_jax, split) == (135, 395, 162_373_632)
    pl = _port_leaves(module)
    assert (sum(d is not None for _, d in pl.values()), len(pl)) == (132, 383)
    assert sum(int(np.prod(s)) for s, _ in pl.values()) == 166_608_723


def test_shard_module_refuses_and_round_trips():
    """A width tp does not divide is refused; the state dict of a split
    module is the whole one, and loads back split; M.param_partition_spec
    names the axis."""
    conv = L.EqualConv2d(4, 6, 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="tp=4 does not divide the 6 channels"):
        TP.shard_module(copy.deepcopy(conv), _row(4), min_channels=4)
    assert M.param_partition_spec(conv.weight, 4) == ("tp", None, None, None)
    assert M.param_partition_spec(torch.zeros(1, 512, 4, 4), name="input") == (
        None, "tp", None, None)
    assert M.param_partition_spec(conv.bias, 4) == ()
    whole = conv.state_dict()
    split = TP.shard_module(copy.deepcopy(conv), _row(2), min_channels=4)
    assert isinstance(split.weight, TP.Shards) and split.weight.shape == (6, 4, 3, 3)
    assert set(split.state_dict()) == set(whole)
    assert all(torch.equal(split.state_dict()[k], v) for k, v in whole.items())
    other = TP.shard_module(L.EqualConv2d(4, 6, 3), _row(2), min_channels=4)
    other.load_state_dict(whole)
    assert torch.equal(other.weight.full(), conv.weight)
    with pytest.raises(ValueError, match="already sharded"):
        TP.shard_module(other, _row(2))


# ---------------------------------------------------------------------------
# each split layer, float64


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _x(g, *shape):
    return torch.randn(shape, generator=g, dtype=torch.float64)


def _noisy(module, g):
    """Non-zero biases, noise weights and a random const everywhere."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim <= 1 or name.endswith("input"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module.double()


def _ops():
    """(name, module factory, fn(module, x, g) -> output, input shape)."""
    sd = 16

    def style(g, b=2):
        return _x(g, b, sd)

    return {
        "equal_linear": (lambda g: L.EqualLinear(12, 8, generator=g),
                         lambda p, x, g: L.equal_linear(p, x), (3, 12)),
        "equal_linear_act_lr": (lambda g: L.EqualLinear(12, 8, generator=g),
                                lambda p, x, g: L.equal_linear(p, x, 0.01, True), (3, 12)),
        "equal_conv2d": (lambda g: L.EqualConv2d(6, 8, 3, generator=g),
                         lambda p, x, g: L.equal_conv2d(p, x, padding=1), (2, 6, 9, 9)),
        "conv_layer": (lambda g: L.ConvLayer(6, 8, 3, generator=g),
                       lambda p, x, g: L.conv_layer(p, x, 3, dilation=2), (2, 6, 9, 9)),
        "conv_layer_down": (lambda g: L.ConvLayer(6, 8, 3, generator=g),
                            lambda p, x, g: L.conv_layer(p, x, 3, downsample=True), (2, 6, 8, 8)),
        "res_block": (lambda g: L.ResBlock(8, 8, generator=g),
                      lambda p, x, g: L.res_block(p, x), (2, 8, 8, 8)),
        "modconv3x3": (lambda g: L.ModulatedConv2d(8, 8, 3, sd, generator=g),
                       lambda p, x, g: L.modulated_conv2d(p, x, style(g), act_bias=_x(g, 8)),
                       (2, 8, 7, 9)),
        "modconv3x3_fold": (lambda g: L.ModulatedConv2d(8, 8, 3, sd, generator=g),
                            lambda p, x, g: L.modulated_conv2d(p, x, style(g, 1)), (3, 8, 7, 9)),
        "modconv_up_fused": (lambda g: L.ModulatedConv2d(8, 8, 3, sd, generator=g),
                             lambda p, x, g: L.modulated_conv2d(
                                 p, x, style(g), upsample=True, act_bias=_x(g, 8)), (2, 8, 6, 5)),
        "modconv_up": (lambda g: L.ModulatedConv2d(8, 8, 3, sd, generator=g),
                       lambda p, x, g: L.modulated_conv2d(p, x, style(g), upsample=True,
                                                          fuse_upsample=False), (2, 8, 6, 5)),
        "modconv_down": (lambda g: L.ModulatedConv2d(8, 8, 3, sd, generator=g),
                         lambda p, x, g: L.modulated_conv2d(p, x, style(g), downsample=True),
                         (2, 8, 8, 8)),
        "modconv_1x1": (lambda g: L.ModulatedConv2d(8, 8, 1, sd, generator=g),
                        lambda p, x, g: L.modulated_conv2d(p, x, style(g), demodulate=False),
                        (2, 8, 5, 5)),
        "styled_conv_noise_up": (lambda g: L.StyledConv(8, 8, 3, sd, generator=g),
                                 lambda p, x, g: L.styled_conv(p, x, style(g), _x(g, 2, 1, 12, 10),
                                                               upsample=True), (2, 8, 6, 5)),
        "styled_conv": (lambda g: L.StyledConv(8, 8, 3, sd, generator=g),
                        lambda p, x, g: L.styled_conv(p, x, style(g)), (2, 8, 6, 5)),
        "to_rgb": (lambda g: L.ToRGB(8, sd, generator=g),
                   lambda p, x, g: L.to_rgb(p, x, style(g), _x(g, 2, 3, 3, 3)), (2, 8, 6, 6)),
        "conv2d_torch": (lambda g: L.Conv2dTorch(6, 8, 3, generator=g),
                         lambda p, x, g: L.conv2d_torch(p, x, stride=2, padding=1), (2, 6, 9, 9)),
        "linear_torch": (lambda g: L.LinearTorch(12, 8, generator=g),
                         lambda p, x, g: L.linear_torch(p, x), (3, 12)),
        "adaptive_instance_norm": (lambda g: L.AdaptiveInstanceNorm(8, sd, generator=g),
                                   lambda p, x, g: L.adaptive_instance_norm(p, x, style(g)),
                                   (2, 8, 5, 5)),
        "ada_res_block": (lambda g: L.AdaResBlock(8, sd, generator=g),
                          lambda p, x, g: L.ada_res_block(p, x, style(g), 0.7, dilation=2),
                          (2, 8, 6, 6)),
        "generator_const": (lambda g: G.Generator(G.GeneratorConfig(
            size=8, style_dim=sd, n_mlp=2, channel_max=8), generator=g),
            lambda p, x, g: G.generate(p, G.GeneratorConfig(size=8, style_dim=sd, n_mlp=2,
                                                            channel_max=8), [x]),
            (2, sd)),
    }


_OPS = _ops()


def _grads(module, out, x, g):
    """The gradient of a random projection of `out` w.r.t. x and every
    parameter, the split ones whole: {name: tensor}."""
    params = TP.logical_parameters(module)
    leaves = [x] + [q for _, t in params for q in (t if isinstance(t, TP.Shards) else [t])]
    gs = torch.autograd.grad(out, leaves, torch.randn(out.shape, generator=g,
                                                      dtype=out.dtype), allow_unused=True)
    gs = [torch.zeros_like(q) if d is None else d for q, d in zip(leaves, gs)]
    res, i = {"x": gs[0]}, 1
    for name, t in params:
        n = len(t) if isinstance(t, TP.Shards) else 1
        res[name] = torch.cat(gs[i:i + n], t.dim) if isinstance(t, TP.Shards) else gs[i]
        i += n
    return res


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", list(_OPS))
def test_split_layer_float64_matches_whole(name, k, plain_kernels):
    make, fn, shape = _OPS[name]
    whole = L.set_trainable(_noisy(make(_g(1)), _g(2)))
    split = TP.shard_module(copy.deepcopy(whole), _row(k), min_channels=8)
    assert TP.is_sharded(split)
    x = _x(_g(3), *shape)
    outs, grads = [], []
    for m in (whole, split):
        xi = x.clone().requires_grad_()
        TP.reset_stats()
        out = fn(m, xi, _g(4))
        outs.append(out)
        grads.append(_grads(m, out, xi, _g(5)))
    assert TP.stats()["gather_copies"] > 0
    assert (outs[1] - outs[0]).abs().max().item() <= 1e-12 * max(1.0, outs[0].abs().max().item())
    assert set(grads[0]) == set(grads[1])
    for key, want in grads[0].items():
        err = (grads[1][key] - want).abs().max().item()
        assert err <= 1e-12 * max(1.0, want.abs().max().item()), (key, err)


# ---------------------------------------------------------------------------
# the pipeline over a (dp, tp) mesh


def test_pipeline_over_dp_tp_mesh_matches_jax():
    """The tiny VToonify-D (weights from JAX, channel_max 256: the 256-wide
    layers split at JAX's min_channels) on 4 seeded 32 px frames with given
    parsing maps, float32, over make_mesh(devices=["cpu"] * 4, tp=2): two
    rows of two shards, against the port on one device and against JAX's
    pipeline over make_mesh(4, tp=2)."""
    jcfg, jp, cfg, p = _vtoonify_pair("dualstylegan")
    bp = B.init_bisenet(generator=_g(2))
    rng = np.random.RandomState(14)
    frames = rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    x_p = rng.randn(4, 32, 32, 19).astype(np.float32) * 4
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    jpipe = JT.ToonifyPipeline(jp, jcfg, {}, dtype=jnp.float32, mesh=JM.make_mesh(4, tp=2))
    ref = np.asarray(jpipe.process_batch_with_parsing(frames, x_p, jnp.asarray(s_w), 0.5))
    del jpipe
    one = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32, device="cpu")
    tp = T.ToonifyPipeline(p, cfg, bp, dtype=torch.float32,
                           mesh=M.make_mesh(devices=_row(4), tp=2))
    assert len(tp._replicas) == 2 and all(TP.is_sharded(r[1]) for r in tp._replicas)
    assert not TP.is_sharded(tp._mapping) and not TP.is_sharded(tp.parsing)
    TP.reset_stats()
    got = tp.process_batch_with_parsing(frames, x_p, s_w, 0.5).numpy()
    assert TP.stats()["gather_copies"] > 0
    want = one.process_batch_with_parsing(frames, x_p, s_w, 0.5).numpy()
    assert got.shape == (4, 128, 128, 3) and got.dtype == np.uint8 and got.std() > 10
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    diff = np.abs(got.astype(np.int32) - ref)
    assert diff.max() <= 1 and diff.mean() <= 0.05, (diff.max(), diff.mean())
    full = tp.process_batch(frames, s_w, 0.5).numpy()
    diff = np.abs(full.astype(np.int32) - one.process_batch(frames, s_w, 0.5).numpy())
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    with pytest.raises(ValueError, match="not divisible by dp width 2"):
        tp.process_batch(frames[:3], s_w, 0.5)


# ---------------------------------------------------------------------------
# the trainers' steps and state files at tp 2 against tp 1


def _step_setup(which):
    from vtoonify_tpu_torch.models.lpips import init_lpips
    from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig, init_psp_encoder

    g = _g(30)
    backbone = "dualstylegan" if which != "train_t" else "toonify"
    cfg = V.VToonifyConfig(backbone=backbone, channel_max=128, **TINY)
    dcfg = V.CondDiscriminatorConfig(size=64, channel_multiplier=1,
                                     use_condition=which == "train_d", style_num=3)
    tcfg = S.TrainDConfig(crop_size=96, lpips_size=64, aug_max_pad=40, remat=False,
                          compute_dtype="float64")
    pcfg = PSPEncoderConfig(n_styles=cfg.n_latent)
    mods = dict(vt=V.init_vtoonify(cfg, g), d=V.init_cond_discriminator(dcfg, g),
                parsing=B.init_bisenet(generator=g), base=G.init_generator(cfg.generator, g))
    if which != "pretrain_d":
        mods.update(psp=init_psp_encoder(pcfg, g), lpips=init_lpips(g))
    for gen in (mods["base"], getattr(mods["vt"].generator, "generator", mods["vt"].generator)):
        _noisy(gen, g).float()
    inputs = dict(directions=torch.randn((4, cfg.n_latent, 512), generator=g) * 0.1,
                  style=torch.randn((STEP_BATCH, cfg.n_latent, 512), generator=g) * 0.3,
                  weights=[0.5] * 7 + [1.0] * (cfg.n_latent - 7))
    draw = {"train_d": S.sample_train_d_draws, "train_t": S.sample_train_t_draws}.get(which)
    draws = (draw(g, STEP_BATCH, cfg, tcfg, 4) if draw
             else S.sample_pretrain_draws(g, STEP_BATCH, cfg, 4))
    return cfg, dcfg, tcfg, pcfg, mods, inputs, draws


def _shard(module, k):
    """The step tests' split: at their channel_max 128, min_channels 64
    (the rule's threshold halved with the widths) splits the 128-wide
    layers."""
    return TP.shard_module(module, _row(k), min_channels=64)


def _step(which, setup, k):
    """One step of `which` with the trees the trainers split at tp k
    (cli/train_d.py, cli/train_t.py); returns (state, metrics)."""
    cfg, dcfg, tcfg, pcfg, base_mods, inputs, draws = setup
    m = copy.deepcopy(base_mods)
    if which == "pretrain_d":
        state = S.init_pretrain_state(m["vt"], device="cpu")
        _, frozen = S.split_trainable(m["vt"], pretrain=True)
        for f in frozen.values():
            _shard(f, k)
        assert TP.is_sharded(frozen["generator"]) == (k > 1)
        metrics = S.pretrain_step(state, frozen, m["parsing"], cfg, inputs["directions"],
                                  inputs["style"], 0.6, compute_dtype="float64",
                                  draws=draws)
        return state, metrics
    _shard(m["vt"], k)
    _shard(m["d"], k)
    assert TP.is_sharded(m["vt"].encoder) == TP.is_sharded(m["d"]) == (k > 1)
    _, frozen = S.split_trainable(m["vt"])
    if which == "train_d":
        state = S.init_train_d_state(m["vt"], m["d"], STEP_BATCH, cfg, tcfg, device="cpu")
        metrics = S.train_d_step(
            state, frozen, m["parsing"], m["psp"], pcfg, None, m["lpips"], cfg, dcfg, tcfg,
            inputs["directions"], inputs["style"], torch.tensor([2]), 0.5,
            inputs["weights"], 0.3, 0.5, False, xl_override=inputs["style"], draws=draws)
    else:
        _shard(m["base"], k)
        state = S.init_train_t_state(m["vt"], m["d"], tcfg, device="cpu")
        metrics = S.train_t_step(state, frozen, m["base"], m["parsing"], m["psp"], pcfg,
                                 None, m["lpips"], cfg, dcfg, tcfg, inputs["directions"],
                                 STEP_BATCH, 0.3, draws=draws)
    return state, metrics


STAGES = ["train_d", "pretrain_d", "train_t"]
STEP_BATCH = 1


@pytest.fixture(scope="module")
def stepped():
    """{stage: {k: (state, metrics)}} for k = 1, 2, and {stage: setup} (the
    kernels' plain versions in their place, as the float64 compute
    needs)."""
    mp = pytest.MonkeyPatch()
    for name in KERNELS:
        mp.setattr(K, name, getattr(K, name + "_plain"))
    mp.setattr(L, "depth_to_space2", K.depth_to_space2_plain)
    try:
        out, setups = {}, {}
        for which in STAGES:
            setups[which] = _step_setup(which)
            out[which] = {k: _step(which, setups[which], k) for k in (1, 2)}
        yield out, setups
    finally:
        mp.undo()


def _rel_l2(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    num = sum(((a[k].double() - b[k].double()) ** 2).sum() for k in b)
    den = sum((b[k].double() ** 2).sum() for k in b)
    return (num / den).sqrt().item()


@pytest.mark.parametrize("which", STAGES)
def test_step_at_tp2_matches_tp1(stepped, which):
    (s1, m1), (s2, m2) = stepped[0][which][1], stepped[0][which][2]
    assert sorted(m1) == sorted(m2)
    for key in m1:
        assert abs(float(m2[key]) - float(m1[key])) <= 1e-10 * max(abs(float(m1[key])), 1e-30), key
    fields = ("trainable", "ema") + (("d",) if which != "pretrain_d" else ())
    for f in fields:
        assert _rel_l2(getattr(s2, f).state_dict(), getattr(s1, f).state_dict()) <= 1e-10, f
    opts = [("g_opt", "trainable")] + ([("d_opt", "d")] if which != "pretrain_d" else [])
    for opt, mod in opts:
        a = TP.optimizer_state_dict(getattr(s2, opt), getattr(s2, mod))
        b = TP.optimizer_state_dict(getattr(s1, opt), getattr(s1, mod))
        assert sorted(a["names"]) == sorted(b["names"])
        for n in b["state"]:
            for key in ("exp_avg", "exp_avg_sq"):
                want = b["state"][n][key]
                assert (a["state"][n][key] - want).norm() <= 1e-10 * max(want.norm(), 1e-30)


def _assert_same_state(a, b):
    """Two train states (any tp) hold the same numbers."""
    assert type(a) is type(b) and a.step == b.step
    for f in ("trainable", "ema", "d"):
        if hasattr(a, f):
            sa, sb = getattr(a, f).state_dict(), getattr(b, f).state_dict()
            assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa), f
    for opt, mod in (("g_opt", "trainable"), ("d_opt", "d")):
        if hasattr(a, opt):
            oa = TP.optimizer_state_dict(getattr(a, opt), getattr(a, mod))
            ob = TP.optimizer_state_dict(getattr(b, opt), getattr(b, mod))
            assert sorted(oa["names"]) == sorted(ob["names"])
            assert oa["param_groups"] == ob["param_groups"]
            assert set(oa["state"]) == set(ob["state"])
            for n, st in oa["state"].items():
                assert all(torch.equal(st[k], ob["state"][n][k]) for k in st), (opt, n)


def test_train_state_moves_between_tp(stepped, tmp_path):
    """The D stage-2 state after a tp-2 step, saved, loads into fresh
    states at tp 1 and at tp 2 (the same init) unchanged; a tp-1 file loads
    at tp 2."""
    setup = stepped[1]["train_d"]
    cfg, dcfg, tcfg = setup[:3]

    def fresh(k):
        m = copy.deepcopy(setup[4])
        _shard(m["vt"], k)
        _shard(m["d"], k)
        return S.init_train_d_state(m["vt"], m["d"], STEP_BATCH, cfg, tcfg, device="cpu")

    for k_from, k_to in ((2, 1), (2, 2), (1, 2)):
        path = str(tmp_path / f"state_tp{k_from}.ckpt")
        kept = stepped[0]["train_d"][k_from][0]
        CK.save_train_state(path, kept)
        loaded = CK.load_train_state(path, fresh(k_to), device="cpu")
        assert TP.is_sharded(loaded.trainable) == (k_to > 1)
        _assert_same_state(loaded, kept)
