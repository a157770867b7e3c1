"""The port's VToonify-T stage-2 step vs the JAX package's (CPU, float32),
the trainers' fusion identity init against JAX's, and the stage-2 train
states through their file.

The trainer's --tiny configuration (cli/train_t.py): VToonifyConfig(in_size
32, out_size 128, channel_multiplier 1, num_res_layers 2, backbone
"toonify"), an unconditional D at 64 px with channel_multiplier 1, crop 96,
LPIPS at 64 px, aug_max_pad 40, batch 2. Params come from the port's init
(noise weights and styled-conv biases randomized), laid out as JAX trees by
`_jax_tree` and carried back with `load_jax_params`. The port's
`TrainTDraws` is filled from JAX's own key splits; JAX's step, its
synthesis and the draws come out of one jit (`jax_step`).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import (  # noqa: F401
    _randomize_generator,
    lean_worker,
    release_memory,
)
from tests.test_torch_train_step import _jax_tree, _nchw, _np, _updates_agree
from vtoonify_tpu.models import bisenet as JB
from vtoonify_tpu.models import generator as JG
from vtoonify_tpu.models import lpips as JLP
from vtoonify_tpu.models import psp_encoder as JP
from vtoonify_tpu.models import vtoonify as JV
from vtoonify_tpu.train import augment as JA
from vtoonify_tpu.train import steps as JS
from vtoonify_tpu.train import synth as JSY
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict, load_jax_params
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.models import lpips as LP
from vtoonify_tpu_torch.models import psp_encoder as P
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.train import steps as S
from vtoonify_tpu_torch.train import synth as SY
from vtoonify_tpu_torch.utils import checkpoint as CK

TINY = dict(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)
BATCH, N_DIR = 2, 4
TCFG = dict(crop_size=96, lpips_size=64, aug_max_pad=40)
DCFG = dict(size=64, channel_multiplier=1, use_condition=False)
TMP_RAMP = 0.3
LR = 1e-4


@pytest.fixture(scope="module")
def bundle():
    g = torch.Generator().manual_seed(62)
    key = jax.random.PRNGKey(0)  # traced for shapes only
    jcfg = JV.VToonifyConfig(backbone="toonify", **TINY)
    cfg = V.VToonifyConfig(backbone="toonify", **TINY)
    jpcfg = JP.PSPEncoderConfig(n_styles=jcfg.n_latent)
    pcfg = P.PSPEncoderConfig(n_styles=cfg.n_latent)
    inits = dict(
        vt=(V.init_vtoonify(cfg, g), lambda: JV.init_vtoonify(key, jcfg)),
        base=(G.init_generator(cfg.generator, g),
              lambda: JG.init_generator(key, jcfg.generator)),
        parsing=(B.init_bisenet(generator=g), lambda: JB.init_bisenet(key)),
        d=(V.init_cond_discriminator(V.CondDiscriminatorConfig(**DCFG), g),
           lambda: JV.init_cond_discriminator(key, JV.CondDiscriminatorConfig(**DCFG))),
        psp=(P.init_psp_encoder(pcfg, g), lambda: JP.init_psp_encoder(key, jpcfg)),
        lpips=(LP.init_lpips(g), lambda: JLP.init_lpips(key)))
    jax_side = {k: _jax_tree(m, jax.eval_shape(f)) for k, (m, f) in inits.items()}
    rng = np.random.RandomState(4)
    _randomize_generator(jax_side["vt"]["generator"], rng)
    _randomize_generator(jax_side["base"], rng)
    port = {k: load_jax_params(m, jax_side[k]) for k, (m, _) in inits.items()}
    jax_side.update(cfg=jcfg, pcfg=jpcfg, dcfg=JV.CondDiscriminatorConfig(**DCFG))
    return dict(jax=jax_side, port=port, cfg=cfg, pcfg=pcfg,
                dcfg=V.CondDiscriminatorConfig(**DCFG),
                directions=(rng.randn(N_DIR, cfg.n_latent, 512) * 0.1).astype(np.float32))


def _draw_arrays(key, gcfg, tcfg, out_size):
    """The draws JAX's train_t_step makes from `key`: the same sub-key
    splits, through JAX's public functions."""
    k_synth, k_crop = jax.random.split(key)
    ks = jax.random.split(k_synth, 4)
    ka, kb = jax.random.split(ks[0])
    z = jax.random.normal(ka, (BATCH, gcfg.style_dim), jnp.float32)
    idx = jax.random.randint(kb, (BATCH,), 0, N_DIR)
    noise = [JG.make_noise(None, gcfg, k, randomize=True, batch=BATCH)
             for k in ks[1:3]]
    affine = jnp.linalg.inv(JA.sample_affine(ks[3], tcfg.aug_p, BATCH,
                                             out_size, out_size))
    max_off = out_size - tcfg.crop_size
    off_w = jax.random.randint(k_crop, (), 0, max_off + 1)
    off_h = jax.random.randint(jax.random.fold_in(k_crop, 1), (), 0, max_off + 1)
    return z, idx, noise, affine, off_w, off_h


def _train_t_draws(arrays):
    z, idx, (nc, ns), affine, off_w, off_h = arrays
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return S.TrainTDraws(t(z), t(idx).long(), [_nchw(n) for n in nc],
                         [_nchw(n) for n in ns], t(affine), int(off_w), int(off_h))


@pytest.fixture(scope="module")
def jax_step(bundle):
    """One jit: JAX's train_t_step, the synth_train_t_batch it runs (same
    sub-key and operands) and its draws."""
    j = bundle["jax"]
    jt = JS.TrainDConfig(**TCFG)
    jcfg = j["cfg"]
    _, jfrozen = JS.split_trainable(j["vt"], pretrain=False)

    def run(vt, jfrozen, d, base, parsing, psp, lpips, directions, tmp_ramp, key):
        jstate = JS.init_train_t_state(vt, d, jt)
        data = JSY.synth_train_t_batch(
            jax.random.split(key)[0], base, jcfg.generator, vt, jcfg, parsing,
            psp, j["pcfg"], None, directions, BATCH, aug_p=jt.aug_p,
            aug_max_pad=jt.aug_max_pad)
        new_state, metrics = JS.train_t_step(
            jstate, jfrozen, base, parsing, psp, j["pcfg"], None, lpips, jcfg,
            j["dcfg"], jt, directions, BATCH, tmp_ramp, key)
        return data, new_state, metrics, _draw_arrays(key, jcfg.generator, jt,
                                                      jcfg.out_size)

    data, jstate2, jm, draws = _np(jax.jit(run)(
        j["vt"], jfrozen, j["d"], j["base"], j["parsing"], j["psp"], j["lpips"],
        bundle["directions"], jnp.asarray(TMP_RAMP), jax.random.PRNGKey(31)))
    # the JAX trees are not read again: free them before the port's step
    del jfrozen, j
    bundle["jax"].clear()
    release_memory()
    return dict(data=data, state=jstate2, metrics=jm, draws=_train_t_draws(draws))


def test_synth_train_t_batch_matches_jax(bundle, jax_step):
    """The T stage-2 pair: content from the base G0 with noise, xl = [0.5
    w'[:7], pSp's code through G0's MLP [7:]], the target from G1 on xl with
    noise, the augment and BiSeNet. Float32; atol 2e-4 of each output's
    range."""
    p, ref = bundle["port"], jax_step["data"]
    tcfg = S.TrainDConfig(**TCFG)
    cfg = bundle["cfg"]
    with torch.no_grad():
        got = SY.synth_train_t_batch(
            jax_step["draws"], p["base"], cfg.generator, p["vt"], cfg,
            p["parsing"], p["psp"], bundle["pcfg"], None,
            torch.from_numpy(bundle["directions"]), aug_p=tcfg.aug_p,
            aug_max_pad=tcfg.aug_max_pad)
    assert set(got) == set(ref)
    for k in ref:
        want = np.asarray(ref[k])
        have = got[k].numpy()
        if have.ndim == 4:
            have = np.moveaxis(have, 1, -1)
        assert have.shape == want.shape, k
        scale = np.abs(want).max()
        np.testing.assert_allclose(have, want, rtol=0, atol=2e-4 * scale, err_msg=k)
    assert np.asarray(ref["real_output"]).std() > 0.05  # not a blind compare


def _run_port_step(bundle, draws):
    p = bundle["port"]
    tt = S.TrainDConfig(**TCFG)
    vt, d = copy.deepcopy(p["vt"]), copy.deepcopy(p["d"])  # the step mutates them
    state = S.init_train_t_state(vt, d, tt, device="cpu")
    _, frozen = S.split_trainable(vt)
    m = S.train_t_step(state, frozen, p["base"], p["parsing"], p["psp"],
                       bundle["pcfg"], None, p["lpips"], bundle["cfg"],
                       bundle["dcfg"], tt, torch.from_numpy(bundle["directions"]),
                       BATCH, TMP_RAMP, draws=draws)
    return state, vt, d, m


@pytest.fixture(scope="module")
def port_step(bundle, jax_step):
    """The port's T step from the same modules and draws (one run, shared)."""
    return _run_port_step(bundle, jax_step["draws"])


def test_train_t_step_matches_jax(bundle, jax_step, port_step):
    """One whole T stage-2 step, float32, batch 2: the five metrics (rtol
    2e-3), the updated trainables and D params (`_updates_agree`) and the
    EMA (atol 1e-6)."""
    p = bundle["port"]
    jstate2, jm = jax_step["state"], jax_step["metrics"]
    state, _, _, m = port_step
    assert state.step == 1 and set(m) == {"g", "gr", "gf", "tp", "d"} == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-3,
                                   atol=1e-9, err_msg=k)
    assert float(jm["tp"]) > 0

    old_tr = torch.nn.ModuleDict(dict(S.split_trainable(p["vt"])[0])).state_dict()
    covered = total = 0
    for which, module, old, jtree, opt in (
            ("trainable", state.trainable, old_tr, jstate2.trainable, state.g_opt),
            ("d", state.d, p["d"].state_dict(), jstate2.d_params, state.d_opt)):
        want = jax_state_dict(_np(jtree))
        named = dict(module.named_parameters())
        assert set(named) == set(want), which
        for k, q in named.items():
            grad = opt.state[q]["exp_avg"].numpy() / (1 - S.ADAM_BETA1)
            c, n = _updates_agree(f"{which}.{k}", q.detach().numpy(),
                                  old[k].numpy(), want[k].numpy(), grad, lr=LR)
            covered, total = covered + c, total + n
    assert covered > 0.25 * total, (covered, total)
    want_ema = jax_state_dict(_np(jstate2.ema))
    for k, q in state.ema.state_dict().items():
        np.testing.assert_allclose(q.numpy(), want_ema[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=f"ema.{k}")


def _jax_fusion_identity_init(tree, backbone):
    """JAX's stage-2 start, as vtoonify_tpu/cli/train_d.py (D) and
    cli/train_t.py (T) run it on the cat2-split fusion weights."""
    for fo in tree["fusion_out"]:
        p = fo["conv"] if backbone == "dualstylegan" else fo
        wa = jnp.asarray(p["weight_a"])
        c = wa.shape[-1]
        p["weight_a"] = (wa * 0.01).at[1, 1, 0:c, :].add(jnp.eye(c))
        p["weight_b"] = jnp.asarray(p["weight_b"]) * 0.01
    for fs in tree["fusion_skip"]:
        wa = jnp.asarray(fs["weight_a"])
        c = wa.shape[-1]
        fs["weight_a"] = (wa * 0.01).at[1, 1, 0:c, :].add(jnp.eye(c))
        fs["weight_b"] = jnp.asarray(fs["weight_b"]) * 0.01
    return tree


@pytest.mark.parametrize("backbone", ["dualstylegan", "toonify"])
def test_fusion_identity_init_matches_jax(backbone):
    """0.01 w plus the identity at the centre tap over the first c input
    channels, on the port's unsplit weights: equal to JAX's init on its
    cat2-split weights, element for element."""
    cfg = V.VToonifyConfig(backbone=backbone, **TINY)
    jcfg = JV.VToonifyConfig(backbone=backbone, **TINY)
    vt = V.init_vtoonify(cfg, torch.Generator().manual_seed(9))
    shapes = jax.eval_shape(lambda: JV.init_vtoonify(jax.random.PRNGKey(0), jcfg))
    keys = ("fusion_out", "fusion_skip")
    tree = {k: _jax_tree(getattr(vt, k), shapes[k]) for k in keys}
    want = {k: jax_state_dict(_np(v)) for k, v in
            _jax_fusion_identity_init(tree, backbone).items()}
    S.fusion_identity_init(vt)
    for k in keys:
        got = getattr(vt, k).state_dict()
        assert set(got) == set(want[k])
        for name, v in got.items():
            assert torch.equal(v, want[k][name]), f"{k}.{name}"
    assert float(vt.fusion_skip[0].weight[1, 1, 1, 1]) > 0.9


def _assert_same_state(a, b):
    assert type(a) is type(b) and a.step == b.step
    for f in ("trainable", "ema", "d"):
        sa, sb = getattr(a, f).state_dict(), getattr(b, f).state_dict()
        assert set(sa) == set(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa), f
    for opt in ("g_opt", "d_opt"):
        oa, ob = getattr(a, opt).state_dict(), getattr(b, opt).state_dict()
        assert oa["param_groups"] == ob["param_groups"]
        assert set(oa["state"]) == set(ob["state"])
        for i, st in oa["state"].items():
            assert all(torch.equal(st[k], ob["state"][i][k]) for k in st), (opt, i)
    if hasattr(a, "wc_prev"):
        assert torch.equal(a.wc_prev, b.wc_prev)


@pytest.mark.parametrize("kind", ["TrainTState", "TrainDState"])
def test_train_state_file_round_trip(bundle, port_step, tmp_path, kind):
    """A stage-2 state after a step (Adam moments set, the EMA moved), saved
    and loaded into a fresh state from the same init, holds the same
    trainables, EMA, D, both Adams, step and (D) color-jitter carry, bit for
    bit; a state of another kind is refused."""
    tt = S.TrainDConfig(**TCFG)
    p = bundle["port"]
    if kind == "TrainTState":
        state = port_step[0]

        def fresh():
            return S.init_train_t_state(copy.deepcopy(p["vt"]), copy.deepcopy(p["d"]),
                                        tt, device="cpu")
    else:  # a D state with its moments and carry set by hand
        cfg = V.VToonifyConfig(**TINY)
        g = torch.Generator().manual_seed(3)
        vt = V.init_vtoonify(cfg, g)
        d = V.init_cond_discriminator(V.CondDiscriminatorConfig(
            size=64, channel_multiplier=1, use_condition=True, style_num=3), g)

        def fresh():
            return S.init_train_d_state(copy.deepcopy(vt), copy.deepcopy(d), BATCH,
                                        cfg, tt, device="cpu")
        state = fresh()
        for opt, params in ((state.g_opt, state.trainable.parameters()),
                            (state.d_opt, state.d.parameters())):
            params = list(params)
            for q in params:
                q.grad = torch.randn(q.shape, generator=g)
            opt.step()
        state.wc_prev = torch.randn(state.wc_prev.shape, generator=g)
        state.step = 5
    path = str(tmp_path / "train_state.ckpt")
    CK.save_train_state(path, state)
    loaded = CK.load_train_state(path, fresh(), device="cpu")
    _assert_same_state(state, loaded)
    with pytest.raises(ValueError, match="holds a"):
        CK.load_train_state(path, S.init_pretrain_state(
            V.init_vtoonify(bundle["cfg"], torch.Generator().manual_seed(0)),
            device="cpu"))
