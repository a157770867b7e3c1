"""The port's stage-1 steps (encoder distillation) of VToonify-D and
VToonify-T vs the JAX package's (CPU, float32), the train-state file, and
the layer-wise generator blend.

The trainer's --tiny configuration, batch 2. Params come from the port's
init (noise weights and styled-conv biases randomized, so the teachers'
images are not blind), laid out as JAX trees by `_jax_tree` (shared with
tests/test_torch_train_step.py), and carried back into the port with
`load_jax_params`. The port's `PretrainDraws` is filled from JAX's own
key splits (`jax.random.split`, `G.make_noise`). The two JAX steps, their
synthesis and their draws come out of one jit (`jax_run`).
"""

import copy
import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import _jax_tree, _nchw, _np, _updates_agree
from vtoonify_tpu.models import bisenet as JB
from vtoonify_tpu.models import generator as JG
from vtoonify_tpu.models import vtoonify as JV
from vtoonify_tpu.train import steps as JS
from vtoonify_tpu.train import synth as JSY
from vtoonify_tpu.utils import blend as JBL
from vtoonify_tpu_torch.convert.from_jax import jax_state_dict, load_jax_params
from vtoonify_tpu_torch.models import bisenet as B
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.train import steps as S
from vtoonify_tpu_torch.train import synth as SY
from vtoonify_tpu_torch.utils import blend as BL
from vtoonify_tpu_torch.utils import checkpoint as CK

TINY = dict(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)
BATCH, N_DIR, N_STYLES = 2, 4, 3
D_S = 0.6
SEL = np.array([0, 2])
BLEND = [0.75] * 7 + [0.25] * 5  # n_latent 12, every layer lerped


def release_memory():
    """Drop JAX's compiled executables and give freed heap back to the OS,
    so a pytest worker does not carry a module's peak memory on (the suite
    runs several workers in one machine's memory)."""
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc
        pass


@pytest.fixture(scope="module", autouse=True)
def lean_worker():
    """One torch thread while the module runs (the suite's workers share
    the host's cores, and a torch thread pool each would oversubscribe
    them); the memory released at the end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


def _randomize_generator(tree, rng):
    """Noise weights and styled-conv biases of a JAX-layout generator tree,
    in place."""
    for blk in [tree["conv1"], *tree["convs"]]:
        blk["noise"]["weight"] = np.float32(rng.uniform(0.05, 0.2))
        blk["act_bias"] = (rng.randn(*blk["act_bias"].shape) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def bundle():
    g = torch.Generator().manual_seed(61)
    key = jax.random.PRNGKey(0)  # traced for shapes only
    out = {}
    for backbone in ("dualstylegan", "toonify"):
        jcfg = JV.VToonifyConfig(backbone=backbone, **TINY)
        cfg = V.VToonifyConfig(backbone=backbone, **TINY)
        out[backbone] = dict(
            jcfg=jcfg, cfg=cfg, vt=V.init_vtoonify(cfg, g),
            jtree=_jax_tree(V.init_vtoonify(cfg, g),
                            jax.eval_shape(lambda c=jcfg: JV.init_vtoonify(key, c))))
    gcfg = out["toonify"]["cfg"].generator
    jgcfg = out["toonify"]["jcfg"].generator
    gen_shape = jax.eval_shape(lambda: JG.init_generator(key, jgcfg))
    rng = np.random.RandomState(5)
    jax_side = dict(
        parsing=_jax_tree(B.init_bisenet(generator=g),
                          jax.eval_shape(lambda: JB.init_bisenet(key))),
        base=_jax_tree(G.init_generator(gcfg, g), gen_shape),
        low=_jax_tree(G.init_generator(gcfg, g), gen_shape))
    for t in (jax_side["base"], jax_side["low"],
              out["dualstylegan"]["jtree"]["generator"]["generator"],
              out["toonify"]["jtree"]["generator"]):
        _randomize_generator(t, rng)
    port = {k: load_jax_params(m, jax_side[k]) for k, m in (
        ("parsing", B.init_bisenet(generator=g)),
        ("base", G.init_generator(gcfg, g)), ("low", G.init_generator(gcfg, g)))}
    for b in out.values():
        b["vt"] = load_jax_params(b["vt"], b["jtree"])
    return dict(jax=jax_side, port=port, nets=out, gcfg=gcfg, jgcfg=jgcfg,
                directions=(rng.randn(N_DIR, 12, 512) * 0.1).astype(np.float32),
                styles=(rng.randn(N_STYLES, 12, 512) * 0.3).astype(np.float32))


def _pretrain_draw_arrays(key, gcfg):
    """The draws JAX's synth_pretrain_batch / synth_pretrain_t_batch make
    from `key`: the same sub-key splits, through JAX's public functions."""
    k1, k2, k3 = jax.random.split(key, 3)
    ka, kb = jax.random.split(k1)
    z = jax.random.normal(ka, (BATCH, gcfg.style_dim), jnp.float32)
    idx = jax.random.randint(kb, (BATCH,), 0, N_DIR)
    noise = [JG.make_noise(None, gcfg, k, randomize=True, batch=BATCH)
             for k in (k2, k3)]
    return z, idx, noise


def _pretrain_draws(arrays):
    z, idx, (nc, nf) = arrays
    return S.PretrainDraws(torch.from_numpy(np.array(z)),
                           torch.from_numpy(np.array(idx)).long(),
                           [_nchw(n) for n in nc], [_nchw(n) for n in nf])


@pytest.fixture(scope="module")
def jax_run(bundle):
    """One jit: JAX's pretrain_step (D) and pretrain_t_step (T), the
    synthesis each runs (same key and operands) and their draws."""
    nd, nt, j = bundle["nets"]["dualstylegan"], bundle["nets"]["toonify"], bundle["jax"]
    jcfg_d, jcfg_t = nd["jcfg"], nt["jcfg"]
    _, frozen_d = JS.split_trainable(nd["jtree"], pretrain=True)
    _, frozen_t = JS.split_trainable(nt["jtree"], pretrain=True)
    blended = JBL.blend_generators(j["low"], j["base"], BLEND)

    def run(vt_d, frozen_d, vt_t, frozen_t, parsing, base, directions, style,
            d_s, key_d, key_t):
        data_d = JSY.synth_pretrain_batch(key_d, vt_d, jcfg_d, parsing,
                                          directions, style, d_s)
        state_d, m_d = JS.pretrain_step(JS.init_pretrain_state(vt_d), frozen_d,
                                        parsing, jcfg_d, directions, style, d_s,
                                        key_d)
        data_t = JSY.synth_pretrain_t_batch(key_t, base, jcfg_t.generator, vt_t,
                                            jcfg_t, parsing, directions, BATCH)
        state_t, m_t = JS.pretrain_t_step(JS.init_pretrain_state(vt_t), frozen_t,
                                          base, parsing, jcfg_t, directions,
                                          BATCH, key_t)
        draws = [_pretrain_draw_arrays(k, bundle["jgcfg"]) for k in (key_d, key_t)]
        return (data_d, state_d, m_d), (data_t, state_t, m_t), draws

    res_d, res_t, draws = _np(jax.jit(run)(
        nd["jtree"], frozen_d, nt["jtree"], frozen_t, j["parsing"], j["base"],
        bundle["directions"], bundle["styles"][SEL], jnp.asarray(D_S),
        jax.random.PRNGKey(21), jax.random.PRNGKey(22)))
    out = {"dualstylegan": (*res_d, _pretrain_draws(draws[0])),
           "toonify": (*res_t, _pretrain_draws(draws[1])),
           "blended": _np(blended)}
    # the JAX trees are not read again: free them before the port's steps
    del frozen_d, frozen_t, blended, j, nd["jtree"], nt["jtree"]
    bundle["jax"].clear()
    release_memory()
    return out


def _port_args(bundle, backbone):
    """(synth fn, step fn) of the port for a backbone, on copies of the
    port's modules (the step mutates them)."""
    net, p = bundle["nets"][backbone], bundle["port"]
    directions = torch.from_numpy(bundle["directions"])
    cfg = net["cfg"]
    if backbone == "dualstylegan":
        style = torch.from_numpy(bundle["styles"][SEL])

        def synth(draws, vt):
            return SY.synth_pretrain_batch(draws, vt, cfg, p["parsing"], directions,
                                           style, D_S)

        def step(state, frozen, draws):
            return S.pretrain_step(state, frozen, p["parsing"], cfg, directions,
                                   style, D_S, draws=draws)
    else:
        def synth(draws, vt):
            return SY.synth_pretrain_t_batch(draws, p["base"], cfg.generator, vt,
                                             cfg, p["parsing"], directions)

        def step(state, frozen, draws):
            return S.pretrain_t_step(state, frozen, p["base"], p["parsing"], cfg,
                                     directions, BATCH, draws=draws)
    return synth, step


@pytest.mark.parametrize("backbone", ["dualstylegan", "toonify"])
def test_synth_pretrain_batch_matches_jax(bundle, jax_run, backbone):
    """The stage-1 teacher data: the content image through StyleGAN (D: the
    DualStyleGAN's; T: the base G0) with noise, BiSeNet, and the feature
    targets (D: DualStyleGAN after the ModRes region at degree d_s; T: the
    generator's return_feature_ind=6 exit). Float32; atol 2e-4 of each
    output's range, the stage-2 synthesis test's bound."""
    ref, draws = jax_run[backbone][0], jax_run[backbone][3]
    synth, _ = _port_args(bundle, backbone)
    with torch.no_grad():
        got = synth(draws, bundle["nets"][backbone]["vt"])
    for k in ("real_input", "real_feat", "real_skip"):
        want = np.asarray(ref[k])
        have = np.moveaxis(got[k].numpy(), 1, -1)
        assert have.shape == want.shape, k
        scale = np.abs(want).max()
        np.testing.assert_allclose(have, want, rtol=0, atol=2e-4 * scale, err_msg=k)
    assert np.asarray(ref["real_feat"]).std() > 1e-3  # not a blind compare


def _adam_grads(state):
    return {id(q): state.g_opt.state[q]["exp_avg"].numpy() / (1 - S.ADAM_BETA1)
            for q in state.trainable.parameters()}


@pytest.mark.parametrize("backbone", ["dualstylegan", "toonify"])
def test_pretrain_step_matches_jax(bundle, jax_run, backbone):
    """One stage-1 step from the same encoder and draws: the loss (rtol
    2e-3), the Adam update of every encoder parameter (within 0.02 lr where
    the gradient is clear of float32 noise, `_updates_agree`) and the EMA
    (atol 1e-6)."""
    _, jstate, jm, draws = jax_run[backbone]
    _, step = _port_args(bundle, backbone)
    vt = copy.deepcopy(bundle["nets"][backbone]["vt"])
    old = {k: v.clone() for k, v in vt.encoder.state_dict().items()}
    state = S.init_pretrain_state(vt, device="cpu")
    _, frozen = S.split_trainable(vt, pretrain=True)
    m = step(state, frozen, draws)
    assert state.step == 1 and set(m) == {"emse"}
    np.testing.assert_allclose(float(m["emse"]), float(jm["emse"]), rtol=2e-3)

    want = jax_state_dict(_np(jstate.encoder))
    gmap = _adam_grads(state)
    named = dict(state.trainable["encoder"].named_parameters())
    assert set(named) == set(want)
    covered = total = 0
    for k, q in named.items():
        c, n = _updates_agree(f"encoder.{k}", q.detach().numpy(), old[k].numpy(),
                              want[k].numpy(), gmap[id(q)])
        covered, total = covered + c, total + n
    assert covered > 0.25 * total, (covered, total)
    want_ema = jax_state_dict(_np(jstate.ema_encoder))
    for k, q in state.ema["encoder"].state_dict().items():
        np.testing.assert_allclose(q.numpy(), want_ema[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=f"ema.{k}")


def test_pretrain_state_save_load_gives_the_same_step(bundle, jax_run, tmp_path):
    """A stage-1 state saved after one step and loaded into a fresh state
    takes its second step exactly as the state it was saved from does (same
    draws; parameters, EMA, Adam moments and the step count bit for bit)."""
    _, step = _port_args(bundle, "dualstylegan")
    draws = jax_run["dualstylegan"][3]

    def fresh():
        vt = copy.deepcopy(bundle["nets"]["dualstylegan"]["vt"])
        return S.init_pretrain_state(vt, device="cpu"), S.split_trainable(vt, True)[1]

    kept, frozen_k = fresh()
    step(kept, frozen_k, draws)
    CK.save_train_state(str(tmp_path / "pretrain_state.ckpt"), kept)
    loaded, frozen_l = fresh()
    CK.load_train_state(str(tmp_path / "pretrain_state.ckpt"), loaded, device="cpu")
    assert loaded.step == 1
    m_kept = step(kept, frozen_k, draws)
    m_loaded = step(loaded, frozen_l, draws)
    assert torch.equal(m_kept["emse"], m_loaded["emse"])
    for part in ("trainable", "ema"):
        a, b = getattr(kept, part).state_dict(), getattr(loaded, part).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), part
    for q_k, q_l in zip(kept.trainable.parameters(), loaded.trainable.parameters()):
        for s in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(kept.g_opt.state[q_k][s], loaded.g_opt.state[q_l][s])
    assert kept.step == loaded.step == 2


def test_blend_generators_matches_jax(bundle, jax_run):
    """The layer-wise lerp (conv1 -> 0, to_rgb1 -> 1, convs[i] -> i+1,
    to_rgbs[i] -> 2i+3; the MLP, input and noises from the high model)
    equals JAX's, element for element, and leaves its inputs alone."""
    p = bundle["port"]
    low_before = copy.deepcopy(p["low"].state_dict())
    got = BL.blend_generators(p["low"], p["base"], BLEND).state_dict()
    want = jax_state_dict(jax_run["blended"])
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k].reshape(v.shape)), k
    assert all(torch.equal(v, p["low"].state_dict()[k]) for k, v in low_before.items())
    base = p["base"].state_dict()
    assert torch.equal(got["style.0.weight"], base["style.0.weight"])
    assert not torch.equal(got["convs.3.conv.weight"], base["convs.3.conv.weight"])
