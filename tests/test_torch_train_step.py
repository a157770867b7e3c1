"""The port's stage-2 training step vs the JAX package's (CPU, float32).

The trainer's --tiny configuration (cli/train_d.py): VToonifyConfig(in_size
32, out_size 128, channel_multiplier 1, num_res_layers 2), conditional D at
64 px with channel_multiplier 1, crop 96, LPIPS at 64 px, aug_max_pad 40,
batch 2. Params are drawn by the port's init functions from a seeded
torch.Generator (with random noise weights and styled-conv biases, so noise
injection and the images are not blind), laid out as the JAX package's
trees (shapes from `jax.eval_shape` of its init functions), and carried back
into the port with `load_jax_params`. torch's random streams cannot match
`jax.random`, so the port's `TrainDDraws` is filled from JAX's own public
functions with the sub-keys JAX's step splits from its key
(`jax.random.split`, `G.make_noise`, `augment.sample_affine`).

JAX's step, the synthesis it runs and those draws come out of one jit
(`jax_step`), shared by both tests, so the file compiles one JAX program.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from vtoonify_tpu_torch.models import lpips as LP
from vtoonify_tpu_torch.models import psp_encoder as P
from vtoonify_tpu_torch.models import vtoonify as V
from vtoonify_tpu_torch.train import steps as S
from vtoonify_tpu_torch.train import synth as SY

TINY = dict(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)
BATCH = 2
N_DIR, N_STYLES = 4, 3
TCFG = dict(crop_size=96, lpips_size=64, aug_max_pad=40)
DCFG = dict(size=64, channel_multiplier=1, use_condition=True, style_num=N_STYLES)
D_S, TMP_RAMP, FUSE_T = 0.6, 0.3, 0.5
N_LATENT = 12  # 2 log2(128) - 2
WEIGHTS = [0.6] * 7 + [1.0] * (N_LATENT - 7)
LR = 1e-4
SEL = np.array([0, 2])  # the batch's exstyle indices


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _jax_tree(module, like):
    """The JAX-layout pytree of `like` (the shapes of a JAX init) filled
    from a port module's state dict: the inverse of `load_jax_params`'s
    layout rules (HWIO conv weights, NHWC image-like leaves, (in, out)
    linear weights, cat2 convs split into weight_a / weight_b)."""
    sd = {k: v.numpy() for k, v in module.state_dict().items()}

    def fill(tree, prefix):
        def key(k):
            return f"{prefix}.{k}" if prefix else str(k)
        if isinstance(tree, dict):
            out = {}
            if "weight_a" in tree:
                w = sd[key("weight")].transpose(2, 3, 1, 0)
                ca = tree["weight_a"].shape[2]
                out["weight_a"], out["weight_b"] = w[:, :, :ca], w[:, :, ca:]
            for k, v in tree.items():
                if k not in out:
                    out[k] = fill(v, key(k))
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v, key(i)) for i, v in enumerate(tree))
        a, name = sd[prefix], prefix.rsplit(".", 1)[-1]
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0) if name == "weight" else a.transpose(0, 2, 3, 1)
        elif a.ndim == 2 and name == "weight":
            a = a.T
        assert a.shape == tuple(tree.shape), prefix
        return np.ascontiguousarray(a, dtype=tree.dtype)

    return fill(like, "")


@pytest.fixture(scope="module", autouse=True)
def lean_worker():
    """tests/test_torch_train_stage1.py's lean_worker (one torch thread, the
    memory released at the end), restated: that module imports this one."""
    from tests.test_torch_train_stage1 import release_memory

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


@pytest.fixture(scope="module")
def bundle():
    g = torch.Generator().manual_seed(60)
    key = jax.random.PRNGKey(0)  # traced for shapes only
    jcfg = JV.VToonifyConfig(**TINY)
    jdcfg = JV.CondDiscriminatorConfig(**DCFG)
    jpcfg = JP.PSPEncoderConfig(n_styles=jcfg.n_latent)
    cfg = V.VToonifyConfig(**TINY)
    dcfg = V.CondDiscriminatorConfig(**DCFG)
    pcfg = P.PSPEncoderConfig(n_styles=cfg.n_latent)
    inits = dict(
        vt=(V.init_vtoonify(cfg, g), lambda: JV.init_vtoonify(key, jcfg)),
        parsing=(B.init_bisenet(generator=g), lambda: JB.init_bisenet(key)),
        d=(V.init_cond_discriminator(dcfg, g),
           lambda: JV.init_cond_discriminator(key, jdcfg)),
        psp=(P.init_psp_encoder(pcfg, g), lambda: JP.init_psp_encoder(key, jpcfg)),
        lpips=(LP.init_lpips(g), lambda: JLP.init_lpips(key)))
    jax_side = {k: _jax_tree(m, jax.eval_shape(f)) for k, (m, f) in inits.items()}
    rng = np.random.RandomState(3)
    gen = jax_side["vt"]["generator"]["generator"]
    for blk in [gen["conv1"], *gen["convs"]]:
        blk["noise"]["weight"] = np.float32(rng.uniform(0.05, 0.2))
        blk["act_bias"] = (rng.randn(*blk["act_bias"].shape) * 0.3).astype(np.float32)
    directions = (rng.randn(N_DIR, jcfg.n_latent, 512) * 0.1).astype(np.float32)
    styles = (rng.randn(N_STYLES, jcfg.n_latent, 512) * 0.3).astype(np.float32)
    wc_prev = rng.randn(BATCH, jcfg.n_latent, 512).astype(np.float32)

    port = {k: load_jax_params(m, jax_side[k]) for k, (m, _) in inits.items()}
    jax_side.update(cfg=jcfg, dcfg=jdcfg, pcfg=jpcfg)
    return dict(jax=jax_side, port=port, cfg=cfg, dcfg=dcfg, pcfg=pcfg,
                directions=directions, styles=styles, wc_prev=wc_prev)


def _draw_arrays(key, gen, gcfg, tcfg, out_size):
    """The draws JAX's train_d_step makes from `key`: the same sub-key
    splits, through JAX's public functions (traceable)."""
    k_synth, k_crop = jax.random.split(key)
    ks = jax.random.split(k_synth, 5)
    k1, k2 = jax.random.split(ks[0])
    z = jax.random.normal(k1, (BATCH, gcfg.style_dim), jnp.float32)
    idx = jax.random.randint(k2, (BATCH,), 0, N_DIR)
    noise = [JG.make_noise(gen, gcfg, k, randomize=True, batch=BATCH)
             for k in ks[1:4]]
    affine = jnp.linalg.inv(JA.sample_affine(ks[4], tcfg.aug_p, BATCH,
                                             out_size, out_size))
    max_off = out_size - tcfg.crop_size
    off_w = jax.random.randint(k_crop, (), 0, max_off + 1)
    off_h = jax.random.randint(jax.random.fold_in(k_crop, 1), (), 0, max_off + 1)
    return z, idx, noise, affine, off_w, off_h


def _train_d_draws(arrays):
    """`_draw_arrays`' values as a port TrainDDraws."""
    z, idx, noise, affine, off_w, off_h = arrays
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    noise_xc, noise_xs, noise_jitter = ([_nchw(n) for n in ns] for ns in noise)
    return S.TrainDDraws(t(z), t(idx).long(), noise_xc, noise_xs, noise_jitter,
                         t(affine), int(off_w), int(off_h))


@pytest.fixture(scope="module")
def jax_step(bundle):
    """One jit: JAX's train_d_step from a state whose color-jitter carry is
    random, the synth_train_batch that step runs (same sub-key and
    operands) and the step's draws; color jitter on."""
    j = bundle["jax"]
    jt = JS.TrainDConfig(**TCFG)
    jcfg = j["cfg"]
    jstate = JS.init_train_d_state(j["vt"], j["d"], BATCH, jcfg, jt)._replace(
        wc_prev=jnp.asarray(bundle["wc_prev"]))
    _, jfrozen = JS.split_trainable(j["vt"], pretrain=False)

    def run(jstate, jfrozen, parsing, psp, lpips, directions, style, sel, d_s,
            tmp_ramp, fuse_t, jitter, key):
        data = JSY.synth_train_batch(
            jax.random.split(key)[0], {**jfrozen, **jstate.trainable}, jcfg,
            parsing, psp, j["pcfg"], None, directions, style, d_s,
            tuple(WEIGHTS), jstate.wc_prev, fuse_t, jitter, aug_p=jt.aug_p,
            aug_max_pad=jt.aug_max_pad)
        new_state, metrics = JS.train_d_step(
            jstate, jfrozen, parsing, psp, j["pcfg"], None, lpips, jcfg,
            j["dcfg"], jt, directions, style, sel, d_s, tuple(WEIGHTS),
            tmp_ramp, fuse_t, jitter, key)
        draws = _draw_arrays(key, jfrozen["generator"]["generator"],
                             jcfg.generator, jt, jcfg.out_size)
        return data, new_state, metrics, draws

    data, jstate2, jm, draws = _np(jax.jit(run)(
        jstate, jfrozen, j["parsing"], j["psp"], j["lpips"], bundle["directions"],
        bundle["styles"][SEL], jnp.asarray(SEL), jnp.asarray(D_S),
        jnp.asarray(TMP_RAMP), jnp.asarray(FUSE_T), jnp.asarray(True),
        jax.random.PRNGKey(12)))
    return dict(data=data, state=jstate2, metrics=jm, draws=_train_d_draws(draws))


def test_synth_train_batch_matches_jax(bundle, jax_step):
    """The frozen-teacher data (content and stylized generators with noise,
    pSp + zplus2wplus, the color-jitter branch, the augment, BiSeNet) from
    one key's draws. Float32; tolerances are float32 rounding through ~40
    layers of random-weight nets (measured max |diff| <= ~1e-4 of the
    values' range)."""
    p, ref = bundle["port"], jax_step["data"]
    tcfg = S.TrainDConfig(**TCFG)
    with torch.no_grad():
        got = SY.synth_train_batch(
            jax_step["draws"], p["vt"], bundle["cfg"], p["parsing"], p["psp"],
            bundle["pcfg"], None, torch.from_numpy(bundle["directions"]),
            torch.from_numpy(bundle["styles"][SEL]), D_S, WEIGHTS,
            torch.from_numpy(bundle["wc_prev"]), FUSE_T, True, aug_p=tcfg.aug_p,
            aug_max_pad=tcfg.aug_max_pad)
    for k in ("real_input", "real_input1024", "mask1024", "real_output", "xl", "wc"):
        want = np.asarray(ref[k])
        have = got[k].numpy()
        if have.ndim == 4:
            have = np.moveaxis(have, 1, -1)
        assert have.shape == want.shape, k
        scale = np.abs(want).max()
        np.testing.assert_allclose(have, want, rtol=0, atol=2e-4 * scale, err_msg=k)
    assert np.asarray(ref["real_output"]).std() > 0.05  # not a blind compare


def _updates_agree(name, new, old, want_new, grad, lr=LR):
    """Adam's first step moves each element by lr * g / (|g| + eps), eps =
    1e-8: about +-lr, but where |g| nears eps a small relative difference
    of the two frameworks' float32 gradients moves it, and where |g| is at
    their noise floor its sign may differ. So: everywhere the updates stay
    within 2 lr of each other; on the mask |g| > 1e-3 * max|g| of its tensor
    and |g| > 100 eps (over all tensors it must hold a quarter of the
    elements, 15.8M of 38.1M here, else the comparison says nothing) they
    agree to 0.02 lr, and to 1e-3 lr in all but 1% of the elements (a few
    near-cancelling sums). A wrong gradient flips signs:
    2 lr, on many elements."""
    d_have, d_want = new - old, want_new - old
    assert np.abs(d_have - d_want).max() <= 2 * lr + 1e-7, name
    g = np.abs(grad)
    mask = (g > 1e-3 * g.max()) & (g > 100 * S.ADAM_EPS)
    err = np.abs(d_have - d_want)[mask]
    if err.size:
        assert err.max() <= 0.02 * lr, (name, err.max())
        assert (err > 1e-3 * lr).mean() <= 1e-2, (name, (err > 1e-3 * lr).mean())
    return mask.sum(), mask.size


def test_train_d_step_matches_jax(bundle, jax_step):
    """One whole stage-2 step at the --tiny configuration, float32, batch 2,
    color jitter on: the six metrics (rtol 2e-3: float32 sums ordered
    differently through D, LPIPS and three student forwards), the updated
    trainables and D params (see `_updates_agree`) and the EMA (its step
    moves by (1 - decay) of the update: atol 1e-6)."""
    p = bundle["port"]
    jstate2, jm = jax_step["state"], jax_step["metrics"]
    tt = S.TrainDConfig(**TCFG)
    vt, d = copy.deepcopy(p["vt"]), copy.deepcopy(p["d"])  # the step mutates them
    old_tr = {k: v.clone() for k, v in torch.nn.ModuleDict(
        dict(S.split_trainable(vt)[0])).state_dict().items()}
    old_d = {k: v.clone() for k, v in d.state_dict().items()}
    state = S.init_train_d_state(vt, d, BATCH, bundle["cfg"], tt, device="cpu")
    state.wc_prev = torch.from_numpy(bundle["wc_prev"])
    _, frozen = S.split_trainable(vt)
    m = S.train_d_step(
        state, frozen, p["parsing"], p["psp"], bundle["pcfg"], None, p["lpips"],
        bundle["cfg"], bundle["dcfg"], tt, torch.from_numpy(bundle["directions"]),
        torch.from_numpy(bundle["styles"][SEL]), torch.from_numpy(SEL), D_S,
        WEIGHTS, TMP_RAMP, FUSE_T, True, draws=jax_step["draws"])

    assert state.step == 1 and set(m) == {"g", "gr", "gf", "tp", "msk", "d"}
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-3,
                                   atol=1e-9, err_msg=k)
    assert float(jm["tp"]) > 0 and float(jm["msk"]) >= 0

    def grads(opt, params):
        return {id(q): opt.state[q]["exp_avg"].numpy() / (1 - S.ADAM_BETA1)
                for q in params}

    covered = total = 0
    for which, module, old, jtree, opt in (
            ("trainable", state.trainable, old_tr, jstate2.trainable, state.g_opt),
            ("d", state.d, old_d, jstate2.d_params, state.d_opt)):
        want = jax_state_dict(_np(jtree))
        gmap = grads(opt, list(module.parameters()))
        named = dict(module.named_parameters())
        assert set(named) == set(want), which
        for k, q in named.items():
            c, n = _updates_agree(f"{which}.{k}", q.detach().numpy(),
                                  old[k].numpy(), want[k].numpy(), gmap[id(q)])
            covered, total = covered + c, total + n
    assert covered > 0.25 * total, (covered, total)

    want_ema = jax_state_dict(_np(jstate2.ema))
    for k, q in state.ema.state_dict().items():
        np.testing.assert_allclose(q.numpy(), want_ema[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=f"ema.{k}")
    np.testing.assert_allclose(state.wc_prev.numpy(), np.asarray(jstate2.wc_prev),
                               rtol=0, atol=1e-4 * np.abs(jstate2.wc_prev).max())
