"""The VToonify-D stage-2 training step (port of vtoonify_tpu/train/steps.py:
`_mp_cast` / `_synth_cast`, `TrainDConfig`, `split_trainable`,
`init_train_d_state`, `train_d_step`).

One call is one iteration of reference train_vtoonify_d.py:212-342: frozen
teacher data synthesis -> D step on the stop-gradient fake -> G step (adv +
rec + LPIPS + mask + temporal crop consistency) -> EMA. The state is mutated
in place: trainable modules and the discriminator hold float32 master
weights updated by two `torch.optim.Adam(lr, betas=(0.9, 0.99), eps=1e-8)`
(optax.adam's defaults as the JAX step uses them).

Mixed precision (`compute_dtype="bfloat16"`, the trainer's --bf16): every
network forward runs on parameters cast per step with
`torch.func.functional_call`, so gradients flow through the casts back to
the float32 leaves; targets and loss arithmetic stay float32. Data synthesis
follows `synth_dtype` (None: the compute dtype). No `torch.autocast`: its
per-op dtype choices differ from the JAX casts and from the kernels'
same-dtype operand rule. `remat` maps to `torch.utils.checkpoint(...,
use_reentrant=False)` around the G forwards and/or LPIPS.

Randomness: every draw of a step is gathered in a draws object
(`PretrainDraws`, `TrainDDraws`, `TrainTDraws`; the `sample_*_draws`
functions make one from a `torch.Generator`), so a step can be replayed with
given draws (torch's streams cannot match `jax.random`).

Data parallelism (one process per card, `parallel/multihost.py`): under a
process group each rank holds its contiguous share of the global batch
(the D steps' `style` rows; the T steps' `batch` is the global batch). The `sample_*_draws` functions draw the global batch's
values from the same seed on every rank and keep the rank's rows; the
gradients are averaged over the ranks (`collectives.gather_grad`) before
every optimizer step; the states start from rank 0's parameters; the
metrics are the ranks' mean; the discriminator's minibatch stddev groups
the global batch (models/generator.py), and the losses are held to the
global batch's (train/losses.py; LPIPS's sum below). No
DistributedDataParallel: the steps run `functional_call` on explicit
parameter lists with two optimizers and several `autograd.grad` calls.

Tensor parallelism (the trainers' --tp k): the modules may hold their wide
weights split over a row of k devices (`parallel.tensor.shard_module`,
before the state is built). Each shard is a parameter of its own: the
casts, Adam, the EMA and the gradient all-reduce run per shard, and a
module that is split is not moved (`shard_module` placed it; its other
tensors are on the row's first device, the step's device).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from vtoonify_tpu_torch import resolve_device
from vtoonify_tpu_torch.models import generator as G
from vtoonify_tpu_torch.models.lpips import lpips_apply
from vtoonify_tpu_torch.models.vtoonify import (
    CondDiscriminatorConfig,
    VToonifyConfig,
    cond_discriminator_apply,
    vtoonify_apply,
)
from vtoonify_tpu_torch.nn.layers import set_trainable
from vtoonify_tpu_torch.ops.interp import avg_pool
from vtoonify_tpu_torch.parallel import collectives as C
from vtoonify_tpu_torch.parallel.tensor import is_sharded
from vtoonify_tpu_torch.train import synth
from vtoonify_tpu_torch.train.augment import sample_affine
from vtoonify_tpu_torch.train.ema import ema_update
from vtoonify_tpu_torch.train.losses import (
    d_logistic_loss,
    g_nonsaturating_loss,
    mask_loss,
    mse_loss,
)

ADAM_BETA1, ADAM_BETA2 = 0.9, 0.99  # train_vtoonify_d.py:448-451
ADAM_EPS = 1e-8                      # optax.adam's default


@dataclass(frozen=True)
class TrainDConfig:
    adv_loss: float = 0.01
    grec_loss: float = 0.1
    perc_loss: float = 0.01
    tmp_loss: float = 1.0
    msk_loss: float = 0.0005
    lr: float = 1e-4
    crop_size: int = 896        # temporal-loss crop (train_vtoonify_d.py:326)
    lpips_size: int = 512       # perceptual-loss resolution (:311-312)
    aug_p: float = 0.2
    aug_max_pad: Optional[int] = None
    remat: bool = True          # checkpoint the G forwards and/or LPIPS
    remat_scope: str = "all"    # "all" | "g" | "lpips"
    compute_dtype: Optional[str] = None  # e.g. "bfloat16" (--bf16)
    synth_dtype: Optional[str] = None    # None: follow compute_dtype;
    # "float32" forces float32 synthesis


def _dtype(name) -> Optional[torch.dtype]:
    """None for float32 (no cast), else the torch dtype."""
    if name is None:
        return None
    dt = getattr(torch, str(name))
    return None if dt == torch.float32 else dt


def _mp_cast(compute_dtype):
    """The dtype network forwards run in (None: float32, no cast)."""
    return _dtype(compute_dtype)


def _synth_cast(synth_dtype, compute_dtype):
    """The teacher synthesis dtype: `synth_dtype`, falling back to
    `compute_dtype`; "float32" forces float32."""
    return _dtype(compute_dtype if synth_dtype is None else synth_dtype)


class _Bound(nn.Module):
    """Holds modules by name so one functional_call can swap cast
    parameters into all of them; forward runs fn(self, ...)."""

    def __init__(self, **modules):
        super().__init__()
        for name, m in modules.items():
            self.add_module(name, m)

    def forward(self, fn, *args):
        return fn(self, *args)


def _cast_state(bound: nn.Module, dtype, grad: bool) -> dict:
    """The parameters and buffers of `bound`, float ones cast to `dtype`
    (None: kept), linked to the float32 leaves for autograd when `grad`,
    detached otherwise."""
    out = {}
    for k, v in [*bound.named_parameters(), *bound.named_buffers()]:
        v = v if grad else v.detach()
        out[k] = v.to(dtype) if dtype is not None and v.is_floating_point() else v
    return out


def _call(bound: _Bound, cast: Optional[dict], fn, *args):
    """fn(bound, *args), with `cast` swapped in for its tensors if given."""
    if cast is None:
        return bound(fn, *args)
    return functional_call(bound, cast, (fn, *args), strict=False)


def _cast(x, dtype):
    """A tensor operand in the working dtype (Python scalars stay as they
    are: torch does not promote a tensor for them)."""
    if dtype is None or not torch.is_tensor(x) or not x.is_floating_point():
        return x
    return x.to(dtype)


def _up(x):
    return x.float() if torch.is_tensor(x) else x


# ---------------------------------------------------------------------------
# state, draws


TRAINABLE = ("encoder", "fusion_out", "fusion_skip")


def split_trainable(vt, pretrain: bool = False):
    """(trainable, frozen): dicts of vt's child modules by name."""
    keys = ("encoder",) if pretrain else TRAINABLE
    trainable = {k: getattr(vt, k) for k in keys}
    frozen = {k: m for k, m in vt.named_children() if k not in keys}
    return trainable, frozen


def _adam(params, lr):
    return torch.optim.Adam(params, lr=lr, betas=(ADAM_BETA1, ADAM_BETA2),
                            eps=ADAM_EPS)


def _place(module, device):
    """`module` on `device`, unless it is split over a 'tp' row (placed by
    `shard_module`, with everything else on the row's first device)."""
    return module if is_sharded(module) else module.to(device)


def _trainable(vt, pretrain: bool, device):
    """Moves `vt` to `device` (None: the card; raises without one) and marks
    its trainable children; returns them as a ModuleDict, their EMA copy
    (frozen) and the device."""
    device = resolve_device(device)
    _place(vt, device)
    trainable = nn.ModuleDict(split_trainable(vt, pretrain)[0])
    set_trainable(trainable)
    return trainable, set_trainable(copy.deepcopy(trainable), False), device


def _device_of(state) -> torch.device:
    return next(state.trainable.parameters()).device


@dataclass
class PretrainState:
    trainable: nn.ModuleDict   # the encoder (float32 masters)
    ema: nn.ModuleDict         # its EMA copy (frozen)
    g_opt: torch.optim.Adam
    step: int = 0


@dataclass
class TrainDState:
    trainable: nn.ModuleDict   # encoder, fusion_out, fusion_skip (f32 masters)
    ema: nn.ModuleDict         # their EMA copies (frozen)
    d: nn.Module               # the conditional discriminator (f32 masters)
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    wc_prev: torch.Tensor      # previous iteration's w' (color-jitter carry)
    step: int = 0


@dataclass
class TrainTState:
    trainable: nn.ModuleDict   # encoder, fusion_out, fusion_skip (f32 masters)
    ema: nn.ModuleDict
    d: nn.Module               # the unconditional discriminator (f32 masters)
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


class _Draws:
    def _map(self, fn):
        """fn on every tensor field and on every tensor of a list field;
        other fields (per-step scalars) as they are."""
        def one(v):
            return [fn(t) for t in v] if isinstance(v, list) else (
                fn(v) if torch.is_tensor(v) else v)
        return type(self)(**{k: one(v) for k, v in vars(self).items()})

    def to(self, device):
        return self._map(lambda t: t.to(device))

    def local(self):
        """This rank's rows of every field with a batch axis (every tensor's
        leading axis); the whole draws in one process."""
        return self._map(C.local_rows) if C.spans_ranks() else self


@dataclass
class PretrainDraws(_Draws):
    """Every random value of one stage-1 step (D or T)."""
    z: torch.Tensor            # (B, style_dim) content latents
    dir_idx: torch.Tensor      # (B,) editing-direction indices
    noise_content: list        # num_layers (B, 1, s, s) noise images, content
    noise_feat: list           # ... the teacher's feature pass


PretrainTDraws = PretrainDraws  # T's stage 1 draws the same values


@dataclass
class TrainDDraws(_Draws):
    """Every random value of one VToonify-D stage-2 step."""
    z: torch.Tensor            # (B, style_dim) content latents
    dir_idx: torch.Tensor      # (B,) editing-direction indices
    noise_xc: list             # num_layers (B, 1, s, s) noise images, content
    noise_xs: list             # ... stylized target (DualStyleGAN)
    noise_jitter: list         # ... color-jittered content
    affine: torch.Tensor       # (B, 3, 3) inverse augment affine (G)
    off_w: int                 # temporal-crop offsets
    off_h: int


@dataclass
class TrainTDraws(_Draws):
    """Every random value of one VToonify-T stage-2 step."""
    z: torch.Tensor
    dir_idx: torch.Tensor
    noise_xc: list             # content (base G0)
    noise_xs: list             # stylized target (blended G1)
    affine: torch.Tensor
    off_w: int
    off_h: int


def _draw_noise(generator, cfg: VToonifyConfig, batch, device):
    return [n.to(device) for n in G.make_noise(None, cfg.generator, generator,
                                                batch=batch)]


def _draw_content(generator, batch, cfg: VToonifyConfig, n_directions, device):
    gdev = generator.device
    z = torch.randn((batch, cfg.generator.style_dim), generator=generator,
                    device=gdev)
    dir_idx = torch.randint(0, n_directions, (batch,), generator=generator,
                            device=gdev)
    return z.to(device), dir_idx.to(device)


def _draw_augment(generator, batch, cfg: VToonifyConfig, tcfg, device):
    """(inverse augment affine, off_w, off_h)."""
    affine = torch.linalg.inv(sample_affine(generator, tcfg.aug_p, batch,
                                            cfg.out_size, cfg.out_size))
    off = torch.randint(0, cfg.out_size - tcfg.crop_size + 1, (2,),
                        generator=generator, device=generator.device)
    return affine.to(device), int(off[0]), int(off[1])


def sample_pretrain_draws(generator: torch.Generator, batch: int,
                          cfg: VToonifyConfig, n_directions: int,
                          device=None) -> PretrainDraws:
    """One stage-1 step's draws from `generator` (made on its device,
    returned on `device`) for a global batch of `batch`: this rank's rows
    under a process group."""
    z, dir_idx = _draw_content(generator, batch, cfg, n_directions, device)
    return PretrainDraws(z, dir_idx, _draw_noise(generator, cfg, batch, device),
                         _draw_noise(generator, cfg, batch, device)).local()


def sample_train_d_draws(generator: torch.Generator, batch: int,
                         cfg: VToonifyConfig, tcfg: TrainDConfig,
                         n_directions: int, device=None) -> TrainDDraws:
    """One stage-2 step's draws from `generator` (made on its device,
    returned on `device`) for a global batch of `batch`: this rank's rows
    under a process group."""
    z, dir_idx = _draw_content(generator, batch, cfg, n_directions, device)
    noise = [_draw_noise(generator, cfg, batch, device) for _ in range(3)]
    return TrainDDraws(z, dir_idx, *noise,
                       *_draw_augment(generator, batch, cfg, tcfg, device)).local()


def sample_train_t_draws(generator: torch.Generator, batch: int,
                         cfg: VToonifyConfig, tcfg: TrainDConfig,
                         n_directions: int, device=None) -> TrainTDraws:
    """One T stage-2 step's draws from `generator` for a global batch of
    `batch` (this rank's rows under a process group)."""
    z, dir_idx = _draw_content(generator, batch, cfg, n_directions, device)
    noise = [_draw_noise(generator, cfg, batch, device) for _ in range(2)]
    return TrainTDraws(z, dir_idx, *noise,
                       *_draw_augment(generator, batch, cfg, tcfg, device)).local()


def init_pretrain_state(vt, lr: float = 1e-4, device=None) -> PretrainState:
    """Moves `vt` to `device` (None: the card; raises without one), marks
    its encoder trainable and builds the encoder's EMA copy and Adam."""
    trainable, ema, _ = _trainable(vt, True, device)
    C.broadcast_modules(trainable, ema)
    return PretrainState(trainable=trainable, ema=ema,
                         g_opt=_adam(trainable.parameters(), lr))


def init_train_d_state(vt, d, batch: int, cfg: VToonifyConfig,
                       tcfg: TrainDConfig, device=None) -> TrainDState:
    """Moves `vt` and `d` to `device` (None: the card; raises without one),
    marks the student's encoder / fusion_out / fusion_skip and all of `d`
    trainable, and builds the EMA copies, the two Adams and the carry
    (`batch`: this rank's rows). Under a process group every rank starts
    from rank 0's parameters."""
    trainable, ema, dev = _trainable(vt, False, device)
    set_trainable(_place(d, dev))
    C.broadcast_modules(trainable, ema, d)
    return TrainDState(
        trainable=trainable, ema=ema, d=d,
        g_opt=_adam(trainable.parameters(), tcfg.lr),
        d_opt=_adam(d.parameters(), tcfg.lr),
        wc_prev=torch.zeros((batch, cfg.n_latent, cfg.style_channels),
                            device=dev),
        step=0)


def init_train_t_state(vt, d, tcfg: TrainDConfig, device=None) -> TrainTState:
    """`init_train_d_state` for VToonify-T: no color-jitter carry."""
    trainable, ema, dev = _trainable(vt, False, device)
    set_trainable(_place(d, dev))
    C.broadcast_modules(trainable, ema, d)
    return TrainTState(trainable=trainable, ema=ema, d=d,
                       g_opt=_adam(trainable.parameters(), tcfg.lr),
                       d_opt=_adam(d.parameters(), tcfg.lr))


def _to(module, device):
    """Move a frozen module to the step's device (no-op when it is there,
    or when it is split over a 'tp' row)."""
    if module is not None:
        t = next(module.parameters(), None)
        if t is not None and t.device != device:
            _place(module, device)
    return module


def _apply_step(opt, params, grads):
    """One optimizer step on `grads`, averaged over the ranks first under a
    process group."""
    for p, g in zip(params, C.gather_grad(grads)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _synthesize(teacher: _Bound, sdt, fn) -> dict:
    """fn(teacher) without gradients, on the teacher's parameters cast to
    `sdt` (None: float32); the outputs come back in float32."""
    with torch.no_grad():
        cast = None if sdt is None else _cast_state(teacher, sdt, grad=False)
        out = _call(teacher, cast, fn)
    return {k: v.float() for k, v in out.items()}


# ---------------------------------------------------------------------------
# stage 1: encoder distillation


def _feature_step(state, frozen: dict, cfg: VToonifyConfig, data: dict, style,
                  d_s, compute_dtype) -> dict:
    """The stage-1 update shared by D and T: the student's encoder
    features (feat, skip) regressed onto the teacher's (MSE), Adam on the
    encoder, EMA."""
    cdt = _mp_cast(compute_dtype)
    student = _Bound(**frozen, **dict(state.trainable.items()))
    cast = None
    if cdt is not None:
        cast = {**_cast_state(_Bound(**frozen), cdt, grad=False),
                **_cast_state(_Bound(**state.trainable), cdt, grad=True)}
    inp_c, style_c, d_s_c = (_cast(t, cdt) for t in (data["real_input"], style, d_s))
    feat, skip = _call(student, cast, lambda m: vtoonify_apply(
        m, cfg, inp_c, style_c, d_s_c, return_feat=True))
    loss = (mse_loss(_up(feat), data["real_feat"])
            + mse_loss(_up(skip), data["real_skip"]))
    params = list(state.trainable.parameters())
    _apply_step(state.g_opt, params, torch.autograd.grad(loss, params))
    ema_update(state.ema, state.trainable)
    state.step += 1
    return C.reduce_loss_dict({"emse": loss.detach()})


def pretrain_step(state: PretrainState, frozen: dict, parsing,
                  cfg: VToonifyConfig, directions, style, d_s,
                  compute_dtype: Optional[str] = None,
                  synth_dtype: Optional[str] = None,
                  draws: Optional[PretrainDraws] = None,
                  generator: Optional[torch.Generator] = None):
    """One VToonify-D stage-1 iteration (train_vtoonify_d.py:99-151).
    `frozen` is split_trainable(vt, pretrain=True)'s second dict, `style`
    (B, n_latent, 512) the batch's w'' codes, `d_s` the degree. Draws come
    from `draws`, else from `generator`. Mutates `state`; returns {emse}."""
    dev = _device_of(state)
    for m in (*frozen.values(), parsing):
        _to(m, dev)
    directions, style = directions.to(dev), style.to(dev)
    if draws is None:
        draws = sample_pretrain_draws(generator, style.shape[0] * C.get_world_size(),
                                      cfg, directions.shape[0], device=dev)
    sdt = _synth_cast(synth_dtype, compute_dtype)
    teacher = _Bound(vt=_Bound(**frozen, **dict(state.trainable.items())),
                     parsing=parsing)
    data = _synthesize(teacher, sdt, lambda m: synth.synth_pretrain_batch(
        draws, m.vt, cfg, m.parsing, _cast(directions, sdt), _cast(style, sdt),
        _cast(d_s, sdt)))
    return _feature_step(state, frozen, cfg, data, style, d_s, compute_dtype)


def pretrain_t_step(state: PretrainState, frozen: dict, base, parsing,
                    cfg: VToonifyConfig, directions, batch: int,
                    compute_dtype: Optional[str] = None,
                    synth_dtype: Optional[str] = None,
                    draws: Optional[PretrainDraws] = None,
                    generator: Optional[torch.Generator] = None):
    """One VToonify-T stage-1 iteration (train_vtoonify_t.py:99-135):
    `frozen` holds the blended G1 as `generator`, `base` is the un-blended
    StyleGAN G0 the content comes from."""
    dev = _device_of(state)
    for m in (*frozen.values(), base, parsing):
        _to(m, dev)
    directions = directions.to(dev)
    if draws is None:
        draws = sample_pretrain_draws(generator, batch, cfg,
                                      directions.shape[0], device=dev)
    sdt = _synth_cast(synth_dtype, compute_dtype)
    teacher = _Bound(vt=_Bound(**frozen, **dict(state.trainable.items())),
                     base=base, parsing=parsing)
    data = _synthesize(teacher, sdt, lambda m: synth.synth_pretrain_t_batch(
        draws, m.base, cfg.generator, m.vt, cfg, m.parsing,
        _cast(directions, sdt)))
    return _feature_step(state, frozen, cfg, data, None, None, compute_dtype)


# ---------------------------------------------------------------------------
# stage 2: the GAN step


def _gan_step(state, frozen: dict, lpips, cfg: VToonifyConfig,
              dcfg: CondDiscriminatorConfig, tcfg: TrainDConfig, batch_data: dict,
              draws, d_s, d_cond: tuple, tmp_ramp) -> dict:
    """The D step, then the G step, then the EMA of one stage-2 iteration,
    shared by D and T. `d_s` is the student's degree (None for T), `d_cond`
    the conditional D's (degree_label, style_ind) (empty for T's
    unconditional D). The D backbone adds the mask loss."""
    with_mask = cfg.backbone == "dualstylegan"
    trainable = dict(state.trainable.items())
    tr_params = list(state.trainable.parameters())
    d_params = list(state.d.parameters())
    xl = batch_data["xl"]
    pool_to_256 = max(1, cfg.out_size // dcfg.size)

    cdt = _mp_cast(tcfg.compute_dtype)
    student = _Bound(**frozen, **trainable)
    inp_c = _cast(batch_data["real_input"], cdt)
    xl_c = _cast(xl, cdt)
    d_s_c = _cast(d_s, cdt)
    real_output = batch_data["real_output"]

    def vt_fwd(m, inp, return_mask=False):
        return vtoonify_apply(m, cfg, inp, xl_c, d_s_c, return_mask=return_mask)

    # ---- D step (G frozen) ---------------------------------------------------
    with torch.no_grad():
        cast = None if cdt is None else _cast_state(student, cdt, grad=False)
        fake_output = _up(_call(student, cast, vt_fwd, inp_c))

    disc = _Bound(d=state.d)

    def d_pred(m, img):
        return _up(cond_discriminator_apply(
            m.d, dcfg, _cast(avg_pool(img, pool_to_256), cdt),
            *(_cast(c, cdt) for c in d_cond)))

    cast = None if cdt is None else _cast_state(disc, cdt, grad=True)
    d_loss = _call(disc, cast, lambda m: d_logistic_loss(
        d_pred(m, real_output), d_pred(m, fake_output)) * tcfg.adv_loss)
    _apply_step(state.d_opt, d_params, torch.autograd.grad(d_loss, d_params))

    # ---- G step (D frozen, updated) -----------------------------------------
    cs = tcfg.crop_size
    off_w, off_h = draws.off_w, draws.off_h
    pool_to_512 = max(1, cfg.out_size // tcfg.lpips_size)
    remat_g = tcfg.remat and tcfg.remat_scope in ("all", "g")
    remat_lpips = tcfg.remat and tcfg.remat_scope in ("all", "lpips")

    g_cast = lp_cast = None
    if cdt is not None:
        g_cast = {**_cast_state(_Bound(**frozen), cdt, grad=False),
                  **_cast_state(_Bound(**trainable), cdt, grad=True)}
        lp_cast = _cast_state(_Bound(lp=lpips), cdt, grad=False)
    d_frozen = _cast_state(disc, cdt, grad=False)  # no D weight gradients
    lp_bound = _Bound(lp=lpips)

    def run_vt(inp, return_mask=False):
        fn = lambda i: _call(student, g_cast, vt_fwd, i, return_mask)  # noqa: E731
        return checkpoint(fn, inp, use_reentrant=False) if remat_g else fn(inp)

    def lpips_fwd(m, x0, x1):
        return lpips_apply(m.lp, x0, x1)

    def run_lpips(x0, x1):
        fn = lambda a, c: _call(lp_bound, lp_cast, lpips_fwd, a, c)  # noqa: E731
        return checkpoint(fn, x0, x1, use_reentrant=False) if remat_lpips else fn(x0, x1)

    if with_mask:
        fake, m_Es = run_vt(inp_c, True)
        m_Es = [_up(m) for m in m_Es]
    else:
        fake = run_vt(inp_c)
    fake = _up(fake)
    fake_pred = _call(disc, d_frozen, d_pred, fake)
    g_adv = g_nonsaturating_loss(fake_pred) * tcfg.adv_loss
    g_rec = mse_loss(fake, real_output) * tcfg.grec_loss
    # a sum over the batch: over the global batch, each rank's share counts
    # world-size times once the gradients are averaged
    g_feat = _up(run_lpips(_cast(avg_pool(fake, pool_to_512), cdt),
                           _cast(avg_pool(real_output, pool_to_512), cdt))
                 ).sum() * (tcfg.perc_loss * C.get_world_size())
    if with_mask:
        g_msk = mask_loss(m_Es, d_s, tcfg.msk_loss)

    # temporal crop consistency (train_vtoonify_d.py:326-334); the reference
    # indexes H with `w` and W with `h` (square crop: only the pairing
    # matters), kept as (off_w -> H, off_h -> W)
    full = torch.cat([batch_data["real_input1024"],
                      batch_data["mask1024"] * synth.PARSING_WEIGHT], dim=1)
    crop_input = synth.down(synth.down(
        full[:, :, off_w:off_w + cs, off_h:off_h + cs].contiguous()))
    crop_fake = fake[:, :, off_w:off_w + cs, off_h:off_h + cs]
    fake_crop = _up(run_vt(_cast(crop_input, cdt)))
    g_tmp = (fake_crop - crop_fake).square().mean() * tmp_ramp * tcfg.tmp_loss
    metrics = {"g": g_adv, "gr": g_rec, "gf": g_feat, "tp": g_tmp}
    total = g_adv + g_rec + g_feat + g_tmp
    if with_mask:
        metrics["msk"] = g_msk
        total = total + g_msk
    _apply_step(state.g_opt, tr_params, torch.autograd.grad(total, tr_params))
    ema_update(state.ema, state.trainable)
    state.step += 1
    metrics["d"] = d_loss
    dev = real_output.device
    return C.reduce_loss_dict(
        {k: torch.as_tensor(v, dtype=torch.float32, device=dev).detach()
         for k, v in metrics.items()})


def train_d_step(state: TrainDState, frozen: dict, parsing, psp, psp_cfg,
                 latent_avg, lpips, cfg: VToonifyConfig,
                 dcfg: CondDiscriminatorConfig, tcfg: TrainDConfig,
                 directions, style, style_ind, d_s, weights, tmp_ramp,
                 color_fuse_t, use_color_jitter: bool, xl_override=None,
                 draws: Optional[TrainDDraws] = None,
                 generator: Optional[torch.Generator] = None):
    """One full VToonify-D iteration (train_vtoonify_d.py:212-342). `frozen`
    is split_trainable's second dict ({'generator', 'res'}); `style`
    (B, n_latent, 512) the selected exstyles, `style_ind` (B,) their
    indices, `weights` the n_latent interp weights, `tmp_ramp` and
    `color_fuse_t` the schedule values, `use_color_jitter` a Python bool.
    Draws come from `draws`, else from `generator`. Mutates `state`;
    returns the metrics {g, gr, gf, tp, msk, d} as float32 0-d tensors."""
    dev = _device_of(state)
    for m in (*frozen.values(), parsing, psp, lpips):
        _to(m, dev)
    directions, style, style_ind = (t.to(dev) for t in (directions, style, style_ind))
    latent_avg = None if latent_avg is None else latent_avg.to(dev)
    b = style.shape[0]
    if draws is None:
        draws = sample_train_d_draws(generator, b * C.get_world_size(), cfg, tcfg,
                                     directions.shape[0], device=dev)

    # ---- data synthesis: the frozen teachers, no gradient -------------------
    sdt = _synth_cast(tcfg.synth_dtype, tcfg.compute_dtype)
    teacher = _Bound(vt=_Bound(**frozen, **dict(state.trainable.items())),
                     parsing=parsing, psp=psp)
    batch_data = _synthesize(teacher, sdt, lambda m: synth.synth_train_batch(
        draws, m.vt, cfg, m.parsing, m.psp, psp_cfg, _cast(latent_avg, sdt),
        _cast(directions, sdt), _cast(style, sdt), _cast(d_s, sdt),
        [_cast(w, sdt) for w in weights], _cast(state.wc_prev, sdt),
        _cast(color_fuse_t, sdt), use_color_jitter,
        xl_override=_cast(xl_override, sdt), aug_p=tcfg.aug_p,
        aug_max_pad=tcfg.aug_max_pad))
    degree_label = torch.zeros((b, 1), device=dev) + d_s
    metrics = _gan_step(state, frozen, lpips, cfg, dcfg, tcfg, batch_data, draws,
                        d_s, (degree_label, style_ind), tmp_ramp)
    state.wc_prev = batch_data["wc"]
    return metrics


def train_t_step(state: TrainTState, frozen: dict, base, parsing, psp, psp_cfg,
                 latent_avg, lpips, cfg: VToonifyConfig,
                 dcfg: CondDiscriminatorConfig, tcfg: TrainDConfig, directions,
                 batch: int, tmp_ramp, draws: Optional[TrainTDraws] = None,
                 generator: Optional[torch.Generator] = None):
    """One full VToonify-T iteration (train_vtoonify_t.py:192-276): no style
    degree, an unconditional D (`dcfg.use_condition` False), no mask loss,
    no color-jitter carry. `frozen` holds the blended G1 as `generator`,
    `base` the un-blended G0, `batch` the global batch. Mutates `state`;
    returns {g, gr, gf, tp, d}."""
    dev = _device_of(state)
    for m in (*frozen.values(), base, parsing, psp, lpips):
        _to(m, dev)
    directions = directions.to(dev)
    latent_avg = None if latent_avg is None else latent_avg.to(dev)
    if draws is None:
        draws = sample_train_t_draws(generator, batch, cfg, tcfg,
                                     directions.shape[0], device=dev)
    sdt = _synth_cast(tcfg.synth_dtype, tcfg.compute_dtype)
    teacher = _Bound(vt=_Bound(**frozen, **dict(state.trainable.items())),
                     base=base, parsing=parsing, psp=psp)
    batch_data = _synthesize(teacher, sdt, lambda m: synth.synth_train_t_batch(
        draws, m.base, cfg.generator, m.vt, cfg, m.parsing, m.psp, psp_cfg,
        _cast(latent_avg, sdt), _cast(directions, sdt), aug_p=tcfg.aug_p,
        aug_max_pad=tcfg.aug_max_pad))
    return _gan_step(state, frozen, lpips, cfg, dcfg, tcfg, batch_data, draws,
                     None, (), tmp_ramp)


# ---------------------------------------------------------------------------
# the trainers' fusion init


@torch.no_grad()
def fusion_identity_init(vt) -> None:
    """The stage-2 start (train_vtoonify_d.py:433-438, train_vtoonify_t.py:
    362-368): every fusion conv's weight scaled by 0.01, plus the identity
    at the centre tap from input channel i < c to output channel i (the
    f_G / skip operand, the first c input channels). D's fusion_out holds
    its conv in `.conv`; T's are plain convs."""
    for m in (*vt.fusion_out, *vt.fusion_skip):
        w = (m.conv if hasattr(m, "conv") else m).weight  # (O, I, 3, 3)
        c = w.shape[0]
        w.mul_(0.01)
        w[:, :c, 1, 1] += torch.eye(c, dtype=w.dtype, device=w.device)
