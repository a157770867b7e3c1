"""The vtoonify family: VToonify-D or VToonify-T behind BiSeNet face parsing
(gpubench/configs/vtoonify-d.json, vtoonify-t.json; a configuration without
a "family" key is of this family).

From the seed, on the first card: the weights in the upstream checkpoint
layout (gpubench/weights.py), the frame pool and the per-video style code
(gpubench/inputs.py). The program, vtoonify_tpu_torch's `ToonifyPipeline`,
loads the weights through its own checkpoint loaders. Its outputs are
uint8 frames, held to the plain reference (gpubench/reference.py) by their
gaps in uint8 steps. The drivers that serve this family's traffic, "engine"
and "frame", take the inputs as `{"pool": (n, H, W, 3) uint8 numpy,
"s_w": style code}`.
"""

from __future__ import annotations

import io
import time

import numpy as np
import torch

from gpubench import inputs, reference, weights


def draw_weights(config, seed, device) -> dict:
    """VToonify's and BiSeNet's state dicts, upstream names, float32."""
    return {"vt": weights.make_state(weights.vtoonify_layout(config["vtoonify"]), seed, device,
                                     inputs.STREAM_VT),
            "bs": weights.make_state(weights.bisenet_layout(config["bisenet"]), seed, device,
                                     inputs.STREAM_BISENET)}


def _as_file(state: dict, key=None) -> io.BytesIO:
    """`state` as a checkpoint file in memory (under `key`, if given)."""
    obj = {k: v.detach().cpu() for k, v in state.items()}
    buf = io.BytesIO()
    torch.save(obj if key is None else {key: obj}, buf)
    buf.seek(0)
    return buf


def build_program(config, traffic, state, device, devices, phases):
    """The program's pipeline, its weights loaded by its own loaders from
    the upstream layout, as a released checkpoint would be; over a mesh of
    `devices` where the traffic has dp > 1."""
    t = time.perf_counter()
    from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
    from vtoonify_tpu_torch.utils.checkpoint import (load_reference_faceparsing,
                                                     load_reference_vtoonify)

    cfg = VToonifyConfig(**config["vtoonify"])
    files = _as_file(state["vt"], "g_ema"), _as_file(state["bs"])
    phases["program.files"], t = time.perf_counter() - t, time.perf_counter()
    vt, _ = load_reference_vtoonify(files[0], cfg)
    parsing = load_reference_faceparsing(files[1])
    phases["program.load"] = time.perf_counter() - t
    dtype = getattr(torch, config["dtype"])
    if traffic["dp"] > 1:
        from vtoonify_tpu_torch.parallel.mesh import make_mesh

        return ToonifyPipeline(vt, cfg, parsing, dtype=dtype, mesh=make_mesh(devices=devices))
    return ToonifyPipeline(vt, cfg, parsing, dtype=dtype, device=device)


def make_inputs(config, traffic, seed, device) -> dict:
    """The frame pool, on the host, and the style code, on `device`."""
    h, w = traffic["frame_hw"]
    return {"pool": inputs.frame_pool(seed, traffic["pool"], h, w, device).cpu().numpy(),
            "s_w": inputs.style_code(seed, config["vtoonify"], device)}


def frame_numbers(prog_u8: torch.Tensor, ref_u8: torch.Tensor) -> dict:
    """One frame's gaps to the reference, in uint8 steps (LSB): their mean
    and largest, the 99.9th percentile, the share of values off by more
    than 4 and 8 steps, and the mean as a share of the spread (standard
    deviation) of the reference frame's values."""
    gap = (prog_u8.to(torch.int16) - ref_u8.to(torch.int16)).abs()
    counts = torch.bincount(gap.flatten().to(torch.int64), minlength=256).double()
    n = counts.sum()
    cum = counts.cumsum(0)
    mean = (counts * torch.arange(256, dtype=torch.float64, device=counts.device)).sum() / n
    spread = ref_u8.double().std().clamp(min=1.0)
    return {"gap_pct": 100.0 * (mean / spread).item(), "mean_lsb": mean.item(),
            "max_lsb": float(torch.nonzero(counts).max().item()),
            "p999_lsb": float(torch.searchsorted(cum, 0.999 * n).item()),
            "over4_pct": 100.0 * (1.0 - cum[4] / n).item(),
            "over8_pct": 100.0 * (1.0 - cum[8] / n).item()}


def reference_numbers(config, traffic, seed, samples, device, precision="float32",
                      against=None) -> list:
    """Per sampled frame (pool index, program uint8 (H', W', 3)), the gap of
    the program's frame to the reference's, computed again from the seed on
    `device` in blocks of `check_block` frames. With `against` (a precision)
    the sample's frames are replaced by that precision's reference frames:
    the control."""
    vt_cfg = config["vtoonify"]
    state = draw_weights(config, seed, device)
    vt_sd, bs_sd = state["vt"], state["bs"]
    h, w = traffic["frame_hw"]
    pool = inputs.frame_pool(seed, traffic["pool"], h, w, device)
    s_w = inputs.style_code(seed, vt_cfg, device)
    block = traffic.get("check_block", 2)
    out = []
    for at in range(0, len(samples), block):
        part = samples[at:at + block]
        idx = torch.tensor([k for k, _ in part], device=device)
        y = reference.frame_image(vt_sd, bs_sd, vt_cfg, pool[idx], s_w,
                                  traffic["style_degree"], precision)
        ref_u8 = reference.quantize(y)
        del y
        if against is not None:
            got = reference.quantize(reference.frame_image(
                vt_sd, bs_sd, vt_cfg, pool[idx], s_w, traffic["style_degree"], against))
        else:
            got = torch.stack([torch.as_tensor(np.ascontiguousarray(f), device=device)
                               for _, f in part])
        for j in range(len(part)):
            if got[j].shape != ref_u8[j].shape:
                raise ValueError(f"frame shape {tuple(got[j].shape)}, reference "
                                 f"{tuple(ref_u8[j].shape)}")
            out.append(frame_numbers(got[j], ref_u8[j]))
    return out


def output_numbers(config, traffic, seed, samples, device) -> list:
    """The sampled frames' gaps to the float32 reference."""
    return reference_numbers(config, traffic, seed, samples, device)


def control_numbers(config, traffic, seed, device) -> list:
    """The control's gaps: the reference with float8 (e4m3) operands in the
    program's place, on the first `check_frames` frames of the seed's pool."""
    samples = [(k % traffic["pool"], None) for k in range(traffic["check_frames"])]
    return reference_numbers(config, traffic, seed, samples, device, against="fp8")


def stderr_lines(run) -> list:
    if run.trace is None or not isinstance(run.cards[0], int):
        return []
    b1 = run.trace.op_seconds("modconv3x3")
    return [f"traced B1 launches {b1[1]} ({b1[0]} s), card batches {run.card_batches_traced}"]
