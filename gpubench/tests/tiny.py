"""Tiny cells for the benchmark's CPU tests: the frame graph at the port's
CPU-test widths (32 px in, 128 px out, channel_max 256), run on the CPU
through the same drivers, program and check as a cell on the card."""

from __future__ import annotations

import copy

from gpubench import manifest

TINY_VT = {"in_size": 32, "out_size": 128, "img_channels": 3, "parsing_channels": 19,
           "style_channels": 512, "num_mlps": 8, "channel_multiplier": 1, "channel_max": 256,
           "num_res_layers": 2, "backbone": "dualstylegan"}

ENGINE = {"driver": "engine", "frame_hw": [32, 40], "pool": 6, "batch": 4, "dp": 1,
          "max_in_flight": 1, "style_degree": 0.5, "warmup_batches": 1, "check_frames": 4}
FRAME = {"driver": "frame", "frame_hw": [32, 32], "pool": 3, "batch": 1, "dp": 1,
         "style_degree": 0.5, "warmup_requests": 1, "check_frames": 2}


def config(backbone="dualstylegan", dtype="float32"):
    return {"name": "tiny", "vtoonify": {**TINY_VT, "backbone": backbone},
            "bisenet": {"n_classes": 19}, "dtype": dtype}


def cell(like: str, traffic=None, backbone="dualstylegan", dtype="float32", dp=1):
    """The tiny twin of BENCHMARK.json's cell `like`: its metrics and
    limits, with the tiny configuration and traffic (engine or frame, as
    `like`'s) on `dp` CPU devices."""
    real = manifest.load_cell(like)
    tr = copy.deepcopy(traffic or (ENGINE if real.traffic["driver"] == "engine" else FRAME))
    tr["dp"] = dp
    return manifest.Cell(f"tiny-{like}", dp, config(backbone, dtype), tr, real.limits,
                         real.end_to_end, real.per_layer)
