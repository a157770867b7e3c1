"""The yardstick's counts: FLOPs against a hand count and against torch's
own count of the reference's convolutions; the bound; the trace's union."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import inputs, manifest, reference, trace, weights, work
from gpubench.tests import tiny

torch.set_num_threads(2)


def test_styled_conv_hand_count():
    # a 4x5 up conv 8 -> 6 channels: the transposed conv does 9 multiply-adds
    # per input pixel and channel pair; the 4x4 blur 16 per output value
    c = work.StyledConv(8, 6, 4, 5, True)
    assert (c.h_out, c.w_out) == (8, 10)
    assert c.flops == 2 * 9 * 8 * 6 * 4 * 5 + 2 * 16 * 6 * 8 * 10
    assert work.StyledConv(6, 6, 8, 10, False).flops == 2 * 9 * 6 * 6 * 8 * 10
    # bf16 bytes for a batch of 2: activations in and out per frame, weight once
    assert c.bytes(2, "bfloat16") == 2 * (2 * (8 * 4 * 5 + 6 * 8 * 10) + 6 * 8 * 9)


def test_bound_is_the_larger_of_bytes_and_flops():
    assert work.bound_s(3.35e12, 0, "bfloat16") == 1.0
    assert work.bound_s(0, 989e12, "bfloat16") == 1.0
    assert work.bound_s(3.35e12, 2 * 989e12, "bfloat16") == 2.0


def test_styled_convs_walk_the_synthesis():
    cfg = manifest.load_cell("vtd-video-400x360").config["vtoonify"]
    convs = work.styled_convs(cfg, 360, 400)
    assert [(c.cin, c.cout, c.h_out, c.w_out) for c in convs] == [
        (512, 512, 90, 100), (512, 512, 90, 100), (512, 256, 180, 200), (256, 256, 180, 200),
        (256, 128, 360, 400), (128, 128, 360, 400), (128, 64, 720, 800), (64, 64, 720, 800),
        (64, 32, 1440, 1600), (32, 32, 1440, 1600)]


def test_frame_flops_equal_torch_count_of_the_reference_convolutions():
    for backbone in ("dualstylegan", "toonify"):
        config = tiny.config(backbone)
        vt = {**config["vtoonify"], "in_size": 64, "out_size": 256}
        config["vtoonify"] = vt
        sd = weights.make_state(weights.vtoonify_layout(vt), 1, "cpu")
        bs = weights.make_state(weights.bisenet_layout(config["bisenet"]), 1, "cpu", 1)
        frames = inputs.frame_pool(1, 1, 64, 48, "cpu")
        with FlopCounterMode(display=False) as fc:
            reference.frame_image(sd, bs, vt, frames, inputs.style_code(1, vt, "cpu"), 0.5)
        convs = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
        assert work.frame_flops(config, 64, 48) == convs["aten.convolution"]


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.union_length(iv) == 3.0
    assert trace.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
