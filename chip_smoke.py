"""Chip smoke test of the PyTorch + CUDA port (vtoonify_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels upfirdn2d,depth_to_space2   # those alone
    python3 chip_smoke.py --kernels fused_leaky_relu,affine_warp
    python3 chip_smoke.py --paths   # serving and bf16 training alone

Builds the port's five hand-written kernels from vtoonify_tpu_torch/csrc
with nvcc (sm_90a, one nvcc per source, in parallel), checks each against its
plain PyTorch version at every shape the main paths give it (forward in
float32 and bfloat16, backward in float32), then drives the two main paths
with random weights from a seeded torch.Generator:

* serve: the flagship VToonify-D frame graph (BiSeNet -> encoder -> fusion ->
  DualStyleGAN, 256 px -> 1024 px) behind ToonifyPipeline.process_batch,
  checked against the same modules on the CPU in float32, timed at batch 1
  and 16, and one call of each profiled (device busy share, B1's share);
* train: the flagship VToonify-D stage-2 training step (train_d_step:
  teacher synthesis with the augment, D step, G step with LPIPS and the
  temporal crop, EMA) at batch 2 in bfloat16 and float32, timed and
  profiled; and the trainer's --tiny configuration for one step on the card
  and on the CPU from the same modules and draws, compared.

Each phase prints one JSON object on a line of its own with its wall
seconds; the line before the last holds the per-kernel summary, and the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero before
that line. Needs torch with CUDA and nvcc; never imports JAX. Long output
goes to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
OUT_DIR = Path("chiprun_out") / "chip_smoke"
LSB_F32_MAX, LSB_F32_MEAN = 2, 0.05  # card vs CPU, float32, uint8 output
# kernel vs plain version, as a fraction of max(1, max |plain|): float32
# differs only in the order of float32 sums (TF32 off); bf16 rounds once in
# the kernel and after each op in the plain version (2^-8 relative each).
# B5 in float32 also differs in coordinate rounding: the plain version goes
# through the normalized grid, ((gx + 1) W - 1) / 2, the kernel takes the
# pixel coefficients; at 4120 px two or three float32 roundings of a
# coordinate below 8192 are at most ~1.5e-3 px apart, and a [-1, 1] image's
# neighbours differ by at most 2, so 3e-3 bounds the value difference.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_WARP_F32 = 3e-3
TOL_GRAD = 1e-4  # backward: the same plain ops on both sides (only the
# forward values the Functions save may differ, by TOL)
# card vs CPU train step (float32, TF32 off): metrics to 2e-3 relative
# (float32 sums ordered differently through D, LPIPS and three student
# forwards); gradients to 1e-3 in relative L2 norm; Adam's first update
# (~ +-lr per element) compared as tests/test_torch_train_step.py does, on
# the elements whose |g| is above the noise floor (at least 5% of them with
# these random weights; most gradients are below 100 eps = 1e-6)
STEP_RTOL = 2e-3

HBM_BYTES_PER_S = 3.35e12          # H100 SXM (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # float32 outside the tensor cores

# main-path shapes, flagship VToonifyConfig() at 256 px in
CONV3X3 = [(64, 512, 512), (128, 256, 256), (256, 128, 128), (512, 64, 64),
           (1024, 32, 32)]                         # (size, Cin, Cout)
UPCONV = [(32, 512, 512), (64, 512, 256), (128, 256, 128), (256, 128, 64),
          (512, 64, 32)]                           # (input size, Cin, Cout)
TEACHER_LOW = [(4, False), (4, True), (8, False), (8, True), (16, False),
               (16, True), (32, False)]            # (input size, up conv?)
RGB_SKIP = [32, 64, 128, 256, 512]                 # (B, 3, r, r) -> 2r
# the train step's temporal-crop forward: the 896 px crop comes in at 224 px
# (28^2 features), so every student layer runs at 7/8 of its size above —
# sizes that are not multiples of B1's 8x16 px tile
CROP_CONV3X3 = [(56, 512, 512), (112, 256, 256), (224, 128, 128),
                (448, 64, 64), (896, 32, 32)]
CROP_UPCONV = [(28, 512, 512), (56, 512, 256), (112, 256, 128), (224, 128, 64),
               (448, 64, 32)]
CROP_RGB_SKIP = [28, 56, 112, 224, 448]
D_BLUR = [(256, 128), (128, 256), (64, 512), (32, 512), (16, 512), (8, 512)]
SYNTH_DOWN = [(3, 1024), (3, 512), (19, 512), (22, 896), (22, 448)]
AUG = 4120                                         # x2 augment plane (1024 px)
# B2's two largest calls in the flagship train step (bf16): the teachers'
# noisy styled convs at 1024 px (32 channels) and 512 px (64 channels);
# train_phase records B2's shapes over a step and checks these two
B2_TRAIN = [(2, 32, 1024, 1024), (2, 64, 512, 512)]
SOURCES = {
    # bf16 (the summary dtype) runs the tensor-core kernel; f32 runs the
    # CUDA-core kernel in csrc/modconv3x3.cu, which dispatches both
    "modconv3x3": ("vtoonify_tpu_torch/csrc/modconv3x3_mma.cu",
                   "vtoonify_tpu/ops/pallas_kernels.py:214"),
    "fused_leaky_relu": ("vtoonify_tpu_torch/csrc/fused_lrelu.cu",
                         "vtoonify_tpu/ops/pallas_kernels.py:44"),
    "upfirdn2d": ("vtoonify_tpu_torch/csrc/upfirdn2d.cu",
                  "vtoonify_tpu/ops/pallas_kernels.py:109"),
    "depth_to_space2": ("vtoonify_tpu_torch/csrc/d2s2.cu",
                        "vtoonify_tpu/ops/pallas_kernels.py:600"),
    "affine_warp": ("vtoonify_tpu_torch/csrc/affine_warp.cu",
                    "vtoonify_tpu/ops/pallas_kernels.py:470"),
}
# the kernels' names in a profiler trace, for the records' device_ms
PROFILED = {"fused_leaky_relu": "lrelu", "affine_warp": "affine_warp_kernel"}
SUMMARY_SET = {  # the shapes each kernel's summary record sums over (bf16)
    "modconv3x3": "batch-1 serving convs, raw folded form (library F.conv2d)",
    "fused_leaky_relu": "batch-1 serving shapes",
    "upfirdn2d": "discriminator blur shapes, batch 2 (library depthwise F.conv2d)",
    "depth_to_space2": "batch-1 serving up-conv interleaves (library F.pixel_shuffle)",
    "affine_warp": "flagship augment warp, p=1 affine (library F.grid_sample)",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps):
    """Median device time of fn() in ms over `reps` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(fn, reps):
    """Host time of one fn() call in ms, mean over `reps` calls queued
    without a synchronize: where it exceeds the device time, cuda_ms reads
    the host's time, not the kernel's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def profiled_kernel_ms(fn, reps, name, tries=3):
    """Device time of the kernel alone per launch in ms, and the number of
    launches it averages: the profiler's device events whose name holds
    `name`, over `reps` calls of fn(). Beside cuda_ms, which also holds the
    gaps between launches, it shows a case where the host is what the
    events time. A trace may hold fewer device events than launches, at
    times none: such a trace is taken again, up to `tries` times, and
    (None, 0) means that none held one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
               else "self_cuda_time_total")
        evts = [e for e in avgs if name in e.key
                and str(getattr(e, "device_type", "")).endswith("CUDA")]
        count = sum(e.count for e in evts)
        if count:
            return sum(getattr(e, key) for e in evts) / count / 1e3, count
    return None, 0


def bound_ms(nbytes, flops, dtype):
    """The least time the card could take: max(bytes / HBM rate, FLOPs /
    peak for the dtype), and which of the two bounds it."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions


class Case:
    """One kernel call at one main-path shape. make(dtype) -> (kernel fn,
    plain fn, library fn or None, (bytes, flops) the call must move/do)."""

    def __init__(self, name, label, make, summary=False, reps=10):
        self.name, self.label, self.make = name, label, make
        self.summary, self.reps = summary, reps


def kernel_cases(rng, dev):
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.ops.upfirdn2d import make_kernel
    from vtoonify_tpu_torch.train import augment as A

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(np.float32))

    def nbytes(dt, *ts):
        es = torch.finfo(dt).bits // 8
        return es * sum(x.numel() for x in ts if x is not None)

    cases = []

    def conv_case(label, b, size, cin, cout, modulated, act, summary=False):
        x = t(b, cin, size, size)
        w = t(3, 3, cin, cout, scale=1.0 / np.sqrt(9 * cin))
        s = t(b, cin, scale=0.5, shift=1.0) if modulated else None
        d = t(b, cout, scale=0.1, shift=1.0) if modulated else None
        bias = t(cout, scale=0.1) if act else None

        def make(dt):
            a = [None if v is None else v.to(dev, dt) for v in (x, w, s, d, bias)]
            lib = None
            if not (modulated or act):  # raw folded: one F.conv2d
                w_oihw = a[1].permute(3, 2, 0, 1).contiguous()
                lib = lambda: F.conv2d(a[0], w_oihw, padding=1)  # noqa: E731
            work = (nbytes(dt, *a) + nbytes(dt, a[0]) * cout // cin,
                    2 * 9 * cin * cout * size * size * b)
            return lambda: K.modconv3x3(*a), lambda: K.modconv3x3_plain(*a), lib, work
        cases.append(Case("modconv3x3", label, make, summary))

    for size, cin, cout in CONV3X3:
        conv_case(f"conv {size}^2 {cin}->{cout}", 1, size, cin, cout, True, True)
        conv_case(f"conv {size}^2 {cin}->{cout} folded b4", 4, size, cin, cout,
                  False, True)
        conv_case(f"conv {size}^2 {cin}->{cout} raw folded", 1, size, cin, cout,
                  False, False, summary=True)
        conv_case(f"teacher conv {size}^2 {cin}->{cout} raw b2", 2, size, cin,
                  cout, True, False)
        conv_case(f"student conv {size}^2 {cin}->{cout} b2", 2, size, cin, cout,
                  True, True)
    for size, cin, cout in CROP_CONV3X3:
        conv_case(f"crop conv {size}^2 {cin}->{cout} b2", 2, size, cin, cout,
                  True, True)
        conv_case(f"crop conv {size}^2 {cin}->{cout} raw b2", 2, size, cin, cout,
                  True, False)
    for size, cin, cout in CROP_UPCONV:
        conv_case(f"crop upconv {size}^2 {cin}->4*{cout} b2", 2, size, cin,
                  4 * cout, True, True)
        conv_case(f"crop upconv {size}^2 {cin}->4*{cout} raw b2", 2, size, cin,
                  4 * cout, True, False)
    for size, cin, cout in UPCONV:
        conv_case(f"upconv {size}^2 {cin}->4*{cout}", 1, size, cin, 4 * cout,
                  True, True)
        conv_case(f"upconv {size}^2 {cin}->4*{cout} folded b4", 4, size, cin,
                  4 * cout, False, True)
        conv_case(f"upconv {size}^2 {cin}->4*{cout} raw folded", 1, size, cin,
                  4 * cout, False, False, summary=True)
        conv_case(f"teacher upconv {size}^2 {cin}->4*{cout} raw b2", 2, size,
                  cin, 4 * cout, True, False)
        conv_case(f"student upconv {size}^2 {cin}->4*{cout} b2", 2, size, cin,
                  4 * cout, True, True)
    for size, upc in TEACHER_LOW:
        conv_case(f"teacher {'upconv' if upc else 'conv'} {size}^2 512->"
                  f"{'4*' if upc else ''}512 raw b2", 2, size, 512,
                  2048 if upc else 512, True, False)

    for shape, summary in [((1, 512, 32, 32), True), ((4, 512, 32, 32), False),
                           ((18, 512), True), ((2, 512, 64, 64), False),
                           *((s, False) for s in B2_TRAIN)]:
        x, bias = t(*shape), t(shape[1], scale=0.1)

        def make(dt, x=x, bias=bias):
            a, c = x.to(dev, dt), bias.to(dev, dt)
            return (lambda: K.fused_leaky_relu(a, c),
                    lambda: K.fused_leaky_relu_plain(a, c), None,
                    (2 * nbytes(dt, a) + nbytes(dt, c), 4 * a.numel()))
        label = f"{tuple(shape)}" + (" train step" if shape in B2_TRAIN else "")
        cases.append(Case("fused_leaky_relu", label, make, summary))

    def fir_case(label, shape, k2d, up, down, pad, summary=False, reps=10):
        x = t(*shape)

        def make(dt, x=x):
            a = x.to(dev, dt)
            args = (k2d, up, down, pad)
            kh, kw = k2d.shape
            oh, ow = K._upfirdn2d_out_hw(shape[2], shape[3], kh, kw, up, down, pad)
            out_n = shape[0] * shape[1] * oh * ow
            work = (nbytes(dt, a) + out_n * (torch.finfo(dt).bits // 8),
                    2 * out_n * kh * kw / (up[0] * up[1]))
            return (lambda: K.upfirdn2d(a, *args), lambda: K.upfirdn2d_plain(a, *args),
                    fir_library(a, *args), work)
        cases.append(Case("upfirdn2d", label, make, summary, reps))

    k1 = make_kernel([1, 3, 3, 1])
    k_up = torch.outer(k1 * 2.0, k1 * 2.0)
    k_blur = torch.outer(k1, k1)
    for b, sizes in ((1, RGB_SKIP), (2, RGB_SKIP), (4, RGB_SKIP),
                     (2, CROP_RGB_SKIP)):
        for r in sizes:
            fir_case(f"upsample_2x ({b},3,{r},{r})", (b, 3, r, r), k_up, (2, 2),
                     (1, 1), (2, 1, 2, 1))
    for r, c in D_BLUR:
        fir_case(f"D blur ({2},{c},{r},{r}) pad 2", (2, c, r, r), k_blur, (1, 1),
                 (1, 1), (2, 2, 2, 2), summary=True)
        fir_case(f"D blur ({2},{c},{r},{r}) pad 1", (2, c, r, r), k_blur, (1, 1),
                 (1, 1), (1, 1, 1, 1), summary=True)
    for c, r in SYNTH_DOWN:
        fir_case(f"synth.down ({2},{c},{r},{r})", (2, c, r, r), k_blur, (1, 1),
                 (2, 2), (1, 1, 1, 1))
    sym6 = A.SYM6
    half = AUG // 2
    fir_case(f"SYM6 x-up (2,6,{half},{half})", (2, 6, half, half), sym6[None, :],
             (2, 1), (1, 1), (6, 5, 0, 0), reps=5)
    fir_case(f"SYM6 y-up (2,6,{half},{AUG})", (2, 6, half, AUG), sym6[:, None],
             (1, 2), (1, 1), (0, 0, 6, 5), reps=5)
    fir_case(f"SYM6 x-down (2,6,{half},{half})", (2, 6, half, half),
             sym6.flip(0)[None, :], (1, 1), (2, 1), (-1, -1, 0, 0), reps=5)
    fir_case(f"SYM6 y-down (2,6,{half},1024)", (2, 6, half, 1024),
             sym6.flip(0)[:, None], (1, 1), (1, 2), (0, 0, -1, -1), reps=5)

    for b, shapes in ((1, UPCONV), (2, UPCONV), (4, UPCONV), (2, CROP_UPCONV)):
        for size, _, cout in shapes:
            x = t(b, 4 * cout, size, size)

            def make(dt, x=x):
                a = x.to(dev, dt)
                return (lambda: K.depth_to_space2(a, True),
                        lambda: K.depth_to_space2_plain(a, True),
                        lambda: F.pixel_shuffle(a, 2), (2 * nbytes(dt, a), 0))
            cases.append(Case("depth_to_space2", f"({b},{4 * cout},{size},{size}) "
                              "phase-minor", make, b == 1))

    # B5 at the flagship augment: (2, 6, 4120, 4120) -> (2, 6, 2060, 2060)
    gen = torch.Generator().manual_seed(SEED)
    img = torch.tanh(torch.randn((2, 6, AUG, AUG), generator=gen))
    eye = torch.eye(3).repeat(2, 1, 1)
    drawn = torch.linalg.inv(A.sample_affine(gen, 1.0, 2, 1024, 1024))
    for label, G_inv, summary in (("identity affine", eye, False),
                                  ("sampled p=1 affine", drawn, True)):
        theta, out_hw = A.warp_theta(G_inv, (1024, 1024), (AUG, AUG))
        coef = A._pixel_affine_coefs(theta, out_hw, (AUG, AUG)).contiguous()
        grid = A._affine_grid(theta, out_hw)

        def make(dt, coef=coef, grid=grid, out_hw=out_hw):
            # F.grid_sample takes its grid in the image's dtype: in bf16 the
            # library call reads the same image bytes but rounds coordinates
            # to 8 bits, so its time is comparable and its values are not
            a, c, g = img.to(dev, dt), coef.to(dev), grid.to(dev, dt)
            # bytes: the input pixels the sampling reaches (nonzero corner
            # weights) once, plus the output; ~12 FLOPs/pixel + 8/value
            with torch.enable_grad():
                leaf = img[:, :1].contiguous().to(dev).requires_grad_()
                touched = torch.autograd.grad(
                    K.affine_warp_plain(leaf, c, out_hw).sum(), leaf)[0]
            n_in = int((touched != 0).sum()) * a.shape[1]
            n_out = a.shape[0] * a.shape[1] * out_hw[0] * out_hw[1]
            es = torch.finfo(dt).bits // 8
            work = ((n_in + n_out) * es, a.shape[0] * out_hw[0] * out_hw[1]
                    * (12 + 8 * a.shape[1]))
            lib = lambda: F.grid_sample(a, g, mode="bilinear",  # noqa: E731
                                        padding_mode="zeros", align_corners=False)
            return (lambda: K.affine_warp(a, c, out_hw),
                    lambda: K.affine_warp_plain(a, c, out_hw), lib, work)
        cases.append(Case("affine_warp", f"(2,6,{AUG},{AUG})->(2,6,{out_hw[0]},"
                          f"{out_hw[1]}) {label}", make, summary, reps=5))
    return cases


def fir_library(a, k2d, up, down, pad):
    """One PyTorch call on `a` (or a view of it) that computes upfirdn2d(a,
    k2d, up, down, pad), or None: a depthwise F.conv_transpose2d with stride
    `up` (the taps as they are, padding kh - 1 - pad0) where only up is 2; a
    depthwise F.conv2d with stride `down` (flipped taps) on the view that the
    negative pads crop, where up is 1 and the positive pads are symmetric.
    The yardstick of B3's time; the port never calls it."""
    c = a.shape[1]
    kh, kw = k2d.shape
    px0, px1, py0, py1 = pad
    if down == (1, 1) and up != (1, 1):
        w = k2d.to(a.device, a.dtype).expand(c, 1, kh, kw).contiguous()
        padding = (kh - 1 - py0, kw - 1 - px0)
        if min(padding) < 0:
            return None
        return lambda: F.conv_transpose2d(a, w, stride=(up[1], up[0]),  # noqa: E731
                                          padding=padding, groups=c)
    if up != (1, 1) or max(px0, 0) != max(px1, 0) or max(py0, 0) != max(py1, 0):
        return None
    view = a[:, :, max(-py0, 0):a.shape[2] - max(-py1, 0),
             max(-px0, 0):a.shape[3] - max(-px1, 0)]
    w = torch.flip(k2d, (0, 1)).to(a.device, a.dtype).expand(c, 1, kh, kw).contiguous()
    return lambda: F.conv2d(view, w, stride=(down[1], down[0]),  # noqa: E731
                            padding=(max(py0, 0), max(px0, 0)), groups=c)


def backward_cases(rng, dev):
    """(kernel, label, kernel fn, plain fn, inputs): each Function's
    gradients on the card vs torch.autograd through the plain version, at one
    main-path shape, float32."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.ops.upfirdn2d import make_kernel
    from vtoonify_tpu_torch.train import augment as A

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(
            np.float32)).to(dev)

    k1 = make_kernel([1, 3, 3, 1])
    k_blur = torch.outer(k1, k1)
    theta, out_hw = A.warp_theta(torch.eye(3).repeat(2, 1, 1), (1024, 1024), (AUG, AUG))
    theta[:, :, :2] = theta[:, :, :2] * 1.07
    coef = A._pixel_affine_coefs(theta, out_hw, (AUG, AUG)).to(dev).contiguous()
    return [
        ("modconv3x3", "conv 64^2 512->512 modulated + act",
         K.modconv3x3, K.modconv3x3_plain,
         (t(1, 512, 64, 64), t(3, 3, 512, 512, scale=1 / 68), t(1, 512, shift=1.0),
          t(1, 512, scale=0.1, shift=1.0), t(512, scale=0.1))),
        ("fused_leaky_relu", "(2,512,64,64)", K.fused_leaky_relu,
         K.fused_leaky_relu_plain, (t(2, 512, 64, 64), t(512))),
        ("upfirdn2d", "D blur (2,128,256,256) pad 2",
         lambda x: K.upfirdn2d(x, k_blur, (1, 1), (1, 1), (2, 2, 2, 2)),
         lambda x: K.upfirdn2d_plain(x, k_blur, (1, 1), (1, 1), (2, 2, 2, 2)),
         (t(2, 128, 256, 256),)),
        ("depth_to_space2", "(1,1024,64,64) phase-minor",
         lambda x: K.depth_to_space2(x, True),
         lambda x: K.depth_to_space2_plain(x, True), (t(1, 1024, 64, 64),)),
        ("affine_warp", f"(2,6,{AUG},{AUG}) scaled affine",
         lambda x: K.affine_warp(x, coef, out_hw),
         lambda x: K.affine_warp_plain(x, coef, out_hw),
         (torch.tanh(t(2, 6, AUG, AUG)),)),
    ]


def kernel_phase(dev, only=None):
    """Every kernel case (or those of the kernels in `only`) against its
    plain version, timed beside it, its library call and its bound."""
    t0 = time.perf_counter()
    names = [n for n in SOURCES if only is None or n in only]
    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "library_ms": None, "bytes": 0, "flops": 0}
               for name in names}
    records = []
    for case in kernel_cases(np.random.RandomState(SEED), dev):
        if case.name not in summary:
            continue
        for dtype in ("float32", "bfloat16"):
            kern, plain, lib, (nb, fl) = case.make(getattr(torch, dtype))
            got, want = kern().float(), plain().float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            tol = (TOL_WARP_F32 if case.name == "affine_warp" and dtype == "float32"
                   else TOL[dtype]) * scale
            lib_err = None
            if lib is not None and case.name == "upfirdn2d":
                # the yardstick computes the same function: checked once
                lib_out = lib().float()
                check(lib_out.shape == want.shape, f"{case.label}: library call "
                      f"shape {tuple(lib_out.shape)} != {tuple(want.shape)}")
                lib_err = (lib_out - want).abs().max().item()
                del lib_out
            bms, by = bound_ms(nb, fl, dtype)
            dev_ms, dev_n = (profiled_kernel_ms(kern, case.reps, PROFILED[case.name])
                             if case.name in PROFILED else (None, None))
            rec = {"phase": "kernel", "kernel": case.name, "shape": case.label,
                   "dtype": dtype, "max_abs_err": err, "tol": tol,
                   "finite": bool(torch.isfinite(got).all()),
                   "ms": cuda_ms(kern, case.reps), "plain_ms": cuda_ms(plain, case.reps),
                   "library_ms": None if lib is None else cuda_ms(lib, case.reps),
                   "library_max_abs_err": lib_err,
                   "host_ms": host_ms(kern, case.reps),
                   "device_ms": dev_ms, "device_events": dev_n,
                   "library_host_ms": None if lib is None else host_ms(lib, case.reps),
                   "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
            del got, want
            records.append(rec)
            emit(rec)
            check(rec["finite"] and err <= tol,
                  f"{case.name} {case.label} {dtype}: max|kernel - plain| {err} > {tol}")
            check(lib_err is None or lib_err <= tol,
                  f"{case.name} {case.label} {dtype}: library call off by {lib_err}")
            sm = summary[case.name]
            sm["max_abs_err"] = max(sm["max_abs_err"], err)
            if case.summary and dtype == "bfloat16":
                for k in ("ms", "plain_ms", "bound_ms", "bytes", "flops"):
                    sm[k] += rec[k]
                if rec["library_ms"] is not None:
                    sm["library_ms"] = (sm["library_ms"] or 0.0) + rec["library_ms"]
    for name, sm in summary.items():
        sm["bound_by"] = bound_ms(sm["bytes"], sm["flops"], "bfloat16")[1]

    for name, label, kern, plain, inputs in backward_cases(np.random.RandomState(1), dev):
        if name not in summary:
            continue
        grads = []
        for fn in (kern, plain):
            leaves = [x.detach().clone().requires_grad_() for x in inputs]
            y = fn(*leaves)
            g_out = torch.ones_like(y) if y.ndim == 0 else torch.linspace(
                -1, 1, y.numel(), device=dev).reshape(y.shape)
            grads.append(torch.autograd.grad(y, leaves, g_out))
        errs = []
        for gk, gp in zip(*grads):
            scale = max(1.0, gp.abs().max().item())
            errs.append((gk - gp).abs().max().item() / scale)
        rec = {"phase": "kernel_backward", "kernel": name, "shape": label,
               "dtype": "float32", "max_rel_err": max(errs), "tol": TOL_GRAD}
        emit(rec)
        check(max(errs) <= TOL_GRAD, f"{name} backward {label}: {max(errs)}")
        summary[name]["backward_max_rel_err"] = max(errs)
    (OUT_DIR / "kernel_records.json").write_text(json.dumps(records, indent=1))
    emit({"phase": "kernel_done", "seconds": time.perf_counter() - t0})
    return summary


def device_profile(fn, table_name):
    """One fn() under torch.profiler: host wall, device busy time (the
    device-side events, kernels and memcpy/memset, each counted once), B1's
    share of it, B2's to B5's device time, the host time per call of B3's
    forward (the wrapper's `vt::upfirdn2d` range, inside `_UpFirDn2d` where
    autograd records it) and backward (a copy to the device that waits on it
    shows there), the same for B2 and B5, the pageable host-to-device
    copies, and the top device ops; the full table goes to OUT_DIR."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    avgs = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side events, without the device spans of user annotations
    # (record_function ranges such as Adam's step and vt::upfirdn2d), which
    # would count their kernels twice
    on_dev = [str(getattr(e, "device_type", "")).endswith("CUDA") for e in avgs]
    evts = sorted((e for e, d in zip(avgs, on_dev)
                   if d and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: getattr(e, key), reverse=True)
    busy = sum(getattr(e, key) for e in evts) / 1e6
    b1 = sum(getattr(e, key) for e in evts if "modconv3x3" in e.key) / 1e6
    (OUT_DIR / table_name).write_text(avgs.table(sort_by=key, row_limit=60))
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "b1_device_s": b1, "b1_share_of_device": b1 / busy if busy else 0.0,
            **{f"{b}_device_ms": sum(getattr(e, key) for e in evts if kernel in e.key)
               / 1e3 for b, kernel in (("b2", "lrelu"), ("b3", "upfirdn2d_kernel"),
                                       ("b4", "d2s2_kernel"),
                                       ("b5", "affine_warp_kernel"))},
            "b3_host_ms_per_call": {  # the wrapper's forward, and the backward
                e.key: e.cpu_time_total / e.count / 1e3 for e, d in zip(avgs, on_dev)
                if not d and e.count and (e.key == "vt::upfirdn2d" or "UpFirDn2d" in e.key)},
            "b2_b5_host_ms_per_call": {
                e.key: e.cpu_time_total / e.count / 1e3 for e, d in zip(avgs, on_dev)
                if not d and e.count and any(k in e.key for k in (
                    "vt::fused_leaky_relu", "FusedLeakyReLU", "vt::affine_warp",
                    "AffineWarp"))},
            "htod_pageable_copies": sum(e.count for e in evts
                                        if "HtoD (Pageable" in e.key),
            "top_device_ops": [{"op": e.key[:120], "device_ms": getattr(e, key) / 1e3,
                                "count": e.count} for e in evts[:15]]}


# ---------------------------------------------------------------------------
# serve: the flagship pipeline


def build_modules():
    """Flagship VToonify-D + BiSeNet on the CPU in float32, random weights
    from a seeded torch.Generator. The styled convs' and ToRGBs' biases
    (zero at init) get random values too, so the random-weight image has
    contrast for the output checks."""
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig, init_vtoonify

    g = torch.Generator().manual_seed(SEED)
    cfg = VToonifyConfig()
    vt = init_vtoonify(cfg, generator=g)
    parsing = init_bisenet(generator=g)
    with torch.no_grad():
        for blk in vt.generator.generator.convs:
            blk.act_bias.normal_(0.0, 0.5, generator=g)
        for blk in vt.generator.generator.to_rgbs:
            blk.bias.normal_(0.0, 0.5, generator=g)
    return cfg, vt, parsing


def serve_phases(smi):
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    # build: the flagship pipeline in bf16 and f32 (no device argument: the card)
    t0 = time.perf_counter()
    cfg, vt_cpu, parsing_cpu = build_modules()
    vt_dev = copy.deepcopy(vt_cpu)
    parsing_dev = copy.deepcopy(parsing_cpu)
    pipe_bf16 = ToonifyPipeline(vt_dev, cfg, parsing_dev, dtype=torch.bfloat16)
    pipe_f32 = ToonifyPipeline(vt_dev, cfg, parsing_dev, dtype=torch.float32)
    check(next(pipe_f32.vt.parameters()).device.type == "cuda",
          "ToonifyPipeline without a device did not run on the card")
    emit({"phase": "build", "config": "VToonifyConfig() + BiSeNet",
          "params": sum(p.numel() for p in vt_cpu.parameters()),
          "bisenet_params": sum(p.numel() for p in parsing_cpu.parameters()),
          "seconds": time.perf_counter() - t0})

    # serve a few requests through process_batch; count launches
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    frames4 = rng.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8)
    wide = rng.randint(0, 256, (1, 256, 320, 3)).astype(np.uint8)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out4 = pipe_bf16.process_batch(frames4, s_w, 0.5)      # folded style
    out1 = pipe_bf16.process_batch(frames4[:1], s_w, 0.5)  # unfolded s/d
    outw = pipe_bf16.process_batch(wide, s_w, 0.5)         # non-square
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for out, shape in ((out4, (4, 1024, 1024, 3)), (out1, (1, 1024, 1024, 3)),
                       (outw, (1, 1024, 1280, 3))):
        check(tuple(out.shape) == shape and out.dtype == torch.uint8
              and out.device.type == "cuda", f"output {tuple(out.shape)} "
              f"{out.dtype} {out.device}, want {shape} uint8 on cuda")
    fold_vs_unfold = (out4[:1].int() - out1.int()).abs()
    emit({"phase": "serve", "requests": ["batch 4 256x256 (folded style)",
                                         "batch 1 256x256", "batch 1 256x320"],
          "launches": launches,
          "out_std_lsb": out4.float().std().item(),
          "fold_vs_unfold_max_lsb": fold_vs_unfold.max().item(),
          "fold_vs_unfold_mean_lsb": fold_vs_unfold.float().mean().item(),
          "seconds": time.perf_counter() - t0})
    for name in ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"):
        check(launches[name] > 0, f"kernel {name} was not launched by the serve path")
    check(out4.float().std().item() > 10, "output image is flat")
    # the two style forms round bf16 at different places; a wrong fold or
    # modulation shows up as tens of LSB, not a fraction of one
    check(fold_vs_unfold.float().mean().item() < 4.0,
          "folded and unfolded style paths disagree")

    # float32 card output vs the same modules on the CPU
    t0 = time.perf_counter()
    frame = frames4[:1]
    card = pipe_f32.process_batch(frame, s_w, 0.5).cpu()
    pipe_cpu = ToonifyPipeline(vt_cpu, cfg, parsing_cpu, dtype=torch.float32,
                               device="cpu")
    t1 = time.perf_counter()
    host = pipe_cpu.process_batch(frame, s_w, 0.5)
    cpu_s = time.perf_counter() - t1
    diff = (card.int() - host.int()).abs().float()
    emit({"phase": "e2e_f32_vs_cpu", "max_lsb": diff.max().item(),
          "mean_lsb": diff.mean().item(), "bound_max_lsb": LSB_F32_MAX,
          "bound_mean_lsb": LSB_F32_MEAN, "cpu_seconds": cpu_s,
          "out_std_lsb": host.float().std().item(),
          "seconds": time.perf_counter() - t0})
    check(diff.max().item() <= LSB_F32_MAX and diff.mean().item() <= LSB_F32_MEAN,
          "float32 card output differs from the CPU plain run beyond the bound")

    # timing, bf16, 256 -> 1024, after warm-up
    t0 = time.perf_counter()
    for batch, reps in ((1, 20), (16, 5)):
        frames = np.resize(frames4, (batch, 256, 256, 3))
        for _ in range(2):
            pipe_bf16.process_batch(frames, s_w, 0.5)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            pipe_bf16.process_batch(frames, s_w, 0.5)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        p25, p50, p75 = (float(v) for v in np.percentile(times, [25, 50, 75]))
        emit({"phase": "timing", "batch": batch, "dtype": "bfloat16",
              "in_px": 256, "out_px": 1024, "reps": reps,
              "p50_ms_per_call": p50 * 1e3, "p50_ms_per_frame": p50 * 1e3 / batch,
              "fps": batch / p50, "p25_p75_ms_per_call": [p25 * 1e3, p75 * 1e3],
              "min_max_ms_per_call": [min(times) * 1e3, max(times) * 1e3],
              "profile": device_profile(
                  lambda: pipe_bf16.process_batch(frames, s_w, 0.5),
                  f"serve_profile_b{batch}.txt"),
              "nvidia_smi": smi})
    emit({"phase": "timing_done", "seconds": time.perf_counter() - t0})
    del pipe_bf16, pipe_f32, pipe_cpu, vt_dev, parsing_dev
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# train: the stage-2 step


def train_setup(cfg, dcfg, tcfg, batch, g):
    """Random-weight modules (CPU, float32) and the step's frozen inputs, as
    bench_train.py::bench_full builds them with JAX."""
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.models.lpips import init_lpips
    from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig, init_psp_encoder
    from vtoonify_tpu_torch.models.vtoonify import init_cond_discriminator, init_vtoonify

    pcfg = PSPEncoderConfig(n_styles=cfg.n_latent)
    mods = dict(vt=init_vtoonify(cfg, g), parsing=init_bisenet(generator=g),
                d=init_cond_discriminator(dcfg, g),
                psp=init_psp_encoder(pcfg, g), lpips=init_lpips(g))
    n_latent = cfg.n_latent
    inputs = dict(
        directions=torch.randn((4, n_latent, 512), generator=g) * 0.1,
        style=torch.randn((batch, n_latent, 512), generator=g) * 0.3,
        style_ind=torch.arange(batch) % dcfg.style_num,
        weights=[0.5] * 7 + [1.0] * (n_latent - 7))
    return pcfg, mods, inputs


def run_step(state, mods, pcfg, inputs, cfg, dcfg, tcfg, jitter, **kw):
    from vtoonify_tpu_torch.train.steps import split_trainable, train_d_step

    _, frozen = split_trainable(mods["vt"])
    return train_d_step(
        state, frozen, mods["parsing"], mods["psp"], pcfg, None, mods["lpips"],
        cfg, dcfg, tcfg, inputs["directions"], inputs["style"],
        inputs["style_ind"], 0.5, inputs["weights"], 0.3, 0.5, jitter, **kw)


@contextlib.contextmanager
def recording_b2_shapes():
    """Counts the (shape, dtype) of every B2 call made through nn/layers.py,
    its one caller on the main paths, while the context is open."""
    from vtoonify_tpu_torch.nn import layers

    seen = collections.Counter()
    real = layers.fused_leaky_relu

    def recording(x, *args, **kw):
        seen[(tuple(x.shape), str(x.dtype).replace("torch.", ""))] += 1
        return real(x, *args, **kw)

    layers.fused_leaky_relu = recording
    try:
        yield seen
    finally:
        layers.fused_leaky_relu = real


def _flat(module):
    return torch.cat([p.detach().float().reshape(-1) for p in module.parameters()])


def train_phase(smi, compute_dtype, steps):
    """The flagship stage-2 step at batch 2 (bench_train.py::bench_full's
    configuration, nothing cut), from init_train_d_state with no device."""
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig, VToonifyConfig
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.train.steps import TrainDConfig, init_train_d_state

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED)
    cfg = VToonifyConfig()
    dcfg = CondDiscriminatorConfig(size=256, channel_multiplier=2,
                                   use_condition=True, style_num=4)
    tcfg = TrainDConfig(compute_dtype=compute_dtype)
    batch = 2
    pcfg, mods, inputs = train_setup(cfg, dcfg, tcfg, batch, g)
    state = init_train_d_state(mods["vt"], mods["d"], batch, cfg, tcfg)
    check(state.wc_prev.device.type == "cuda",
          "init_train_d_state without a device did not run on the card")
    gen = torch.Generator(device=state.wc_prev.device).manual_seed(SEED)
    before = {k: _flat(m) for k, m in (("trainable", state.trainable),
                                       ("d", state.d), ("ema", state.ema))}
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, per_step, metrics = [], [], None
    for i in range(1 + steps):  # 1 warm-up step, then the timed steps
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t1 = time.perf_counter()
        with recording_b2_shapes() if i == 0 else contextlib.nullcontext() as seen:
            metrics = run_step(state, mods, pcfg, inputs, cfg, dcfg, tcfg, False,
                               generator=gen)
            if i == 0:
                b2_shapes = sorted(seen.items(), key=lambda kv: -np.prod(kv[0][0]))
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t1)
        per_step.append(K.launch_counts())
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in vals.values()),
              f"non-finite loss in step {i}: {vals}")
        for name, n in per_step[-1].items():
            check(n > 0, f"kernel {name} was not launched by train step {i}")
    moved = {k: (_flat(m) - before[k]).abs().sum().item()
             for k, m in (("trainable", state.trainable), ("d", state.d),
                          ("ema", state.ema))}
    check(all(v > 0 for v in moved.values()), f"parameters did not move: {moved}")
    dtype = compute_dtype or "float32"
    rec = {"phase": f"train_{dtype}", "config": "VToonifyConfig() + "
           "CondDiscriminatorConfig(256, 2, use_condition, style_num=4) + pSp "
           "(18 styles) + LPIPS + BiSeNet, TrainDConfig(compute_dtype="
           f"{compute_dtype!r}) defaults, batch 2",
           "steps_timed": steps, "s_per_iter": times,
           "p50_s_per_iter": float(np.median(times)),
           "min_max_s_per_iter": [min(times), max(times)],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step": per_step[1],
           "b2_largest_shapes": [{"shape": list(sh), "dtype": dt, "calls": n}
                                 for (sh, dt), n in b2_shapes[:6]],
           "metrics": vals, "moved_abs_sum": moved,
           "setup_seconds": setup_s, "seconds": time.perf_counter() - t0,
           "nvidia_smi": smi}

    largest = sorted({sh for (sh, _), _ in b2_shapes}, key=lambda sh: -np.prod(sh))
    check(largest[:2] == B2_TRAIN and all(dt == dtype for (sh, dt), _ in b2_shapes
                                          if sh in B2_TRAIN),
          f"B2's largest train-step shapes {largest[:2]} ({dtype}) are not "
          f"chip_smoke's B2 train cases {B2_TRAIN}")
    if compute_dtype is not None:  # profile one more step: top device ops
        rec["profile"] = device_profile(
            lambda: run_step(state, mods, pcfg, inputs, cfg, dcfg, tcfg, False,
                             generator=gen), "train_profile.txt")
    emit(rec)
    launches = per_step[1]
    del state, mods
    torch.cuda.empty_cache()
    return launches


def train_f32_vs_cpu_phase():
    """The trainer's --tiny configuration, one step at batch 2 on the card
    and on the CPU from identical modules and one TrainDDraws, float32 with
    TF32 off."""
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig, VToonifyConfig
    from vtoonify_tpu_torch.train.steps import (
        ADAM_BETA1, ADAM_EPS, TrainDConfig, init_train_d_state, sample_train_d_draws)

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 1)
    cfg = VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1,
                         num_res_layers=2)
    dcfg = CondDiscriminatorConfig(size=64, channel_multiplier=1,
                                   use_condition=True, style_num=4)
    tcfg = TrainDConfig(crop_size=96, lpips_size=64, aug_max_pad=40)
    lr = tcfg.lr
    pcfg, mods_cpu, inputs = train_setup(cfg, dcfg, tcfg, 2, g)
    with torch.no_grad():  # random noise weights and biases: nothing blind
        gen = mods_cpu["vt"].generator.generator
        for blk in [gen.conv1, *gen.convs]:
            blk.noise.weight.fill_(0.1)
            blk.act_bias.normal_(0.0, 0.3, generator=g)
    mods_dev = copy.deepcopy(mods_cpu)
    draws = sample_train_d_draws(g, 2, cfg, tcfg, 4)
    out = {}
    for where, mods in (("cuda", mods_dev), ("cpu", mods_cpu)):
        state = init_train_d_state(mods["vt"], mods["d"], 2, cfg, tcfg,
                                   device=None if where == "cuda" else "cpu")
        t1 = time.perf_counter()
        m = run_step(state, mods, pcfg, inputs, cfg, dcfg, tcfg, True,
                     draws=draws.to(state.wc_prev.device))
        torch.cuda.synchronize()
        grads = {"trainable": torch.cat([
            (state.g_opt.state[p]["exp_avg"] / (1 - ADAM_BETA1)).reshape(-1).cpu()
            for p in state.trainable.parameters()]),
                 "d": torch.cat([
            (state.d_opt.state[p]["exp_avg"] / (1 - ADAM_BETA1)).reshape(-1).cpu()
            for p in state.d.parameters()])}
        new = {"trainable": _flat(state.trainable).cpu(), "d": _flat(state.d).cpu()}
        out[where] = dict(metrics={k: float(v) for k, v in m.items()}, new=new,
                          grads=grads, ema=_flat(state.ema).cpu(),
                          seconds=time.perf_counter() - t1)
    # the updates: both sides started from the same float32 parameters
    rec = {"phase": "train_f32_vs_cpu", "config": "--tiny: VToonifyConfig(32 -> "
           "128 px, channel_multiplier 1, 2 res layers), D 64 px cm 1, crop 96, "
           "lpips 64, aug_max_pad 40, batch 2, color jitter on",
           "metrics_cuda": out["cuda"]["metrics"], "metrics_cpu": out["cpu"]["metrics"],
           "cuda_step_s": out["cuda"]["seconds"], "cpu_step_s": out["cpu"]["seconds"]}
    for k in out["cuda"]["metrics"]:
        a, b = out["cuda"]["metrics"][k], out["cpu"]["metrics"][k]
        check(np.isfinite(a) and abs(a - b) <= STEP_RTOL * abs(b) + 1e-9,
              f"train step metric {k}: card {a} vs CPU {b}")
    covered = total = 0
    for k in ("trainable", "d"):
        d_card = out["cuda"]["new"][k] - out["cpu"]["new"][k]
        g = out["cpu"]["grads"][k].abs()
        err = d_card.abs()  # both updates start from the same parameters
        check(err.max().item() <= 2 * lr + 1e-7, f"{k}: updates differ by > 2 lr")
        mask = (g > 1e-3 * g.max()) & (g > 100 * ADAM_EPS)
        e = err[mask]
        rec[f"{k}_masked_max_err_over_lr"] = e.max().item() / lr if e.numel() else 0.0
        rec[f"{k}_masked_frac_over_1e-3_lr"] = (e > 1e-3 * lr).float().mean().item() \
            if e.numel() else 0.0
        check(rec[f"{k}_masked_max_err_over_lr"] <= 0.02
              and rec[f"{k}_masked_frac_over_1e-3_lr"] <= 1e-2,
              f"{k}: card and CPU updates disagree")
        covered, total = covered + int(mask.sum()), total + mask.numel()
        g_card = out["cuda"]["grads"][k]
        rec[f"{k}_grad_rel_l2"] = ((g_card - out["cpu"]["grads"][k]).norm()
                                   / out["cpu"]["grads"][k].norm()).item()
        check(rec[f"{k}_grad_rel_l2"] <= 1e-3, f"{k}: card and CPU gradients differ")
    ema_err = (out["cuda"]["ema"] - out["cpu"]["ema"]).abs().max().item()
    rec.update(mask_coverage=covered / total, ema_max_abs_err=ema_err,
               seconds=time.perf_counter() - t0)
    emit(rec)
    check(covered > 0.05 * total, "update comparison covers too few elements")
    check(ema_err <= 1e-6, "EMA differs between card and CPU")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from vtoonify_tpu_torch.ops import kernels as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    # environment and kernel build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = not K.library_path().exists()
    t0 = time.perf_counter()
    lib = K.build()
    K._library()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "kernel_library": str(lib.relative_to(K.BUILD_DIR.parent.parent)),
          "built_from_source": built, "build_and_load_s": time.perf_counter() - t0})

    if len(sys.argv) == 3 and sys.argv[1] == "--kernels":
        # a quick check of some kernels alone: their cases and summary, no
        # main path and no result line
        only = sys.argv[2].split(",")
        check(set(only) <= set(SOURCES), f"--kernels takes names from {list(SOURCES)}")
        emit({"kernels_only": kernel_phase(dev, only)})
        return
    if sys.argv[1:] == ["--paths"]:
        # the serving and bf16 training paths alone, timed and profiled (an
        # A/B of two trees runs this in each); no result line
        serve_phases(smi)
        train_phase(smi, "bfloat16", steps=3)
        return
    check(len(sys.argv) == 1,
          "usage: chip_smoke.py [--kernels NAME[,NAME...] | --paths]")
    summary = kernel_phase(dev)
    launches_serve = serve_phases(smi)
    launches_train = train_phase(smi, "bfloat16", steps=3)
    train_phase(smi, None, steps=2)
    train_f32_vs_cpu_phase()

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": launches_serve.get(name, 0) + launches_train.get(name, 0),
         "launches_serve": launches_serve.get(name, 0),
         "launches_train_step": launches_train.get(name, 0),
         **{k: summary[name][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "backward_max_rel_err")},
         "summed_over": SUMMARY_SET[name]}
        for name in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
