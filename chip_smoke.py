"""Chip smoke test of the PyTorch + CUDA port (vtoonify_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's four hand-written kernels from vtoonify_tpu_torch/csrc
with nvcc (sm_90a), checks each against its plain PyTorch version at every
shape the main path gives it, then drives the main path — the flagship
VToonify-D frame graph (BiSeNet -> encoder -> fusion -> DualStyleGAN,
256 px -> 1024 px) behind ToonifyPipeline.process_batch — with random
weights from a seeded torch.Generator, checks its output against the same
modules run on the CPU, and times it. Each phase prints one JSON object on a
line of its own; the line before the last holds the per-kernel summary, and
the last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line. Needs torch with CUDA and nvcc; never imports JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
LSB_F32_MAX, LSB_F32_MEAN = 2, 0.05  # card vs CPU, float32, uint8 output
# kernel vs plain version, as a fraction of max(1, max |plain|): float32
# differs only in the order of float32 sums (TF32 off); bf16 rounds once in
# the kernel and after each op in the plain version (2^-8 relative each)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}

# main-path shapes, flagship VToonifyConfig() at 256 px in
CONV3X3 = [(64, 512, 512), (128, 256, 256), (256, 128, 128), (512, 64, 64),
           (1024, 32, 32)]                         # (size, Cin, Cout)
UPCONV = [(32, 512, 512), (64, 512, 256), (128, 256, 128), (256, 128, 64),
          (512, 64, 32)]                           # (input size, Cin, Cout)
RGB_SKIP = [32, 64, 128, 256, 512]                 # (B, 3, r, r) -> 2r
SOURCES = {
    "modconv3x3": ("vtoonify_tpu_torch/csrc/modconv3x3.cu",
                   "vtoonify_tpu/ops/pallas_kernels.py:214"),
    "fused_leaky_relu": ("vtoonify_tpu_torch/csrc/fused_lrelu.cu",
                         "vtoonify_tpu/ops/pallas_kernels.py:44"),
    "upfirdn2d": ("vtoonify_tpu_torch/csrc/upfirdn2d.cu",
                  "vtoonify_tpu/ops/pallas_kernels.py:109"),
    "depth_to_space2": ("vtoonify_tpu_torch/csrc/d2s2.cu",
                        "vtoonify_tpu/ops/pallas_kernels.py:600"),
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


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main-path shapes


def kernel_cases(rng):
    """(kernel name, shape label, batch-1 per-frame?, make(dtype) -> (kernel
    fn, plain fn)) for every main-path shape."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.ops.upfirdn2d import make_kernel

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(np.float32))

    cases = []

    def conv_case(label, b, size, cin, cout, modulated):
        x = t(b, cin, size, size)
        w = t(3, 3, cin, cout, scale=1.0 / np.sqrt(9 * cin))
        s = t(b, cin, scale=0.5, shift=1.0) if modulated else None
        d = t(b, cout, scale=0.1, shift=1.0) if modulated else None
        bias = t(cout, scale=0.1)

        def make(dt, dev):
            a = [None if v is None else v.to(dev, dt) for v in (x, w, s, d, bias)]
            return lambda: K.modconv3x3(*a), lambda: K.modconv3x3_plain(*a)
        cases.append(("modconv3x3", label, b == 1, make))

    for size, cin, cout in CONV3X3:
        conv_case(f"conv {size}^2 {cin}->{cout}", 1, size, cin, cout, True)
        conv_case(f"conv {size}^2 {cin}->{cout} folded b4", 4, size, cin, cout, False)
    for size, cin, cout in UPCONV:
        conv_case(f"upconv {size}^2 {cin}->4*{cout}", 1, size, cin, 4 * cout, True)
        conv_case(f"upconv {size}^2 {cin}->4*{cout} folded b4", 4, size, cin,
                  4 * cout, False)

    for b, shape in [(1, (1, 512, 32, 32)), (4, (4, 512, 32, 32)), (1, (18, 512))]:
        x, bias = t(*shape), t(shape[1], scale=0.1)

        def make(dt, dev, x=x, bias=bias):
            a, c = x.to(dev, dt), bias.to(dev, dt)
            return (lambda: K.fused_leaky_relu(a, c),
                    lambda: K.fused_leaky_relu_plain(a, c))
        cases.append(("fused_leaky_relu", f"{tuple(shape)}", b == 1, make))

    k1 = make_kernel([1, 3, 3, 1]) * 2.0
    k2 = torch.outer(k1, k1)
    for b in (1, 4):
        for r in RGB_SKIP:
            x = t(b, 3, r, r)

            def make(dt, dev, x=x):
                a = x.to(dev, dt)
                args = (k2, (2, 2), (1, 1), (2, 1, 2, 1))
                return (lambda: K.upfirdn2d(a, *args),
                        lambda: K.upfirdn2d_plain(a, *args))
            cases.append(("upfirdn2d", f"upsample_2x ({b},3,{r},{r})", b == 1, make))

    for b in (1, 4):
        for size, _, cout in UPCONV:
            x = t(b, 4 * cout, size, size)

            def make(dt, dev, x=x):
                a = x.to(dev, dt)
                return (lambda: K.depth_to_space2(a, True),
                        lambda: K.depth_to_space2_plain(a, True))
            cases.append(("depth_to_space2", f"({b},{4 * cout},{size},{size}) "
                          "phase-minor", b == 1, make))
    return cases


def kernel_phase(dev):
    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for name in SOURCES}
    for name, label, per_frame, make in kernel_cases(np.random.RandomState(SEED)):
        for dtype in ("float32", "bfloat16"):
            kern, plain = make(getattr(torch, dtype), dev)
            got, want = kern().float(), plain().float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            rec = {"phase": "kernel", "kernel": name, "shape": label,
                   "dtype": dtype, "max_abs_err": err, "tol": TOL[dtype] * scale,
                   "finite": bool(torch.isfinite(got).all())}
            rec["ms"] = cuda_ms(kern, 10)
            rec["plain_ms"] = cuda_ms(plain, 10)
            if per_frame and dtype == "bfloat16":  # the serving dtype
                summary[name]["ms"] += rec["ms"]
                summary[name]["plain_ms"] += rec["plain_ms"]
            emit(rec)
            check(rec["finite"] and err <= rec["tol"],
                  f"{name} {label} {dtype}: max|kernel - plain| {err} > {rec['tol']}")
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
    return summary


# ---------------------------------------------------------------------------
# phases 3-6: the flagship pipeline


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 1: environment and kernel build
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
          "built_from_source": built,
          "build_and_load_s": time.perf_counter() - t0})

    # phase 2: kernels vs plain versions
    summary = kernel_phase(dev)

    # phase 3: the flagship pipeline in bf16 and f32
    t0 = time.perf_counter()
    cfg, vt_cpu, parsing_cpu = build_modules()
    vt_dev = copy.deepcopy(vt_cpu).to(dev)
    parsing_dev = copy.deepcopy(parsing_cpu).to(dev)
    pipe_bf16 = ToonifyPipeline(vt_dev, cfg, parsing_dev, dtype=torch.bfloat16)
    pipe_f32 = ToonifyPipeline(vt_dev, cfg, parsing_dev, dtype=torch.float32)
    emit({"phase": "build", "config": "VToonifyConfig() + BiSeNet",
          "params": sum(p.numel() for p in vt_cpu.parameters()),
          "bisenet_params": sum(p.numel() for p in parsing_cpu.parameters()),
          "seconds": time.perf_counter() - t0})

    # phase 4: serve a few requests through process_batch; count launches
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
          "fold_vs_unfold_mean_lsb": fold_vs_unfold.float().mean().item()})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    check(out4.float().std().item() > 10, "output image is flat")
    # the two style forms round bf16 at different places; a wrong fold or
    # modulation shows up as tens of LSB, not a fraction of one
    check(fold_vs_unfold.float().mean().item() < 4.0,
          "folded and unfolded style paths disagree")

    # phase 5: float32 card output vs the same modules on the CPU
    frame = frames4[:1]
    card = pipe_f32.process_batch(frame, s_w, 0.5).cpu()
    pipe_cpu = ToonifyPipeline(vt_cpu, cfg, parsing_cpu, dtype=torch.float32)
    t0 = time.perf_counter()
    host = pipe_cpu.process_batch(frame, s_w, 0.5)
    cpu_s = time.perf_counter() - t0
    diff = (card.int() - host.int()).abs().float()
    emit({"phase": "e2e_f32_vs_cpu", "max_lsb": diff.max().item(),
          "mean_lsb": diff.mean().item(), "bound_max_lsb": LSB_F32_MAX,
          "bound_mean_lsb": LSB_F32_MEAN, "cpu_seconds": cpu_s,
          "out_std_lsb": host.float().std().item()})
    check(diff.max().item() <= LSB_F32_MAX and diff.mean().item() <= LSB_F32_MEAN,
          "float32 card output differs from the CPU plain run beyond the bound")

    # phase 6: timing, bf16, 256 -> 1024, after warm-up
    for batch, reps in ((1, 20), (16, 5)):
        frames = np.resize(frames4, (batch, 256, 256, 3))
        for _ in range(2):
            pipe_bf16.process_batch(frames, s_w, 0.5)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pipe_bf16.process_batch(frames, s_w, 0.5)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        p25, p50, p75 = (float(v) for v in np.percentile(times, [25, 50, 75]))
        emit({"phase": "timing", "batch": batch, "dtype": "bfloat16",
              "in_px": 256, "out_px": 1024, "reps": reps,
              "p50_ms_per_call": p50 * 1e3, "p50_ms_per_frame": p50 * 1e3 / batch,
              "fps": batch / p50, "p25_p75_ms_per_call": [p25 * 1e3, p75 * 1e3],
              "min_max_ms_per_call": [min(times) * 1e3, max(times) * 1e3],
              "nvidia_smi": smi})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
