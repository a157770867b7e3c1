"""Chip smoke test of the PyTorch + CUDA port (vtoonify_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels upfirdn2d,depth_to_space2   # those alone
    python3 chip_smoke.py --kernels fused_leaky_relu,affine_warp
    python3 chip_smoke.py --paths   # serving, style + engine, pipeline
                                    # options, the HTTP server, bf16 training
                                    # (D stage 2, D stage 1, T stage 2)
    python3 chip_smoke.py --apps    # pipeline options, the HTTP server,
                                    # smoothing and the release gate alone
    python3 chip_smoke.py --raft    # RAFT training and evaluation alone
    python3 chip_smoke.py --reg     # the regularisers, full ADA and the
                                    # auxiliary models alone
    python3 chip_smoke.py --dist    # frame-parallel serving and
                                    # data-parallel training alone
    python3 chip_smoke.py --sp      # one frame split by rows alone
    python3 chip_smoke.py --tp      # tensor parallelism alone

Builds the port's five hand-written kernels from vtoonify_tpu_torch/csrc
with nvcc (sm_90a, one nvcc per source, in parallel), checks each against its
plain PyTorch version at every shape the main paths give it (forward in
float32 and bfloat16, backward in float32), then drives the two main paths
with random weights from a seeded torch.Generator:

* serve: the flagship VToonify-D frame graph (BiSeNet -> encoder -> fusion ->
  DualStyleGAN, 256 px -> 1024 px) behind ToonifyPipeline.process_batch,
  checked against the same modules on the CPU in float32, timed at batch 1
  and 16, and one call of each profiled (device busy share, B1's share);
* style_engine: style preparation (ToonifyPipeline.compute_style: the
  flagship pSp encoder with 18 styles, the mapping MLP, the exemplar
  splice from a bank of 3 random z+ codes) on the card against the CPU in
  float32 and timed in the bf16 pipeline; then the video engine
  (pipeline/video.py::toonify_frames) over in-memory 256 px frames at
  batch 16, held to process_batch on the same batches and timed beside it,
  with its stage breakdown (decode and encode are not part of it: frames
  come from memory and go to memory);
* pipeline_options: packed_output (its host finish and the packed video
  writer) bit-equal to the unpacked pipeline at batch 16, size_bucket and
  bucket_margin on the card against the CPU in float32, batch-16 fps
  packed and unpacked in turns, and the native host frame functions timed
  against their numpy versions;
* serve_http: the HTTP server (cli/serve.py, its pool of worker threads)
  over Model on reference-format random checkpoints at the flagship widths:
  its routes and error codes, and a synthetic 1024 px portrait POSTed 9
  times, each body byte-equal to cv2.imencode of Model.image_toonify; what
  a request pays on a thread new to the model, profiled;
* smooth_parsing: the parsing-map smoother (RAFT at the raft-things widths,
  BiSeNet, float32) one window card vs CPU, all-pairs vs alt (TF32 off),
  timed over videos at 256 px (16 frames) and 512 px (2) with both in its default
  TF32 and held to the CPU's float32 on one frame, then its CLI, whose maps
  feed the style-transfer CLI, held byte for byte to
  process_batch_with_parsing fed the same maps;
* release_gate: the release gate (cli/validate_release.py) at the --tiny
  widths on the card against goldens that the style-transfer CLI made on
  the CPU, a perturbed golden refused, and the inference playground;
* train: the flagship VToonify-D stage-2 training step (train_d_step:
  teacher synthesis with the augment, D step, G step with LPIPS and the
  temporal crop, EMA) at batch 2 in bfloat16 and float32, timed and
  profiled; and the trainer's --tiny configuration for one step on the card
  and on the CPU from the same modules and draws, compared;
* pretrain_d, pretrain_t, train_t: the flagship stage-1 steps of VToonify-D
  and VToonify-T at batch 8 and the VToonify-T stage-2 step at batch 2
  (blended G1, unconditional D), bf16, timed and profiled;
  train_tiny_vs_cpu: the --tiny D stage-1, T stage-2 and T stage-1 steps on
  the card against the CPU;
* train_cli: both trainer CLIs (cli/train_d.py, cli/train_t.py), both
  stages at --tiny on reference-format random files, with --export_pt and
  --resume; the exported checkpoints load in the pipeline and toonify;
* raft_train: RAFT training at the raft-things widths (models/raft_train.py):
  one step of both BN modes and both correlations on the card against the
  CPU and alt against all-pairs (TF32 off); upstream RAFT's train_standard.sh
  recipes timed and profiled on device-resident synthetic data (chairs:
  batch 10, 368 x 496, BN trained; things: batch 6, 400 x 720, BN frozen, in
  TF32 and under bf16 autocast); the trainer command over synthetic
  FlyingChairs / FlyingThings3D / Sintel trees (chairs, then things from its
  .ckpt) and the eval command (Sintel validation, a warm-started
  submission). RAFT launches none of the five kernels. The seed-9 step of
  tests/test_torch_cuda.py also runs card vs CPU in float64;
* regularise: each Function's second-order gradient against its plain
  version's at a main-path shape; R1 (through the full ADA augment at p =
  0.6) and the path-length penalty at 64 px card vs CPU; the full pSp at
  1024 px, VGG19 and ArcFace's id_loss card vs CPU; then one R1 D step
  (augment, D, d_r1_loss, backward, Adam) and one path-length G step
  (mixing_noise, g_path_regularize, backward, Adam) of the flagship
  StyleGAN2 at 1024 px, batch 4 (path batch 2), in rosinality
  stylegan2-pytorch's recipe, float32, timed and profiled; B5's second
  derivative in its coefficients against affine_warp_gather_plain;
* distributed: frame-parallel serving (ToonifyPipeline over a mesh of two
  replicas on cuda:0, bit-equal to one device, and over every visible
  card, timed beside one device at batch 16, bf16) and data-parallel
  training: the flagship D stage-2 step (bf16, global batch 2) without a
  process group and under a 1-rank NCCL group (bit-equal; timed, the
  all-reduce profiled), and over 2 gloo ranks with CUDA tensors sharing
  cuda:0 (this script started again as `--dist-rank R PORT DIR`, 1 row
  each), held to the 1-process step, with the --tiny T stage-2 step the
  same way;
* spatial: one frame split by rows (ToonifyPipeline over
  make_spatial_mesh: 2 and 4 slabs on cuda:0, and one per visible card),
  batch 1, the flagship: float32 against one device within SP_F32_*, bf16
  against one device within one device's own bf16-vs-float32 gap on the
  same frame, B1-B4 launched on the 2-slab path, and host p50 per call at
  256 and 1024 px in (1024 and 4096 px out) beside one device, with the
  halo copies and bytes per call and the peak memory per card;
* tp: tensor parallelism (the wide weights split over a 'tp' row,
  parallel/tensor.py): the flagship pipeline over make_mesh(devices=
  ["cuda:0"] * k, tp=k) for k = 2 and 4 (and over every visible card when
  there are 2 or more) at batch 1 and 16, float32 against one device within
  TP_F32_*, bf16 within one device's own bf16-vs-float32 gap on the same
  frames; B1-B4 launched on the tp-2 path; host p50 per call, the copies
  and bytes per call and the peak memory per card; then the flagship D
  stage-2 step (batch 2) over a tp-2 row on cuda:0 against no split, from
  the same state and draws, float32 gradients within TP_GRAD_REL_L2 and
  bf16 within the step's own bf16-vs-float32 gap, s/iter and peak memory
  at tp 1 and 2; the --tiny D stage-1 and T stage-2 steps at tp 2 against
  tp 1. B1, B2 and B4 run at the shard shapes in the kernel cases
  (`tp2 shard ...`, `tp4 shard ...`).

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
import gc
import json
import subprocess
import sys
import tempfile
import threading
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
# each parameter's elements whose |g| is above 1e-3 of its largest and above
# the noise floor 100 eps = 1e-6 (at least 5% of all elements)
STEP_RTOL = 2e-3
# compute_style, card vs CPU in float32 (TF32 off): relative L2 of s_w; pSp's
# 24 IR-SE units and the mapping MLP differ only in the order of float32 sums
STYLE_REL_L2 = 1e-4
# the engine's frames vs process_batch on the same batches: the same calls,
# but cuDNN may pick another algorithm for the ragged last batch
ENGINE_MAX_LSB = 1
# data-parallel steps against one process on the same global batch: relative
# L2 of the new parameters, the EMA and the metrics (float32 sums and the
# gradient mean over ranks in another order)
DIST_REL_L2 = 1e-5
# the gates on _dist_compare's readings: (key, "<=" or ">=", bound); "{k}"
# stands for the student's ("trainable") and D's ("d") parameters. The
# --tiny T step and the flagship D step's metrics and EMA in float32 are
# held to DIST_REL_L2. The flagship's gradients are not: a rank of one row
# rounds the teacher synthesis and every conv as batch 1, and the step's
# float32 gradients move by 1.4e-5-4.1e-5 relative L2 from that alone
# (the witness `synthesis_per_row`, one process; the H100 read the 2 ranks
# 3.7e-5 / 1.8e-5); in float64 on the CPU the 2 ranks equal one process
# (`python tests/_torch_parallel_worker.py witness DIR`: 3e-16, 1.4e-15).
# So their bounds are set at ~3x those readings, and each 2-rank gradient
# gap is held to DIST_WITNESS_RATIO x the larger witness's. The updates:
# every element within 2 lr; on the mask of tests/test_torch_train_step.py
# its element bounds (0.02 lr, 1% above 1e-3 lr) in float32, over at least
# 5% of the elements (the card-vs-CPU step gate's floor: only 12.4% of the
# student's and 10.4% of D's flagship elements have |g| > 100 eps, so the
# test's 25% cannot be reached). bf16: the gradients, the updates' 2 lr, the
# metrics and the EMA at ~3-10x their readings.
DIST_GATES = (
    *[(f"two_ranks_t_{r}", "<=", DIST_REL_L2)
      for r in ("metrics_rel_l2", "ema_rel_l2", "{k}_grad_rel_l2", "{k}_rel_l2")],
    ("two_ranks_t_{k}_max_err_over_lr", "<=", 2.001),
    *[(f"two_ranks_d_f32_{r}", "<=", DIST_REL_L2) for r in ("metrics_rel_l2", "ema_rel_l2")],
    ("two_ranks_d_f32_{k}_grad_rel_l2", "<=", 1e-4),
    ("two_ranks_d_f32_{k}_max_err_over_lr", "<=", 2.001),
    ("two_ranks_d_f32_{k}_masked_rel_l2", "<=", DIST_REL_L2),
    ("two_ranks_d_f32_{k}_masked_max_err_over_lr", "<=", 0.02),
    ("two_ranks_d_f32_{k}_masked_share_over_1e-3_lr", "<=", 1e-2),
    ("two_ranks_d_f32_mask_share", ">=", 0.05),
    *[(f"two_ranks_d_{r}", "<=", 5e-5) for r in ("metrics_rel_l2", "ema_rel_l2")],
    ("two_ranks_d_trainable_grad_rel_l2", "<=", 2e-2),
    ("two_ranks_d_d_grad_rel_l2", "<=", 0.1),
    ("two_ranks_d_{k}_max_err_over_lr", "<=", 2.001),
)
DIST_WITNESSES = ("rows_swapped", "synthesis_per_row")
DIST_WITNESS_RATIO = 3.0
DIST_BATCH, DIST_TINY_BATCH = 2, 4  # global batches: flagship D, --tiny T
DIST_DEADLINE_S = 400  # the 2-rank workers, from their start
# frame-parallel serving against one device at the whole batch: cuDNN picks
# other conv algorithms at batch 8 than at 16 (the encoder's and BiSeNet's
# bf16 convs round differently; the H100 read 4 LSB, mean 3.1e-4), so not
# bit-equal: bounded at that reading; against one device on the same 8
# frames, bit-equal
DP_SERVE_MAX_LSB, DP_SERVE_MEAN_LSB = 4, 1e-3
# one frame split by rows against one device, float32 at 256 px in: the same
# ops on row slabs with their halo rows; only the order of float32 sums
# differs (the global means summed over slabs, a slab's conv may take
# another cuDNN algorithm), which can move a value across one quantization
# step. bf16 is held to one device's own bf16-vs-float32 gap on the frame
SP_F32_MAX_LSB, SP_F32_MEAN_LSB = 1, 0.01
SP_SLABS_ON_CUDA0 = (2, 4)  # and a mesh of every visible card
SP_TIMED_PX, SP_REPS = (256, 1024), 5
# tensor parallelism against one device, float32 at 256 px in: each output
# channel is the same sum as in the whole layer, but a conv of Cout / tp
# channels may take another cuDNN algorithm or B1 tile order, which can move
# a value across one quantization step. bf16 is held to one device's own
# bf16-vs-float32 gap on the same frames. The D step over a tp-2 row: float32
# gradients to TP_GRAD_REL_L2 relative L2 per tree, or to DIST_WITNESS_RATIO
# x the same step's gap with its teacher synthesis a row at a time (other
# conv shapes, so other cuDNN algorithms: the H100 read 3.8e-5 / 1.4e-5 for
# tp 2, deterministic, and the per-row witness moves this step by as much,
# as it moves the 2-rank step of DIST_GATES); bf16 to the step's own
# bf16-vs-float32 gap
TP_F32_MAX_LSB, TP_F32_MEAN_LSB = 1, 0.01
TP_WIDTHS_ON_CUDA0 = (2, 4)  # and a row of every visible card
TP_BATCHES, TP_REPS = (1, 16), 5
TP_GRAD_REL_L2 = 1e-5
ENGINE_FRAMES, ENGINE_TIMED_FRAMES, ENGINE_BATCH, ENGINE_PX = 40, 160, 16, 256

# pipeline_options: batch-16 packed/unpacked at the 256 px serving crop, the
# packed file writer over 8 frames, and size bucketing of a 248 x 264 crop
OPTIONS_BATCH, OPTIONS_REPS, WRITER_FRAMES = 16, 3, 8
BUCKET_CROP, BUCKET, BUCKET_MARGIN = (248, 264), 64, 32
# serve_http: a synthetic 1024 px portrait upload (a 256 px crop, 1024 px
# out) to the style arcane1-d, warmed once and timed over 8 requests
PORTRAIT_PX, HTTP_STYLE, HTTP_TIMED = 1024, "arcane1-d", 8
# smooth_parsing: the reference's window 5 and 20 RAFT iterations; one
# window of 64 px frames card vs CPU, videos timed at 256 px (16 frames) and
# 512 px (2 frames: every frame fuses a whole window of 11, so the time per
# frame does not depend on the count); the CLI over 8 frames of 256 px. Card vs CPU and alt vs all-pairs on
# the smoothed maps: relative L2 within 1e-3 (float32 sums in another order
# through 20 GRU steps, and a validity mask binarized at 0.9999 that a
# rounding can flip at the border)
SMOOTH_WINDOW, SMOOTH_ITERS, SMOOTH_FRAMES = 5, 20, {256: 16, 512: 2}
SMOOTH_GATE_PX, SMOOTH_PX, CLI_PX, CLI_FRAMES = 64, (256, 512), 256, 8
SMOOTH_REL_L2 = 1e-3
# the timed 256 px maps in TF32 (the smoother's default) against the CPU's
# float32 map of one frame of the same video: relative L2 within 2e-3, 5x
# the 4.0e-4 that both corr impls read on an H100 (TF32 rounds each conv's
# and matmul's inputs to 10 mantissa bits, through 20 GRU steps)
SMOOTH_TF32_FRAME, SMOOTH_TF32_REL_L2 = 8, 2e-3
# release_gate: two release cases (D and T) at the trainer's --tiny widths
GATE_CASES = ["077436_vtoonify_d", "038648_vtoonify_t"]
# raft_train: RAFT at the raft-things widths. Gates (TF32 off): one step at
# (2, 3, 48, 64), 2 iterations, card vs CPU and alt vs all-pairs on the card:
# loss and EPE within 1e-4 relative, the accuracies within one pixel's share,
# the clipped gradients within 1e-2 relative L2 (at these 6 x 8 feature maps
# a few ReLU inputs sit within float32 rounding of zero, and each one that
# flips moves the gradient of whole tensors), the new params within 1e-4;
# AdamW's first update (about +-lr an element) within 2 lr everywhere and,
# on each tensor's elements whose |g| is above 1e-3 of its largest and 100
# eps (where |g| sits at the rounding noise its sign may differ; at least 5%
# of all), all but 0.1% of them within 0.02 lr and all but 1% within 1e-3 lr
# (a flipped ReLU can change single elements' gradients wholly); trained BN
# buffers within 1e-4, frozen ones unchanged. Timed: upstream RAFT's
# train_standard.sh recipes (name, batch, image size, BN trained, bf16
# autocast, lr, wdecay), 12 iterations; the CLIs over synthetic trees for
# RAFT_CLI_STEPS steps each
RAFT_GATE_SHAPE = (2, 48, 64)
RAFT_GATE_RTOL, RAFT_GATE_GRAD_REL_L2 = 1e-4, 1e-2
RAFT_GATE_PARAMS_REL_L2, RAFT_GATE_BN_ATOL = 1e-4, 1e-4
RAFT_ITERS, RAFT_TIMED_STEPS = 12, 5
RAFT_RECIPES = [("chairs", 10, (368, 496), True, False, 4e-4, 1e-4),
                ("things", 6, (400, 720), False, False, 1.25e-4, 1e-4),
                ("things_bf16", 6, (400, 720), False, True, 1.25e-4, 1e-4)]
RAFT_CLI_CHAIRS, RAFT_CLI_STEPS = 24, 4
# the seed-9 step of tests/test_torch_cuda.py::test_raft_train_step_card_vs_cpu
# also in float64, where float32 rounding (a ReLU input within it of zero
# that flips) vanishes and a real fault would not: gradients card vs CPU
# within 1e-8 relative L2 (float64 sums in another order)
RAFT_F64_SEED, RAFT_F64_GRAD_REL_L2 = 9, 1e-8
# regularise: rosinality stylegan2-pytorch train.py's recipe at config-f's
# 1024 px (4 a card): R1 gamma 10 every 16 D steps, path_regularize 2 every 4
# G steps on batch // path_batch_shrink, mixing 0.9; the ADA augment at p =
# 0.6 (AdaptiveAugment's target 0.6, length 500k, every 256); float32 with
# cuDNN's default TF32 convs, as upstream trains; 1 warm-up + REG_STEPS
# timed + 1 profiled step each, and 1 profiled with the convs' shapes. Gates (TF32 off): each Function's
# second-order gradient against its plain version's at backward_cases'
# shapes (TOL_GRAD; B5, whose adjoint's adjoint is its forward, TOL_WARP_F32:
# the coordinate rounding of the forward check); R1 (through the full ADA
# augment) and the path penalty at 64 px, batch 2, the flagship widths,
# card vs CPU from the same draws: the penalty within 1e-3 relative and
# the parameter gradients within 1e-3 relative L2 (float32 sums in another
# order through two backward passes; the train step's gradient bound); the
# full pSp (1024), VGG19 and ArcFace forwards card vs CPU within 1e-4
# relative L2 (STYLE_REL_L2: the same conv stacks in float32)
REG_BATCH, PATH_BATCH_SHRINK, MIXING, ADA_P = 4, 2, 0.9, 0.6
R1_GAMMA, D_REG_EVERY, PATH_REGULARIZE, G_REG_EVERY = 10.0, 16, 2.0, 4
REG_STEPS, REG_GATE_PX, REG_GATE_BATCH = 3, 64, 2
REG_GATE_RTOL, REG_GATE_GRAD_REL_L2, AUX_REL_L2 = 1e-3, 1e-3, 1e-4
TINY_VT = dict(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)

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


class Drawn:
    """A float32 normal draw of `shape` times `scale` plus `shift`, made on
    the card from its own seed each time a case asks for it (`.to(dev,
    dtype)`): the cases' inputs are never all held at once, and drawing
    their ~2e9 values on the host would take longer than the phase's
    timing."""

    def __init__(self, shape, scale, shift, seed):
        self.shape, self.scale, self.shift, self.seed = shape, scale, shift, seed

    def to(self, dev, dtype):
        g = torch.Generator(device=dev).manual_seed(self.seed)
        x = torch.randn(self.shape, generator=g, device=dev)
        return (x * self.scale + self.shift).to(dtype)


def kernel_cases(seed, dev):
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.ops.upfirdn2d import make_kernel
    from vtoonify_tpu_torch.train import augment as A

    seeds = iter(range(seed * 100_000, (seed + 1) * 100_000))

    def t(*shape, scale=1.0, shift=0.0):
        return Drawn(shape, scale, shift, next(seeds))

    def nbytes(dt, *ts):
        es = torch.finfo(dt).bits // 8
        return es * sum(x.numel() for x in ts if x is not None)

    cases = []

    def conv_case(label, b, size, cin, cout, modulated, act, summary=False):
        h, w_px = (size, size) if isinstance(size, int) else size
        x = t(b, cin, h, w_px)
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
                    2 * 9 * cin * cout * h * w_px * b)
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
    # spatial: a slab of the 1024 px conv and of the 512 -> 1024 up conv over
    # 2 slabs, each with one halo row a side
    conv_case("sp2 slab conv 514x1024 32->32", 1, (514, 1024), 32, 32, True, True)
    conv_case("sp2 slab upconv 258x512 64->4*32", 1, (258, 512), 64, 128, True, True)
    # tensor parallelism: a shard of the 512- and 256-wide convs and up convs
    # (Cout / tp output channels; the up conv's 4 phases per channel)
    for k in (2, 4):
        conv_case(f"tp{k} shard conv 64^2 512->{512 // k}", 1, 64, 512, 512 // k, True, True)
        conv_case(f"tp{k} shard conv 64^2 512->{512 // k} folded b16", 16, 64, 512,
                  512 // k, False, True)
        conv_case(f"tp{k} shard conv 128^2 256->{256 // k}", 1, 128, 256, 256 // k,
                  True, True)
        conv_case(f"tp{k} shard teacher conv 64^2 512->{512 // k} raw b2", 2, 64, 512,
                  512 // k, True, False)
        conv_case(f"tp{k} shard upconv 32^2 512->4*{512 // k}", 1, 32, 512,
                  4 * 512 // k, True, True)
        conv_case(f"tp{k} shard upconv 64^2 512->4*{256 // k}", 1, 64, 512,
                  4 * 256 // k, True, True)

    for shape, summary in [((1, 512, 32, 32), True), ((4, 512, 32, 32), False),
                           ((18, 512), True), ((2, 512, 64, 64), False),
                           ((1, 512, 16, 32), False),  # a slab of 2 (spatial)
                           # shards of 2 and 4 ('tp'): the teacher's noisy
                           # 512-wide convs, a wide linear
                           ((2, 256, 64, 64), False), ((2, 128, 64, 64), False),
                           ((18, 256), False),
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
    fir_case("sp2 slab upsample_2x (1,3,258,512) pads (2,1,0,-1)", (1, 3, 258, 512),
             k_up, (2, 2), (1, 1), (2, 1, 0, -1))
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

    for b, shapes in ((1, UPCONV), (2, UPCONV), (4, UPCONV), (2, CROP_UPCONV),
                      (1, [((258, 512), None, 32)]),  # a slab of 2 (spatial)
                      # shards of 2 and 4 ('tp') of the 32 and 64 px up convs
                      (1, [(32, None, 256), (32, None, 128), (64, None, 128),
                           (64, None, 64)])):
        for size, _, cout in shapes:
            h, w_px = (size, size) if isinstance(size, int) else size
            x = t(b, 4 * cout, h, w_px)

            def make(dt, x=x):
                a = x.to(dev, dt)
                return (lambda: K.depth_to_space2(a, True),
                        lambda: K.depth_to_space2_plain(a, True),
                        lambda: F.pixel_shuffle(a, 2), (2 * nbytes(dt, a), 0))
            cases.append(Case("depth_to_space2", f"({b},{4 * cout},{h},{w_px}) "
                              "phase-minor", make, b == 1 and h == w_px))

    # B5 at the flagship augment: (2, 6, 4120, 4120) -> (2, 6, 2060, 2060)
    gen = torch.Generator().manual_seed(SEED)
    img = torch.tanh(torch.randn((2, 6, AUG, AUG), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED)))
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


def backward_cases(seed, dev):
    """(kernel, label, kernel fn, plain fn, inputs, second-order plain fn
    or None): each Function's gradients on the card vs torch.autograd
    through the plain version, at one main-path shape, float32. B5's second
    order is held to its gather form (torch 2.11 cannot differentiate
    F.grid_sample twice); None: the plain fn."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.ops.upfirdn2d import make_kernel
    from vtoonify_tpu_torch.train import augment as A

    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device=dev) * scale + shift

    k1 = make_kernel([1, 3, 3, 1])
    k_blur = torch.outer(k1, k1)
    theta, out_hw = A.warp_theta(torch.eye(3).repeat(2, 1, 1), (1024, 1024), (AUG, AUG))
    theta[:, :, :2] = theta[:, :, :2] * 1.07
    coef = A._pixel_affine_coefs(theta, out_hw, (AUG, AUG)).to(dev).contiguous()
    return [
        ("modconv3x3", "conv 64^2 512->512 modulated + act",
         K.modconv3x3, K.modconv3x3_plain,
         (t(1, 512, 64, 64), t(3, 3, 512, 512, scale=1 / 68), t(1, 512, shift=1.0),
          t(1, 512, scale=0.1, shift=1.0), t(512, scale=0.1)), None),
        ("modconv3x3", "tp2 shard conv 64^2 512->256 modulated + act",
         K.modconv3x3, K.modconv3x3_plain,
         (t(1, 512, 64, 64), t(3, 3, 512, 256, scale=1 / 68), t(1, 512, shift=1.0),
          t(1, 256, scale=0.1, shift=1.0), t(256, scale=0.1)), None),
        ("modconv3x3", "tp4 shard upconv 32^2 512->4*128 modulated + act",
         K.modconv3x3, K.modconv3x3_plain,
         (t(1, 512, 32, 32), t(3, 3, 512, 512, scale=1 / 68), t(1, 512, shift=1.0),
          t(1, 512, scale=0.1, shift=1.0), t(512, scale=0.1)), None),
        ("fused_leaky_relu", "tp2 shard (2,256,64,64)", K.fused_leaky_relu,
         K.fused_leaky_relu_plain, (t(2, 256, 64, 64), t(256)), None),
        ("depth_to_space2", "tp2 shard (1,1024,32,32) phase-minor",
         lambda x: K.depth_to_space2(x, True),
         lambda x: K.depth_to_space2_plain(x, True), (t(1, 1024, 32, 32),), None),
        ("fused_leaky_relu", "(2,512,64,64)", K.fused_leaky_relu,
         K.fused_leaky_relu_plain, (t(2, 512, 64, 64), t(512)), None),
        ("upfirdn2d", "D blur (2,128,256,256) pad 2",
         lambda x: K.upfirdn2d(x, k_blur, (1, 1), (1, 1), (2, 2, 2, 2)),
         lambda x: K.upfirdn2d_plain(x, k_blur, (1, 1), (1, 1), (2, 2, 2, 2)),
         (t(2, 128, 256, 256),), None),
        ("depth_to_space2", "(1,1024,64,64) phase-minor",
         lambda x: K.depth_to_space2(x, True),
         lambda x: K.depth_to_space2_plain(x, True), (t(1, 1024, 64, 64),), None),
        ("affine_warp", f"(2,6,{AUG},{AUG}) scaled affine",
         lambda x: K.affine_warp(x, coef, out_hw),
         lambda x: K.affine_warp_plain(x, coef, out_hw),
         (torch.tanh(t(2, 6, AUG, AUG)),),
         lambda x: K.affine_warp_gather_plain(x, coef, out_hw)),
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
    for case in kernel_cases(SEED, dev):
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

    for name, label, kern, plain, inputs, _ in backward_cases(1, dev):
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
        summary[name]["backward_max_rel_err"] = max(
            summary[name].get("backward_max_rel_err", 0.0), max(errs))
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
# style_engine: style preparation and the video engine


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def style_engine_phase(smi):
    """compute_style at the flagship pSp (18 styles) with an exemplar bank
    of 3 random z+ codes, card vs CPU in float32 and timed in the bf16
    pipeline; the video engine over in-memory frames, held to process_batch
    and timed beside it. Returns the launches counted over the style timing
    calls and the engine's gated run."""
    from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig, init_psp_encoder
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.pipeline import video
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
    from vtoonify_tpu_torch.utils.profiling import StageTimer

    t0 = time.perf_counter()
    cfg, vt_cpu, parsing_cpu = build_modules()
    g = torch.Generator().manual_seed(SEED + 2)
    pcfg = PSPEncoderConfig(n_styles=cfg.n_latent)  # 18
    psp_cpu = init_psp_encoder(pcfg, g)
    latent_avg = torch.randn((pcfg.n_styles, 512), generator=g) * 0.3
    bank = [torch.randn((1, cfg.n_latent, 512), generator=g) * 0.3 for _ in range(3)]
    style = dict(psp_params=psp_cpu, psp_cfg=pcfg, latent_avg=latent_avg,
                 exstyle=bank[1])
    rng = np.random.RandomState(SEED + 2)
    face = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    pipe = ToonifyPipeline(vt_cpu, cfg, parsing_cpu, dtype=torch.bfloat16, **style)
    check(pipe.psp.input_conv.weight.device.type == "cuda"
          and pipe.psp.input_conv.weight.dtype == torch.float32,
          "the bf16 pipeline's pSp encoder is not float32 on the card")
    setup_s = time.perf_counter() - t0

    # style timing, bf16 pipeline (style preparation runs in float32)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    first_ms, s_w = _sync_ms(lambda: pipe.compute_style(face))
    warm = [_sync_ms(lambda: pipe.compute_style(face))[0] for _ in range(10)]
    launches_style = K.launch_counts()
    check(launches_style["fused_leaky_relu"] > 0,
          "compute_style did not launch B2 (the mapping MLP's fused_lrelu)")
    prof = device_profile(lambda: pipe.compute_style(face), "style_profile.txt")
    # the same with TF32 for cuDNN's convs, torch's default and the CLI's
    # without --fp32 (the gates below run with TF32 off)
    torch.backends.cudnn.allow_tf32 = True
    try:
        pipe.compute_style(face)
        warm_tf32 = [_sync_ms(lambda: pipe.compute_style(face))[0] for _ in range(10)]
        s_w_tf32 = pipe.compute_style(face)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    style_rec = {"phase": "style", "config": "pSp (18 styles) + the flagship "
                 "mapping MLP, exemplar bank of 3 random z+ codes",
                 "first_call_ms": first_ms, "warm_median_ms": float(np.median(warm)),
                 "warm_min_max_ms": [min(warm), max(warm)],
                 "warm_median_ms_tf32": float(np.median(warm_tf32)),
                 "tf32_rel_l2": ((s_w_tf32 - s_w).norm() / s_w.norm()).item(),
                 "launches": launches_style, "tf32": False,
                 "profile": {k: prof[k] for k in ("wall_s", "device_busy_s",
                                                  "device_busy_share", "top_device_ops")},
                 "nvidia_smi": smi}

    # style gate: card vs CPU, float32, with and without color transfer
    pipe_f32 = ToonifyPipeline(vt_cpu, cfg, parsing_cpu, dtype=torch.float32, **style)
    pipe_cpu = ToonifyPipeline(vt_cpu, cfg, parsing_cpu, dtype=torch.float32,
                               device="cpu", **style)
    errs = {}
    for color in (False, True):
        card, host = (p.compute_style(face, color).cpu() for p in (pipe_f32, pipe_cpu))
        errs[f"color_transfer={color}"] = ((card - host).norm() / host.norm()).item()
        n = cfg.n_latent if color else 7
        check(tuple(card.shape) == (1, cfg.n_latent, 512) and torch.isfinite(card).all(),
              f"compute_style gave {tuple(card.shape)}")
        check(torch.equal(card[:, :n], pipe_f32.exstyle_w[:, :n].cpu()),
              f"the exemplar splice (layers :{n}) is not exemplar_w's")
    exw_err = ((pipe_f32.exstyle_w.cpu() - pipe_cpu.exstyle_w).norm()
               / pipe_cpu.exstyle_w.norm()).item()
    style_rec.update(rel_l2_card_vs_cpu=errs, exstyle_w_rel_l2=exw_err,
                     bound_rel_l2=STYLE_REL_L2)
    emit(style_rec)
    check(max(*errs.values(), exw_err) <= STYLE_REL_L2,
          f"compute_style card vs CPU: relative L2 {errs}, exstyle_w {exw_err}")
    del pipe_f32, pipe_cpu
    torch.cuda.empty_cache()

    # engine gate: 40 frames at batch 16 (16, 16, 8), against process_batch
    frames = rng.randint(0, 256, (ENGINE_TIMED_FRAMES, ENGINE_PX, ENGINE_PX, 3)
                         ).astype(np.uint8)

    def engine(n, writer, timer=None):
        return video.toonify_frames(
            pipe, ((25.0, f) for f in frames[:n]), lambda fps, size: writer,
            scale_image=False, batch_size=ENGINE_BATCH, max_in_flight=3, s_w=s_w,
            timer=timer)

    t1 = time.perf_counter()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    kept = video.MemoryWriter()
    result = engine(ENGINE_FRAMES, kept)
    torch.cuda.synchronize()
    launches_engine = K.launch_counts()
    check(result.frames_written == len(kept.frames) == ENGINE_FRAMES,
          f"engine wrote {result.frames_written} frames, want {ENGINE_FRAMES}")
    out_shape = (4 * ENGINE_PX, 4 * ENGINE_PX, 3)
    check(all(f.shape == out_shape and f.dtype == np.uint8 for f in kept.frames),
          f"engine frames are not {out_shape} uint8")
    for name in ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"):
        check(launches_engine[name] > 0, f"kernel {name} was not launched by the engine")
    lsb_max, lsb_sum = 0, 0.0
    for i in range(0, ENGINE_FRAMES, ENGINE_BATCH):
        want = pipe.process_batch(frames[i:min(i + ENGINE_BATCH, ENGINE_FRAMES)],
                                  s_w, 0.5).cpu().numpy()
        got = np.stack(kept.frames[i:i + len(want)])
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        lsb_max, lsb_sum = max(lsb_max, int(d.max())), lsb_sum + float(d.sum())
    lsb_mean = lsb_sum / (ENGINE_FRAMES * np.prod(out_shape))
    out_std = float(np.std(kept.frames[0]))
    del kept
    emit({"phase": "engine", "frames": ENGINE_FRAMES, "batch": ENGINE_BATCH,
          "max_in_flight": 3, "batches": [16, 16, 8], "launches": launches_engine,
          "max_lsb_vs_process_batch": lsb_max, "mean_lsb_vs_process_batch": lsb_mean,
          "bound_max_lsb": ENGINE_MAX_LSB, "out_std_lsb": out_std,
          "seconds": time.perf_counter() - t1})
    check(lsb_max <= ENGINE_MAX_LSB, f"engine frames differ from process_batch "
          f"by {lsb_max} LSB")
    check(out_std > 10, "engine output frame is flat")

    # engine timing: 160 frames at batch 16, beside process_batch at batch 16
    engine(2 * ENGINE_BATCH, video.MemoryWriter(keep=False))  # warm-up
    walls, stages = [], None
    for _ in range(3):
        timer = StageTimer()
        wall_ms, res = _sync_ms(lambda: engine(ENGINE_TIMED_FRAMES,
                                               video.MemoryWriter(keep=False), timer))
        check(res.frames_written == ENGINE_TIMED_FRAMES, "engine lost frames")
        walls.append(wall_ms / 1e3)
        stages = res.stages
    batch16 = frames[:ENGINE_BATCH]
    pb = [_sync_ms(lambda: pipe.process_batch(batch16, s_w, 0.5))[0] / 1e3
          for _ in range(6)][1:]
    emit({"phase": "engine_timing", "frames": ENGINE_TIMED_FRAMES,
          "batch": ENGINE_BATCH, "max_in_flight": 3, "dtype": "bfloat16",
          "engine_fps_runs": [ENGINE_TIMED_FRAMES / w for w in walls],
          "engine_fps_median": ENGINE_TIMED_FRAMES / float(np.median(walls)),
          "process_batch_fps_median": ENGINE_BATCH / float(np.median(pb)),
          "process_batch_fps_runs": [ENGINE_BATCH / t for t in pb],
          "stages_last_run": stages,
          "excludes": "decode and encode: in-memory frames in, in-memory "
                      "frames out (no cv2)",
          "nvidia_smi": smi, "setup_seconds": setup_s,
          "seconds": time.perf_counter() - t0})
    del pipe
    torch.cuda.empty_cache()
    return {k: launches_style[k] + launches_engine[k] for k in launches_engine}


# ---------------------------------------------------------------------------
# inference apps: pipeline options, the HTTP server, parsing-map smoothing
# and the release gate


def synthetic_frames(seed, n, px, step=(1, 2)):
    """n seeded (px, px, 3) uint8 frames of one smooth random image that
    moves `step` (rows, columns) pixels a frame, with pixel noise: something
    for RAFT to follow and for the face crop to cut."""
    import cv2

    rng = np.random.RandomState(seed)
    side = px + max(step) * n
    base = cv2.resize(rng.randint(0, 256, (24, 24, 3)).astype(np.uint8), (side, side),
                      interpolation=cv2.INTER_LINEAR)
    out = []
    for i in range(n):
        y, x = step[0] * i, step[1] * i
        noise = rng.randint(-12, 13, (px, px, 3))
        out.append(np.clip(base[y:y + px, x:x + px].astype(np.int16) + noise, 0, 255)
                   .astype(np.uint8))
    return np.stack(out)


def portrait_landmarks(px=PORTRAIT_PX):
    """68 landmarks for a synthetic px-square portrait: eyes px/4 apart at
    43% height, so the crop rescales by 256/px into a 256 x 256 crop (1024
    px out), the serving size."""
    lm = np.zeros((68, 2), np.float32)
    lm[0:17] = np.stack([np.linspace(0.2, 0.8, 17),
                         0.49 + 0.25 * np.sin(np.linspace(0, np.pi, 17))], axis=1)
    lm[36:42] = [0.375, 0.43]
    lm[42:48] = [0.625, 0.43]
    lm[27:36] = [0.5, 0.55]
    lm[48:68] = [0.5, 0.66]
    lm[48], lm[54] = [0.42, 0.66], [0.58, 0.66]
    return lm * px


def write_serving_zoo(root, g):
    """Model's checkpoint layout for the style arcane1-d at the flagship
    widths, random weights: VToonify-D at VToonifyConfig() (build_modules'
    modules, through the port's save_reference_checkpoint), BiSeNet, pSp with
    18 styles and its latent_avg, a one-style exemplar bank, and the
    synthetic portrait's landmarks (landmarks.npy; landmarks_cli.npy for
    the smoother's CLI_PX frames)."""
    from vtoonify_tpu_torch.convert.torch_export import save_reference_checkpoint
    from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig, init_psp_encoder

    cfg, vt, parsing = build_modules()
    style_dir = root / "vtoonify_d_arcane"
    style_dir.mkdir(parents=True, exist_ok=True)
    save_reference_checkpoint(str(style_dir / "vtoonify_s_d.pt"), vt, cfg)
    torch.save(bisenet_reference_state(parsing), str(root / "faceparsing.pth"))
    psp = init_psp_encoder(PSPEncoderConfig(n_styles=cfg.n_latent), g)
    torch.save({"state_dict": psp_reference_state(psp),
                "latent_avg": torch.randn((cfg.n_latent, 512), generator=g) * 0.3},
               str(root / "encoder.pt"))
    np.save(str(style_dir / "exstyle_code.npy"),
            {"style0.png": (torch.randn((1, cfg.n_latent, 512), generator=g) * 0.3).numpy()},
            allow_pickle=True)
    np.save(str(root / "landmarks.npy"), portrait_landmarks())
    np.save(str(root / "landmarks_cli.npy"), portrait_landmarks(CLI_PX))
    return cfg


def pipeline_options_phase(smi):
    """packed_output, its host finish and the packed video writer against
    the unpacked pipeline (bit-equal, the same mp4 bytes); size_bucket and
    bucket_margin on the card against the CPU in float32; batch-16 fps
    packed and unpacked, in turns; the host frame functions, C++ against
    numpy. Returns the launches of the packed batch-16 call."""
    import os
    import tempfile

    import cv2

    from vtoonify_tpu_torch import native
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.pipeline import video
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    t0 = time.perf_counter()
    check(native.backend() == "native", "the native frame library did not load")
    cfg, vt_cpu, parsing_cpu = build_modules()
    plain = ToonifyPipeline(vt_cpu, cfg, parsing_cpu)
    packed = ToonifyPipeline(vt_cpu, cfg, parsing_cpu, packed_output=True)
    rng = np.random.RandomState(SEED + 7)
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    frames = rng.randint(0, 256, (OPTIONS_BATCH, 256, 256, 3)).astype(np.uint8)

    torch.cuda.synchronize()
    K.reset_launch_counts()
    got = packed.process_batch(frames, s_w, 0.5).cpu().numpy()
    launches = K.launch_counts()
    want = plain.process_batch(frames, s_w, 0.5).cpu().numpy()
    check(got.shape == (OPTIONS_BATCH, 512, 512, 12) and got.dtype == np.uint8,
          f"packed output {got.shape} {got.dtype}")
    check(want.shape == (OPTIONS_BATCH, 1024, 1024, 3), f"unpacked output {want.shape}")
    unpack_equal = all(np.array_equal(ToonifyPipeline.unpack_frame(got[k]), want[k])
                       for k in range(OPTIONS_BATCH))
    unpack_bgr_equal = np.array_equal(ToonifyPipeline.unpack_frame(got[0], bgr=True),
                                      want[0][..., ::-1])
    out_std = float(want.std())
    for name in ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"):
        check(launches[name] > 0, f"kernel {name} was not launched by the packed pipeline")

    # the file writer: a packed and an unpacked pipeline write the same mp4
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.mp4")
        w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (256, 256))
        for f in frames[:WRITER_FRAMES]:
            w.write(f)
        w.release()
        written = {}
        for name, pipe in (("packed", packed), ("plain", plain)):
            out = os.path.join(tmp, f"{name}.mp4")
            res = video.toonify_video(pipe, src, out, scale_image=False, s_w=s_w,
                                      batch_size=4)
            check(res.frames_written == WRITER_FRAMES,
                  f"{name} writer wrote {res.frames_written} frames")
            written[name] = Path(out).read_bytes()
    writer_equal = written["packed"] == written["plain"]

    # size bucketing, float32, card vs CPU on the same crop
    crop = synthetic_frames(SEED + 7, 1, max(BUCKET_CROP))[:, :BUCKET_CROP[0], :BUCKET_CROP[1]]
    bucketed = {}
    for margin in (0, BUCKET_MARGIN):
        kw = dict(dtype=torch.float32, size_bucket=BUCKET, bucket_margin=margin)
        card = ToonifyPipeline(vt_cpu, cfg, parsing_cpu, **kw).process_batch(
            crop, s_w, 0.5).cpu().numpy()
        host = ToonifyPipeline(vt_cpu, cfg, parsing_cpu, device="cpu", **kw).process_batch(
            crop, s_w, 0.5).numpy()
        d = np.abs(card.astype(np.int16) - host.astype(np.int16))
        padded = [-(-(s + 2 * margin) // BUCKET) * BUCKET for s in BUCKET_CROP]
        bucketed[f"margin_{margin}"] = {
            "shape": list(card.shape), "padded_to": padded, "max_lsb": int(d.max()),
            "mean_lsb": float(d.mean()), "out_std_lsb": float(host.std())}
        check(card.shape == host.shape == (1, 4 * BUCKET_CROP[0], 4 * BUCKET_CROP[1], 3),
              f"bucketed output {card.shape}, CPU {host.shape}, want the exact crop's")
        check(d.max() <= LSB_F32_MAX and d.mean() <= LSB_F32_MEAN,
              f"bucketed (margin {margin}) card vs CPU: max {d.max()} mean {d.mean()} LSB")

    # timing: batch 16, packed and unpacked in turns; on the device alone
    # (process_batch + synchronize) and to host BGR frames as the file
    # writer gets them (+ the copy to the host + each frame's finish)
    finish = {"plain": native.rgb_to_bgr,
              "packed": lambda f: native.depth_to_space2_u8(f, bgr=True)}
    pipes = {"plain": plain, "packed": packed}

    def device_call(name):
        return lambda: pipes[name].process_batch(frames, s_w, 0.5)

    def to_host(name):
        """ms of process_batch + the copy to the host, and of the 16
        frames' finish after it."""
        t1 = time.perf_counter()
        host = pipes[name].process_batch(frames, s_w, 0.5).cpu().numpy()
        t2 = time.perf_counter()
        for f in host:
            finish[name](f)
        return (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3

    for name in pipes:
        for _ in range(2):
            to_host(name)
    dev_ms = {name: [] for name in pipes}
    host_ms_ = {name: [] for name in pipes}
    copy_ms = {name: [] for name in pipes}
    finish_ms = {name: [] for name in pipes}
    for _ in range(OPTIONS_REPS):
        for name in ("plain", "packed", "packed", "plain"):
            dev_ms[name].append(_sync_ms(device_call(name))[0])
            torch.cuda.synchronize()
            c, f = to_host(name)
            copy_ms[name].append(c)
            finish_ms[name].append(f)
            host_ms_[name].append(c + f)
    fin_ms = {name: host_ms(lambda: finish[name](h), 20) for name, h in
              (("plain", want[0]), ("packed", got[0]))}
    native_vs_numpy = frameio_native_vs_numpy(want[0], got[0])
    emit({"phase": "pipeline_options", "batch": OPTIONS_BATCH, "dtype": "bfloat16",
          "in_px": 256, "packed_shape": list(got.shape),
          "unpack_frame_equal": unpack_equal, "unpack_frame_bgr_equal": unpack_bgr_equal,
          "writer_mp4_equal": writer_equal, "writer_frames": WRITER_FRAMES,
          "bucket": BUCKET, "crop": list(BUCKET_CROP), "bucketed_f32_card_vs_cpu": bucketed,
          "bound_max_lsb": LSB_F32_MAX, "bound_mean_lsb": LSB_F32_MEAN,
          "launches": launches, "out_std_lsb": out_std,
          "device_fps_median": {k: OPTIONS_BATCH * 1e3 / float(np.median(v))
                                for k, v in dev_ms.items()},
          "to_host_bgr_fps_median": {k: OPTIONS_BATCH * 1e3 / float(np.median(v))
                                     for k, v in host_ms_.items()},
          "device_ms_runs": dev_ms, "to_host_bgr_ms_runs": host_ms_,
          "to_host_copy_ms_runs": copy_ms, "finish_16_frames_ms_runs": finish_ms,
          "host_finish_ms_per_frame": fin_ms,
          "frameio_native_vs_numpy_ms": native_vs_numpy,
          "nvidia_smi": smi, "seconds": time.perf_counter() - t0})
    check(unpack_equal and unpack_bgr_equal,
          "unpack_frame of the packed output differs from the unpacked output")
    check(writer_equal, "the packed writer's mp4 differs from the unpacked one's")
    check(out_std > 10, "output image is flat")
    del plain, packed
    torch.cuda.empty_cache()
    return launches


def frameio_native_vs_numpy(frame, packed_frame, reps=20, rounds=3):
    """ms of the host's frame I/O a 1024 px frame: native.rgb_to_bgr and
    native.depth_to_space2_u8(bgr=True), the C++ library against the numpy
    versions (VTOONIFY_NO_NATIVE=1), in turns; medians of `reps` calls a
    turn, and their median over the turns."""
    import os

    from vtoonify_tpu_torch import native

    fns = {"rgb_to_bgr": lambda: native.rgb_to_bgr(frame),
           "depth_to_space2_u8_bgr": lambda: native.depth_to_space2_u8(packed_frame, bgr=True)}
    runs = {name: {"native": [], "numpy": []} for name in fns}
    try:
        for _ in range(rounds):
            for impl in ("native", "numpy", "numpy", "native"):
                os.environ["VTOONIFY_NO_NATIVE"] = "1" if impl == "numpy" else "0"
                check(native.backend() == impl, f"native.backend() is not {impl}")
                for name, fn in fns.items():
                    fn()
                    times = []
                    for _ in range(reps):
                        t1 = time.perf_counter()
                        fn()
                        times.append((time.perf_counter() - t1) * 1e3)
                    runs[name][impl].append(float(np.median(times)))
    finally:
        os.environ.pop("VTOONIFY_NO_NATIVE", None)
    return {name: {**{impl: float(np.median(v)) for impl, v in r.items()}, "turns": r}
            for name, r in runs.items()}


def serve_http_phase(smi, root):
    """cli/serve.py's server over Model (the card) on the serving zoo in
    `root`: its routes and error codes, then the synthetic 1024 px portrait
    POSTed once to warm and HTTP_TIMED times, each body byte-equal to
    cv2.imencode of Model.image_toonify on the same upload. Returns the
    launches of the timed requests."""
    import http.client

    import cv2

    from vtoonify_tpu_torch.cli import serve
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.pipeline.model_api import Model

    t0 = time.perf_counter()
    model = Model(checkpoint_root=str(root), landmarks=str(root / "landmarks.npy"))
    server = serve.build_server(model, "127.0.0.1", 0, default_style=HTTP_STYLE)
    thread = serve.serve_forever_in_thread(server)
    port = server.server_address[1]

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    portrait = synthetic_frames(SEED + 6, 1, PORTRAIT_PX)[0]
    ok, jpg = cv2.imencode(".jpg", cv2.cvtColor(portrait, cv2.COLOR_RGB2BGR))
    check(ok, "cv2 could not encode the portrait")
    upload = jpg.tobytes()
    url = f"/toonify?style_type={HTTP_STYLE}&style_degree=0.5"
    try:
        status, styles = request("GET", "/styles")
        check(status == 200 and HTTP_STYLE in json.loads(styles),
              f"/styles answered {status}")
        codes = {"unknown style": request("POST", "/toonify?style_type=nope", upload)[0],
                 "empty body": request("POST", url, b"")[0],
                 "unknown path": request("GET", "/nope")[0]}
        check(codes == {"unknown style": 400, "empty body": 400, "unknown path": 404},
              f"error codes {codes}")
        t1 = time.perf_counter()
        status, first = request("POST", url, upload)
        first_ms = (time.perf_counter() - t1) * 1e3
        check(status == 200, f"first request: {status} {first[:200]!r}")
        # the handler's two Model calls, timed inside the server's thread
        inner = collections.defaultdict(list)

        def timed(name, fn):
            def call(*args, **kw):
                t = time.perf_counter()
                out = fn(*args, **kw)
                inner[name].append((time.perf_counter() - t) * 1e3)
                return out
            return call

        model.detect_and_align_frame = timed("crop_align", model.detect_and_align_frame)
        model.image_toonify = timed("style_and_frame", model.image_toonify)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        times, bodies = [], []
        for _ in range(HTTP_TIMED):
            t1 = time.perf_counter()
            status, body = request("POST", url, upload)
            times.append((time.perf_counter() - t1) * 1e3)
            check(status == 200, f"request: {status} {body[:200]!r}")
            bodies.append(body)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        del model.detect_and_align_frame, model.image_toonify
        # the HTTP round trip alone: an upload of the same size that the
        # server reads and refuses at cv2.imdecode (400)
        junk = bytes(len(upload))
        transport = []
        for _ in range(5):
            t1 = time.perf_counter()
            status = request("POST", url, junk)[0]
            transport.append((time.perf_counter() - t1) * 1e3)
            check(status == 400, f"an undecodable upload answered {status}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the server thread did not stop")

    # the same upload through Model in process, as the server decodes it
    bgr = cv2.imdecode(np.frombuffer(upload, np.uint8), cv2.IMREAD_COLOR)
    frame, aligned, msg = model.detect_and_align_frame(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    check(msg == "Success", f"detect_and_align_frame: {msg}")
    want = model.image_toonify(frame, aligned, style_degree=0.5, style_type=HTTP_STYLE)
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(want, cv2.COLOR_RGB2BGR))
    same = [b == enc.tobytes() for b in [first, *bodies]]
    pipe = model.load_model(HTTP_STYLE)

    # where a request's time goes: its stages in process, median of 5
    s_w = pipe.compute_style(aligned)
    stages = {
        "decode": lambda: cv2.cvtColor(cv2.imdecode(np.frombuffer(upload, np.uint8),
                                                    cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB),
        "crop_align": lambda: model.detect_and_align_frame(
            cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)),
        "compute_style": lambda: pipe.compute_style(aligned),
        "frame_to_host_rgb": lambda: pipe.process_image(frame, s_w, 0.5),
        "encode": lambda: cv2.imencode(".jpg", cv2.cvtColor(want, cv2.COLOR_RGB2BGR)),
    }
    stage_ms = {k: float(np.median([_sync_ms(fn)[0] for _ in range(5)]))
                for k, fn in stages.items()}

    def toonify():
        return model.image_toonify(frame, aligned, style_degree=0.5, style_type=HTTP_STYLE)

    stage_ms["style_and_frame_this_thread"] = float(np.median(
        [_sync_ms(toonify)[0] for _ in range(5)]))
    new_thread = new_thread_costs(toonify)
    emit({"phase": "serve_http", "style": HTTP_STYLE, "upload_px": PORTRAIT_PX,
          "upload_bytes": len(upload), "crop_px": list(frame.shape[:2]),
          "out_px": list(want.shape[:2]), "pipeline_device": str(pipe.device),
          "packed_output": pipe.packed_output, "error_codes": codes,
          "bodies_equal_image_toonify": same, "body_bytes": len(bodies[0]),
          "first_request_ms": first_ms, "requests_timed": HTTP_TIMED,
          "p50_request_ms": float(np.median(times)), "max_request_ms": max(times),
          "request_ms": times, "transport_ms_median": float(np.median(transport)),
          "in_request_ms_median": {k: float(np.median(v)) for k, v in inner.items()},
          "stage_ms_median": stage_ms,
          "stages_sum_ms": sum(stage_ms[k] for k in stages),
          "out_std_lsb": float(want.std()),
          "launches_per_request": {k: v / HTTP_TIMED for k, v in launches.items()},
          "worker_threads": serve.PooledHTTPServer.workers, "new_thread": new_thread,
          "nvidia_smi": smi, "seconds": time.perf_counter() - t0})
    check(pipe.device.type == "cuda", "Model's pipeline is not on the card")
    check(want.shape == (4 * frame.shape[0], 4 * frame.shape[1], 3),
          f"image_toonify gave {want.shape} for a {frame.shape} crop")
    check(all(same), "a served body differs from cv2.imencode of Model.image_toonify")
    check(float(want.std()) > 10, "served image is flat")
    for name in ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"):
        check(launches[name] > 0, f"kernel {name} was not launched by the server")
    # the handler class closes over the Model and the server over the
    # class: a reference cycle, so collect it before the cache is emptied
    del model, server, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def new_thread_costs(fn, threads=3):
    """What a request pays on a thread that has not run the model before
    (as a server that starts a thread per request runs each): fn() twice on
    each of `threads` new threads (host wall ending in a synchronize), and
    one more new thread's first call under torch.profiler (host time by op,
    the table in OUT_DIR)."""
    from torch.profiler import ProfilerActivity, profile

    calls, profs = [], []

    def run(profiled):
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                _sync_ms(fn)
            profs.append(prof)
        else:
            calls.append([_sync_ms(fn)[0] for _ in range(2)])

    for profiled in [False] * threads + [True]:
        t = threading.Thread(target=run, args=(profiled,))
        t.start()
        t.join()
    check(len(calls) == threads and len(profs) == 1, "a new-thread call failed")
    avgs = sorted(profs[0].key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    (OUT_DIR / "serve_new_thread_profile.txt").write_text(
        profs[0].key_averages().table(sort_by="self_cpu_time_total", row_limit=40))
    return {"first_call_ms": [c[0] for c in calls], "second_call_ms": [c[1] for c in calls],
            "profiled_first_call_top_host_ops": [
                {"op": e.key[:80], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                 "count": e.count} for e in avgs[:8]]}


def raft_reference_state(module):
    """A port RAFT's state under the reference RAFT's keys, as
    raft-things.pth holds them (the inverse of convert_raft's key map)."""
    sd = {}
    for k, v in module.state_dict().items():
        parts = k.split(".")
        if parts[0] in ("fnet", "cnet"):
            if parts[1] == "layers":
                parts[1:3] = [f"layer{int(parts[2]) + 1}"]
                parts = ["downsample.0" if p == "down" else p
                         for p in parts if p != "norms"]
            elif parts[1] == "bn1":
                parts[1] = "norm1"
        else:
            sub = {"enc": "encoder", "gru": "gru", "flow_head": "flow_head",
                   "mask": "mask"}[parts[1]]
            parts[0:2] = ["update_block", sub]
            if sub == "mask":
                parts[2] = {"conv1": "0", "conv2": "2"}[parts[2]]
        sd["module." + ".".join(parts)] = v.clone()
    return sd


def smooth_parsing_phase(smi, root):
    """pipeline/smooth_parsing.py with RAFT at the raft-things widths and
    BiSeNet, random weights, float32. Gates with TF32 off: one window card
    vs CPU and alt vs all-pairs on the card, RAFT's flows alt vs all-pairs
    at JAX's bounds. Then in the smoother's default precision (TF32 for
    cuDNN's convs and the matmuls, as its CLI runs): the smoother timed over
    a video at 256 px (16 frames) and 512 px (2) with both corr impls (ms per smoothed
    frame, peak memory, B3's launches), the 256 px maps held to the CPU's
    float32 map of one frame of the same video, one run profiled, and its
    CLI on a cv2 mp4, whose maps feed the style-transfer CLI on the serving
    zoo in `root`. Returns the launches of the timed runs."""
    from vtoonify_tpu_torch.models.bisenet import bisenet_apply, init_bisenet
    from vtoonify_tpu_torch.models.raft import RAFTConfig, init_raft, raft_apply
    from vtoonify_tpu_torch.ops.interp import resize_bilinear
    from vtoonify_tpu_torch.pipeline import smooth_parsing as SP

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 8)
    raft = init_raft(RAFTConfig(), g)
    parsing = init_bisenet(generator=g)
    raft_dev = copy.deepcopy(raft).cuda()
    rec = {"phase": "smooth_parsing", "raft": "RAFTConfig() (raft-things widths)",
           "window": SMOOTH_WINDOW, "iters": SMOOTH_ITERS, "dtype": "float32",
           "gates_tf32": False, "timed_and_cli_tf32": True}

    # one window, card vs CPU: 64 px frames, fused at 128 px
    k = 2 * SMOOTH_WINDOW + 1
    clip = torch.from_numpy(synthetic_frames(SEED + 8, k, SMOOTH_GATE_PX)).permute(0, 3, 1, 2)
    with SP.float32_precision(False), torch.inference_mode():
        frames2x = resize_bilinear(clip.float() / 127.5 - 1.0,
                                   (2 * SMOOTH_GATE_PX, 2 * SMOOTH_GATE_PX),
                                   align_corners=False)
        parses = bisenet_apply(parsing, 2.0 * frames2x)
        host = SP.fuse_window(raft, frames2x, parses, center=SMOOTH_WINDOW,
                              iters=SMOOTH_ITERS)
        card, card_alt = (SP.fuse_window(raft_dev, frames2x.cuda(), parses.cuda(),
                                         center=SMOOTH_WINDOW, iters=SMOOTH_ITERS,
                                         alt_corr=alt).cpu() for alt in (False, True))
    rec["window_card_vs_cpu_rel_l2"] = ((card - host).norm() / host.norm()).item()
    rec["window_alt_vs_allpairs_rel_l2"] = ((card_alt - card).norm() / card.norm()).item()
    rec["window_shape"] = list(card.shape)
    check(tuple(card.shape) == (1, 19, SMOOTH_GATE_PX, SMOOTH_GATE_PX)
          and torch.isfinite(card).all() and torch.isfinite(card_alt).all(),
          f"fuse_window gave {tuple(card.shape)}")
    check(max(rec["window_card_vs_cpu_rel_l2"], rec["window_alt_vs_allpairs_rel_l2"])
          <= SMOOTH_REL_L2, f"fuse_window: card vs CPU relative L2 "
          f"{rec['window_card_vs_cpu_rel_l2']}, alt vs all-pairs "
          f"{rec['window_alt_vs_allpairs_rel_l2']}")

    # all-pairs vs alt on the card: one pair of 256 px frames, fused at 512
    pair = torch.from_numpy(synthetic_frames(SEED + 9, 2, 2 * SMOOTH_PX[0])).permute(
        0, 3, 1, 2).float().cuda()
    with SP.float32_precision(False), torch.inference_mode():
        flows = {impl: raft_apply(raft_dev, pair[:1], pair[1:], RAFTConfig(corr_impl=impl),
                                  iters=SMOOTH_ITERS)
                 for impl in ("allpairs", "alt")}
    agree = {}
    for i, (name, atol) in enumerate((("flow_low", 1e-3), ("flow_up", 1e-2))):
        a, b = flows["allpairs"][i], flows["alt"][i]
        agree[name] = {"max_abs_diff": (a - b).abs().max().item(),
                       "max_abs": a.abs().max().item(), "atol": atol, "rtol": 1e-3,
                       "within": bool(torch.allclose(b, a, atol=atol, rtol=1e-3))}
    rec["alt_vs_allpairs_flows"] = agree
    check(all(v["within"] for v in agree.values()) and all(
        torch.isfinite(f).all() for fl in flows.values() for f in fl),
        f"alt vs all-pairs flows on the card: {agree}")
    del flows, pair

    # timed, profiled and the CLI in the smoother's default precision, TF32
    # for cuDNN's convs and the matmuls (smooth_video_parsing_maps sets it):
    # with TF32 off cuDNN's heuristics pick FFT algorithms for RAFT's
    # 128->256 3x3 convs, thousands of small complex GEMMs a conv (2.6 s a
    # smoothed 256 px frame)
    timed, launches = _smooth_timed(smi, raft, parsing, root, rec)
    rec.update(timed=timed, launches=dict(launches), nvidia_smi=smi,
               seconds=time.perf_counter() - t0)
    emit(rec)
    del raft_dev
    torch.cuda.empty_cache()
    return dict(launches)


def tf32_vs_cpu(raft, parsing, clip, maps):
    """The card's TF32 maps of frame SMOOTH_TF32_FRAME of `clip` (maps[impl]
    for both corr impls) against the CPU's float32 map of that frame, made
    from its own window as smooth_video_parsing_maps forms it; relative L2,
    gated at SMOOTH_TF32_REL_L2."""
    from vtoonify_tpu_torch.pipeline import smooth_parsing as SP

    t1 = time.perf_counter()
    sel = SP.window_indices(len(clip), SMOOTH_WINDOW)[SMOOTH_TF32_FRAME]
    with torch.inference_mode():
        frames2x, parses = SP.prepare_frames(parsing, clip[sel], torch.device("cpu"))
        want = SP.fuse_window(raft, frames2x, parses, center=SMOOTH_WINDOW,
                              iters=SMOOTH_ITERS)[0].permute(1, 2, 0).numpy()
    out = {"frame": SMOOTH_TF32_FRAME, "bound_rel_l2": SMOOTH_TF32_REL_L2,
           "cpu_seconds": time.perf_counter() - t1}
    for impl, m in maps.items():
        out[f"{impl}_rel_l2"] = float(np.linalg.norm(m[SMOOTH_TF32_FRAME] - want)
                                      / np.linalg.norm(want))
        out[f"{impl}_max_abs"] = float(np.abs(m[SMOOTH_TF32_FRAME] - want).max())
    check(max(out[f"{impl}_rel_l2"] for impl in maps) <= SMOOTH_TF32_REL_L2,
          f"the card's TF32 maps against the CPU's float32: {out}")
    return out


def _smooth_timed(smi, raft, parsing, root, rec):
    """smooth_parsing_phase's timed runs, its profile and its CLI run (into
    rec["profile_..."] and rec["cli"]); returns (timed records, launches)."""
    import io
    import tempfile

    import cv2

    from vtoonify_tpu_torch.cli import style_transfer
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.pipeline import smooth_parsing as SP

    timed, launches = [], collections.Counter()
    for px in SMOOTH_PX:
        frames = SMOOTH_FRAMES[px]
        clip = synthetic_frames(SEED + 10, frames, px)
        maps = {}
        for impl in ("allpairs", "alt"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            wall_ms, maps[impl] = _sync_ms(lambda: SP.smooth_video_parsing_maps(
                raft, parsing, clip, window=SMOOTH_WINDOW, iters=SMOOTH_ITERS,
                alt_corr=impl == "alt", tf32=True))
            counts = K.launch_counts()
            launches.update(counts)
            m = maps[impl]
            check(m.shape == (frames, px, px, 19) and m.dtype == np.float32
                  and np.isfinite(m).all(), f"smoothed maps {m.shape} {m.dtype} at {px} px")
            check(counts["upfirdn2d"] > 0, "smoothing did not launch B3")
            timed.append({"px": px, "corr": impl, "frames": frames,
                          "ms_per_frame": wall_ms / frames,
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "b3_launches_per_frame": counts["upfirdn2d"] / frames,
                          "launches": counts})
        a, b = maps["allpairs"], maps["alt"]
        timed[-1]["maps_alt_vs_allpairs_rel_l2"] = float(np.linalg.norm(b - a)
                                                         / np.linalg.norm(a))
        if px == SMOOTH_PX[0]:
            rec["tf32_vs_cpu_f32"] = tf32_vs_cpu(raft, parsing, clip, maps)
        del maps, a, b
    # one profiled run: 4 frames of 256 px, all-pairs
    clip = synthetic_frames(SEED + 10, 4, SMOOTH_PX[0])
    prof = device_profile(lambda: SP.smooth_video_parsing_maps(
        raft, parsing, clip, window=SMOOTH_WINDOW, iters=SMOOTH_ITERS),
        "smooth_profile.txt")
    rec["profile_4_frames_256px_allpairs"] = {
        k: prof[k] for k in ("wall_s", "device_busy_s", "device_busy_share",
                             "b3_device_ms", "htod_pageable_copies", "top_device_ops")}

    # the CLI: an mp4 written by cv2 -> _parsingmap.npy -> style_transfer
    # --video --parsing_map_path on the serving zoo
    t1 = time.perf_counter()
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raft_path = tmp / "raft-things.pth"
        torch.save(raft_reference_state(raft), str(raft_path))
        torch.save(bisenet_reference_state(parsing), str(tmp / "faceparsing.pth"))
        frames = synthetic_frames(SEED + 11, CLI_FRAMES, CLI_PX)
        src = str(tmp / "clip.mp4")
        w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (CLI_PX, CLI_PX))
        for f in frames:
            w.write(f)
        w.release()
        with contextlib.redirect_stdout(log):
            SP.main(["--video_path", src, "--raft_path", str(raft_path),
                     "--faceparsing_path", str(tmp / "faceparsing.pth"),
                     "--output_path", str(tmp)])
        maps = np.load(tmp / "clip_parsingmap.npy")
        check(maps.shape == (CLI_FRAMES, CLI_PX, CLI_PX, 19) and np.isfinite(maps).all(),
              f"the smoother's CLI wrote {maps.shape}")
        with contextlib.redirect_stdout(log):
            style_transfer.main([
                "--content", src, "--video", "--style_id", "0",
                "--ckpt", str(root / "vtoonify_d_arcane/vtoonify_s_d.pt"),
                "--exstyle_path", str(root / "vtoonify_d_arcane/exstyle_code.npy"),
                "--faceparsing_path", str(root / "faceparsing.pth"),
                "--style_encoder_path", str(root / "encoder.pt"),
                "--landmarks", str(root / "landmarks_cli.npy"),
                "--parsing_map_path", str(tmp / "clip_parsingmap.npy"),
                "--output_path", str(tmp / "cli")])
        cli_mp4 = (tmp / "cli" / "clip_vtoonify_d.mp4").read_bytes()
        direct = maps_in_process(root, src, maps, tmp / "direct.mp4")
        direct_mp4 = (tmp / "direct.mp4").read_bytes()
    (OUT_DIR / "smooth_parsing_cli_stdout.txt").write_text(log.getvalue())
    moved = np.abs(direct["transposed"].astype(np.int16) - direct["maps"])
    rec["cli"] = {"frames": CLI_FRAMES, "px": CLI_PX, "maps_shape": list(maps.shape),
                  "mp4_equal_process_batch_with_parsing": cli_mp4 == direct_mp4,
                  "transposed_maps_max_lsb": int(moved.max()),
                  "transposed_maps_mean_lsb": float(moved.mean()),
                  "seconds": time.perf_counter() - t1}
    check(direct["maps"].shape == (CLI_FRAMES, 4 * CLI_PX, 4 * CLI_PX, 3),
          f"process_batch_with_parsing gave {direct['maps'].shape}")
    check(cli_mp4 == direct_mp4, "style_transfer --parsing_map_path wrote other frames "
          "than process_batch_with_parsing fed the same maps")
    check(moved.max() > 0, "transposed parsing maps did not change the stylized frames")
    return timed, launches


def maps_in_process(root, src, maps, out_path):
    """What style_transfer --video --parsing_map_path writes for `src` on the
    serving zoo in `root`, made here: its modules loaded as the CLI loads
    them, the clip's frames as decoded (no --scale_image: the frames are
    the crops), the style from the first, then process_batch_with_parsing
    on all CLI_FRAMES crops at once (the CLI's one batch) fed `maps`,
    written to out_path by the CLI's video writer. Returns the frames made
    with `maps` and with the maps transposed."""
    from vtoonify_tpu_torch.pipeline import crop as crop_mod
    from vtoonify_tpu_torch.pipeline import video
    from vtoonify_tpu_torch.pipeline.landmarks import make_landmarker
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
    from vtoonify_tpu_torch.utils import checkpoint as ckpt_util

    vt, cfg = ckpt_util.load_reference_vtoonify(str(root / "vtoonify_d_arcane/vtoonify_s_d.pt"))
    psp, latent_avg, psp_cfg = ckpt_util.load_reference_psp(str(root / "encoder.pt"))
    bank, names = ckpt_util.load_exstyle_bank(str(root / "vtoonify_d_arcane/exstyle_code.npy"))
    pipe = ToonifyPipeline(
        vt, cfg, ckpt_util.load_reference_faceparsing(str(root / "faceparsing.pth")),
        psp_params=psp, psp_cfg=psp_cfg, latent_avg=latent_avg, exstyle=bank[names[0]])
    decoded = list(video.iterate_video_frames(src))
    crops = np.stack([crop_mod.preprocess_frame(f, None, False) for _, f in decoded])
    check(len(crops) == CLI_FRAMES, f"decoded {len(crops)} frames")
    landmarker = make_landmarker(landmarks=str(root / "landmarks_cli.npy"))
    s_w = pipe.compute_style(crop_mod.align_face(crops[0], landmarker))
    out = {name: pipe.process_batch_with_parsing(crops, m, s_w, 0.5).cpu().numpy()
           for name, m in (("maps", maps),
                           ("transposed", np.ascontiguousarray(maps.transpose(0, 2, 1, 3))))}
    writer = video._AsyncWriter(str(out_path), decoded[0][0],
                                (4 * crops.shape[2], 4 * crops.shape[1]))
    for f in out["maps"]:
        writer.write(f)
    check(writer.close() == CLI_FRAMES, "the writer lost frames")
    return out


def write_release_zoo(root, g):
    """The release cases' checkpoint layout at the --tiny widths, random
    weights: VToonify-D (cartoon, a 65-style bank) and VToonify-T (arcane),
    BiSeNet and pSp."""
    from vtoonify_tpu_torch.convert.torch_export import save_reference_checkpoint
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig, init_psp_encoder
    from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig, init_vtoonify

    for backbone, rel in (("dualstylegan", "vtoonify_d_cartoon/vtoonify_s_d.pt"),
                          ("toonify", "vtoonify_t_arcane/vtoonify.pt")):
        cfg = VToonifyConfig(backbone=backbone, **TINY_VT)
        vt = init_vtoonify(cfg, generator=g)
        gen = vt.generator.generator if backbone == "dualstylegan" else vt.generator
        with torch.no_grad():
            for blk in gen.to_rgbs:
                blk.bias.normal_(0.0, 0.5, generator=g)
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        save_reference_checkpoint(str(root / rel), vt, cfg)
    n = cfg.n_latent
    torch.save(bisenet_reference_state(init_bisenet(generator=g)), str(root / "faceparsing.pth"))
    torch.save({"state_dict": psp_reference_state(init_psp_encoder(PSPEncoderConfig(n_styles=n), g)),
                "latent_avg": torch.randn((n, 512), generator=g) * 0.3},
               str(root / "encoder.pt"))
    np.save(str(root / "vtoonify_d_cartoon/exstyle_code.npy"),
            {f"style{i}.png": (torch.randn((1, n, 512), generator=g) * 0.3).numpy()
             for i in range(65)}, allow_pickle=True)


def release_gate_phase():
    """cli/validate_release.py on a tiny release zoo: goldens made by the
    port's style-transfer CLI with --cpu --fp32, then the gate on the card
    (bf16) passes them at >= 35 dB, and fails (exit code 1) a perturbed
    golden; then
    cli/inference_playground.py writes its three parts on the card. Returns
    the launches of the card's gate run against the CPU goldens plus those
    of the playground (not the perturbed golden's run)."""
    import io
    import os
    import shutil
    import tempfile

    import cv2

    from vtoonify_tpu_torch.cli import inference_playground, style_transfer
    from vtoonify_tpu_torch.cli import validate_release as vr
    from vtoonify_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    rec = {"phase": "release_gate", "cases": GATE_CASES, "config": TINY_VT}
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt, data, lms, golden = (tmp / d for d in ("checkpoint", "data", "lm", "golden"))
        for d in (ckpt, data, lms):
            d.mkdir()
        write_release_zoo(ckpt, torch.Generator().manual_seed(SEED + 12))
        for i, stem in enumerate(("077436", "038648")):
            img = synthetic_frames(SEED + 13 + i, 1, PORTRAIT_PX)[0]
            cv2.imwrite(str(data / f"{stem}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            np.save(lms / f"{stem}.npy", portrait_landmarks())
        common = ["--checkpoint_root", str(ckpt), "--data_root", str(data),
                  "--landmarks_root", str(lms), "--cases", *GATE_CASES, "--skip_video"]

        def gate(*argv):
            report = tmp / "report.json"
            with contextlib.redirect_stdout(log):
                code = vr.main([*common, *argv, "--json_out", str(report)])
            return code, json.loads(report.read_text())["results"]

        # goldens: each case's command through the port's style-transfer
        # CLI on the CPU in float32, as the reference's goldens are float32
        # (the card's gate runs the CLI's default, bf16)
        golden.mkdir()
        for case in (c for c in vr.CASES if c.name in GATE_CASES):
            stem = case.content.split(".")[0]
            argv = ["--content", str(data / case.content), "--ckpt", str(ckpt / case.ckpt),
                    "--scale_image", "--output_path", str(tmp / "cpu"),
                    "--faceparsing_path", str(ckpt / "faceparsing.pth"),
                    "--style_encoder_path", str(ckpt / "encoder.pt"),
                    "--padding", *map(str, case.padding), "--backbone", case.backbone,
                    "--landmarks", str(lms / f"{stem}.npy"), "--cpu", "--fp32"]
            if case.style_id is not None:
                argv += ["--style_id", str(case.style_id)]
            with contextlib.redirect_stdout(log):
                style_transfer.main(argv)
            shutil.copy(tmp / "cpu" / f"{stem}_vtoonify_{case.backbone[0]}.jpg",
                        golden / f"{case.name}.jpg")

        torch.cuda.synchronize()
        K.reset_launch_counts()
        code, results = gate("--golden_root", str(golden), "--output_path", str(tmp / "card"))
        torch.cuda.synchronize()
        launches = {"gate": K.launch_counts()}
        rec["card_vs_cpu_goldens"] = {"exit": code, "results": results}
        check(code == 0 and [r["case"] for r in results] == GATE_CASES
              and all(r["pass"] and r["psnr_db"] >= vr.MIN_PSNR_DB for r in results),
              f"the card's gate against the CPU goldens: exit {code}, {results}")

        g0 = golden / f"{GATE_CASES[0]}.jpg"
        im = cv2.imread(str(g0)).astype(np.int16)
        noise = np.random.RandomState(SEED + 14).randint(-60, 61, im.shape)
        cv2.imwrite(str(g0), np.clip(im + noise, 0, 255).astype(np.uint8))
        code, results = gate("--golden_root", str(golden), "--output_path", str(tmp / "card2"))
        rec["perturbed_golden"] = {"exit": code, "results": results}
        check(code == 1 and [r["pass"] for r in results] == [False, True],
              f"the gate against a perturbed golden: exit {code}, {results}")

        out = tmp / "playground"
        K.reset_launch_counts()
        with contextlib.redirect_stdout(log):
            inference_playground.main([
                "--checkpoint_root", str(ckpt), "--content", str(data / "077436.jpg"),
                "--out", str(out), "--landmarks", str(lms / "077436.npy"),
                "--style_type", "cartoon1-d", "--model", "cartoon1-d",
                "--styles", "cartoon1-d,cartoon2-d"])
        torch.cuda.synchronize()
        launches["playground"] = K.launch_counts()
        names = sorted(os.listdir(out))
        want = sorted(["demo_cartoon1-d.jpg", "walkthrough_ds0.0.jpg",
                       "walkthrough_ds0.5.jpg", "walkthrough_ds1.0.jpg",
                       "style_cartoon1-d.jpg", "style_cartoon2-d.jpg",
                       "style_color_transfer.jpg"])
        shapes = {n: cv2.imread(str(out / n)).shape for n in names}
        rec["playground"] = {"files": names, "shapes": sorted(set(map(str, shapes.values())))}
        check(names == want, f"the playground wrote {names}, not {want}")
        check(len(set(shapes.values())) == 1, f"playground images {shapes}")
    (OUT_DIR / "release_gate_stdout.txt").write_text(log.getvalue())
    for run, counts in launches.items():
        for name in ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"):
            check(counts[name] > 0, f"kernel {name} was not launched by the {run}")
    rec.update(launches=launches, seconds=time.perf_counter() - t0)
    emit(rec)
    return dict(collections.Counter(launches["gate"]) + collections.Counter(launches["playground"]))


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
        style_ind=torch.arange(batch) % (dcfg.style_num or 1),
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


def _step_result(state, metrics, seconds):
    """What a card-vs-CPU comparison reads from a state after one step:
    the metrics, the new parameters and gradients (Adam's first moment over
    1 - beta1) of each optimizer, the EMA."""
    from vtoonify_tpu_torch.train.steps import ADAM_BETA1

    opts = {"trainable": (state.g_opt, state.trainable)}
    if hasattr(state, "d_opt"):
        opts["d"] = (state.d_opt, state.d)
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        new={k: _flat(m).cpu() for k, (_, m) in opts.items()},
        grads={k: torch.cat([(opt.state[p]["exp_avg"] / (1 - ADAM_BETA1))
                             .reshape(-1).cpu() for p in m.parameters()])
               for k, (opt, m) in opts.items()},
        sizes={k: [p.numel() for p in m.parameters()] for k, (_, m) in opts.items()},
        ema=_flat(state.ema).cpu(), seconds=seconds)


def _check_card_vs_cpu(rec, out, lr, prefix=""):
    """Metrics within STEP_RTOL, gradients within 1e-3 relative L2, Adam's
    first updates as tests/test_torch_train_step.py compares them (on each
    parameter's elements whose |g| is above 1e-3 of that parameter's
    largest and above 100 eps), and the EMA within 1e-6; the findings go
    into `rec` under `prefix`."""
    from vtoonify_tpu_torch.train.steps import ADAM_EPS

    for k in out["cuda"]["metrics"]:
        a, b = out["cuda"]["metrics"][k], out["cpu"]["metrics"][k]
        check(np.isfinite(a) and abs(a - b) <= STEP_RTOL * abs(b) + 1e-9,
              f"{prefix}train step metric {k}: card {a} vs CPU {b}")
    covered = total = 0
    for k in out["cpu"]["new"]:
        err = (out["cuda"]["new"][k] - out["cpu"]["new"][k]).abs()  # same start
        g = out["cpu"]["grads"][k].abs()
        check(err.max().item() <= 2 * lr + 1e-7, f"{prefix}{k}: updates differ by > 2 lr")
        mask = torch.cat([(gi > 1e-3 * gi.max()) & (gi > 100 * ADAM_EPS)
                          for gi in g.split(out["cpu"]["sizes"][k])])
        e = err[mask]
        rec[f"{prefix}{k}_masked_max_err_over_lr"] = e.max().item() / lr if e.numel() else 0.0
        rec[f"{prefix}{k}_masked_frac_over_1e-3_lr"] = (
            (e > 1e-3 * lr).float().mean().item() if e.numel() else 0.0)
        check(rec[f"{prefix}{k}_masked_max_err_over_lr"] <= 0.02
              and rec[f"{prefix}{k}_masked_frac_over_1e-3_lr"] <= 1e-2,
              f"{prefix}{k}: card and CPU updates disagree")
        covered, total = covered + int(mask.sum()), total + mask.numel()
        rec[f"{prefix}{k}_grad_rel_l2"] = ((out["cuda"]["grads"][k] - out["cpu"]["grads"][k])
                                           .norm() / out["cpu"]["grads"][k].norm()).item()
        check(rec[f"{prefix}{k}_grad_rel_l2"] <= 1e-3,
              f"{prefix}{k}: card and CPU gradients differ")
    ema_err = (out["cuda"]["ema"] - out["cpu"]["ema"]).abs().max().item()
    rec[f"{prefix}mask_coverage"] = covered / total
    rec[f"{prefix}ema_max_abs_err"] = ema_err
    check(covered > 0.05 * total, f"{prefix}update comparison covers too few elements")
    check(ema_err <= 1e-6, f"{prefix}EMA differs between card and CPU")


def train_f32_vs_cpu_phase():
    """The trainer's --tiny configuration, one step at batch 2 on the card
    and on the CPU from identical modules and one TrainDDraws, float32 with
    TF32 off."""
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig, VToonifyConfig
    from vtoonify_tpu_torch.train.steps import (
        TrainDConfig, init_train_d_state, sample_train_d_draws)

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 1)
    cfg = VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1,
                         num_res_layers=2)
    dcfg = CondDiscriminatorConfig(size=64, channel_multiplier=1,
                                   use_condition=True, style_num=4)
    tcfg = TrainDConfig(crop_size=96, lpips_size=64, aug_max_pad=40)
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
        out[where] = _step_result(state, m, time.perf_counter() - t1)
    rec = {"phase": "train_f32_vs_cpu", "config": "--tiny: VToonifyConfig(32 -> "
           "128 px, channel_multiplier 1, 2 res layers), D 64 px cm 1, crop 96, "
           "lpips 64, aug_max_pad 40, batch 2, color jitter on",
           "metrics_cuda": out["cuda"]["metrics"], "metrics_cpu": out["cpu"]["metrics"],
           "cuda_step_s": out["cuda"]["seconds"], "cpu_step_s": out["cpu"]["seconds"]}
    try:
        _check_card_vs_cpu(rec, out, tcfg.lr)
    finally:
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)


# ---------------------------------------------------------------------------
# stage 1 (D and T) and VToonify-T stage 2


def _timed_steps(run, steps, expect, table, with_profile=True):
    """1 warm-up call of run() (one training step), then `steps` timed ones
    (host wall ending in a synchronize), each with finite metrics and every
    kernel in `expect` launched; then one profiled step. Returns the
    record's fields and the launches of the first timed step."""
    torch.cuda.reset_peak_memory_stats()
    times, per_step = [], []
    from vtoonify_tpu_torch.ops import kernels as K

    for i in range(1 + steps):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t1 = time.perf_counter()
        metrics = run()
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t1)
        per_step.append(K.launch_counts())
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in vals.values()),
              f"non-finite loss in step {i}: {vals}")
        for name in expect:
            check(per_step[-1][name] > 0, f"kernel {name} was not launched by step {i}")
    rec = {"steps_timed": steps, "s_per_iter": times,
           "p50_s_per_iter": float(np.median(times)),
           "min_max_s_per_iter": [min(times), max(times)],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_step": per_step[1], "metrics": vals}
    if with_profile:
        rec["profile"] = device_profile(run, table)
        rec["device_busy_share"] = rec["profile"]["device_busy_share"]
    return rec, per_step[1]


STAGE1_KERNELS = ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2")


def pretrain_d_phase(smi, steps=3):
    """The flagship VToonify-D stage-1 step at batch 8 in bf16
    (bench_train.py::bench_pretrain's configuration, pSp absent), from
    init_pretrain_state with no device."""
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig, init_vtoonify
    from vtoonify_tpu_torch.train.steps import (
        init_pretrain_state, pretrain_step, split_trainable)

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED)
    cfg = VToonifyConfig()
    vt, parsing = init_vtoonify(cfg, g), init_bisenet(generator=g)
    directions = torch.randn((4, cfg.n_latent, 512), generator=g) * 0.1
    style = torch.randn((8, cfg.n_latent, 512), generator=g) * 0.3
    state = init_pretrain_state(vt)
    check(next(state.trainable.parameters()).device.type == "cuda",
          "init_pretrain_state without a device did not run on the card")
    _, frozen = split_trainable(vt, pretrain=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    before = _flat(state.trainable)
    setup_s = time.perf_counter() - t0
    rec, launches = _timed_steps(
        lambda: pretrain_step(state, frozen, parsing, cfg, directions, style, 0.5,
                              compute_dtype="bfloat16", generator=gen),
        steps, STAGE1_KERNELS, "pretrain_d_profile.txt")
    moved = (_flat(state.trainable) - before).abs().sum().item()
    check(moved > 0, "the encoder did not move")
    emit({"phase": "pretrain_d", "config": "VToonifyConfig() (VToonify-D, "
          "DualStyleGAN teacher) + BiSeNet, pretrain_step, batch 8, d_s 0.5",
          "batch": 8, "dtype": "bfloat16", **rec, "moved_abs_sum": moved,
          "setup_seconds": setup_s, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    del state, vt, frozen
    torch.cuda.empty_cache()
    return launches


def train_t_phase(smi, stages=("pretrain", "train"), steps=3):
    """The flagship VToonify-T: G1 blended (the cartoon recipe) from two
    random StyleGAN2 generators, the un-blended base G0; stage 1 at batch 8
    and stage 2 at batch 2 (unconditional D at 256 px), bf16. Returns the
    launches of one step of each stage run."""
    from vtoonify_tpu_torch.cli.train_t import STYLE_BLEND_WEIGHTS
    from vtoonify_tpu_torch.models.generator import init_generator
    from vtoonify_tpu_torch.models.vtoonify import (
        CondDiscriminatorConfig, VToonifyConfig, init_cond_discriminator, init_vtoonify)
    from vtoonify_tpu_torch.train import steps as S
    from vtoonify_tpu_torch.utils.blend import blend_generators

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 2)
    cfg = VToonifyConfig(backbone="toonify")
    dcfg = CondDiscriminatorConfig(size=256, channel_multiplier=2)
    tcfg = S.TrainDConfig(compute_dtype="bfloat16")
    pcfg, mods, _ = train_setup(cfg, dcfg, tcfg, 2, g)
    base = init_generator(cfg.generator, g)
    mods["vt"].generator = blend_generators(init_generator(cfg.generator, g), base,
                                            STYLE_BLEND_WEIGHTS["cartoon"])
    directions = torch.randn((4, cfg.n_latent, 512), generator=g) * 0.1
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    setup_s = time.perf_counter() - t0
    launches = {}
    if "pretrain" in stages:
        t1 = time.perf_counter()
        state = S.init_pretrain_state(mods["vt"])
        _, frozen = S.split_trainable(mods["vt"], pretrain=True)
        rec, launches["pretrain_t"] = _timed_steps(
            lambda: S.pretrain_t_step(state, frozen, base, mods["parsing"], cfg,
                                      directions, 8, compute_dtype="bfloat16",
                                      generator=gen),
            steps, STAGE1_KERNELS, "pretrain_t_profile.txt")
        emit({"phase": "pretrain_t", "config": "VToonifyConfig(backbone='toonify') "
              "+ BiSeNet, G1 = blend(random, random G0, cartoon weights), "
              "pretrain_t_step, batch 8", "batch": 8, "dtype": "bfloat16", **rec,
              "seconds": time.perf_counter() - t1, "setup_seconds": setup_s,
              "nvidia_smi": smi})
        del state, frozen
        torch.cuda.empty_cache()
    if "train" in stages:
        t1 = time.perf_counter()
        state = S.init_train_t_state(mods["vt"], mods["d"], tcfg)
        check(next(state.d.parameters()).device.type == "cuda",
              "init_train_t_state without a device did not run on the card")
        _, frozen = S.split_trainable(mods["vt"])
        before = {k: _flat(m) for k, m in (("trainable", state.trainable),
                                           ("d", state.d))}
        rec, launches["train_t"] = _timed_steps(
            lambda: S.train_t_step(state, frozen, base, mods["parsing"], mods["psp"],
                                   pcfg, None, mods["lpips"], cfg, dcfg, tcfg,
                                   directions, 2, 0.3, generator=gen),
            steps, (*STAGE1_KERNELS, "affine_warp"), "train_t_profile.txt")
        moved = {k: (_flat(m) - before[k]).abs().sum().item()
                 for k, m in (("trainable", state.trainable), ("d", state.d))}
        check(all(v > 0 for v in moved.values()), f"parameters did not move: {moved}")
        emit({"phase": "train_t", "config": "VToonifyConfig(backbone='toonify') + "
              "CondDiscriminatorConfig(256, 2, unconditional) + pSp (18 styles) + "
              "LPIPS + BiSeNet, G1 blended, TrainDConfig(compute_dtype='bfloat16') "
              "defaults, batch 2", "batch": 2, "dtype": "bfloat16", **rec,
              "moved_abs_sum": moved, "seconds": time.perf_counter() - t1,
              "nvidia_smi": smi})
        del state, frozen
    del mods, base
    torch.cuda.empty_cache()
    return launches


def train_tiny_vs_cpu_phase():
    """The trainers' --tiny configuration, float32 with TF32 off: one
    VToonify-D stage-1 step, one VToonify-T stage-2 step and one T stage-1
    step, each on the card and on the CPU from the same modules and draws."""
    from vtoonify_tpu_torch.models.generator import init_generator
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig, VToonifyConfig
    from vtoonify_tpu_torch.train import steps as S

    t0 = time.perf_counter()
    rec = {"phase": "train_tiny_vs_cpu", "config": "--tiny: VToonifyConfig(32 -> 128 "
           "px, channel_multiplier 1, 2 res layers), batch 2; T: D 64 px cm 1 "
           "(unconditional), crop 96, lpips 64, aug_max_pad 40"}
    tcfg = S.TrainDConfig(crop_size=96, lpips_size=64, aug_max_pad=40)
    for which in ("pretrain_d", "train_t", "pretrain_t"):
        g = torch.Generator().manual_seed(SEED + 3)
        backbone = "dualstylegan" if which == "pretrain_d" else "toonify"
        cfg = VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1,
                             num_res_layers=2, backbone=backbone)
        dcfg = CondDiscriminatorConfig(size=64, channel_multiplier=1)
        pcfg, mods_cpu, inputs = train_setup(cfg, dcfg, tcfg, 2, g)
        mods_cpu["base"] = init_generator(cfg.generator, g)
        with torch.no_grad():  # random noise weights and biases: nothing blind
            vt_gen = mods_cpu["vt"].generator
            for gen in (mods_cpu["base"], getattr(vt_gen, "generator", vt_gen)):
                for blk in [gen.conv1, *gen.convs]:
                    blk.noise.weight.fill_(0.1)
                    blk.act_bias.normal_(0.0, 0.3, generator=g)
        draws = (S.sample_train_t_draws(g, 2, cfg, tcfg, 4) if which == "train_t"
                 else S.sample_pretrain_draws(g, 2, cfg, 4))
        out = {}
        for where in ("cuda", "cpu"):
            m = copy.deepcopy(mods_cpu)
            device = None if where == "cuda" else "cpu"
            t1 = time.perf_counter()
            if which == "train_t":
                state = S.init_train_t_state(m["vt"], m["d"], tcfg, device=device)
                _, frozen = S.split_trainable(m["vt"])
                dev = next(state.d.parameters()).device
                metrics = S.train_t_step(
                    state, frozen, m["base"], m["parsing"], m["psp"], pcfg, None,
                    m["lpips"], cfg, dcfg, tcfg, inputs["directions"], 2, 0.3,
                    draws=draws.to(dev))
            else:
                state = S.init_pretrain_state(m["vt"], device=device)
                _, frozen = S.split_trainable(m["vt"], pretrain=True)
                dev = next(state.trainable.parameters()).device
                if which == "pretrain_d":
                    metrics = S.pretrain_step(state, frozen, m["parsing"], cfg,
                                              inputs["directions"], inputs["style"],
                                              0.6, draws=draws.to(dev))
                else:
                    metrics = S.pretrain_t_step(state, frozen, m["base"], m["parsing"],
                                                cfg, inputs["directions"], 2,
                                                draws=draws.to(dev))
            torch.cuda.synchronize()
            out[where] = _step_result(state, metrics, time.perf_counter() - t1)
        rec[f"{which}_metrics_cuda"] = out["cuda"]["metrics"]
        rec[f"{which}_metrics_cpu"] = out["cpu"]["metrics"]
        rec[f"{which}_step_s"] = {k: out[k]["seconds"] for k in out}
        try:
            _check_card_vs_cpu(rec, out, tcfg.lr, prefix=f"{which}.")
        except SystemExit:
            rec["seconds"] = time.perf_counter() - t0
            emit(rec)
            raise
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)


# ---------------------------------------------------------------------------
# the trainer CLIs on reference-format random files


_BISENET_CP = ("resnet", "arm16", "arm32", "conv_head32", "conv_head16", "conv_avg")
_PSP_INPUT = ("input_conv", "input_bn", "input_prelu")
_PSP_BODY = {"bn0": "res_layer.0", "conv1": "res_layer.1", "prelu": "res_layer.2",
             "conv2": "res_layer.3", "bn2": "res_layer.4", "se": "res_layer.5",
             "shortcut_conv": "shortcut_layer.0", "shortcut_bn": "shortcut_layer.1"}


def bisenet_reference_state(module):
    """A port BiSeNet's state under the reference BiSeNet's keys (the
    inverse of convert/torch_import.py::convert_bisenet's key map)."""
    sd = {}
    for k, v in module.state_dict().items():
        k = k.replace(".down_conv.", ".downsample.0.").replace(".down_bn.", ".downsample.1.")
        sd[("cp." + k) if k.split(".")[0] in _BISENET_CP else k] = v.clone()
    return sd


def psp_reference_state(module):
    """A port PSPEncoder's state as a reference pSp checkpoint's
    `encoder.`-prefixed GradualStyleEncoder keys (the inverse of
    convert_psp_encoder's key map)."""
    sd = {}
    for k, v in module.state_dict().items():
        parts = k.split(".")
        if parts[0] in _PSP_INPUT:
            parts[0] = f"input_layer.{_PSP_INPUT.index(parts[0])}"
        elif parts[0] == "body":
            parts[2] = _PSP_BODY[parts[2]]
        elif parts[0] == "styles" and parts[2] == "convs":
            parts[3] = str(2 * int(parts[3]))  # LeakyReLUs in between
        sd["encoder." + ".".join(parts)] = v.clone()
    return sd


def _write_reference_files(root, g):
    """The trainers' inputs at the --tiny configuration, random weights from
    `g`, in the reference's formats: DualStyleGAN generator.pt, the base and
    finetuned StyleGANs (through the port's exporter), faceparsing.pth,
    encoder.pt (pSp, n_latent styles), exstyle_code.npy, directions.npy."""
    from vtoonify_tpu_torch.convert.torch_export import export_dualstylegan, export_generator
    from vtoonify_tpu_torch.models.bisenet import init_bisenet
    from vtoonify_tpu_torch.models.dualstylegan import init_dualstylegan
    from vtoonify_tpu_torch.models.generator import init_generator
    from vtoonify_tpu_torch.models.psp_encoder import PSPEncoderConfig, init_psp_encoder
    from vtoonify_tpu_torch.models.vtoonify import VToonifyConfig

    cfg = VToonifyConfig(in_size=32, out_size=128, channel_multiplier=1, num_res_layers=2)
    n = cfg.n_latent

    def g_ema(path, sd):
        torch.save({"g_ema": {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in sd.items()}}, str(path))

    ds = init_dualstylegan(cfg.dualstylegan, g)
    with torch.no_grad():
        for blk in ds.generator.to_rgbs:
            blk.bias.normal_(0.0, 0.5, generator=g)
    g_ema(root / "generator.pt", export_dualstylegan(ds, cfg.dualstylegan))
    for name in ("stylegan.pt", "finetune.pt"):
        g_ema(root / name, export_generator(init_generator(cfg.generator, g), cfg.generator))
    torch.save(bisenet_reference_state(init_bisenet(generator=g)), str(root / "faceparsing.pth"))
    psp = init_psp_encoder(PSPEncoderConfig(n_styles=n), g)
    torch.save({"state_dict": psp_reference_state(psp),
                "latent_avg": torch.randn((n, 512), generator=g) * 0.3},
               str(root / "encoder.pt"))
    np.save(str(root / "exstyle_code.npy"),
            {f"style{i}.png": (torch.randn((1, n, 512), generator=g) * 0.3).numpy()
             for i in range(3)}, allow_pickle=True)
    np.save(str(root / "directions.npy"), (torch.randn((4, n, 512), generator=g) * 0.1).numpy())


def train_cli_phase():
    """cli.train_d.main and cli.train_t.main on the card at --tiny
    --allow_random_lpips, on reference-format random files in a temporary
    directory: 2 iterations of each stage with --export_pt, then --resume
    to 3; the metrics finite, the files the trainers write there, the
    exported checkpoints loaded strictly and run through one
    ToonifyPipeline.process_batch."""
    import io
    import os
    import tempfile

    from vtoonify_tpu_torch.cli import train_d, train_t
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline
    from vtoonify_tpu_torch.utils import checkpoint as CK

    t0 = time.perf_counter()
    rec = {"phase": "train_cli", "argv": "--tiny --allow_random_lpips --batch 2 "
           "--export_pt: --pretrain --iter 2, --pretrain --iter 3 --resume, --iter 2, "
           "--iter 3 --resume"}
    import PIL  # the sample grids are jpgs

    rec["pillow"] = PIL.__version__
    cwd = os.getcwd()
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _write_reference_files(root, torch.Generator().manual_seed(SEED + 4))
        inputs = ["--faceparsing_path", str(root / "faceparsing.pth"),
                  "--style_encoder_path", str(root / "encoder.pt"),
                  "--direction_path", str(root / "directions.npy"),
                  "--tiny", "--allow_random_lpips", "--batch", "2", "--export_pt",
                  "--log_every", "10"]
        clis = {
            "d": (train_d.main, ["--stylegan_path", str(root / "generator.pt"),
                                 "--exstyle_path", str(root / "exstyle_code.npy"),
                                 "--style_id", "1"], "vtoonify_s_d_c", "dualstylegan"),
            "t": (train_t.main, ["--stylegan_path", str(root / "stylegan.pt"),
                                 "--finetunegan_path", str(root / "finetune.pt")],
                  "vtoonify", "toonify")}
        os.chdir(tmp)
        try:
            K.reset_launch_counts()
            for name, (main, extra, stem, backbone) in clis.items():
                argv = [*inputs, *extra, "--name", name]
                with contextlib.redirect_stdout(log):
                    for stage in (["--pretrain"], []):
                        main([*argv, *stage, "--iter", "2"])
                        main([*argv, *stage, "--iter", "3", "--resume"])
                text = log.getvalue()
                check("resumed pretrain state at step 2" in text
                      and "resumed full train state at step 2" in text,
                      f"train_{name}: --resume did not resume")
                recs = [json.loads(line) for line in open(f"log/{name}/metrics.jsonl")]
                check([r["step"] for r in recs] == [0, 1, 2, 0, 1, 2]
                      and all(np.isfinite(v) for r in recs for v in r.values()),
                      f"train_{name}: metrics {recs}")
                files = sorted(os.listdir(f"checkpoint/{name}"))
                want = sorted(["pretrain.ckpt", "pretrain.pt", "pretrain_state.ckpt",
                               f"{stem}.ckpt", f"{stem}.pt", "train_state.ckpt"])
                check(files == want, f"train_{name} wrote {files}, not {want}")
                grids = sorted(os.listdir(f"log/{name}"))
                check(any(f.endswith(".jpg") for f in grids),
                      f"train_{name}: no sample grid in {grids}")
                vt, cfg = CK.load_reference_vtoonify(f"checkpoint/{name}/{stem}.pt")
                check(cfg.backbone == backbone, f"train_{name}: exported {cfg.backbone}")
                pipe = ToonifyPipeline(vt, cfg, CK.load_reference_faceparsing(
                    str(root / "faceparsing.pth")))
                frames = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3), np.uint8)
                s_w = np.random.RandomState(1).randn(1, cfg.n_latent, 512).astype(
                    np.float32) * 0.3
                out = pipe.process_batch(frames, s_w, 0.5).cpu()
                check(tuple(out.shape) == (2, 128, 128, 3) and out.dtype == torch.uint8,
                      f"train_{name}: the exported model gave {tuple(out.shape)}")
                rec[f"train_{name}"] = {"last_metrics": recs[-1], "files": files,
                                        "grids": grids}
            launches = K.launch_counts()
        finally:
            os.chdir(cwd)
            (OUT_DIR / "train_cli_stdout.txt").write_text(log.getvalue())
    for name in SOURCES:
        check(launches[name] > 0, f"kernel {name} was not launched by the trainer CLIs")
    rec.update(launches=launches, seconds=time.perf_counter() - t0)
    emit(rec)
    return launches


# ---------------------------------------------------------------------------
# raft_train: RAFT training and evaluation (models/raft_train.py, raft_eval.py)


def _raft_gate_inputs():
    rng = np.random.RandomState(SEED + 20)
    b, h, w = RAFT_GATE_SHAPE
    return (torch.from_numpy((rng.rand(b, 3, h, w) * 255).astype(np.float32)),
            torch.from_numpy((rng.rand(b, 3, h, w) * 255).astype(np.float32)),
            torch.from_numpy((rng.randn(b, 2, h, w) * 3).astype(np.float32)),
            torch.from_numpy((rng.rand(b, h, w) > 0.2).astype(np.float32)))


def _raft_steps_agree(a, b, before, lr, n_valid, bn_trained, name):
    """Two RAFT train steps from the same params and inputs, held as
    tests/test_torch_cuda.py::_raft_steps_agree holds them (RAFT_GATE_*
    above); returns the measured errors."""
    (am, ap, ag), (bm, bp, bg) = a, b
    out = {}
    for k in ("loss", "epe"):
        out[f"{k}_rel_err"] = abs(am[k] - bm[k]) / max(abs(bm[k]), 1e-12)
        check(out[f"{k}_rel_err"] <= RAFT_GATE_RTOL, f"{name}: {k} {am[k]} vs {bm[k]}")
    for k in ("1px", "3px", "5px"):
        out[f"{k}_abs_err"] = abs(am[k] - bm[k])
        check(out[f"{k}_abs_err"] <= 1.0 / n_valid + 1e-7, f"{name}: {k} {am[k]} vs {bm[k]}")

    def rel(x, y, keys):
        return (sum(((x[k] - y[k]) ** 2).sum() for k in keys)
                / sum((y[k] ** 2).sum() for k in keys)).sqrt().item()

    out["grad_rel_l2"] = rel(ag, bg, list(bg))
    out["params_rel_l2"] = rel(ap, bp, list(bg))
    check(out["grad_rel_l2"] <= RAFT_GATE_GRAD_REL_L2
          and out["params_rel_l2"] <= RAFT_GATE_PARAMS_REL_L2, f"{name}: {out}")
    worst = worst_masked = 0.0
    covered = total = over_2e2 = over_1e3 = 0
    for k, g in bg.items():
        err = (ap[k] - bp[k]).abs()
        worst = max(worst, err.max().item() / lr)
        mask = (g.abs() > 1e-3 * g.abs().max()) & (g.abs() > 1e-6)
        covered, total = covered + int(mask.sum()), total + mask.numel()
        if mask.any():
            worst_masked = max(worst_masked, err[mask].max().item() / lr)
            over_2e2 += int((err[mask] > 0.02 * lr).sum())
            over_1e3 += int((err[mask] > 1e-3 * lr).sum())
    frac_2e2, frac_1e3 = over_2e2 / max(covered, 1), over_1e3 / max(covered, 1)
    out.update({"update_max_err_over_lr": worst,
                "masked_update_max_err_over_lr": worst_masked,
                "masked_frac_over_0.02_lr": frac_2e2,
                "masked_frac_over_1e-3_lr": frac_1e3, "mask_coverage": covered / total})
    check(worst <= 2 + 1e-3 and frac_2e2 <= 1e-3 and frac_1e3 <= 1e-2
          and covered > 0.05 * total, f"{name}: AdamW updates disagree: {out}")
    bn = [k for k in bp if "running" in k]
    if bn_trained:
        out["bn_max_abs_err"] = max((ap[k] - bp[k]).abs().max().item() for k in bn)
        check(out["bn_max_abs_err"] <= RAFT_GATE_BN_ATOL, f"{name}: BN buffers {out}")
    else:
        check(all(torch.equal(ap[k], before[k]) and torch.equal(bp[k], before[k])
                  for k in bn), f"{name}: frozen BN buffers moved")
    return out


def raft_train_gates():
    """One raft_train_step at RAFT_GATE_SHAPE, 2 iterations, noise and a
    clip that binds, both BN modes and both correlations, card against CPU
    from the same params and draws (TF32 off, as main sets it); and the alt
    step against the all-pairs step on the card."""
    from vtoonify_tpu_torch.models import raft as R
    from vtoonify_tpu_torch.models import raft_train as RT
    from vtoonify_tpu_torch.ops import kernels as K

    model = R.init_raft(R.RAFTConfig(), torch.Generator().manual_seed(SEED + 20))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    inputs = _raft_gate_inputs()
    draws = RT.sample_raft_train_draws(torch.Generator().manual_seed(SEED + 21),
                                       inputs[0].shape)
    n_valid = inputs[3].sum().item()
    rec = {"shape": list(inputs[0].shape), "iters": 2, "clip": 0.5, "tf32": False}
    for train_bn in (False, True):
        tcfg = RT.RaftTrainConfig(lr=1e-4, num_steps=10, iters=2, add_noise=True, clip=0.5,
                                  train_bn=train_bn)
        out = {}
        for impl in ("allpairs", "alt"):
            for where in ("cpu", "cuda"):
                state = RT.init_raft_train_state(copy.deepcopy(model), tcfg, device=where)
                K.reset_launch_counts()
                m = RT.raft_train_step(state, *inputs, R.RAFTConfig(corr_impl=impl), tcfg,
                                       draws=draws)
                check(not any(K.launch_counts().values()),
                      f"the RAFT step launched a kernel: {K.launch_counts()}")
                out[impl, where] = ({k: float(v) for k, v in m.items()},
                                    {k: v.cpu() for k, v in state.model.state_dict().items()},
                                    {k: p.grad.cpu() for k, p in state.model.named_parameters()})
        bn = "train_bn" if train_bn else "frozen_bn"
        for a, b in ((("allpairs", "cuda"), ("allpairs", "cpu")), (("alt", "cuda"), ("alt", "cpu")),
                     (("alt", "cuda"), ("allpairs", "cuda"))):
            name = f"{bn}_{a[0]}_{a[1]}_vs_{b[0]}_{b[1]}"
            rec[name] = _raft_steps_agree(out[a], out[b], before, tcfg.lr, n_valid,
                                          train_bn, name)
        rec[f"{bn}_card_metrics"] = out["allpairs", "cuda"][0]
    rec["float64_seed9"] = raft_float64_gate()
    return rec


def raft_float64_gate():
    """The seed-9 step of tests/test_torch_cuda.py::test_raft_train_step_card_vs_cpu
    (raft-things widths, (2, 3, 48, 64), 2 iterations, noise, clip 0.5,
    all-pairs, both BN modes), card against CPU in float32 (TF32 off) and
    in float64: the gradients' relative L2 in each. Float64 leaves float32's
    rounding flips (a ReLU input within rounding of zero) no room; a real
    fault would stay. Gate: float64 within RAFT_F64_GRAD_REL_L2."""
    import copy

    from vtoonify_tpu_torch.models import raft as R
    from vtoonify_tpu_torch.models import raft_train as RT

    rng = np.random.RandomState(RAFT_F64_SEED)
    model = R.init_raft(R.RAFTConfig(), torch.Generator().manual_seed(RAFT_F64_SEED))
    inputs = (torch.from_numpy((rng.rand(2, 3, 48, 64) * 255).astype(np.float32)),
              torch.from_numpy((rng.rand(2, 3, 48, 64) * 255).astype(np.float32)),
              torch.from_numpy((rng.randn(2, 2, 48, 64) * 3.0).astype(np.float32)),
              torch.from_numpy((rng.rand(2, 48, 64) > 0.2).astype(np.float32)))
    draws = RT.sample_raft_train_draws(torch.Generator().manual_seed(RAFT_F64_SEED + 1),
                                       inputs[0].shape)
    rec = {}
    for train_bn in (False, True):
        tcfg = RT.RaftTrainConfig(lr=1e-4, num_steps=10, iters=2, add_noise=True,
                                  clip=0.5, train_bn=train_bn)
        for dtype in (torch.float32, torch.float64):
            out = {}
            for where in ("cpu", "cuda"):
                state = RT.init_raft_train_state(copy.deepcopy(model).to(dtype), tcfg,
                                                 device=where)
                m = RT.raft_train_step(
                    state, *(t.to(dtype) for t in inputs), R.RAFTConfig(), tcfg,
                    draws=RT.RaftTrainDraws(draws.stdv.to(dtype), draws.noise1.to(dtype),
                                            draws.noise2.to(dtype)))
                out[where] = (float(m["loss"]), {k: p.grad.cpu()
                                                 for k, p in state.model.named_parameters()})
            name = f"{'train_bn' if train_bn else 'frozen_bn'}_{str(dtype)[6:]}"
            rec[name] = {"loss_rel_err": abs(out["cuda"][0] - out["cpu"][0])
                         / max(abs(out["cpu"][0]), 1e-30),
                         "grad_rel_l2": _grads_rel_l2(out["cuda"][1], out["cpu"][1])}
        check(rec[name]["grad_rel_l2"] <= RAFT_F64_GRAD_REL_L2,
              f"RAFT seed-{RAFT_F64_SEED} step card vs CPU in float64: {rec}")
    return rec


def _raft_batch(batch, hw, g):
    """Device-resident synthetic frames (smooth, in [0, 255]), flow and a
    full valid mask."""
    h, w = hw
    img = F.interpolate(torch.rand((batch, 3, h // 16, w // 16), generator=g, device="cuda"),
                        size=(h, w), mode="bilinear", align_corners=False) * 255
    img2 = torch.roll(img, (2, -3), dims=(2, 3))
    flow = F.interpolate(torch.randn((batch, 2, h // 32, w // 32), generator=g, device="cuda"),
                         size=(h, w), mode="bilinear", align_corners=False) * 8
    return img, img2, flow, torch.ones((batch, h, w), device="cuda")


def raft_step_flops(batch, hw):
    """The FLOPs of one RAFT train step's forward and backward at
    RAFT_ITERS iterations: convolutions and matmuls, counted from shapes by
    torch.utils.flop_counter on meta tensors (nothing runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    from vtoonify_tpu_torch.models import raft as R
    from vtoonify_tpu_torch.models import raft_train as RT
    from vtoonify_tpu_torch.nn.layers import set_trainable

    model = set_trainable(R.init_raft(R.RAFTConfig(), torch.Generator().manual_seed(0))
                          .to("meta"))
    img = torch.zeros((batch, 3, *hw), device="meta")
    with FlopCounterMode(display=False) as fc:
        preds = R.raft_apply(model, img, img, R.RAFTConfig(), iters=RAFT_ITERS,
                             test_mode=False, train_bn=True)
        RT.sequence_loss(preds, torch.zeros((batch, 2, *hw), device="meta"),
                         torch.ones((batch, *hw), device="meta"))[0].backward()
    return fc.get_total_flops()


def raft_timed(smi, name, batch, hw, train_bn, mixed, lr, wdecay):
    """One recipe of upstream RAFT's train_standard.sh on the card in the
    trainer's precision (TF32; bf16 autocast with mixed): 1 warm-up step,
    RAFT_TIMED_STEPS timed, 1 profiled."""
    from vtoonify_tpu_torch.models import raft as R
    from vtoonify_tpu_torch.models import raft_train as RT

    model = R.init_raft(R.RAFTConfig(), torch.Generator().manual_seed(SEED + 22))
    tcfg = RT.RaftTrainConfig(lr=lr, wdecay=wdecay, num_steps=100000, iters=RAFT_ITERS,
                              train_bn=train_bn, mixed_precision=mixed)
    state = RT.init_raft_train_state(model, tcfg)
    data = _raft_batch(batch, hw, torch.Generator("cuda").manual_seed(SEED + 23))
    cfg = R.RAFTConfig()
    rec, launches = _timed_steps(lambda: RT.raft_train_step(state, *data, cfg, tcfg),
                                 RAFT_TIMED_STEPS, (), f"raft_train_{name}_profile.txt")
    flops = raft_step_flops(batch, hw)
    rec.update(recipe=name, batch=batch, image_size=list(hw), iters=RAFT_ITERS,
               train_bn=train_bn, precision="bf16 autocast" if mixed else "tf32",
               lr=lr, wdecay=wdecay, nvidia_smi=smi, step_tflop=flops / 1e12,
               achieved_tflops=flops / rec["p50_s_per_iter"] / 1e12)
    del state, data, model
    torch.cuda.empty_cache()
    return rec, launches


def _write_pfm(path, data):
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode())
        f.write(np.flipud(data).astype("<f4").tobytes())


def write_flow_trees(root, seed):
    """Synthetic trees in the trainer's --data_root layout, at the datasets'
    frame sizes: FlyingChairs (384 x 512 .ppm pairs, .flo, a split file:
    RAFT_CLI_CHAIRS pairs, the last 4 for validation), FlyingThings3D (540 x
    960 .png, 3-channel .pfm flow, one sequence of 4 frames, both passes and
    directions: 12 pairs) and Sintel (436 x 1024 .png, two scenes of 3
    frames: training with .flo flow, test clean and final)."""
    import os

    import cv2

    from vtoonify_tpu_torch.models import raft_data as RD

    rng = np.random.RandomState(seed)

    def img(path, h, w):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        small = rng.randint(0, 256, (h // 16, w // 16, 3)).astype(np.uint8)
        cv2.imwrite(path, cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR))

    def flow(h, w):
        return cv2.resize((rng.randn(h // 32, w // 32, 2) * 8).astype(np.float32), (w, h))

    chairs = os.path.join(root, "FlyingChairs_release", "data")
    for i in range(1, RAFT_CLI_CHAIRS + 1):
        for t in (1, 2):
            img(os.path.join(chairs, f"{i:05d}_img{t}.ppm"), 384, 512)
        RD.write_flo(os.path.join(chairs, f"{i:05d}_flow.flo"), flow(384, 512))
    with open(os.path.join(root, "chairs_split.txt"), "w") as f:
        f.write("1\n" * (RAFT_CLI_CHAIRS - 4) + "2\n" * 4)
    things = os.path.join(root, "FlyingThings3D")
    for i in range(4):
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            img(os.path.join(things, dstype, "TRAIN", "A", "0000", "left", f"{i:04d}.png"),
                540, 960)
        for direction in ("into_future", "into_past"):
            d = os.path.join(things, "optical_flow", "TRAIN", "A", "0000", direction, "left")
            os.makedirs(d, exist_ok=True)
            _write_pfm(os.path.join(d, f"OpticalFlowInto{i:04d}.pfm"),
                       np.concatenate([flow(540, 960), np.zeros((540, 960, 1), np.float32)],
                                      axis=-1))
    for scene in ("alley_1", "cave_2"):
        for i in (1, 2, 3):
            img(os.path.join(root, "Sintel", "training", "clean", scene, f"frame_{i:04d}.png"),
                436, 1024)
            for dstype in ("clean", "final"):
                img(os.path.join(root, "Sintel", "test", dstype, scene, f"frame_{i:04d}.png"),
                    436, 1024)
        d = os.path.join(root, "Sintel", "training", "flow", scene)
        os.makedirs(d, exist_ok=True)
        for i in (1, 2):
            RD.write_flo(os.path.join(d, f"frame_{i:04d}.flo"), flow(436, 1024))


def raft_cli(root):
    """The trainer command on the card over the synthetic trees in `root`,
    at the chairs and things recipes: RAFT_CLI_STEPS steps of --stage chairs
    --validation chairs, its .ckpt restored into --stage things --validation
    sintel; then the eval command on a reference-format .pth of the result:
    the Sintel validation, and a Sintel submission with --warm_start. The
    CLI's s/it (host augmentation included; the first step left out)."""
    import contextlib
    import glob
    import io
    import os

    from vtoonify_tpu_torch.models import raft as R
    from vtoonify_tpu_torch.models import raft_data as RD
    from vtoonify_tpu_torch.models import raft_eval as RE
    from vtoonify_tpu_torch.models import raft_train as RT

    rec, out_dir = {}, OUT_DIR.resolve()  # the commands run inside `root`
    common = ["--data_root", root, "--num_steps", str(RAFT_CLI_STEPS),
              "--val_freq", str(RAFT_CLI_STEPS), "--iters", str(RAFT_ITERS)]
    stages = (("chairs", ["--stage", "chairs", "--validation", "chairs", "--name", "raft-chairs",
                          "--batch_size", "10", "--image_size", "368", "496", "--lr", "0.0004",
                          "--wdecay", "0.0001"]),
              ("things", ["--stage", "things", "--validation", "sintel", "--name", "raft-things",
                          "--restore_ckpt", "checkpoints/raft-chairs.ckpt", "--batch_size", "6",
                          "--image_size", "400", "720", "--lr", "0.000125",
                          "--wdecay", "0.0001"]))
    with contextlib.chdir(root):
        for name, argv in stages:
            buf = io.StringIO()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = RT.main(argv + common)
            text = buf.getvalue()
            (out_dir / f"raft_cli_{name}.txt").write_text(text)
            steps = out["step_seconds"][1:]
            rec[name] = {"argv": " ".join(argv), "seconds": time.perf_counter() - t1,
                         "s_per_it": steps, "p50_s_per_it": float(np.median(steps)),
                         "stdout_tail": text.strip().splitlines()[-3:]}
            check(os.path.exists(out["checkpoint"]) and "epe" in text,
                  f"the {name} trainer wrote no checkpoint or validation: {text[-500:]}")
        model = R.init_raft(R.RAFTConfig(), torch.Generator().manual_seed(0))
        model.load_state_dict(torch.load("checkpoints/raft-things.ckpt", weights_only=True))
        torch.save(raft_reference_state(model), "raft-things.pth")
        common = ["--model", "raft-things.pth", "--dataset", "sintel", "--data_root", root]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t1 = time.perf_counter()
            metrics = RE.main(common)
            rec["eval_sintel"] = {**metrics, "seconds": time.perf_counter() - t1}
            t1 = time.perf_counter()
            sub = RE.main(common + ["--submission", "submission", "--warm_start"])
            rec["submission"] = {**sub, "seconds": time.perf_counter() - t1}
        files = sorted(glob.glob("submission/*/*/*.flo"))
        check(set(metrics) == {"epe", "1px", "3px", "5px"}
              and all(np.isfinite(v) for v in metrics.values()), f"eval: {metrics}")
        check(sub == {"files": 8} and len(files) == 8
              and all(np.isfinite(RD.read_flo(f)).all() and RD.read_flo(f).shape == (436, 1024, 2)
                      for f in files), f"submission: {sub}, {files}")
    return rec


def raft_train_phase(smi):
    """RAFT training at the raft-things widths: the gates (TF32 off), the
    train_standard.sh recipes timed and profiled in the trainer's precision
    (TF32, and bf16 autocast), and the trainer and eval commands over
    synthetic dataset trees. Returns the launches of B1-B5 over the timed
    steps (all 0: RAFT runs none of them)."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.pipeline.smooth_parsing import float32_precision

    t0 = time.perf_counter()
    rec = {"phase": "raft_train", "raft": "RAFTConfig() (raft-things widths)",
           "nvidia_smi": smi, "gates": raft_train_gates()}
    rec["gates_seconds"] = time.perf_counter() - t0
    launches = collections.Counter()
    with float32_precision(True):
        for recipe in RAFT_RECIPES:
            r, per_step = raft_timed(smi, *recipe)
            rec[recipe[0]] = r
            launches.update(per_step)
            launches.update(K.launch_counts())  # the last timed and the profiled step
        with tempfile.TemporaryDirectory() as tmp:
            t1 = time.perf_counter()
            write_flow_trees(tmp, SEED + 24)
            rec["trees_seconds"] = time.perf_counter() - t1
            rec["cli"] = raft_cli(tmp)
    for name in ("chairs", "things"):
        rec["cli"][name]["bare_step_p50_s"] = rec[name]["p50_s_per_iter"]
        rec["cli"][name]["host_share"] = 1 - (rec[name]["p50_s_per_iter"]
                                              / rec["cli"][name]["p50_s_per_it"])
    check(not any(launches.values()), f"the RAFT train step launched B1-B5: {launches}")
    rec["launches"] = dict(launches)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    torch.cuda.empty_cache()
    return dict(launches)


# ---------------------------------------------------------------------------
# regularise: second-order gradients, R1 and the path-length penalty
# (train/losses.py), the full ADA augment (train/augment_full.py) and the
# auxiliary models (models/psp.py, vgg.py, arcface.py)


def _second_order(fn, inputs, v1, v2):
    """d/d(inputs, v1) <d/d(inputs) <fn(inputs), v1>, v2>: a gradient of a
    gradient whose incoming gradient v1 carries history too, as R1 and the
    path penalty take it; zero where a term vanishes."""
    leaves = [x.detach().clone().requires_grad_() for x in (*inputs, v1)]
    g1 = torch.autograd.grad((fn(*leaves[:-1]) * leaves[-1]).sum(), leaves[:-1],
                             create_graph=True)
    inner = sum((g * v).sum() for g, v in zip(g1, v2))
    return [*(g.detach() for g in g1), *torch.autograd.grad(
        inner, leaves, allow_unused=True, materialize_grads=True)]


def second_order_gates(dev):
    """Each Function's second-order gradient on the card, through the
    wrapper, against the same through its plain version on the same card,
    at backward_cases' main-path shapes, float32; with the kernel's
    launches in the wrapper's run (B3: forward, adjoint and the adjoint's
    adjoint; B5: forward and the image adjoint's adjoint)."""
    from vtoonify_tpu_torch.ops import kernels as K

    rng = np.random.RandomState(SEED + 30)
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    rec = {}
    for name, label, kern, plain, inputs, plain2 in backward_cases(1, dev):
        plain = plain2 or plain
        with torch.no_grad():
            out_shape = plain(*inputs).shape

        def t(shape):
            return torch.randn(shape, generator=g, device=dev)

        v1, v2 = t(out_shape), [t(x.shape) for x in inputs]
        K.reset_launch_counts()
        got = _second_order(kern, inputs, v1, v2)
        torch.cuda.synchronize()
        launches = K.launch_counts()[name]
        want = _second_order(plain, inputs, v1, v2)
        errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(got, want)]
        tol = TOL_WARP_F32 if name == "affine_warp" else TOL_GRAD
        rec[name] = {"shape": label, "max_rel_err": max(errs), "tol": tol,
                     "launches": launches,
                     "finite": all(bool(torch.isfinite(a).all()) for a in got)}
        check(rec[name]["finite"] and max(errs) <= tol,
              f"{name} second order {label}: {rec[name]}")
        check(launches > 0, f"{name}: its second order launched no kernel")
        del got, want, v1, v2
        torch.cuda.empty_cache()
    rec["affine_warp_coef"] = affine_warp_coef_second_order(dev, rng)
    return rec


def affine_warp_coef_second_order(dev, rng):
    """B5 differentiated twice in its image and its coefficients together
    (the coef gradient's derivative and the image gradient's dependence on
    coef), through the wrapper on the card against the same through
    affine_warp_gather_plain on the card: the x2 augment plane of a 256 px
    image under a scaled affine, float32, TOL_WARP_F32."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.train import augment as A

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    hw2x = (2 * 256 + 8, 2 * 256 + 8)
    theta, out_hw = A.warp_theta(torch.eye(3).repeat(2, 1, 1), (256, 256), hw2x)
    theta[:, :, :2] = theta[:, :, :2] * 1.07
    coef = A._pixel_affine_coefs(theta, out_hw, hw2x).to(dev).contiguous()
    inputs = (torch.tanh(t(2, 6, *hw2x)), coef)
    v1, v2 = t(2, 6, *out_hw), [t(2, 6, *hw2x), t(2, 6)]
    K.reset_launch_counts()
    got = _second_order(lambda i, c: K.affine_warp(i, c, out_hw), inputs, v1, v2)
    torch.cuda.synchronize()
    launches = K.launch_counts()["affine_warp"]
    want = _second_order(lambda i, c: K.affine_warp_gather_plain(i, c, out_hw),
                         inputs, v1, v2)
    errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
            for a, b in zip(got, want)]
    rec = {"shape": f"(2,6,{hw2x[0]},{hw2x[1]}) -> {out_hw}, coef (2,6)",
           "max_rel_err": max(errs), "coef_rel_err": errs[-2], "tol": TOL_WARP_F32,
           "launches": launches,
           "finite": all(bool(torch.isfinite(a).all()) for a in got)}
    check(rec["finite"] and max(errs) <= TOL_WARP_F32,
          f"affine_warp second order in coef: {rec}")
    check(launches > 0, "affine_warp: its second order in coef launched no kernel")
    return rec


def _rel_l2(a, b):
    return ((a - b).norm() / max(b.norm().item(), 1e-30)).item()


def _grads_rel_l2(a, b):
    keys = sorted(b)
    check(sorted(a) == keys, f"gradients of different parameters: {sorted(a)} vs {keys}")
    return (sum(((a[k] - b[k]) ** 2).sum() for k in keys)
            / sum((b[k] ** 2).sum() for k in keys)).sqrt().item()


def regulariser_gates():
    """R1 (through the full ADA augment at p = 0.6: B5, B3; the
    Discriminator: B2, B3) and the path-length penalty (through the mapping
    network and the synthesis: B1-B4) at REG_GATE_PX, batch 2, the flagship
    widths, card against CPU from the same modules and draws, float32 with
    TF32 off: the penalty, and its gradients w.r.t. every parameter."""
    import copy

    from vtoonify_tpu_torch.models import generator as G
    from vtoonify_tpu_torch.nn.layers import set_trainable
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.train import augment_full as AU
    from vtoonify_tpu_torch.train import losses as LS

    g = torch.Generator().manual_seed(SEED + 31)
    px, b = REG_GATE_PX, REG_GATE_BATCH
    dcfg, gcfg = G.DiscriminatorConfig(size=px), G.GeneratorConfig(size=px)
    disc = set_trainable(G.init_discriminator(dcfg, g))
    gen = set_trainable(G.init_generator(gcfg, g))
    with torch.no_grad():  # non-zero noise weights and biases, as trained
        for blk in [gen.conv1, *gen.convs]:
            blk.noise.weight.uniform_(0.05, 0.2, generator=g)
            blk.act_bias.normal_(0.0, 0.3, generator=g)
    real = torch.tanh(torch.randn((b, 3, px, px), generator=g))
    Ginv = torch.linalg.inv(AU.sample_affine_full(g, ADA_P, b, px, px))
    Cm = AU.sample_color(g, ADA_P, b)
    z = LS.mixing_noise(g, b, gcfg.style_dim, 1.0)
    noise = G.make_noise(gen, gcfg, g, batch=b)
    img_noise = torch.randn((b, 3, px, px), generator=g) / px

    def r1(where):
        d = copy.deepcopy(disc).to(where)
        loss = LS.d_r1_loss(lambda x: G.discriminator_apply(
            d, dcfg, AU.augment(x, ADA_P, G=Ginv, C=Cm)[0]), real.to(where))
        loss.backward()
        return loss.item(), {k: p.grad.cpu() for k, p in d.named_parameters()
                             if p.grad is not None}

    def path(where):
        gn = copy.deepcopy(gen).to(where)
        lat = G.styles_to_latent(gn, gcfg, [v.to(where) for v in z], inject_index=3)
        pen, mean, lengths = LS.g_path_regularize(
            lambda w: G.generator_apply(gn, gcfg, w, noise=[n.to(where) for n in noise]),
            lat, 0.5, noise=img_noise.to(where))
        pen.backward()
        return pen.item(), {k: p.grad.cpu() for k, p in gn.named_parameters()
                            if p.grad is not None}

    rec = {"px": px, "batch": b, "widths": "flagship (channel_multiplier 2)",
           "ada_p": ADA_P, "tf32": False}
    for name, fn, expect in (("r1", r1, ("fused_leaky_relu", "upfirdn2d", "affine_warp")),
                             ("path", path, ("modconv3x3", "fused_leaky_relu",
                                             "upfirdn2d", "depth_to_space2"))):
        t1 = time.perf_counter()
        cpu_loss, cpu_grads = fn("cpu")
        cpu_s = time.perf_counter() - t1
        K.reset_launch_counts()
        card_loss, card_grads = fn("cuda")
        launches = K.launch_counts()
        r = {"cpu": cpu_loss, "card": card_loss, "cpu_seconds": cpu_s,
             "rel_err": abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-30),
             "grads_rel_l2": _grads_rel_l2(card_grads, cpu_grads),
             "n_param_grads": len(cpu_grads), "launches": launches}
        rec[name] = r
        check(np.isfinite(card_loss) and r["rel_err"] <= REG_GATE_RTOL
              and r["grads_rel_l2"] <= REG_GATE_GRAD_REL_L2, f"{name} card vs CPU: {r}")
        for k in expect:
            check(launches[k] > 0, f"{name} on the card launched no {k}")
    return rec


def conv_shape_profile(fn, top=8):
    """One fn() under torch.profiler with shapes: the convolution ops
    (aten::convolution's children) with the most device time, each with
    its input shapes, count and device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages(group_by_input_shape=True)
    key = ("device_time_total" if hasattr(avgs[0], "device_time_total")
           else "cuda_time_total")
    convs = sorted((e for e in avgs if e.key == "aten::_convolution"),
                   key=lambda e: getattr(e, key), reverse=True)
    return [{"op": e.key, "input_shapes": str(e.input_shapes[:2]), "count": e.count,
             "device_ms": getattr(e, key) / 1e3} for e in convs[:top]]


def reg_timed(smi):
    """One R1 D step and one path-length G step of the flagship StyleGAN2
    (GeneratorConfig(), DiscriminatorConfig(size=1024)) in rosinality's
    recipe (REG_* above), timed and profiled, each step's launches
    recorded."""
    from vtoonify_tpu_torch.models import generator as G
    from vtoonify_tpu_torch.nn.layers import set_trainable
    from vtoonify_tpu_torch.train import augment_full as AU
    from vtoonify_tpu_torch.train import losses as LS

    g = torch.Generator().manual_seed(SEED + 32)
    gcfg, dcfg = G.GeneratorConfig(), G.DiscriminatorConfig(size=1024)
    gen = set_trainable(G.init_generator(gcfg, g)).cuda()
    disc = set_trainable(G.init_discriminator(dcfg, g)).cuda()
    g_ratio, d_ratio = G_REG_EVERY / (G_REG_EVERY + 1), D_REG_EVERY / (D_REG_EVERY + 1)
    g_optim = torch.optim.Adam(gen.parameters(), lr=0.002 * g_ratio,
                               betas=(0.0, 0.99 ** g_ratio))
    d_optim = torch.optim.Adam(disc.parameters(), lr=0.002 * d_ratio,
                               betas=(0.0, 0.99 ** d_ratio))
    ada = AU.AdaptiveAugment(0.6, 500 * 1000, 256)
    ada.ada_aug_p = ADA_P
    cg = torch.Generator(device="cuda").manual_seed(SEED + 33)
    real = torch.tanh(torch.randn((REG_BATCH, 3, 1024, 1024), generator=cg, device="cuda"))
    path_batch = max(1, REG_BATCH // PATH_BATCH_SHRINK)
    mean_path = [torch.zeros((), device="cuda")]

    def r1_step():
        def d_fn(x):
            return G.discriminator_apply(disc, dcfg, AU.augment(x, ada.ada_aug_p,
                                                                generator=cg)[0])
        r1 = LS.d_r1_loss(d_fn, real)
        d_optim.zero_grad(set_to_none=True)
        (R1_GAMMA / 2 * r1 * D_REG_EVERY).backward()
        d_optim.step()
        return {"r1_loss": r1.detach()}

    def path_step():
        z = LS.mixing_noise(cg, path_batch, gcfg.style_dim, MIXING, device="cuda")
        inject = (None if len(z) == 1 else
                  int(torch.randint(1, gcfg.n_latent, (1,), generator=g)))
        lat = G.styles_to_latent(gen, gcfg, z, inject_index=inject)
        noise = G.make_noise(gen, gcfg, cg, batch=path_batch, device="cuda")
        pen, mean_path[0], lengths = LS.g_path_regularize(
            lambda w: G.generator_apply(gen, gcfg, w, noise=noise), lat, mean_path[0],
            generator=cg)
        g_optim.zero_grad(set_to_none=True)
        (PATH_REGULARIZE * G_REG_EVERY * pen).backward()
        g_optim.step()
        return {"path_loss": pen.detach(), "mean_path_length": mean_path[0],
                "path_length": lengths.mean().detach()}

    out, launches = {}, {}
    for name, run, expect in (
            ("r1_d_step", r1_step, ("fused_leaky_relu", "upfirdn2d", "affine_warp")),
            ("path_g_step", path_step, ("modconv3x3", "fused_leaky_relu", "upfirdn2d",
                                        "depth_to_space2"))):
        before = _flat(disc if name == "r1_d_step" else gen)
        rec, launches[name] = _timed_steps(run, REG_STEPS, expect, f"reg_{name}_profile.txt")
        rec["conv_shapes"] = conv_shape_profile(run)
        rec["moved_abs_sum"] = (_flat(disc if name == "r1_d_step" else gen)
                                - before).abs().sum().item()
        check(rec["moved_abs_sum"] > 0, f"{name}: the parameters did not move")
        out[name] = rec
    out["path_g_step"]["path_batch"] = path_batch
    out["params"] = {"generator": sum(p.numel() for p in gen.parameters()),
                     "discriminator": sum(p.numel() for p in disc.parameters())}
    del gen, disc, g_optim, d_optim, real
    torch.cuda.empty_cache()
    return out, launches


def aux_models_vs_cpu():
    """The full pSp (output_size 1024, resize to 256, codes returned) on a
    256 px face, VGG19's features and loss at 256 px and ArcFace's id_loss
    on 256 px images: forward once on the card against the CPU, float32,
    TF32 off; then one timed call of each on the card (pSp profiled), with
    its launches."""
    import copy

    from vtoonify_tpu_torch.models import arcface as AF
    from vtoonify_tpu_torch.models import psp as P
    from vtoonify_tpu_torch.models import vgg as VG
    from vtoonify_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED + 34)
    cfg = P.PSPConfig(output_size=1024)
    psp = P.init_psp(cfg, g)
    with torch.no_grad():
        psp.latent_avg.normal_(0.0, 0.3, generator=g)
        for blk in psp.decoder.convs:  # contrast in the random-weight image
            blk.act_bias.normal_(0.0, 0.5, generator=g)
    vgg, arc = VG.init_vgg19(g), AF.init_arcface_backbone(112, g)
    face = torch.tanh(torch.randn((1, 3, 256, 256), generator=g))
    x, y = (torch.tanh(torch.randn((2, 3, 256, 256), generator=g)) for _ in range(2))
    calls = {
        "psp": (psp, lambda m, dev: P.psp_apply(m, cfg, face.to(dev), resize=True,
                                                return_latents=True)),
        "vgg19": (vgg, lambda m, dev: (*VG.vgg19_features(m, x.to(dev)),
                                       VG.vgg_loss(m, x.to(dev), y.to(dev)))),
        "arcface": (arc, lambda m, dev: (AF.arcface_apply(m, x[:, :, :112, :112].to(dev)),
                                         AF.id_loss(m, x.to(dev), y.to(dev)))),
    }
    rec = {}
    for name, (module, fn) in calls.items():
        with torch.no_grad():
            t1 = time.perf_counter()
            want = fn(module, "cpu")
            cpu_s = time.perf_counter() - t1
            card = copy.deepcopy(module).cuda()
            got = fn(card, "cuda")
            errs = [_rel_l2(a.cpu().reshape(-1), b.reshape(-1)) for a, b in zip(got, want)]
            K.reset_launch_counts()
            ms, out = _sync_ms(lambda: fn(card, "cuda"))
            launches = K.launch_counts()
        r = {"rel_l2": errs, "card_ms": ms, "cpu_seconds": cpu_s, "launches": launches,
             "finite": all(bool(torch.isfinite(a).all()) for a in out)}
        if name == "psp":
            r["image_shape"], r["codes_shape"] = list(out[0].shape), list(out[1].shape)
            check(r["image_shape"] == [1, 3, 256, 256] and r["codes_shape"] == [1, 18, 512],
                  f"psp shapes {r}")
            with torch.no_grad():
                r["profile"] = device_profile(lambda: fn(card, "cuda"), "reg_psp_profile.txt")
            for k in ("modconv3x3", "upfirdn2d", "depth_to_space2"):
                check(launches[k] > 0, f"the pSp decoder launched no {k}")
        rec[name] = r
        check(r["finite"] and max(errs) <= AUX_REL_L2, f"{name} card vs CPU: {r}")
        del card, want, got, out
        torch.cuda.empty_cache()
    return rec


def regularise_phase(smi):
    """The second-order gates, the regulariser gates at 64 px and the
    auxiliary models card vs CPU (TF32 off); then the flagship R1 D step and
    path-length G step timed in cuDNN's default TF32 convs. Returns the
    launches of B1-B5 in the phase's main path: one R1 D step, one path G
    step and one pSp forward."""
    t0 = time.perf_counter()
    rec = {"phase": "regularise", "nvidia_smi": smi,
           "config": "rosinality stylegan2-pytorch train.py at 1024 px (config-f): "
                     "GeneratorConfig(), DiscriminatorConfig(size=1024), batch 4, "
                     f"path batch {REG_BATCH // PATH_BATCH_SHRINK}, r1 {R1_GAMMA}, "
                     f"path_regularize {PATH_REGULARIZE}, mixing {MIXING}, ADA p {ADA_P}, "
                     "float32"}
    rec["second_order"] = second_order_gates(torch.device("cuda"))
    rec["gates"] = regulariser_gates()
    rec["aux_models"] = aux_models_vs_cpu()
    rec["gates_seconds"] = time.perf_counter() - t0
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as upstream trains
    try:
        timed, launches = reg_timed(smi)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    rec.update(timed)
    total = collections.Counter()
    for part in (launches["r1_d_step"], launches["path_g_step"],
                 rec["aux_models"]["psp"]["launches"]):
        total.update(part)
    rec["launches"] = dict(total)
    rec["seconds"] = time.perf_counter() - t0
    (OUT_DIR / "regularise.json").write_text(json.dumps(rec, indent=1))
    emit({k: v for k, v in rec.items() if k not in ("aux_models",)}
         | {"aux_models": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                           for k, v in rec["aux_models"].items()}})
    return dict(total)


# ---------------------------------------------------------------------------
# distributed: frame-parallel serving and data-parallel training


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def dist_serving(smi):
    """The flagship pipeline (bf16, batch 16) over a mesh of two replicas on
    cuda:0: bit-equal to the pipeline without a mesh on each replica's 8
    frames, within DP_SERVE_*_LSB of it on all 16 at once; both timed in
    turns, and the mesh over every visible card. Returns the record and the
    launches of one frame-parallel call."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.parallel.mesh import make_mesh
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    t0 = time.perf_counter()
    cfg, vt, parsing = build_modules()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 40)
    frames = rng.randint(0, 256, (16, 256, 256, 3)).astype(np.uint8)
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    pipes = {"one_device": ToonifyPipeline(vt, cfg, parsing),
             "mesh_2x_cuda0": ToonifyPipeline(vt, cfg, parsing, mesh=make_mesh(
                 devices=["cuda:0", "cuda:0"])),
             "mesh_all_cards": ToonifyPipeline(vt, cfg, parsing, mesh=make_mesh())}
    del vt, parsing
    dp = pipes["mesh_2x_cuda0"]
    check(len(dp._replicas) == 2, "the mesh pipeline did not make two replicas")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out_dp = dp.process_batch(frames, s_w, 0.5)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    one = pipes["one_device"]
    out_one = one.process_batch(frames, s_w, 0.5)
    out_halves = torch.cat([one.process_batch(frames[i:i + 8], s_w, 0.5) for i in (0, 8)])
    diff = (out_dp.int() - out_one.int()).abs()
    rec = {"config": "VToonifyConfig() + BiSeNet, bf16, batch 16, 256 -> 1024 px",
           "build_seconds": build_s, "launches_per_call": launches,
           "bit_equal_per_replica_batch": bool(torch.equal(out_dp, out_halves)),
           "bit_equal_batch_16": bool(torch.equal(out_dp, out_one)),
           "vs_batch_16_max_lsb": diff.max().item(),
           "vs_batch_16_mean_lsb": diff.float().mean().item(),
           "bound_max_mean_lsb": [DP_SERVE_MAX_LSB, DP_SERVE_MEAN_LSB],
           "out_std_lsb": out_dp.float().std().item(),
           "cards_visible": torch.cuda.device_count()}
    check(tuple(out_dp.shape) == (16, 1024, 1024, 3) and out_dp.dtype == torch.uint8,
          f"frame-parallel output {tuple(out_dp.shape)} {out_dp.dtype}")
    for name in ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"):
        check(launches[name] > 0, f"kernel {name} was not launched by frame-parallel serving")
    check(rec["bit_equal_per_replica_batch"] and rec["out_std_lsb"] > 10
          and rec["vs_batch_16_max_lsb"] <= DP_SERVE_MAX_LSB
          and rec["vs_batch_16_mean_lsb"] <= DP_SERVE_MEAN_LSB,
          f"frame-parallel pipeline differs from one device: {rec}")
    for name in ("one_device", "mesh_2x_cuda0", "one_device", "mesh_2x_cuda0",
                 "mesh_all_cards"):
        ms = host_ms(lambda: pipes[name].process_batch(frames, s_w, 0.5), reps=5)
        rec.setdefault(f"{name}_ms_per_call", []).append(ms)
    for name in pipes:
        rec[f"{name}_fps"] = 16e3 / float(np.median(rec[f"{name}_ms_per_call"]))
    del pipes, dp, one, out_dp, out_one, out_halves
    torch.cuda.empty_cache()
    return rec, launches


_DIST_BUILT = {}  # _dist_setup's modules and inputs, built once a process


def _dist_setup(compute_dtype="bfloat16"):
    """train_phase's flagship stage-2 configuration, global batch
    DIST_BATCH: CPU modules from one seed, the same in every process and
    for either dtype (train_setup does not read tcfg), built once and
    handed out as copies."""
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig, VToonifyConfig
    from vtoonify_tpu_torch.train.steps import TrainDConfig

    cfg = VToonifyConfig()
    dcfg = CondDiscriminatorConfig(size=256, channel_multiplier=2, use_condition=True,
                                   style_num=4)
    tcfg = TrainDConfig(compute_dtype=compute_dtype)
    if not _DIST_BUILT:
        _DIST_BUILT["setup"] = train_setup(cfg, dcfg, tcfg, DIST_BATCH,
                                           torch.Generator().manual_seed(SEED + 41))
    pcfg, mods, inputs = copy.deepcopy(_DIST_BUILT["setup"])
    return (cfg, dcfg, tcfg, pcfg), mods, inputs


def _tiny_t_setup():
    """The trainers' --tiny VToonify-T stage-2 configuration (float32),
    global batch DIST_TINY_BATCH, noise weights and biases non-zero."""
    from vtoonify_tpu_torch.models.generator import init_generator
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig, VToonifyConfig
    from vtoonify_tpu_torch.train.steps import TrainDConfig

    g = torch.Generator().manual_seed(SEED + 42)
    cfg = VToonifyConfig(backbone="toonify", **TINY_VT)
    dcfg = CondDiscriminatorConfig(size=64, channel_multiplier=1)
    tcfg = TrainDConfig(crop_size=96, lpips_size=64, aug_max_pad=40)
    pcfg, mods, inputs = train_setup(cfg, dcfg, tcfg, DIST_TINY_BATCH, g)
    mods["base"] = init_generator(cfg.generator, g)
    with torch.no_grad():
        for gen in (mods["base"], mods["vt"].generator):
            for blk in [gen.conv1, *gen.convs]:
                blk.noise.weight.fill_(0.1)
                blk.act_bias.normal_(0.0, 0.3, generator=g)
    return (cfg, dcfg, tcfg, pcfg), mods, inputs


def _state_result(state, metrics):
    """_step_result without a time: metrics, new parameters and gradients
    of the student and the discriminator, sizes, EMA."""
    return _step_result(state, metrics, None)


def _dist_compare(rec, prefix, got, ref, lr):
    """A one-process or 2-rank step's results against a one-process step's
    on the same global batch, recorded in `rec` under `prefix`: the relative
    L2 of the metrics, the EMA, the gradients (Adam's first moment over 1 -
    beta1: what data parallelism averages) and the new parameters; the
    largest update difference over lr; and Adam's first updates as
    tests/test_torch_train_step.py compares them, on the elements whose |g|
    is above 1e-3 of its parameter's largest and above 100 eps (Adam's
    first step moves every element by ~lr whatever its gradient, so one
    whose gradient is at the rounding noise moves by +-lr either side):
    their relative L2, largest difference over lr and share above 1e-3 lr,
    and the share of the elements of both optimizers they cover."""
    from vtoonify_tpu_torch.train.steps import ADAM_EPS

    keys = sorted(ref["metrics"])
    rec[f"{prefix}metrics_rel_l2"] = _rel_l2(
        torch.tensor([got["metrics"][k] for k in keys], dtype=torch.float64),
        torch.tensor([ref["metrics"][k] for k in keys], dtype=torch.float64))
    rec[f"{prefix}ema_rel_l2"] = _rel_l2(got["ema"], ref["ema"])
    covered = total = 0
    for k in ref["new"]:
        rec[f"{prefix}{k}_grad_rel_l2"] = _rel_l2(got["grads"][k], ref["grads"][k])
        rec[f"{prefix}{k}_rel_l2"] = _rel_l2(got["new"][k], ref["new"][k])
        err = (got["new"][k] - ref["new"][k]).abs()  # the same start
        rec[f"{prefix}{k}_max_err_over_lr"] = err.max().item() / lr
        mask = torch.cat([(gi > 1e-3 * gi.max()) & (gi > 100 * ADAM_EPS)
                          for gi in ref["grads"][k].abs().split(ref["sizes"][k])])
        e = err[mask]
        rec[f"{prefix}{k}_masked_rel_l2"] = _rel_l2(got["new"][k][mask], ref["new"][k][mask])
        rec[f"{prefix}{k}_masked_max_err_over_lr"] = e.max().item() / lr if e.numel() else 0.0
        rec[f"{prefix}{k}_masked_share_over_1e-3_lr"] = (
            (e > 1e-3 * lr).float().mean().item() if e.numel() else 0.0)
        covered, total = covered + int(mask.sum()), total + mask.numel()
    rec[f"{prefix}mask_share"] = covered / total


def _dist_gate_failures(rec):
    """{key: (reading, bound)} of every DIST_GATES reading out of bounds,
    and of every flagship 2-rank gradient gap above DIST_WITNESS_RATIO x
    its witnesses' larger one."""
    bad = {}
    for key, op, bound in DIST_GATES:
        for name in {key.format(k=k) for k in ("trainable", "d")}:
            v = rec[name]
            if not (v <= bound if op == "<=" else v >= bound):
                bad[name] = (v, bound)
    for which in ("d", "d_f32"):
        for k in ("trainable", "d"):
            name = f"two_ranks_{which}_{k}_grad_rel_l2"
            bound = DIST_WITNESS_RATIO * max(rec[f"witness_{which}_{w}_{k}_grad_rel_l2"]
                                             for w in DIST_WITNESSES)
            if not rec[name] <= bound:
                bad[f"{name}_vs_witnesses"] = (rec[name], bound)
    return bad


@contextlib.contextmanager
def synthesis_row_by_row():
    """The stage-2 teacher synthesis (synth.synth_train_batch) run a row of
    the batch at a time, its outputs concatenated: the same function (the
    synthesis is per row), rounded as a rank of one row rounds it."""
    from vtoonify_tpu_torch.train import synth

    real = synth.synth_train_batch

    def per_row(draws, vt, cfg, parsing, psp, psp_cfg, latent_avg, directions, style,
                d_s, weights, wc_prev, *args, **kw):
        outs = [real(draws._map(lambda t: t[i:i + 1]), vt, cfg, parsing, psp, psp_cfg,
                     latent_avg, directions, style[i:i + 1], d_s, weights,
                     wc_prev[i:i + 1], *args, **kw) for i in range(len(style))]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    synth.synth_train_batch = per_row
    try:
        yield
    finally:
        synth.synth_train_batch = real


def _dist_witnesses(rec, prefix, setup, mods_cpu, inputs, ref, lr):
    """Where a 2-rank step's gap to `ref` comes from: two one-process steps
    of the same function on the same global batch with other float
    rounding, each compared with `ref` as the 2-rank step is.
    `rows_swapped` takes the global batch's rows (and every draw's) in the
    other order: the step is symmetric in its rows, only the order of the
    sums over the batch changes. `synthesis_per_row` runs the teacher
    synthesis a row at a time, as each rank of one row does
    (synthesis_row_by_row). Returns {witness: its results}."""
    from vtoonify_tpu_torch.train import steps as S

    cfg, dcfg, tcfg, pcfg = setup
    results = {}
    for name in DIST_WITNESSES:
        mods = copy.deepcopy(mods_cpu)
        flip = (lambda t: t.flip(0)) if name == "rows_swapped" else (lambda t: t)
        draws = S.sample_train_d_draws(torch.Generator().manual_seed(SEED + 43), DIST_BATCH,
                                       cfg, tcfg, inputs["directions"].shape[0],
                                       device="cuda")._map(flip)
        state = S.init_train_d_state(mods["vt"], mods["d"], DIST_BATCH, cfg, tcfg)
        _, frozen = S.split_trainable(mods["vt"])
        torch.backends.cudnn.deterministic = True
        try:
            with (synthesis_row_by_row() if name == "synthesis_per_row"
                  else contextlib.nullcontext()):
                metrics = S.train_d_step(
                    state, frozen, mods["parsing"], mods["psp"], pcfg, None, mods["lpips"],
                    cfg, dcfg, tcfg, inputs["directions"], flip(inputs["style"]),
                    flip(inputs["style_ind"]), 0.5, inputs["weights"], 0.3, 0.5, False,
                    draws=draws)
            results[name] = _state_result(state, metrics)
            _dist_compare(rec, f"{prefix}{name}_", results[name], ref, lr)
        finally:
            torch.backends.cudnn.deterministic = False
        del state, frozen, mods
        torch.cuda.empty_cache()
    return results


def _dist_d_steps(setup, mods, inputs, seed=SEED + 43):
    """init_train_d_state on the card; returns the state and a function
    that runs one flagship D step of this rank's rows (the draws of the
    global batch from a CPU generator seeded `seed`)."""
    from vtoonify_tpu_torch.parallel import collectives as C
    from vtoonify_tpu_torch.train import steps as S

    cfg, dcfg, tcfg, pcfg = setup
    style, ind = C.local_rows(inputs["style"]), C.local_rows(inputs["style_ind"])
    state = S.init_train_d_state(mods["vt"], mods["d"], len(style), cfg, tcfg)
    _, frozen = S.split_trainable(mods["vt"])
    gen = torch.Generator().manual_seed(seed)

    def step():
        return S.train_d_step(state, frozen, mods["parsing"], mods["psp"], pcfg, None,
                              mods["lpips"], cfg, dcfg, tcfg, inputs["directions"],
                              style, ind, 0.5, inputs["weights"], 0.3, 0.5, False,
                              generator=gen)
    return state, step


def _tiny_t_step(setup, mods, inputs, seed=SEED + 44):
    from vtoonify_tpu_torch.train import steps as S

    cfg, dcfg, tcfg, pcfg = setup
    state = S.init_train_t_state(mods["vt"], mods["d"], tcfg)
    _, frozen = S.split_trainable(mods["vt"])
    metrics = S.train_t_step(state, frozen, mods["base"], mods["parsing"], mods["psp"],
                             pcfg, None, mods["lpips"], cfg, dcfg, tcfg,
                             inputs["directions"], DIST_TINY_BATCH, 0.3,
                             generator=torch.Generator().manual_seed(seed))
    return _state_result(state, metrics)


def _gather_grad_timer():
    """Wraps collectives.gather_grad so that each call's host wall, ending
    in a synchronize, is recorded; returns (the list of ms, undo)."""
    from vtoonify_tpu_torch.parallel import collectives as C

    ms, real = [], C.gather_grad

    def timed(grads):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = real(grads)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        return out

    C.gather_grad = timed

    def undo():
        C.gather_grad = real
    return ms, undo


def dist_rank_main(rank, port, out_dir):
    """One rank of the 2-rank job (gloo with CUDA tensors, both ranks on
    cuda:0): the first flagship D step on its row in bf16 (its gradient
    all-reduces timed) and in float32, and one --tiny T step on its two
    rows, saved to out_dir/rank{rank}.pt."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.parallel import multihost

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    K._library()
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda:0", backend="gloo")
    try:
        res = {}
        setup, mods, inputs = _dist_setup()
        torch.cuda.reset_peak_memory_stats()
        state, step = _dist_d_steps(setup, mods, inputs)
        ms, undo = _gather_grad_timer()
        try:
            res["d"] = _state_result(state, step())
        finally:
            undo()
        res["d_gather_grad_ms"] = ms
        res["d_max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del state, step, mods
        setup, mods, inputs = _dist_setup(None)
        state, step = _dist_d_steps(setup, mods, inputs)
        res["d_f32"] = _state_result(state, step())
        del state, step, mods
        torch.cuda.empty_cache()
        setup, mods, inputs = _tiny_t_setup()
        res["t"] = _tiny_t_step(setup, mods, inputs)
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        multihost.shutdown()


def _nccl_allreduce_ms(fn):
    """Device ms of NCCL's kernels in one fn() under torch.profiler, and
    their count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    nccl = [e for e in avgs if "nccl" in e.key.lower()
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    return (sum(getattr(e, key) for e in nccl) / 1e3,
            sum(e.count for e in nccl), [e.key[:80] for e in nccl])


def dist_training(smi):
    """The flagship D stage-2 step (bf16, global batch 2) without a process
    group and under a 1-rank NCCL group: the first step of each with cuDNN
    deterministic, bit-equal; then 1 warm-up and 3 timed steps each, and
    one NCCL step profiled for its all-reduce. Then the same first step in
    float32 (TF32 off), and the witnesses of both dtypes (_dist_witnesses);
    then that first step over 2 gloo ranks sharing cuda:0 with CUDA tensors
    (1 row each), in bf16 and in float32, and the --tiny T stage-2 step
    (float32) over the same 2 ranks, each against one process
    (_dist_compare) and held to DIST_GATES. Returns the record, the
    launches of one step under the process group and the checks that
    failed."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    setup, mods_cpu, inputs = _dist_setup()
    rec = {"config": "train_phase's: VToonifyConfig() + CondDiscriminatorConfig(256, 2, "
                     "use_condition, style_num=4) + pSp + LPIPS + BiSeNet, "
                     f"TrainDConfig(compute_dtype='bfloat16'), global batch {DIST_BATCH}; "
                     f"--tiny T stage 2 at global batch {DIST_TINY_BATCH}, float32",
           "setup_seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    first, launches = {}, {}
    for mode in ("no_group", "nccl_world_1"):
        if mode == "nccl_world_1":
            multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
        try:
            torch.cuda.reset_peak_memory_stats()
            state, step = _dist_d_steps(setup, copy.deepcopy(mods_cpu), inputs)
            torch.backends.cudnn.deterministic = True
            torch.cuda.synchronize()
            K.reset_launch_counts()
            first[mode] = _state_result(state, step())
            torch.cuda.synchronize()
            launches[mode] = K.launch_counts()
            torch.backends.cudnn.deterministic = False
            times = []
            for i in range(4):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            rec[f"{mode}_s_per_iter"] = times[1:]
            rec[f"{mode}_p50_s_per_iter"] = float(np.median(times[1:]))
            rec[f"{mode}_max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated()
                                                       / 2**30)
            if mode == "nccl_world_1":
                ms, n, names = _nccl_allreduce_ms(step)
                rec["nccl_world_1_allreduce_device_ms"] = ms
                rec["nccl_world_1_allreduce_kernels"] = n
                rec["nccl_kernel_names"] = names
            del state, step
            torch.cuda.empty_cache()
        finally:
            multihost.shutdown()
    for k in ("trainable", "d"):
        rec[f"nccl_world_1_bit_equal_{k}"] = bool(torch.equal(
            first["no_group"]["new"][k], first["nccl_world_1"]["new"][k]))
    rec["nccl_world_1_bit_equal_ema"] = bool(torch.equal(first["no_group"]["ema"],
                                                         first["nccl_world_1"]["ema"]))
    rec["nccl_world_1_bit_equal_metrics"] = (first["no_group"]["metrics"]
                                             == first["nccl_world_1"]["metrics"])
    for name in SOURCES:
        check(launches["nccl_world_1"][name] > 0,
              f"kernel {name} was not launched by the step under the process group")

    # the float32 first step (TF32 off, cuDNN deterministic), the 2-rank
    # job's float32 reference; then the witnesses of both dtypes
    torch.backends.cudnn.deterministic = True
    try:
        f32_setup, f32_mods, _ = _dist_setup(None)
        state, step = _dist_d_steps(f32_setup, copy.deepcopy(f32_mods), inputs)
        first["f32"] = _state_result(state, step())
        del state, step
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    lr = setup[2].lr
    witness = {"d": _dist_witnesses(rec, "witness_d_", setup, mods_cpu, inputs,
                                    first["no_group"], lr),
               "d_f32": _dist_witnesses(rec, "witness_d_f32_", f32_setup, f32_mods, inputs,
                                        first["f32"], lr)}
    del f32_mods

    # 2 ranks on cuda:0 over gloo with CUDA tensors, beside the --tiny T
    # step's one-process reference; their results (hundreds of MB) go to a
    # temporary directory
    port = _free_port()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, "--dist-rank", str(r),
                                   str(port), tmp], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            t_setup, t_mods, t_inputs = _tiny_t_setup()
            t_one = _tiny_t_step(t_setup, t_mods, t_inputs)
            del t_mods
            for p in procs:
                out, _ = p.communicate(
                    timeout=max(1, DIST_DEADLINE_S - (time.perf_counter() - t1)))
                check(p.returncode == 0,
                      f"2-rank worker failed (rc {p.returncode}):\n{out[-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(2)]
    rec["two_ranks_seconds"] = time.perf_counter() - t1
    rec["two_ranks_gather_grad_ms"] = ranks[0]["d_gather_grad_ms"]
    rec["two_ranks_max_memory_allocated_gib"] = [r["d_max_memory_allocated_gib"]
                                                 for r in ranks]
    for which, ref in (("d", first["no_group"]), ("d_f32", first["f32"]), ("t", t_one)):
        got = ranks[0][which]
        for k in ("trainable", "d"):
            check(torch.equal(got["new"][k], ranks[1][which]["new"][k]),
                  f"2-rank {which} step: the ranks hold different {k} parameters")
            check(bool(torch.isfinite(got["new"][k]).all()),
                  f"2-rank {which} step: non-finite {k} parameters")
        _dist_compare(rec, f"two_ranks_{which}_", got, ref, lr)
        if which in witness:
            _dist_compare(rec, f"two_ranks_{which}_vs_synthesis_per_row_", got,
                          witness[which]["synthesis_per_row"], lr)
    rec["seconds"] = time.perf_counter() - t0
    (OUT_DIR / "distributed_training.json").write_text(json.dumps(rec, indent=1))
    bad = _dist_gate_failures(rec)
    bad.update({k: v for k, v in rec.items()
                if k.startswith("nccl_world_1_bit_equal") and v is not True})
    return rec, launches["nccl_world_1"], bad


def distributed_phase(smi):
    """Frame-parallel serving and data-parallel training (dist_serving,
    dist_training). Returns the launches of B1-B5 in the phase's main path:
    one frame-parallel serving call and one D step under the process
    group."""
    t0 = time.perf_counter()
    serve, serve_launches = dist_serving(smi)
    train, train_launches, bad = dist_training(smi)
    launches = collections.Counter(serve_launches)
    launches.update(train_launches)
    emit({"phase": "distributed", "serve": serve, "train": train,
          "launches": dict(launches), "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    check(not bad, f"data-parallel steps differ from one process: {bad}")
    return dict(launches)


# ---------------------------------------------------------------------------
# spatial: one frame split by rows


def _lsb_diff(a, b):
    d = (a.int() - b.int()).abs()
    return d.max().item(), d.float().mean().item()


def b1_row_parity():
    """Why a slab's rows are gathered from an even row (parallel.spatial):
    B1 on a frame against B1 on the frame with k zero rows on each side,
    cropped, at the 1024 px conv's shape: the share of outputs that differ,
    per dtype and k."""
    from vtoonify_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((1, 32, 1024, 1024), generator=g, device="cuda").to(dt)
        w = (torch.randn((3, 3, 32, 32), generator=g, device="cuda") / 17).to(dt)
        s, d = (torch.rand((2, 1, 32), generator=g, device="cuda") + 0.5).to(dt)
        b = torch.randn(32, generator=g, device="cuda").to(dt)
        y = K.modconv3x3(x, w, s, d, b)
        for k in (1, 2):
            z = torch.zeros_like(x[:, :, :k])
            yk = K.modconv3x3(torch.cat([z, x, z], 2), w, s, d, b)[:, :, k:-k]
            out[f"{str(dt)[6:]}_shift_{k}_share_differing"] = (y != yk).float().mean().item()
    return out


def spatial_phase(smi):
    """The flagship pipeline at batch 1 over make_spatial_mesh(devices=
    ["cuda:0"] * k) for k in SP_SLABS_ON_CUDA0 and over every visible card,
    against the pipeline without a mesh: float32 within SP_F32_*, bf16
    within one device's own bf16-vs-float32 gap on the same 256 px frame;
    the launches of one 2-slab bf16 call (B1-B4 each launched); then each
    bf16 pipeline timed at SP_TIMED_PX in, with the halo, reduction and
    gather copies per call and the peak memory per card, and one call of
    one device and of 2 slabs profiled at the largest. Returns those
    launches."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.parallel import spatial as S
    from vtoonify_tpu_torch.parallel.mesh import make_spatial_mesh
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    t0 = time.perf_counter()
    cfg, vt, parsing = build_modules()
    # serve_phases' style and first frame (an image with contrast), then a
    # 1024 px frame
    rng = np.random.RandomState(SEED)
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    frames = {256: rng.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8)[:1],
              1024: rng.randint(0, 256, (1, 1024, 1024, 3)).astype(np.uint8)}
    meshes = {"one_device": None,
              **{f"sp{k}_cuda0": make_spatial_mesh(devices=["cuda:0"] * k)
                 for k in SP_SLABS_ON_CUDA0},
              "sp_all_cards": make_spatial_mesh()}
    rec = {"config": "VToonifyConfig() + BiSeNet, batch 1, d_s 0.5",
           "cards_visible": torch.cuda.device_count(),
           "build_seconds": time.perf_counter() - t0, "nvidia_smi": smi,
           "b1_row_parity": b1_row_parity()}
    outs, pipes = {}, {}
    for dtype in ("float32", "bfloat16"):
        for name, mesh in meshes.items():
            pipe = ToonifyPipeline(vt, cfg, parsing, dtype=getattr(torch, dtype), mesh=mesh)
            out = pipe.process_batch(frames[256], s_w, 0.5)
            check(tuple(out.shape) == (1, 1024, 1024, 3) and out.dtype == torch.uint8
                  and out.device == torch.device("cuda", 0),
                  f"spatial {name} {dtype}: output {tuple(out.shape)} {out.dtype} {out.device}")
            outs[dtype, name] = out
            if dtype == "bfloat16":
                pipes[name] = pipe
            del pipe
    del vt, parsing
    gap = _lsb_diff(outs["bfloat16", "one_device"], outs["float32", "one_device"])
    rec["one_device_bf16_vs_f32_max_mean_lsb"] = gap
    rec["out_std_lsb"] = outs["bfloat16", "one_device"].float().std().item()
    bad = []
    for name in list(meshes)[1:]:
        f32 = _lsb_diff(outs["float32", name], outs["float32", "one_device"])
        bf16 = _lsb_diff(outs["bfloat16", name], outs["bfloat16", "one_device"])
        rec[f"{name}_f32_vs_one_device_max_mean_lsb"] = f32
        rec[f"{name}_bf16_vs_one_device_max_mean_lsb"] = bf16
        if f32[0] > SP_F32_MAX_LSB or f32[1] > SP_F32_MEAN_LSB:
            bad.append(f"{name} float32 {f32}")
        if bf16[0] > gap[0] or bf16[1] > gap[1]:
            bad.append(f"{name} bf16 {bf16} above one device's bf16-vs-f32 gap {gap}")
    del outs

    # the launches of the 2-slab path, counted from 0 just before it
    sp = pipes[f"sp{SP_SLABS_ON_CUDA0[0]}_cuda0"]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    S.reset_stats()
    sp.process_batch(frames[256], s_w, 0.5)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    rec["launches_per_call_sp2"] = launches
    rec["copies_per_call_sp2_256px"] = S.stats()
    for name in ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"):
        if not launches[name]:
            bad.append(f"kernel {name} was not launched by the spatial path")

    # timing: host p50 per batch-1 call ending in a synchronize, bf16
    n_cards = torch.cuda.device_count()
    for px in SP_TIMED_PX:
        ref = None
        for name, pipe in pipes.items():
            call = lambda: pipe.process_batch(frames[px], s_w, 0.5)  # noqa: E731
            out = call()
            torch.cuda.synchronize()
            if ref is None:
                ref = out
                rec[f"out_std_lsb_{px}px"] = out.float().std().item()
            else:
                rec[f"{name}_{px}px_bf16_vs_one_device_max_mean_lsb"] = _lsb_diff(out, ref)
            del out
            resident = [torch.cuda.memory_allocated(d) / 2**30 for d in range(n_cards)]
            for d in range(n_cards):
                torch.cuda.reset_peak_memory_stats(d)
            S.reset_stats()
            times = []
            for _ in range(SP_REPS):
                t1 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            rec[f"{name}_{px}px"] = {
                "p50_ms_per_call": float(np.median(times)),
                "min_max_ms": [min(times), max(times)],
                "copies_per_call": {k: v / SP_REPS for k, v in S.stats().items()},
                "resident_gib_per_card": resident,
                "peak_gib_per_card": [torch.cuda.max_memory_allocated(d) / 2**30
                                      for d in range(n_cards)]}
            if px == max(SP_TIMED_PX) and name in ("one_device", "sp2_cuda0"):
                rec[f"{name}_{px}px"]["profile"] = device_profile(
                    call, f"spatial_profile_{name}_{px}px.txt")
        del ref
    del pipes, sp
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    emit({"phase": "spatial", **rec, "failures": bad})
    check(not bad, f"spatial: {bad}")
    check(rec["out_std_lsb"] > 10, "spatial: the one-device image is flat")
    return launches


def _tp_result(state, metrics):
    """A D step's readings by parameter name, split weights whole: the
    metrics, the new parameters and the gradients (Adam's first moment over
    1 - beta1) of each optimizer's module, and the EMA."""
    from vtoonify_tpu_torch.parallel import tensor as TPS
    from vtoonify_tpu_torch.train.steps import ADAM_BETA1

    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "ema": {k: v.float().cpu().clone() for k, v in state.ema.state_dict().items()}}
    for key, opt, mod in (("trainable", state.g_opt, state.trainable),
                          ("d", state.d_opt, state.d)):
        sd = TPS.optimizer_state_dict(opt, mod)
        out[f"{key}_grads"] = {n: (st["exp_avg"] / (1 - ADAM_BETA1)).cpu()
                               for n, st in sd["state"].items()}
        out[f"{key}_new"] = {k: v.float().cpu().clone() for k, v in mod.state_dict().items()}
    return out


def _tree_rel_l2(a: dict, b: dict) -> float:
    check(sorted(a) == sorted(b), "tensor-parallel results of other parameters")
    return _grads_rel_l2(a, b)


def _tp_compare(got, ref):
    """{reading: relative L2 of got against ref}: metrics, EMA, and each
    tree's gradients and new parameters."""
    keys = sorted(ref["metrics"])
    out = {"metrics": _rel_l2(torch.tensor([got["metrics"][k] for k in keys], dtype=torch.float64),
                              torch.tensor([ref["metrics"][k] for k in keys], dtype=torch.float64)),
           "ema": _tree_rel_l2(got["ema"], ref["ema"])}
    for tree in ("trainable", "d"):
        for what in ("grads", "new"):
            out[f"{tree}_{what}"] = _tree_rel_l2(got[f"{tree}_{what}"], ref[f"{tree}_{what}"])
    return out


def _tp_d_step(setup, mods_cpu, inputs, k, timed=0):
    """The flagship D stage-2 step from mods_cpu's state and the draws of
    seed SEED + 61, the student and D split over a row of k on cuda:0
    (k = 1: no split), with cuDNN deterministic; then, when `timed`, one
    warm-up step and `timed` steps, timed (cuDNN's default). Returns (the
    first step's readings, peak GiB on cuda:0, s/iter of the timed
    steps)."""
    from vtoonify_tpu_torch.parallel.tensor import shard_module
    from vtoonify_tpu_torch.train import steps as S

    cfg, dcfg, tcfg, pcfg = setup
    mods = copy.deepcopy(mods_cpu)
    if k > 1:
        for name in ("vt", "d"):
            shard_module(mods[name], ["cuda:0"] * k)
    state = S.init_train_d_state(mods["vt"], mods["d"], DIST_BATCH, cfg, tcfg)
    _, frozen = S.split_trainable(mods["vt"])
    gen = torch.Generator().manual_seed(SEED + 61)

    def step():
        draws = S.sample_train_d_draws(gen, DIST_BATCH, cfg, tcfg,
                                       inputs["directions"].shape[0], device="cuda")
        return S.train_d_step(state, frozen, mods["parsing"], mods["psp"], pcfg, None,
                              mods["lpips"], cfg, dcfg, tcfg, inputs["directions"],
                              inputs["style"], inputs["style_ind"], 0.5,
                              inputs["weights"], 0.3, 0.5, False, draws=draws)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(0)
    torch.backends.cudnn.deterministic = True
    try:
        first = _tp_result(state, step())
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(0) / 2**30
    times = []
    for i in range(timed + 1 if timed else 0):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t1)
    del state, frozen, mods
    torch.cuda.empty_cache()
    return first, peak, (float(np.median(times)) if times else None)


def _tp_tiny_steps():
    """The --tiny D stage-1 and T stage-2 steps (float32) at tp 2 on
    cuda:0 against tp 1, from the same modules and draws: {reading: rel
    L2}."""
    from vtoonify_tpu_torch.models.generator import init_generator
    from vtoonify_tpu_torch.models.vtoonify import CondDiscriminatorConfig, VToonifyConfig
    from vtoonify_tpu_torch.parallel.tensor import shard_module
    from vtoonify_tpu_torch.train import steps as S

    out = {}
    tcfg = S.TrainDConfig(crop_size=96, lpips_size=64, aug_max_pad=40)
    for which in ("pretrain_d", "train_t"):
        g = torch.Generator().manual_seed(SEED + 62)
        backbone = "dualstylegan" if which == "pretrain_d" else "toonify"
        cfg = VToonifyConfig(backbone=backbone, **TINY_VT)
        dcfg = CondDiscriminatorConfig(size=64, channel_multiplier=1)
        pcfg, mods_cpu, inputs = train_setup(cfg, dcfg, tcfg, 2, g)
        mods_cpu["base"] = init_generator(cfg.generator, g)
        draws = (S.sample_train_t_draws(g, 2, cfg, tcfg, 4) if which == "train_t"
                 else S.sample_pretrain_draws(g, 2, cfg, 4)).to("cuda")
        res = {}
        for k in (1, 2):
            m = copy.deepcopy(mods_cpu)
            row = ["cuda:0"] * k
            if which == "train_t":
                for name in ("vt", "d", "base"):
                    shard_module(m[name], row)
                state = S.init_train_t_state(m["vt"], m["d"], tcfg)
                _, frozen = S.split_trainable(m["vt"])
                metrics = S.train_t_step(state, frozen, m["base"], m["parsing"], m["psp"],
                                         pcfg, None, m["lpips"], cfg, dcfg, tcfg,
                                         inputs["directions"], 2, 0.3, draws=draws)
                new = {**state.trainable.state_dict(), **{
                    f"d.{n}": v for n, v in state.d.state_dict().items()}}
            else:
                state = S.init_pretrain_state(m["vt"])
                _, frozen = S.split_trainable(m["vt"], pretrain=True)
                for f in frozen.values():
                    shard_module(f, row)
                metrics = S.pretrain_step(state, frozen, m["parsing"], cfg,
                                          inputs["directions"], inputs["style"], 0.6,
                                          draws=draws)
                new = state.trainable.state_dict()
            res[k] = ({n: v.float().cpu() for n, v in new.items()},
                      {n: v.float().cpu() for n, v in state.ema.state_dict().items()},
                      torch.tensor([float(metrics[n]) for n in sorted(metrics)],
                                   dtype=torch.float64))
        for i, what in enumerate(("new", "ema")):
            out[f"{which}_{what}_rel_l2"] = _tree_rel_l2(res[2][i], res[1][i])
        out[f"{which}_metrics_rel_l2"] = _rel_l2(res[2][2], res[1][2])
    return out


def tp_phase(smi):
    """Tensor parallelism on the card: the flagship pipeline over tp rows
    (serving gates, launches, copies, p50 per call, peak memory), the
    flagship D stage-2 step over a tp-2 row against no split (float32 and
    bf16), and the --tiny D stage-1 and T stage-2 steps at tp 2 against tp 1.
    Returns the launches of one tp-2 batch-1 bf16 serving call."""
    from vtoonify_tpu_torch.ops import kernels as K
    from vtoonify_tpu_torch.parallel import tensor as TPS
    from vtoonify_tpu_torch.parallel.mesh import make_mesh
    from vtoonify_tpu_torch.pipeline.toonify import ToonifyPipeline

    t0 = time.perf_counter()
    cfg, vt, parsing = build_modules()
    rng = np.random.RandomState(SEED + 60)
    s_w = rng.randn(1, cfg.n_latent, 512).astype(np.float32)
    frames = rng.randint(0, 256, (max(TP_BATCHES), 256, 256, 3)).astype(np.uint8)
    n_cards = torch.cuda.device_count()
    meshes = {"one_device": None,
              **{f"tp{k}_cuda0": make_mesh(devices=["cuda:0"] * k, tp=k)
                 for k in TP_WIDTHS_ON_CUDA0}}
    if n_cards >= 2:
        meshes["tp_all_cards"] = make_mesh(tp=n_cards)
    rec = {"config": "VToonifyConfig() + BiSeNet, d_s 0.5, 256 -> 1024 px",
           "cards_visible": n_cards, "nvidia_smi": smi}
    bad, outs, pipes = [], {}, {}
    for dtype in ("float32", "bfloat16"):
        for name, mesh in meshes.items():
            pipe = ToonifyPipeline(vt, cfg, parsing, dtype=getattr(torch, dtype), mesh=mesh)
            if mesh is not None:
                check(TPS.is_sharded(pipe.vt), f"tp {name}: the pipeline's VToonify is not split")
            for b in TP_BATCHES:
                out = pipe.process_batch(frames[:b], s_w, 0.5)
                check(tuple(out.shape) == (b, 1024, 1024, 3) and out.dtype == torch.uint8
                      and out.device == torch.device("cuda", 0),
                      f"tp {name} {dtype} b{b}: output {tuple(out.shape)} {out.dtype}")
                outs[dtype, name, b] = out
            if dtype == "bfloat16":
                pipes[name] = pipe
            del pipe
    del vt, parsing
    rec["build_and_first_calls_seconds"] = time.perf_counter() - t0
    for b in TP_BATCHES:
        gap = _lsb_diff(outs["bfloat16", "one_device", b], outs["float32", "one_device", b])
        rec[f"one_device_b{b}_bf16_vs_f32_max_mean_lsb"] = gap
        rec[f"out_std_lsb_b{b}"] = outs["float32", "one_device", b].float().std().item()
        for name in list(meshes)[1:]:
            f32 = _lsb_diff(outs["float32", name, b], outs["float32", "one_device", b])
            bf16 = _lsb_diff(outs["bfloat16", name, b], outs["bfloat16", "one_device", b])
            rec[f"{name}_b{b}_f32_vs_one_device_max_mean_lsb"] = f32
            rec[f"{name}_b{b}_bf16_vs_one_device_max_mean_lsb"] = bf16
            if f32[0] > TP_F32_MAX_LSB or f32[1] > TP_F32_MEAN_LSB:
                bad.append(f"{name} b{b} float32 {f32}")
            if bf16[0] > gap[0] or bf16[1] > gap[1]:
                bad.append(f"{name} b{b} bf16 {bf16} above one device's bf16-vs-f32 gap {gap}")
    del outs

    # the launches and copies of one tp-2 batch-1 bf16 call, counted from 0
    tp2 = pipes[f"tp{TP_WIDTHS_ON_CUDA0[0]}_cuda0"]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    TPS.reset_stats()
    tp2.process_batch(frames[:1], s_w, 0.5)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    rec["launches_per_call_tp2_b1"] = launches
    rec["copies_per_call_tp2_b1"] = TPS.stats()
    for name in ("modconv3x3", "fused_leaky_relu", "upfirdn2d", "depth_to_space2"):
        if not launches[name]:
            bad.append(f"kernel {name} was not launched by the tp path")
    K.reset_launch_counts()
    pipes["one_device"].process_batch(frames[:1], s_w, 0.5)
    torch.cuda.synchronize()
    rec["launches_per_call_one_device_b1"] = K.launch_counts()

    # host p50 per call ending in a synchronize, bf16, in turns
    for b in TP_BATCHES:
        for rnd in range(2):
            for name, pipe in pipes.items():
                call = lambda: pipe.process_batch(frames[:b], s_w, 0.5)  # noqa: E731
                call()
                torch.cuda.synchronize()
                for d in range(n_cards):
                    torch.cuda.reset_peak_memory_stats(d)
                TPS.reset_stats()
                times = []
                for _ in range(TP_REPS):
                    t1 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                r = rec.setdefault(f"{name}_b{b}", {"p50_ms_per_call": []})
                r["p50_ms_per_call"].append(float(np.median(times)))
                r["copies_per_call"] = {k: v / TP_REPS for k, v in TPS.stats().items()}
                r["peak_gib_per_card"] = [torch.cuda.max_memory_allocated(d) / 2**30
                                          for d in range(n_cards)]
    for name, pipe in pipes.items():
        rec[f"{name}_weights_gib_per_card"] = [
            sum(t.numel() * t.element_size() for t in pipe.vt.parameters()
                if t.device == torch.device("cuda", d)) / 2**30 for d in range(n_cards)]
    del pipes, tp2
    torch.cuda.empty_cache()
    rec["serving_seconds"] = time.perf_counter() - t0

    # the flagship D stage-2 step over a tp-2 row on cuda:0 against no split
    t1 = time.perf_counter()
    readings = {}
    for compute_dtype in (None, "bfloat16"):
        setup, mods_cpu, inputs = _dist_setup(compute_dtype)
        tag = "f32" if compute_dtype is None else "bf16"
        for k in (1, 2):
            readings[tag, k], peak, s_iter = _tp_d_step(
                setup, mods_cpu, inputs, k, timed=3 if compute_dtype else 0)
            rec[f"d_step_{tag}_tp{k}_peak_gib_cuda0"] = peak
            if s_iter is not None:
                rec[f"d_step_{tag}_tp{k}_s_per_iter"] = s_iter
        if compute_dtype is None:
            # witnesses: the same step again (deterministic: equal), and
            # with its teacher synthesis a row at a time (the same function,
            # other conv shapes, so other cuDNN algorithms and float32 sums,
            # as a split layer has: _dist_witnesses' synthesis_per_row)
            again = _tp_d_step(setup, mods_cpu, inputs, 1)[0]
            rec["d_step_f32_tp1_again_vs_tp1_rel_l2"] = _tp_compare(again, readings[tag, 1])
            with synthesis_row_by_row():
                readings["witness"] = _tp_d_step(setup, mods_cpu, inputs, 1)[0]
            rec["d_step_f32_synthesis_per_row_vs_tp1_rel_l2"] = _tp_compare(
                readings["witness"], readings[tag, 1])
            del again
        del mods_cpu
    f32 = _tp_compare(readings["f32", 2], readings["f32", 1])
    for which, key in (("tp2", ("f32", 2)), ("synthesis_per_row", "witness")):
        for tree in ("trainable", "d"):  # where the float32 gradient gap sits
            got, ref = readings[key][f"{tree}_grads"], readings["f32", 1][f"{tree}_grads"]
            gaps = {n: ((got[n] - ref[n]).norm().item(), ref[n].norm().item()) for n in ref}
            rec[f"d_step_f32_{which}_{tree}_largest_grad_gaps"] = sorted(
                ([n, d, r] for n, (d, r) in gaps.items()), key=lambda v: -v[1])[:5]
    bf16 = _tp_compare(readings["bf16", 2], readings["bf16", 1])
    own = _tp_compare(readings["bf16", 1], readings["f32", 1])
    rec["d_step_f32_tp2_vs_tp1_rel_l2"] = f32
    rec["d_step_bf16_tp2_vs_tp1_rel_l2"] = bf16
    rec["d_step_bf16_vs_f32_tp1_rel_l2"] = own
    witness = rec["d_step_f32_synthesis_per_row_vs_tp1_rel_l2"]
    if any(rec["d_step_f32_tp1_again_vs_tp1_rel_l2"].values()):
        bad.append("the deterministic D step differs from itself")
    for tree in ("trainable", "d"):
        bound = max(TP_GRAD_REL_L2, DIST_WITNESS_RATIO * witness[f"{tree}_grads"])
        rec[f"d_step_f32_{tree}_grads_bound"] = bound
        if not f32[f"{tree}_grads"] <= bound:
            bad.append(f"D step float32 {tree} gradients {f32[tree + '_grads']} > {bound}")
        if not bf16[f"{tree}_grads"] <= own[f"{tree}_grads"]:
            bad.append(f"D step bf16 {tree} gradients {bf16[tree + '_grads']} above "
                       f"the step's bf16-vs-f32 gap {own[tree + '_grads']}")
    # the new parameters are recorded, not gated: Adam's first update moves
    # an element whose gradient is at the rounding noise by +-lr either way
    for what in ("metrics", "ema"):
        if not f32[what] <= DIST_REL_L2:
            bad.append(f"D step float32 {what} {f32[what]}")
    del readings
    rec["d_step_seconds"] = time.perf_counter() - t1
    tiny = _tp_tiny_steps()
    rec["tiny_tp2_vs_tp1_rel_l2"] = tiny
    bad += [f"--tiny {k} {v}" for k, v in tiny.items() if not v <= DIST_REL_L2]
    rec["seconds"] = time.perf_counter() - t0
    emit({"phase": "tp", **rec, "failures": bad})
    check(not bad, f"tp: {bad}")
    check(rec["out_std_lsb_b1"] > 10, "tp: the one-device image is flat")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    from vtoonify_tpu_torch.ops import kernels as K

    if len(sys.argv) == 5 and sys.argv[1] == "--dist-rank":
        # one rank of distributed_phase's 2-rank job, started by it
        dist_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
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
        style_engine_phase(smi)
        pipeline_options_phase(smi)
        with tempfile.TemporaryDirectory() as tmp:
            write_serving_zoo(Path(tmp), torch.Generator().manual_seed(SEED + 5))
            serve_http_phase(smi, Path(tmp))
        train_phase(smi, "bfloat16", steps=3)
        pretrain_d_phase(smi)
        train_t_phase(smi, stages=("train",))
        return
    if sys.argv[1:] == ["--apps"]:
        # the inference apps alone (pipeline options, the HTTP server,
        # smoothing, the release gate); no result line
        pipeline_options_phase(smi)
        with tempfile.TemporaryDirectory() as tmp:
            write_serving_zoo(Path(tmp), torch.Generator().manual_seed(SEED + 5))
            serve_http_phase(smi, Path(tmp))
            smooth_parsing_phase(smi, Path(tmp))
        release_gate_phase()
        return
    if sys.argv[1:] == ["--raft"]:
        # RAFT training and evaluation alone; no result line
        raft_train_phase(smi)
        return
    if sys.argv[1:] == ["--reg"]:
        # the regularisers, full ADA and the auxiliary models alone; no
        # result line
        regularise_phase(smi)
        return
    if sys.argv[1:] == ["--dist"]:
        # frame-parallel serving and data-parallel training alone, with
        # B5's second order in coef; no result line
        emit({"phase": "affine_warp_coef_second_order",
              **affine_warp_coef_second_order(dev, np.random.RandomState(SEED + 30))})
        distributed_phase(smi)
        return
    if sys.argv[1:] == ["--sp"]:
        # one frame split by rows alone; no result line
        spatial_phase(smi)
        return
    if sys.argv[1:] == ["--tp"]:
        # tensor parallelism alone; no result line
        tp_phase(smi)
        return
    check(len(sys.argv) == 1, "usage: chip_smoke.py [--kernels NAME[,NAME...] | --paths "
          "| --apps | --raft | --reg | --dist | --sp | --tp]")
    summary = kernel_phase(dev)
    launches_serve = serve_phases(smi)
    launches_style_engine = style_engine_phase(smi)
    launches_options = pipeline_options_phase(smi)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_serving_zoo(Path(tmp), torch.Generator().manual_seed(SEED + 5))
        emit({"phase": "serving_zoo", "seconds": time.perf_counter() - t0})
        launches_http = serve_http_phase(smi, Path(tmp))
        launches_smooth = smooth_parsing_phase(smi, Path(tmp))
    launches_gate = release_gate_phase()
    launches_train = train_phase(smi, "bfloat16", steps=3)
    train_phase(smi, None, steps=2)
    train_f32_vs_cpu_phase()
    launches_pretrain_d = pretrain_d_phase(smi)
    launches_t = train_t_phase(smi)
    train_tiny_vs_cpu_phase()
    launches_cli = train_cli_phase()
    launches_raft = raft_train_phase(smi)
    launches_reg = regularise_phase(smi)
    launches_dist = distributed_phase(smi)
    launches_spatial = spatial_phase(smi)
    launches_tp = tp_phase(smi)
    paths = {"serve": launches_serve, "style_engine": launches_style_engine,
             "pipeline_options": launches_options, "serve_http": launches_http,
             "smooth_parsing": launches_smooth, "release_gate": launches_gate,
             "train_step": launches_train, "pretrain_d_step": launches_pretrain_d,
             "pretrain_t_step": launches_t["pretrain_t"],
             "train_t_step": launches_t["train_t"], "train_cli": launches_cli,
             "raft_train_step": launches_raft, "regularise": launches_reg,
             "distributed": launches_dist, "spatial": launches_spatial,
             "tp": launches_tp}

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": sum(p.get(name, 0) for p in paths.values()),
         **{f"launches_{path}": p.get(name, 0) for path, p in paths.items()},
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
