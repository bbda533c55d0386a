#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``osvos_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (sm_90a) and the
CUDA toolkit. Phases, in order; any failure raises and exits nonzero:

1. device: the card and its power limit (``nvidia-smi``);
2. build: nvcc compiles every kernel of the port from ``csrc/``, one
   process per source, all started together;
3. kernel checks, each kernel against its plain PyTorch version:
   the fused-head tail at the serving shapes and odd ones (H = 1, W = 1,
   W = 17, B = 7, one and two scales, W past 1024 and 4000); the CB-BCE
   statistics and gradient at the fine-tune's per-sample shape, its
   whole-batch form and ragged shapes (n = 1, 3, 33 at B = 4096, a one-
   element last tile), with logits of +-100, the statistics' two launches
   bitwise equal with a launch on other inputs between them; the 3x3
   weight gradient (``wgrad.cu``) at every trunk conv of the fine-tune,
   its four side convs and a small odd shape, two launches bitwise equal,
   on the Hopper path (TMA + wgmma) at every conv after the stem and the
   wmma path at the stem's and the odd shape; the stem's tap-stacked
   weight gradient (B16) at the stem of the fine-tune's and the parent's
   batch and at odd shapes, on its Hopper path (``stem_wgrad.cu``: a TMA
   ring of g, a rolling image strip, wgmma) where D is a multiple of 8 and
   its mma path elsewhere; the stem's forward (``stem.cu``, B2's stem)
   within one rounding at the same shapes, a ragged W, H = 1, D = 8 and
   D = 12 (the mma path that stays), two launches bitwise equal; the flat
   trunk's kernels (B2-B6) at every call of a flat fine-tune step and an
   odd small shape (B4, ``wgrad.cu`` with db, also at the stem's shape),
   two launches bitwise equal, each B2 after the stem, each B3 dz, B5 and
   B6 dz on ``flatconv.cu``'s Hopper path (TMA + wgmma), the stem on
   ``stem.cu``, the odd shape on the mma path, B3's pooled call routing
   through the pool backward
   kernel, B6's routed pool cotangent bit for bit; the weight pack kernel
   bit for bit before each of those launches; the stage-boundary max pool
   forward and backward (B7-B10) bit for bit at the four boundaries of a
   batch-5 480x854 step, in float32, at an odd shape with C = 12, with
   heavy ties and with NaNs; the int8 conv of int8 inference (I1,
   ``int8conv.cu``) bit for bit at the 12 trunk convs after the stem of a
   batch-4 480x854 forward and at odd shapes (Cin 1, 3, 12, 16, 48; Cout 1,
   12, 17, 65, 136; H = 1; ragged W; 15 pixels): its mma.sync path on int8
   x, with and without the ReLU, and its entry on bf16 x
   (``int8_conv3x3_q``) under the given, static and dynamic scale rules,
   on the Hopper path (TMA + s8 wgmma, the quantization in the operand
   load) at the 12 convs and the mma path at the odd shapes, its max_out
   against the plain max and with -0.0 outputs; two launches bitwise
   equal, and the refusal of operands neither path takes;
3b. the JAX package's ``.ckpt``: the committed ``tests/data/parent_tiny.ckpt``
   (a --tiny parent with its optimizer state) through ``load_checkpoint``
   and ``load_training_state`` without the ``msgpack`` package, every leaf
   bit for bit against ``tests/data/parent_tiny_expect.npz``;
4. card tests: ``tests/test_torch_cuda.py`` under pytest, nothing skipped;
5. serving: full-width OSVOS in fast mode (bf16 trunk) with seeded weights
   serves 12 synthetic 480x854 frames at batch 4 through ``infer_sequence``
   and writes one PNG per frame; the fused-head kernel and the pool
   forward (four per forward pass) must have run, and the maps must equal
   the plain tail's within 1 code;
5b. int8 serving: the same weights in int8 mode, static scales calibrated
   on frame 0 and dynamic scales, 12 frames at batch 4 with PNGs: exact
   launches (I1's Hopper path 12 a batch, its mma path none, B1 1), the
   maps bit for bit against I1's plain version and agreeing with fast
   serving's on at least 99% of the pixels' 0.5 masks; frames/s of fast
   and int8 at batch 4 and 32, and each one's device-busy ms a batch;
6. parity: full-width parity-mode logits on the card, through the float32
   pool kernel, against the same model on the CPU, within 2e-4 of the
   output's scale;
7. fine-tune: ``make_fine_tune_fn`` at full width with
   ``loss_impl='pallas'``, the default microbatch step (batch 5) and pool
   (100 entries) on a 480x854 frame, for 8 optimizer steps, in fast mode
   and then in flat mode (the JAX package's default trunk); the launch
   counts of every kernel must be exact, the same steps with the kernels'
   plain versions substituted must give the same losses and parameter
   deltas within the mode's limits, the flat run must agree with the fast
   run within the CPU tests' model-level bounds, and each mode's tuned
   weights serve 4 frames through the fused-head kernel;
8. parent training: ``ParentTrainer`` at full width in fast mode
   (``loss_impl='pallas'``, batch 2, ``n_ave_grad=2``) on synthetic
   480x854 frames through the training transforms, 6 calls (3 optimizer
   steps) with the deep supervision annealed over two epochs: exact launch
   counts per kernel, the same calls with the plain versions within the
   fast limits, no parameter move between optimizer steps, a snapshot
   mid-accumulation resumed in a fresh trainer, a val loss, and 2 calls in
   flat mode against the fast run;
8b. ``--vis_net``: ``cli/train_parent.main`` with ``--synthetic 2 --epochs
   1 --n_ave_grad 1 --no_test --vis_net`` at full width, in fast and in
   flat mode: its ``net.dot`` a digraph naming all 44 parameter leaves with
   their shapes, 5 outputs and the mode's kernel Functions
   (``_Conv3x3Same`` and ``_MaxPoolCeil``; the five flat ones); ``make_dot``
   of the same model called directly draws the same DOT with exactly one
   train-mode forward's launches (fast: the 4 pool forwards; flat: B2 13,
   the stem on ``stem.cu``, B5 4), and its node count and wall time;
9. the online entry point (the main path): ``cli/train_online.main`` with
   its defaults and ``--steps 8 --eval --vis_res`` on one synthetic 12-frame
   480x854 sequence written in DAVIS's layout (JPEG frames, PNG masks), from
   a random parent: exact launch counts of the flat fine-tune (B16 among
   them) and of the fast inference, the tuned weights and losses bit for
   bit against ``build_host_pool`` + ``run_online`` called directly, 12
   PNGs, 12 overlays, 8 logged losses, the J/F line and the time of each
   phase (decode, pool build, fine-tune steps, inference, PNG writes,
   eval); then a second run from the JAX ``.ckpt`` fixture with ``--tiny
   --infer_mode int8 --aug_mode per_step --steps 2``: I1 and B1 launches
   exact, its PNGs bit for bit against a direct calibration and int8
   inference of its tuned weights;
9b. ``parallel/`` at full width: ``batched_fine_tune`` (the rounds, serial on
   the card) over 2 synthetic sequences, flat, 8 steps, ``loss_impl=
   'pallas'``, pool 16, every tuned tensor and loss bit for bit against
   ``run_online`` on the same bf16 pool and draws (seeded ``cfg.seed + i``)
   with exact launch counts; ``batched_infer`` on ragged 4 and 6 frames in
   4-frame chunks, bit for bit against ``infer_sequence`` per sequence in
   fast mode and in int8 (``calibrate_int8_scales_batched``, each row the
   per-sequence calibration's maxes times float32(1.05); against the static
   scales of ``calibrate_int8_scales`` the 0.5 masks agree on >= 99%); a
   one-rank NCCL group: 2 data-parallel ``ParentTrainer`` calls and
   frame-parallel ``infer_sequence`` bit for bit against no mesh, with
   their times; ``parallel/dryrun.dryrun_multichip(2)`` on 2 gloo ranks of
   the host's CPU (the multi-rank paths against one rank); the batched
   online CLI (``--all_val --batched --steps 8 --eval``, 2 sequences of 4
   frames, the default pool of 100): exact launches, a PNG a frame, J/F,
   the ``[batched]`` line and its phase times;
9c. the packed schedule at full width (fast, seeded weights, batch 5):
   the sequence-batched weight gradients (``wgrad3x3_seq``, B17 over S
   sequences in one launch, at the 12 trunk convs after the stem;
   ``stem_wgrad_seq``, B16's, at the stem) at S = 2 and 4, at full and
   --tiny widths and B16's odd shapes, and the sequence-batched forward
   (``conv_fwd_seq``, B2-seq) at the full widths, each sequence bit for bit
   a lone launch on its slice and within the lone bounds of the plain
   version; ``batched_fine_tune(schedule='packed')`` against
   ``schedule='rounds'`` (8 steps, pool 16, ``loss_impl='pallas'``, the
   same bf16 pools and draws, cuDNN deterministic), the rounds' trunk
   convs after the stem also run as B2-seq over one sequence: over one
   sequence bit for bit; over 2 synthetic sequences every leaf's delta read
   against the fast fine-tune's 1e-2 of its delta scale and held to
   ``PK_DELTA``, set from readings (cuDNN's grouped convs round some bf16
   gradients otherwise): this run and 3 more seeds read under it, a
   control with one sequence's gradient halved over it; against the
   rounds as they run, losses within rtol 1e-3 and the deltas printed;
   exact launch
   counts (per step 12
   ``wgrad3x3_seq``, 12 ``conv_fwd_seq`` each on the Hopper path after one
   weight pack, 1 ``stem_wgrad_seq``, the pools 4 + 4, one CB-BCE
   statistics and gradient, no lone B17 or B16); 'flat' under packed
   downgraded to 'fast' with one warning, bit for bit the fast packed run;
   the sequence launches' times at S = 2 and 4, a line a conv (B17's two
   passes apart), against S lone launches, a grouped
   ``convolution_backward``, the plain version and the bound, and B2-seq's
   against S lone launches, the grouped conv + bias + ReLU it replaced and
   the bound; the packed
   step at S = 2, 4 and 20 (the val split on one card) with the default pool
   as capped, against S rounds' steps, with its device-busy share and peak
   memory;
   the batched CLI with ``--compute_mode fast`` (packed);
10. timings: each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (the fused-head tail and the
   CB-BCE kernels with their device kernels a call, one each;
   ``wgrad.cu`` at each trunk conv
   with its TFLOP/s and path, and alone at the side convs, B6's dK; B2, B3
   and B15's dz launch alone at each call of a flat step with their
   TFLOP/s and path, summed, and B2's calls after the stem summed; the
   stem's forward alone (its byte bound, ``F.conv2d`` bf16 + bias); B6's dz
   launch alone; the weight pack; I1's two paths at each trunk conv after
   the stem, against their bounds (the Hopper path's reads x as bf16), im2col
   + ``torch._int_mm`` and cuDNN's bf16 conv, per call and, for the Hopper
   path, on the device); the per-call host split of the flat
   wrappers (``--host-split`` runs only that, after the build); the
   ms per step of both
   fine-tune modes and of parent training, and their device kernels by
   group.

The last lines are a JSON object describing each kernel, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. No CPU fallback: without
CUDA the script fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
FACTORS = (2, 4, 8, 16)
BATCH, H, W = 4, 480, 854
N_FRAMES = 12
SEED = 0
MAX_OFF_SHARE = 1e-3  # share of pixels allowed one code off the plain tail
KERNEL_SOURCES = ("fused_head", "cbbce", "wgrad", "flatconv", "pool",
                  "stem_wgrad", "stem", "int8conv")
FT_STEPS = 8          # optimizer steps of the fine-tune phase
FT_BATCH = 5          # OnlineConfig().n_ave_grad, the microbatch
FT_POOL = 100         # make_fine_tune_fn's default pool size
FT_TIMED = 8          # steps timed after 2 warm-up steps
CB_COPIES = 6         # input pairs the CB-BCE timings rotate through
# Kernel run against plain-version run of the 8-step fine-tune, per mode:
# (losses, relative; parameter deltas, of each leaf's delta scale). Fast
# mode differs only in float32 sum order. In flat mode a bf16 output may
# also round the other way, and the trunk biases' gradients, sums over
# every pixel with much cancellation, feel it most (7.06e-2 of the scale at
# stage3_conv2.bias on an H100, PERF.md).
FT_LIMITS = {"fast": (1e-6, 1e-2), "flat": (1e-4, 0.15)}
# Flat run against fast run: the CPU model-level bounds of
# tests/test_torch_flat_model.py (losses rtol; deltas within max(0.2 of the
# leaf's scale, 0.075 of the largest delta)).
FLAT_VS_FAST = (5e-2, 0.2, 0.075)
SIDE_CH = 16          # ModelConfig().side_channels
# Parent training: two epochs of 6 synthetic frames at batch 2 (3 calls
# each), an optimizer step every 2 calls; the snapshot after call 3
# (mid-accumulation); 2 calls in flat mode; calls timed after 2 warm-up.
PT_FRAMES, PT_EPOCHS, PT_BATCH, PT_AVE = 6, 2, 2, 2
PT_SNAPSHOT, PT_FLAT_CALLS, PT_TIMED = 3, 2, 6
# At the reference lr of 1e-8, 3 steps move stage 5's weights by about 60
# float32 steps, so a delta one rounding step apart is 1.6e-2 of it (an
# H100 run, PERF.md); at 1e-7 the kernel-vs-plain check sees the gradients,
# not float32 resolution.
PT_LR = 1e-7
PT_OUTPUTS = 5        # losses of the train-mode outputs (4 sides, fuse)
# --vis_net (phase 8b): the parent CLI's arguments besides the flag, the
# mode and the save root, and the shape it draws the graph on (the JAX
# script's); the autograd Functions of each mode's kernel paths
VIS_ARGS = ["--synthetic", "2", "--epochs", "1", "--n_ave_grad", "1",
            "--no_test"]
VIS_SHAPE = (1, 64, 112, 3)
VIS_FUNCTIONS = {"fast": ("_Conv3x3SameBackward", "_MaxPoolCeilBackward"),
                 "flat": ("_FlatConv3x3InputBackward", "_FlatConv3x3Backward",
                          "_ConvPoolBackward", "_SideAndPoolBackward",
                          "_SideConvBackward")}
# The stem's checks and timings (its forward and B16): the stem at the
# fine-tune's and the parent's batch, then odd shapes that take the Hopper
# paths: a ragged W with D = 8, H = 1, C = 1, C = 2 over two channel tiles
STEM_SHAPES = [(FT_BATCH, H, W, 3, 64), (PT_BATCH, H, W, 3, 64)]
STEM_ODD = [(2, 17, 29, 3, 8), (1, 1, 200, 3, 16), (3, 9, 70, 1, 16),
            (2, 7, 130, 2, 72)]
# The online CLI phase: one synthetic val sequence of CLI_FRAMES 480x854
# frames in DAVIS's layout, the CLI's defaults with FT_STEPS steps
CLI_SEQ, CLI_FRAMES = "synth-val-a", 12
CLI_PHASES = ("decode", "pool build", "fine-tune steps", "inference",
              "PNG writes", "eval")
# Launch counters: (name in the report, module, attribute).
COUNTERS = (("cbbce_stats", "cbbce", "stats_launches"),
            ("cbbce_grad", "cbbce", "grad_launches"),
            ("wgrad3x3 (B17)", "wgrad", "launches"),
            ("stem_wgrad (B16)", "stem_wgrad", "launches"),
            ("B2", "flatconv", "fwd_launches"),
            ("B3", "flatconv", "bwd_launches"),
            ("B4", "flatconv", "wgrad_db_launches"),
            ("B5", "flatconv", "side_fwd_launches"),
            ("B6", "flatconv", "side_bwd_launches"),
            ("max_pool_fwd", "pool", "fwd_launches"),
            ("max_pool_bwd", "pool", "bwd_launches"),
            ("wgrad.cu tma", "wgrad", "tma_launches"),
            ("wgrad.cu wmma", "wgrad", "wmma_launches"),
            ("flatconv.cu hopper", "flatconv", "hopper_launches"),
            ("flatconv.cu mma", "flatconv", "mma_launches"),
            ("stem.cu", "flatconv", "stem_launches"),
            ("flatconv.cu pack", "flatconv", "pack_launches"),
            ("stem_wgrad.cu tma", "stem_wgrad", "tma_launches"),
            ("stem_wgrad.cu mma", "stem_wgrad", "mma_launches"),
            ("int8_conv3x3 (I1)", "int8conv", "launches"),
            ("int8_conv3x3_q (I1 hopper)", "int8conv", "hopper_launches"),
            ("wgrad3x3_seq (B17)", "wgrad", "seq_launches"),
            ("stem_wgrad_seq (B16)", "stem_wgrad", "seq_launches"),
            ("conv_fwd_seq (B2-seq)", "flatconv", "seq_fwd_launches"))
FLAT_WRAPPERS = ("conv_fwd", "conv_bwd", "wgrad_db", "stem_bwd", "side_fwd",
                 "side_bwd")

# int8 inference: I1's odd shapes (N, H, W, Cin, Cout): Cin 1, 3 and 12
# (byte and word loads), Cin 16 and 48 (a K tail under 16-byte loads), Cout
# 1, 12 and 17, a second partial and a third channel tile, H = 1, ragged W,
# 15 output pixels (fewer rows than torch._int_mm takes on CUDA)
INT8_ODD = [(2, 17, 29, 1, 12), (2, 9, 70, 3, 17), (1, 1, 200, 12, 1),
            (3, 7, 13, 48, 65), (2, 5, 131, 16, 8), (1, 3, 5, 64, 24),
            (2, 33, 49, 64, 136)]
# int8 serving against fast serving: the least share of pixels whose 0.5
# masks (u8 >= 128) agree, tests/test_model.py's bound for the JAX
# package's int8 trunk
INT8_MIN_AGREE = 0.99
# serving at bench.py's default batch: the 12 frames repeated to 96
SERVE_BIG_BATCH, SERVE_BIG_FRAMES = 32, 96
# The JAX package's .ckpt of a --tiny parent with its optimizer state, and
# the values the port must read from it (tests/test_torch_msgpack.py)
CKPT_FIXTURE = os.path.join("tests", "data", "parent_tiny.ckpt")
CKPT_EXPECT = os.path.join("tests", "data", "parent_tiny_expect.npz")
CLI2_STEPS = 2
# parallel/: the rounds over BT_SEQS sequences with a pool of BT_POOL;
# batched inference of ragged sequences of BT_FRAMES frames; BT_DP_CALLS
# data-parallel parent calls on one NCCL rank (one optimizer step); the
# batched CLI on BT_SEQS sequences of BT_CLI_FRAMES frames
BT_SEQS, BT_POOL, BT_FRAMES, BT_DP_CALLS, BT_CLI_FRAMES = 2, 16, (4, 6), 2, 4
# the packed schedule (phase 9c): BT_SEQS sequences against the rounds, the
# sequence-batched kernels at S = PK_SEQS, the packed step timed at each S of
# PK_TIMED_SEQS (20: the DAVIS-2016 val split, which --all_val --batched
# packs onto one card) with the default pool of PK_POOL frames a sequence
# as batched_online.pool_cap caps it. The packed trunk's 12 convs after
# the stem run B2-seq, whose sums differ in order from the rounds' library
# convs, so the packed schedule is held to the rounds with B2-seq's forward
# (``rounds_b2_forward``): at S = 1 bit for bit; at S = 2 the parameter
# deltas read against the fast fine-tune's bound PK_DELTA_FAST (1e-2 of
# each leaf's delta scale), which assumes that the two runs differ in
# float32 sum order alone. They do not: at S > 1 cuDNN takes other
# algorithms for some grouped convs, whose bf16 gradients then round some
# elements the other way (1336 of 36864 of side_prep1's dK at S = 2, an
# H100, PERF.md), and the head's float32 GEMMs change shape with S; over 8
# steps the trunk biases, sums over every pixel with much cancellation,
# drift. So the deltas are held to PK_DELTA, set from readings: the sound
# runs (the host pools' seed and PK_SEEDS more seeds of weights, pools and
# draws) read under it, and the control, the same run with one sequence's
# gradient halved (the fault of a loss meaned over the S * N rows), must
# read over it. On an H100, against that reference, 32 sound readings at 16
# seeds came 0.0066-0.206 (31 of them under 0.077), 13 control readings at
# 7 seeds 0.594-0.948 (PERF.md). Against the rounds as they run, the losses
# are held to PK_LOSS_RTOL and the deltas printed: the forward's other sum
# order alone reads 0.167 at S = 1, and 33 readings came 0.0144-0.387.
PK_SEQS, PK_TIMED_SEQS, PK_POOL, PK_LOSS_RTOL = 2, (2, 4, 20), 100, 1e-3
PK_DELTA_FAST, PK_DELTA, PK_SEEDS = 1e-2, 0.35, 3
# the S at which the sequence launches are checked and timed (the first,
# PK_SEQS, goes into the kernels' JSON line)
PK_KERNEL_SEQS = (PK_SEQS, 4)
# the --tiny widths (cli/train_online.TINY_STAGES), where the trunk's
# C = 12 convs take wgrad.cu's wmma path
TINY_STAGES = ((8, 8), (12, 12), (16, 16, 16), (16, 16, 16), (16, 16, 16))
# B16's odd shapes for the sequence launch: its mma path (D = 12, 130)
STEM_SEQ_ODD = [(1, 5, 3, 2, 12), (3, 9, 70, 1, 130)]

# Published peaks of one H100 SXM (dense, no sparsity), for the bounds.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# Floating-point operations per element, counted from the kernels' source:
# statistics: compare, abs, neg, exp, log1p, max, add, accumulate;
# gradient: exp, add, divide, sub, select and four multiply-adds.
CBBCE_STATS_OPS = 8
CBBCE_GRAD_OPS = 10
# fused-head tail per output pixel: 4 scales x (2x2 weights, 3 FMAs),
# bias, sigmoid (exp, add, divide), scale and round.
TAIL_OPS = 4 * 7 + 6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(ms, 'bytes' or 'operations'): the least time of the work on the
    card, the larger of its bytes over HBM bandwidth and its operations over
    the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def contribs(b, h, w, device, seed, std=3.0):
    """Random (b, h_i, w_i) contributions at the four side-branch shapes."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in FACTORS:
        h, w = -(-h // 2), -(-w // 2)
        out.append(torch.from_numpy((rng.randn(b, h, w) * std)
                                    .astype(np.float32)).to(device))
    return out


def logits_labels(b, n, device, seed):
    """(b, n) float32 logits of std 5 with some at +-100, and labels in
    [0, 0.72) of which about 30% reach 0.5."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, n, generator=gen, device=device) * 5
    x.view(-1)[::997] = 100.0
    x.view(-1)[::1009] = -100.0
    z = torch.rand(b, n, generator=gen, device=device) * 0.72
    return x, z


def trunk_conv_shapes(stages, n, h, w):
    """(name, N, H, W, C, D) of every trunk conv at an (n, h, w) input."""
    from osvos_torch.models.vgg_osvos import stage_conv_names

    out, hw = [], {}
    for i in range(len(stages)):
        hw[f"stage{i + 1}"] = (h, w)
        h, w = -(-h // 2), -(-w // 2)
    for name, c, d in stage_conv_names(stages):
        out.append((name, n, *hw[name.split("_")[0]], c, d))
    return out


def call_ms(fn) -> float:
    """ms of one call of ``fn``: CUDA events around it, then a sync."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, n: int = 50, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    return statistics.median(call_ms(fn) for _ in range(n))


def paired_median_ms(fa, fb, n: int = 30, warmup: int = 3):
    """Median ms per call of ``fa`` and of ``fb``, their calls taken in
    turns, so that a drift of the host's speed falls on both: a call's
    host time on the card's machine moves by tens of us between runs."""
    for _ in range(warmup):
        fa()
        fb()
    ta, tb = [], []
    for _ in range(n):
        ta.append(call_ms(fa))
        tb.append(call_ms(fb))
    return statistics.median(ta), statistics.median(tb)


def queued_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """ms a call of ``fn`` on the device: CUDA events around ``n`` calls
    queued back to back (the host runs ahead of a kernel that takes longer
    than its launch), over ``n``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_events(fn, n: int):
    """The device activity (name, µs) of ``n`` calls of ``fn`` under
    ``torch.profiler``, and the host-clock µs of the window; no activity if
    the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # Late in a long run the profiler returns windows without device events,
    # or with a part of them (H100, torch 2.11): a window whose event count
    # is not a whole number a call is profiled again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and len(events) % n == 0:
            return events, wall_us
        say(f"[profiler] {len(events)} device events in a window of {n} calls")
    return events, wall_us


def device_ms(fn, n: int = 20, kernel: str = ""):
    """Median device time of one call of ``fn`` from a profiler trace: the
    duration of the kernel named ``kernel``, or, with no name, the sum of all
    device activity in the window divided by ``n``. None when the profiler
    saw no device activity: the time is then not measured."""
    events, _ = device_events(fn, n)
    if not events:
        return None
    if kernel:
        times = [us for name, us in events if kernel in name]
        check(len(times) == n, f"profiler saw {len(times)} of {n} {kernel}")
        return statistics.median(times) / 1e3
    return sum(us for _, us in events) / n / 1e3


def device_per_call(fn, n: int = 20):
    """(ms, kernels) per call of ``fn`` from a profiler trace: the device
    activity of ``n`` calls summed, and counted, over ``n``, in the active
    window after a warm-up window of the profiler (it can still miss an
    event, so one kernel a call can read a little under 1); (None, None)
    when the profiler saw none: then neither is measured."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # a window without device events, or with a part of them (a count not a
    # whole number a call), is profiled again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and len(events) % n == 0:
            return sum(events) / n / 1e3, len(events) / n
        say(f"[profiler] {len(events)} device events in a window of {n} calls")
    if events:
        return sum(events) / n / 1e3, len(events) / n
    return None, None


def dev_text(ms, rate=None, digits: int = 4) -> str:
    """A profiler device time as printed: '<ms> ms device', with
    ``rate(ms)`` in parentheses, or 'device not measured'."""
    if ms is None:
        return "device not measured"
    return f"{ms:.{digits}f} ms device" + (f" ({rate(ms)})" if rate else "")


def add_ms(total, ms):
    """A sum of times that is not measured once one of its parts is not."""
    return None if total is None or ms is None else total + ms


def blob_mask(h: int, w: int) -> np.ndarray:
    """(h, w) float32 ellipse of about 15% foreground."""
    yy, xx = np.mgrid[:h, :w]
    inside = ((yy - 0.45 * h) / (0.25 * h)) ** 2 + ((xx - 0.5 * w) / (0.19 * w)) ** 2
    return (inside <= 1.0).astype(np.float32)


@contextlib.contextmanager
def plain_kernels(k):
    """Substitute the plain versions for the training kernels' wrappers."""
    wrappers = [(k["cbbce"], "cbbce_stats"), (k["cbbce"], "cbbce_grad"),
                (k["wgrad"], "wgrad3x3"), (k["stem_wgrad"], "stem_wgrad"),
                (k["wgrad"], "wgrad3x3_seq"), (k["stem_wgrad"], "stem_wgrad_seq"),
                (k["pool"], "max_pool_fwd"), (k["pool"], "max_pool_bwd")]
    wrappers += [(k["flatconv"], name) for name in FLAT_WRAPPERS]
    saved = [getattr(mod, name) for mod, name in wrappers]
    for mod, name in wrappers:
        setattr(mod, name, getattr(mod, name + "_ref"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(wrappers, saved):
            setattr(mod, name, fn)


def zero_counts(k) -> None:
    for _, mod, attr in COUNTERS:
        setattr(k[mod], attr, 0)


def read_counts(k) -> dict:
    return {name: getattr(k[mod], attr) for name, mod, attr in COUNTERS}


def expected_counts(mode: str, steps: int, stages, outputs: int = 1,
                    loss_kernels: bool = True) -> dict:
    """Launches of ``steps`` training steps whose loss reads ``outputs``
    outputs (the fine-tune 1, parent training 5): per step and output one
    CB-BCE statistics and one gradient (with ``loss_kernels``); one B16 for
    the stem's weight gradient; in fast mode one B17 per trunk conv after
    the stem and one pool forward and backward per stage boundary (B9/B10
    at the first, B7/B8 at the others); in flat mode one B2 per trunk conv,
    one B3 and one B4 (``wgrad.cu`` with db, B3's second launch) per trunk
    conv after the stem, one B5 and one B6 per side branch (the pools of
    stages 2-4 inside them), and the pool backward of stage 1 (B3's route,
    B10's kernel). Every B17, B4 and B6 launch runs ``wgrad.cu``'s Hopper
    (TMA + wgmma) path, none its wmma path; every B2 after the stem, every
    B3 dz, B5 and B6 dz runs ``flatconv.cu``'s Hopper path and each of them
    but B6's dz (whose blocks pack their own) launches the weight pack
    kernel first; the stem's forward runs ``stem.cu`` (its blocks pack
    their own weights) and every B16 ``stem_wgrad.cu``'s Hopper path: no
    launch takes an mma path. Mode 'packed' (the packed schedule, fast
    trunk): the fast counts with one ``wgrad3x3_seq`` a trunk conv after the
    stem and one ``stem_wgrad_seq`` in place of the lone launches, and one
    ``conv_fwd_seq`` (B2-seq, after its weight pack, on ``flatconv.cu``'s
    Hopper path) a trunk conv after the stem, whatever the number of
    sequences."""
    convs = sum(len(s) for s in stages)
    sides = len(stages) - 1
    flat, packed = mode == "flat", mode == "packed"
    losses = steps * outputs * loss_kernels
    tma = steps * (convs - 1) + steps * sides * flat
    seq_fwd = steps * (convs - 1) * packed
    return {"cbbce_stats": losses, "cbbce_grad": losses,
            "wgrad3x3 (B17)": 0 if flat or packed else steps * (convs - 1),
            "stem_wgrad (B16)": 0 if packed else steps,
            "wgrad3x3_seq (B17)": steps * (convs - 1) if packed else 0,
            "stem_wgrad_seq (B16)": steps if packed else 0,
            "B2": steps * convs * flat, "B3": steps * (convs - 1) * flat,
            "B4": steps * (convs - 1) * flat,
            "B5": steps * sides * flat, "B6": steps * sides * flat,
            "max_pool_fwd": 0 if flat else steps * sides,
            "max_pool_bwd": steps if flat else steps * sides,
            "wgrad.cu tma": tma, "wgrad.cu wmma": 0,
            "flatconv.cu hopper": 2 * steps * (convs - 1 + sides) * flat + seq_fwd,
            "flatconv.cu mma": 0, "stem.cu": steps * flat,
            "flatconv.cu pack": steps * (2 * convs - 2 + sides) * flat + seq_fwd,
            "conv_fwd_seq (B2-seq)": seq_fwd,
            "stem_wgrad.cu tma": steps, "stem_wgrad.cu mma": 0,
            "int8_conv3x3 (I1)": 0, "int8_conv3x3_q (I1 hopper)": 0}


def forward_counts(mode: str, stages) -> dict:
    """Launches of one train-mode forward and no backward: the forward's
    rows of one step's ``expected_counts`` (fast: the pool forwards; flat:
    B2, the stem on ``stem.cu`` and B5, each launch after the stem on
    ``flatconv.cu``'s Hopper path after one weight pack), every other
    row 0."""
    step = expected_counts(mode, 1, stages, loss_kernels=False)
    rows = {"fast": ("max_pool_fwd",), "flat": ("B2", "stem.cu", "B5")}[mode]
    counts = {name: step[name] if name in rows else 0 for name in step}
    if mode == "flat":
        counts["flatconv.cu hopper"] = counts["flatconv.cu pack"] = \
            step["B2"] - step["stem.cu"] + step["B5"]
    return counts


def build_kernels(build) -> None:
    """Build every source from scratch, one nvcc per source, in parallel."""
    for name in KERNEL_SOURCES:
        lib = build.library_path(name)
        if lib.exists():
            lib.unlink()
        say("[build] " + " ".join(build.nvcc_command(name, lib)))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        reports = dict(zip(KERNEL_SOURCES,
                           pool.map(build.build_library, KERNEL_SOURCES)))
    say(f"[build] {', '.join(KERNEL_SOURCES)} built in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        say(f"[build] {name} -> "
            f"{os.path.relpath(build.library_path(name), ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                say(f"[build]   {line.strip()}")


# The fused-head tail's odd shapes (B, (H, W), scales): one row, one column,
# one pixel, a ragged W, B = 7, one and two scales, rows wider than a block's
# 1024 threads, and W = 4000, where a piece has fewer rows to fit shared
# memory
TAIL_ODD = [(2, (1, 854), 4), (3, (480, 1), 4), (2, (1, 1), 4), (2, (33, 17), 4),
            (7, (65, 97), 4), (2, (65, 97), 1), (7, (9, 17), 2), (1, (5, 2500), 4),
            (1, (3, 4000), 4)]


def check_fused_head(device, fused_head) -> int:
    bias = torch.tensor([0.5], device=device)
    max_err = 0
    for b, (h, w), scales in TAIL_ODD:
        cs = contribs(b, h, w, device, seed=SEED + h + w)[:scales]
        got = fused_head.fused_upsample_sigmoid_u8(cs, bias, (h, w), FACTORS[:scales])
        torch.cuda.synchronize()
        want = fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, (h, w),
                                                        FACTORS[:scales])
        err = int((got.int() - want.int()).abs().max())
        off = float((got != want).float().mean())
        say(f"[kernel] fused_head B={b} {h}x{w}, {scales} scale(s): max |kernel "
            f"- ref| = {err} code(s) on {off:.2e} of pixels")
        check(got.shape == (b, h, w) and got.dtype == torch.uint8, "tail shape")
        check(err <= 1 and off <= MAX_OFF_SHARE,
              f"kernel disagrees with its plain version at B={b} {h}x{w}: "
              f"{err} codes on {off:.2e} of pixels")
        max_err = max(max_err, err)
    for b, (h, w) in ((BATCH, (H, W)), (1, (65, 97))):
        cs = contribs(b, h, w, device, seed=SEED + h)
        logits = fused_head.tail_logits_ref(cs, bias, (h, w), FACTORS)
        got = fused_head.fused_upsample_sigmoid_u8(cs, bias, (h, w), FACTORS)
        torch.cuda.synchronize()
        want = fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, (h, w), FACTORS)
        err = int((got.int() - want.int()).abs().max())
        # sums in another order may round the other way only next to a
        # .5 boundary, so off-by-one codes must also be rare
        off = float((got != want).float().mean())
        distinct = len(torch.unique(got))
        lo, hi = float(logits.min()), float(logits.max())
        say(f"[kernel] fused_head B={b} {h}x{w}: max |kernel - ref| = {err} "
            f"code(s) on {off:.2e} of pixels, {distinct} distinct u8 values, "
            f"logits in [{lo:.2f}, {hi:.2f}]")
        check(got.shape == (b, h, w) and got.dtype == torch.uint8, "tail shape")
        check(lo <= -6 and hi >= 6, "kernel-check logits do not span +-6")
        check(distinct >= 200, "kernel output is degenerate (< 200 codes)")
        check(err <= 1 and off <= MAX_OFF_SHARE,
              f"kernel disagrees with its plain version: {err} codes on "
              f"{off:.2e} of pixels")
        max_err = max(max_err, err)
    return max_err


def check_cbbce(device, cbbce):
    """Statistics: counts exact, sums within 1e-5 relative (float32 sums in
    another order), two launches bitwise equal. Gradient: within 1e-6 of
    max|dx| (the same float32 expression, sigmoid rounded apart)."""
    shapes = [(FT_BATCH, H * W), (3, 33 * 49), (1, FT_BATCH * H * W), (1, 1),
              (1, 3), (4096, 33), (7, 4097)]
    tiny = torch.finfo(torch.float32).tiny
    stats_err = grad_err = 0.0
    for b, n in shapes:
        x, z = logits_labels(b, n, device, seed=SEED + n)
        x2, z2 = logits_labels(b, n, device, seed=SEED + n + 1)
        got = cbbce.cbbce_stats(x, z)
        other = cbbce.cbbce_stats(x2, z2)
        again = cbbce.cbbce_stats(x, z)
        torch.cuda.synchronize()
        rel, abs_err = 0.0, 0.0
        for out, want in ((got, cbbce.cbbce_stats_ref(x, z)),
                          (other, cbbce.cbbce_stats_ref(x2, z2))):
            diff = (out[:, 2:] - want[:, 2:]).abs()
            abs_err = max(abs_err, float(diff.max()))
            rel = max(rel, float((diff / want[:, 2:].abs().clamp_min(tiny)).max()))
            check(out.shape == (b, 4) and bool(torch.isfinite(out).all()),
                  "cbbce_stats shape or non-finite output")
            check(torch.equal(out[:, :2], want[:, :2]), f"cbbce_stats ({b}, {n}) "
                  "counts differ")
        say(f"[kernel] cbbce_stats ({b}, {n}): counts {got[:, :2].tolist()[:2]}"
            f"{'...' if b > 2 else ''}, sums max rel err {rel:.3g}, "
            f"max abs err {abs_err:.4g}, repeat bitwise equal (other inputs "
            f"between) {torch.equal(got, again)}")
        check(rel <= 1e-5, f"cbbce_stats ({b}, {n}) sums: {rel:.3g} relative")
        check(torch.equal(got, again), f"cbbce_stats ({b}, {n}): two launches differ")
        stats_err = max(stats_err, abs_err)

        wts = torch.rand(b, 4, device=device,
                         generator=torch.Generator(device=device).manual_seed(n)) + 0.1
        dx = cbbce.cbbce_grad(x, z, wts)
        torch.cuda.synchronize()
        want_dx = cbbce.cbbce_grad_ref(x, z, wts)
        abs_err = float((dx - want_dx).abs().max())
        scale = float(want_dx.abs().max())
        # a lone logit of -100 has a gradient of 0 (or a denormal)
        share = abs_err / scale if scale > 0 else (0.0 if abs_err == 0 else float("inf"))
        say(f"[kernel] cbbce_grad ({b}, {n}): max |kernel - ref| = "
            f"{abs_err:.4g} = {share:.3g} of max|dx|")
        check(bool(torch.isfinite(dx).all()), "cbbce_grad non-finite output")
        check(abs_err <= 1e-6 * scale, f"cbbce_grad ({b}, {n}): {share:.3g} "
              "of max|dx|")
        grad_err = max(grad_err, abs_err)
    return stats_err, grad_err


def side_conv_shapes(stages, n, h, w):
    """(name, N, H, W, C, D) of the C -> SIDE_CH side convs of stages 2-5,
    whose dK B6 takes from ``wgrad.cu``."""
    convs = trunk_conv_shapes(stages, n, h, w)
    hw = {c[0].split("_")[0]: c[2:4] for c in convs}
    return [(f"side_prep{i}", n, *hw[f"stage{i + 1}"], stages[i][-1], SIDE_CH)
            for i in range(1, len(stages))]


def check_wgrad(device, wgrad, shapes) -> float:
    """Within 1e-4 of max|dK|: both sum exact bf16 products in float32, in
    another order; two launches bitwise equal; the Hopper path at the trunk
    convs after the stem and at the side convs, the wmma path at the stem's
    shape (C = 3; B16 takes the stem on the main path) and the odd shape
    (D = 4), whose rows TMA cannot describe."""
    wmma_shapes = (shapes[0][0], "odd")
    worst = 0.0
    for name, n, h, w, c, d in shapes + [("odd", 2, 9, 13, 8, 4)]:
        gen = torch.Generator(device=device).manual_seed(SEED + c * d + h)
        x = torch.randn(n, h, w, c, device=device, generator=gen).to(torch.bfloat16)
        g = torch.randn(n, h, w, d, device=device, generator=gen).to(torch.bfloat16)
        paths = (wgrad.tma_launches, wgrad.wmma_launches)
        got, again = wgrad.wgrad3x3(x, g), wgrad.wgrad3x3(x, g)
        torch.cuda.synchronize()
        took = (wgrad.tma_launches - paths[0], wgrad.wmma_launches - paths[1])
        path = wgrad.plan(n, h, w, c, d).path
        want = wgrad.wgrad3x3_ref(x, g)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        say(f"[kernel] wgrad3x3 {name} x({n},{h},{w},{c}) g(..,{d}): {path} "
            f"path; max |kernel - ref| = {err:.4g} = {err / scale:.3g} of "
            f"max|dK|; repeat bitwise {torch.equal(got, again)}")
        check(got.shape == (3, 3, c, d) and got.dtype == torch.float32,
              "wgrad3x3 shape or type")
        check(err <= 1e-4 * scale, f"wgrad3x3 {name}: {err / scale:.3g} of max|dK|")
        check(torch.equal(got, again), f"wgrad3x3 {name}: two launches differ")
        check(took == ((0, 2) if name in wmma_shapes else (2, 0)),
              f"wgrad3x3 {name}: launches by path (tma, wmma) {took}")
        worst = max(worst, err)
    return worst


def time_wgrad(device, wgrad, shapes, card, what) -> dict:
    """``wgrad.cu`` (dK alone) at each shape: per call (CUDA events) and
    device ms (profiler) with the TFLOP/s of each and the path taken, the
    plain version, cuDNN's dK (``convolution_backward``) and the bound;
    the sums over the shapes."""
    acc = dict(ms=0.0, dev=0.0, plain=0.0, lib=0.0, bound_b=0.0, bound_o=0.0)
    for name, n, h, w, c, d in shapes:
        gen = torch.Generator(device=device).manual_seed(SEED + c * d + h)
        xb = torch.randn(n, h, w, c, device=device, generator=gen).to(torch.bfloat16)
        gb = torch.randn(n, h, w, d, device=device, generator=gen).to(torch.bfloat16)
        wb = torch.randn(d, c, 3, 3, device=device, generator=gen).to(torch.bfloat16)
        xn, gn = xb.permute(0, 3, 1, 2), gb.permute(0, 3, 1, 2)
        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            gn, xn, wb, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])
        kfn = lambda: wgrad.launch(xb, gb, with_db=False)[0]  # noqa: E731
        pfn = lambda: wgrad.wgrad3x3_ref(xb, gb)  # noqa: E731
        k_ms = median_ms(kfn, n=20, warmup=3)
        k_dev = device_ms(kfn, n=10)
        p_ms = median_ms(pfn, n=10, warmup=2)
        l_ms = median_ms(lib, n=20, warmup=3)
        dk = kfn()
        lib_dk = lib()[1].float().permute(2, 3, 1, 0)
        lib_err = float((lib_dk - dk).abs().max() / dk.abs().max())
        ops = 2 * 9 * c * d * n * h * w
        nbytes = 2 * n * h * w * (c + d) + 4 * 9 * c * d
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        tflops = lambda t: f"{ops / t / 1e9:.1f} TFLOP/s"  # noqa: E731
        say(f"[time] wgrad.cu {name} ({n},{h},{w},{c}->{d}), "
            f"{wgrad.plan(n, h, w, c, d).path} path: kernel {k_ms:.4f} ms per "
            f"call ({tflops(k_ms)}), {dev_text(k_dev, tflops)}; plain "
            f"{p_ms:.4f}; library (convolution_backward, bf16 dK, "
            f"{lib_err:.2g} of max|dK| off) {l_ms:.4f}; bound "
            f"{max(t_b, t_o):.4f} ms ({'bytes' if t_b >= t_o else 'operations'}) "
            f"| {card}")
        acc["dev"] = add_ms(acc["dev"], k_dev)
        for key, v in (("ms", k_ms), ("plain", p_ms), ("lib", l_ms),
                       ("bound_b", t_b), ("bound_o", t_o)):
            acc[key] += v
        del xb, gb, wb, xn, gn
    acc["bound"] = max(acc["bound_b"], acc["bound_o"])
    acc["by"] = "bytes" if acc["bound_b"] >= acc["bound_o"] else "operations"
    say(f"[time] {what}: kernel {acc['ms']:.3f} ms per call summed, "
        f"{dev_text(acc['dev'], digits=3)}; plain {acc['plain']:.3f}; library "
        f"{acc['lib']:.3f}; bound {acc['bound']:.3f} ms ({acc['by']}) | {card}")
    return acc


def stem_inputs(device, shape, seed):
    """An image of the flat stem's range (the mean-subtracted frame in
    bf16, values to about +-150) and a bf16 cotangent."""
    n, h, w, c, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(n, h, w, c, device=device, generator=gen) * 60).to(torch.bfloat16)
    g = torch.randn(n, h, w, d, device=device, generator=gen).to(torch.bfloat16)
    return x, g


def check_stem_wgrad(device, stem_wgrad) -> float:
    """B16 against its plain version (the im2col product) at the stem of
    the fine-tune's and the parent's batch and at odd shapes: dK within
    1e-4 of max|dK| (``check_wgrad``'s bound), db within 1e-5 of the
    largest column sum of |g|, two launches bitwise equal, each launch on
    the path ``tma_plan`` gives the shape (the Hopper path for D a multiple
    of 8: the stem's shapes and ``STEM_ODD``; the mma path for D = 12 and
    130). Returns the largest |kernel - plain| of dK."""
    worst = 0.0
    for i, shape in enumerate(STEM_SHAPES + STEM_ODD + [(1, 5, 3, 2, 12),
                                                         (3, 9, 70, 1, 130)]):
        n, h, w, c, d = shape
        x, g = stem_inputs(device, shape, SEED + 500 + i)
        before = (stem_wgrad.tma_launches, stem_wgrad.mma_launches)
        (dk, db), (dk2, db2) = stem_wgrad.stem_wgrad(x, g), stem_wgrad.stem_wgrad(x, g)
        torch.cuda.synchronize()
        took = (stem_wgrad.tma_launches - before[0], stem_wgrad.mma_launches - before[1])
        path = "tma" if stem_wgrad.tma_plan(n, h, w, c, d) else "mma"
        want_dk, want_db = stem_wgrad.stem_wgrad_ref(x, g)
        err = float((dk - want_dk).abs().max())
        rel = err / float(want_dk.abs().max())
        col = float(g.float().abs().sum((0, 1, 2)).max())
        db_rel = float((db - want_db).abs().max()) / col
        same = torch.equal(dk, dk2) and torch.equal(db, db2)
        say(f"[kernel] stem_wgrad (B16) x{tuple(x.shape)} g(..,{d}): max "
            f"|kernel - plain| = {err:.4g} = {rel:.3g} of max|dK|; db "
            f"{db_rel:.3g} of sum|g|; repeat bitwise equal {same}; {path} path")
        check(path == ("tma" if d % 8 == 0 else "mma"), f"stem_wgrad {shape}: {path} path")
        check(took == ((2, 0) if path == "tma" else (0, 2)),
              f"stem_wgrad {shape}: launches (tma, mma) {took} on the {path} path")
        check(dk.shape == (3, 3, c, d) and db.shape == (d,)
              and dk.dtype == db.dtype == torch.float32, "stem_wgrad shape or type")
        check(rel <= 1e-4, f"stem_wgrad {shape}: dK {rel:.3g} of max|dK|")
        check(db_rel <= 1e-5, f"stem_wgrad {shape}: db {db_rel:.3g} of sum|g|")
        check(same, f"stem_wgrad {shape}: two launches differ")
        worst = max(worst, err)
    return worst


def check_stem_fwd(device, flatconv) -> float:
    """The stem's forward (B2's stem, ``conv_fwd`` at C <= 3) against its
    plain version at the stem of the fine-tune's and the parent's batch,
    the odd shapes of ``STEM_ODD`` and D = 12: within one bf16 rounding,
    the ReLU acting, two launches bitwise equal, each launch on the path
    ``plan`` gives it (``stem.cu`` for D a multiple of 8, no weight pack;
    ``flatconv.cu``'s mma path with its pack for D = 12). Returns the
    largest |kernel - plain|."""
    worst = 0.0
    for i, shape in enumerate(STEM_SHAPES + STEM_ODD + [(2, 17, 29, 3, 12)]):
        n, h, w, c, d = shape
        x, _ = stem_inputs(device, (n, h, w, c, 8), SEED + 700 + i)
        k = torch.randn(d, c, 3, 3, device=device) * (9 * c) ** -0.5
        b = torch.randn(d, device=device) * 0.1
        counters = ("stem_launches", "mma_launches", "pack_launches")
        before = [getattr(flatconv, a) for a in counters]
        (y, _), (y2, _) = flatconv.conv_fwd(x, k, b), flatconv.conv_fwd(x, k, b)
        torch.cuda.synchronize()
        took = tuple(getattr(flatconv, a) - v for a, v in zip(counters, before))
        path = flatconv.plan(n, h, w, c, d, "stem").path
        want, _ = flatconv.conv_fwd_ref(x, k, b)
        err = float((y.float() - want.float()).abs().max())
        zeros = float((want.float() == 0).float().mean())
        say(f"[kernel] B2's stem {shape}: max |kernel - plain| = {err:.4g}; "
            f"within one rounding {one_rounding_ok(y, want)}; ReLU zeros "
            f"{zeros:.1%}; repeat bitwise {torch.equal(y, y2)}; {path} path")
        check(path == ("stem" if d % 8 == 0 else "mma"), f"stem {shape}: {path} path")
        check(took == ((2, 0, 0) if path == "stem" else (0, 2, 2)),
              f"stem {shape}: launches (stem, mma, pack) {took} on the {path} path")
        check(y.shape == (n, h, w, d) and y.dtype == torch.bfloat16, "stem shape or type")
        check(one_rounding_ok(y, want), f"stem {shape}: beyond one bf16 rounding ({err:.4g})")
        check(zeros > 0.05, f"stem {shape}: the ReLU did not act")
        check(torch.equal(y, y2), f"stem {shape}: two launches differ")
        worst = max(worst, err)
    return worst


def time_stem_fwd(device, flatconv, card) -> dict:
    """The stem's forward alone at each shape of ``STEM_SHAPES``: the
    kernel's ms per call (CUDA events, in turns with the library call) and
    device ms (profiler), the plain version's, ``F.conv2d`` bf16 + bias and
    the bound (bytes: the image read, y written, the weight and bias read).
    Returns the first shape's (the fine-tune's batch) numbers."""
    out = {}
    for i, shape in enumerate(STEM_SHAPES):
        n, h, w, c, d = shape
        x, _ = stem_inputs(device, (n, h, w, c, 8), SEED + 800 + i)
        k = torch.randn(d, c, 3, 3, device=device) * (9 * c) ** -0.5
        b = torch.randn(d, device=device) * 0.1
        xn, kb, bb = x.permute(0, 3, 1, 2), k.to(torch.bfloat16), b.to(torch.bfloat16)
        kfn = lambda: flatconv.conv_fwd(x, k, b)  # noqa: E731
        pfn = lambda: flatconv.conv_fwd_ref(x, k, b)  # noqa: E731
        lib = lambda: torch.nn.functional.conv2d(xn, kb, bb, padding=1)  # noqa: E731
        k_ms, l_ms = paired_median_ms(kfn, lib)
        k_dev = device_ms(kfn, n=10)
        p_ms = median_ms(pfn, n=5, warmup=1)
        px = n * h * w
        nbytes = 2 * px * (c + d) + 4 * (9 * c * d + d)
        b_ms, b_by = bound(nbytes, 2 * 9 * c * d * px, BF16_OPS_PER_S)
        tbps = lambda t: f"{nbytes / t / 1e9:.2f} TB/s"  # noqa: E731
        say(f"[time] B2's stem ({n},{h},{w},{c}->{d}): kernel {k_ms:.4f} ms per "
            f"call, {dev_text(k_dev, tbps)}; plain {p_ms:.4f}; library (conv2d "
            f"bf16 + bias) {l_ms:.4f}; bound {b_ms:.4f} ms ({b_by}, "
            f"{nbytes / 1e6:.1f} MB); {flatconv.plan(n, h, w, c, d, 'stem').path} "
            f"path | {card}")
        out.setdefault("first", dict(ms=k_ms, dev=k_dev, plain=p_ms, lib=l_ms,
                                     bound=b_ms, by=b_by, shape=shape))
        del x, xn
    return out["first"]


def time_stem_wgrad(device, stem_wgrad, card) -> dict:
    """B16 at the stem of each batch in ``STEM_SHAPES``: the kernel's ms per
    call (CUDA events, in turns with the library call) and device ms
    (profiler, both launches), the plain version's, cuDNN's dK + db
    (``convolution_backward``) and the bound.
    Returns the first shape's (the fine-tune's batch) numbers."""
    out = {}
    for i, shape in enumerate(STEM_SHAPES):
        n, h, w, c, d = shape
        x, g = stem_inputs(device, shape, SEED + 600 + i)
        wb = torch.randn(d, c, 3, 3, device=device).to(torch.bfloat16)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            gn, xn, wb, [d], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, True])
        kfn = lambda: stem_wgrad.stem_wgrad(x, g)  # noqa: E731
        pfn = lambda: stem_wgrad.stem_wgrad_ref(x, g)  # noqa: E731
        k_ms, l_ms = paired_median_ms(kfn, lib)
        k_dev = device_ms(kfn, n=10)
        p_ms = median_ms(pfn, n=5, warmup=1)
        px = n * h * w
        nbytes = 2 * px * (c + d) + 4 * (9 * c * d + d)
        ops = 2 * (9 * c + 1) * d * px
        b_ms, b_by = bound(nbytes, ops, BF16_OPS_PER_S)
        tbps = lambda t: f"{nbytes / t / 1e9:.2f} TB/s"  # noqa: E731
        path = "tma" if stem_wgrad.tma_plan(n, h, w, c, d) else "mma"
        say(f"[time] stem_wgrad (B16) ({n},{h},{w},{c}->{d}): kernel {k_ms:.4f} "
            f"ms per call, {dev_text(k_dev, tbps)}; plain {p_ms:.4f}; library "
            f"(convolution_backward, dK db) "
            f"{l_ms:.4f}; bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); "
            f"{path} path | {card}")
        out.setdefault("first", dict(ms=k_ms, dev=k_dev, plain=p_ms, lib=l_ms,
                                     bound=b_ms, by=b_by, shape=shape))
        del x, g, xn, gn, wb
    return out["first"]


def flat_case_list(stages, n, h, w):
    """(row, label, shape) of every flat-trunk kernel call of one fine-tune
    step at (n, h, w), then the cases that are only checked: an odd small
    case per row and B4 at the stem's shape. Shapes are (N, H, W, C, D);
    B3's call of stage 1's last conv routes the pool's cotangent, B4 is B3's
    second launch at each of its convs, and the side convs of stages 2-4
    carry the next stage's pool."""
    convs = trunk_conv_shapes(stages, n, h, w)
    last1 = f"stage1_conv{len(stages[0]) - 1}"
    out = []
    for name, *shape in convs:
        out.append(("B2", name + (" +pool" if name == last1 else ""), tuple(shape)))
    for name, *shape in convs[1:]:
        out.append(("B3", name + (" +route" if name == last1 else ""), tuple(shape)))
    for name, *shape in convs[1:]:
        out.append(("B4", name, tuple(shape)))
    hw = {c[0].split("_")[0]: c[2:4] for c in convs}
    for i in range(1, len(stages)):
        shape = (n, *hw[f"stage{i + 1}"], stages[i][-1], SIDE_CH)
        pool = " +pool" if i < len(stages) - 1 else ""
        out.append(("B5", f"side_prep{i}{pool}", shape))
        out.append(("B6", f"side_prep{i}{pool}", shape))
    for row in ("B2", "B3", "B4", "B5", "B6"):
        small = (2, 17, 29, 3 if row == "B4" else 12, 8)
        out.append((row, "odd" + ("" if row == "B4" else " +pool"), small))
    out.append(("B4", f"stem shape {convs[0][0]}", tuple(convs[0][1:])))
    return out


def step_cases(cases):
    """The cases of ``flat_case_list`` that a flat step runs."""
    return [c for c in cases if not c[1].startswith(("odd", "stem shape"))]


def bf16_randn(shape, device, seed, relu=False, levels=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn(shape, device=device, generator=gen)
    if levels:  # few distinct values: pool windows tie
        t = torch.round(t * levels / 3) * (3 / levels)
    return (t.clamp_min(0) if relu else t).to(torch.bfloat16)


def make_flat_case(device, flatconv, row, label, shape, seed):
    """Inputs of one flat kernel call, and (kernel, plain, library) calls of
    the same function plus its bytes and operations. Each call returns the
    outputs to compare, in the wrapper's order; then come the cotangent the
    backward rows take (None where the kernel routes it) and, for B6 at a
    pooled side, (kernel, plain) calls of its dz with a zero side
    cotangent: the routed pool cotangent alone (else None)."""
    from osvos_torch.ops.pool import pool_fwd

    n, h, w, c, d = shape
    pool = "+pool" in label or "+route" in label
    hw2 = (n, -(-h // 2), -(-w // 2))
    x = bf16_randn((n, h, w, c), device, seed, relu=row != "B4" or c > 3,
                   levels=4 * pool)
    k = torch.randn(d, c, 3, 3, device=device) * (9 * c) ** -0.5
    b = torch.randn(d, device=device) * 0.1
    kb, bb = k.to(torch.bfloat16), b.to(torch.bfloat16)
    xn = x.permute(0, 3, 1, 2)
    px = n * h * w
    mac = 2 * 9 * c * d * px
    if row in ("B2", "B5"):
        if row == "B2":
            kfn = lambda: flatconv.conv_fwd(x, k, b, pool=pool)  # noqa: E731
            pfn = lambda: flatconv.conv_fwd_ref(x, k, b, pool=pool)  # noqa: E731
            pooled_bytes = 2 * hw2[0] * hw2[1] * hw2[2] * d * pool
        else:
            kfn = lambda: flatconv.side_fwd(x, k, pool=pool)  # noqa: E731
            pfn = lambda: flatconv.side_fwd_ref(x, k, pool=pool)  # noqa: E731
            pooled_bytes = 2 * hw2[0] * hw2[1] * hw2[2] * c * pool
        lib = lambda: torch.nn.functional.conv2d(xn, kb, bb, padding=1)  # noqa: E731
        nbytes = 2 * px * (c + d) + 4 * (9 * c * d + d) + pooled_bytes
        return kfn, pfn, lib, nbytes, mac, None, None
    g = bf16_randn((n, h, w, d), device, seed + 1)
    gn = g.permute(0, 3, 1, 2)
    mask = [row != "B4", True, row != "B6"]
    lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        gn, xn, kb, [d] if mask[2] else None, [1, 1], [1, 1], [1, 1], False,
        [0, 0], 1, mask)
    if row == "B4":
        kfn = lambda: flatconv.wgrad_db(x, g)  # noqa: E731
        pfn = lambda: flatconv.wgrad_db_ref(x, g)  # noqa: E731
        return (kfn, pfn, lib, 2 * px * (c + d) + 4 * (9 * c * d + d), mac, g,
                None)
    if row == "B3":
        if pool:
            y = bf16_randn((n, h, w, d), device, seed + 2, relu=True, levels=4)
            pooled = pool_fwd(y)
            dp = bf16_randn(pooled.shape, device, seed + 3)
            kw = dict(route=(y, pooled, dp))
            g_bytes = 2 * px * d * 2 + 4 * pooled.numel()  # y, g out; pooled, dp
        else:
            kw, g_bytes = dict(g=g), 2 * px * d
        kfn = lambda: flatconv.conv_bwd(x, k, **kw)  # noqa: E731
        pfn = lambda: flatconv.conv_bwd_ref(x, k, **kw)  # noqa: E731
        nbytes = 2 * px * 2 * c + g_bytes + 4 * (2 * 9 * c * d + 2 * d)
        return kfn, pfn, lib, nbytes, 2 * mac, kw.get("g"), None
    pl = None
    if pool:
        pooled = pool_fwd(x)
        pl = (pooled, bf16_randn(pooled.shape, device, seed + 3))
    kfn = lambda: flatconv.side_bwd(x, k, g, pool=pl)  # noqa: E731
    pfn = lambda: flatconv.side_bwd_ref(x, k, g, pool=pl)  # noqa: E731
    nbytes = (2 * px * (2 * c + d) + 4 * 9 * c * d * 2
              + (4 * hw2[0] * hw2[1] * hw2[2] * c if pool else 0))
    routed = None
    if pool:
        zero = torch.zeros_like(g)
        routed = (lambda: flatconv.side_bwd(x, k, zero, pool=pl)[0],
                  lambda: flatconv.side_bwd_ref(x, k, zero, pool=pl)[0])
    return kfn, pfn, lib, nbytes, 2 * mac, g, routed


def one_rounding_ok(got, want) -> bool:
    """bf16 results of the same float32 sums in another order: within one
    bf16 rounding (2^-7 of the value) plus 2^-16 of the scale."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    return bool(((g - w).abs() <= w.abs() * 2.0 ** -7 + scale * 2.0 ** -16).all())


def flat_path(flatconv, row, label, shape):
    """The path of ``csrc/flatconv.cu`` that a case's launch takes, as
    ``plan`` picks it (None for B4, which launches only ``wgrad.cu``)."""
    n, h, w, c, d = shape
    pool = "+pool" in label
    if row == "B4":
        return None
    if row == "B2":
        mode = "fwd_pool" if pool else ("stem" if c <= 3 else "fwd")
        return flatconv.plan(n, h, w, c, d, mode).path
    if row == "B3":
        return flatconv.plan(n, h, w, d, c, "dgrad").path
    if row == "B5":
        return flatconv.plan(n, h, w, c, d, "side_pool" if pool else "side").path
    return flatconv.plan(n, h, w, d, c,
                         "side_dgrad_pool" if pool else "side_dgrad").path


def check_flat(device, flatconv, cases) -> dict:
    """Each flat kernel against its plain version at every call of the
    step and an odd small shape: bf16 values within one rounding, dK within
    1e-4 of max|dK|, db within 1e-5 of the largest column sum of |g|, pools
    and routed cotangents bit for bit, two launches bitwise equal (each
    Hopper mode at its step shapes among them). Every B2 after the stem,
    every B3 dz, B5 and B6 dz of the step takes the Hopper path, the stem
    ``stem.cu``, the odd shapes (C = 12) the mma path, counted by the path
    counters, each ``flatconv.cu`` launch but B6's Hopper dz after one
    weight pack; B3's routed call launches the pool backward first.
    Returns the largest |kernel - plain| of each row's first output."""
    from osvos_torch.ops.kernels import pool as kpool
    from osvos_torch.ops.pool import pool_fwd

    worst = {}
    for i, (row, label, shape) in enumerate(cases):
        kfn, pfn, _, _, _, g, routed = make_flat_case(device, flatconv, row,
                                                      label, shape, i)
        before = (flatconv.hopper_launches, flatconv.mma_launches,
                  kpool.bwd_launches, flatconv.pack_launches,
                  flatconv.stem_launches)
        got, again = kfn(), kfn()
        torch.cuda.synchronize()
        took = (flatconv.hopper_launches - before[0],
                flatconv.mma_launches - before[1], kpool.bwd_launches - before[2],
                flatconv.pack_launches - before[3],
                flatconv.stem_launches - before[4])
        path = flat_path(flatconv, row, label, shape)
        on_step = not label.startswith(("odd", "stem shape"))
        hopper = row in ("B3", "B5", "B6") or (row == "B2" and shape[3] > 3)
        check(path == ("hopper" if on_step and hopper else
                       "stem" if on_step and row == "B2" else
                       None if row == "B4" else "mma"),
              f"{row} {label}: {path} path")
        routes = 2 * (row == "B3" and ("+route" in label or "+pool" in label))
        packs = 0 if row == "B6" and path == "hopper" else 2
        want_took = {"hopper": (2, 0, routes, packs, 0),
                     "mma": (0, 2, routes, packs, 0), "stem": (0, 0, 0, 0, 2),
                     None: (0, 0, 0, 0, 0)}[path]
        check(took == want_took, f"{row} {label}: launches (hopper, mma, pool "
              f"backward, weight pack, stem) {took}, expected {want_took}")
        want = pfn()
        check(all(torch.equal(a, b) for a, b in zip(got, again) if a is not None),
              f"{row} {label}: two launches differ")
        err = float((got[0].float() - want[0].float()).abs().max())
        notes = []
        if row == "B4":  # (dK, db)
            dk_got, dk_want, db_pair = got[0], want[0], (got[1], want[1])
        else:
            check(one_rounding_ok(got[0], want[0]),
                  f"{row} {label}: beyond one bf16 rounding ({err:.4g})")
            notes.append("within one rounding")
            dk_got, dk_want = (got[1], want[1]) if row in ("B3", "B6") else (None, None)
            db_pair = (got[2], want[2]) if row == "B3" else None
        if dk_got is not None:
            rel = float((dk_got - dk_want).abs().max()) / float(dk_want.abs().max())
            check(rel <= 1e-4, f"{row} {label}: dK {rel:.3g} of max|dK|")
            notes.append(f"dK {rel:.2g} of max|dK|")
        if db_pair is not None:
            cot = g if g is not None else want[3]
            col = float(cot.float().abs().sum((0, 1, 2)).max())
            rel = float((db_pair[0] - db_pair[1]).abs().max()) / col
            check(rel <= 1e-5, f"{row} {label}: db {rel:.3g} of sum|g|")
            notes.append(f"db {rel:.2g} of sum|g|")
        if row == "B3":
            check(torch.equal(got[3], want[3]), f"B3 {label}: routed g differs")
            if g is None:
                notes.append("routed cotangent bit-exact")
        if routed is not None:  # B6's routed cotangent alone, planted ties
            check(torch.equal(routed[0](), routed[1]()),
                  f"B6 {label}: routed pool cotangent differs")
            notes.append("routed cotangent bit-exact")
        if row in ("B2", "B5") and got[1] is not None:
            exact = want[1] if row == "B5" else pool_fwd(got[0])
            check(torch.equal(got[1], exact), f"{row} {label}: pooled map differs")
            notes.append("pool bit-exact")
        if path:
            notes.append(f"{path} path")
        notes.append("repeat bitwise")
        say(f"[kernel] {row} {label} {shape}: max |kernel - plain| = {err:.4g}; "
            f"{', '.join(notes)}")
        worst[row] = max(worst.get(row, 0.0), err)
        del kfn, pfn, got, again, want, g, routed
    return worst


def pack_cases(flatconv, cases):
    """(row, label, weight shape (D, C), tile_n, tile_c, flip, stem) of the
    weight pack before each ``flatconv.cu`` launch of ``cases`` that takes
    one (all but B6's dz on the Hopper path and the stem on ``stem.cu``,
    whose blocks pack their own), at the tiles ``plan`` gives that
    launch."""
    out = []
    for row, label, (n, h, w, c, d) in cases:
        path = flat_path(flatconv, row, label, (n, h, w, c, d))
        if path in (None, "stem") or (row == "B6" and path == "hopper"):
            continue
        flip = row in ("B3", "B6")
        stem = row == "B2" and c <= flatconv.STEM_MAX_C
        pool = "+pool" in label
        mode = {"B2": "stem" if stem else "fwd_pool" if pool else "fwd",
                "B3": "dgrad", "B5": "side_pool" if pool else "side",
                "B6": "side_dgrad_pool" if pool else "side_dgrad"}[row]
        p = (flatconv.plan(n, h, w, d, c, mode) if flip
             else flatconv.plan(n, h, w, c, d, mode))
        out.append((row, label, (d, c), p.tile_n, p.tile_c, flip, stem))
    return out


def check_pack(device, flatconv, cases) -> None:
    """The weight pack kernel bit for bit against its plain version before
    every ``flatconv.cu`` launch of ``cases``, one count a launch, two
    launches bitwise equal."""
    for i, (row, label, (d, c), tn, tc, flip, stem) in enumerate(
            pack_cases(flatconv, cases)):
        k = torch.randn(d, c, 3, 3, device=device) * (9 * c) ** -0.5
        before = flatconv.pack_launches
        got = flatconv.pack_weight(k, tn, tc, flip=flip, stem=stem)
        again = flatconv.pack_weight(k, tn, tc, flip=flip, stem=stem)
        torch.cuda.synchronize()
        check(flatconv.pack_launches - before == 2, f"pack {row} {label}: launches")
        want = flatconv.pack_weight_ref(k, tn, tc, flip=flip, stem=stem)
        check(torch.equal(got, want) and torch.equal(got, again),
              f"pack {row} {label}: differs from its plain version")
    say(f"[kernel] flatconv weight pack: bit-exact against its plain version "
        f"before each of the {len(pack_cases(flatconv, cases))} flatconv.cu "
        f"launches of the checks that take one (flipped for B3 and the odd B6, "
        f"the stem's im2col), repeat bitwise")


def time_pack(device, flatconv, cases, card) -> dict:
    """The weight pack before each ``flatconv.cu`` launch of one flat step:
    ms per call (CUDA events), device ms, the plain version's ms, and the
    bound (bytes: the float32 weight read, the bf16 operand written),
    summed."""
    acc = dict(ms=0.0, dev=0.0, plain=0.0, nbytes=0, calls=0)
    for row, label, (d, c), tn, tc, flip, stem in pack_cases(
            flatconv, step_cases(cases)):
        k = torch.randn(d, c, 3, 3, device=device)
        out = flatconv.pack_weight(k, tn, tc, flip=flip, stem=stem)
        kfn = lambda: flatconv.pack_weight(k, tn, tc, flip=flip, stem=stem)  # noqa: E731
        pfn = lambda: flatconv.pack_weight_ref(k, tn, tc, flip=flip, stem=stem)  # noqa: E731
        acc["dev"] = add_ms(acc["dev"], device_ms(kfn, n=5))
        acc["ms"] += median_ms(kfn, n=10, warmup=2)
        acc["plain"] += median_ms(pfn, n=10, warmup=2)
        acc["nbytes"] += 4 * k.numel() + 2 * out.numel()
        acc["calls"] += 1
    acc["bound"] = acc["nbytes"] / HBM_BYTES_PER_S * 1e3
    say(f"[time] flatconv weight pack, the {acc['calls']} flatconv.cu launches "
        f"of one flat step that take one, summed: kernel {acc['ms']:.4f} ms per call, "
        f"{dev_text(acc['dev'])}; plain {acc['plain']:.4f}; bound "
        f"{acc['bound']:.4f} ms (bytes, {acc['nbytes'] / 1e6:.1f} MB) | {card}")
    return acc


def pool_cases(stages, n, h, w):
    """(label, (N, H, W, C), dtype, levels) of the pool checks: the stage
    boundaries of a step at (n, h, w) in bf16, the last one also in float32
    (parity mode), an odd small shape with C = 12 in both, and heavy ties
    (values on a few levels, as bf16 post-ReLU activations tie)."""
    bf16, f32 = torch.bfloat16, torch.float32
    out = []
    for i in range(1, len(stages)):
        shape = (n, h, w, stages[i - 1][-1])
        out.append((f"boundary {i}", shape, bf16, 0))
        h, w = -(-h // 2), -(-w // 2)
    out += [("boundary 4 float32", shape, f32, 0),
            ("boundary 1 ties", out[0][1], bf16, 4),
            ("odd", (2, 17, 29, 12), bf16, 4), ("odd float32", (2, 17, 29, 12), f32, 4),
            ("one pixel", (1, 1, 1, 5), bf16, 0)]
    return out


def nan_equal(got, want) -> bool:
    """Equal values, NaN where the plain version has NaN."""
    return bool(((got == want) | (got.isnan() & want.isnan())).all())


def check_pool(device, pool, cases) -> float:
    """The pool forward and backward against their plain versions bit for
    bit (NaN where the plain version has NaN), two launches bitwise
    equal. Returns the largest |kernel - plain| (0)."""
    worst = 0.0
    for i, (label, shape, dtype, levels) in enumerate(cases + [
            ("NaNs", (2, 17, 29, 16), torch.bfloat16, 0)]):
        x = bf16_randn(shape, device, SEED + 100 + i, relu=True,
                       levels=levels).to(dtype)
        if label == "NaNs":
            x[0, 4, 5, 3] = float("nan")
            x[1, 16, 28, :] = float("nan")  # a ragged corner window
        y, y2 = pool.max_pool_fwd(x), pool.max_pool_fwd(x)
        g = bf16_randn(y.shape, device, SEED + 200 + i).to(dtype)
        dx, dx2 = pool.max_pool_bwd(x, y, g), pool.max_pool_bwd(x, y, g)
        torch.cuda.synchronize()
        want_y = pool.max_pool_fwd_ref(x)
        want_dx = pool.max_pool_bwd_ref(x, want_y, g)
        check(y.shape == want_y.shape and y.dtype == dtype, f"pool {label}: shape")
        check(nan_equal(y, want_y) and nan_equal(y, y2),
              f"pool {label}: forward differs from its plain version")
        check(torch.equal(dx, want_dx) and torch.equal(dx, dx2),
              f"pool {label}: backward differs from its plain version")
        n, hh, ww, c = shape[0], shape[1] // 2, shape[2] // 2, shape[3]
        win = x[:, :2 * hh, :2 * ww].reshape(n, hh, 2, ww, 2, c)
        ties = int((win == y[:, :hh, None, :ww, None]).sum((2, 4)).gt(1).sum())
        say(f"[kernel] max_pool {label} {tuple(shape)} {str(dtype)[6:]}: "
            f"forward and backward bit-exact, repeat bitwise equal; "
            f"{ties} tied windows; {int(y.isnan().sum())} NaN outputs")
        worst = max(worst, float((dx.float() - want_dx.float()).abs().max()))
    return worst


def time_pool(device, pool, cases, card) -> dict:
    """Per direction, summed over the stage boundaries of one fast
    fine-tune step: the kernel's ms per call (CUDA events) and device ms,
    the plain version's, the library call's (``F.max_pool2d``, forward
    only) and the bound (bytes: each input read once, each output written
    once)."""
    totals = {d: dict(ms=0.0, dev=0.0, plain=0.0, lib=0.0, nbytes=0.0)
              for d in ("fwd", "bwd")}
    for i, (label, shape, dtype, _) in enumerate(cases):
        x = bf16_randn(shape, device, SEED + 300 + i, relu=True).to(dtype)
        y = pool.max_pool_fwd(x)
        g = bf16_randn(y.shape, device, SEED + 400 + i).to(dtype)
        xn = x.permute(0, 3, 1, 2)
        size = x.element_size()
        for d, kfn, pfn, lib, nbytes in (
                ("fwd", lambda: pool.max_pool_fwd(x),
                 lambda: pool.max_pool_fwd_ref(x),
                 lambda: torch.nn.functional.max_pool2d(xn, 2, 2, ceil_mode=True),
                 size * (x.numel() + y.numel())),
                ("bwd", lambda: pool.max_pool_bwd(x, y, g),
                 lambda: pool.max_pool_bwd_ref(x, y, g), None,
                 size * 2 * (x.numel() + y.numel()))):
            k_ms = median_ms(kfn, n=20, warmup=3)
            k_dev = device_ms(kfn, n=10)
            p_ms = median_ms(pfn, n=10, warmup=2)
            l_ms = median_ms(lib, n=20, warmup=3) if lib else None
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            gbps = lambda t: f"{nbytes / t / 1e6:.0f} GB/s"  # noqa: E731
            say(f"[time] max_pool_{d} {label} {tuple(shape)}: kernel "
                f"{k_ms:.4f} ms per call, {dev_text(k_dev, gbps)}; plain "
                f"{p_ms:.4f}; library "
                f"{'%.4f' % l_ms if lib else 'none'}; bound {b_ms:.4f} ms "
                f"(bytes, {nbytes / 1e6:.0f} MB) | {card}")
            acc = totals[d]
            acc["dev"] = add_ms(acc["dev"], k_dev)
            for key, v in (("ms", k_ms), ("plain", p_ms),
                           ("lib", l_ms or 0.0), ("nbytes", nbytes)):
                acc[key] += v
    for d, acc in totals.items():
        acc["bound"] = acc["nbytes"] / HBM_BYTES_PER_S * 1e3
        say(f"[time] max_pool_{d}, the {len(cases)} boundaries of one step "
            f"summed: kernel {acc['ms']:.4f} ms per call, "
            f"{dev_text(acc['dev'])}; plain {acc['plain']:.4f}; library "
            f"{'%.4f' % acc['lib'] if d == 'fwd' else 'none'}; bound "
            f"{acc['bound']:.4f} ms (bytes, {acc['nbytes'] / 1e6:.0f} MB) | {card}")
    return totals


def time_flat(device, flatconv, cases, card) -> dict:
    """Per row of B2-B6, summed over its calls of one fine-tune step: the
    kernel's ms per call (CUDA events) and device ms (profiler), the plain
    version's and the library call's ms per call, and the bound."""
    totals = {}
    for i, (row, label, shape) in enumerate(cases):
        kfn, pfn, lib, nbytes, ops, _, _ = make_flat_case(device, flatconv, row,
                                                          label, shape, i)
        k_ms, l_ms = paired_median_ms(kfn, lib)
        k_dev = device_ms(kfn, n=5)
        p_ms = median_ms(pfn, n=5, warmup=1)
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        tflops = lambda t: f"{ops / t / 1e9:.1f} TFLOP/s"  # noqa: E731
        path = flat_path(flatconv, row, label, shape)
        say(f"[time] {row} {label} {shape}: kernel {k_ms:.4f} ms per call "
            f"({tflops(k_ms)}), {dev_text(k_dev, tflops)}; plain {p_ms:.4f}; "
            f"library {l_ms:.4f}; bound {max(t_b, t_o):.4f} ms "
            f"({'bytes' if t_b >= t_o else 'operations'}); "
            f"{path + ' path' if path else 'wgrad.cu'} | {card}")
        # each row's calls, and B2's on the Hopper path (after the stem)
        for key in (row, "B2 after the stem") if row == "B2" and path == "hopper" else (row,):
            acc = totals.setdefault(key, dict(ms=0.0, dev=0.0, plain=0.0,
                                              lib=0.0, bound_b=0.0,
                                              bound_o=0.0, calls=0, ops=0,
                                              paths={}))
            acc["dev"] = add_ms(acc["dev"], k_dev)
            for name, v in (("ms", k_ms), ("plain", p_ms), ("lib", l_ms),
                            ("bound_b", t_b), ("bound_o", t_o), ("calls", 1),
                            ("ops", ops)):
                acc[name] += v
            where = f"{path} path" if path else "wgrad.cu"
            acc["paths"][where] = acc["paths"].get(where, 0) + 1
        del kfn, pfn, lib
    for row, acc in sorted(totals.items()):
        acc["bound"] = max(acc["bound_b"], acc["bound_o"])
        acc["by"] = "bytes" if acc["bound_b"] >= acc["bound_o"] else "operations"
        tflops = lambda t: f"{acc['ops'] / t / 1e9:.1f} TFLOP/s"  # noqa: E731
        paths = ", ".join(f"{n} on the {p}" if p != "wgrad.cu" else f"{n} wgrad.cu"
                          for p, n in acc["paths"].items())
        say(f"[time] {row}, its {acc['calls']} calls of one flat step summed: "
            f"kernel {acc['ms']:.3f} ms per call ({tflops(acc['ms'])}), "
            f"{dev_text(acc['dev'], tflops, digits=3)}; plain {acc['plain']:.3f}; "
            f"library {acc['lib']:.3f}; bound "
            f"{acc['bound']:.3f} ms ({acc['by']}); {paths} | {card}")
    return totals


def time_dgrad(device, flatconv, cases, card, row="B3") -> dict:
    """An input-gradient launch alone at each of its calls of a flat step:
    for ``row`` B3, B15's function dz = conv_T(g, K) * (x > 0) for a given
    cotangent g (``flatconv.cu`` mode 5); for B6, the side dz = conv_T(g,
    K) * (x > 0) plus, at a pooled side, the routed cotangent of x's pool
    (modes 7 and 8). Each with its weight pack, against its plain version
    and cuDNN's input gradient, summed; and the bound of that work alone."""
    from osvos_torch.ops.pool import pool_bwd, pool_fwd

    what = ("B15's function (B3's dz launch alone)" if row == "B3" else
            "B6's dz launch alone")
    acc = dict(ms=0.0, dev=0.0, plain=0.0, lib=0.0, bound_b=0.0, bound_o=0.0,
               ops=0, paths=set(), calls=0)
    for i, (r, label, (n, h, w, c, d)) in enumerate(cases):
        if r != row:
            continue
        pool = row == "B6" and "+pool" in label
        x = bf16_randn((n, h, w, c), device, i, relu=True, levels=4 * pool)
        g = bf16_randn((n, h, w, d), device, i + 1)
        k = torch.randn(d, c, 3, 3, device=device) * (9 * c) ** -0.5
        dz = torch.empty_like(x)
        xn, gn, kb = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2), k.to(torch.bfloat16)
        extra, route_bytes = {}, 0
        if pool:
            pooled = pool_fwd(x)
            dp = bf16_randn(pooled.shape, device, i + 3)
            extra, route_bytes = dict(zp=pooled, dzp=dp), 2 * 2 * pooled.numel()
        mode = ("dgrad" if row == "B3" else
                "side_dgrad_pool" if pool else "side_dgrad")
        kfn = lambda: flatconv._launch(mode, g, k, cout=c, y=dz, z=x, flip=True,  # noqa: E731
                                       **extra)

        def pfn():
            t = flatconv._conv3x3_t_f32(g, k) * (x > 0)
            if pool:
                t = t + pool_bwd(x, pooled, dp).float()
            return t.to(torch.bfloat16)

        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            gn, xn, kb, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, False, False])
        kfn()
        torch.cuda.synchronize()
        check(one_rounding_ok(dz, pfn()), f"{row} dz {label}: beyond one rounding")
        px = n * h * w
        ops = 2 * 9 * c * d * px
        k_dev = device_ms(kfn, n=5)
        k_ms, l_ms = paired_median_ms(kfn, lib)
        p_ms = median_ms(pfn, n=5, warmup=1)
        t_b = ((2 * px * (2 * c + d) + 4 * 9 * c * d + route_bytes)
               / HBM_BYTES_PER_S * 1e3)
        t_o = ops / BF16_OPS_PER_S * 1e3
        tflops = lambda t: f"{ops / t / 1e9:.1f} TFLOP/s"  # noqa: E731
        path = flatconv.plan(n, h, w, d, c, mode).path
        say(f"[time] {what} {label} {(n, h, w, c, d)}: "
            f"kernel {k_ms:.4f} ms per call ({tflops(k_ms)}), "
            f"{dev_text(k_dev, tflops)}; plain {p_ms:.4f}; library "
            f"(convolution_backward, dx) {l_ms:.4f}; bound {max(t_b, t_o):.4f} "
            f"ms ({'bytes' if t_b >= t_o else 'operations'}); {path} path | {card}")
        acc["dev"] = add_ms(acc["dev"], k_dev)
        acc["paths"].add(path)
        for key, v in (("ms", k_ms), ("plain", p_ms), ("lib", l_ms),
                       ("bound_b", t_b), ("bound_o", t_o), ("ops", ops),
                       ("calls", 1)):
            acc[key] += v
    acc["bound"] = max(acc["bound_b"], acc["bound_o"])
    acc["by"] = "bytes" if acc["bound_b"] >= acc["bound_o"] else "operations"
    tflops = lambda t: f"{acc['ops'] / t / 1e9:.1f} TFLOP/s"  # noqa: E731
    say(f"[time] {what}, its {acc['calls']} calls of one flat step summed: "
        f"kernel {acc['ms']:.3f} ms per call ({tflops(acc['ms'])}), "
        f"{dev_text(acc['dev'], tflops, digits=3)}; plain {acc['plain']:.3f}; "
        f"library (convolution_backward, dx) {acc['lib']:.3f}; bound "
        f"{acc['bound']:.3f} ms ({acc['by']}); "
        f"{' and '.join(sorted(acc['paths']))} path; within one rounding of "
        f"the plain version | {card}")
    return acc


def host_split(device, flatconv, card, n_calls: int = 20) -> None:
    """Per-call host work of the flat wrappers: one side_fwd and one
    side_bwd at side_prep1's shape (pooled) and one conv_fwd at a trunk
    shape. For each, the host clock of the call alone (the card idle, so
    the call only enqueues; median of ``n_calls``), and a CPU trace of
    ``n_calls`` calls (``torch.profiler``): the PyTorch operators' own time
    by name per call, and the rest of the call (Python, ctypes and the
    entry points: tensor-map encodes and launches)."""
    from torch.profiler import ProfilerActivity, profile

    from osvos_torch.ops.pool import pool_fwd

    n, h, w, c = FT_BATCH, -(-H // 2), -(-W // 2), 128
    x = bf16_randn((n, h, w, c), device, 1, relu=True)
    k = torch.randn(SIDE_CH, c, 3, 3, device=device) * (9 * c) ** -0.5
    g = bf16_randn((n, h, w, SIDE_CH), device, 2)
    pooled = pool_fwd(x)
    pl = (pooled, bf16_randn(pooled.shape, device, 3))
    kt = torch.randn(c, c, 3, 3, device=device) * (9 * c) ** -0.5
    bt = torch.randn(c, device=device) * 0.1
    calls = (("side_fwd side_prep1 +pool", (n, h, w, c, SIDE_CH),
              lambda: flatconv.side_fwd(x, k, pool=True)),
             ("side_bwd side_prep1 +pool", (n, h, w, c, SIDE_CH),
              lambda: flatconv.side_bwd(x, k, g, pool=pl)),
             ("conv_fwd stage2_conv1", (n, h, w, c, c),
              lambda: flatconv.conv_fwd(x, kt, bt)))
    for name, shape, fn in calls:
        for _ in range(3):
            fn()
        times = []
        for _ in range(n_calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        wall = statistics.median(times)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
        ops = {}
        for e in prof.key_averages():
            if e.key.startswith("aten::") and e.self_cpu_time_total > 0:
                ops[e.key] = e.self_cpu_time_total / n_calls
        traced = sum(ops.values())
        top = sorted(ops.items(), key=lambda kv: -kv[1])
        say(f"[host] {name} {shape}: {wall:.1f} us per call on the host "
            f"(median of {n_calls}, the call alone); PyTorch operators "
            f"{traced:.1f} us a call under the profiler ("
            + ", ".join(f"{key[6:]} {us:.1f}" for key, us in top[:6])
            + f"); the rest (Python, ctypes, the entry points) "
            f"{max(wall - traced, 0.0):.1f} us | {card}")


# ---------------------------------------------------------------------------
# int8 inference: I1 (csrc/int8conv.cu) and the .ckpt reader
# ---------------------------------------------------------------------------


def int8_inputs(device, shape, seed):
    """(x_q, w_q, scale, bias) of an I1 call at (N, H, W, Cin, Cout): int8
    operands over the whole code range, scales of about the trunk's
    (x_scale * w_scale, 1e-5 to 1e-3) and biases N(0, 0.1)."""
    n, h, w, c, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x_q = torch.randint(-127, 128, (n, h, w, c), generator=gen, device=device,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (d, c, 3, 3), generator=gen, device=device,
                        dtype=torch.int8)
    scale = torch.rand(d, generator=gen, device=device) * 1e-3 + 1e-5
    bias = torch.randn(d, generator=gen, device=device) * 0.1
    return x_q, w_q, scale, bias


def int_mm_takes(shape) -> bool:
    """Whether ``torch._int_mm`` on CUDA takes the plain version's product
    at (N, H, W, Cin, Cout): more than 16 rows, K = 9 Cin and Cout
    multiples of 8."""
    n, h, w, c, d = shape
    return n * h * w > 16 and c % 8 == 0 and d % 8 == 0


def check_int8(device, int8conv, shapes) -> float:
    """I1 against its plain version, bit for bit, at every shape of
    ``shapes`` (the trunk convs after the stem at full width, then
    ``INT8_ODD``), with and without the ReLU at the odd ones: one count a
    launch, a repeat bitwise equal; the plain version on the card where
    ``torch._int_mm`` takes the shape, else on CPU copies. Then CUDA
    tensors it does not take raise and launch nothing. Returns the largest
    |kernel - plain| (0)."""
    worst = 0.0
    for i, (label, shape) in enumerate(shapes):
        ops = int8_inputs(device, shape, SEED + 1100 + i)
        for relu in ((True,) if label != "odd" else (True, False)):
            before = int8conv.launches
            y = int8conv.int8_conv3x3(*ops, relu=relu)
            y2 = int8conv.int8_conv3x3(*ops, relu=relu)
            torch.cuda.synchronize()
            took = int8conv.launches - before
            on_card = int_mm_takes(shape)
            want = (int8conv.int8_conv3x3_ref(*ops, relu=relu) if on_card else
                    int8conv.int8_conv3x3_ref(*[t.cpu() for t in ops], relu=relu)
                    .to(device))
            err = float((y.float() - want.float()).abs().max())
            zeros = float((want == 0).float().mean())
            say(f"[kernel] int8_conv3x3 (I1) {label} {shape} relu={relu}: "
                f"bit for bit {torch.equal(y, want)} against the plain version "
                f"({'on the card' if on_card else 'on CPU copies: torch._int_mm on CUDA takes more than 16 rows and K, Cout multiples of 8'}); "
                f"repeat bitwise {torch.equal(y, y2)}; zeros {zeros:.1%}")
            check(took == 2, f"I1 {shape}: {took} launches counted for 2")
            check(y.shape == want.shape and y.dtype == torch.bfloat16,
                  f"I1 {shape}: shape or type")
            check(torch.equal(y, want), f"I1 {label} {shape} relu={relu}: "
                  f"differs from its plain version by up to {err:.4g}")
            check(torch.equal(y, y2), f"I1 {shape}: two launches differ")
            check(zeros > 0.05 if relu else zeros < 0.05,
                  f"I1 {shape}: the ReLU acted {zeros:.1%} (relu={relu})")
            worst = max(worst, err)
        del ops
    x_q, w_q, scale, bias = int8_inputs(device, (1, 9, 13, 16, 8), SEED)
    before = int8conv.launches
    for what, args, kw in (
            ("float32 x", (x_q.float(), w_q, scale, bias), {}),
            ("NWHC view of x", (x_q.transpose(1, 2), w_q, scale, bias), {}),
            ("w_q on the CPU", (x_q, w_q.cpu(), scale, bias), {}),
            ("float64 scale", (x_q, w_q, scale.double(), bias), {}),
            ("packed weight cut short", (x_q, w_q, scale, bias),
             {"packed": int8conv.pack_weight(w_q)[:, :64]})):
        try:
            int8conv.int8_conv3x3(*args, **kw)
        except ValueError:
            continue
        check(False, f"I1 took a {what}")
    check(int8conv.launches == before, "I1 launched on operands it refuses")
    say("[kernel] int8_conv3x3 (I1) refuses a float32 x, an NWHC view, w_q "
        "on the CPU, a float64 scale and a short packed weight, launching "
        "nothing")
    return worst


def time_int8(device, int8conv, shapes, card) -> dict:
    """I1 at each full-width trunk conv after the stem: its ms per call
    (CUDA events, in turns with the library's im2col + ``torch._int_mm``)
    and device ms and kernels a call (profiler, after a warm-up window;
    one kernel a call), the plain version's (that and its
    epilogue), cuDNN's bf16 conv of the same shape (``F.conv2d``, what
    'fast' pays for the product), and the bound (operations at the int8
    peak; bytes: x read, y written in bf16, the weight, scale and bias
    read). Returns the sums."""
    tot = dict(ms=0.0, dev=0.0, plain=0.0, lib=0.0, cudnn=0.0, bound_b=0.0,
               bound_o=0.0, ops=0.0)
    for i, (label, shape) in enumerate(shapes):
        n, h, w, c, d = shape
        x_q, w_q, scale, bias = int8_inputs(device, shape, SEED + 1200 + i)
        packed = int8conv.pack_weight(w_q)
        xb = (x_q.float() * 0.01).to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = (w_q.float() * 0.01).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        kfn = lambda: int8conv.int8_conv3x3(x_q, w_q, scale, bias, packed=packed)  # noqa: E731
        lib = lambda: int8conv.int8_conv3x3_acc_ref(x_q, w_q)  # noqa: E731
        pfn = lambda: int8conv.int8_conv3x3_ref(x_q, w_q, scale, bias)  # noqa: E731
        cud = lambda: torch.nn.functional.conv2d(xb, wb, padding=1)  # noqa: E731
        k_ms, l_ms = paired_median_ms(kfn, lib)
        k_dev, k_kernels = device_per_call(kfn, n=10)
        c_ms = median_ms(cud, n=20, warmup=3)
        p_ms = median_ms(pfn, n=5, warmup=1)
        px = n * h * w
        nbytes = px * (c + 2 * d) + 9 * c * d + 8 * d
        ops = 2 * 9 * c * d * px
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        b_ms, b_by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        tops = lambda t: f"{ops / t / 1e9:.1f} TOP/s, {b_ms / t:.1%} of bound"  # noqa: E731
        say(f"[time] int8_conv3x3 (I1) {label} {shape}: kernel {k_ms:.4f} ms "
            f"per call, {dev_text(k_dev, tops)}, {k_kernels} device kernel(s) "
            f"a call; plain {p_ms:.4f}; library (im2col + torch._int_mm) "
            f"{l_ms:.4f}; cuDNN bf16 conv {c_ms:.4f}; bound {b_ms:.4f} ms "
            f"({b_by}) | {card}")
        # the profiler can miss an event, so a call's kernels read at most 1
        check(k_kernels is None or 0.5 < k_kernels <= 1,
              f"I1: {k_kernels} device kernels a call")
        for key, v in (("ms", k_ms), ("plain", p_ms), ("lib", l_ms),
                       ("cudnn", c_ms), ("bound_b", t_b), ("bound_o", t_o),
                       ("ops", ops)):
            tot[key] += v
        tot["dev"] = add_ms(tot["dev"], k_dev)
        del x_q, w_q, packed, xb, wb
    tot["bound"] = max(tot["bound_b"], tot["bound_o"])
    tot["by"] = "bytes" if tot["bound_b"] >= tot["bound_o"] else "operations"
    say(f"[time] int8_conv3x3 (I1), the {len(shapes)} trunk convs after the "
        f"stem summed: kernel {tot['ms']:.4f} ms per call, "
        f"{dev_text(tot['dev'])}; plain {tot['plain']:.4f}; library "
        f"{tot['lib']:.4f}; cuDNN bf16 conv {tot['cudnn']:.4f}; bound "
        f"{tot['bound']:.4f} ms ({tot['by']}) | {card}")
    return tot


def int8_q_inputs(device, int8conv, shape, seed, rule):
    """(x, x_scale, w_q, w_scale, bias) of an ``int8_conv3x3_q`` call at (N,
    H, W, Cin, Cout): bf16 x of std 2, and x_scale by ``rule``: 'given'
    float32(0.7 max|x|) / 127 over a signed x (codes clip at both ends),
    'static' float32(0.9 max|x| / 127) over a ReLU'd x (clips at +127),
    'dynamic' ``activation_scale`` of a ReLU'd x; weights quantized from
    N(0, 1), biases N(0, 0.1)."""
    n, h, w, c, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=gen, device=device) * 2
    if rule != "given":
        x = x.relu()
    x = x.to(torch.bfloat16)
    peak = float(x.float().abs().max())
    if rule == "given":
        x_scale = int8conv.activation_scale(
            x, given=torch.tensor(0.7 * peak, dtype=torch.float32, device=device))
    elif rule == "static":
        x_scale = int8conv.activation_scale(x, static=0.9 * peak)
    else:
        x_scale = int8conv.activation_scale(x)
    w_q, w_scale = int8conv.quantize_weight(
        torch.randn(d, c, 3, 3, generator=gen, device=device))
    bias = torch.randn(d, generator=gen, device=device) * 0.1
    return x, x_scale, w_q, w_scale, bias


def check_int8_q(device, int8conv, shapes) -> float:
    """I1's entry on bf16 x (``int8_conv3x3_q``) against its plain version,
    bit for bit, under the given, static and dynamic rules at every shape
    of ``shapes`` (the full-width trunk convs after the stem take the
    Hopper path, the odd shapes the mma path, counted apart), its max_out
    against the plain max, a repeat bitwise equal; then a dynamic case with
    -0.0 outputs (zero scales and -0.0 biases on some channels), and the
    refusals; and two scales out of the range of the division-free
    quantization. Returns the largest |kernel - plain| (0)."""
    worst = 0.0
    for i, (label, shape) in enumerate(shapes):
        n, h, w, c, d = shape
        hopper = int8conv.hopper_takes(c, d)
        for rule in ("given", "static", "dynamic"):
            ops = int8_q_inputs(device, int8conv, shape, SEED + 1300 + i, rule)
            packed = int8conv.pack_for(ops[2])
            m1 = torch.zeros((), device=device)
            before = (int8conv.hopper_launches, int8conv.launches)
            y = int8conv.int8_conv3x3_q(*ops, packed=packed, max_out=m1)
            y2 = int8conv.int8_conv3x3_q(*ops, packed=packed)
            torch.cuda.synchronize()
            took = (int8conv.hopper_launches - before[0], int8conv.launches - before[1])
            on_card = int_mm_takes(shape)
            m2 = torch.zeros((), device=device if on_card else "cpu")
            want = (int8conv.int8_conv3x3_q_ref(*ops, max_out=m2) if on_card else
                    int8conv.int8_conv3x3_q_ref(*[t.cpu() for t in ops], max_out=m2)
                    .to(device))
            err = float((y.float() - want.float()).abs().max())
            zeros = float((want == 0).float().mean())
            say(f"[kernel] int8_conv3x3_q (I1) {label} {shape} {rule}: "
                f"{'hopper' if hopper else 'mma'} path, launches (hopper, mma) "
                f"{took}; bit for bit {torch.equal(y, want)} against the plain "
                f"version ({'on the card' if on_card else 'on CPU copies'}); "
                f"repeat bitwise {torch.equal(y, y2)}; max_out {float(m1)} vs "
                f"plain {float(m2)}; zeros {zeros:.1%}")
            check(took == ((2, 0) if hopper else (0, 2)),
                  f"I1 q {shape}: launches (hopper, mma) {took}")
            check(y.shape == want.shape and y.dtype == torch.bfloat16,
                  f"I1 q {shape}: shape or type")
            check(torch.equal(y, want), f"I1 q {label} {shape} {rule}: differs "
                  f"from its plain version by up to {err:.4g}")
            check(torch.equal(y, y2), f"I1 q {shape} {rule}: two launches differ")
            check(float(m1) == float(m2) and (float(m1) > 0 or label == "odd"),
                  f"I1 q {shape} {rule}: max_out {float(m1)}, plain {float(m2)}")
            worst = max(worst, err)
            del ops, packed, y, y2, want
    # -0.0 outputs: a channel with a zero scale and a -0.0 bias gives
    # float(acc) * 0 + -0.0, -0.0 where acc < 0, and the ReLU keeps it
    label, shape = shapes[len(shapes) // 2]
    x, x_scale, w_q, w_scale, bias = int8_q_inputs(device, int8conv, shape, SEED + 1399,
                                                   "dynamic")
    w_scale = w_scale.clone()
    bias = bias.clone()
    w_scale[::3] = 0.0
    bias[::3] = -0.0
    bias[1::3] = -5.0  # these channels' outputs are all zero
    m1 = torch.zeros((), device=device)
    y = int8conv.int8_conv3x3_q(x, x_scale, w_q, w_scale, bias, max_out=m1)
    m2 = torch.zeros((), device=device)
    want = int8conv.int8_conv3x3_q_ref(x, x_scale, w_q, w_scale, bias, max_out=m2)
    negz = int((y.view(torch.int16) == -32768).sum())
    say(f"[kernel] int8_conv3x3_q (I1) {label} {shape} with -0.0 outputs "
        f"({negz}): bit for bit {torch.equal(y, want)}, max_out {float(m1)} vs "
        f"plain {float(m2)}")
    check(negz > 0 and torch.equal(y, want) and float(m1) == float(m2),
          "I1 q: -0.0 outputs or their max differ")
    # scales past the range of the division-free quantization, where the
    # kernel divides: an all-zero input's dynamic scale (1e-30) and a tiny
    # given one
    x, x_scale, w_q, w_scale, bias = int8_q_inputs(device, int8conv, (2, 9, 70, 64, 128),
                                                   SEED + 1398, "given")
    for what, xi, si in (("an all-zero x, dynamic", torch.zeros_like(x),
                          int8conv.activation_scale(torch.zeros_like(x))),
                         ("a given scale of 1e-25", x, int8conv.activation_scale(
                             x, given=torch.tensor(1e-25, device=device)))):
        y = int8conv.int8_conv3x3_q(xi, si, w_q, w_scale, bias)
        want = int8conv.int8_conv3x3_q_ref(xi, si, w_q, w_scale, bias)
        say(f"[kernel] int8_conv3x3_q (I1) (2, 9, 70, 64, 128) with {what} "
            f"(x_scale {float(si):.3g}): bit for bit {torch.equal(y, want)}")
        check(torch.equal(y, want), f"I1 q with {what} differs from the plain version")
    x, x_scale, w_q, w_scale, bias = int8_q_inputs(device, int8conv, (1, 9, 13, 64, 64),
                                                   SEED, "dynamic")
    before = int8conv.hopper_launches
    for what, args, kw in (
            ("float32 x", (x.float(), x_scale, w_q, w_scale, bias), {}),
            ("NWHC view of x", (x.transpose(1, 2), x_scale, w_q, w_scale, bias), {}),
            ("float64 x_scale", (x, x_scale.double(), w_q, w_scale, bias), {}),
            ("w_q on the CPU", (x, x_scale, w_q.cpu(), w_scale, bias), {}),
            ("the mma path's packing", (x, x_scale, w_q, w_scale, bias),
             {"packed": int8conv.pack_weight(w_q)}),
            ("max_out without the ReLU", (x, x_scale, w_q, w_scale, bias),
             {"relu": False, "max_out": torch.zeros((), device=device)})):
        try:
            int8conv.int8_conv3x3_q(*args, **kw)
        except ValueError:
            continue
        check(False, f"I1 q took a {what}")
    check(int8conv.hopper_launches == before, "I1 q launched on operands it refuses")
    say("[kernel] int8_conv3x3_q (I1) refuses a float32 x, an NWHC view, a "
        "float64 x_scale, w_q on the CPU, the mma path's packing and a max_out "
        "without the ReLU, launching nothing")
    return worst


def time_int8_q(device, int8conv, shapes, card) -> dict:
    """I1's Hopper path at each full-width trunk conv after the stem, on
    bf16 x with the dynamic rule: ms per call (CUDA events, in turns with
    cuDNN's bf16 conv), device ms (CUDA events around calls queued back to
    back, in turns with cuDNN's) and kernels a call (profiler), the plain
    version (the quantization, im2col + ``torch._int_mm``, the epilogue),
    im2col + ``torch._int_mm`` alone of the quantized operand, cuDNN's bf16
    conv of the same x (per call and device), and the bound: the larger of
    operations at the int8 peak and bytes (x read as bf16, y written as
    bf16, the weight, scales and bias read), each conv's summed. Returns the
    sums."""
    tot = dict(ms=0.0, dev=0.0, plain=0.0, lib=0.0, cudnn=0.0, cudnn_dev=0.0,
               bound_b=0.0, bound_o=0.0, ops=0.0)
    for i, (label, shape) in enumerate(shapes):
        n, h, w, c, d = shape
        x, x_scale, w_q, w_scale, bias = int8_q_inputs(device, int8conv, shape,
                                                       SEED + 1400 + i, "dynamic")
        packed = int8conv.pack_for(w_q)
        x_q = int8conv.quantize_activation(x, x_scale)
        xb = x.permute(0, 3, 1, 2)
        wb = (w_q.float() * 0.01).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        kfn = lambda: int8conv.int8_conv3x3_q(x, x_scale, w_q, w_scale, bias, packed=packed)  # noqa: E731
        lib = lambda: int8conv.int8_conv3x3_acc_ref(x_q, w_q)  # noqa: E731
        pfn = lambda: int8conv.int8_conv3x3_q_ref(x, x_scale, w_q, w_scale, bias)  # noqa: E731
        cud = lambda: torch.nn.functional.conv2d(xb, wb, padding=1)  # noqa: E731
        k_ms, c_ms = paired_median_ms(kfn, cud)
        # device time: CUDA events around 20 calls queued back to back, in
        # turns (I1, cuDNN, cuDNN, I1); the profiler's count checks that a
        # call is one kernel (it can miss events late in a run)
        runs = [queued_ms(fn) for fn in (kfn, cud, cud, kfn)]
        k_dev, c_dev = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        _, k_kernels = device_per_call(kfn, n=10)
        l_ms = median_ms(lib, n=5, warmup=1)
        p_ms = median_ms(pfn, n=5, warmup=1)
        px = n * h * w
        nbytes = 2 * px * (c + d) + 9 * c * d + 8 * d + 4
        ops = 2 * 9 * c * d * px
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        b_ms, b_by = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        tops = lambda t: f"{ops / t / 1e9:.1f} TOP/s, {b_ms / t:.1%} of bound"  # noqa: E731
        say(f"[time] int8_conv3x3_q (I1 hopper) {label} {shape}: kernel "
            f"{k_ms:.4f} ms per call, {dev_text(k_dev, tops)} (queued, "
            f"events; runs {runs[0]:.4f} {runs[3]:.4f}), {k_kernels} device "
            f"kernel(s) a call (profiler); cuDNN bf16 conv {c_ms:.4f} per call, "
            f"{dev_text(c_dev)} (runs {runs[1]:.4f} {runs[2]:.4f}); plain "
            f"{p_ms:.4f}; im2col + torch._int_mm {l_ms:.4f}; bound {b_ms:.4f} "
            f"ms ({b_by}) | {card}")
        # the profiler can miss events, never add one: at most one a call
        check(k_kernels is None or k_kernels <= 1,
              f"I1 q: {k_kernels} device kernels a call")
        # each conv's bound, summed by what bounds it
        for key, v in (("ms", k_ms), ("plain", p_ms), ("lib", l_ms),
                       ("cudnn", c_ms), ("bound_b" if b_by == "bytes" else "bound_o", b_ms),
                       ("ops", ops)):
            tot[key] += v
        tot["dev"] += k_dev
        tot["cudnn_dev"] += c_dev
        del x, x_scale, w_q, w_scale, bias, packed, x_q, xb, wb
    tot["bound"] = tot["bound_b"] + tot["bound_o"]
    tot["by"] = "bytes" if tot["bound_b"] >= tot["bound_o"] else "operations"
    say(f"[time] int8_conv3x3_q (I1 hopper), the {len(shapes)} trunk convs "
        f"after the stem summed: kernel {tot['ms']:.4f} ms per call, "
        f"{dev_text(tot['dev'])} (queued); cuDNN bf16 conv {tot['cudnn']:.4f} "
        f"per call, {dev_text(tot['cudnn_dev'])} (queued; I1 / cuDNN device "
        f"{tot['dev'] / tot['cudnn_dev']:.3f}); plain {tot['plain']:.4f}; im2col "
        f"+ torch._int_mm {tot['lib']:.4f}; bound {tot['bound']:.4f} ms, each "
        f"conv's summed ({tot['bound_b']:.4f} of it bytes, {tot['bound_o']:.4f} "
        f"operations), I1 at {tot['bound'] / tot['dev']:.1%} of it | {card}")
    return tot


def ckpt_phase() -> int:
    """The JAX package's ``.ckpt`` on the card's machine: the committed
    fixture through ``load_checkpoint`` and ``load_training_state``, every
    leaf against the committed expected values, bit for bit, with no
    ``msgpack`` package imported. Returns the leaves checked."""
    from osvos_torch.utils.checkpoint import load_checkpoint, load_training_state

    path = os.path.join(ROOT, CKPT_FIXTURE)
    params, opt, step = load_training_state(path)
    only = load_checkpoint(path)
    checked = 0
    with np.load(os.path.join(ROOT, CKPT_EXPECT)) as want:
        check(step == int(want["step"]) and opt is not None
              and opt["mini_step"] == int(want["mini_step"]),
              f"ckpt: step {step} or mini-step differ from the expected")
        groups = {"params": params, "acc_grads": opt["acc_grads"],
                  "momentum": opt["momentum"]}
        for key in want.files:
            group, _, name = key.partition("/")
            if not name:
                continue
            got = groups[group][name].numpy()
            check(got.dtype == want[key].dtype and np.array_equal(got, want[key]),
                  f"ckpt: {key} differs from the expected")
            if group == "params":
                check(np.array_equal(only[name].numpy(), want[key]),
                      f"ckpt: load_checkpoint's {name} differs")
            checked += 1
        check(sum(len(v) for v in groups.values()) == checked,
              "ckpt: leaves the expected values do not hold")
    check("msgpack" not in sys.modules, "ckpt: the msgpack package was imported")
    say(f"[ckpt] {CKPT_FIXTURE} ({os.path.getsize(path)} bytes, written by the "
        f"JAX package's save_checkpoint) read by load_training_state and "
        f"load_checkpoint without the msgpack package: {checked} leaves "
        f"(params, accumulated gradients, momentum) bit for bit against "
        f"{CKPT_EXPECT}, step {step}, mini-step {opt['mini_step']}")
    return checked


@contextlib.contextmanager
def plain_i1(int8conv):
    """Substitute I1's plain versions for its two entries."""
    kernel, kernel_q = int8conv.int8_conv3x3, int8conv.int8_conv3x3_q
    int8conv.int8_conv3x3 = (lambda x_q, w_q, scale, bias, relu=True, packed=None:
                             int8conv.int8_conv3x3_ref(x_q, w_q, scale, bias, relu))
    int8conv.int8_conv3x3_q = (
        lambda x, x_scale, w_q, w_scale, bias, relu=True, packed=None, max_out=None:
        int8conv.int8_conv3x3_q_ref(x, x_scale, w_q, w_scale, bias, relu, max_out))
    try:
        yield
    finally:
        int8conv.int8_conv3x3, int8conv.int8_conv3x3_q = kernel, kernel_q


def frames_per_s(model, frames, batch, runs=3) -> float:
    """Median frames/s of ``infer_sequence`` over ``frames`` at ``batch``."""
    from osvos_torch.evaluation.infer import infer_sequence

    infer_sequence(model, frames[:batch], batch_size=batch)  # warm-up
    secs = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer_sequence(model, frames, batch_size=batch)
        secs.append(time.perf_counter() - t0)
    return len(frames) / statistics.median(secs)


def png_frames_per_s(model, frames, batch) -> float:
    """Frames/s of one ``infer_sequence`` over ``frames`` at ``batch`` and
    the PNG writes of its maps."""
    from osvos_torch.evaluation.infer import infer_sequence, save_sequence_results

    with tempfile.TemporaryDirectory() as results:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = infer_sequence(model, frames, batch_size=batch)
        save_sequence_results(masks, [f"{i:05d}.jpg" for i in range(len(frames))],
                              results, "synth")
        return len(frames) / (time.perf_counter() - t0)


def device_busy_per_batch(model, frames, batch):
    """(device ms, wall ms) a batch of one ``infer_sequence`` over
    ``frames`` at ``batch`` under the profiler: the device activity summed
    (kernels and copies), which leaves the host's share (stacking, the
    pageable copy, Python) to the rest of the wall time."""
    from osvos_torch.evaluation.infer import infer_sequence

    batches = -(-len(frames) // batch)
    events, wall_us = device_events(
        lambda: infer_sequence(model, frames, batch_size=batch), 1)
    busy = sum(us for _, us in events) / batches / 1e3 if events else None
    return busy, wall_us / batches / 1e3


def serve_int8(device, k, fast_model, frames, card) -> dict:
    """int8 serving at full width: the fast model's weights (seeded, head
    spread) in int8 mode with static scales calibrated on frame 0 and with
    dynamic scales; 12 frames through ``infer_sequence`` at batch 4 and the
    PNG writer: exact launches (I1 per trunk conv after the stem and batch,
    B1 per batch, the pool forward per boundary and batch), the maps bit
    for bit against the same model with I1's plain version, and against
    fast serving's maps (the share of pixels whose 0.5 masks agree); then
    frames/s with and without PNG writes at batch 4 and at batch 32
    (``bench.py``'s default), fast beside int8. Returns the static run's
    launches and agreement, and each mode's rates (``fast``, ``static``,
    ``dynamic``)."""
    import dataclasses

    from osvos_torch.configs import ModelConfig
    from osvos_torch.data.image_io import imread
    from osvos_torch.evaluation.infer import infer_sequence, save_sequence_results
    from osvos_torch.models import OSVOS, stage_conv_names
    from osvos_torch.models.quantize import calibrate_int8_scales

    int8conv, fused_head = k["int8conv"], k["fused_head"]
    cfg = ModelConfig(compute_mode="int8")
    state = fast_model.state_dict()
    t0 = time.perf_counter()
    scales = calibrate_int8_scales(state, frames[:1], cfg)
    cal_s = time.perf_counter() - t0
    say(f"[serve int8] calibrated on frame 0 in {cal_s:.3f} s (margin 1.05): "
        f"{[round(s, 3) for s in scales]}")
    convs = len(stage_conv_names(cfg.stages))
    check(len(scales) == convs and all(
        np.isfinite(s) and s > 0 for s in scales), "calibration scales")
    fast_maps = np.stack(infer_sequence(fast_model, frames, batch_size=BATCH))
    batches = -(-N_FRAMES // BATCH)
    convs -= 1  # the stem is a bf16 conv
    sides = len(cfg.stages) - 1
    out = {}
    for label, mcfg in (("static", dataclasses.replace(cfg, int8_scales=scales)),
                        ("dynamic", cfg)):
        model = OSVOS(mcfg)
        model.load_state_dict(state)
        model.to(device).eval()
        infer_sequence(model, frames[:BATCH], batch_size=BATCH)  # warm-up
        torch.cuda.synchronize()
        fnames = [f"{i:05d}.jpg" for i in range(N_FRAMES)]
        with tempfile.TemporaryDirectory() as results:
            zero_counts(k)
            fused_head.launches = 0
            masks = infer_sequence(model, frames, batch_size=BATCH)
            save_sequence_results(masks, fnames, results, "synth")
            counts = read_counts(k)
            i1, tail = counts["int8_conv3x3_q (I1 hopper)"], fused_head.launches
            decoded = [imread(os.path.join(results, "synth", f"{i:05d}.png"), gray=True)
                       for i in range(N_FRAMES)]
        want = {name: 0 for name in counts}
        want.update({"int8_conv3x3_q (I1 hopper)": convs * batches,
                     "max_pool_fwd": sides * batches})
        say(f"[serve int8 {label}] launches {counts}, fused_head {tail}; "
            f"expected I1's Hopper path {convs * batches} ({convs} convs x "
            f"{batches} batches) and its mma path 0, pools {sides * batches}, "
            f"fused_head {batches}")
        check(counts == want and tail == batches,
              f"int8 serving ({label}) launch counts {counts}, fused_head {tail}")
        got = np.stack(masks)
        check(got.shape == (N_FRAMES, H, W) and got.dtype == np.uint8, "int8 maps")
        check(all(np.array_equal(d, m) for d, m in zip(decoded, masks)),
              "int8 PNG contents differ from the maps")
        with plain_i1(int8conv):
            plain = np.stack(infer_sequence(model, frames, batch_size=BATCH))
        agree = float(((got >= 128) == (fast_maps >= 128)).mean())
        codes = np.abs(got.astype(int) - fast_maps.astype(int))
        say(f"[serve int8 {label}] maps against I1's plain version: bit for bit "
            f"{np.array_equal(got, plain)}; against fast serving: 0.5 masks "
            f"agree on {agree:.4%} of pixels (limit {INT8_MIN_AGREE:.0%}), "
            f"mean |int8 - fast| {codes.mean():.3f} codes, max {codes.max()}; "
            f"{len(np.unique(got))} distinct codes")
        check(np.array_equal(got, plain), f"int8 serving ({label}) differs "
              "from the plain I1's")
        check(agree >= INT8_MIN_AGREE, f"int8 serving ({label}) agrees with "
              f"fast on {agree:.4%} of pixels")
        check(len(np.unique(got)) >= 100, "int8 serving output is degenerate")
        out[label] = dict(launches=i1, tail=tail, agree=agree, model=model)
    many = frames[np.arange(SERVE_BIG_FRAMES) % N_FRAMES]
    for label, model in (("fast", fast_model), ("int8 static", out["static"].pop("model")),
                         ("int8 dynamic", out["dynamic"].pop("model"))):
        rates = dict(fps4=frames_per_s(model, frames, BATCH),
                     fps32=frames_per_s(model, many, SERVE_BIG_BATCH),
                     png4=png_frames_per_s(model, frames, BATCH),
                     png32=png_frames_per_s(model, many, SERVE_BIG_BATCH))
        busy = {b: device_busy_per_batch(model, f, b)
                for b, f in ((BATCH, frames), (SERVE_BIG_BATCH, many))}
        rates.update(busy4=busy[BATCH], busy32=busy[SERVE_BIG_BATCH])
        say(f"[time] serving {label}: infer_sequence {rates['fps4']:.2f} frames/s "
            f"at batch {BATCH} ({N_FRAMES} frames), {rates['fps32']:.2f} at batch "
            f"{SERVE_BIG_BATCH} ({len(many)} frames), median of 3; with PNG "
            f"writes {rates['png4']:.2f} and {rates['png32']:.2f}, one run; "
            + "; ".join(f"batch {b}: device busy {dev_text(bz, digits=3)} of "
                        f"{wall:.3f} ms wall a batch under the profiler"
                        for b, (bz, wall) in busy.items()) + f" | {card}")
        out.setdefault(label.split()[-1], {}).update(rates)
    return out



def run_card_tests() -> None:
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-rs",
         os.path.join("tests", "test_torch_cuda.py")],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "OSVOS_TEST_PLATFORM": "gpu"})
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    say(f"[tests] tests/test_torch_cuda.py: {summary}")
    check(proc.returncode == 0 and "skipped" not in summary,
          f"card tests failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")


def serve(device, k, model, frames):
    """The serving slice: 12 frames through ``infer_sequence`` and the PNG
    writer; returns the fused-head launches and the slice's seconds."""
    fused_head, pool = k["fused_head"], k["pool"]
    from osvos_torch.data.image_io import imread
    from osvos_torch.evaluation.infer import (infer_sequence, make_infer_fn,
                                              save_sequence_results)

    fnames = [f"{i:05d}.jpg" for i in range(N_FRAMES)]
    infer_sequence(model, frames, batch_size=BATCH)  # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as results:
        fused_head.launches = 0
        zero_counts(k)
        t0 = time.perf_counter()
        masks = infer_sequence(model, frames, batch_size=BATCH)
        save_sequence_results(masks, fnames, results, "synth")
        slice_s = time.perf_counter() - t0
        launches = fused_head.launches
        pools = (pool.fwd_launches, pool.bwd_launches)
        pngs = sorted(os.listdir(os.path.join(results, "synth")))
        decoded = [imread(os.path.join(results, "synth", p), gray=True)
                   for p in pngs]
    sides = len(model.config.stages) - 1
    say(f"[serve] fused_head launches in the run: {launches}; max pool "
        f"forward / backward launches: {pools[0]} / {pools[1]} ({sides} per "
        f"forward pass); PNGs written: {len(pngs)}")
    check(launches == N_FRAMES // BATCH, f"expected {N_FRAMES // BATCH} "
          f"fused_head launches, counted {launches}")
    check(pools == (sides * N_FRAMES // BATCH, 0),
          f"expected {sides * N_FRAMES // BATCH} pool launches, counted {pools}")
    check(len(pngs) == N_FRAMES, f"expected {N_FRAMES} PNGs, found {len(pngs)}")
    check(all(np.array_equal(d, m) for d, m in zip(decoded, masks)),
          "PNG contents differ from the maps")
    plain = make_infer_fn(model.config, kernel_tail=False)
    want = np.concatenate([
        plain(model, torch.from_numpy(frames[i:i + BATCH]).to(device)).cpu().numpy()
        for i in range(0, N_FRAMES, BATCH)]).astype(int)
    got = np.stack(masks).astype(int)
    err = int(np.abs(got - want).max())
    off = float((got != want).mean())
    distinct = len(np.unique(got))
    say(f"[serve] maps {masks[0].shape} uint8; max |kernel tail - plain tail| "
        f"= {err} code(s) on {off:.2e} of pixels; {distinct} distinct u8 values")
    check(all(m.shape == (H, W) and m.dtype == np.uint8 for m in masks),
          "map shape or type")
    check(err <= 1 and off <= MAX_OFF_SHARE,
          f"slice maps differ from the plain tail: {err} codes on {off:.2e}")
    check(distinct >= 100, "slice output is degenerate")
    return launches, slice_s


def check_parity(device, pool) -> None:
    from osvos_torch.configs import ModelConfig
    from osvos_torch.models import OSVOS, init_osvos_params
    from osvos_torch.models.surgery import spread_head

    pcfg = ModelConfig(compute_mode="parity")
    pmodel = OSVOS(pcfg)
    pmodel.load_state_dict(init_osvos_params(pcfg, torch.Generator().manual_seed(SEED)))
    x = torch.from_numpy(np.random.RandomState(SEED).randn(1, 65, 97, 3)
                         .astype(np.float32) * 40)
    spread_head(pmodel, x)
    with torch.no_grad():
        cpu_out = pmodel(x)
        launches = pool.fwd_launches
        gpu_out = pmodel.to(device)(x.to(device))
        launches = pool.fwd_launches - launches
    check(launches == len(pcfg.stages) - 1,
          f"parity forward: {launches} float32 pool launches")
    worst = 0.0
    for i, (g, c) in enumerate(zip(gpu_out, cpu_out)):
        rel = float((g.cpu() - c).abs().max()) / max(float(c.abs().max()), 1e-3)
        worst = max(worst, rel)
        check(bool(torch.isfinite(g).all()), f"parity output {i} not finite")
        check(rel <= 2e-4, f"parity output {i}: card vs CPU {rel:.3g} of scale")
    say(f"[parity] full width 65x97, 5 outputs: max |card - cpu| / max|out| "
        f"= {worst:.3g} (limit 2e-4); float32 pool launches {launches}")


def fine_tune_phase(device, k, frames, mode):
    """The fine-tune slice through ``make_fine_tune_fn`` in ``mode``, once
    with the kernels and once with their plain versions; the tuned weights
    then serve 4 frames. Returns (initial state, tuned model, losses, launch
    counts of the kernel run)."""
    from osvos_torch.configs import ModelConfig, OnlineConfig
    from osvos_torch.evaluation.infer import infer_sequence, make_infer_fn
    from osvos_torch.models import OSVOS, init_osvos_params
    from osvos_torch.train.online import make_fine_tune_fn

    fused_head = k["fused_head"]
    mcfg = ModelConfig(compute_mode=mode)
    ocfg = OnlineConfig(n_steps=FT_STEPS, loss_impl="pallas")
    check(ocfg.n_ave_grad == FT_BATCH, "OnlineConfig's default batch moved")
    state0 = init_osvos_params(mcfg, torch.Generator().manual_seed(SEED))
    image, mask = frames[0], blob_mask(H, W)
    fine_tune = make_fine_tune_fn(mcfg, ocfg, aug_mode="pool",
                                  pool_size=FT_POOL, device=device)
    tag = f"[fine-tune {mode}]"
    say(f"{tag} OSVOS {mode}, full width, frame 0 {H}x{W} with a "
        f"{mask.mean():.1%} foreground mask; pool {FT_POOL}, {FT_STEPS} steps "
        f"of batch {FT_BATCH}, lr {ocfg.lr}, loss_impl='pallas'")

    def run():
        model = OSVOS(mcfg)
        model.load_state_dict(state0)
        t0 = time.perf_counter()
        losses = fine_tune(model, image, mask, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        return model, losses, time.perf_counter() - t0

    zero_counts(k)
    model_k, losses_k, secs = run()
    counts = read_counts(k)
    want = expected_counts(mode, FT_STEPS, mcfg.stages)
    say(f"{tag} kernel run {secs:.2f} s (pool build and first-call set-up "
        f"included); launches {counts}, expected {want}")
    say(f"{tag} losses {[round(v, 4) for v in losses_k.tolist()]}")
    check(counts == want, f"{mode} launch counts {counts}, expected {want}")
    check(losses_k.shape == (FT_STEPS,) and bool(torch.isfinite(losses_k).all()),
          "fine-tune losses not finite")

    with plain_kernels(k):
        zero_counts(k)
        model_p, losses_p, secs_p = run()
        plain_counts = read_counts(k)
    say(f"{tag} plain run {secs_p:.2f} s; kernel launches {plain_counts}")
    check(not any(plain_counts.values()), "the plain run launched a kernel")
    loss_rel = float(((losses_k - losses_p).abs() / losses_p.abs()).max())
    worst_leaf, worst = delta_diff(state0, model_k.state_dict(),
                                   model_p.state_dict(), require_moved=True)
    weights = [key for key in state0 if key.endswith("weight")]
    w_leaf, w_worst = delta_diff({key: state0[key] for key in weights},
                                 model_k.state_dict(), model_p.state_dict())
    loss_limit, delta_limit = FT_LIMITS[mode]
    say(f"{tag} kernel vs plain: losses max rel diff {loss_rel:.3g} "
        f"(limit {loss_limit:g}); parameter deltas max {worst:.3g} of the "
        f"leaf's delta scale at {worst_leaf or '-'} (limit {delta_limit:g}), "
        f"of the weights {w_worst:.3g} at {w_leaf or '-'}; every trunk, "
        f"side_prep and fuse weight moved")
    # At lr 1e-8 a delta is some hundred float32 steps of its weight, so
    # one rounding step apart is about 1e-2 of it: the delta bound cannot
    # be much tighter.
    check(loss_rel <= loss_limit, f"losses differ by {loss_rel:.3g} relative")
    check(worst <= delta_limit, f"{worst_leaf} delta differs by {worst:.3g} of scale")

    model_k.eval()
    fused_head.launches = 0
    maps = infer_sequence(model_k, frames[:BATCH], batch_size=BATCH)
    tuned_launches = fused_head.launches
    plain = make_infer_fn(mcfg, kernel_tail=False)(
        model_k, torch.from_numpy(frames[:BATCH]).to(device)).cpu().numpy()
    err = int(np.abs(np.stack(maps).astype(int) - plain.astype(int)).max())
    say(f"{tag} tuned weights serve {BATCH} frames: fused_head launches "
        f"{tuned_launches}; max |kernel tail - plain tail| = {err} code(s)")
    check(tuned_launches == 1, "the tuned model did not serve through the kernel")
    check(all(m.shape == (H, W) and m.dtype == np.uint8 for m in maps),
          "tuned maps shape or type")
    check(err <= 1, "tuned maps differ from the plain tail")
    return state0, model_k, losses_k, counts


def delta_diff(state0, got, want, require_moved=False):
    """(leaf, largest |delta_got - delta_want| over the leaf's delta
    scale), the worst over the leaves."""
    worst_leaf, worst = "", 0.0
    for key in state0:
        dg = got[key].cpu() - state0[key]
        dw = want[key].cpu() - state0[key]
        scale = float(dw.abs().max())
        diff = float((dg - dw).abs().max())
        rel = diff / scale if scale else diff
        if rel > worst:
            worst_leaf, worst = key, rel
        if require_moved and key.endswith("weight") and not key.startswith("score_dsn"):
            check(scale > 0 and float(dg.abs().max()) > 0, f"{key} did not move")
    return worst_leaf, worst


def flat_vs_fast(state0, flat, fast, tag="[fine-tune]") -> None:
    """The flat run against the fast run of the same steps, within the CPU
    model-level bounds; ``flat`` and ``fast`` are (losses, state)."""
    (l_flat, p_flat), (l_fast, p_fast) = flat, fast
    loss_rtol, leaf_tol, global_tol = FLAT_VS_FAST
    loss_rel = float(((l_flat - l_fast).abs() / l_fast.abs()).max())
    gmax = max(float((p_fast[key].cpu() - state0[key]).abs().max()) for key in state0)
    worst_leaf, worst = "", 0.0
    for key in state0:
        dg = p_flat[key].cpu() - state0[key]
        dw = p_fast[key].cpu() - state0[key]
        bound = max(leaf_tol * float(dw.abs().max()), global_tol * gmax)
        ratio = float((dg - dw).abs().max()) / bound if bound else 0.0
        if ratio > worst:
            worst_leaf, worst = key, ratio
    say(f"{tag} flat vs fast, same steps: losses max rel diff "
        f"{loss_rel:.3g} (limit {loss_rtol:g}); parameter deltas at most "
        f"{worst:.3g} of their bound max({leaf_tol:g} x leaf scale, "
        f"{global_tol:g} x largest delta), at {worst_leaf or '-'}")
    check(loss_rel <= loss_rtol, f"flat vs fast losses {loss_rel:.3g} apart")
    check(worst <= 1.0, f"flat vs fast delta of {worst_leaf} out of bound")


def parent_calls(cfg):
    """The parent phase's batches: two epochs of the synthetic train split
    through ``make_train_pipeline`` (flip, ScaleNRotate, Resize, ToArray on
    the host), each call's (images, gts, side_weight)."""
    from osvos_torch.configs import DataConfig
    from osvos_torch.data.synthetic import SyntheticDAVIS
    from osvos_torch.train.parent import make_train_pipeline

    _, epoch_batches = make_train_pipeline(
        SyntheticDAVIS(PT_FRAMES, (H, W), seed=SEED), DataConfig(), cfg,
        input_res=(H, W), seed=SEED)
    calls = []
    for epoch in range(cfg.n_epochs):
        side_w = 1.0 - epoch / cfg.n_epochs
        calls += [(b["image"], b["gt"], side_w) for b in epoch_batches()]
    return calls


def parent_phase(device, k):
    """Parent training at full width through ``ParentTrainer``: the kernel
    run (launch counts, no move between optimizer steps, a snapshot after
    call 3), the plain-version run, the resume from the snapshot, a val
    loss, and 2 calls in flat mode. Returns (config, initial state, calls,
    launch counts of the kernel run)."""
    from osvos_torch.configs import ModelConfig, ParentConfig
    from osvos_torch.data.synthetic import SyntheticDAVIS
    from osvos_torch.data.transforms import Compose, Resize, ToArray
    from osvos_torch.models import init_osvos_params
    from osvos_torch.train.parent import ParentTrainer
    from osvos_torch.utils.checkpoint import load_training_state, save_checkpoint

    cfg = ParentConfig(n_epochs=PT_EPOCHS, batch_size=PT_BATCH,
                       n_ave_grad=PT_AVE, lr=PT_LR, loss_impl="pallas")
    stages = ModelConfig().stages
    state0 = init_osvos_params(ModelConfig(), torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    calls = parent_calls(cfg)
    say(f"[parent] OSVOS fast, full width; {len(calls)} calls of batch "
        f"{PT_BATCH} over {PT_EPOCHS} epochs of {PT_FRAMES} synthetic {H}x{W} "
        f"frames (host transforms {time.perf_counter() - t0:.2f} s); "
        f"n_ave_grad {PT_AVE}, lr {cfg.lr}, loss_impl='pallas', side weights "
        f"{[c[2] for c in calls]}")
    check(len(calls) == PT_EPOCHS * PT_FRAMES // PT_BATCH and all(
        c[0].shape == (PT_BATCH, H, W, 3) and c[1].shape == (PT_BATCH, H, W, 1)
        and set(np.unique(c[1])) == {0.0, 1.0} for c in calls), "parent batches")

    def run(mode, todo, trainer=None, on_call=None):
        trainer = trainer or ParentTrainer(state0, ModelConfig(compute_mode=mode),
                                           cfg, device=device)
        losses = []
        for i, (img, gt, side_w) in todo:
            losses.append(trainer.train_step(img, gt, side_w)["total"])
            if on_call:
                on_call(i, trainer)
        torch.cuda.synchronize()
        return trainer, torch.stack(losses).cpu()

    snaps = {}

    def watch(i, trainer):
        """No move between optimizer steps; keep the state after call 2
        (for flat) and a snapshot after call 3."""
        state = trainer.params
        stepped = (i + 1) % PT_AVE == 0
        same = all(torch.equal(v, snaps["prev"][key]) for key, v in state.items())
        check(same != stepped, f"parent call {i}: parameters "
              f"{'did not move at' if same else 'moved between'} optimizer steps")
        snaps["prev"] = {key: v.clone() for key, v in state.items()}
        if i + 1 == PT_FLAT_CALLS:
            snaps["fast2"] = {key: v.to("cpu", copy=True) for key, v in state.items()}
        if i + 1 == PT_SNAPSHOT:
            snaps["path"] = save_checkpoint(
                os.path.join(snaps["dir"], "parent_call-3.pt"), state,
                trainer.opt_state, step=0)

    indexed = list(enumerate(calls))
    with tempfile.TemporaryDirectory() as tmp:
        snaps.update(dir=tmp, prev={key: v.to(device) for key, v in state0.items()})
        zero_counts(k)
        t0 = time.perf_counter()
        trainer_k, losses_k = run("fast", indexed, on_call=watch)
        counts = read_counts(k)
        secs = time.perf_counter() - t0
        want = expected_counts("fast", len(calls), stages, PT_OUTPUTS)
        say(f"[parent] kernel run {secs:.2f} s (first-call set-up included); "
            f"launches {counts}, expected {want}")
        say(f"[parent] losses {[round(v, 2) for v in losses_k.tolist()]}; "
            f"parameters moved at calls {PT_AVE}, {2 * PT_AVE}, ... only")
        check(counts == want, f"parent launch counts {counts}, expected {want}")
        check(bool(torch.isfinite(losses_k).all()), "parent losses not finite")

        params, opt_state, _ = load_training_state(snaps["path"])
        check(opt_state["mini_step"] == PT_SNAPSHOT % PT_AVE, "snapshot mini_step")
        fresh = ParentTrainer(init_osvos_params(ModelConfig(), torch.Generator()
                                                .manual_seed(SEED + 1)),
                              ModelConfig(compute_mode="fast"), cfg, device=device)
        fresh.load(params, opt_state)
        resumed, losses_r = run("fast", indexed[PT_SNAPSHOT:], trainer=fresh)

    with plain_kernels(k):
        zero_counts(k)
        trainer_p, losses_p = run("fast", indexed)
        plain_counts = read_counts(k)
    check(not any(plain_counts.values()), "the plain run launched a kernel")
    final_k = trainer_k.params
    loss_limit, delta_limit = FT_LIMITS["fast"]
    for name, losses, other, skip in (
            ("plain versions", losses_p, trainer_p.params, 0),
            ("resumed after call 3", losses_r, resumed.params, PT_SNAPSHOT)):
        rel = float(((losses - losses_k[skip:]).abs() / losses_k[skip:].abs()).max())
        leaf, worst = delta_diff(state0, other, final_k,
                                 require_moved=name.startswith("plain"))
        steps = (float((final_k[leaf].cpu() - state0[leaf]).abs().max())
                 / float(np.spacing(state0[leaf].abs().max().numpy()))
                 if leaf else 0.0)
        say(f"[parent] kernel run vs {name}: losses max rel diff {rel:.3g} "
            f"(limit {loss_limit:g}); parameter deltas max {worst:.3g} of the "
            f"leaf's delta scale at {leaf or '-'} (limit {delta_limit:g}; that "
            f"scale is {steps:.0f} float32 steps of the leaf's largest value)")
        check(rel <= loss_limit, f"parent {name}: losses {rel:.3g} apart")
        check(worst <= delta_limit, f"parent {name}: {leaf} delta {worst:.3g} apart")

    val = SyntheticDAVIS(1, (H, W), train=False, seed=SEED,
                         transform=Compose([Resize((H, W)), ToArray()]))[0]
    val_loss = trainer_k.val_loss(val["image"][None], val["gt"][None])
    say(f"[parent] val loss of one {H}x{W} val frame: {val_loss:.2f}")
    check(np.isfinite(val_loss) and val_loss > 0, "val loss")

    zero_counts(k)
    trainer_f, losses_f = run("flat", indexed[:PT_FLAT_CALLS])
    flat_counts = read_counts(k)
    want = expected_counts("flat", PT_FLAT_CALLS, stages, PT_OUTPUTS)
    say(f"[parent] flat run, {PT_FLAT_CALLS} calls: launches {flat_counts}, "
        f"expected {want}")
    check(flat_counts == want, f"parent flat launch counts {flat_counts}")
    flat_vs_fast(state0, (losses_f, trainer_f.params),
                 (losses_k[:PT_FLAT_CALLS], snaps["fast2"]), tag="[parent]")
    return cfg, state0, calls, counts


def vis_net_phase(device, k, card) -> None:
    """``--vis_net`` at full width, in fast and in flat mode: the parent
    CLI (``VIS_ARGS --vis_net``) writes a ``net.dot`` that is a digraph,
    names every parameter leaf with its shape, has PT_OUTPUTS output nodes
    and names the mode's kernel Functions, then trains; ``make_dot`` of
    the same model called directly draws the same DOT with exactly the
    launches of one train-mode forward."""
    from osvos_torch.cli import train_parent
    from osvos_torch.configs import ModelConfig
    from osvos_torch.models import OSVOS, init_osvos_params
    from osvos_torch.utils.visualize import make_dot

    for mode in ("fast", "flat"):
        cfg = ModelConfig(compute_mode=mode)
        with tempfile.TemporaryDirectory() as tmp:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = train_parent.main(VIS_ARGS + ["--vis_net", "--compute_mode",
                                                   mode, "--save_root", tmp])
            secs = time.perf_counter() - t0
            for line in out.getvalue().splitlines():
                say(f"[vis_net {mode}] cli: {line}")
            path = os.path.join(tmp, "net.dot")
            check(rc == 0 and f"net graph -> {path}\n" in out.getvalue()
                  and "[epoch 0] loss=" in out.getvalue(),
                  f"--vis_net {mode}: the CLI did not draw and train")
            with open(path) as f:
                dot = f.read()
        say(f"[vis_net {mode}] the CLI drew, wrote net.dot and trained "
            f"{VIS_ARGS} in {secs:.2f} s")

        model = OSVOS(cfg)
        model.load_state_dict(init_osvos_params(cfg, torch.Generator()
                                                .manual_seed(SEED)))
        model.to(device)
        x = torch.zeros(VIS_SHAPE, device=device)
        torch.cuda.synchronize()
        zero_counts(k)
        t0 = time.perf_counter()
        direct = make_dot(model, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts(k)
        want = forward_counts(mode, cfg.stages)
        leaves = [f'label="{name}\\n{tuple(p.shape)}"'
                  for name, p in model.named_parameters()]
        missing = [leaf for leaf in leaves if leaf not in dot]
        functions = [f for f in VIS_FUNCTIONS[mode] if f'label="{f}"' not in dot]
        n_nodes = len(re.findall(r'^  \w+ \[label=', dot, re.M))
        n_edges = len(re.findall(r'^  \w+ -> \w+;$', dot, re.M))
        n_out = dot.count('label="output ')
        say(f"[vis_net {mode}] net.dot: {n_nodes} nodes, {n_edges} edges, "
            f"{len(leaves) - len(missing)} of {len(leaves)} parameter leaves "
            f"named with their shapes, {n_out} outputs; make_dot of the same "
            f"model at {VIS_SHAPE} in {wall_ms:.1f} ms wall (forward and "
            f"walk), launches {counts}, expected {want} | {card}")
        check(dot.startswith("digraph") and dot.endswith("}"),
              f"--vis_net {mode}: net.dot is not a digraph")
        check(not missing, f"--vis_net {mode}: leaves not named {missing}")
        check(n_out == PT_OUTPUTS,
              f"--vis_net {mode}: {n_out} output nodes, not {PT_OUTPUTS}")
        check(not functions, f"--vis_net {mode}: no {functions} in net.dot")
        check(direct == dot, f"--vis_net {mode}: make_dot of the same model "
              "drew another graph than the CLI's")
        check(counts == want, f"--vis_net {mode}: draw launches {counts}")


def online_cli_phase(device, k, card):
    """The online entry point, ``cli/train_online.main``, in this process
    with its defaults (flat fine-tune, host pool of 100, 'xla' loss, fast
    inference) and ``--steps FT_STEPS --eval --vis_res`` on a synthetic
    DAVIS tree of one 12-frame 480x854 sequence, from a random parent:
    exact launch counts, the tuned weights and losses bit for bit against
    ``build_host_pool`` + ``run_online`` called directly, the files it
    writes, the J/F line and the phase times. Returns the launch counts."""
    from osvos_torch.cli import train_online
    from osvos_torch.configs import ModelConfig, OnlineConfig
    from osvos_torch.data.davis import DAVIS2016
    from osvos_torch.data.image_io import imread
    from osvos_torch.data.synthetic import generate
    from osvos_torch.models import init_osvos_params
    from osvos_torch.train.online import build_host_pool, run_online
    from osvos_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    tag = "[online-cli]"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        db_root = generate(os.path.join(tmp, "davis"), height=H, width=W,
                           n_frames=CLI_FRAMES, train_seqs=[], val_seqs=[CLI_SEQ])
        gen_s = time.perf_counter() - t0
        ds = DAVIS2016(train=False, db_root_dir=db_root, seq_name=CLI_SEQ)
        fast = ModelConfig()
        # The reference init as it is: with the fuse weights spread (as the
        # serving phase does) the default lr's steps diverge at 480x854.
        parent = save_checkpoint(os.path.join(tmp, "parent.pt"), init_osvos_params(
            fast, torch.Generator().manual_seed(SEED)))
        save_root = os.path.join(tmp, "runs")
        argv = ["--db_root", db_root, "--parent", parent, "--seq_name", CLI_SEQ,
                "--steps", str(FT_STEPS), "--eval", "--vis_res",
                "--save_root", save_root]
        say(f"{tag} wrote {CLI_FRAMES} JPEG frames {H}x{W} and PNG masks in "
            f"DAVIS's layout in {gen_s:.2f} s; random parent; python -m osvos_torch.cli.train_online "
            f"{' '.join(argv)}")
        out = io.StringIO()
        zero_counts(k)
        k["fused_head"].launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = train_online.main(argv)
        finally:
            for line in out.getvalue().splitlines():
                say(f"{tag} | {line}")
        cli_s = time.perf_counter() - t0
        counts = read_counts(k)
        tail = k["fused_head"].launches
        stages = fast.stages
        sides = len(stages) - 1
        batches = -(-CLI_FRAMES // BATCH)
        want = expected_counts("flat", FT_STEPS, stages, loss_kernels=False)
        want["max_pool_fwd"] = sides * batches  # fast inference
        say(f"{tag} main() returned {rc} in {cli_s:.2f} s; launches {counts}, "
            f"fused_head {tail}; expected {want}, fused_head {batches}")
        check(rc == 0, f"the online CLI returned {rc}")
        check(counts == want and tail == batches,
              f"online CLI launch counts {counts} (fused_head {tail}), expected {want}")

        results = os.path.join(save_root, "Results", CLI_SEQ)
        overlays = os.path.join(save_root, "Overlays", CLI_SEQ)
        names = [f"{i:05d}.png" for i in range(CLI_FRAMES)]
        check(sorted(os.listdir(results)) == names, "Results PNGs")
        check(sorted(os.listdir(overlays)) == names, "Overlays PNGs")
        maps = [imread(os.path.join(results, f), gray=True) for f in names]
        shown = [imread(os.path.join(overlays, f)) for f in names]
        check(all(m.shape == (H, W) and m.dtype == np.uint8 for m in maps)
              and all(s.shape == (H, W, 3) for s in shown), "PNG shapes")
        with open(os.path.join(save_root, "logs", CLI_SEQ, "scalars.jsonl")) as f:
            logged = [json.loads(line)["value"] for line in f]
        check(len(logged) == FT_STEPS and all(np.isfinite(logged)), "scalars")
        text = out.getvalue()
        jf = re.search(rf"\[{CLI_SEQ}\] J=([0-9.]+) F=([0-9.]+)", text)
        check(jf is not None, "no J/F line")
        times = {name: float(re.search(rf"\[{CLI_SEQ}\] time {name}: ([0-9.]+) s",
                                       text).group(1)) for name in CLI_PHASES}
        say(f"{tag} {CLI_FRAMES} readable PNGs and overlays, {len(logged)} "
            f"scalars; J={jf.group(1)} F={jf.group(2)}; {len(set(np.unique(maps[0])))} "
            f"distinct codes in frame 0's map; phases {times} | {card}")

        a = train_online.parse_args(argv)
        ocfg = OnlineConfig(seq_name=CLI_SEQ, n_steps=a.steps, n_ave_grad=a.n_ave_grad,
                            lr=a.lr, weight_decay=a.weight_decay,
                            momentum=a.momentum, seed=a.seed, loss_impl=a.loss_impl)
        flat = ModelConfig(compute_mode=a.compute_mode)
        img, gt = ds.make_img_gt_pair(0)
        pool = build_host_pool(img, gt[..., None], ocfg, FT_POOL, seed=ocfg.seed)
        direct = run_online(load_checkpoint(parent, flat), img, gt[..., None], flat,
                            ocfg, device=device, pool=pool)
        tuned = load_checkpoint(os.path.join(save_root, "models",
                                             f"{CLI_SEQ}_online.pt"), flat)
        same = [key for key in tuned if torch.equal(tuned[key], direct.params[key].cpu())]
        direct_losses = direct.losses.cpu().tolist()
        say(f"{tag} direct build_host_pool + run_online, same seed: "
            f"{len(same)} of {len(tuned)} tuned tensors bit for bit, losses "
            f"{'bit for bit' if direct_losses == logged else 'differ'}: {logged}")
        check(len(same) == len(tuned), "the CLI's tuned weights differ from a "
              "direct run_online")
        check(direct_losses == logged, "the CLI's losses differ from a direct run_online")
        frames = [ds.make_img_gt_pair(i)[0] for i in range(len(ds))]
        counts["int8 CLI I1"] = int8_cli_run(
            device, k, db_root, frames, os.path.join(tmp, "runs_int8"), card)
    return counts


def int8_cli_run(device, k, db_root, frames, save_root, card) -> None:
    """The online entry point from the JAX package's ``.ckpt`` of a --tiny
    parent with int8 inference (``--tiny --infer_mode int8 --aug_mode
    per_step``), on the first run's tree: I1's and B1's launches exact,
    the phase lines, and the PNGs bit for bit against
    ``calibrate_int8_scales`` and ``infer_sequence`` on the tuned weights,
    called directly."""
    import dataclasses

    from osvos_torch.cli import train_online
    from osvos_torch.configs import ModelConfig
    from osvos_torch.data.image_io import imread
    from osvos_torch.evaluation.infer import infer_sequence
    from osvos_torch.models import OSVOS, stage_conv_names
    from osvos_torch.models.quantize import calibrate_int8_scales
    from osvos_torch.utils.checkpoint import load_checkpoint

    tag = "[online-cli int8]"
    argv = ["--db_root", db_root, "--parent", os.path.join(ROOT, CKPT_FIXTURE),
            "--tiny", "--seq_name", CLI_SEQ, "--steps", str(CLI2_STEPS),
            "--infer_mode", "int8", "--aug_mode", "per_step",
            "--save_root", save_root]
    say(f"{tag} python -m osvos_torch.cli.train_online {' '.join(argv)} "
        f"(flat fine-tune at the --tiny widths)")
    out = io.StringIO()
    zero_counts(k)
    k["fused_head"].launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = train_online.main(argv)
    finally:
        for line in out.getvalue().splitlines():
            say(f"{tag} | {line}")
    secs = time.perf_counter() - t0
    counts = read_counts(k)
    tail = k["fused_head"].launches
    cfg = ModelConfig(stages=train_online.TINY_STAGES, side_channels=8,
                      compute_mode="int8")
    batches = -(-len(frames) // BATCH)
    i1 = (len(stage_conv_names(cfg.stages)) - 1) * batches
    say(f"{tag} main() returned {rc} in {secs:.2f} s; launches {counts}, "
        f"fused_head {tail}; expected I1 {i1}, fused_head {batches}")
    check(rc == 0, f"the int8 online CLI returned {rc}")
    check(counts["int8_conv3x3 (I1)"] == i1 and tail == batches
          and counts["int8_conv3x3_q (I1 hopper)"] == 0,
          f"int8 CLI: I1 {counts['int8_conv3x3 (I1)']} (the --tiny widths "
          f"take the mma path), Hopper path "
          f"{counts['int8_conv3x3_q (I1 hopper)']}, fused_head {tail}")
    text = out.getvalue()
    check(re.search(rf"\[{CLI_SEQ}\] fine-tune .* inference \[int8\]", text)
          is not None, "no int8 inference line")
    check(re.search(rf"\[{CLI_SEQ}\] time int8 calibration: [0-9.]+ s", text)
          is not None, "no int8 calibration line")
    tuned = load_checkpoint(os.path.join(save_root, "models",
                                         f"{CLI_SEQ}_online.pt"), cfg)
    model = OSVOS(dataclasses.replace(cfg, int8_scales=calibrate_int8_scales(
        tuned, frames[0][None], cfg)))
    model.load_state_dict(tuned)
    want = infer_sequence(model.to(device).eval(), frames)
    got = [imread(os.path.join(save_root, "Results", CLI_SEQ, f"{i:05d}.png"),
                  gray=True) for i in range(len(frames))]
    same = sum(np.array_equal(g, w) for g, w in zip(got, want))
    say(f"{tag} {same} of {len(frames)} PNGs bit for bit against a direct "
        f"calibrate_int8_scales + infer_sequence on the tuned weights; "
        f"{len(np.unique(np.stack(got)))} distinct codes | {card}")
    check(same == len(frames), "the int8 CLI's maps differ from a direct run")
    return counts["int8_conv3x3 (I1)"]


def sync_s(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def parallel_phase(device, k, card, pt_cfg, pt_state0, pt_calls) -> None:
    """``parallel/`` at full width: the rounds against ``run_online``, bit
    for bit with exact launch counts; ``batched_infer`` (fast, then int8 on
    ``calibrate_int8_scales_batched``) against ``infer_sequence`` per
    sequence; a one-rank NCCL group's data-parallel parent calls and
    frame-parallel inference bit for bit against no mesh; the gloo ranks
    of ``parallel/dryrun.py`` on the host's CPU; the batched online CLI."""
    import dataclasses

    import torch.distributed as dist

    from osvos_torch.configs import ModelConfig, OnlineConfig
    from osvos_torch.data.synthetic import image_like
    from osvos_torch.evaluation.infer import infer_sequence, make_infer_fn
    from osvos_torch.models import OSVOS, init_osvos_params, stage_conv_names
    from osvos_torch.models.quantize import (calibrate_int8_scales,
                                             calibrate_int8_scales_batched)
    from osvos_torch.models.surgery import spread_head
    from osvos_torch.parallel.batched_online import (batched_fine_tune,
                                                     batched_infer,
                                                     stack_param_list,
                                                     unstack_params)
    from osvos_torch.parallel.dryrun import dryrun_multichip
    from osvos_torch.parallel.mesh import make_mesh
    from osvos_torch.train.online import build_host_pool, make_draws, run_online
    from osvos_torch.train.parent import ParentTrainer

    tag = "[batched]"
    t_phase = time.perf_counter()
    fast = ModelConfig(compute_mode="fast")
    flat = ModelConfig(compute_mode="flat")
    stages = fast.stages
    state0 = init_osvos_params(fast, torch.Generator().manual_seed(SEED))
    imgs = image_like(BT_SEQS, H, W, seed0=SEED + 100)
    blob = blob_mask(H, W)
    masks = np.stack([np.roll(blob, 40 * i, axis=1)[..., None]
                      for i in range(BT_SEQS)])
    ocfg = OnlineConfig(n_steps=FT_STEPS, loss_impl="pallas")

    # 1. the rounds (mesh=None: serial on this card) against run_online
    zero_counts(k)
    t0 = time.perf_counter()
    tuned, losses = batched_fine_tune(state0, imgs, masks, flat, ocfg,
                                      pool_size=BT_POOL, device=device)
    rounds_s = sync_s(t0)
    counts = read_counts(k)
    want = expected_counts("flat", FT_STEPS * BT_SEQS, stages)
    say(f"{tag} batched_fine_tune: {BT_SEQS} sequences x {FT_STEPS} flat steps "
        f"at {H}x{W} (batch {ocfg.n_ave_grad}, pool {BT_POOL}, "
        f"loss_impl='pallas', mesh=None) in {rounds_s:.2f} s with the pool "
        f"builds; launches {counts}, expected {want} | {card}")
    check(counts == want, f"rounds launch counts {counts}, expected {want}")
    check(tuple(losses.shape) == (BT_SEQS, FT_STEPS)
          and bool(torch.isfinite(losses).all()), "rounds' losses")
    serial_s = 0.0
    for i in range(BT_SEQS):
        pool = build_host_pool(imgs[i], masks[i], ocfg, BT_POOL, seed=ocfg.seed + i)
        pool = tuple(torch.from_numpy(p).to(torch.bfloat16).float().numpy()
                     for p in pool)  # the rounds keep pools in bf16
        draws = make_draws(ocfg, "pool", ocfg.n_steps, BT_POOL,
                           torch.Generator().manual_seed(ocfg.seed + i))
        t0 = time.perf_counter()
        direct = run_online(state0, imgs[i], masks[i], flat, ocfg,
                            device=device, pool=pool, draws=draws)
        serial_s += sync_s(t0)
        same = [key for key, v in direct.params.items()
                if torch.equal(tuned[key][i], v)]
        say(f"{tag} sequence {i} against run_online (bf16 pool seeded "
            f"{ocfg.seed + i}, draws seeded {ocfg.seed + i}): {len(same)} of "
            f"{len(direct.params)} tensors bit for bit, losses "
            f"{losses[i].tolist()} vs {direct.losses.tolist()}")
        check(len(same) == len(direct.params)
              and torch.equal(losses[i], direct.losses),
              f"rounds sequence {i} differs from run_online")
    check(not torch.equal(losses[0], losses[1]), "the sequences drew alike")
    say(f"{tag} {BT_SEQS} sequences fine-tuned in {rounds_s:.2f}s "
        f"({rounds_s / BT_SEQS:.2f}s/seq amortized, pools built inside); "
        f"run_online steps alone {serial_s / BT_SEQS:.2f} s/seq | {card}")

    # 2. batched inference against the per-sequence path: ragged 4 and 6
    # frames, the budget one of 4-frame chunks (infer_sequence's batch)
    lists = [list(image_like(n, H, W, seed0=SEED + 200 + 10 * i))
             for i, n in enumerate(BT_FRAMES)]
    spread = []
    with torch.no_grad():
        for i in range(BT_SEQS):
            model = OSVOS(fast).to(device).eval()
            model.load_state_dict(unstack_params(tuned, i))
            spread_head(model, torch.from_numpy(lists[i][0][None]).to(device))
            spread.append(model.state_dict())
    stacked = stack_param_list(spread)
    per_frame = H * W * (3 * 4 + 320)
    budget = (BT_SEQS * BATCH + 1) * per_frame
    n_calls = BT_SEQS * -(-max(BT_FRAMES) // BATCH)
    int8 = dataclasses.replace(fast, compute_mode="int8")
    firsts = np.stack([f[0] for f in lists])
    for mode, cfg in (("fast", fast), ("int8", int8)):
        scales = None
        if mode == "int8":
            scales = calibrate_int8_scales_batched(stacked, firsts, int8)
        zero_counts(k)
        k["fused_head"].launches = 0
        t0 = time.perf_counter()
        maps = batched_infer(stacked, lists, cfg, act_scales=scales,
                             hbm_budget_bytes=budget, device=device)
        infer_s = sync_s(t0)
        counts, tail = read_counts(k), k["fused_head"].launches
        i1 = counts["int8_conv3x3_q (I1 hopper)"]
        want_i1 = (len(stage_conv_names(stages)) - 1) * n_calls \
            if mode == "int8" else 0
        say(f"{tag} batched_infer [{mode}] on ragged {BT_FRAMES} frames, "
            f"budget {budget} B ({BATCH}-frame calls): {infer_s:.2f} s; "
            f"fused_head {tail}, I1 hopper {i1}, I1 mma "
            f"{counts['int8_conv3x3 (I1)']}, pool fwd {counts['max_pool_fwd']} "
            f"(expected {n_calls}, {want_i1}, 0, {4 * n_calls})")
        check(tail == n_calls and i1 == want_i1
              and counts["int8_conv3x3 (I1)"] == 0
              and counts["max_pool_fwd"] == (len(stages) - 1) * n_calls,
              f"batched_infer [{mode}] launch counts")
        for i, frames in enumerate(lists):
            model = OSVOS(cfg).to(device).eval()
            model.load_state_dict(spread[i])
            infer = make_infer_fn(cfg)
            given = None if scales is None else scales[i]
            want = infer_sequence(model, frames, batch_size=BATCH,
                                  infer_fn=lambda m, x: infer(m, x, given))
            same = sum(np.array_equal(maps[i, t], w) for t, w in enumerate(want))
            say(f"{tag} [{mode}] sequence {i}: {same} of {len(frames)} maps bit "
                f"for bit against infer_sequence{'' if given is None else ' with its act_scales row'}; "
                f"{len(np.unique(maps[i, :len(frames)]))} distinct codes")
            check(same == len(frames), f"batched_infer [{mode}] sequence {i}")
            if mode != "int8":
                continue
            # the rows are calibrate_int8_scales' maxes times float32(1.05)
            single = calibrate_int8_scales(spread[i], frames[0][None], int8, 1.0)
            row = np.float32(single) * np.float32(1.05)
            check(np.array_equal(scales[i].cpu().numpy(), row),
                  f"act_scales row {i} against calibrate_int8_scales")
            # calibrate_int8_scales + a static model: its scales divide by
            # 127 in float64, act_scales in float32 (as in the JAX package)
            static = OSVOS(dataclasses.replace(int8, int8_scales=calibrate_int8_scales(
                spread[i], frames[0][None], int8))).to(device).eval()
            static.load_state_dict(spread[i])
            ref = np.stack(infer_sequence(static, frames, batch_size=BATCH))
            got = maps[i, :len(frames)]
            codes = float(np.mean(ref == got))
            agree = float(np.mean((ref >= 128) == (got >= 128)))
            say(f"{tag} [int8] sequence {i} against calibrate_int8_scales + "
                f"infer_sequence (static scales): {codes:.6f} of the codes "
                f"equal ({'bit for bit' if codes == 1.0 else 'not bit for bit'}), "
                f"0.5 masks agree on {agree:.6f}")
            check(agree >= INT8_MIN_AGREE, f"int8 sequence {i}: masks agree on {agree}")

    # 3. one NCCL rank: data-parallel parent calls and frame-parallel
    # inference against the same without a mesh
    tmp = tempfile.mkdtemp()
    nccl = device.type == "cuda"
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method=f"file://{tmp}/rendezvous", rank=0,
                            world_size=1, device_id=device if nccl else None)
    try:
        runs = {}
        for name, mesh in (("no mesh", None),
                           ("mesh", make_mesh("data", 1, device.type))):
            trainer = ParentTrainer(pt_state0, fast, pt_cfg, device=device,
                                    mesh=mesh)
            zero_counts(k)
            ms, totals = [], []
            for img, gt, side_w in pt_calls[:BT_DP_CALLS]:
                t0 = time.perf_counter()
                totals.append(trainer.train_step(img, gt, side_w)["total"])
                ms.append(1e3 * sync_s(t0))
            runs[name] = (trainer.params, torch.stack(totals), ms,
                          read_counts(k))
        want = expected_counts("fast", BT_DP_CALLS, stages, PT_OUTPUTS)
        (p0, l0, ms0, c0), (p1, l1, ms1, c1) = runs["no mesh"], runs["mesh"]
        same = [key for key in p0 if torch.equal(p0[key], p1[key])]
        moved = [key for key in p0 if not torch.equal(p0[key], pt_state0[key].to(device))]
        say(f"{tag} [dp] ParentTrainer(mesh=make_mesh('data', 1)), one NCCL "
            f"rank, {BT_DP_CALLS} fast calls of batch {pt_cfg.batch_size} at "
            f"{H}x{W} (n_ave_grad {pt_cfg.n_ave_grad}): {len(same)} of "
            f"{len(p0)} tensors bit for bit against no mesh ({len(moved)} "
            f"moved), losses {l1.tolist()} vs {l0.tolist()}; ms per call "
            f"{[round(t, 2) for t in ms1]} vs {[round(t, 2) for t in ms0]}; "
            f"launches {c1} | {card}")
        check(len(same) == len(p0) and torch.equal(l0, l1) and moved,
              "one-rank data parallel differs from no mesh")
        check(c0 == c1 == want, f"[dp] launch counts {c1}, expected {want}")
        model = OSVOS(fast).to(device).eval()
        model.load_state_dict(spread[1])
        frames = lists[1]
        t0 = time.perf_counter()
        want_maps = infer_sequence(model, frames, batch_size=BATCH)
        plain_s = sync_s(t0)
        t0 = time.perf_counter()
        got_maps = infer_sequence(model, frames, batch_size=BATCH,
                                  mesh=make_mesh("data", 1, device.type))
        mesh_s = sync_s(t0)
        same = sum(np.array_equal(g, w) for g, w in zip(got_maps, want_maps))
        say(f"{tag} [frame-parallel] infer_sequence(mesh=make_mesh('data', 1)) "
            f"of {len(frames)} frames: {same} maps bit for bit against no mesh; "
            f"{mesh_s:.3f} s vs {plain_s:.3f} s | {card}")
        check(same == len(frames), "frame-parallel inference differs")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    # 4. the multi-rank paths, on gloo ranks of the host's CPU
    t0 = time.perf_counter()
    reports = dryrun_multichip(2)
    say(f"{tag} [dp] [frame-parallel] dryrun_multichip(2) on 2 gloo ranks "
        f"(CPU, tiny widths): data parallel, rounds over 3 sequences and "
        f"frame-parallel inference held against one rank in "
        f"{time.perf_counter() - t0:.2f} s; rounds' losses "
        f"{reports[0]['rounds']['losses'].tolist()}")

    # 5. the batched online CLI
    cli_batched(device, k, card)
    say(f"{tag} phase 9b passed in {time.perf_counter() - t_phase:.1f} s | {card}")


@contextlib.contextmanager
def halved_gradient(seq: int):
    """The control of packed against the rounds: ``PackedOSVOS`` passes
    sequence ``seq``'s logits on unchanged but halves their gradient, the
    fault of a loss meaned over the S * N rows, on one sequence."""
    from osvos_torch.parallel.packed import PackedOSVOS

    forward = PackedOSVOS.forward

    def halved(self, x):
        out = forward(self, x)
        keep = torch.ones(out.shape[-1], device=out.device)
        keep[seq] = 0.5
        return out * keep + out.detach() * (1 - keep)

    PackedOSVOS.forward = halved
    try:
        yield
    finally:
        PackedOSVOS.forward = forward


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the runs held bit for bit."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


@contextlib.contextmanager
def rounds_b2_forward():
    """The rounds' lone fast model with each trunk conv after the stem run
    as the packed trunk runs it, B2-seq over one sequence
    (``conv3x3_bias_relu_seq`` with the weight as a stack of one), so that
    the rounds' forward sums as the packed schedule's does; the rest of the
    rounds (the stem, sides, loss, the backward's kernels, the optimizer)
    is unchanged. The reference that holds the packed schedule to the
    rounds with one forward kernel on both sides."""
    from osvos_torch.models.vgg_osvos import OSVOS
    from osvos_torch.ops.fastconv import conv3x3_bias_relu_seq

    saved = OSVOS._trunk_conv

    def trunk_conv(self, x, name, idx, act_scales, maxes=None):
        if not (self._fast_vjp and idx > 0):
            return saved(self, x, name, idx, act_scales, maxes)
        conv = getattr(self, name)
        return conv3x3_bias_relu_seq(x, conv.weight[None], conv.bias.to(x.dtype))

    OSVOS._trunk_conv = trunk_conv
    try:
        yield
    finally:
        OSVOS._trunk_conv = saved


def check_fwd_seq(device, flatconv, stages, s) -> float:
    """B2-seq (``conv_fwd_seq``) at the 12 trunk convs after the stem of a
    full-width fast step over ``s`` sequences: each sequence's output bit
    for bit the lone launch (S = 1) on its slice, within one bf16 ulp of the
    conv and one of the sum of the plain version, one launch counted in
    ``seq_fwd_launches``, ``hopper_launches`` and ``pack_launches``.
    Returns the largest |kernel - plain| over the plain version's max."""
    worst = 0.0
    convs = trunk_conv_shapes(stages, FT_BATCH, H, W)
    for i, (name, n, h, w, c, d) in enumerate(convs[1:]):
        x = bf16_randn((n, h, w, s * c), device, SEED + 1200 + i, relu=True)
        gen = torch.Generator(device=device).manual_seed(SEED + 1250 + i)
        weight = torch.randn(s, d, c, 3, 3, device=device, generator=gen) * (9 * c) ** -0.5
        bias = (torch.randn(s * d, device=device, generator=gen) * 0.1).to(torch.bfloat16)
        before = (flatconv.seq_fwd_launches, flatconv.hopper_launches,
                  flatconv.pack_launches)
        y = flatconv.conv_fwd_seq(x, weight, bias)
        torch.cuda.synchronize()
        took = (flatconv.seq_fwd_launches - before[0],
                flatconv.hopper_launches - before[1], flatconv.pack_launches - before[2])
        same = [torch.equal(y[..., j * d:(j + 1) * d], flatconv.conv_fwd_seq(
            x[..., j * c:(j + 1) * c].contiguous(), weight[j:j + 1],
            bias[j * d:(j + 1) * d])) for j in range(s)]
        want = flatconv.conv_fwd_seq_ref(x, weight, bias).float()
        conv = torch.cat([flatconv.conv3x3_f32(x[..., j * c:(j + 1) * c], weight[j])
                          for j in range(s)], dim=-1).to(torch.bfloat16).float()
        diff = (y.float() - want).abs()
        scale = float(want.abs().max())
        ok = not bool((diff > (conv.abs() + want.abs()) * 2.0 ** -7
                       + scale * 2.0 ** -16).any())
        rel = float(diff.max()) / scale
        say(f"[packed] [kernel] conv_fwd_seq S = {s} {name} x({n},{h},{w},{s}x{c}) "
            f"-> {s}x{d}: each sequence bit "
            f"for bit a lone launch {same}; max |kernel - plain| {rel:.3g} of "
            f"the max, within two roundings {ok}; launches (seq, hopper, pack) {took}")
        check(all(same), f"conv_fwd_seq S = {s} {name}: not the lone launches")
        check(ok, f"conv_fwd_seq S = {s} {name}: past two roundings of the plain version")
        check(took == (1, 1, 1), f"conv_fwd_seq S = {s} {name}: launches {took}")
        worst = max(worst, rel)
        del x, y, want, conv, diff
    return worst


def check_seq_kernels(device, k, stages) -> dict:
    """The sequence-batched B17 and B16 against lone launches: at the 12
    trunk convs after the stem and at the stem of a full-width fast step
    (batch FT_BATCH at 480x854) and at the --tiny widths, at each S of
    PK_KERNEL_SEQS, and B16 at STEM_SEQ_ODD: each sequence's result bit for
    bit a lone launch on its contiguous slice, within the lone rows' bounds
    of the plain version (dK 1e-4 of max|dK|, db 1e-5 of the column sums of
    |g|), one launch counted in ``seq_launches`` on the lone shape's path.
    Returns the largest |kernel - plain| of dK of each at S = PK_SEQS."""
    wgrad, stem_wgrad = k["wgrad"], k["stem_wgrad"]
    worst = {"wgrad3x3_seq": 0.0, "stem_wgrad_seq": 0.0, "conv_fwd_seq": 0.0}
    for s in PK_KERNEL_SEQS:
        rel = check_fwd_seq(device, k["flatconv"], stages, s)
        if s == PK_SEQS:
            worst["conv_fwd_seq"] = rel
        for label, widths in (("full", stages), ("tiny", TINY_STAGES)):
            convs = trunk_conv_shapes(widths, FT_BATCH, H, W)
            for i, (name, n, h, w, c, d) in enumerate(convs[1:]):
                x = bf16_randn((n, h, w, s * c), device, SEED + 900 + i, relu=True)
                g = bf16_randn((n, h, w, s * d), device, SEED + 950 + i)
                path = wgrad.plan(n, h, w, c, d).path
                before = (wgrad.seq_launches, wgrad.tma_launches, wgrad.wmma_launches)
                got = wgrad.wgrad3x3_seq(x, g, s)
                torch.cuda.synchronize()
                took = (wgrad.seq_launches - before[0], wgrad.tma_launches - before[1],
                        wgrad.wmma_launches - before[2])
                same = [torch.equal(got[j], wgrad.wgrad3x3(
                    x[..., j * c:(j + 1) * c].contiguous(),
                    g[..., j * d:(j + 1) * d].contiguous())) for j in range(s)]
                want = wgrad.wgrad3x3_seq_ref(x, g, s)
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                say(f"[packed] [kernel] wgrad3x3_seq S = {s} {label} {name} "
                    f"x({n},{h},{w},{s}x{c}) g(..,{s}x{d}): {path} path; each "
                    f"sequence bit for bit a lone launch {same}; max |kernel - "
                    f"plain| {err:.4g} = {rel:.3g} of max|dK|")
                check(all(same), f"wgrad3x3_seq S = {s} {label} {name}: not the "
                      f"lone launches")
                check(rel <= 1e-4, f"wgrad3x3_seq S = {s} {label} {name}: "
                      f"{rel:.3g} of max|dK|")
                check(took == ((1, 1, 0) if path == "tma" else (1, 0, 1)),
                      f"wgrad3x3_seq S = {s} {label} {name}: launches (seq, tma, "
                      f"wmma) {took}")
                if s == PK_SEQS:
                    worst["wgrad3x3_seq"] = max(worst["wgrad3x3_seq"], err)
                del x, g, got, want
            stem = [(FT_BATCH, H, W, 3, widths[0][0])]
            for j, (n, h, w, c, d) in enumerate(
                    stem + (STEM_SEQ_ODD if label == "tiny" else [])):
                x, g = stem_inputs(device, (n, h, w, s * c, s * d), SEED + 990 + j)
                tma = stem_wgrad.tma_plan(n, h, w, c, d) is not None
                before = (stem_wgrad.seq_launches, stem_wgrad.tma_launches,
                          stem_wgrad.mma_launches)
                dk, db = stem_wgrad.stem_wgrad_seq(x, g, s)
                torch.cuda.synchronize()
                took = (stem_wgrad.seq_launches - before[0],
                        stem_wgrad.tma_launches - before[1],
                        stem_wgrad.mma_launches - before[2])
                want_dk, want_db = stem_wgrad.stem_wgrad_seq_ref(x, g, s)
                same, rel, db_rel = [], 0.0, 0.0
                for q in range(s):
                    gq = g[..., q * d:(q + 1) * d].contiguous()
                    lone = stem_wgrad.stem_wgrad(x[..., q * c:(q + 1) * c].contiguous(), gq)
                    same.append(torch.equal(dk[q], lone[0]) and torch.equal(db[q], lone[1]))
                    rel = max(rel, float((dk[q] - want_dk[q]).abs().max())
                              / float(want_dk[q].abs().max()))
                    db_rel = max(db_rel, float((db[q] - want_db[q]).abs().max())
                                 / float(gq.float().abs().sum((0, 1, 2)).max()))
                err = float((dk - want_dk).abs().max())
                say(f"[packed] [kernel] stem_wgrad_seq S = {s} {label} "
                    f"x({n},{h},{w},{s}x{c}) g(..,{s}x{d}): {'tma' if tma else 'mma'} "
                    f"path; each sequence bit for bit a lone launch {same}; dK "
                    f"{rel:.3g} of max|dK|, db {db_rel:.3g} of sum|g|")
                check(all(same), f"stem_wgrad_seq S = {s} {label} {(n, h, w, c, d)}: "
                      f"not the lone launches")
                check(rel <= 1e-4 and db_rel <= 1e-5,
                      f"stem_wgrad_seq S = {s} {label} {(n, h, w, c, d)}: {rel:.3g}, "
                      f"db {db_rel:.3g}")
                check(took == ((1, 1, 0) if tma else (1, 0, 1)),
                      f"stem_wgrad_seq S = {s} {label}: launches (seq, tma, mma) {took}")
                if s == PK_SEQS:
                    worst["stem_wgrad_seq"] = max(worst["stem_wgrad_seq"], err)
                del x, g
    return worst


def kernel_split_ms(fn, names, n: int = 10):
    """ms a call of each device kernel whose name holds one of ``names``,
    from one profiler window of ``n`` calls of ``fn``; None for a name the
    window did not show exactly ``n`` times (late in a run the profiler
    can lose events: then it is not measured)."""
    events, _ = device_events(fn, n)
    out = []
    for name in names:
        times = [us for e, us in events if name in e]
        out.append(sum(times) / n / 1e3 if len(times) == n else None)
    return out


# the device kernels of the sequence launches' two passes
SEQ_PASSES = {"wgrad3x3_seq": ("wgrad_tma_kernel<", "wgrad_tma_reduce_kernel"),
              "stem_wgrad_seq": ("stem_wgrad_tma_kernel<", "stem_wgrad_reduce_kernel")}


def time_seq_kernels(device, k, card, stages, s: int) -> dict:
    """Per kernel at S = ``s``: the sequence launch (queued: CUDA events
    around 20 calls queued back to back, the device's time a call; per
    call: CUDA events around one call) against its S lone launches (the
    rounds' work), the two taken in turns (kernel, lone, lone, kernel;
    queued the mean of the two readings of each), its two passes apart
    (profiler), one grouped ``aten.convolution_backward`` (groups=S; dK, and
    for the stem db), the plain version and the bound, a line for each of
    the 12 trunk convs after the stem and for the stem of a full-width
    step, then their sums."""
    wgrad, stem_wgrad = k["wgrad"], k["stem_wgrad"]
    out = {}
    convs = trunk_conv_shapes(stages, FT_BATCH, H, W)
    for name, shapes in (("wgrad3x3_seq", convs[1:]), ("stem_wgrad_seq", convs[:1])):
        acc = dict(ms=0.0, dev=0.0, lone=0.0, lone_dev=0.0, plain=0.0, lib=0.0,
                   b=0.0, o=0.0, p1=0.0, p2=0.0)
        split_seen = True
        for i, (conv, n, h, w, c, d) in enumerate(shapes):
            x = bf16_randn((n, h, w, s * c), device, SEED + 1000 + i, relu=True)
            g = bf16_randn((n, h, w, s * d), device, SEED + 1050 + i)
            xs = [x[..., j * c:(j + 1) * c].contiguous() for j in range(s)]
            gs = [g[..., j * d:(j + 1) * d].contiguous() for j in range(s)]
            wb = torch.randn(s * d, c, 3, 3, device=device).to(torch.bfloat16)
            xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            stem = name == "stem_wgrad_seq"
            if stem:
                kfn = lambda: stem_wgrad.stem_wgrad_seq(x, g, s)  # noqa: E731
                lone = lambda: [stem_wgrad.stem_wgrad(a, b) for a, b in zip(xs, gs)]  # noqa: E731
                pfn = lambda: stem_wgrad.stem_wgrad_seq_ref(x, g, s)  # noqa: E731
            else:
                kfn = lambda: wgrad.wgrad3x3_seq(x, g, s)  # noqa: E731
                lone = lambda: [wgrad.wgrad3x3(a, b) for a, b in zip(xs, gs)]  # noqa: E731
                pfn = lambda: wgrad.wgrad3x3_seq_ref(x, g, s)  # noqa: E731
            lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
                gn, xn, wb, [s * d] if stem else None, [1, 1], [1, 1], [1, 1],
                False, [0, 0], s, [False, True, stem])
            k_ms, lone_ms = paired_median_ms(kfn, lone, n=20)
            k_q, lone_q = [queued_ms(kfn)], [queued_ms(lone), queued_ms(lone)]
            k_q.append(queued_ms(kfn))
            k_dev, lone_dev = statistics.mean(k_q), statistics.mean(lone_q)
            p1, p2 = kernel_split_ms(kfn, SEQ_PASSES[name])
            l_ms = median_ms(lib, n=20, warmup=3)
            p_ms = median_ms(pfn, n=5, warmup=1)
            px = n * h * w
            t_b = (2 * px * s * (c + d) + 4 * s * (9 * c * d + d * stem)) \
                / HBM_BYTES_PER_S * 1e3
            t_o = 2 * s * (9 * c + stem) * d * px / BF16_OPS_PER_S * 1e3
            t_bound = max(t_b, t_o)
            passes = ("passes not measured" if p1 is None or p2 is None else
                      f"pass 1 {p1:.4f}, pass 2 {p2:.4f} ms device")
            say(f"[packed] [time] {name} S = {s} {conv} ({n},{h},{w},{s}x{c}->"
                f"{s}x{d}): one launch {k_dev:.4f} ms queued ({passes}), "
                f"{k_ms:.4f} per call; {s} lone launches {lone_dev:.4f} queued, "
                f"{lone_ms:.4f} per call (one launch / lone {k_dev / lone_dev:.3f} "
                f"queued); grouped convolution_backward {l_ms:.4f}; plain "
                f"{p_ms:.4f}; bound {t_bound:.4f} ms "
                f"({'bytes' if t_b >= t_o else 'operations'}), "
                f"{t_bound / k_dev:.1%} of it queued | {card}")
            for key, v in (("ms", k_ms), ("lone", lone_ms), ("plain", p_ms),
                           ("lib", l_ms), ("b", t_b), ("o", t_o), ("dev", k_dev),
                           ("lone_dev", lone_dev)):
                acc[key] += v
            if p1 is None or p2 is None:
                split_seen = False
            else:
                acc["p1"] += p1
                acc["p2"] += p2
            del x, g, xs, gs, xn, gn, wb
        acc["bound"], acc["by"] = max(acc["b"], acc["o"]), (
            "bytes" if acc["b"] >= acc["o"] else "operations")
        acc["passes"] = [acc["p1"], acc["p2"]] if split_seen else None
        passes = (f"pass 1 {acc['p1']:.3f}, pass 2 {acc['p2']:.3f} ms device"
                  if split_seen else "passes not measured")
        say(f"[packed] [time] {name}, {len(shapes)} conv(s) of a full-width step "
            f"at S = {s}, summed: one launch {acc['dev']:.3f} ms queued "
            f"({passes}), {acc['ms']:.3f} per call; {s} lone launches "
            f"{acc['lone_dev']:.3f} queued, {acc['lone']:.3f} per call (one "
            f"launch / lone {acc['dev'] / acc['lone_dev']:.3f} queued); grouped "
            f"convolution_backward {acc['lib']:.3f}; plain {acc['plain']:.3f}; "
            f"bound {acc['bound']:.3f} ms ({acc['by']}), "
            f"{acc['bound'] / acc['dev']:.1%} of it queued | {card}")
        out[name] = acc
    return out


def time_fwd_seq(device, k, card, stages, s: int) -> dict:
    """B2-seq (``conv_fwd_seq``) at S = ``s``, queued (CUDA events around 20
    calls queued back to back, the variants in turns, each the mean of its
    two readings), against its S lone launches (S = 1, on contiguous
    slices) and the packed trunk's forward before it, the grouped library
    conv (``groups=S``) + bf16 bias + ReLU, with the grouped conv alone, and
    the bound: a line for each of the 12 trunk convs after the stem of a
    full-width step, then their sums."""
    flatconv = k["flatconv"]
    names = ("B2-seq", f"{s} lone", "grouped+bias+relu", "grouped conv")
    acc = dict.fromkeys(names + ("bound",), 0.0)
    for i, (conv, n, h, w, c, d) in enumerate(trunk_conv_shapes(stages, FT_BATCH, H, W)[1:]):
        x = bf16_randn((n, h, w, s * c), device, SEED + 1300 + i, relu=True)
        weight = torch.randn(s, d, c, 3, 3, device=device) * (9 * c) ** -0.5
        bias = (torch.randn(s * d, device=device) * 0.1).to(torch.bfloat16)
        xs = [x[..., j * c:(j + 1) * c].contiguous() for j in range(s)]
        w16 = weight.to(torch.bfloat16).flatten(0, 1)

        def grouped():
            return F.conv2d(x.permute(0, 3, 1, 2), w16, padding=1,
                            groups=s).permute(0, 2, 3, 1)

        fns = (lambda: flatconv.conv_fwd_seq(x, weight, bias),
               lambda: [flatconv.conv_fwd_seq(xs[j], weight[j:j + 1],
                                              bias[j * d:(j + 1) * d])
                        for j in range(s)],
               lambda: F.relu(grouped() + bias), grouped)
        first = [queued_ms(f) for f in fns]
        second = [queued_ms(f) for f in reversed(fns)][::-1]
        ms = [statistics.mean(p) for p in zip(first, second)]
        px = n * h * w
        bound = max((2 * px * s * (c + d) + 2 * s * 9 * c * d) / HBM_BYTES_PER_S,
                    2 * s * 9 * c * d * px / BF16_OPS_PER_S) * 1e3
        say(f"[packed] [time] conv_fwd_seq S = {s} {conv} ({n},{h},{w},{s}x{c}->"
            f"{s}x{d}), ms queued: " + ", ".join(f"{a} {b:.4f}" for a, b in zip(names, ms))
            + f"; bound {bound:.4f}, {bound / ms[0]:.1%} of it | {card}")
        for key, v in zip(names + ("bound",), ms + [bound]):
            acc[key] += v
        del x, xs, weight, bias, w16
    say(f"[packed] [time] conv_fwd_seq, 12 convs of a full-width step at S = {s}, "
        "summed, ms queued: " + ", ".join(f"{a} {acc[a]:.3f}" for a in names)
        + f"; bound {acc['bound']:.3f}, {acc['bound'] / acc['B2-seq']:.1%} of it "
        f"| {card}")
    return acc


def grouped_against_lone(device, card, stages) -> None:
    """Why packed and the rounds part at S > 1, printed, not checked: at
    the side convs and the trunk convs that change width, cuDNN's grouped
    (groups=PK_SEQS) bf16 forward, d(input) and weight gradient against the
    same calls on each sequence's contiguous slice, and the bias gradient
    (a bf16 sum over the pixels) over S * C channels against each slice's,
    in elements that differ (cuDNN deterministic)."""
    s = PK_SEQS
    convs = trunk_conv_shapes(stages, FT_BATCH, H, W)
    shapes = [(name, n, h, w, c, d) for name, n, h, w, c, d in convs[1:] if c != d]
    shapes += side_conv_shapes(stages, FT_BATCH, H, W)
    with cudnn_deterministic():
        for i, (name, n, h, w, c, d) in enumerate(shapes):
            x = bf16_randn((n, h, w, s * c), device, SEED + 1100 + i, relu=True)
            g = bf16_randn((n, h, w, s * d), device, SEED + 1150 + i)
            wt = (torch.randn(s * d, c, 3, 3, device=device) * (9 * c) ** -0.5).to(torch.bfloat16)

            def ops(xx, gg, ww, groups):
                y = F.conv2d(xx.permute(0, 3, 1, 2), ww, padding=1, groups=groups)
                dx, dk, _ = torch.ops.aten.convolution_backward(
                    gg.permute(0, 3, 1, 2), xx.permute(0, 3, 1, 2), ww, None, [1, 1],
                    [1, 1], [1, 1], False, [0, 0], groups, [True, True, False])
                return y, dx, dk, gg.sum((0, 1, 2))

            grouped = ops(x, g, wt, s)
            diff = [0, 0, 0, 0]
            for q in range(s):
                lone = ops(x[..., q * c:(q + 1) * c].contiguous(),
                           g[..., q * d:(q + 1) * d].contiguous(), wt[q * d:(q + 1) * d], 1)
                parts = (grouped[0][:, q * d:(q + 1) * d], grouped[1][:, q * c:(q + 1) * c],
                         grouped[2][q * d:(q + 1) * d], grouped[3][q * d:(q + 1) * d])
                for j, (a, b) in enumerate(zip(parts, lone)):
                    diff[j] += int((a != b).sum())
            say(f"[packed] [grouped vs lone] {name} ({n},{h},{w},{s}x{c}->{s}x{d}): "
                f"elements that differ: forward {diff[0]} of {grouped[0].numel()}, "
                f"d(input) {diff[1]} of {grouped[1].numel()}, weight gradient "
                f"{diff[2]} of {grouped[2].numel()}, bias gradient {diff[3]} of "
                f"{grouped[3].numel()} | {card}")
            del x, g, grouped, lone


def step_profile(run, steps: int, device):
    """(median ms a step over ``steps`` timed after 2 warm-up, device-busy
    ms a step from a profiled window of 2 steps or None, peak GB). ``run(i)``
    runs step i."""
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for i in range(2 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    events, _ = device_events(lambda: [run(i) for i in range(2)], 1)
    busy = sum(us for _, us in events) / 2 / 1e3 if events else None
    return statistics.median(times[2:]), busy, peak


def time_packed_steps(device, card, state0, frames) -> None:
    """The packed step (fast, batch FT_BATCH at 480x854, loss_impl='pallas')
    at each S of PK_TIMED_SEQS against S times the rounds' step (one
    sequence, ``make_chunk_fn``): host ms a step, the device-busy ms and
    share, and peak memory, each with the pool ``batched_fine_tune`` would
    keep on the card (PK_POOL frames a sequence, capped by
    ``batched_online.pool_cap``; the rounds' pool float32, packed's bf16),
    sequence i's pool frame ``frames[i % len(frames)]``."""
    from osvos_torch.configs import ModelConfig, OnlineConfig
    from osvos_torch.models import OSVOS
    from osvos_torch.parallel.batched_online import pool_cap, stack_param_list
    from osvos_torch.parallel.packed import (PackedOSVOS, draws_steps,
                                             make_packed_chunk_fn, stack_draws)
    from osvos_torch.train.online import (make_chunk_fn, make_draws,
                                          make_online_optimizer)

    mcfg, ocfg = ModelConfig(compute_mode="fast"), OnlineConfig(loss_impl="pallas")
    n_steps = 2 + FT_TIMED
    masks = torch.from_numpy(blob_mask(H, W)).to(device)[..., None]
    images = torch.from_numpy(frames).to(device)

    def pool(s, p, dtype):
        """(S, P, H, W, 3) images and (S, P, H, W, 1) masks of dtype."""
        rows = torch.arange(s, device=device) % images.shape[0]
        return (images[rows, None].expand(s, p, H, W, 3).to(dtype).contiguous(),
                masks.expand(s, p, H, W, 1).to(dtype).contiguous())

    def draws(s, p):
        return [make_draws(ocfg, "pool", n_steps, p,
                           torch.Generator().manual_seed(SEED + i), device)
                for i in range(s)]

    model = OSVOS(mcfg).to(device)
    model.load_state_dict(state0)
    chunk, opt = make_chunk_fn(mcfg, ocfg), make_online_optimizer(model, ocfg)
    one_pool = min(PK_POOL, pool_cap(1, H, W, torch.bfloat16))
    one_imgs, one_masks = (t[0] for t in pool(1, one_pool, torch.float32))
    one_draws = draws(1, one_pool)[0]
    rounds_step = lambda i: chunk(model, opt, one_imgs, one_masks,  # noqa: E731
                                  one_draws.steps(i, i + 1))
    one_ms, one_busy, one_peak = step_profile(rounds_step, FT_TIMED, device)
    profile_groups(lambda: [rounds_step(i) for i in range(2)],
                   "[packed] rounds' step (one sequence), per step of 2", card, 2)
    say(f"[packed] [time] rounds' step (one sequence, fast, batch {FT_BATCH} "
        f"at {H}x{W}, pool {one_pool} float32): {one_ms:.2f} ms host, device busy "
        f"{'not measured' if one_busy is None else f'{one_busy:.2f} ms ({one_busy / one_ms:.1%})'}"
        f"; peak memory {one_peak:.2f} GB | {card}")
    del model, opt, one_imgs, one_masks
    torch.cuda.empty_cache()
    for s in PK_TIMED_SEQS:
        p = min(PK_POOL, pool_cap(s, H, W, torch.bfloat16))
        packed = PackedOSVOS(mcfg, s).to(device).from_stacked(
            stack_param_list([state0] * s))
        pchunk = make_packed_chunk_fn(mcfg, ocfg)
        popt = make_online_optimizer(packed, ocfg)
        stacked = stack_draws(draws(s, p))
        pool_imgs, pool_masks = pool(s, p, torch.bfloat16)
        packed_step = lambda i: pchunk(packed, popt, pool_imgs, pool_masks,  # noqa: E731
                                       draws_steps(stacked, i, i + 1))
        ms, busy, peak = step_profile(packed_step, FT_TIMED, device)
        if s == PK_SEQS:
            profile_groups(lambda: [packed_step(i) for i in range(2)],
                           f"[packed] packed step, S = {s}, per step of 2", card, 2)
        say(f"[packed] [time] packed step, S = {s} (fast, batch {FT_BATCH} at "
            f"{H}x{W}, pool {p} bf16 a sequence{'' if p == PK_POOL else f', capped from {PK_POOL}'}): "
            f"{ms:.2f} ms host against {s} x {one_ms:.2f} = "
            f"{s * one_ms:.2f} ms of rounds' steps ({ms / (s * one_ms):.3f} of "
            f"it; {ms / s:.2f} ms a sequence-step); device busy "
            f"{'not measured' if busy is None else f'{busy:.2f} ms ({busy / ms:.1%})'}"
            f"; peak memory {peak:.2f} GB (rounds' {one_peak:.2f} GB) | {card}")
        del packed, popt, pool_imgs, pool_masks
        torch.cuda.empty_cache()


def packed_phase(device, k, card) -> dict:
    """Phase 9c, the packed schedule at full width (fast, seeded weights,
    batch FT_BATCH): the sequence-batched kernels against lone launches;
    ``batched_fine_tune(schedule='packed')`` against ``schedule='rounds'``
    over one sequence, bit for bit, and over BT_SEQS synthetic sequences
    (FT_STEPS steps, pool BT_POOL, loss_impl='pallas', mesh=None, the same
    bf16 pools and draws; the bounds beside PK_SEQS), with exact launch
    counts; the flat -> fast downgrade and its warning once, bit for bit the
    fast packed run; the timings; the batched CLI in fast mode (packed).
    Returns the kernels' JSON numbers."""
    import dataclasses
    import logging

    from osvos_torch.configs import ModelConfig, OnlineConfig
    from osvos_torch.data.synthetic import image_like
    from osvos_torch.models import init_osvos_params
    from osvos_torch.parallel import batched_online
    from osvos_torch.parallel.batched_online import (batched_fine_tune,
                                                     unstack_params)

    tag = "[packed]"
    t_phase = time.perf_counter()
    fast = ModelConfig(compute_mode="fast")
    errs = check_seq_kernels(device, k, fast.stages)

    state0 = init_osvos_params(fast, torch.Generator().manual_seed(SEED))
    imgs = image_like(BT_SEQS, H, W, seed0=SEED + 300)
    blob = blob_mask(H, W)
    masks = np.stack([np.roll(blob, 60 * i, axis=1)[..., None]
                      for i in range(BT_SEQS)])
    ocfg = OnlineConfig(n_steps=FT_STEPS, loss_impl="pallas")
    kw = dict(pool_size=BT_POOL, device=device)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger(batched_online.__name__)
    logger.addHandler(handler)
    try:
        with cudnn_deterministic():
            zero_counts(k)
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            packed, p_losses = batched_fine_tune(state0, imgs, masks, fast, ocfg,
                                                 schedule="packed", **kw)
            packed_s = sync_s(t0)
            peak = torch.cuda.max_memory_allocated(device) / 1e9
            counts = read_counts(k)
            want = expected_counts("packed", FT_STEPS, fast.stages)
            say(f"{tag} batched_fine_tune(schedule='packed'): {BT_SEQS} sequences "
                f"x {FT_STEPS} fast steps at {H}x{W} (batch {ocfg.n_ave_grad}, pool "
                f"{BT_POOL}, loss_impl='pallas', mesh=None) in {packed_s:.2f} s "
                f"with the pool builds, peak memory {peak:.2f} GB; launches "
                f"{counts}, expected {want} | {card}")
            check(counts == want, f"packed launch counts {counts}, expected {want}")
            zero_counts(k)
            t0 = time.perf_counter()
            rounds, r_losses = batched_fine_tune(state0, imgs, masks, fast, ocfg,
                                                 schedule="rounds", **kw)
            rounds_s = sync_s(t0)
            want_r = expected_counts("fast", FT_STEPS * BT_SEQS, fast.stages)
            check(read_counts(k) == want_r, f"rounds launch counts {read_counts(k)}")
            with rounds_b2_forward():
                rounds_b2, _ = batched_fine_tune(state0, imgs, masks, fast, ocfg,
                                                 schedule="rounds", **kw)
            records.clear()
            flat = dataclasses.replace(fast, compute_mode="flat")
            down, d_losses = batched_fine_tune(state0, imgs, masks, flat, ocfg,
                                               schedule="packed", **kw)
            one = [batched_fine_tune(state0, imgs[:1], masks[:1], fast, ocfg,
                                     schedule=sched, **kw) for sched in ("packed", "rounds")]
            with rounds_b2_forward():
                one_b2 = batched_fine_tune(state0, imgs[:1], masks[:1], fast, ocfg,
                                           schedule="rounds", **kw)
    finally:
        logger.removeHandler(handler)
    (one_p, one_pl), (one_r, one_rl), (one_b, one_bl) = *one, one_b2
    same = [key for key in one_p if torch.equal(one_p[key], one_b[key])]
    say(f"{tag} one sequence, packed against the rounds with B2-seq's forward: "
        f"{len(same)} of {len(one_p)} tensors and the losses "
        f"{'bit for bit' if torch.equal(one_pl, one_bl) else 'NOT bit for bit'}")
    check(len(same) == len(one_p) and torch.equal(one_pl, one_bl),
          "packed over one sequence differs from the rounds with B2-seq's forward")
    loss_rel = float(((p_losses - r_losses).abs() / r_losses.abs()).max())
    one_rel = float(((one_pl - one_rl).abs() / one_rl.abs()).max())
    say(f"{tag} packed {packed_s:.2f} s, rounds {rounds_s:.2f} s (with the pool "
        f"builds); losses packed {p_losses.tolist()}, rounds {r_losses.tolist()}: "
        f"max rel diff {loss_rel:.3g}, over one sequence {one_rel:.3g} (limit "
        f"{PK_LOSS_RTOL:g})")
    check(loss_rel <= PK_LOSS_RTOL, f"packed vs rounds losses {loss_rel:.3g} apart")
    check(one_rel <= PK_LOSS_RTOL, f"one sequence: losses {one_rel:.3g} apart")
    check(not torch.equal(p_losses[0], p_losses[1]), "the sequences drew alike")
    # the deltas against the rounds with B2-seq's forward, held to PK_DELTA,
    # and against the rounds as they run, printed: this run and PK_SEEDS
    # more seeds (pools warped on the card), then the control, which must
    # read over PK_DELTA against both
    refs = ("the rounds with B2-seq's forward", "the rounds")
    readings = [("one sequence", 0, refs[1], *delta_diff(
        state0, unstack_params(one_p, 0), unstack_params(one_r, 0), require_moved=True))]
    for i in range(BT_SEQS):
        for against, ref in zip(refs, (rounds_b2, rounds)):
            readings.append((f"seed {SEED}, host pools", i, against, *delta_diff(
                state0, unstack_params(packed, i), unstack_params(ref, i),
                require_moved=True)))
    dev_kw = dict(kw, host_pool=False)
    with cudnn_deterministic():
        for j in range(1, PK_SEEDS + 1):
            state_j = init_osvos_params(fast, torch.Generator().manual_seed(SEED + j))
            cfg_j = dataclasses.replace(ocfg, seed=ocfg.seed + 10 * j)
            (pk, pl), (rd, rl) = (
                batched_fine_tune(state_j, imgs, masks, fast, cfg_j,
                                  schedule=sched, **dev_kw)
                for sched in ("packed", "rounds"))
            with rounds_b2_forward():
                rb, _ = batched_fine_tune(state_j, imgs, masks, fast, cfg_j,
                                          schedule="rounds", **dev_kw)
            rel = float(((pl - rl).abs() / rl.abs()).max())
            say(f"{tag} seed {SEED + j}, device pools: losses max rel diff "
                f"{rel:.3g} (limit {PK_LOSS_RTOL:g})")
            check(rel <= PK_LOSS_RTOL, f"seed {SEED + j}: losses {rel:.3g} apart")
            for i in range(BT_SEQS):
                for against, ref in zip(refs, (rb, rd)):
                    readings.append((f"seed {SEED + j}, device pools", i, against,
                                     *delta_diff(state_j, unstack_params(pk, i),
                                                 unstack_params(ref, i),
                                                 require_moved=True)))
            if j == 1:
                bad = BT_SEQS - 1
                with halved_gradient(bad):
                    ctrl, _ = batched_fine_tune(state_j, imgs, masks, fast, cfg_j,
                                                schedule="packed", **dev_kw)
                ctrls = [(against, *delta_diff(state_j, unstack_params(ctrl, bad),
                                               unstack_params(ref, bad)))
                         for against, ref in zip(refs, (rb, rd))]
                others = all(torch.equal(ctrl[key][:bad], pk[key][:bad]) for key in pk)
    for run, i, against, leaf, worst in readings:
        say(f"{tag} {run}, sequence {i}: parameter deltas of packed against "
            f"{against} at most {worst:.3g} of the leaf's delta scale, at "
            f"{leaf or '-'}: {'within' if worst <= PK_DELTA_FAST else 'NOT within'} "
            f"the fast fine-tune's {PK_DELTA_FAST:g}")
    sound = max((r for r in readings if r[2] == refs[0]), key=lambda r: r[4])
    order = max((r for r in readings if r[2] == refs[1]), key=lambda r: r[4])
    ctrl = min(ctrls, key=lambda r: r[2])
    say(f"{tag} packed against {refs[0]}: the worst of "
        f"{sum(r[2] == refs[0] for r in readings)} sound readings {sound[4]:.3g} "
        f"({sound[0]}, sequence {sound[1]}, at {sound[3]}); the control (seed "
        f"{SEED + 1}, sequence {bad}'s gradient halved) at least {ctrl[2]:.3g} "
        f"(against {ctrl[0]}, at {ctrl[1]}); limit {PK_DELTA:g} (cuDNN's grouped "
        f"convs round some bf16 gradients otherwise); the control's other "
        f"sequences {'bit for bit' if others else 'NOT bit for bit'} the sound "
        f"packed run's; against {refs[1]}, printed (the forward's sum order "
        f"too): the worst of {sum(r[2] == refs[1] for r in readings)} "
        f"{order[4]:.3g} ({order[0]}, sequence {order[1]}, at {order[3]}) | {card}")
    check(sound[4] <= PK_DELTA, f"packed vs rounds deltas {sound[4]:.3g} of their scale")
    check(ctrl[2] > PK_DELTA, f"the control reads {ctrl[2]:.3g}, within the limit "
          f"{PK_DELTA:g}")
    warned = [r.getMessage() for r in records if "cannot be packed" in r.getMessage()]
    same = [key for key in packed if torch.equal(packed[key], down[key])]
    say(f"{tag} compute_mode='flat' under schedule='packed': {len(warned)} "
        f"warning(s) {warned}; {len(same)} of {len(packed)} tensors and the "
        f"losses {'bit for bit' if torch.equal(d_losses, p_losses) else 'NOT bit for bit'} "
        f"the fast packed run (cuDNN deterministic)")
    check(len(warned) == 1, f"{len(warned)} downgrade warnings")
    check(len(same) == len(packed) and torch.equal(d_losses, p_losses),
          "the downgraded run differs from the fast packed run")

    grouped_against_lone(device, card, fast.stages)
    times = {s: time_seq_kernels(device, k, card, fast.stages, s)
             | {"conv_fwd_seq": time_fwd_seq(device, k, card, fast.stages, s)}
             for s in PK_KERNEL_SEQS}[PK_SEQS]
    time_packed_steps(device, card, state0, imgs)
    cli_batched(device, k, card, mode="fast")
    say(f"{tag} phase 9c passed in {time.perf_counter() - t_phase:.1f} s | {card}")
    return {"counts": counts, "errs": errs, "times": times}


def cli_batched(device, k, card, mode: str = "flat") -> None:
    """``cli/train_online.main --all_val --batched --steps FT_STEPS --eval``
    on a synthetic tree of BT_SEQS val sequences of BT_CLI_FRAMES frames at
    480x854 from a random full-width parent (the default pool of 100):
    exact launches, a PNG a frame, the J/F and [batched] lines and the
    phase times. ``mode`` 'flat' (the default compute mode: the rounds) or
    'fast' (``--compute_mode fast``: off a mesh, the packed schedule)."""
    from osvos_torch.cli import train_online
    from osvos_torch.configs import ModelConfig
    from osvos_torch.data.synthetic import DEFAULT_VAL_SEQS, generate
    from osvos_torch.models import init_osvos_params
    from osvos_torch.utils.checkpoint import save_checkpoint

    tag = "[batched-cli]" if mode == "flat" else "[packed-cli]"
    seqs = DEFAULT_VAL_SEQS[:BT_SEQS]
    with tempfile.TemporaryDirectory() as tmp:
        db_root = generate(os.path.join(tmp, "davis"), height=H, width=W,
                           n_frames=BT_CLI_FRAMES, train_seqs=[], val_seqs=seqs)
        parent = save_checkpoint(os.path.join(tmp, "parent.pt"), init_osvos_params(
            ModelConfig(), torch.Generator().manual_seed(SEED)))
        save_root = os.path.join(tmp, "runs")
        argv = ["--db_root", db_root, "--parent", parent, "--all_val",
                "--batched", "--steps", str(FT_STEPS), "--eval",
                "--save_root", save_root, "--compute_mode", mode]
        out = io.StringIO()
        zero_counts(k)
        k["fused_head"].launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = train_online.main(argv)
        finally:
            for line in out.getvalue().splitlines():
                say(f"{tag} | {line}")
        secs = time.perf_counter() - t0
        counts, tail = read_counts(k), k["fused_head"].launches
        stages = ModelConfig().stages
        if mode == "flat":  # the rounds
            want = expected_counts("flat", FT_STEPS * len(seqs), stages,
                                   loss_kernels=False)
        else:  # packed: one launch a layer a step for the sequences
            want = expected_counts("packed", FT_STEPS, stages,
                                   loss_kernels=False)
        # inference, one call a sequence
        want["max_pool_fwd"] += (len(stages) - 1) * len(seqs)
        say(f"{tag} python -m osvos_torch.cli.train_online {' '.join(argv)}: "
            f"returned {rc} in {secs:.2f} s; launches {counts}, fused_head "
            f"{tail}; expected {want}, fused_head {len(seqs)} | {card}")
        check(rc == 0, f"the batched CLI returned {rc}")
        check(counts == want and tail == len(seqs),
              f"batched CLI launch counts {counts} (fused_head {tail})")
        for seq in seqs:
            names = sorted(os.listdir(os.path.join(save_root, "Results", seq)))
            check(names == [f"{i:05d}.png" for i in range(BT_CLI_FRAMES)],
                  f"batched CLI PNGs of {seq}: {names}")
        text = out.getvalue()
        check(re.search(rf"\[batched\] {len(seqs)} sequences fine-tuned in "
                        r"[0-9.]+s \([0-9.]+s/seq amortized\)", text) is not None,
              "no [batched] line")
        check(all(re.search(rf"\[{s}\] J=[0-9.]+ F=[0-9.]+", text) for s in seqs),
              "no J/F lines")
        times = {name: float(re.search(rf"\[batched\] time {name}: ([0-9.]+) s",
                                       text).group(1))
                 for name in ("decode", "fine-tune", "inference", "PNG writes",
                              "eval")}
        say(f"{tag} {len(seqs)} x {BT_CLI_FRAMES} PNGs, J/F lines; phases "
            f"{times} | {card}")


def time_parent(device, cfg, state0, calls, card):
    """ms per call (microbatch) and per optimizer step, host clock, fast
    and flat in the same run, and the device kernels of one optimizer step
    by group."""
    from osvos_torch.configs import ModelConfig
    from osvos_torch.train.parent import ParentTrainer

    out = {}
    for mode in ("fast", "flat"):
        trainer = ParentTrainer(state0, ModelConfig(compute_mode=mode), cfg,
                                device=device)
        call_ms = []
        for i in range(2 + PT_TIMED):
            img, gt, side_w = calls[i % len(calls)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(img, gt, side_w)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(call_ms[2:])
        step_ms = [a + b for a, b in zip(call_ms[2::2], call_ms[3::2])]
        out[mode] = (med, statistics.median(step_ms))
        say(f"[time] parent {mode} (batch {PT_BATCH}, {H}x{W}, n_ave_grad "
            f"{PT_AVE}): median {med:.2f} ms per call, "
            f"{out[mode][1]:.2f} ms per optimizer step, of {PT_TIMED} calls "
            f"after 2 warm-up (all: {[round(t, 2) for t in call_ms]}) | {card}")
        batches = [calls[0], calls[1]]
        profile_groups(lambda: [trainer.train_step(*c) for c in batches],
                       f"parent {mode}, one optimizer step ({PT_AVE} calls)",
                       card, 1)
    say(f"[time] parent ms per optimizer step, same card and run: flat "
        f"{out['flat'][1]:.2f}, fast {out['fast'][1]:.2f} | {card}")
    return out


def profile_groups(fn, what, card, per):
    """The device kernels of ``fn`` under the profiler, by group, per
    ``per`` repetitions."""
    events, wall_us = device_events(fn, 1)
    if not events:
        say(f"[profile] {what}: not measured, the profiler saw no device "
            f"activity | {card}")
        return
    by_name, launches = {}, {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
        launches[kernel_group(name)] = launches.get(kernel_group(name), 0) + 1
    busy_us = sum(by_name.values())
    say(f"[profile] {what}: device busy {busy_us / per / 1e3:.2f} ms of "
        f"{wall_us / per / 1e3:.2f} ms wall ({busy_us / wall_us:.1%}; the "
        f"profiler slows the host side) | {card}")
    groups = {}
    for name, us in by_name.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + us
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        say(f"[profile]   {us / per / 1e3:9.3f} ms {us / busy_us:6.1%}  {group} "
            f"({launches[group]} launches)")
    say("[profile] top kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        say(f"[profile]   {us / per / 1e3:9.3f} ms {us / busy_us:6.1%}  {name[:110]}")


def time_fine_tune(device, model, frames, card, mode):
    """ms per optimizer step (host clock, median after 2 warm-up steps) and
    the device kernels of 2 profiled steps."""
    from osvos_torch.configs import ModelConfig, OnlineConfig
    from osvos_torch.train.online import (make_chunk_fn, make_draws,
                                          make_online_optimizer)

    mcfg = ModelConfig(compute_mode=mode)
    ocfg = OnlineConfig(loss_impl="pallas")
    model.train()
    chunk = make_chunk_fn(mcfg, ocfg)
    opt = make_online_optimizer(model, ocfg)
    image = torch.from_numpy(frames[0]).to(device)[None]
    mask = torch.from_numpy(blob_mask(H, W)).to(device)[None, ..., None]
    draws = make_draws(ocfg, "pool", 2 + FT_TIMED, 1,
                       torch.Generator().manual_seed(SEED), device)
    torch.cuda.reset_peak_memory_stats(device)
    step_ms = []
    for s in range(2 + FT_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk(model, opt, image, mask, draws.steps(s, s + 1))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    med = statistics.median(step_ms[2:])
    say(f"[time] fine-tune step (batch {FT_BATCH}, {H}x{W}, {mode}, "
        f"loss_impl='pallas'): median {med:.2f} ms of {FT_TIMED} after 2 "
        f"warm-up (all: {[round(t, 2) for t in step_ms]}); peak memory "
        f"{peak_gb:.2f} GB | {card}")
    say(f"[time] {mode} projection, not a measurement: 2000 steps x {med:.2f} ms = "
        f"{2000 * med / 1e3:.1f} s of fine-tune per sequence | {card}")
    profile_groups(lambda: chunk(model, opt, image, mask, draws.steps(0, 2)),
                   f"{mode} fine-tune, per step of 2", card, 2)
    return med


def kernel_group(name: str) -> str:
    """The layer a device kernel of a training step belongs to."""
    if "side_fwd_tma_kernel<" in name:
        return "flatconv side forward (B5)"
    if "side_dgrad_tma_kernel<" in name:
        return "flatconv dz, side (B6)"
    if "pack_weight_kernel" in name:
        return "flatconv weight pack"
    if "stem_fwd_kernel<" in name:
        return "stem.cu stem forward (B2's stem)"
    if "conv3x3_tma_kernel<" in name:
        # csrc/flatconv.cu's Hopper path <TN, R, epilogue>: 2 is dz's mask
        epi = int(name.split("conv3x3_tma_kernel<")[1].split(">")[0].split(",")[2])
        return ("flatconv dz, trunk (B3)" if epi == 2
                else "flatconv forward after the stem (B2)")
    if "conv3x3_kernel<" in name:
        # csrc/flatconv.cu's template <TN, TC, epilogue, extra>
        args = name.split("conv3x3_kernel<")[1].split(">")[0].split(",")
        epi, tc = int(args[2]), int(args[1])
        return {0: "flatconv forward (B2)", 1: "flatconv side forward (B5)"}.get(
            epi, "flatconv dz, side (B6)" if tc == 16 else "flatconv dz, trunk (B3)")
    if "stem_wgrad_" in name:
        return "stem_wgrad.cu stem dK + db (B16)"
    if any(k in name for k in ("wgrad_tma_kernel", "wgrad_tma_reduce_kernel",
                               "wgrad_partial_kernel", "wgrad_reduce_kernel")):
        return "wgrad.cu dK (fast: B17; flat: B4, the dK + db of B3, and B6's dK)"
    if "::stats_" in name or "::grad_kernel<" in name:
        return "cbbce kernels (B13, B14)"
    if any(k in name for k in ("xmma", "cudnn", "gemm", "cutlass", "sm90_",
                               "nchwToNhwc", "nhwcToNchw")):
        return "cuDNN and cuBLAS (conv forward, conv dx, matmuls)"
    if "pool_fwd_kernel<" in name or "pool_bwd_kernel<" in name:
        return "pool.cu max pool forward and backward (B7-B10)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy and memset"
    return "other PyTorch kernels (bias, ReLU, casts, loss, SGD)"


def main(argv=None) -> int:
    """The phases in order; with ``--host-split`` only the device, the build
    and the flat wrappers' per-call host split (``host_split``), which runs
    against any checkout whose ``ops/kernels/flatconv.py`` has the same
    wrappers, as a parent commit's does."""
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--host-split"]):
        raise SystemExit(f"usage: chip_smoke.py [--host-split]; got {argv}")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; "
                           "this check runs only on an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from osvos_torch.configs import ModelConfig
    from osvos_torch.data.synthetic import image_like
    from osvos_torch.evaluation.infer import infer_sequence
    from osvos_torch.models import OSVOS, init_osvos_params
    from osvos_torch.models.surgery import spread_head
    from osvos_torch.ops.kernels import (build, cbbce, flatconv, fused_head,
                                         int8conv, pool, stem_wgrad, wgrad)

    t_start = time.perf_counter()
    # 1. device
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | host: {os.cpu_count()} cores, "
        f"{len(os.sched_getaffinity(0))} usable")

    # 2. build, from the sources, even if a library of the same hash exists
    build_kernels(build)
    if argv:
        host_split(device, flatconv, card)
        return 0

    # 3. every kernel against its plain version
    cfg = ModelConfig(compute_mode="fast")
    conv_shapes = trunk_conv_shapes(cfg.stages, FT_BATCH, H, W)
    tail_err = check_fused_head(device, fused_head)
    stats_err, grad_err = check_cbbce(device, cbbce)
    side_shapes = side_conv_shapes(cfg.stages, FT_BATCH, H, W)
    wgrad_err = check_wgrad(device, wgrad, conv_shapes + side_shapes)
    stem_err = check_stem_wgrad(device, stem_wgrad)
    stem_fwd_err = check_stem_fwd(device, flatconv)
    flat_cases = flat_case_list(cfg.stages, FT_BATCH, H, W)
    flat_err = check_flat(device, flatconv, flat_cases)
    check_pack(device, flatconv, flat_cases)
    pcases = pool_cases(cfg.stages, FT_BATCH, H, W)
    pool_err = check_pool(device, pool, pcases)
    int8_shapes = [(name, (n, h, w, c, d)) for name, n, h, w, c, d in
                   trunk_conv_shapes(cfg.stages, BATCH, H, W)[1:]]
    int8_err = check_int8(device, int8conv, int8_shapes
                          + [("odd", shape) for shape in INT8_ODD])
    int8_q_err = check_int8_q(device, int8conv, int8_shapes
                              + [("odd", shape) for shape in INT8_ODD])
    k = dict(cbbce=cbbce, wgrad=wgrad, flatconv=flatconv, fused_head=fused_head,
             pool=pool, stem_wgrad=stem_wgrad, int8conv=int8conv)

    # 3b. the JAX package's .ckpt, read without msgpack
    ckpt_phase()

    # 4. the card's tests, in their own process, without JAX
    run_card_tests()

    # 5. the serving slice: full width, fast mode, seeded weights
    model = OSVOS(cfg)
    model.load_state_dict(init_osvos_params(cfg, torch.Generator().manual_seed(SEED)))
    model.to(device).eval()
    frames = image_like(N_FRAMES, H, W, seed0=SEED)
    scale = spread_head(model, torch.from_numpy(frames[:BATCH]).to(device))
    say(f"[serve] OSVOS fast, full width, {N_FRAMES} frames {H}x{W}, batch "
        f"{BATCH}; fuse weights scaled by {scale:.4g} to spread the logits")
    tail_launches, slice_s = serve(device, k, model, frames)

    # 5b. int8 serving from the same weights, static and dynamic scales
    int8_serve = serve_int8(device, k, model, frames, card)

    # 6. parity mode: card against CPU, full width, one 65x97 frame
    check_parity(device, pool)

    # 7. the fine-tune slice, in fast mode and in flat mode (the JAX
    # package's default), from the same weights and draws
    state0, tuned, losses_fast, fast_counts = fine_tune_phase(
        device, k, frames, "fast")
    _, tuned_flat, losses_flat, flat_counts = fine_tune_phase(
        device, k, frames, "flat")
    flat_vs_fast(state0, (losses_flat, tuned_flat.state_dict()),
                 (losses_fast, tuned.state_dict()))

    # 8. parent training, full width, fast mode (flat beside it)
    pt_cfg, pt_state0, pt_calls, parent_counts = parent_phase(device, k)

    # 8b. --vis_net: the parent CLI draws the graph, fast and flat
    vis_net_phase(device, k, card)

    # 9. the online entry point, the main path: decode, host pool, flat
    # fine-tune, fast inference, PNGs, J/F
    cli_counts = online_cli_phase(device, k, card)

    # 9b. parallel/: the rounds, batched inference, one NCCL rank's data
    # parallel and frame-parallel inference, gloo ranks, the batched CLI
    parallel_phase(device, k, card, pt_cfg, pt_state0, pt_calls)

    # 9c. the packed schedule: the sequence-batched B17 and B16, packed
    # against the rounds, the downgrade, its times, the batched CLI packed
    pk = packed_phase(device, k, card)

    # 10. timings, same card
    bias = torch.tensor([0.5], device=device)
    cs = contribs(BATCH, H, W, device, seed=SEED + H)
    kern = lambda: fused_head.fused_upsample_sigmoid_u8(cs, bias, (H, W), FACTORS)  # noqa: E731
    ref = lambda: fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, (H, W), FACTORS)  # noqa: E731
    ref_ms = [median_ms(ref)]
    kern_ms = [median_ms(kern), median_ms(kern)]
    ref_ms.append(median_ms(ref))
    tail_ms, tail_plain_ms = statistics.median(kern_ms), statistics.median(ref_ms)
    tail_dev, tail_kernels = device_per_call(kern)
    tail_bound = bound(sum(c.numel() * 4 for c in cs) + 4 + BATCH * H * W,
                       TAIL_OPS * BATCH * H * W, F32_OPS_PER_S)
    say(f"[time] fused_head tail B={BATCH} {H}x{W}, per call (CUDA events): "
        f"kernel {tail_ms:.4f} ms (runs {kern_ms}), plain {tail_plain_ms:.4f} ms "
        f"(runs {ref_ms}); profiler: kernel {dev_text(tail_dev)}, "
        f"{tail_kernels} device kernel(s) a call, plain "
        f"{dev_text(device_ms(ref))}; bound {tail_bound[0]:.4f} ms "
        f"({tail_bound[1]}) | {card}")
    # the profiler can miss an event, so a call's kernels read at most 1
    check(tail_kernels is None or 0.5 < tail_kernels <= 1,
          f"fused_head: {tail_kernels} device kernels a call")
    infer_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer_sequence(model, frames, batch_size=BATCH)
        infer_s.append(time.perf_counter() - t0)
    say(f"[time] serving: {N_FRAMES / slice_s:.2f} frames/s with PNG writes, "
        f"{N_FRAMES / statistics.median(infer_s):.2f} frames/s infer_sequence "
        f"alone (median of 3) | {card}")

    # Each call takes the next of CB_COPIES input pairs, 98 MB in all, so
    # that its inputs are not left in the 50 MB L2 by the call before.
    pairs = [logits_labels(FT_BATCH, H * W, device, seed=SEED + i)
             for i in range(CB_COPIES)]
    turn = iter(range(1 << 30))
    numel = FT_BATCH * H * W
    cb = {}
    # the per-sample form (B13, B14) is the microbatch step's and goes into
    # the JSON line; the whole-batch form (B11, B12) is the sequential step's
    for form, shape in (("per-sample", (FT_BATCH, H * W)),
                        ("whole-batch", (1, numel))):
        def nxt(shape=shape):
            x, z = pairs[next(turn) % CB_COPIES]
            return x.view(shape), z.view(shape)

        wts = torch.rand(shape[0], 4, device=device) + 0.1
        for name, kfn, pfn, nbytes, ops in (
                ("cbbce_stats", lambda: cbbce.cbbce_stats(*nxt()),
                 lambda: cbbce.cbbce_stats_ref(*nxt()),
                 8 * numel + 16 * shape[0], CBBCE_STATS_OPS * numel),
                ("cbbce_grad", lambda: cbbce.cbbce_grad(*nxt(), wts),
                 lambda: cbbce.cbbce_grad_ref(*nxt(), wts),
                 12 * numel + 16 * shape[0], CBBCE_GRAD_OPS * numel)):
            k_ms, p_ms = median_ms(kfn), median_ms(pfn)
            k_dev, k_kernels = device_per_call(kfn)
            b_ms, b_by = bound(nbytes, ops, F32_OPS_PER_S)
            say(f"[time] {name} {form} {shape}, inputs not in L2: kernel "
                f"{k_ms:.4f} ms per call (CUDA events), {dev_text(k_dev)}, "
                f"{k_kernels} device kernel(s) a call (profiler); plain "
                f"{p_ms:.4f} ms per call; bound {b_ms:.4f} ms ({b_by}); no "
                f"single PyTorch call computes it | {card}")
            check(k_kernels is None or 0.5 < k_kernels <= 1,
                  f"{name}: {k_kernels} device kernels a call")
            cb.setdefault(name, (k_ms, p_ms, b_ms, b_by, k_dev))

    # B17 takes every trunk conv after the stem (the stem takes B16)
    b17_shapes = conv_shapes[1:]
    totals = time_wgrad(device, wgrad, b17_shapes, card,
                        f"wgrad3x3, the {len(b17_shapes)} trunk convs of one step")
    wgrad_bound, wgrad_by = totals["bound"], totals["by"]
    b6_dk = time_wgrad(device, wgrad, side_shapes, card,
                       f"B6's dK (wgrad.cu alone), the {len(side_shapes)} side "
                       "convs of one flat step")
    stem_t = time_stem_wgrad(device, stem_wgrad, card)
    stem_fwd_t = time_stem_fwd(device, flatconv, card)
    flat_t = time_flat(device, flatconv, step_cases(flat_cases), card)
    time_dgrad(device, flatconv, step_cases(flat_cases), card)
    b6_dz = time_dgrad(device, flatconv, step_cases(flat_cases), card, row="B6")
    pack_t = time_pack(device, flatconv, flat_cases, card)
    host_split(device, flatconv, card)
    pool_t = time_pool(device, pool, pcases[:len(cfg.stages) - 1], card)
    time_pool(device, pool, pool_cases(cfg.stages, PT_BATCH, H, W)[:len(cfg.stages) - 1],
              card)  # at the parent phase's batch
    fast_ms = time_fine_tune(device, tuned, frames, card, "fast")
    flat_ms = time_fine_tune(device, tuned_flat, frames, card, "flat")
    say(f"[time] fine-tune ms per step, same card and run: flat {flat_ms:.2f}, "
        f"fast {fast_ms:.2f} (flat / fast = {flat_ms / fast_ms:.3f}) | {card}")
    time_parent(device, pt_cfg, pt_state0, pt_calls, card)
    i1_t = time_int8(device, int8conv, int8_shapes, card)
    i1q_t = time_int8_q(device, int8conv, int8_shapes, card)
    flat_rows = (
        ("B2", "flat_conv_fwd", "osvos_torch/csrc/flatconv.cu", None,
         "osvos_tpu/ops/pallas/flatconv.py:875"),
        ("B3", "flat_conv_bwd", "osvos_torch/csrc/flatconv.cu",
         "osvos_torch/csrc/wgrad.cu", "osvos_tpu/ops/pallas/flatconv.py:1484"),
        ("B4", "flat_wgrad_db", "osvos_torch/csrc/wgrad.cu", None,
         "osvos_tpu/ops/pallas/flatconv.py:1080"),
        ("B5", "flat_side_fwd", "osvos_torch/csrc/flatconv.cu", None,
         "osvos_tpu/ops/pallas/flatconv.py:2477"),
        ("B6", "flat_side_bwd", "osvos_torch/csrc/flatconv.cu",
         "osvos_torch/csrc/wgrad.cu", "osvos_tpu/ops/pallas/flatconv.py:2040"))
    flat_json = []
    for row, name, source, also, replaces in flat_rows:
        t = flat_t[row]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": cli_counts[row],
                 "max_abs_err": flat_err[row], "ms": t["ms"],
                 "plain_ms": t["plain"], "bound_ms": t["bound"],
                 "bound_by": t["by"], "library_ms": t["lib"],
                 "work": f"its {t['calls']} calls of one flat fine-tune step, "
                         f"batch {FT_BATCH} at {H}x{W}, summed"}
        if also:
            entry["also_source"] = also
        if row == "B3":  # its dz launch is the separate flat dgrad's function
            entry["also_replaces"] = "osvos_tpu/ops/pallas/flatconv.py:965"
            entry["work"] += "; its times include its B4 launch"
        if row == "B4":
            entry["work"] += "; B3's second launch"
        if row == "B2":  # its stem alone: csrc/stem.cu, bound by bytes
            entry.update(stem_source="osvos_torch/csrc/stem.cu",
                         stem_launches=cli_counts["stem.cu"],
                         stem_max_abs_err=stem_fwd_err, stem_ms=stem_fwd_t["ms"],
                         stem_device_ms=stem_fwd_t["dev"],
                         stem_plain_ms=stem_fwd_t["plain"],
                         stem_bound_ms=stem_fwd_t["bound"],
                         stem_bound_by=stem_fwd_t["by"],
                         stem_library_ms=stem_fwd_t["lib"])
            entry["work"] += (f"; stem_* its stem alone, one call at "
                              f"{stem_fwd_t['shape']}")
        if row == "B6":  # its wgrad.cu launch alone, and its dz launch alone
            entry.update(dk_ms=b6_dk["ms"], dk_device_ms=b6_dk["dev"],
                         dk_plain_ms=b6_dk["plain"], dk_bound_ms=b6_dk["bound"],
                         dk_bound_by=b6_dk["by"], dk_library_ms=b6_dk["lib"],
                         dz_ms=b6_dz["ms"], dz_device_ms=b6_dz["dev"],
                         dz_plain_ms=b6_dz["plain"], dz_bound_ms=b6_dz["bound"],
                         dz_bound_by=b6_dz["by"], dz_library_ms=b6_dz["lib"])
        flat_json.append(entry)
    flat_json.append({
        "name": "flat_pack_weight", "route": "cuda",
        "source": "osvos_torch/csrc/flatconv.cu",
        "replaces": "osvos_tpu/ops/pallas/flatconv.py:833",
        "launches": cli_counts["flatconv.cu pack"], "max_abs_err": 0.0,
        "ms": pack_t["ms"], "plain_ms": pack_t["plain"],
        "bound_ms": pack_t["bound"], "bound_by": "bytes", "library_ms": None,
        "work": f"the weight operands of the {pack_t['calls']} flatconv.cu "
                f"launches of one flat step that take one, summed; replaces "
                f"the operand's bf16 cast and padding in XLA before each flat "
                f"pallas_call"})
    pool_json = []
    for d, replaces, also in (("fwd", 185, 442), ("bwd", 309, 571)):
        t = pool_t[d]
        pool_json.append({
            "name": f"max_pool_{d}", "route": "cuda",
            "source": "osvos_torch/csrc/pool.cu",
            "replaces": f"osvos_tpu/ops/pallas/flatpool.py:{replaces}",
            "also_replaces": f"osvos_tpu/ops/pallas/flatpool.py:{also}",
            "launches": parent_counts[f"max_pool_{d}"], "max_abs_err": pool_err,
            "ms": t["ms"], "plain_ms": t["plain"], "bound_ms": t["bound"],
            "bound_by": "bytes", "library_ms": t["lib"] if d == "fwd" else None,
            "work": f"the {len(cfg.stages) - 1} stage-boundary pools of one fast "
                    f"fine-tune step, batch {FT_BATCH} at {H}x{W}, summed; "
                    f"launches from the parent run"})

    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [
        {"name": "fused_head_tail", "route": "cuda",
         "source": "osvos_torch/csrc/fused_head.cu",
         "replaces": "osvos_tpu/ops/pallas/fused_head.py:109",
         "launches": tail_launches, "max_abs_err": tail_err,
         "ms": tail_ms, "plain_ms": tail_plain_ms,
         "bound_ms": tail_bound[0], "bound_by": tail_bound[1],
         "library_ms": None, "device_ms": tail_dev,
         "work": f"one call, B={BATCH} {H}x{W}"},
        {"name": "cbbce_stats", "route": "cuda",
         "source": "osvos_torch/csrc/cbbce.cu",
         "replaces": "osvos_tpu/ops/pallas/cbbce.py:198",
         "also_replaces": "osvos_tpu/ops/pallas/cbbce.py:101",
         "launches": flat_counts["cbbce_stats"], "max_abs_err": stats_err,
         "ms": cb["cbbce_stats"][0], "plain_ms": cb["cbbce_stats"][1],
         "bound_ms": cb["cbbce_stats"][2], "bound_by": cb["cbbce_stats"][3],
         "library_ms": None, "device_ms": cb["cbbce_stats"][4],
         "work": f"one call, ({FT_BATCH}, {H * W})"},
        {"name": "cbbce_grad", "route": "cuda",
         "source": "osvos_torch/csrc/cbbce.cu",
         "replaces": "osvos_tpu/ops/pallas/cbbce.py:239",
         "also_replaces": "osvos_tpu/ops/pallas/cbbce.py:129",
         "launches": flat_counts["cbbce_grad"], "max_abs_err": grad_err,
         "ms": cb["cbbce_grad"][0], "plain_ms": cb["cbbce_grad"][1],
         "bound_ms": cb["cbbce_grad"][2], "bound_by": cb["cbbce_grad"][3],
         "library_ms": None, "device_ms": cb["cbbce_grad"][4],
         "work": f"one call, ({FT_BATCH}, {H * W})"},
        {"name": "wgrad3x3", "route": "cuda",
         "source": "osvos_torch/csrc/wgrad.cu",
         "replaces": "osvos_tpu/ops/pallas/wgrad.py:168",
         "launches": fast_counts["wgrad3x3 (B17)"], "max_abs_err": wgrad_err,
         "ms": totals["ms"], "plain_ms": totals["plain"],
         "bound_ms": wgrad_bound, "bound_by": wgrad_by,
         "library_ms": totals["lib"],
         "work": f"the {len(b17_shapes)} trunk convs after the stem of one "
                 f"fast fine-tune step, batch {FT_BATCH} at {H}x{W}, one call "
                 f"each, summed; launches from the fast run"},
        {"name": "stem_wgrad", "route": "cuda",
         "source": "osvos_torch/csrc/stem_wgrad.cu",
         "replaces": "osvos_tpu/ops/pallas/flatconv.py:1681",
         "launches": cli_counts["stem_wgrad (B16)"], "max_abs_err": stem_err,
         "ms": stem_t["ms"], "plain_ms": stem_t["plain"],
         "bound_ms": stem_t["bound"], "bound_by": stem_t["by"],
         "library_ms": stem_t["lib"],
         "work": f"one call, the stem {stem_t['shape']}; launches from the "
                 f"online CLI run"},
        {"name": "int8_conv3x3_q", "route": "cuda",
         "source": "osvos_torch/csrc/int8conv.cu",
         "replaces": "osvos_tpu/models/vgg_osvos.py:97",
         "launches": int8_serve["static"]["launches"], "max_abs_err": int8_q_err,
         "ms": i1q_t["ms"], "plain_ms": i1q_t["plain"], "bound_ms": i1q_t["bound"],
         "bound_by": i1q_t["by"], "library_ms": i1q_t["lib"],
         "device_ms": i1q_t["dev"], "cudnn_bf16_ms": i1q_t["cudnn"],
         "cudnn_bf16_device_ms": i1q_t["cudnn_dev"],
         "work": f"I1's Hopper path (bf16 x quantized in its operand load, s8 "
                 f"wgmma fed by TMA): the {len(int8_shapes)} trunk convs after "
                 f"the stem of one int8 forward, batch {BATCH} at {H}x{W}, one "
                 f"call each, summed; no Pallas kernel: _Int8Conv's "
                 f"quantization and XLA int8 conv; the bound reads x as bf16; "
                 f"library_ms is im2col + torch._int_mm of the quantized x, "
                 f"cudnn_bf16_ms F.conv2d in bf16; launches from int8 serving "
                 f"with static scales"},
        {"name": "int8_conv3x3", "route": "cuda",
         "source": "osvos_torch/csrc/int8conv.cu",
         "replaces": "osvos_tpu/models/vgg_osvos.py:97",
         "launches": cli_counts["int8 CLI I1"], "max_abs_err": int8_err,
         "ms": i1_t["ms"], "plain_ms": i1_t["plain"], "bound_ms": i1_t["bound"],
         "bound_by": i1_t["by"], "library_ms": i1_t["lib"],
         "device_ms": i1_t["dev"], "cudnn_bf16_ms": i1_t["cudnn"],
         "work": f"I1's mma.sync path (int8 x, the shapes the Hopper path does "
                 f"not take): timed at the {len(int8_shapes)} trunk convs after "
                 f"the stem of one int8 forward, batch {BATCH} at {H}x{W}, one "
                 f"call each, summed; library_ms is im2col + torch._int_mm, "
                 f"cudnn_bf16_ms F.conv2d in bf16; launches from the int8 CLI "
                 f"run at the --tiny widths"},
    ] + flat_json + pool_json + [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": pk["counts"][f"{name} ({row})"],
         "max_abs_err": pk["errs"][name], "ms": pk["times"][name]["ms"],
         "plain_ms": pk["times"][name]["plain"],
         "bound_ms": pk["times"][name]["bound"],
         "bound_by": pk["times"][name]["by"],
         "library_ms": pk["times"][name]["lib"],
         "queued_ms": pk["times"][name]["dev"],
         "lone_ms": pk["times"][name]["lone"],
         "lone_queued_ms": pk["times"][name]["lone_dev"],
         "passes_device_ms": pk["times"][name]["passes"],
         "work": f"{what} of one packed fast step, S = {PK_SEQS} sequences of "
                 f"batch {FT_BATCH} at {H}x{W}, one launch each{', summed' if row == 'B17' else ''}; "
                 f"lone_ms is the {PK_SEQS} lone launches of the rounds; "
                 f"queued_ms the mean of two readings of CUDA events around 20 "
                 f"calls queued back to back; passes_device_ms its two passes "
                 f"(profiler); "
                 f"library_ms one grouped (groups={PK_SEQS}) "
                 f"convolution_backward; launches from the packed run's "
                 f"{FT_STEPS} steps"}
        for name, row, source, replaces, what in (
            ("wgrad3x3_seq", "B17", "osvos_torch/csrc/wgrad.cu",
             "osvos_tpu/ops/pallas/wgrad.py:168", "the 12 trunk convs after the stem"),
            ("stem_wgrad_seq", "B16", "osvos_torch/csrc/stem_wgrad.cu",
             "osvos_tpu/ops/pallas/flatconv.py:1681", "the stem's dK + db"))]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
