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
   heavy ties and with NaNs;
4. card tests: ``tests/test_torch_cuda.py`` under pytest, nothing skipped;
5. serving: full-width OSVOS in fast mode (bf16 trunk) with seeded weights
   serves 12 synthetic 480x854 frames at batch 4 through ``infer_sequence``
   and writes one PNG per frame; the fused-head kernel and the pool
   forward (four per forward pass) must have run, and the maps must equal
   the plain tail's within 1 code;
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
9. the online entry point (the main path): ``cli/train_online.main`` with
   its defaults and ``--steps 8 --eval --vis_res`` on one synthetic 12-frame
   480x854 sequence written in DAVIS's layout (JPEG frames, PNG masks), from
   a random parent: exact launch counts of the flat fine-tune (B16 among
   them) and of the fast inference, the tuned weights and losses bit for
   bit against ``build_host_pool`` + ``run_online`` called directly, 12
   PNGs, 12 overlays, 8 logged losses, the J/F line and the time of each
   phase (decode, pool build, fine-tune steps, inference, PNG writes,
   eval);
10. timings: each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (the fused-head tail and the
   CB-BCE kernels with their device kernels a call, one each;
   ``wgrad.cu`` at each trunk conv
   with its TFLOP/s and path, and alone at the side convs, B6's dK; B2, B3
   and B15's dz launch alone at each call of a flat step with their
   TFLOP/s and path, summed, and B2's calls after the stem summed; the
   stem's forward alone (its byte bound, ``F.conv2d`` bf16 + bias); B6's dz
   launch alone; the weight pack); the per-call host split of the flat
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
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FACTORS = (2, 4, 8, 16)
BATCH, H, W = 4, 480, 854
N_FRAMES = 12
SEED = 0
MAX_OFF_SHARE = 1e-3  # share of pixels allowed one code off the plain tail
KERNEL_SOURCES = ("fused_head", "cbbce", "wgrad", "flatconv", "pool",
                  "stem_wgrad", "stem")
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
            ("stem_wgrad.cu mma", "stem_wgrad", "mma_launches"))
FLAT_WRAPPERS = ("conv_fwd", "conv_bwd", "wgrad_db", "stem_bwd", "side_fwd",
                 "side_bwd")

# Published peaks of one H100 SXM (dense, no sparsity), for the bounds.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
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


def device_events(fn, n: int):
    """The device activity (name, µs) of ``n`` calls of ``fn`` under
    ``torch.profiler``, and the host-clock µs of the window; no activity if
    the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # Late in a long run the profiler has once returned a window without
    # device events (H100, torch 2.11); such a window is profiled again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events, wall_us
        say(f"[profiler] no device activity in a window of {n} calls")
    return [], wall_us


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
    for _ in range(3):  # a window without device events is profiled again
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return sum(events) / n / 1e3, len(events) / n
        say(f"[profiler] no device activity in a window of {n} calls")
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
    launch takes an mma path."""
    convs = sum(len(s) for s in stages)
    sides = len(stages) - 1
    flat = mode == "flat"
    losses = steps * outputs * loss_kernels
    tma = steps * (convs - 1) + steps * sides * flat
    return {"cbbce_stats": losses, "cbbce_grad": losses,
            "wgrad3x3 (B17)": 0 if flat else steps * (convs - 1),
            "stem_wgrad (B16)": steps,
            "B2": steps * convs * flat, "B3": steps * (convs - 1) * flat,
            "B4": steps * (convs - 1) * flat,
            "B5": steps * sides * flat, "B6": steps * sides * flat,
            "max_pool_fwd": 0 if flat else steps * sides,
            "max_pool_bwd": steps if flat else steps * sides,
            "wgrad.cu tma": tma, "wgrad.cu wmma": 0,
            "flatconv.cu hopper": 2 * steps * (convs - 1 + sides) * flat,
            "flatconv.cu mma": 0, "stem.cu": steps * flat,
            "flatconv.cu pack": steps * (2 * convs - 2 + sides) * flat,
            "stem_wgrad.cu tma": steps, "stem_wgrad.cu mma": 0}


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
    return counts


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
                                         pool, stem_wgrad, wgrad)

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
    k = dict(cbbce=cbbce, wgrad=wgrad, flatconv=flatconv, fused_head=fused_head,
             pool=pool, stem_wgrad=stem_wgrad)

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

    # 9. the online entry point, the main path: decode, host pool, flat
    # fine-tune, fast inference, PNGs, J/F
    cli_counts = online_cli_phase(device, k, card)

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
    ] + flat_json + pool_json}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
