#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``osvos_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (sm_90a) and the
CUDA toolkit. Phases, in order; any failure raises and exits nonzero:

1. device: the card and its power limit (``nvidia-smi``);
2. build: nvcc compiles every kernel of the port from ``csrc/``, one
   process per source, all started together;
3. kernel checks, each kernel against its plain PyTorch version:
   the fused-head tail at the serving shapes and an odd small shape; the
   CB-BCE statistics and gradient at the fine-tune's per-sample shape, its
   whole-batch form and a ragged shape, with logits of +-100; the 3x3
   weight gradient at every trunk conv of the fine-tune and a small odd
   shape;
4. card tests: ``tests/test_torch_cuda.py`` under pytest, nothing skipped;
5. serving: full-width OSVOS in fast mode (bf16 trunk) with seeded weights
   serves 12 synthetic 480x854 frames at batch 4 through ``infer_sequence``
   and writes one PNG per frame; the fused-head kernel must have run, and
   the maps must equal the plain tail's within 1 code;
6. parity: full-width parity-mode logits on the card against the same
   model on the CPU, within 2e-4 of the output's scale;
7. fine-tune: ``make_fine_tune_fn`` at full width in fast mode with
   ``loss_impl='pallas'``, the default microbatch step (batch 5) and pool
   (100 entries) on a 480x854 frame, for 8 optimizer steps; the launch
   counts must be exact, and the same steps with the kernels' plain
   versions substituted must give the same losses and parameter deltas;
   the tuned weights then serve 4 frames through the fused-head kernel;
8. timings: each kernel, its plain version and, where one PyTorch call
   computes the same function, that call; the fine-tune's ms per step and
   its top device kernels.

The last lines are a JSON object describing each kernel, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. No CPU fallback: without
CUDA the script fails.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FACTORS = (2, 4, 8, 16)
BATCH, H, W = 4, 480, 854
N_FRAMES = 12
SEED = 0
MAX_OFF_SHARE = 1e-3  # share of pixels allowed one code off the plain tail
KERNEL_SOURCES = ("fused_head", "cbbce", "wgrad")
FT_STEPS = 8          # optimizer steps of the fine-tune phase
FT_BATCH = 5          # OnlineConfig().n_ave_grad, the microbatch
FT_POOL = 100         # make_fine_tune_fn's default pool size
FT_TIMED = 8          # steps timed after 2 warm-up steps
CB_COPIES = 6         # input pairs the CB-BCE timings rotate through

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


def median_ms(fn, n: int = 50, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_events(fn, n: int):
    """The device activity (name, µs) of ``n`` calls of ``fn`` under
    ``torch.profiler``, and the host-clock µs of the window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(events), "profiler saw no device activity")
    return events, wall_us


def device_ms(fn, n: int = 20, kernel: str = "") -> float:
    """Median device time of one call of ``fn`` from a profiler trace: the
    duration of the kernel named ``kernel``, or, with no name, the sum of all
    device activity in the window divided by ``n``."""
    events, _ = device_events(fn, n)
    if kernel:
        times = [us for name, us in events if kernel in name]
        check(len(times) == n, f"profiler saw {len(times)} of {n} {kernel}")
        return statistics.median(times) / 1e3
    return sum(us for _, us in events) / n / 1e3


def read_png_gray8(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale PNG whose rows all use filter type 0, as
    ``evaluation.infer.encode_png_gray8`` writes them."""
    with open(path, "rb") as f:
        blob = f.read()
    check(blob[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        check(zlib.crc32(tag + data) & 0xFFFFFFFF
              == struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])[0],
              f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    check((depth, color) == (8, 0), f"{path}: not 8-bit grayscale")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    check(not rows[:, 0].any(), f"{path}: unexpected row filter")
    return rows[:, 1:]


def blob_mask(h: int, w: int) -> np.ndarray:
    """(h, w) float32 ellipse of about 15% foreground."""
    yy, xx = np.mgrid[:h, :w]
    inside = ((yy - 0.45 * h) / (0.25 * h)) ** 2 + ((xx - 0.5 * w) / (0.19 * w)) ** 2
    return (inside <= 1.0).astype(np.float32)


@contextlib.contextmanager
def plain_kernels(cbbce, wgrad):
    """Substitute the plain versions for the fine-tune's kernel wrappers."""
    saved = cbbce.cbbce_stats, cbbce.cbbce_grad, wgrad.wgrad3x3
    cbbce.cbbce_stats, cbbce.cbbce_grad = cbbce.cbbce_stats_ref, cbbce.cbbce_grad_ref
    wgrad.wgrad3x3 = wgrad.wgrad3x3_ref
    try:
        yield
    finally:
        cbbce.cbbce_stats, cbbce.cbbce_grad, wgrad.wgrad3x3 = saved


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


def check_fused_head(device, fused_head) -> int:
    bias = torch.tensor([0.5], device=device)
    max_err = 0
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
    shapes = [(FT_BATCH, H * W), (3, 33 * 49), (1, FT_BATCH * H * W)]
    stats_err = grad_err = 0.0
    for b, n in shapes:
        x, z = logits_labels(b, n, device, seed=SEED + n)
        got = cbbce.cbbce_stats(x, z)
        again = cbbce.cbbce_stats(x, z)
        torch.cuda.synchronize()
        want = cbbce.cbbce_stats_ref(x, z)
        abs_err = float((got[:, 2:] - want[:, 2:]).abs().max())
        rel = float(((got[:, 2:] - want[:, 2:]).abs() / want[:, 2:].abs()).max())
        say(f"[kernel] cbbce_stats ({b}, {n}): counts {got[:, :2].tolist()[:2]}"
            f"{'...' if b > 2 else ''}, sums max rel err {rel:.3g}, "
            f"max abs err {abs_err:.4g}, repeat bitwise equal "
            f"{torch.equal(got, again)}")
        check(got.shape == (b, 4) and bool(torch.isfinite(got).all()),
              "cbbce_stats shape or non-finite output")
        check(torch.equal(got[:, :2], want[:, :2]), "cbbce_stats counts differ")
        check(rel <= 1e-5, f"cbbce_stats sums: {rel:.3g} relative")
        check(torch.equal(got, again), "cbbce_stats: two launches differ")
        stats_err = max(stats_err, abs_err)

        wts = torch.rand(b, 4, device=device,
                         generator=torch.Generator(device=device).manual_seed(n)) + 0.1
        dx = cbbce.cbbce_grad(x, z, wts)
        torch.cuda.synchronize()
        want_dx = cbbce.cbbce_grad_ref(x, z, wts)
        abs_err = float((dx - want_dx).abs().max())
        scale = float(want_dx.abs().max())
        say(f"[kernel] cbbce_grad ({b}, {n}): max |kernel - ref| = "
            f"{abs_err:.4g} = {abs_err / scale:.3g} of max|dx|")
        check(bool(torch.isfinite(dx).all()), "cbbce_grad non-finite output")
        check(abs_err <= 1e-6 * scale, f"cbbce_grad: {abs_err / scale:.3g} "
              "of max|dx|")
        grad_err = max(grad_err, abs_err)
    return stats_err, grad_err


def check_wgrad(device, wgrad, shapes) -> float:
    """Within 1e-4 of max|dK|: both sum exact bf16 products in float32, in
    another order."""
    worst = 0.0
    for name, n, h, w, c, d in shapes + [("odd", 2, 9, 13, 8, 4)]:
        gen = torch.Generator(device=device).manual_seed(SEED + c * d + h)
        x = torch.randn(n, h, w, c, device=device, generator=gen).to(torch.bfloat16)
        g = torch.randn(n, h, w, d, device=device, generator=gen).to(torch.bfloat16)
        got = wgrad.wgrad3x3(x, g)
        torch.cuda.synchronize()
        want = wgrad.wgrad3x3_ref(x, g)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        say(f"[kernel] wgrad3x3 {name} x({n},{h},{w},{c}) g(..,{d}): "
            f"max |kernel - ref| = {err:.4g} = {err / scale:.3g} of max|dK|")
        check(got.shape == (3, 3, c, d) and got.dtype == torch.float32,
              "wgrad3x3 shape or type")
        check(err <= 1e-4 * scale, f"wgrad3x3 {name}: {err / scale:.3g} of max|dK|")
        worst = max(worst, err)
    return worst


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


def serve(device, fused_head, model, frames):
    """The serving slice: 12 frames through ``infer_sequence`` and the PNG
    writer; returns the fused-head launches and the slice's seconds."""
    from osvos_torch.evaluation.infer import (infer_sequence, make_infer_fn,
                                              save_sequence_results)

    fnames = [f"{i:05d}.jpg" for i in range(N_FRAMES)]
    infer_sequence(model, frames, batch_size=BATCH)  # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as results:
        fused_head.launches = 0
        t0 = time.perf_counter()
        masks = infer_sequence(model, frames, batch_size=BATCH)
        save_sequence_results(masks, fnames, results, "synth")
        slice_s = time.perf_counter() - t0
        launches = fused_head.launches
        pngs = sorted(os.listdir(os.path.join(results, "synth")))
        decoded = [read_png_gray8(os.path.join(results, "synth", p)) for p in pngs]
    say(f"[serve] fused_head launches in the run: {launches}; PNGs written: "
        f"{len(pngs)}")
    check(launches == N_FRAMES // BATCH, f"expected {N_FRAMES // BATCH} "
          f"fused_head launches, counted {launches}")
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


def check_parity(device) -> None:
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
        gpu_out = pmodel.to(device)(x.to(device))
    worst = 0.0
    for i, (g, c) in enumerate(zip(gpu_out, cpu_out)):
        rel = float((g.cpu() - c).abs().max()) / max(float(c.abs().max()), 1e-3)
        worst = max(worst, rel)
        check(bool(torch.isfinite(g).all()), f"parity output {i} not finite")
        check(rel <= 2e-4, f"parity output {i}: card vs CPU {rel:.3g} of scale")
    say(f"[parity] full width 65x97, 5 outputs: max |card - cpu| / max|out| "
        f"= {worst:.3g} (limit 2e-4)")


def fine_tune_phase(device, kernels, frames):
    """The fine-tune slice through ``make_fine_tune_fn``, once with the
    kernels and once with their plain versions; returns the tuned model and
    the launch counts of the kernel run."""
    from osvos_torch.configs import ModelConfig, OnlineConfig
    from osvos_torch.evaluation.infer import infer_sequence, make_infer_fn
    from osvos_torch.models import OSVOS, init_osvos_params
    from osvos_torch.train.online import make_fine_tune_fn

    cbbce, wgrad, fused_head = kernels
    mcfg = ModelConfig(compute_mode="fast")
    ocfg = OnlineConfig(n_steps=FT_STEPS, loss_impl="pallas")
    check(ocfg.n_ave_grad == FT_BATCH, "OnlineConfig's default batch moved")
    state0 = init_osvos_params(mcfg, torch.Generator().manual_seed(SEED))
    image, mask = frames[0], blob_mask(H, W)
    fine_tune = make_fine_tune_fn(mcfg, ocfg, aug_mode="pool",
                                  pool_size=FT_POOL, device=device)
    n_convs = len(trunk_conv_shapes(mcfg.stages, 1, H, W))
    say(f"[fine-tune] OSVOS fast, full width, frame 0 {H}x{W} with a "
        f"{mask.mean():.1%} foreground mask; pool {FT_POOL}, {FT_STEPS} steps "
        f"of batch {FT_BATCH}, lr {ocfg.lr}, loss_impl='pallas'")

    def run():
        model = OSVOS(mcfg)
        model.load_state_dict(state0)
        t0 = time.perf_counter()
        losses = fine_tune(model, image, mask, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        return model, losses, time.perf_counter() - t0

    cbbce.stats_launches = cbbce.grad_launches = wgrad.launches = 0
    model_k, losses_k, secs = run()
    counts = (cbbce.stats_launches, cbbce.grad_launches, wgrad.launches)
    want = (FT_STEPS, FT_STEPS, FT_STEPS * n_convs)
    say(f"[fine-tune] kernel run {secs:.2f} s (pool build and first-call set-up "
        f"included); launches stats/grad/wgrad = {counts}, expected {want}")
    say(f"[fine-tune] losses {[round(v, 3) for v in losses_k.tolist()]}")
    check(counts == want, f"launch counts {counts}, expected {want}")
    check(losses_k.shape == (FT_STEPS,) and bool(torch.isfinite(losses_k).all()),
          "fine-tune losses not finite")

    with plain_kernels(cbbce, wgrad):
        cbbce.stats_launches = cbbce.grad_launches = wgrad.launches = 0
        model_p, losses_p, secs_p = run()
        plain_counts = (cbbce.stats_launches, cbbce.grad_launches, wgrad.launches)
    say(f"[fine-tune] plain run {secs_p:.2f} s; kernel launches {plain_counts}")
    check(plain_counts == (0, 0, 0), "the plain run launched a kernel")
    loss_rel = float(((losses_k - losses_p).abs() / losses_p.abs()).max())
    p0, pk, pp = state0, model_k.state_dict(), model_p.state_dict()
    worst_leaf, worst = "", 0.0
    for key in p0:
        dk = pk[key].cpu() - p0[key]
        dp = pp[key].cpu() - p0[key]
        scale = float(dp.abs().max())
        rel = float((dk - dp).abs().max()) / scale if scale else \
            float((dk - dp).abs().max())
        if rel > worst:
            worst_leaf, worst = key, rel
        if key.endswith("weight") and not key.startswith("score_dsn"):
            check(scale > 0 and float(dk.abs().max()) > 0, f"{key} did not move")
    say(f"[fine-tune] kernel vs plain: losses max rel diff {loss_rel:.3g} "
        f"(limit 1e-6); parameter deltas max {worst:.3g} of the leaf's delta "
        f"scale at {worst_leaf or '-'} (limit 1e-2); every trunk, side_prep "
        f"and fuse weight moved")
    # The two runs differ only in float32 sum order. At lr 1e-8 a delta is
    # some hundred float32 steps of its weight, so one rounding step apart is
    # about 1e-2 of it, and the delta bound cannot be tighter.
    check(loss_rel <= 1e-6, f"losses differ by {loss_rel:.3g} relative")
    check(worst <= 1e-2, f"{worst_leaf} delta differs by {worst:.3g} of scale")

    model_k.eval()
    fused_head.launches = 0
    maps = infer_sequence(model_k, frames[:BATCH], batch_size=BATCH)
    tuned_launches = fused_head.launches
    plain = make_infer_fn(mcfg, kernel_tail=False)(
        model_k, torch.from_numpy(frames[:BATCH]).to(device)).cpu().numpy()
    err = int(np.abs(np.stack(maps).astype(int) - plain.astype(int)).max())
    say(f"[fine-tune] tuned weights serve {BATCH} frames: fused_head launches "
        f"{tuned_launches}; max |kernel tail - plain tail| = {err} code(s)")
    check(tuned_launches == 1, "the tuned model did not serve through the kernel")
    check(all(m.shape == (H, W) and m.dtype == np.uint8 for m in maps),
          "tuned maps shape or type")
    check(err <= 1, "tuned maps differ from the plain tail")
    return model_k, counts


def time_fine_tune(device, model, frames, card):
    """ms per optimizer step (host clock, median after 2 warm-up steps) and
    the device kernels of 2 profiled steps."""
    from osvos_torch.configs import ModelConfig, OnlineConfig
    from osvos_torch.train.online import (make_chunk_fn, make_draws,
                                          make_online_optimizer)

    mcfg = ModelConfig(compute_mode="fast")
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
    say(f"[time] fine-tune step (batch {FT_BATCH}, {H}x{W}, fast, "
        f"loss_impl='pallas'): median {med:.2f} ms of {FT_TIMED} after 2 "
        f"warm-up (all: {[round(t, 2) for t in step_ms]}); peak memory "
        f"{peak_gb:.2f} GB | {card}")
    say(f"[time] projection, not a measurement: 2000 steps x {med:.2f} ms = "
        f"{2000 * med / 1e3:.1f} s of fine-tune per sequence | {card}")
    events, wall_us = device_events(
        lambda: chunk(model, opt, image, mask, draws.steps(0, 2)), 1)
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_us = sum(by_name.values())
    say(f"[profile] fine-tune, 2 steps: device busy {busy_us / 2e3:.2f} ms per "
        f"step of {wall_us / 2e3:.2f} ms wall ({busy_us / wall_us:.1%}; the "
        f"profiler slows the host side) | {card}")
    groups = {}
    for name, us in by_name.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + us
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        say(f"[profile]   {us / 2e3:9.3f} ms/step {us / busy_us:6.1%}  {group}")
    say("[profile] top kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        say(f"[profile]   {us / 2e3:9.3f} ms/step {us / busy_us:6.1%}  {name[:110]}")
    return med


def kernel_group(name: str) -> str:
    """The layer a device kernel of the fine-tune step belongs to."""
    if "wgrad_partial_kernel" in name or "wgrad_reduce_kernel" in name:
        return "wgrad3x3 kernel (B17)"
    if "::stats_" in name or "::grad_kernel<" in name:
        return "cbbce kernels (B13, B14)"
    if any(k in name for k in ("xmma", "cudnn", "gemm", "cutlass", "sm90_",
                               "nchwToNhwc", "nhwcToNchw")):
        return "cuDNN and cuBLAS (conv forward, conv dx, matmuls)"
    if "max_pool" in name:
        return "max pool forward"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy and memset"
    return "other PyTorch kernels (bias, ReLU, pool backward, casts, loss, SGD)"


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; "
                           "this check runs only on an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from osvos_torch.configs import ModelConfig
    from osvos_torch.data.synthetic import image_like
    from osvos_torch.evaluation.infer import infer_sequence
    from osvos_torch.models import OSVOS, init_osvos_params
    from osvos_torch.models.surgery import spread_head
    from osvos_torch.ops.kernels import build, cbbce, fused_head, wgrad

    t_start = time.perf_counter()
    # 1. device
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build, from the sources, even if a library of the same hash exists
    build_kernels(build)

    # 3. every kernel against its plain version
    cfg = ModelConfig(compute_mode="fast")
    conv_shapes = trunk_conv_shapes(cfg.stages, FT_BATCH, H, W)
    tail_err = check_fused_head(device, fused_head)
    stats_err, grad_err = check_cbbce(device, cbbce)
    wgrad_err = check_wgrad(device, wgrad, conv_shapes)

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
    tail_launches, slice_s = serve(device, fused_head, model, frames)

    # 6. parity mode: card against CPU, full width, one 65x97 frame
    check_parity(device)

    # 7. the fine-tune slice
    tuned, (stats_launches, grad_launches, wgrad_launches) = fine_tune_phase(
        device, (cbbce, wgrad, fused_head), frames)

    # 8. timings, same card
    bias = torch.tensor([0.5], device=device)
    cs = contribs(BATCH, H, W, device, seed=SEED + H)
    kern = lambda: fused_head.fused_upsample_sigmoid_u8(cs, bias, (H, W), FACTORS)  # noqa: E731
    ref = lambda: fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, (H, W), FACTORS)  # noqa: E731
    ref_ms = [median_ms(ref)]
    kern_ms = [median_ms(kern), median_ms(kern)]
    ref_ms.append(median_ms(ref))
    tail_ms, tail_plain_ms = statistics.median(kern_ms), statistics.median(ref_ms)
    tail_dev = device_ms(kern, kernel="tail_kernel")
    tail_bound = bound(sum(c.numel() * 4 for c in cs) + 4 + BATCH * H * W,
                       TAIL_OPS * BATCH * H * W, F32_OPS_PER_S)
    say(f"[time] fused_head tail B={BATCH} {H}x{W}, per call (CUDA events): "
        f"kernel {tail_ms:.4f} ms (runs {kern_ms}), plain {tail_plain_ms:.4f} ms "
        f"(runs {ref_ms}); device (profiler): kernel {tail_dev:.4f} ms, plain "
        f"{device_ms(ref):.4f} ms; bound {tail_bound[0]:.4f} ms "
        f"({tail_bound[1]}) | {card}")
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
            k_dev = device_ms(kfn)
            b_ms, b_by = bound(nbytes, ops, F32_OPS_PER_S)
            say(f"[time] {name} {form} {shape}, inputs not in L2: kernel "
                f"{k_ms:.4f} ms per call (CUDA events), {k_dev:.4f} ms device "
                f"(profiler); plain {p_ms:.4f} ms per call; bound {b_ms:.4f} "
                f"ms ({b_by}); no single PyTorch call computes it | {card}")
            cb.setdefault(name, (k_ms, p_ms, b_ms, b_by))

    totals = dict(ms=0.0, dev=0.0, plain=0.0, lib=0.0, bound_b=0.0, bound_o=0.0)
    for name, n, h, w, c, d in conv_shapes:
        gen = torch.Generator(device=device).manual_seed(SEED + c * d + h)
        xb = torch.randn(n, h, w, c, device=device, generator=gen).to(torch.bfloat16)
        gb = torch.randn(n, h, w, d, device=device, generator=gen).to(torch.bfloat16)
        wb = torch.randn(d, c, 3, 3, device=device, generator=gen).to(torch.bfloat16)
        xn, gn = xb.permute(0, 3, 1, 2), gb.permute(0, 3, 1, 2)
        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            gn, xn, wb, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])
        kfn = lambda: wgrad.wgrad3x3(xb, gb)  # noqa: E731
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
        say(f"[time] wgrad3x3 {name} ({n},{h},{w},{c}->{d}): kernel "
            f"{k_ms:.4f} ms per call, {k_dev:.4f} ms device; plain {p_ms:.4f}; "
            f"library (convolution_backward, bf16 dK, {lib_err:.2g} of max|dK| "
            f"off) {l_ms:.4f}; bound {max(t_b, t_o):.4f} ms "
            f"({'bytes' if t_b >= t_o else 'operations'}); "
            f"{ops / k_dev / 1e9:.1f} TFLOP/s | {card}")
        for key, v in (("ms", k_ms), ("dev", k_dev), ("plain", p_ms),
                       ("lib", l_ms), ("bound_b", t_b), ("bound_o", t_o)):
            totals[key] += v
        del xb, gb, wb, xn, gn
    wgrad_bound = max(totals["bound_b"], totals["bound_o"])
    wgrad_by = "bytes" if totals["bound_b"] >= totals["bound_o"] else "operations"
    say(f"[time] wgrad3x3, the {len(conv_shapes)} trunk convs of one step: "
        f"kernel {totals['ms']:.3f} ms per call summed, {totals['dev']:.3f} ms "
        f"device; plain {totals['plain']:.3f}; library {totals['lib']:.3f}; "
        f"bound {wgrad_bound:.3f} ms ({wgrad_by}) | {card}")

    time_fine_tune(device, tuned, frames, card)

    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [
        {"name": "fused_head_tail", "route": "cuda",
         "source": "osvos_torch/csrc/fused_head.cu",
         "replaces": "osvos_tpu/ops/pallas/fused_head.py:109",
         "launches": tail_launches, "max_abs_err": tail_err,
         "ms": tail_ms, "plain_ms": tail_plain_ms,
         "bound_ms": tail_bound[0], "bound_by": tail_bound[1],
         "library_ms": None,
         "work": f"one call, B={BATCH} {H}x{W}"},
        {"name": "cbbce_stats", "route": "cuda",
         "source": "osvos_torch/csrc/cbbce.cu",
         "replaces": "osvos_tpu/ops/pallas/cbbce.py:198",
         "also_replaces": "osvos_tpu/ops/pallas/cbbce.py:101",
         "launches": stats_launches, "max_abs_err": stats_err,
         "ms": cb["cbbce_stats"][0], "plain_ms": cb["cbbce_stats"][1],
         "bound_ms": cb["cbbce_stats"][2], "bound_by": cb["cbbce_stats"][3],
         "library_ms": None, "work": f"one call, ({FT_BATCH}, {H * W})"},
        {"name": "cbbce_grad", "route": "cuda",
         "source": "osvos_torch/csrc/cbbce.cu",
         "replaces": "osvos_tpu/ops/pallas/cbbce.py:239",
         "also_replaces": "osvos_tpu/ops/pallas/cbbce.py:129",
         "launches": grad_launches, "max_abs_err": grad_err,
         "ms": cb["cbbce_grad"][0], "plain_ms": cb["cbbce_grad"][1],
         "bound_ms": cb["cbbce_grad"][2], "bound_by": cb["cbbce_grad"][3],
         "library_ms": None, "work": f"one call, ({FT_BATCH}, {H * W})"},
        {"name": "wgrad3x3", "route": "cuda",
         "source": "osvos_torch/csrc/wgrad.cu",
         "replaces": "osvos_tpu/ops/pallas/wgrad.py:168",
         "launches": wgrad_launches, "max_abs_err": wgrad_err,
         "ms": totals["ms"], "plain_ms": totals["plain"],
         "bound_ms": wgrad_bound, "bound_by": wgrad_by,
         "library_ms": totals["lib"],
         "work": f"the {len(conv_shapes)} trunk convs of one fine-tune step, "
                 f"batch {FT_BATCH} at {H}x{W}, one call each, summed"},
    ]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
