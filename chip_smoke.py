#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``osvos_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (sm_90a) and the
CUDA toolkit. Phases, in order; any failure raises and exits nonzero:

1. device: the card and its power limit (``nvidia-smi``);
2. build: nvcc compiles every kernel of the serving path from ``csrc/``;
3. kernel check: each kernel against its plain PyTorch version at the
   serving shapes and an odd small shape, on inputs that spread the logits;
4. card tests: ``tests/test_torch_cuda.py`` under pytest, nothing skipped;
5. slice: full-width OSVOS in fast mode (bf16 trunk) with seeded weights
   serves 12 synthetic 480x854 frames at batch 4 through ``infer_sequence``
   and writes one PNG per frame; the fused-head kernel must have run, and
   the maps must equal the plain tail's within 1 code;
6. parity: full-width parity-mode logits on the card against the same
   model on the CPU, within 2e-4 of the output's scale;
7. timings: the tail kernel and its plain version (median of CUDA-event
   times) and the slice's frames/s.

The last lines are a JSON object describing each kernel, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. No CPU fallback: without
CUDA the script fails.
"""

from __future__ import annotations

import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FACTORS = (2, 4, 8, 16)
BATCH, H, W = 4, 480, 854
N_FRAMES = 12
SEED = 0
MAX_OFF_SHARE = 1e-3  # share of pixels allowed one code off the plain tail


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


def contribs(b, h, w, device, seed, std=3.0):
    """Random (b, h_i, w_i) contributions at the four side-branch shapes."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in FACTORS:
        h, w = -(-h // 2), -(-w // 2)
        out.append(torch.from_numpy((rng.randn(b, h, w) * std)
                                    .astype(np.float32)).to(device))
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


def device_ms(fn, n: int = 20, kernel: str = "") -> float:
    """Median device time of one call of ``fn`` from a profiler trace: the
    duration of the kernel named ``kernel``, or, with no name, the sum of all
    device activity in the window divided by ``n``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernel:
        times = [e.time_range.elapsed_us() for e in events if kernel in e.name]
        check(len(times) == n, f"profiler saw {len(times)} of {n} {kernel}")
        return statistics.median(times) / 1e3
    check(bool(events), "profiler saw no device activity")
    return sum(e.time_range.elapsed_us() for e in events) / n / 1e3


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


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false; "
                           "this check runs only on an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from osvos_torch.configs import ModelConfig
    from osvos_torch.data.synthetic import image_like
    from osvos_torch.evaluation.infer import (infer_sequence, make_infer_fn,
                                              save_sequence_results)
    from osvos_torch.models import OSVOS, init_osvos_params
    from osvos_torch.models.surgery import spread_head
    from osvos_torch.ops.kernels import build, fused_head

    # 1. device
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build, from the sources, even if a library of the same hash exists
    lib = build.library_path("fused_head")
    if lib.exists():
        lib.unlink()
    say("[build] " + " ".join(build.nvcc_command("fused_head", lib)))
    t0 = time.perf_counter()
    report = build.build_library("fused_head")
    say(f"[build] fused_head built in {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(lib, ROOT)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"[build]   {line.strip()}")

    # 3. kernel against its plain version
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

    # 4. the card's tests, in their own process, without JAX
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-rs",
         os.path.join("tests", "test_torch_cuda.py")],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "OSVOS_TEST_PLATFORM": "gpu"})
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    say(f"[tests] tests/test_torch_cuda.py: {summary}")
    check(proc.returncode == 0 and "skipped" not in summary,
          f"card tests failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")

    # 5. the serving slice: full width, fast mode, seeded weights
    cfg = ModelConfig(compute_mode="fast")
    model = OSVOS(cfg)
    model.load_state_dict(init_osvos_params(cfg, torch.Generator().manual_seed(SEED)))
    model.to(device).eval()
    frames = image_like(N_FRAMES, H, W, seed0=SEED)
    scale = spread_head(model, torch.from_numpy(frames[:BATCH]).to(device))
    say(f"[slice] OSVOS fast, full width, {N_FRAMES} frames {H}x{W}, batch "
        f"{BATCH}; fuse weights scaled by {scale:.4g} to spread the logits")
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
    say(f"[slice] fused_head launches in the run: {launches}; PNGs written: "
        f"{len(pngs)}")
    check(launches == N_FRAMES // BATCH, f"expected {N_FRAMES // BATCH} "
          f"fused_head launches, counted {launches}")
    check(len(pngs) == N_FRAMES, f"expected {N_FRAMES} PNGs, found {len(pngs)}")
    check(all(np.array_equal(d, m) for d, m in zip(decoded, masks)),
          "PNG contents differ from the maps")
    plain = make_infer_fn(cfg, kernel_tail=False)
    want = np.concatenate([
        plain(model, torch.from_numpy(frames[i:i + BATCH]).to(device)).cpu().numpy()
        for i in range(0, N_FRAMES, BATCH)]).astype(int)
    got = np.stack(masks).astype(int)
    err = int(np.abs(got - want).max())
    off = float((got != want).mean())
    distinct = len(np.unique(got))
    say(f"[slice] maps {masks[0].shape} uint8; max |kernel tail - plain tail| "
        f"= {err} code(s) on {off:.2e} of pixels; {distinct} distinct u8 values")
    check(all(m.shape == (H, W) and m.dtype == np.uint8 for m in masks),
          "map shape or type")
    check(err <= 1 and off <= MAX_OFF_SHARE,
          f"slice maps differ from the plain tail: {err} codes on {off:.2e}")
    check(distinct >= 100, "slice output is degenerate")

    # 6. parity mode: card against CPU, full width, one 65x97 frame
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

    # 7. timings, same card, in turns
    cs = contribs(BATCH, H, W, device, seed=SEED + H)
    kern = lambda: fused_head.fused_upsample_sigmoid_u8(cs, bias, (H, W), FACTORS)  # noqa: E731
    ref = lambda: fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, (H, W), FACTORS)  # noqa: E731
    ref_ms = [median_ms(ref)]
    kern_ms = [median_ms(kern), median_ms(kern)]
    ref_ms.append(median_ms(ref))
    kernel_ms, plain_ms = statistics.median(kern_ms), statistics.median(ref_ms)
    say(f"[time] fused_head tail B={BATCH} {H}x{W}, per call (CUDA events): "
        f"kernel {kernel_ms:.4f} ms (runs {kern_ms}), plain {plain_ms:.4f} ms "
        f"(runs {ref_ms}) | {card}")
    say(f"[time] fused_head tail B={BATCH} {H}x{W}, device only (profiler): "
        f"kernel {device_ms(kern, kernel='tail_kernel'):.4f} ms, plain "
        f"{device_ms(ref):.4f} ms | {card}")
    infer_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer_sequence(model, frames, batch_size=BATCH)
        infer_s.append(time.perf_counter() - t0)
    say(f"[time] slice: {N_FRAMES / slice_s:.2f} frames/s with PNG writes, "
        f"{N_FRAMES / statistics.median(infer_s):.2f} frames/s infer_sequence "
        f"alone (median of 3) | {card}")

    say(json.dumps({"kernels": [{
        "name": "fused_head_tail", "route": "cuda",
        "source": "osvos_torch/csrc/fused_head.cu",
        "replaces": "osvos_tpu/ops/pallas/fused_head.py:48",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
