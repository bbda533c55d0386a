#!/usr/bin/env python3
"""Device times of the sequence launches and the lone launches they stand
for, for the checkout at ROOT, so that two commits can be compared on one
card in turns.

    python3 tools/seq_launch_ab.py ROOT TAG

ROOT is a checkout of the repository (this one, or a parent commit
unpacked under ``build/``); its kernels are built from its sources and timed
with its own ``chip_smoke.py`` helpers. Each line starts with ``[TAG]``:

- ``wgrad3x3_seq`` (B17 over S sequences) at S = 2 and 4 at the 12 trunk
  convs after the stem of a full-width fast step (batch 5 at 480x854): the
  sequence launch against its S lone ``wgrad3x3`` launches, queued (CUDA
  events around 20 calls queued back to back; the two taken in turns,
  kernel, lone, lone, kernel, each the mean of its two readings), and the
  sequence launch's two passes from one profiler window, per conv and
  summed;
- ``stem_wgrad_seq`` (B16 over S sequences) at S = 2, 4 and 5 against its S
  lone ``stem_wgrad`` launches, the same way;
- the lone launches of ``csrc/wgrad.cu`` at the same 12 convs, dK alone
  (B17) and dK + db (B4), and the lone B16, queued.

Run it on a machine with an NVIDIA H100, e.g. for a parent unpacked under
``build/parent``: ``for t in build/parent:old .:new .:new build/parent:old;
do python3 tools/seq_launch_ab.py ${t%%:*} ${t##*:}; done``.
"""

import os
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor


def main(root: str, tag: str) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from osvos_torch.configs import ModelConfig
    from osvos_torch.ops.kernels import build, stem_wgrad, wgrad

    if not torch.cuda.is_available():
        raise SystemExit("seq_launch_ab: needs an NVIDIA GPU")
    with ThreadPoolExecutor(2) as ex:
        list(ex.map(build.build_library, ["wgrad", "stem_wgrad"]))
    dev = torch.device("cuda", 0)
    card = cs.card_line()

    def turns(kfn, lfn):
        k = [cs.queued_ms(kfn)]
        lone = [cs.queued_ms(lfn), cs.queued_ms(lfn)]
        k.append(cs.queued_ms(kfn))
        return statistics.mean(k), statistics.mean(lone)

    def passes(fn, names, n=10):
        events, _ = cs.device_events(fn, n)
        times = [[us for e, us in events if name in e] for name in names]
        return [sum(t) / n / 1e3 if len(t) == n else None for t in times]

    def text(v):
        return "not measured" if v is None else f"{v:.4f}"

    convs = cs.trunk_conv_shapes(ModelConfig().stages, 5, 480, 854)
    for s in (2, 4):
        tot = [0.0, 0.0, 0.0, 0.0]
        for i, (name, n, h, w, c, d) in enumerate(convs[1:]):
            x = cs.bf16_randn((n, h, w, s * c), dev, 1000 + i, relu=True)
            g = cs.bf16_randn((n, h, w, s * d), dev, 1050 + i)
            xs = [x[..., j * c:(j + 1) * c].contiguous() for j in range(s)]
            gs = [g[..., j * d:(j + 1) * d].contiguous() for j in range(s)]
            kfn = lambda: wgrad.wgrad3x3_seq(x, g, s)  # noqa: E731
            lfn = lambda: [wgrad.wgrad3x3(a, b) for a, b in zip(xs, gs)]  # noqa: E731
            k, lone = turns(kfn, lfn)
            p1, p2 = passes(kfn, ("wgrad_tma_kernel<", "wgrad_tma_reduce_kernel"))
            print(f"[{tag}] wgrad3x3_seq S = {s} {name} ({n},{h},{w},{c}->{d}): "
                  f"{k:.4f} ms queued, {s} lone {lone:.4f} ({k / lone:.3f}); "
                  f"pass 1 {text(p1)}, pass 2 {text(p2)}", flush=True)
            for j, v in enumerate((k, lone, p1 or 0.0, p2 or 0.0)):
                tot[j] += v
            del x, g, xs, gs
        print(f"[{tag}] wgrad3x3_seq S = {s}, 12 convs: {tot[0]:.4f} ms queued, "
              f"{s} lone {tot[1]:.4f} ({tot[0] / tot[1]:.3f}); pass 1 "
              f"{tot[2]:.4f}, pass 2 {tot[3]:.4f} | {card}", flush=True)
    for s in (2, 4, 5):
        x, g = cs.stem_inputs(dev, (5, 480, 854, 3 * s, 64 * s), 1200 + s)
        xs = [x[..., j * 3:(j + 1) * 3].contiguous() for j in range(s)]
        gs = [g[..., j * 64:(j + 1) * 64].contiguous() for j in range(s)]
        kfn = lambda: stem_wgrad.stem_wgrad_seq(x, g, s)  # noqa: E731
        lfn = lambda: [stem_wgrad.stem_wgrad(a, b) for a, b in zip(xs, gs)]  # noqa: E731
        k, lone = turns(kfn, lfn)
        p1, p2 = passes(kfn, ("stem_wgrad_tma_kernel<", "stem_wgrad_reduce_kernel"))
        print(f"[{tag}] stem_wgrad_seq S = {s}: {k:.4f} ms queued, {s} lone "
              f"{lone:.4f} ({k / lone:.3f}); pass 1 {text(p1)}, pass 2 "
              f"{text(p2)} | {card}", flush=True)
        del x, g, xs, gs
    b17 = b4 = 0.0
    for i, (name, n, h, w, c, d) in enumerate(convs[1:]):
        x = cs.bf16_randn((n, h, w, c), dev, 1000 + i, relu=True)
        g = cs.bf16_randn((n, h, w, d), dev, 1050 + i)
        b17 += statistics.mean(cs.queued_ms(lambda: wgrad.launch(x, g, False))
                               for _ in range(2))
        b4 += statistics.mean(cs.queued_ms(lambda: wgrad.launch(x, g, True))
                              for _ in range(2))
    x, g = cs.stem_inputs(dev, (5, 480, 854, 3, 64), 7)
    b16 = statistics.mean(cs.queued_ms(lambda: stem_wgrad.stem_wgrad(x, g))
                          for _ in range(2))
    print(f"[{tag}] lone launches queued: wgrad.cu at the 12 convs, dK (B17) "
          f"{b17:.4f} ms, dK + db (B4) {b4:.4f}; stem_wgrad (B16) {b16:.4f} "
          f"| {card}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit("usage: seq_launch_ab.py ROOT TAG")
    sys.exit(main(*sys.argv[1:]))
