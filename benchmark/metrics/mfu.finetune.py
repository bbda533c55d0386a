"""mfu.finetune: the fine-tune step's share of the card's bf16 peak, over
the unprofiled window: every sequence-step's operations (lib/counts.py:
forward, dK and dx of the 17 convs) over the window's seconds."""

from benchmark.lib.peaks import BF16_FLOPS


def read(r):
    if r.kind != "finetune":
        return None
    steps = sum(w for w, _ in r.window["units"])
    return 100 * r.info["flops_per_step"] * steps / (r.window["seconds"] * BF16_FLOPS)
