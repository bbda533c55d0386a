"""mfu.infer: the inference passes' share of the card's bf16 peak, over the
unprofiled window: the real frames' forward operations (padding frames are
run but not counted, so padding shows as lost work) over the window's
seconds."""

from benchmark.lib.peaks import BF16_FLOPS


def read(r):
    if r.kind != "infer":
        return None
    frames = sum(w for w, _ in r.window["units"])
    return 100 * r.info["flops_per_frame"] * frames / (r.window["seconds"] * BF16_FLOPS)
