"""infer.useful_frame_pct: the share of the frames the forward ran that
are real: 100 x ``infer.frames_real`` (each call's frames of its sequence)
over ``infer.frames_run`` (each call's buffer rows, the pad included),
counted by ``batched_infer`` in a traced run's profiled windows. Every call
runs a full buffer, so a sequence's tail and a short sequence's padding to
the longest are both run and not used. None where nothing was counted (a
program without the counters)."""

from osvos_torch.utils import profiling


def read(r):
    totals = getattr(profiling, "totals", None)
    if r.kind != "infer" or totals is None:
        return None
    counted = totals()
    run = counted.get("infer.frames_run", 0)
    if not run:
        return None
    return 100 * counted.get("infer.frames_real", 0) / run
