"""infer.fill_ms_per_frame: the host's ms a real frame in ``infer.fill``,
the numpy buffer fill of each call of ``batched_infer`` (the call's frames
copied into its float32 buffer, the pad with the sequence's last frame):
the spans' host intervals summed over a traced run's two profiled windows
(a whole pass each), over the ``infer.frames_real`` counted there. The
fill runs no PyTorch operation, so the profiler does not stretch it: 424
and 464 ms a pass in the two windows against 461-598 with no profiler
(H100 host; the host's own spread, 10-30%, is larger). None where nothing
was recorded (a program without the span or the counter)."""

from osvos_torch.utils import profiling


def read(r):
    spans = getattr(profiling, "spans", None)
    totals = getattr(profiling, "totals", None)
    if r.kind != "infer" or spans is None or totals is None:
        return None
    real = totals().get("infer.frames_real", 0)
    ms = [s.host_ms for s in spans() if s.name == "infer.fill"]
    if not real or not ms:
        return None
    return sum(ms) / real
