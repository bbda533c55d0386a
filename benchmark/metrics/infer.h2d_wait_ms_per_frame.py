"""infer.h2d_wait_ms_per_frame: the host's ms a real frame in
``infer.h2d``, its wait in ``torch.from_numpy(buf).to(device)``: a copy
from pageable memory returns when it is done, and it starts only when the
stream has run the previous call's forward. The spans' host intervals
summed over a traced run's two profiled windows (a whole pass each), over
the ``infer.frames_real`` counted there. One operation a call, so the
profiler hardly stretches it: 398 and 424 ms a pass in the two windows
against 415-483 with no profiler (H100 host). None where nothing was
recorded (a program without the span or the counter)."""

from osvos_torch.utils import profiling


def read(r):
    spans = getattr(profiling, "spans", None)
    totals = getattr(profiling, "totals", None)
    if r.kind != "infer" or spans is None or totals is None:
        return None
    real = totals().get("infer.frames_real", 0)
    ms = [s.host_ms for s in spans() if s.name == "infer.h2d"]
    if not real or not ms:
        return None
    return sum(ms) / real
