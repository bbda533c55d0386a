"""infer.launch_ms_per_frame: the host's ms a real frame in
``infer.forward``, the ``make_infer_fn`` call that launches each call's
forward and B1, and the copy of its maps into the output: the spans' host
intervals summed over a traced run's two profiled windows (a whole pass
each), over the ``infer.frames_real`` counted there. The profiler of host
and device stretches these launches: 388 ms a pass under the device's
profiler and 517 under the host's and the device's, against 369-512
(median 376) with no profiler (H100 host), so the reading is about 20%
above the unprofiled launch. None where nothing was recorded (a program
without the span or the counter)."""

from osvos_torch.utils import profiling


def read(r):
    spans = getattr(profiling, "spans", None)
    totals = getattr(profiling, "totals", None)
    if r.kind != "infer" or spans is None or totals is None:
        return None
    real = totals().get("infer.frames_real", 0)
    ms = [s.host_ms for s in spans() if s.name == "infer.forward"]
    if not real or not ms:
        return None
    return sum(ms) / real
