"""int8.calibrate_ms_per_frame: the card's ms a real frame in the int8
calibration (``models/quantize``'s span ``int8.calibrate``, on the device's
clock: a bf16 trunk over each sequence's first frame), summed over a
traced run's two profiled windows (a calibration and a pass each), over
the ``infer.frames_real`` counted there. None where nothing was recorded
(a program without the span, the counter or a card)."""

from osvos_torch.utils import profiling


def read(r):
    spans = getattr(profiling, "spans", None)
    totals = getattr(profiling, "totals", None)
    if r.kind != "infer" or spans is None or totals is None:
        return None
    real = totals().get("infer.frames_real", 0)
    ms = [s.device_ms for s in spans() if s.name == "int8.calibrate"]
    if not real or not ms or None in ms:
        return None
    return sum(ms) / real
