"""finetune.optimizer_ms_per_step: the card's ms a packed step in
``step.optimizer``, SGD's update of the stacked parameters, then the
zeroing of the gradients the next step accumulates into. Each such span's
two CUDA events bound its interval on the card's clock: their sum over the
spans recorded in a traced run's profiled windows, over the packed steps
recorded there (one ``step.draw`` a step). The launch queue runs ahead of
the card in this cell, so an interval is the card's time on the phase;
where the host paced a phase, its idle time would count too. The profiler
moves the phases by up to 2% (H100: forward 157.5 ms a step and backward
183.8 under it, 157.0 and 187.3 with no profiler). None where nothing was
recorded: on the CPU (no CUDA event), or in a program without the span."""

from osvos_torch.utils import profiling


def read(r):
    spans = getattr(profiling, "spans", None)
    if r.kind != "finetune" or spans is None:
        return None
    recorded = spans()
    steps = sum(1 for s in recorded if s.name == "step.draw")
    ms = [s.device_ms for s in recorded if s.name == "step.optimizer"]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
