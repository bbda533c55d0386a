"""int8.static_conv_pct: the share of the int8 convs run on a static scale:
100 x ``int8.convs_static`` (the scale from ``act_scales`` or the model's
calibrated ``int8_scales``) over it and ``int8.convs_dynamic`` (the scale
from the input's own max), counted by ``OSVOS`` in a traced run's profiled
windows. A calibrated deployment reads 100. None where nothing was counted
(a program without the counters)."""

from osvos_torch.utils import profiling


def read(r):
    totals = getattr(profiling, "totals", None)
    if r.kind != "infer" or totals is None:
        return None
    counted = totals()
    static = counted.get("int8.convs_static", 0)
    total = static + counted.get("int8.convs_dynamic", 0)
    if not total:
        return None
    return 100 * static / total
