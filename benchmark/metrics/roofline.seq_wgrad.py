"""roofline.seq_wgrad: the packed schedule's sequence launches
(``wgrad3x3_seq``, B17's, and ``stem_wgrad_seq``, B16's) against their
bound: the dK of every trunk conv for S sequences from its shapes
(lib/counts.seq_wgrad_bound_s) over their device time a packed step in the
profiled window. Nothing to read outside a packed cell."""

from benchmark.lib import counts
from benchmark.lib.groups import SEQ_WGRAD
from benchmark.lib.trace import group_seconds


def read(r):
    if r.kind != "finetune" or r.info["sequences"] < 2 or r.device is None:
        return None
    groups = group_seconds(r.device["events"])
    seconds = sum(groups.get(g, 0.0) for g in SEQ_WGRAD)
    if not seconds:
        return None
    i = r.info
    packed_steps = r.device["per"]["steps"] / i["sequences"]
    bound = counts.seq_wgrad_bound_s(i["stages"], i["batch"], i["h"], i["w"],
                                     i["sequences"])
    return 100 * bound / (seconds / packed_steps)
