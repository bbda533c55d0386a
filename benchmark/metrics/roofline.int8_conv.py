"""roofline.int8_conv: the int8 convs (I1, ``csrc/int8conv.cu``) against
their bound: each launch of the device window's pass bounded alone from its
shapes (``lib/counts_int8.int8_bound_s``: its int8 operations at 1979
TOP/s or its bytes at 3.35 TB/s, the larger) and summed, over the I1
group's device seconds there. The frames a launch ran are the pass's
``frames_run`` (the program's ``infer.frames_run``, the pad included) over
its calls, a call being one launch of each int8 conv. None where the window
ran no I1 kernel or the program counted no frames."""

from benchmark.lib import counts_int8
from benchmark.lib.groups import kernel_group

I1 = kernel_group("int8_conv3x3_q_kernel")


def read(r):
    if r.kind != "infer" or r.device is None:
        return None
    run = r.device["per"].get("frames_run")
    events = [(s, e) for name, s, e in r.device["events"] if kernel_group(name) == I1]
    if not run or not events:
        return None
    i = r.info
    convs = len(counts_int8.int8_convs(i["stages"], 1, i["h"], i["w"]))
    calls = len(events) / convs
    bound = calls * counts_int8.int8_bound_s(i["stages"], run / calls, i["h"], i["w"])
    return 100 * bound / (sum(e - s for s, e in events) / 1e6)
