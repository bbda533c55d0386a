"""device.idle_pct.infer: the share of the timed window in which no kernel
ran on the card: the kernels' busy seconds a unit of work, from the
device-profiled window, times the units of the timed window, over its
seconds. Kernel times do not stretch under the profiler's host cost; the
copies' do (a pageable copy waits on the host's staging), so copies count
as idle here and have a metric of their own where they matter. The
profiled window's own busy share reads idler: the profiler slows the host
that launches the work."""


def read(r):
    if r.kind != "infer" or r.device is None:
        return None
    busy_per_unit = r.device["kernel_busy_s"] / r.device["per"]["work"]
    work = sum(w for w, _ in r.window["units"])
    return 100 * (1 - busy_per_unit * work / r.window["seconds"])
