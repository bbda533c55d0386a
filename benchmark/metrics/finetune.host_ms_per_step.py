"""finetune.host_ms_per_step: the host's ms in the chunk call before its
synchronize, over the optimizer steps of the call (a packed step counts
once), in the unprofiled window: the loop's and the wrappers' host work.
Where it reaches the step's device time the host paces the card."""


def read(r):
    if r.kind != "finetune":
        return None
    host = sum(h for _, h in r.window["units"])
    steps = sum(w for w, _ in r.window["units"]) / r.info["sequences"]
    return 1e3 * host / steps
