"""infer.host_frames_per_s: real (unpadded) frames whose maps reached the
host, over the seconds of the unprofiled window: the throughput a user of
``batched_infer`` sees. The host paces it (the numpy buffer fill and the
pageable copies serialise with the forward), so it follows the host's
load and is read here, beside the card's own cost a frame."""


def read(r):
    if r.kind != "infer":
        return None
    frames = sum(w for w, _ in r.window["units"])
    return frames / r.window["seconds"]
