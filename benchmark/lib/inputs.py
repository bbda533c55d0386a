"""The benchmark's inputs, made on the device from ``--seed``.

Weights, frames, masks, augmentation pools and draws come from here and are
handed to the program and to the reference alike; the program makes none
of them. Every stream has its own ``torch.Generator`` on the device, seeded
from the run's seed and the stream's name, so one seed gives the same
inputs in every run, and large seeds (beyond 32 bits) are taken whole.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

# BGR means of the Caffe-era preprocessing (OSVOS-PyTorch's meanval)
MEANVAL_BGR = (104.00699, 116.66877, 122.67892)
# weight scales: He at the trunk (ReLU follows), a unit gain at the side
# convs, and heads small enough that the fine-tune's first step at the
# published lr (1e-8 on a loss summed over every pixel) lowers the loss by a
# few percent, as a trained parent's does, and not by more than the loss
# itself: with heads ten times larger the first update overshoots at
# 480x854 and the later steps amplify any rounding (PERF.md)
SIDE_GAIN = 1.0
HEAD_STD = {"score_dsn": 0.0005, "fuse": 0.0005}
BIAS_STD = 0.01


def generator(seed: int, stream: str, device) -> torch.Generator:
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


def param_shapes(stages: Sequence[Sequence[int]], side_channels: int
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, named as the published model's
    modules in the JAX package's order (trunk, then per side the side conv
    and its score head, then fuse): weights OIHW."""
    out, c = [], 3
    for i, widths in enumerate(stages):
        for j, d in enumerate(widths):
            out += [(f"stage{i + 1}_conv{j}.weight", (d, c, 3, 3)),
                    (f"stage{i + 1}_conv{j}.bias", (d,))]
            c = d
    n_sides = len(stages) - 1
    for i in range(1, n_sides + 1):
        out += [(f"side_prep{i}.weight", (side_channels, stages[i][-1], 3, 3)),
                (f"side_prep{i}.bias", (side_channels,)),
                (f"score_dsn{i}.weight", (1, side_channels, 1, 1)),
                (f"score_dsn{i}.bias", (1,))]
    out += [("fuse.weight", (1, n_sides * side_channels, 1, 1)),
            ("fuse.bias", (1,))]
    return out


def _std(name: str, shape) -> float:
    if name.endswith(".bias"):
        return BIAS_STD
    module = name.split(".")[0].rstrip("0123456789")
    if module in HEAD_STD:
        return HEAD_STD[module]
    fan_in = shape[1] * shape[2] * shape[3]
    gain = 2.0 if module.startswith("stage") else SIDE_GAIN
    return math.sqrt(gain / fan_in)


def make_params(stages, side_channels: int, seed: int, device, copies: int = 1,
                stream: str = "weights") -> Dict[str, torch.Tensor]:
    """float32 parameters from one normal draw on ``device`` (one call for
    all leaves), each leaf scaled by its std; with ``copies`` > 1 each leaf
    has a leading axis of that many independent sets."""
    shapes = param_shapes(stages, side_channels)
    sizes = [math.prod(s) for _, s in shapes]
    flat = torch.randn((copies, sum(sizes)), generator=generator(seed, stream, device),
                       device=device)
    out = {}
    for (name, shape), part in zip(shapes, flat.split(sizes, dim=1)):
        leaf = part.mul_(_std(name, shape)).reshape((copies,) + shape)
        out[name] = leaf[0] if copies == 1 else leaf
    return out


def make_frames(n: int, h: int, w: int, seed: int, device, stream: str = "frames"
                ) -> torch.Tensor:
    """(n, H, W, 3) float32 preprocessed frames (BGR minus the means): a
    smooth random scene (bicubic from a 1/16 grid) with fine noise, clipped
    to [0, 255] before the means are taken off."""
    gen = generator(seed, stream, device)
    coarse = torch.rand((n, 3, -(-h // 16) + 1, -(-w // 16) + 1), generator=gen,
                        device=device) * 255
    img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    img = img + torch.randn((n, 3, h, w), generator=gen, device=device) * 8
    img = img.clamp_(0, 255) - torch.tensor(MEANVAL_BGR, device=device)[:, None, None]
    return img.permute(0, 2, 3, 1).contiguous()


def make_masks(n: int, h: int, w: int, seed: int, device, stream: str = "masks"
               ) -> torch.Tensor:
    """(n, H, W, 1) float32 masks in {0, 1}: an ellipse a frame, its centre
    within the middle half and its half-axes 12-30% of the frame's."""
    gen = generator(seed, stream, device)
    u = torch.rand((n, 4), generator=gen, device=device, dtype=torch.float64)
    cy, cx = (0.25 + 0.5 * u[:, 0]) * h, (0.25 + 0.5 * u[:, 1]) * w
    ay, ax = (0.12 + 0.18 * u[:, 2]) * h, (0.12 + 0.18 * u[:, 3]) * w
    yy = torch.arange(h, device=device, dtype=torch.float64)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float64)[None, None, :]
    inside = (((yy - cy[:, None, None]) / ay[:, None, None]) ** 2
              + ((xx - cx[:, None, None]) / ax[:, None, None]) ** 2) <= 1
    return inside.float()[..., None]


def warp_pool(image: torch.Tensor, mask: torch.Tensor, pool: int, seed: int,
              rots=(-30.0, 30.0), scales=(0.75, 1.25), stream: str = "pool"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The augmentation pool of one (H, W, 3) frame and its (H, W, 1) mask:
    (pool, H, W, 3) and (pool, H, W, 1) float32 on their device. Entry 0 is
    the pair itself; each other entry rotates it by an angle ~ U(rots)
    degrees and scales it by ~ U(scales) about the frame's centre, as
    OSVOS's ScaleNRotate (cv2.getRotationMatrix2D, warpAffine: bicubic
    image, nearest mask, zeros outside)."""
    device = image.device
    h, w = image.shape[:2]
    gen = generator(seed, stream, device)
    u = torch.rand((pool - 1, 2), generator=gen, device=device, dtype=torch.float64)
    angle = torch.deg2rad(rots[0] + (rots[1] - rots[0]) * u[:, 0])
    scale = scales[0] + (scales[1] - scales[0]) * u[:, 1]
    # output pixel -> source pixel: the inverse of a rotation by +angle
    # (counter-clockwise on screen, y down) and a scale about the centre
    cy, cx = (h - 1) / 2, (w - 1) / 2
    yy = torch.arange(h, device=device, dtype=torch.float64)[:, None] - cy
    xx = torch.arange(w, device=device, dtype=torch.float64)[None, :] - cx
    cos, sin = (torch.cos(angle) / scale)[:, None, None], (torch.sin(angle) / scale)[:, None, None]
    src_x = cos * xx - sin * yy + cx
    src_y = sin * xx + cos * yy + cy
    grid = torch.stack([(2 * src_x + 1) / w - 1, (2 * src_y + 1) / h - 1], dim=-1)
    grid = grid.float()
    img = image.permute(2, 0, 1)[None].expand(pool - 1, -1, -1, -1)
    msk = mask.permute(2, 0, 1)[None].expand(pool - 1, -1, -1, -1)
    imgs = F.grid_sample(img, grid, mode="bicubic", padding_mode="zeros",
                         align_corners=False)
    msks = F.grid_sample(msk, grid, mode="nearest", padding_mode="zeros",
                         align_corners=False)
    imgs = torch.cat([image[None], imgs.permute(0, 2, 3, 1)])
    msks = torch.cat([mask[None], msks.permute(0, 2, 3, 1)])
    return imgs.contiguous(), msks.contiguous()


def first_rows(steps: int, batch: int, pool: int, seed: int, device,
               stream: str = "first") -> torch.Tensor:
    """(steps, batch) int64 pool entries, all different: the checked
    steps' samples."""
    if steps * batch > pool:
        raise ValueError(f"{steps} x {batch} distinct rows from a pool of {pool}")
    perm = torch.randperm(pool, generator=generator(seed, stream, device),
                          device=device)
    return perm[:steps * batch].view(steps, batch)


def random_rows(steps: int, batch: int, pool: int, seed: int, device,
                stream: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(steps, batch) pool entries ~ U{0..pool-1} and flips ~ Bernoulli(0.5)."""
    gen = generator(seed, stream, device)
    index = torch.randint(0, pool, (steps, batch), generator=gen, device=device)
    flip = torch.rand((steps, batch), generator=gen, device=device) < 0.5
    return index, flip
