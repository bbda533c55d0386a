"""Device-side geometric augmentation (ScaleNRotate and horizontal flip).

Counterpart of ``osvos_tpu/ops/warp.py``. The reference augments on the host
with OpenCV (``ScaleNRotate``: rot ~ U(rots), sc ~ U(scales),
``cv2.getRotationMatrix2D`` about the image center, ``warpAffine`` with
INTER_CUBIC for images and INTER_NEAREST for masks, zero border). Here the
same map runs on the tensors' device: inverse-affine resampling about the
center with the same matrix, the cubic kernel with a = -0.75 as OpenCV's
INTER_CUBIC, and zeros outside the image.

Random draws come from an explicit ``torch.Generator``
(``draw_scale_n_rotate``) and are applied by ``apply_scale_n_rotate``, so a
test can feed the JAX package's draws to the port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def rotation_scale_matrix(angle_deg: torch.Tensor, scale: torch.Tensor,
                          center: Tuple[float, float]) -> torch.Tensor:
    """cv2.getRotationMatrix2D-compatible (2, 3) float32 affine (src -> dst)
    for scalar tensors ``angle_deg`` and ``scale``."""
    a = torch.deg2rad(angle_deg.float())
    alpha = scale.float() * torch.cos(a)
    beta = scale.float() * torch.sin(a)
    cx, cy = center
    return torch.stack([
        torch.stack([alpha, beta, (1 - alpha) * cx - beta * cy]),
        torch.stack([-beta, alpha, beta * cx + (1 - alpha) * cy])])


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    a, b, tx = m[0, 0], m[0, 1], m[0, 2]
    c, d, ty = m[1, 0], m[1, 1], m[1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    return torch.stack([
        torch.stack([ia, ib, -(ia * tx + ib * ty)]),
        torch.stack([ic, id_, -(ic * tx + id_ * ty)])])


def _cubic_weights(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Cubic convolution weights of the 4 taps at offsets (-1, 0, 1, 2) from
    the floor sample, for fractional positions t in [0, 1); t.shape + (4,)."""
    d = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t], dim=-1)
    d2, d3 = d * d, d * d * d
    near = (a + 2.0) * d3 - (a + 3.0) * d2 + 1.0          # |d| <= 1
    far = a * d3 - 5.0 * a * d2 + 8.0 * a * d - 4.0 * a   # 1 < |d| < 2
    return torch.where(d <= 1.0, near, far)


def _gather_hw(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img[y, x, :] for (H, W) index maps, zero outside the image."""
    h, w = img.shape[0], img.shape[1]
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    vals = img[ys.clamp(0, h - 1), xs.clamp(0, w - 1)]
    return torch.where(inside[..., None], vals, 0.0)


def warp_affine(img: torch.Tensor, matrix: torch.Tensor,
                interp: str = "cubic") -> torch.Tensor:
    """Apply a (2, 3) forward affine (cv2 convention) to HWC ``img``.

    interp: 'cubic' (INTER_CUBIC, a = -0.75), 'linear' or 'nearest'. Zero
    border; the output has the input's shape and dtype.
    """
    h, w = img.shape[0], img.shape[1]
    inv = _invert_affine(matrix.float())
    dst_y = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    dst_x = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    src_x = inv[0, 0] * dst_x + inv[0, 1] * dst_y + inv[0, 2]
    src_y = inv[1, 0] * dst_x + inv[1, 1] * dst_y + inv[1, 2]

    if interp == "nearest":
        ys = torch.floor(src_y + 0.5).long()
        xs = torch.floor(src_x + 0.5).long()
        return _gather_hw(img, ys, xs)

    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    ty, tx = src_y - y0, src_x - x0
    y0, x0 = y0.long(), x0.long()
    if interp == "linear":
        wy = torch.stack([1.0 - ty, ty], dim=-1)
        wx = torch.stack([1.0 - tx, tx], dim=-1)
        offs: Sequence[int] = (0, 1)
    elif interp == "cubic":
        wy, wx = _cubic_weights(ty), _cubic_weights(tx)
        offs = (-1, 0, 1, 2)
    else:
        raise ValueError(f"unknown interp {interp!r}")

    out = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for iy, oy in enumerate(offs):
        for ix, ox in enumerate(offs):
            tap = _gather_hw(img, y0 + oy, x0 + ox).float()
            out = out + tap * (wy[..., iy] * wx[..., ix])[..., None]
    return out.to(img.dtype)


def draw_scale_n_rotate(n: int, rots: Tuple[float, float] = (-30.0, 30.0),
                        scales: Tuple[float, float] = (0.75, 1.25),
                        hflip_prob: float = 0.5,
                        generator: Optional[torch.Generator] = None,
                        device: Optional[torch.device] = None):
    """n draws of (flip (bool), angle (degrees), scale), each a (n,) tensor
    made on the generator's device and moved to ``device``: flip with
    probability ``hflip_prob``, angle ~ U(rots), scale ~ U(scales)."""
    gen_device = generator.device if generator is not None else torch.device("cpu")
    u = torch.rand((3, n), generator=generator, device=gen_device)
    if device is not None:
        u = u.to(device)
    flip = u[0] < hflip_prob
    angle = rots[0] + u[1] * (rots[1] - rots[0])
    scale = scales[0] + u[2] * (scales[1] - scales[0])
    return flip, angle, scale


def apply_scale_n_rotate(image: torch.Tensor, mask: torch.Tensor,
                         flip: torch.Tensor, angle: torch.Tensor,
                         scale: torch.Tensor):
    """The reference's ``Compose([RandomHorizontalFlip(), ScaleNRotate()])``
    with given draws: flip (bool scalar tensor), angle (degrees) and scale.
    image (H, W, C) float, warped cubic; mask (H, W, 1), warped nearest."""
    image = torch.where(flip, image.flip(1), image)
    mask = torch.where(flip, mask.flip(1), mask)
    h, w = image.shape[0], image.shape[1]
    m = rotation_scale_matrix(angle, scale, (w / 2.0, h / 2.0))
    return warp_affine(image, m, "cubic"), warp_affine(mask, m, "nearest")


def scale_n_rotate(image: torch.Tensor, mask: torch.Tensor,
                   rots: Tuple[float, float] = (-30.0, 30.0),
                   scales: Tuple[float, float] = (0.75, 1.25),
                   hflip_prob: float = 0.5,
                   generator: Optional[torch.Generator] = None):
    """One random draw applied: (image', mask'). The same distribution as the
    JAX package's ``scale_n_rotate``, from ``generator``."""
    flip, angle, scale = draw_scale_n_rotate(1, rots, scales, hflip_prob,
                                             generator, image.device)
    return apply_scale_n_rotate(image, mask, flip[0], angle[0], scale[0])
