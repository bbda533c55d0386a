"""DAVIS-2016 evaluation: J (region similarity) and F (boundary measure).

Counterpart of ``osvos_tpu/evaluation/davis_j.py``, the same math with
``scipy.ndimage.binary_dilation`` in place of OpenCV's dilation.

- J = IoU(pred, gt) per frame; a sequence's J-mean averages frames 1..N-2
  (the annotated first frame and the last frame are excluded, as in the
  official DAVIS-2016 benchmark code).
- F = boundary F-measure: boundary pixels matched within 0.8% of the image
  diagonal (dilation by a disk), F = 2PR / (P + R).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
from scipy.ndimage import binary_dilation


def db_eval_iou(annotation: np.ndarray, segmentation: np.ndarray) -> float:
    """Jaccard index between binary masks; 1.0 when both are empty."""
    ann = np.asarray(annotation) > 0.5
    seg = np.asarray(segmentation) > 0.5
    union = float(np.count_nonzero(ann | seg))
    if union == 0.0:
        return 1.0
    return float(np.count_nonzero(ann & seg)) / union


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Boundary map with the official benchmark's half-pixel convention: a
    pixel is boundary iff its value differs from its east, south or
    southeast neighbour, the last row and column compared in bounds only."""
    seg = np.asarray(seg) > 0.5
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def boundary_f_measure(annotation: np.ndarray, segmentation: np.ndarray,
                       bound_th: float = 0.008) -> float:
    """Official-protocol boundary F: precision and recall of ``seg2bmap``
    boundary pixels matched within ``ceil(bound_th * diagonal)`` pixels by
    a Euclidean disk (x^2 + y^2 <= r^2). bound_th >= 1 is an absolute
    radius in pixels."""
    fg = seg2bmap(segmentation)
    gt = seg2bmap(annotation)
    h, w = fg.shape
    radius = int(bound_th) if bound_th >= 1 else int(
        np.ceil(bound_th * np.sqrt(h * h + w * w)))
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = xx * xx + yy * yy <= radius * radius
    fg_dil = binary_dilation(fg, structure=disk)
    gt_dil = binary_dilation(gt, structure=disk)

    n_fg = fg.sum()
    n_gt = gt.sum()
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0  # official: (P, R) = (1, 0) or (0, 1) -> F = 0
    precision = float((fg & gt_dil).sum()) / n_fg
    recall = float((gt & fg_dil).sum()) / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def evaluate_sequence(annotations: Sequence[np.ndarray],
                      segmentations: Sequence[np.ndarray],
                      exclude_first: bool = True,
                      exclude_last: bool = True,
                      compute_f: bool = True) -> Dict[str, float]:
    """Per-sequence J and F means over the evaluated frame range."""
    n = len(annotations)
    if n != len(segmentations):
        raise ValueError(f"{n} annotations but {len(segmentations)} "
                         "segmentations")
    start = 1 if (exclude_first and n > 2) else 0
    stop = n - 1 if (exclude_last and n > 2) else n
    js, fs = [], []
    for i in range(start, stop):
        js.append(db_eval_iou(annotations[i], segmentations[i]))
        if compute_f:
            fs.append(boundary_f_measure(annotations[i], segmentations[i]))
    out = {"J_mean": float(np.mean(js)) if js else float("nan")}
    if compute_f:
        out["F_mean"] = float(np.mean(fs)) if fs else float("nan")
    return out
