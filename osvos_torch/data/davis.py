"""DAVIS-2016 dataset index and loader, and batching of its samples.

Counterpart of ``osvos_tpu/data/davis.py`` (reference:
``dataloaders/davis_2016.py``), with the same semantics:

- ``train=True`` without ``seq_name``: every (frame, annotation) pair of the
  train split. With ``seq_name``: only the first annotated frame of that
  sequence, the one-shot fine-tuning set.
- ``train=False`` with ``seq_name``: all frames of the sequence; only frame
  0 has its annotation, the others get all-zero gts.
- Images load as BGR float32 minus the caffe mean, gts as float32 divided
  by their maximum ({0, 1} for DAVIS's 0/255 masks).
- ``input_res`` resizes as ``cv2.resize`` does: bilinear for the image (in
  float32 on the uint8 values, rounded back to uint8: within one code of
  OpenCV's fixed-point arithmetic), nearest for the annotation.
- Split files: ``<db_root>/train_seqs.txt`` / ``val_seqs.txt``, then the
  official ``ImageSets/<year>/{train,val}.txt``, then, for 2016, the copies
  of the standard splits shipped in ``data/splits/``.

Frames and annotations are read by ``data/image_io`` (no OpenCV).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from osvos_torch.configs import DataConfig, PathConfig
from osvos_torch.data.image_io import imread
from osvos_torch.data.transforms import resize

_SPLITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "splits")


def read_split(db_root: str, train: bool, year: str = "2016") -> List[str]:
    """The sequence names of the train or val split under ``db_root``."""
    fname = "train_seqs.txt" if train else "val_seqs.txt"
    ref_style = os.path.join(db_root, fname)
    if os.path.exists(ref_style):
        with open(ref_style) as f:
            return [ln.strip() for ln in f if ln.strip()]
    official = os.path.join(db_root, "ImageSets", year,
                            "train.txt" if train else "val.txt")
    if os.path.exists(official):
        with open(official) as f:
            # official 2016 files may list per-frame paths; collapse to seqs
            seqs: List[str] = []
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                name = ln.split("/")[-2] if "/" in ln else ln
                if name not in seqs:
                    seqs.append(name)
            return seqs
    if year == "2016":
        packaged = os.path.join(_SPLITS, fname)
        if os.path.exists(packaged):
            with open(packaged) as f:
                return [ln.strip() for ln in f if ln.strip()]
    raise FileNotFoundError(f"no split file at {ref_style} or {official}")


def _resize_u8(img: np.ndarray, size: Tuple[int, int],
               nearest: bool) -> np.ndarray:
    """``cv2.resize`` of a uint8 image to ``size`` = (h, w)."""
    out = resize(img.astype(np.float32), size, nearest=nearest,
                 bilinear=not nearest)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class DAVIS2016:
    """Indexable DAVIS-2016 dataset with the reference's semantics."""

    def __init__(self, train: bool = True, db_root_dir: Optional[str] = None,
                 transform=None, seq_name: Optional[str] = None,
                 input_res: Optional[Tuple[int, int]] = None,
                 data_config: DataConfig = DataConfig()):
        self.train = train
        self.db_root_dir = db_root_dir or PathConfig().db_root_dir
        self.transform = transform
        self.seq_name = seq_name
        self.input_res = input_res or data_config.input_res
        self.meanval = np.asarray(data_config.meanval, np.float32)
        self.resolution = data_config.resolution

        img_dir = os.path.join(self.db_root_dir, "JPEGImages", self.resolution)
        ann_dir = os.path.join(self.db_root_dir, "Annotations", self.resolution)

        def rel(kind: str, seq: str, f: str) -> str:
            return os.path.join(kind, self.resolution, seq, f)

        img_list: List[str] = []
        labels: List[Optional[str]] = []
        if seq_name is None:
            for seq in read_split(self.db_root_dir, train, data_config.year):
                frames = sorted(os.listdir(os.path.join(img_dir, seq)))
                anns = sorted(os.listdir(os.path.join(ann_dir, seq)))
                img_list += [rel("JPEGImages", seq, f) for f in frames]
                labels += [rel("Annotations", seq, f) for f in anns]
                if len(img_list) != len(labels):
                    raise ValueError(f"{seq}: {len(frames)} frames but "
                                     f"{len(anns)} annotations")
        else:
            frames = sorted(os.listdir(os.path.join(img_dir, seq_name)))
            anns = sorted(os.listdir(os.path.join(ann_dir, seq_name)))
            if train:  # the one-shot set: the first annotated frame only
                img_list = [rel("JPEGImages", seq_name, frames[0])]
                labels = [rel("Annotations", seq_name, anns[0])]
            else:
                img_list = [rel("JPEGImages", seq_name, f) for f in frames]
                labels = ([rel("Annotations", seq_name, anns[0])]
                          + [None] * (len(frames) - 1))
        self.img_list = img_list
        self.labels = labels
        self.seqs_in_split = (None if seq_name else
                              read_split(self.db_root_dir, train,
                                         data_config.year))

    def __len__(self) -> int:
        return len(self.img_list)

    def make_img_gt_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(image, gt) as float32 arrays: image = BGR - meanval, (H, W, 3);
        gt = label / max(label), (H, W), zeros if unannotated."""
        img = imread(os.path.join(self.db_root_dir, self.img_list[idx]))
        label = None
        if self.labels[idx] is not None:
            label = imread(os.path.join(self.db_root_dir, self.labels[idx]),
                           gray=True)
        if self.input_res is not None:
            img = _resize_u8(img, self.input_res, nearest=False)
            if label is not None:
                label = _resize_u8(label, self.input_res, nearest=True)
        image = img.astype(np.float32) - self.meanval
        if label is None:
            return image, np.zeros(image.shape[:2], np.float32)
        gt = label.astype(np.float32)
        return image, gt / max(float(gt.max()), 1e-8)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        img, gt = self.make_img_gt_pair(idx)
        sample: Dict[str, object] = {"image": img, "gt": gt}
        if self.seq_name is not None:
            fname = os.path.join(self.seq_name,
                                 os.path.basename(self.img_list[idx]))
            sample["fname"] = os.path.splitext(fname)[0]
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def get_img_size(self) -> Tuple[int, int]:
        return imread(os.path.join(self.db_root_dir, self.img_list[0])).shape[:2]

    def sequence_frames(self, seq_name: str) -> List[str]:
        return sorted(os.listdir(os.path.join(
            self.db_root_dir, "JPEGImages", self.resolution, seq_name)))


def iterate_batches(dataset: Sequence, batch_size: int, shuffle: bool,
                    rng: np.random.RandomState) -> Iterator[Dict[str, np.ndarray]]:
    """Stack same-shape samples into batches of ``batch_size`` (the last
    one may be smaller), in an order shuffled by ``rng``."""
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        samples = [dataset[int(i)] for i in order[start:start + batch_size]]
        yield {"image": np.stack([s["image"] for s in samples]),
               "gt": np.stack([s["gt"] for s in samples])}
