"""Batching of DAVIS-2016 samples.

Counterpart of ``osvos_tpu/data/davis.py``, so far only ``iterate_batches``.
The on-disk ``DAVIS2016`` reader comes with ROADMAP.md A.3 (its frames are
JPEGs, and the card's machine has no decoder); until then parent training
runs on ``data/synthetic.SyntheticDAVIS``, which returns the same samples.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np


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
