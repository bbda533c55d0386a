"""The port's parent-training transforms against the JAX package's (OpenCV).

Each transform of ``osvos_torch/data/transforms.py`` and the JAX package's
counterpart take the same sample and a ``random.Random`` of the same seed.
They must draw the same numbers (the generators end in the same state) and
give, on the 0-255 scale of the caffe-mean-subtracted BGR images:

- flips and ``ToArray``: equal arrays;
- ``ScaleNRotate``: images within 1e-3 absolute (measured over these
  cases: 2.2e-4 at most, on noise at 480x854; float32 sums in another
  order) and gts equal on all but 1e-3 of the pixels (measured: all equal
  here; other draws differ on up to 4e-5 of them, where a source point lies
  within float32 rounding of a pixel boundary);
- ``Resize``: images within 1e-3 (measured: 5.4e-5 at most) and gts equal
  on all but 1e-3 of the pixels (measured: all equal); the same size
  returns an exact copy.
"""

import random

import numpy as np
import pytest

from osvos_tpu.data import transforms as jax_tf
from osvos_torch.configs import MEANVAL_BGR
from osvos_torch.data import transforms as port_tf
from osvos_torch.data.synthetic import SyntheticDAVIS, _frame

IMAGE_ATOL = 1e-3
GT_SHARE = 1e-3
SIZES = [(33, 49), (96, 160), (480, 854)]


def _sample(hw, seed=0, noise=False):
    img, mask = _frame(*hw, t=0.9, seed=seed)
    image = img[..., ::-1].astype(np.float32) - np.asarray(MEANVAL_BGR, np.float32)
    if noise:  # a worst case for resampling: neighbours far apart
        image = (np.random.RandomState(seed).rand(*hw, 3) * 255 - 120).astype(np.float32)
    return {"image": np.ascontiguousarray(image),
            "gt": (mask > 0).astype(np.float32), "fname": "seq/00000"}


def _both(make, sample, seed):
    """(port output, JAX output) of one transform with the same draws; the
    two generators must end in the same state."""
    outs, rngs = [], []
    for mod in (port_tf, jax_tf):
        rng = random.Random(seed)
        outs.append(make(mod, rng)({k: (v.copy() if isinstance(v, np.ndarray)
                                        else v) for k, v in sample.items()}))
        rngs.append(rng.random())
    assert rngs[0] == rngs[1], "the transforms drew different numbers"
    return outs


def _close(got, want):
    assert got.keys() == want.keys() and got["fname"] == want["fname"]
    assert got["image"].shape == want["image"].shape
    assert got["gt"].shape == want["gt"].shape
    assert got["image"].dtype == got["gt"].dtype == np.float32
    err = float(np.abs(got["image"] - want["image"]).max())
    share = float((got["gt"] != want["gt"]).mean())
    assert err <= IMAGE_ATOL, err
    assert share <= GT_SHARE, share
    return err, share


@pytest.mark.parametrize("seed", range(4))
def test_flip_matches_jax(seed):
    got, want = _both(lambda m, r: m.RandomHorizontalFlip(0.5, rng=r),
                      _sample((33, 49)), seed)
    for k in ("image", "gt"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("hw", SIZES)
def test_scale_n_rotate_matches_jax(hw, noise):
    for seed in range(3):
        got, want = _both(lambda m, r: m.ScaleNRotate((-30, 30), (0.75, 1.25),
                                                      rng=r),
                          _sample(hw, seed, noise), seed)
        _close(got, want)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("src,dst", [((480, 854), (96, 160)),
                                     ((96, 160), (480, 854)),
                                     ((33, 49), (40, 64)),
                                     ((100, 100), (37, 51))])
def test_resize_matches_jax(src, dst, noise):
    got, want = _both(lambda m, r: m.Resize(dst), _sample(src, 1, noise), 0)
    _close(got, want)


@pytest.mark.parametrize("hw", SIZES)
def test_resize_to_the_same_size_is_exact(hw):
    sample = _sample(hw, 2, noise=True)
    got, want = _both(lambda m, r: m.Resize(hw), sample, 0)
    for k in ("image", "gt"):
        np.testing.assert_array_equal(got[k], sample[k])
        np.testing.assert_array_equal(want[k], sample[k])


@pytest.mark.parametrize("hw,size", [((480, 854), (480, 854)),
                                     ((120, 200), (96, 160))])
def test_training_composition_matches_jax(hw, size):
    """The parent pipeline's chain: flip, ScaleNRotate, Resize, ToArray."""
    def make(m, r):
        return m.Compose([m.RandomHorizontalFlip(0.5, rng=r),
                          m.ScaleNRotate((-30, 30), (0.75, 1.25), rng=r),
                          m.Resize(size), m.ToArray()])
    for seed in range(3):
        got, want = _both(make, _sample(hw, seed), seed)
        _close(got, want)
        assert got["gt"].shape == size + (1,)


def test_to_array_matches_jax():
    got, want = _both(lambda m, r: m.ToArray(), _sample((33, 49)), 0)
    for k in ("image", "gt"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].flags["C_CONTIGUOUS"]


def test_synthetic_dataset_returns_davis_samples():
    """``SyntheticDAVIS`` returns ``DAVIS2016.__getitem__``'s structure:
    BGR minus the caffe mean, {0, 1} gts, disjoint train and val frames."""
    train = SyntheticDAVIS(3, (33, 49))
    val = SyntheticDAVIS(2, (33, 49), train=False)
    s = train[1]
    assert s["image"].shape == (33, 49, 3) and s["image"].dtype == np.float32
    assert set(np.unique(s["gt"])) == {0.0, 1.0}
    assert 0.05 < s["gt"].mean() < 0.5
    img, _ = _frame(33, 49, t=0.7, seed=1)
    np.testing.assert_allclose(s["image"] + np.asarray(MEANVAL_BGR, np.float32),
                               img[..., ::-1], atol=1e-4)
    assert not np.array_equal(val[1]["image"], s["image"])
    assert len(train) == 3 and len(val) == 2
    with pytest.raises(IndexError):
        train[3]
