"""The port's small helpers (``data/helpers.py``) and tracing
(``utils/profiling.py``) against the JAX package's, on the CPU.

The helpers are numpy in both packages, so they must agree exactly on the
same seeded inputs. The profiling module wraps a different profiler; what
it must keep is the phase timer's accounting and report, and a trace file
where one is asked for.
"""

import json
import os

import numpy as np
import pytest

from osvos_torch.data import helpers
from osvos_torch.utils import profiling
from osvos_tpu.data import helpers as jax_helpers


@pytest.mark.parametrize("shape", [(1, 9, 13, 3), (9, 13, 3), (1, 9, 13, 1),
                                   (9, 13, 1), (9, 13)])
def test_tens2image_matches_jax(shape):
    a = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got, want = helpers.tens2image(a), jax_helpers.tens2image(a)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [0.0, 1.0, 255.0])
def test_im_normalize_matches_jax(scale):
    a = np.random.RandomState(1).rand(7, 11, 3) * scale + 3.0
    np.testing.assert_array_equal(helpers.im_normalize(a),
                                  jax_helpers.im_normalize(a))


@pytest.mark.parametrize("color,alpha", [((255, 0, 0), 0.5), ((0, 40, 200), 0.3)])
def test_overlay_mask_matches_jax(color, alpha):
    rng = np.random.RandomState(2)
    im = rng.randint(0, 256, (17, 29, 3)).astype(np.uint8)
    ma = (rng.rand(17, 29) > 0.6).astype(np.float32)
    got = helpers.overlay_mask(im, ma, color, alpha)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_helpers.overlay_mask(im, ma, color, alpha))


def test_construct_name_matches_jax():
    p = {"lr": 1e-8, "wd": 0.0002, "epochs": 240, "arch": "vgg16"}
    assert helpers.construct_name(p, "OSVOS") == jax_helpers.construct_name(p, "OSVOS")


def test_phase_timer_accumulates_and_reports():
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("a"):
            pass
    with timer.phase("b", sync=True):
        sum(range(1000))
    assert timer.counts == {"a": 3, "b": 1}
    report = timer.report()
    assert set(report) == {"a", "b"}
    assert set(report["a"]) == {"total_s", "mean_s", "count"}
    assert report["a"]["count"] == 3 and report["b"]["total_s"] >= 0


def test_device_trace_writes_a_trace(tmp_path):
    import torch

    with profiling.device_trace(None):  # no directory: no trace
        pass
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir), profiling.annotate("fine_tune/x"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "fine_tune/x" for e in events)
