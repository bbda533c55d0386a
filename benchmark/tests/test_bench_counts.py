"""The work counted from OSVOS VGG-16's shapes at DAVIS's 480x854."""

import pytest

from benchmark.lib import counts, peaks

STAGES = [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512], [512, 512, 512]]


def test_a_frames_forward_is_258_gflop():
    assert counts.forward_flops(STAGES, 16, 1, 480, 854) / 1e9 == pytest.approx(258.229, abs=1e-3)


def test_a_batch5_finetune_step_is_3866_tflop():
    flops = counts.step_flops(STAGES, 16, 5, 480, 854)
    assert flops / 1e12 == pytest.approx(3.8664, abs=1e-4)
    assert flops / peaks.BF16_FLOPS * 1e3 == pytest.approx(3.909, abs=1e-3)


def test_stage_sizes_round_up():
    assert counts.stage_hw(480, 854, 5) == [(480, 854), (240, 427), (120, 214),
                                            (60, 107), (30, 54)]


def test_bounds_take_the_larger_side():
    # the stem's weight gradient reads 274.7 MB and does little arithmetic
    stem = counts.trunk_convs(STAGES, 5, 480, 854)[0]
    assert counts._dk_bytes(stem) / 1e6 == pytest.approx(274.66, abs=0.01)
    assert peaks.bound_s(stem.flops, counts._dk_bytes(stem)) == pytest.approx(
        counts._dk_bytes(stem) / peaks.HBM_BYTES)
    one = counts.seq_wgrad_bound_s(STAGES, 5, 480, 854, 1)
    assert counts.seq_wgrad_bound_s(STAGES, 5, 480, 854, 20) == pytest.approx(20 * one)
