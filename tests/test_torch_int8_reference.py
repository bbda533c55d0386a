"""int8 serving against the benchmark's plain int8 reference
(``benchmark/reference/int8.py``), on the CPU at tiny widths.

- The port's ``batched_infer`` in ``compute_mode='int8'`` on the scales of
  ``calibrate_int8_scales_batched`` holds to the reference within the limits
  of the cell ``int8.infer_rank1of4``, through the cell's own driver; its
  calibration holds to the reference's within ``scale_gap``.
- The faults fail: each sequence run on the next one's scales reads over the
  cell's limits. The int7 control (the reference on codes -63..63 in the
  program's place) reads over the limits on the card, where they were set
  (``PERF.md``); at these widths every gap is smaller, so here it has to
  read at least 1.5 times the sound run's ``code_gap_mean`` on the same
  inputs (twice it on the card).
- The reference's int8 conv is an int64 loop over the taps, pixel by pixel.
"""

import copy

import pytest
import torch

from benchmark import run
from benchmark.lib import inputs, registry
from benchmark.reference import int8
from benchmark.tools.calibrate_int8 import readings
from osvos_torch.configs import ModelConfig
from osvos_torch.models.quantize import calibrate_int8_scales_batched

CELL = "int8.infer_rank1of4"
SEEDS = (2 ** 31 + 12345, 99)
# every int8 conv at 8 to 16 inputs; the second puts every conv after the
# stem on the Hopper kernel's shapes (Cin a multiple of 32, Cout of 64)
GEOMETRIES = {
    "tiny": dict(stages=[[8, 8], [12, 12], [16, 16, 16], [16, 16, 16], [16, 16, 16]],
                 side_channels=8, input_hw=[33, 49]),
    "hopper_shapes": dict(stages=[[8, 32], [64, 64], [64, 128, 64], [64, 64, 64],
                                  [64, 64, 64]], side_channels=8, input_hw=[33, 49]),
}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def shrunk(geometry: str):
    cell = registry.cell(CELL)
    cfg = copy.deepcopy(registry.config(cell["config"]))
    tr = copy.deepcopy(registry.traffic(cell["traffic"]))
    cfg.update(GEOMETRIES[geometry])
    tr.update(lengths=[3, 5, 2], distinct_frames=2, warm_frames=1)
    return cfg, tr


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_the_port_holds_to_the_reference_within_the_cells_limits(geometry, seed):
    result = run.execute(CELL, seed, 0.0, False, torch.device("cpu"), *shrunk(geometry))
    assert result["correct"], result["checks"]
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_the_reference_calibrates_as_the_port(geometry):
    g = GEOMETRIES[geometry]
    h, w = g["input_hw"]
    params = inputs.make_params(g["stages"], g["side_channels"], SEEDS[0], "cpu",
                                copies=3)
    first = inputs.make_frames(3, h, w, SEEDS[0], "cpu")
    mcfg = ModelConfig(stages=tuple(map(tuple, g["stages"])),
                       side_channels=g["side_channels"], compute_mode="int8")
    prog = calibrate_int8_scales_batched(params, first.numpy(), mcfg, margin=1.05)
    ref = torch.stack([int8.calibrate({k: v[i] for k, v in params.items()},
                                      first[i:i + 1], g["stages"], 1.05)
                       for i in range(3)])
    assert prog.shape == ref.shape == (3, sum(map(len, g["stages"])))
    gap = ((prog.double() - ref) / ref).abs()
    assert float(gap.max()) <= registry.limits(CELL)["scale_gap"]
    # the stem's entry is the frame's own max, in bf16 and in float32
    assert torch.allclose(ref[:, 0], first.abs().amax((1, 2, 3)).double() * 1.05)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_the_int7_control_and_the_wrong_scales_fail(geometry):
    limits = registry.limits(CELL)
    out = readings(CELL, SEEDS[0], True, torch.device("cpu"), *shrunk(geometry))
    assert all(out["sound"][k] <= v for k, v in limits.items())
    wrong = out["wrong_scales"]
    assert any(wrong[k] > v for k, v in limits.items()), wrong
    assert wrong["scale_gap"] > limits["scale_gap"]
    assert out["int7"]["code_gap_mean"] >= 1.5 * out["sound"]["code_gap_mean"]
    assert out["altered"]["code_gap_max"] > limits["code_gap_max"]


def test_the_int8_conv_is_an_int64_loop():
    gen = torch.Generator().manual_seed(3)
    n, c, d, h, w = 2, 8, 16, 5, 6
    x = torch.randn((n, c, h, w), generator=gen) * 40
    weight = torch.randn((d, c, 3, 3), generator=gen) * 0.1
    bias = torch.randn((d,), generator=gen)
    s = float(x.abs().max()) * 0.8  # a scale that clips some inputs
    y = int8.int_conv(x, weight, bias, s)

    x_s = s / 127
    w_s = [max(abs(float(v)) for v in weight[o].flatten()) / 127 for o in range(d)]

    def q(v: float, scale: float) -> int:
        return max(-127, min(127, round(v / scale)))  # half to even

    for (b, o, i, j) in [(0, 0, 0, 0), (1, 15, 4, 5), (0, 7, 2, 3), (1, 3, 0, 5)]:
        acc = 0
        for ci in range(c):
            for kh in range(3):
                for kw in range(3):
                    ii, jj = i + kh - 1, j + kw - 1
                    if 0 <= ii < h and 0 <= jj < w:
                        acc += (q(float(x[b, ci, ii, jj]), x_s)
                                * q(float(weight[o, ci, kh, kw]), w_s[o]))
        want = acc * (x_s * w_s[o]) + float(bias[o])  # float64, then float32
        assert float(y[b, o, i, j]) == float(torch.tensor(want, dtype=torch.float64).float())
