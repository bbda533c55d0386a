"""The control fails: on the card, at each cell's own size, on three seeds,
one precision below the configurations' bf16 in the program's place (the
training cells: the reference on int8 conv operands; serving: the
program's own int8 path), and for the training cells half of each batch
left out, read over the cell's limits on at least one number each. Marked ``cuda``: it skips without a card and runs on one with

    python -m pytest benchmark/tests/test_bench_control.py -m cuda
"""

import pytest
import torch

from benchmark.lib import registry

from .conftest import cells

SEEDS = (7001, 7002, 7003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", cells())
def test_the_control_and_the_faults_fail(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.tools.calibrate import readings

    limits = registry.limits(cell_name)
    for seed in SEEDS:
        out = readings(cell_name, seed, True, torch.device("cuda", 0))
        assert all(out["sound"][k] <= v for k, v in limits.items()), out
        for kind in ("control", "half_batch", "unchanged"):
            if kind in out:
                assert any(out[kind].get(k, 0) > v for k, v in limits.items()), (kind, out)
