"""Shared helpers of the benchmark's CPU tests: one torch thread, and each
cell's configuration and traffic cut to a size the CPU runs in seconds
(the --tiny widths of the port's own tests, a 33x49 frame, small pools
and short chunks)."""

import copy

import pytest
import torch

from benchmark.lib import registry

TINY_STAGES = [[8, 8], [12, 12], [16, 16, 16], [16, 16, 16], [16, 16, 16]]
SEED = 2 ** 31 + 12345  # beyond 32 signed bits: seeds are taken whole


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny(cell_name: str):
    """(config, traffic) of ``cell_name`` at the tiny size."""
    cell = registry.cell(cell_name)
    cfg = copy.deepcopy(registry.config(cell["config"]))
    tr = copy.deepcopy(registry.traffic(cell["traffic"]))
    cfg.update(stages=TINY_STAGES, side_channels=8, input_hw=[33, 49])
    cfg["online"]["scan_chunk"] = 2
    small = {"packed": dict(sequences=3, pool=16, chunk_steps=2, warm_steps=1,
                            checked_sequences=2, profile_steps=1, gap_steps=1),
             "infer": dict(lengths=[3, 5, 2], distinct_frames=2, warm_frames=1)}
    tr.update(small[tr["driver"]])
    return cfg, tr


def cells():
    return [w["name"] for w in registry.spec()["workloads"]]
