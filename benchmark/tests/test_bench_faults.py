"""A run with the timed path broken underneath comes out not correct: once
for each fault its cell can have (a step that returns its state unchanged,
half of the batch left out with the mean taken over the rest, an answer
altered where it is produced). The cells run on one chip, so no exchange
between chips can be left out."""

import pytest
import torch

from benchmark import run

from .conftest import SEED, tiny

TRAINING = ["fast.packed20"]


def _run(cell_name):
    cfg, tr = tiny(cell_name)
    return run.execute(cell_name, SEED, 0.0, False, torch.device("cpu"), cfg, tr)


@pytest.mark.parametrize("cell_name", TRAINING)
def test_a_sound_run_reads_under_the_faults(cell_name):
    result = _run(cell_name)
    assert all(c["value"] < 0.5 for c in result["checks"].values())


@pytest.mark.parametrize("cell_name", TRAINING)
def test_a_step_that_leaves_the_state_unchanged(cell_name, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    result = _run(cell_name)
    assert not result["correct"]
    assert result["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell_name", TRAINING)
def test_half_the_batch_left_out(cell_name, monkeypatch):
    import osvos_torch.parallel.packed as packed

    real = packed.class_balanced_cross_entropy_loss_per_sample
    n = tiny(cell_name)[0]["online"]["n_ave_grad"]
    keep = n - n // 2

    def half(out, labels, impl="xla"):
        per = real(out, labels, impl=impl).view(-1, n)
        rest = per[:, :keep].mean(1, keepdim=True).expand(-1, n - keep)
        return torch.cat([per[:, :keep], rest], dim=1).reshape(-1)

    monkeypatch.setattr(packed, "class_balanced_cross_entropy_loss_per_sample", half)
    assert not _run(cell_name)["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    import osvos_torch.parallel.batched_online as batched

    real = batched.make_infer_fn
    calls = []

    def altered(*args, **kwargs):
        infer = real(*args, **kwargs)

        def fn(*a, **k):
            maps = infer(*a, **k)
            calls.append(1)
            # the window's first call: the first frame of a sequence, never a pad
            return maps + 64 if len(calls) == 4 else maps
        return fn

    monkeypatch.setattr(batched, "make_infer_fn", altered)
    result = _run("fast.infer_rank1of4")
    assert not result["correct"]
