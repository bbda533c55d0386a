"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it also runs where JAX is not installed:

    OSVOS_TEST_PLATFORM=gpu python -m pytest tests/test_torch_cuda.py

(any value other than ``cpu`` keeps ``tests/conftest.py`` from importing
jax). ``chip_smoke.py`` runs it that way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from osvos_torch.configs import ModelConfig
from osvos_torch.evaluation.infer import make_infer_fn
from osvos_torch.models import OSVOS, init_osvos_params
from osvos_torch.models.surgery import spread_head
from osvos_torch.ops.kernels import fused_head

pytestmark = pytest.mark.cuda

FACTORS = (2, 4, 8, 16)
TINY = ModelConfig(stages=((8, 8), (12, 12), (16, 16, 16), (16, 16, 16),
                           (16, 16, 16)), side_channels=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _contribs(b, h, w, device, seed=0, std=3.0):
    rng = np.random.RandomState(seed)
    shapes = []
    for _ in FACTORS:
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w))
    return [torch.from_numpy((rng.randn(b, hi, wi) * std).astype(np.float32))
            .to(device) for hi, wi in shapes]


@pytest.mark.parametrize("b,hw", [(4, (480, 854)), (3, (65, 97)), (1, (64, 96))])
def test_fused_head_kernel_matches_ref(cuda, b, hw):
    cs = _contribs(b, *hw, cuda)
    bias = torch.tensor([0.5], device=cuda)
    before = fused_head.launches
    got = fused_head.fused_upsample_sigmoid_u8(cs, bias, hw, FACTORS)
    torch.cuda.synchronize()
    assert fused_head.launches == before + 1
    want = fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, hw, FACTORS)
    assert got.dtype == torch.uint8 and got.shape == (b, *hw) and got.is_cuda
    assert len(torch.unique(want)) >= 200
    assert int((got.int() - want.int()).abs().max()) <= 1
    # one code off only next to a .5 rounding boundary: rare
    assert float((got != want).float().mean()) <= 1e-3


def test_fused_head_kernel_rejects_what_it_does_not_take(cuda):
    cs = _contribs(2, 65, 97, cuda)
    bias = torch.tensor([0.5], device=cuda)
    bad = [cs[0].half()] + cs[1:]
    with pytest.raises(ValueError):
        fused_head.fused_upsample_sigmoid_u8(bad, bias, (65, 97), FACTORS)
    strided = [cs[0].transpose(1, 2).contiguous().transpose(1, 2)] + cs[1:]
    with pytest.raises(ValueError):
        fused_head.fused_upsample_sigmoid_u8(strided, bias, (65, 97), FACTORS)
    with pytest.raises(ValueError):
        fused_head.fused_upsample_sigmoid_u8(cs, bias.cpu(), (65, 97), FACTORS)


def _model(cfg, x, device):
    model = OSVOS(cfg)
    model.load_state_dict(init_osvos_params(cfg, torch.Generator().manual_seed(0)))
    model.to(device)
    spread_head(model, x.to(device))
    return model


@pytest.mark.parametrize("compute_mode", ["fast", "parity"])
def test_kernel_tail_matches_plain_tail(cuda, compute_mode):
    cfg = dataclasses.replace(TINY, compute_mode=compute_mode)
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 65, 97, 3)
                         .astype(np.float32) * 40)
    model = _model(cfg, x, cuda)
    before = fused_head.launches
    got = make_infer_fn(cfg)(model, x.to(cuda))
    assert fused_head.launches == before + 1
    want = make_infer_fn(cfg, kernel_tail=False)(model, x.to(cuda))
    assert int((got.int() - want.int()).abs().max()) <= 1
    assert float((got != want).float().mean()) <= 1e-3


def test_parity_on_card_matches_cpu(cuda):
    """TF32 off in parity mode: the card holds the CPU's answer to 2e-4 of
    the output's scale, the tolerance of tests/test_model.py."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 65, 97, 3)
                         .astype(np.float32) * 40)
    model = _model(TINY, x, "cpu")
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda))
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-3)
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=2e-4 * scale)
