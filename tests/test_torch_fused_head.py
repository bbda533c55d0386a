"""The fused-head tail: its plain version against the JAX package's Pallas
kernel (interpret mode), the two-tap tables the CUDA kernel gathers with,
and a torch restatement of the kernel's arithmetic on those tables. The
kernel itself runs only on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from osvos_tpu.ops.pallas.fused_head import (
    fused_upsample_sigmoid_u8 as jax_fused_upsample_sigmoid_u8)
from osvos_torch.ops.kernels import fused_head

FACTORS = (2, 4, 8, 16)


def _low_res_shapes(h, w):
    """(h_i, w_i) of the four side branches: ceil-halved per stage."""
    shapes = []
    for _ in FACTORS:
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w))
    return shapes


def _contribs(rng, b, h, w, std=3.0):
    return [(rng.randn(b, hi, wi) * std).astype(np.float32)
            for hi, wi in _low_res_shapes(h, w)]


def _gather_tail(contribs, bias, out_hw, factors):
    """The CUDA kernel's arithmetic, restated in torch: per scale a 2x2
    gather through the two-tap tables, summed over the rows first at both
    source columns, then over the columns; then bias, sigmoid, round."""
    h, w = out_hw
    acc = None
    for c, f in zip(contribs, factors):
        ri, rw = map(torch.from_numpy, fused_head.two_tap_table(c.shape[1], f, h))
        ci, cw = map(torch.from_numpy, fused_head.two_tap_table(c.shape[2], f, w))
        r0, r1 = c[:, ri[:, 0].long()], c[:, ri[:, 1].long()]  # (B, H, w_i)
        t = [rw[:, 0, None] * r0[:, :, ci[:, k].long()]
             + rw[:, 1, None] * r1[:, :, ci[:, k].long()] for k in (0, 1)]
        term = t[0] * cw[:, 0] + t[1] * cw[:, 1]
        acc = term if acc is None else acc + term
    probs = torch.sigmoid(acc + bias)
    return torch.round(255.0 * probs).to(torch.uint8)


@pytest.mark.parametrize("hw", [(65, 97), (64, 96)])
def test_ref_matches_jax_pallas_tail(rng, hw):
    """Plain version vs the Pallas kernel in interpret mode, on contributions
    that spread the logits (the reference init gives only 127 and 128)."""
    cs = _contribs(rng, 2, *hw)
    bias = np.float32(0.5)
    logits = fused_head.tail_logits_ref(
        [torch.from_numpy(c) for c in cs], torch.tensor(bias), hw, FACTORS)
    assert logits.min() < -6 and logits.max() > 6
    want = np.asarray(jax_fused_upsample_sigmoid_u8(
        [jnp.asarray(c) for c in cs], jnp.asarray(bias), out_hw=hw,
        factors=FACTORS, interpret=True))
    got = fused_head.fused_upsample_sigmoid_u8_ref(
        [torch.from_numpy(c) for c in cs], torch.tensor(bias), hw,
        FACTORS).numpy()
    assert got.shape == want.shape == (2, *hw) and got.dtype == np.uint8
    assert len(np.unique(got)) >= 200
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() <= 1e-3


@pytest.mark.parametrize("hw", [(480, 854), (65, 97), (64, 96)])
def test_two_tap_tables_rebuild_interp_matrices(hw):
    for (hi, wi), f in zip(_low_res_shapes(*hw), FACTORS):
        for n_in, n_out in ((hi, hw[0]), (wi, hw[1])):
            m = fused_head._cropped_interp(n_in, f, n_out)
            assert (np.count_nonzero(m, axis=1) <= 2).all()
            idx, w = fused_head.two_tap_table(n_in, f, n_out)
            rebuilt = np.zeros_like(m)
            rows = np.arange(n_out)
            np.add.at(rebuilt, (rows, idx[:, 0]), w[:, 0])
            np.add.at(rebuilt, (rows, idx[:, 1]), w[:, 1])
            np.testing.assert_array_equal(rebuilt, m)


@pytest.mark.parametrize("hw", [(480, 854), (65, 97)])
def test_kernel_gather_arithmetic_matches_ref(rng, hw):
    b = 2 if hw == (480, 854) else 3
    cs = [torch.from_numpy(c) for c in _contribs(rng, b, *hw)]
    bias = torch.tensor(-0.25)
    want = fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, hw, FACTORS)
    got = _gather_tail(cs, bias, hw, FACTORS)
    assert len(torch.unique(want)) >= 200
    assert (got.int() - want.int()).abs().max() <= 1
    # one code off only next to a .5 rounding boundary: rare
    assert float((got != want).float().mean()) <= 1e-3


def test_cpu_tensors_take_the_plain_version(rng):
    cs = [torch.from_numpy(c) for c in _contribs(rng, 1, 65, 97)]
    bias = torch.tensor([0.5])
    before = fused_head.launches
    got = fused_head.fused_upsample_sigmoid_u8(cs, bias, (65, 97), FACTORS)
    assert fused_head.launches == before
    want = fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, (65, 97), FACTORS)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_no_fallback_for_other_devices():
    cs = [torch.zeros(1, h, w, device="meta") for h, w in _low_res_shapes(65, 97)]
    before = fused_head.launches
    with pytest.raises(ValueError, match="no kernel"):
        fused_head.fused_upsample_sigmoid_u8(
            cs, torch.zeros(1, device="meta"), (65, 97), FACTORS)
    assert fused_head.launches == before
