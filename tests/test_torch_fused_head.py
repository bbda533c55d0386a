"""The fused-head tail: its plain version against the JAX package's Pallas
kernel (interpret mode), the two-tap tables that state the taps the CUDA
kernel computes, a torch restatement of the kernel's arithmetic on those
taps, and the kernel's division of the work (its runs of rows, the pieces
it stages, the source rows it copies, the columns each thread sums). The
kernel itself runs only on the card: tests/test_torch_cuda.py."""

import re
from pathlib import Path

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
    """The CUDA kernel's arithmetic, restated in torch: per scale the
    vertical blend of every source column into an output row through the
    row taps, then each output column's two taps of that row; the scales
    summed in order, then bias, sigmoid, round."""
    h, w = out_hw
    acc = None
    for c, f in zip(contribs, factors):
        ri, rw = map(torch.from_numpy, fused_head.two_tap_table(c.shape[1], f, h))
        ci, cw = map(torch.from_numpy, fused_head.two_tap_table(c.shape[2], f, w))
        v = (rw[:, 0, None] * c[:, ri[:, 0].long()]
             + rw[:, 1, None] * c[:, ri[:, 1].long()])  # (B, H, w_i)
        term = v[:, :, ci[:, 0].long()] * cw[:, 0] + v[:, :, ci[:, 1].long()] * cw[:, 1]
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


@pytest.mark.parametrize("hw", [(480, 854), (65, 97), (64, 96), (1, 1), (1, 854),
                                (480, 1)])
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


def _kernel_constant(name):
    src = (Path(fused_head.__file__).parents[2] / "csrc" / "fused_head.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_python_schedule_constants_are_the_kernels():
    assert fused_head.THREADS == _kernel_constant("kThreads")
    assert fused_head.MAX_RUN == _kernel_constant("kMaxRun")


SCHEDULE_SHAPES = [(480, 854), (65, 97), (1, 1), (1, 854), (480, 1)]


@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("hw", SCHEDULE_SHAPES)
def test_schedule_covers_every_output_pixel_once(hw, b):
    """Every flat output row lies in exactly one piece of one block's run,
    whatever the grid (a block per SM, a block per row, odd counts), each
    piece has at most MAX_RUN rows in at most two frames; the threads'
    columns cover each output column once."""
    h, w = hw
    rows = b * h
    for blocks in sorted({min(132, rows), rows, min(7, rows), 1}):
        cover = np.zeros(rows, np.int32)
        for lo, hi in fused_head.row_runs(rows, blocks):
            for p0, p1 in fused_head.pieces(lo, hi, h):
                assert lo <= p0 < p1 <= hi and p1 - p0 <= fused_head.MAX_RUN
                assert (p1 - 1) // h - p0 // h <= 1
                cover[p0:p1] += 1
        assert (cover == 1).all()
    cols = np.zeros(max(w, 2500), np.int32)
    for width in (w, 2500):
        cols[:] = 0
        for tid in range(fused_head.THREADS):
            for x in fused_head.thread_columns(tid, width):
                cols[x] += 1
        assert (cols[:width] == 1).all()


@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("hw", SCHEDULE_SHAPES)
def test_staged_source_rows_hold_every_row_tap(hw, b):
    """The source rows a block copies for a piece (per scale and frame, the
    span ``source_span`` finds) hold both row taps of each of the piece's
    rows, in at most (rows - 1) // factor + 3 rows, the room the kernel
    gives a span."""
    h, w = hw
    rows = b * h
    for (hi_, _), f in zip(_low_res_shapes(h, w), FACTORS):
        idx, _ = fused_head.two_tap_table(hi_, f, h)
        top = fused_head.crop_top(hi_, f, h)
        for lo, hi in fused_head.row_runs(rows, min(132, rows)):
            for p0, p1 in fused_head.pieces(lo, hi, h):
                ys = np.arange(p0, p1) % h
                for part in np.split(ys, np.flatnonzero(np.diff(ys) < 0) + 1):
                    s_lo, s_hi = fused_head.source_span(part[0], part[-1], hi_, f, top)
                    assert s_hi - s_lo + 1 <= (p1 - p0 - 1) // f + 3
                    assert (idx[part] >= s_lo).all() and (idx[part] <= s_hi).all()
