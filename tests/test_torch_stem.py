"""The stem conv's Hopper kernels (``csrc/stem.cu``, B2's stem forward, and
``csrc/stem_wgrad.cu``'s Hopper path, B16), held on the CPU where they can
be: the host-side arithmetic they share (``csrc/stem.cuh``, mirrored in
``ops/kernels/stem_wgrad.py``) and a numpy model of what they compute from
it.

- The persistent schedule's runs of image rows cover every (n, h) once.
- The 16-byte chunks that bring an image row into a strip slot cover the
  row's bytes and read nothing past the tensor; the row and its halo
  columns fit the slot.
- The rolling strip's slots hold the rows each step reads.
- The stacked row that each thread builds (nine taps x C values, the ones
  column at 9 C, zeros), modelled in numpy from the strip's bytes, times
  ``pack_weight_ref(stem=True)`` is the stem's conv, and its product with g
  is ``stem_wgrad_ref``'s dK and db.
- The forward's plain version, which the wrapper runs on the CPU, equals
  the JAX package's stem through its XLA twin ``flat_conv3x3_ref``.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Sums of exact bf16 products in float32 are compared
with float64 sums within 1e-5 of their scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osvos_tpu.ops.pallas.flatconv import (FlatGeom, flat_conv3x3_ref,
                                           from_flat, to_flat)
from osvos_torch.ops.kernels import flatconv, stem_wgrad

# (n, h, w, c, d): the fine-tune's and the parent's stem at 480x854, and
# odd shapes: a ragged W, H = 1, one row per block, C = 1 and 2, D > 64
SCHEDULE_SHAPES = [(5, 480, 854, 3, 64), (2, 480, 854, 3, 64),
                   (2, 17, 29, 3, 8), (1, 1, 200, 3, 16), (3, 9, 70, 1, 16),
                   (2, 7, 130, 2, 72), (1, 3, 40, 3, 256), (7, 31, 5, 3, 8)]
MODEL_SHAPES = [(2, 5, 29, 3, 16), (1, 3, 130, 2, 8), (3, 4, 7, 1, 24)]


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def _image(shape, seed):
    """An image of the stem's range (values to about +-150) on the bf16
    grid, as the kernels see it."""
    return _bf16(np.random.RandomState(seed).randn(*shape) * 60)


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_row_runs_cover_every_image_row_once(shape):
    """Both kernels' grids: every (n, h) lies in exactly one block's run,
    the runs are contiguous, in block order and none is empty; the forward
    has a block per SM (or per row where there are fewer), B16 that many
    per 64-channel tile in all."""
    n, h, w, c, d = shape
    rows = n * h
    fwd = flatconv.plan(n, h, w, c, d, "stem")
    assert fwd.path == "stem" and fwd.blocks == min(flatconv.NUM_SMS, rows)
    runs = stem_wgrad.tma_plan(n, h, w, c, d)
    d_tiles = -(-d // stem_wgrad.TILE_D)
    assert runs == min(stem_wgrad.NUM_SMS // d_tiles, rows)
    assert runs * d_tiles <= stem_wgrad.NUM_SMS
    for blocks in (fwd.blocks, runs):
        spans = stem_wgrad.row_runs(rows, blocks)
        cover = np.zeros(rows, np.int32)
        for (lo, hi), (lo2, _) in zip(spans, spans[1:] + [(rows, rows)]):
            assert lo < hi == lo2
            cover[lo:hi] += 1
        assert (cover == 1).all()
        assert max(hi - lo for lo, hi in spans) - min(hi - lo for lo, hi in spans) <= 1


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_row_windows_cover_each_row_and_stay_in_the_tensor(shape):
    """Each image row's 16-byte chunks start at an aligned byte at or
    before the row, end at or past its last byte with no chunk to spare,
    and read only bytes of the tensor (the last chunk of the last row stops
    at its end); in the slot the row, its chunks and its two halo pixels
    fit."""
    n, h, w, c, _ = shape
    rows, row_bytes = n * h, 2 * w * c
    total = rows * row_bytes
    slot = stem_wgrad.slot_bytes(w, c)
    for r in range(rows):
        a0, chunks, lead = stem_wgrad.row_window(r, w, c)
        b0, b1 = r * row_bytes, (r + 1) * row_bytes
        assert a0 % 16 == 0 and a0 <= b0 < a0 + 16
        assert a0 + 16 * (chunks - 1) < b1 <= a0 + 16 * chunks
        last = a0 + 16 * (chunks - 1)
        assert last < total and last + min(16, total - last) <= total
        assert lead == stem_wgrad.LEAD + b0 - a0
        assert lead - 2 * c >= 0 and lead + row_bytes + 2 * c <= slot
        assert stem_wgrad.LEAD + 16 * chunks <= slot


def _strip_row(xbytes, r, w, c):
    """A strip slot after image row r has landed, as the kernel fills it:
    the row's chunks copied at LEAD (the last one zero past the tensor),
    then its halo columns zeroed. Returns (slot, lead)."""
    a0, chunks, lead = stem_wgrad.row_window(r, w, c)
    slot = np.full(stem_wgrad.slot_bytes(w, c), 0xA5, np.uint8)  # stale bytes
    for i in range(chunks):
        src = xbytes[a0 + 16 * i:a0 + 16 * i + 16]
        dst = stem_wgrad.LEAD + 16 * i
        slot[dst:dst + 16] = 0
        slot[dst:dst + len(src)] = src
    slot[lead - 2 * c:lead] = 0
    slot[lead + 2 * w * c:lead + 2 * w * c + 2 * c] = 0
    return slot, lead


def _stacked(x):
    """(N H W, 32) float64 stacked rows of the bf16 image x built as the
    kernels build them: from strip slots holding the tap rows (a zero row
    outside the image), one pixel at a time, each 128-pixel segment of a
    row padded with zero rows past W."""
    n, h, w, c = x.shape
    xbytes = x.view(torch.int16).numpy().reshape(-1).view(np.uint8)
    zero = np.zeros(stem_wgrad.slot_bytes(w, c), np.uint8)
    out = []
    for r in range(n * h):
        hh = r % h
        taps = []
        for kh in range(3):
            if 0 <= hh + kh - 1 < h:
                taps.append(_strip_row(xbytes, r + kh - 1, w, c))
            else:
                taps.append((zero, stem_wgrad.LEAD))
        segs = -(-w // stem_wgrad.SEG)
        rows = np.zeros((segs * stem_wgrad.SEG, 32), np.uint16)
        for p in range(w):
            for kh, (slot, lead) in enumerate(taps):
                for kw in range(3):
                    for ch in range(c):
                        at = lead + ((p + kw - 1) * c + ch) * 2
                        rows[p, (3 * kh + kw) * c + ch] = int(slot[at]) | int(slot[at + 1]) << 8
            rows[p, 9 * c] = 0x3F80  # bf16 1.0
        assert not rows[w:].any()  # past the row's end: zero
        out.append(rows[:w])
    bits = np.concatenate(out).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_stacked_rows_give_the_plain_conv_and_weight_gradient(shape):
    """The numpy model of `build_stacked`: values t * C + c (t = 3 kh + kw)
    are the taps of the image, 9 C is one and the rest zero; times the
    weight operand ``pack_weight_ref(stem=True)`` (the layout the forward
    packs its resident weights in) they give the conv the forward rounds,
    and their product with g gives ``stem_wgrad_ref``'s dK (rows t * C + c)
    and db (row 9 C)."""
    n, h, w, c, d = shape
    x = _image((n, h, w, c), sum(shape))
    rng = np.random.RandomState(d)
    k = torch.from_numpy((rng.randn(d, c, 3, 3) * 0.3).astype(np.float32))
    g = _bf16(rng.randn(n, h, w, d))
    s = _stacked(x)
    assert (s[:, 9 * c] == 1).all() and not s[:, 9 * c + 1:].any()

    wm = flatconv.pack_weight_ref(k, 64, 32, stem=True).float().numpy()[:d]
    conv = (s @ wm.T.astype(np.float64)).reshape(n, h, w, d)
    want = flatconv.conv3x3_f32(x, k).double().numpy()
    np.testing.assert_allclose(conv, want, rtol=0, atol=1e-5 * np.abs(want).max())

    prod = s.T @ g.float().double().numpy().reshape(-1, d)
    dk, db = stem_wgrad.stem_wgrad_ref(x, g)
    np.testing.assert_allclose(prod[:9 * c].reshape(3, 3, c, d), dk.double().numpy(),
                               rtol=0, atol=1e-5 * float(dk.abs().max()))
    col = float(g.float().abs().sum((0, 1, 2)).max())
    np.testing.assert_allclose(prod[9 * c], db.double().numpy(), rtol=0, atol=1e-5 * col)


@pytest.mark.parametrize("rs,slots", [(flatconv.STEM_WGS, flatconv.STEM_SLOTS),
                                     (1, stem_wgrad.SLOTS)])
@pytest.mark.parametrize("rows,blocks", [(2400, 132), (960, 132), (7, 3), (5, 5)])
def test_rolling_strip_holds_the_rows_each_step_reads(rs, slots, rows, blocks):
    """The strip's ring as the kernels run it (the forward three rows a
    step in eight slots, B16 one in four): the first rows of a run, then at
    each step the copies of the rows `rs` + 1 .. 2 `rs` ahead into the
    slots of rows no step still reads; every row a step reads, r - 1 ..
    r + `rs` within the tensor, is in its slot."""
    for lo, hi in stem_wgrad.row_runs(rows, blocks):
        ring = {}
        for r in range(lo - 1, lo + rs + 1):
            if 0 <= r < rows:
                ring[r % slots] = r
        for r0 in range(lo, hi, rs):
            for r in range(r0 - 1, r0 + rs + 1):
                if 0 <= r < rows and r <= hi:
                    assert ring.get(r % slots) == r, (lo, hi, r0, r)
            for r in range(r0 + rs + 1, r0 + 2 * rs + 1):
                if r < rows and r <= hi:
                    ring[r % slots] = r


def test_stem_forward_plain_version_matches_the_jax_stem():
    """conv_fwd on CPU tensors (the plain version, no launch) on a 2x10x13
    image against the JAX package's stem, the XLA twin of its kernel
    (``flat_conv3x3_ref`` with no input ReLU and the output ReLU): within
    one bf16 rounding."""
    n, h, w, c, d = 2, 10, 13, 3, 16
    x = _image((n, h, w, c), 7)
    rng = np.random.RandomState(8)
    k = (rng.randn(3, 3, c, d) * 0.05).astype(np.float32)
    b = (rng.randn(d) * 0.5).astype(np.float32)
    geom = FlatGeom(n=n, h=h, w=w, c=c, t=4)
    zf = to_flat(jnp.asarray(x.float().numpy()), geom)
    want = np.asarray(from_flat(
        flat_conv3x3_ref(zf, jnp.asarray(k), jnp.asarray(b), geom,
                         relu_input=False, relu_output=True),
        FlatGeom(n=n, h=h, w=w, c=d, t=4)).astype(jnp.float32))
    before = flatconv.stem_launches, flatconv.fwd_launches
    y, pooled = flatconv.conv_fwd(x, torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                                  torch.from_numpy(b))
    assert (flatconv.stem_launches, flatconv.fwd_launches) == before
    assert pooled is None and y.dtype == torch.bfloat16 and y.shape == (n, h, w, d)
    got = y.float().numpy()
    assert (want == 0).mean() > 0.1  # the ReLU acted
    scale = np.abs(want).max()
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + scale * 2.0 ** -16).all()
