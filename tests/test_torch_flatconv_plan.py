"""How ``csrc/flatconv.cu`` is launched, checked on the CPU: the path and
tiling that ``ops/kernels/flatconv.plan`` picks, the tiles' cover of the
output, and the weight operand the kernels read.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); what decides where they read and write is Python, and
is held here at the port's real shapes without running a kernel.
"""

import numpy as np
import pytest
import torch

from osvos_torch.configs import ModelConfig
from osvos_torch.models.vgg_osvos import stage_conv_names
from osvos_torch.ops.kernels import flatconv as kern


def _trunk_convs(n, h, w):
    """(n, h, w, c, d) of every trunk conv of ModelConfig() at an (h, w)
    input, the stem first."""
    stages = ModelConfig().stages
    hw = {}
    for i in range(len(stages)):
        hw[f"stage{i + 1}"] = (h, w)
        h, w = -(-h // 2), -(-w // 2)
    return [(n, *hw[name.split("_")[0]], c, d)
            for name, c, d in stage_conv_names(stages)]


@pytest.mark.parametrize("batch", [5, 2])
def test_every_trunk_conv_after_the_stem_takes_the_hopper_path(batch):
    """At batch 5 (the fine-tune) and 2 (parent training), 480x854: the
    forward (C -> D) of every trunk conv after the stem, the pooled forward
    of stage 1's last, and every dz (D -> C) take the Hopper path, with 64
    channels x 4 rows for 64 outputs and 128 x 2 rows above; the stem takes
    the mma path."""
    convs = _trunk_convs(batch, 480, 854)
    stem, rest = convs[0], convs[1:]
    assert kern.plan(*stem, mode="stem").path == "mma"
    assert kern.plan(*stem, mode="fwd").path == "mma"  # C = 3
    for n, h, w, c, d in rest:
        for cin, cout, mode in ((c, d, "fwd"), (d, c, "dgrad")):
            p = kern.plan(n, h, w, cin, cout, mode)
            assert p.path == "hopper", (n, h, w, cin, cout, mode)
            assert (p.tile_n, p.rows) == ((64, 4) if cout <= 64 else (128, 2))
            assert p.tile_c == kern.CHUNK == 64
            assert 1 <= p.blocks <= min(kern.NUM_SMS, p.tiles)
    n, h, w, c, d = rest[0]  # stage 1's last conv carries the pool
    assert kern.plan(n, h, w, c, d, "fwd_pool").path == "hopper"


@pytest.mark.parametrize("mode", ["side", "side_pool", "side_dgrad",
                                  "side_dgrad_pool", "stem"])
def test_the_side_convs_and_the_stem_take_the_mma_path(mode):
    """B5 and B6 (C -> 16 and back, channel counts TMA could take) and the
    stem stay on the mma.sync template with their own tiles."""
    for n, h, w, c, _ in _trunk_convs(5, 480, 854)[1:]:
        cin, cout = (16, c) if "dgrad" in mode else (c, 16)
        p = kern.plan(n, h, w, cin, cout, mode)
        assert p.path == "mma"
        assert (p.tile_n, p.tile_c) == tuple(kern._MODES[mode][1:])


@pytest.mark.parametrize("cin,cout", [(12, 64), (64, 12), (3, 8), (8, 4),
                                      (20, 20)])
@pytest.mark.parametrize("mode", ["fwd", "fwd_pool", "dgrad"])
def test_channels_off_a_multiple_of_8_take_the_mma_path(cin, cout, mode):
    assert kern.plan(2, 17, 29, cin, cout, mode).path == "mma"


@pytest.mark.parametrize("shape", [(2, 17, 54, 8, 512), (1, 31, 107, 64, 64),
                                   (2, 9, 427, 16, 136), (3, 1, 5, 64, 8),
                                   (1, 6, 64, 512, 128)])
@pytest.mark.parametrize("mode", ["fwd", "dgrad"])
def test_hopper_tiles_cover_every_output_once(shape, mode):
    """Every output pixel and channel, W of 54, 107 and 427 (ragged 64-pixel
    segments), odd H (a ragged row group), lies in exactly one tile, and
    the blocks' strided runs (b, b + blocks, ...) take every tile once."""
    n, h, w, cin, cout = shape
    p = kern.plan(n, h, w, cin, cout, mode)
    assert p.path == "hopper"
    assert p.tiles == n * -(-h // p.rows) * -(-w // kern.SEG) * -(-cout // p.tile_n)
    cover = np.zeros((n, h, w, cout), np.int32)
    for t in range(p.tiles):
        img, h0, w0, d0 = p.tile(t)
        assert 0 <= img < n and h0 % p.rows == 0 and w0 % kern.SEG == 0
        assert d0 % p.tile_n == 0 and h0 < h and w0 < w and d0 < cout
        cover[img, h0:h0 + p.rows, w0:w0 + kern.SEG, d0:d0 + p.tile_n] += 1
    assert (cover == 1).all()
    taken = sorted(t for b in range(p.blocks) for t in range(b, p.tiles, p.blocks))
    assert taken == list(range(p.tiles))


def test_pooled_forward_tiles_hold_whole_windows():
    """The pooled forward's tiles start on even rows and columns and hold
    an even number of rows, so each 2x2 window of the ceil pool lies in one
    tile (its epilogue pools in registers)."""
    for n, h, w, c, d in _trunk_convs(5, 480, 854)[1:] + [(2, 17, 29, 8, 64)]:
        p = kern.plan(n, h, w, c, d, "fwd_pool")
        assert p.rows % 2 == 0 and kern.SEG % 2 == 0


@pytest.mark.parametrize("d,c", [(64, 64), (128, 64), (512, 512), (136, 16),
                                 (8, 192)])
def test_hopper_weight_operand_holds_the_taps(d, c):
    """The (9, D_p, C_p) bf16 operand at the Hopper tiles: tap kh * 3 + kw,
    output row o, input column i is weight[o, i, kh, kw] rounded to bf16,
    zero in the padding to the output tile and the 64-channel chunk."""
    rng = np.random.RandomState(d + c)
    weight = torch.from_numpy(rng.randn(d, c, 3, 3).astype(np.float32))
    p = kern.plan(1, 8, 64, c, d, "fwd")
    wm = kern._weight_matrix(weight, p.tile_n, p.tile_c)
    d_p, c_p = -(-d // p.tile_n) * p.tile_n, -(-c // 64) * 64
    assert wm.shape == (9, d_p, c_p) and wm.dtype == torch.bfloat16
    assert wm.is_contiguous()
    want = torch.zeros(9, d_p, c_p, dtype=torch.bfloat16)
    for kh in range(3):
        for kw in range(3):
            want[kh * 3 + kw, :d, :c] = weight[:, :, kh, kw].to(torch.bfloat16)
    assert torch.equal(wm, want)


def test_dz_operand_is_the_flipped_transposed_weight():
    """dz's product reads the (C, D, 3, 3) flip of the weight: tap (kh, kw)
    of the dz operand is the forward's tap (2 - kh, 2 - kw), transposed."""
    rng = np.random.RandomState(5)
    weight = torch.from_numpy(rng.randn(128, 64, 3, 3).astype(np.float32))
    flipped = weight.flip(2, 3).transpose(0, 1)
    p = kern.plan(1, 8, 64, 128, 64, "dgrad")
    wm = kern._weight_matrix(flipped, p.tile_n, p.tile_c)
    fwd = kern._weight_matrix(weight, 128, 64)
    for tap in range(9):
        assert torch.equal(wm[tap], fwd[8 - tap].T)
