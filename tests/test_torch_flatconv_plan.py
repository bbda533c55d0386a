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
    its own path (csrc/stem.cu)."""
    convs = _trunk_convs(batch, 480, 854)
    stem, rest = convs[0], convs[1:]
    assert kern.plan(*stem, mode="stem").path == "stem"
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


def _side_convs(n, h, w):
    """(n, h, w, c) of the four side convs of ModelConfig() at an (h, w)
    input: stages 2-5, each reading its stage's last output."""
    stages = ModelConfig().stages
    out = []
    for i in range(len(stages)):
        if i:
            out.append((n, h, w, stages[i][-1]))
        h, w = -(-h // 2), -(-w // 2)
    return out


@pytest.mark.parametrize("batch", [5, 2])
@pytest.mark.parametrize("mode", ["side", "side_pool", "side_dgrad",
                                  "side_dgrad_pool", "stem"])
def test_the_side_convs_and_the_stem_take_the_mma_path(mode, batch):
    """No launch of the model stays on the mma.sync template: at batch 5
    (the fine-tune) and 2 (parent training), 480x854, B5 (C -> 16) and B6's
    dz (16 -> C) at every side conv take the Hopper path, B5 with tiles of 4
    rows (2 at the last sides, where 4 would leave SMs idle) x 62 pixels x
    all 16 channels over 64-channel chunks, B6 with 2 rows x 64 pixels x 64
    dz channels over the 16 of g and a grid that is a multiple of its
    channel tiles; the stem takes its own path (csrc/stem.cu): one block
    per SM, each a run of image rows, 128-pixel segments and one 64-channel
    tile, its shared memory within the card's 227 KB."""
    if mode == "stem":
        n, h, w, c, d = _trunk_convs(batch, 480, 854)[0]
        p = kern.plan(n, h, w, c, d, mode)
        assert p.path == "stem"
        assert (p.blocks, p.n, p.groups) == (kern.NUM_SMS, n, h)
        assert (p.seg, p.segs, p.n_tiles) == (kern.STEM_SEG, -(-w // 128), 1)
        assert kern.stem_smem(w, c, d) <= 227 * 1024
        return
    sides = _side_convs(batch, 480, 854)
    assert [c for *_, c in sides] == [128, 256, 512, 512]
    for n, h, w, c in sides:
        dgrad = "dgrad" in mode
        cin, cout = (16, c) if dgrad else (c, 16)
        p = kern.plan(n, h, w, cin, cout, mode)
        assert p.path == "hopper", (n, h, w, c, mode)
        # B5's tiles have 2 rows where 4 would leave fewer than two a SM
        four_row_tiles = n * -(-h // 4) * -(-w // kern.SIDE_FWD_SEG)
        assert kern.SIDE_ROWS == 4 and kern.SIDE_DZ_ROWS == 2
        assert p.rows == (2 if dgrad or four_row_tiles < 2 * kern.NUM_SMS else 4)
        if dgrad:
            assert (p.tile_n, p.tile_c) == (kern.SIDE_DZ_TILE, kern.SIDE_D)
            assert p.n_tiles == c // 64 and p.blocks % p.n_tiles == 0
        else:
            assert (p.tile_n, p.tile_c, p.n_tiles, p.seg) == (16, kern.CHUNK, 1, 62)
        assert 1 <= p.blocks <= min(kern.NUM_SMS, p.tiles)


@pytest.mark.parametrize("cin,cout,mode", [(12, 16, "side"), (64, 12, "side"),
                                           (64, 24, "side_pool"),
                                           (12, 12, "side_dgrad"),
                                           (24, 64, "side_dgrad_pool"),
                                           (16, 20, "side_dgrad")])
def test_side_convs_off_their_path_take_the_mma_path(cin, cout, mode):
    """A side conv whose channels are off a multiple of 8, or whose side
    is wider than the Hopper path's 16 channels, takes the mma path."""
    assert kern.plan(2, 17, 29, cin, cout, mode).path == "mma"


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


@pytest.mark.parametrize("shape", [(5, 30, 54, 512, 16), (2, 17, 107, 64, 16),
                                   (1, 9, 427, 128, 16), (3, 1, 5, 8, 8),
                                   (2, 31, 70, 520, 16)])
@pytest.mark.parametrize("mode", ["side_pool", "side_dgrad_pool"])
def test_side_tiles_cover_every_pixel_and_hold_whole_windows(shape, mode):
    """B5's and B6's tiles: every output pixel and channel at W of 54, 107
    and 427 (ragged 62- and 64-pixel segments) and odd H (a ragged row
    group) lies
    in exactly one tile, the blocks' strided runs take every tile once, a
    B6 block keeps one channel tile, and each pooled tile starts on an even
    row and column with an even number of rows, so it holds whole 2x2
    windows of the ceil pool."""
    n, h, w, c, d = shape
    dgrad = "dgrad" in mode
    cin, cout = (d, c) if dgrad else (c, d)
    p = kern.plan(n, h, w, cin, cout, mode)
    assert p.path == "hopper"
    assert p.rows % 2 == 0 and p.seg % 2 == 0
    assert p.seg == (kern.SEG if dgrad else kern.SIDE_FWD_SEG)
    cover = np.zeros((n, h, w, cout), np.int32)
    windows = np.zeros((n, -(-h // 2), -(-w // 2)), np.int32)
    for t in range(p.tiles):
        img, h0, w0, d0 = p.tile(t)
        assert h0 % 2 == 0 and w0 % 2 == 0 and h0 < h and w0 < w
        cover[img, h0:h0 + p.rows, w0:w0 + p.seg, d0:d0 + p.tile_n] += 1
        if d0 == 0:
            windows[img, h0 // 2:(h0 + p.rows) // 2,
                    w0 // 2:(w0 + p.seg) // 2] += 1
    assert (cover == 1).all() and (windows == 1).all()
    taken = sorted(t for b in range(p.blocks) for t in range(b, p.tiles, p.blocks))
    assert taken == list(range(p.tiles))
    for b in range(p.blocks):
        assert {p.tile(t)[3] for t in range(b, p.tiles, p.blocks)} == \
            ({b % p.n_tiles * p.tile_n} if dgrad else {0})


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


@pytest.mark.parametrize("d,c,tile_n,tile_c", [(16, 128, 16, 64), (16, 512, 16, 64),
                                               (8, 12, 16, 32), (64, 64, 64, 64),
                                               (136, 16, 128, 64), (20, 24, 64, 16)])
@pytest.mark.parametrize("flip", [False, True])
def test_pack_weight_ref_is_the_weight_matrix_and_its_flip(d, c, tile_n, tile_c,
                                                           flip):
    """The pack kernel's plain version, built element by element: tap kh * 3
    + kw, row o, column i is weight[o, i, kh, kw] rounded to bf16, or with
    ``flip`` weight[i, o, 2 - kh, 2 - kw] (the input gradient's operand),
    zero in the padding to the tiles; it is ``_weight_matrix`` of the
    weight or of its flipped transpose, and ``pack_weight`` on a CPU weight
    returns it."""
    rng = np.random.RandomState(d * c + flip)
    w = rng.randn(d, c, 3, 3).astype(np.float32)
    weight = torch.from_numpy(w)
    got = kern.pack_weight_ref(weight, tile_n, tile_c, flip=flip)
    rows, cols = (c, d) if flip else (d, c)
    want = torch.zeros(9, -(-rows // tile_n) * tile_n, -(-cols // tile_c) * tile_c)
    for kh in range(3):
        for kw in range(3):
            for o in range(rows):
                for i in range(cols):
                    want[kh * 3 + kw, o, i] = float(
                        w[i, o, 2 - kh, 2 - kw] if flip else w[o, i, kh, kw])
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, want.to(torch.bfloat16))
    base = weight.flip(2, 3).transpose(0, 1) if flip else weight
    assert torch.equal(got, kern._weight_matrix(base, tile_n, tile_c))
    assert torch.equal(kern.pack_weight(weight, tile_n, tile_c, flip=flip), got)


def test_pack_weight_ref_of_the_stem():
    """The stem's im2col operand: row o, column (kh * 3 + kw) * C + c is
    weight[o, c, kh, kw], zero past 9 C and past D."""
    rng = np.random.RandomState(3)
    w = rng.randn(64, 3, 3, 3).astype(np.float32)
    got = kern.pack_weight_ref(torch.from_numpy(w), 64, 32, stem=True)
    want = np.zeros((64, 32), np.float32)
    for o in range(64):
        for kh in range(3):
            for kw in range(3):
                for c in range(3):
                    want[o, (kh * 3 + kw) * 3 + c] = w[o, c, kh, kw]
    assert torch.equal(got, torch.from_numpy(want).to(torch.bfloat16))
