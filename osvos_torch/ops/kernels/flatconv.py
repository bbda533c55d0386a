"""The flat trunk's 3x3 conv kernels (B2-B6).

Counterparts of the TPU kernels of ``osvos_tpu/ops/pallas/flatconv.py`` on
the port's layout: NHWC bf16 tensors, contiguous, the trunk's holding
post-ReLU activations (ROADMAP.md: the TPU's 128-lane flat buffers and pixel
packing are not ported). A weight is the float32 OIHW (D, C, 3, 3) parameter,
rounded to bf16 for the products; products of bf16 values are summed in
float32 and each output is rounded once.

- ``conv_fwd`` (B2): y = bf16(relu(conv(x, K) + b)), the bias added in
  float32; with ``pool`` also the ceil-mode 2x2/2 max pool of y. The
  3-channel stem is the same function, with a kernel of its own
  (``csrc/stem.cu``).
- ``conv_bwd`` (B3): dz = bf16(conv_T(g, K) * (x > 0)) (the producer's ReLU
  backward, as every flat consumer applies it), dK (3, 3, C, D) and db (D,)
  in float32. With ``route`` = (y, pooled, d_pooled) the cotangent g of a
  pooled conv is routed from d_pooled first (row-major-first ties), by the
  pool backward kernel (``ops/kernels/pool.max_pool_bwd``, B10's kernel).
- ``stem_bwd``: dK and db only, the image needs no gradient; the stem's
  weight gradient kernel B16 (``ops/kernels/stem_wgrad.py``), which counts
  its own launches.
- ``wgrad_db`` (B4): dK (3, 3, C, D) and db (D,) of any flat conv in
  float32, ``csrc/wgrad.cu``'s ``with_db`` launch; B3 makes it second.
- ``side_fwd`` (B5): side = bf16(conv(x, K)), no bias or ReLU; with ``pool``
  also the pool of x.
- ``side_bwd`` (B6): dz = bf16(conv_T(g, K) * (x > 0) + routed d_pooled),
  summed in float32 before the one rounding, and dK in float32.
- ``conv_fwd_seq`` (B2-seq): the fast trunk's forward, relu(bf16(bf16(conv(x,
  K)) + b)) with a bf16 bias, two roundings as the fast mode's separate
  bias add gives them, for S sequences in one launch: x (N, H, W, S * C)
  with sequence s in the channels [s * C, (s + 1) * C), a stacked (S, D, C,
  3, 3) weight (the packed schedule's trunk, ``ops/fastconv.py``
  ``conv3x3_bias_relu_seq``). Each sequence runs the lone launch's plan,
  so its output is bit for bit the launch at S = 1 on its slice; the
  sequences are dispatched one after another (grid block i runs lone block
  i % blocks of sequence i / blocks). ``seq_fwd_takes`` says which shapes
  it takes.

On CUDA tensors each wrapper launches the hand-written kernels of
``osvos_torch/csrc/flatconv.cu`` (the input gradients and forwards),
``csrc/stem.cu`` (the stem's forward) and ``csrc/wgrad.cu`` (dK and db),
and adds one to its B row's count; on CPU tensors it runs the plain
version (``*_ref``). There is no fallback from one to the other.

The mode and shape pick one of three paths (``plan``): ``csrc/flatconv.cu``'s
Hopper path (TMA, an mbarrier ring and wgmma; ``hopper_launches``) for
the trunk forward and dz and the side convs' B5 and dz with C and D
multiples of 8; the stem's (``csrc/stem.cu``: a rolling image strip,
wgmma, TMA stores; ``stem_launches``) for C <= 3 and D a multiple of 8;
and ``flatconv.cu``'s mma.sync template (``mma_launches``) for the shapes
TMA cannot describe.

Each ``flatconv.cu`` launch reads its weight operand (bf16, the taps'
order, zero-padded to the path's tiles) from ``pack_weight``, one launch
of ``csrc/flatconv.cu``'s pack kernel per call (``pack_launches``), whose
plain version is ``pack_weight_ref``; B6's dz on the Hopper path and the
stem's kernel pack their blocks' operands themselves. The operand is
packed every call: the optimizer changes every weight every step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels import pool as _pool
from osvos_torch.ops.kernels.build import launch_stream
from osvos_torch.ops.kernels import stem_wgrad as _stem
from osvos_torch.ops.kernels import wgrad as _wgrad
from osvos_torch.ops.pool import pool_bwd, pool_fwd
from osvos_torch.utils.precision import exact_f32

# Wrapper calls that launched their kernels in this process, one count per
# TPU kernel row (ROADMAP.md queue B).
fwd_launches = 0        # B2
seq_fwd_launches = 0    # B2-seq (conv_fwd_seq)
bwd_launches = 0        # B3
wgrad_db_launches = 0   # B4
side_fwd_launches = 0   # B5
side_bwd_launches = 0   # B6
# Launches of each path of csrc/flatconv.cu, whichever row called, of the
# stem's kernel (csrc/stem.cu), and of flatconv.cu's weight pack kernel
# (one before each flatconv.cu launch but B6's Hopper dz).
hopper_launches = 0
mma_launches = 0
stem_launches = 0
pack_launches = 0

# Variants of csrc/flatconv.cu: name -> (mode, output-channel tile TN,
# input-channel chunk TC) of the mma path; the weight operand is padded to
# these tiles.
_MODES = {
    "fwd": (0, 64, 32), "fwd_pool": (1, 64, 32), "stem": (2, 64, 32),
    "side": (3, 16, 32), "side_pool": (4, 16, 32), "dgrad": (5, 64, 32),
    "fwd_fast": (6, 64, 32), "side_dgrad": (7, 64, 16),
    "side_dgrad_pool": (8, 64, 16),
}
# The modes the Hopper path takes, for C and D multiples of 8: the trunk's
# (K-steps of a chunk and a kernel row; 'fwd_fast', B2-seq's, has no other
# path), B5's and B6's dz (a chunk with all nine taps; a side of at most
# SIDE_D channels).
TRUNK_HOPPER_MODES = ("fwd", "fwd_pool", "dgrad", "fwd_fast")
SIDE_FWD_MODES = ("side", "side_pool")
SIDE_DZ_MODES = ("side_dgrad", "side_dgrad_pool")
# Inputs this narrow take the stem's kernels (9 * C <= 32).
STEM_MAX_C = 3
# csrc/stem.cu: pixels of a segment, output channels of a product and a
# store box, the most output channels its resident weights take, consumer
# warpgroups (one image row each) and strip slots.
STEM_SEG = 128
STEM_TILE_D = 64
STEM_MAX_D = 256
STEM_WGS = 3
STEM_SLOTS = 2 * STEM_WGS + 2
# SMs of an H100; the Hopper path runs at most one block on each.
NUM_SMS = 132
# Hopper path: pixels of a row segment (one m64 tile) and input channels of
# a K-step (one 128-byte swizzled row).
SEG = 64
CHUNK = 64
# The side convs' Hopper path: the side channels of its product (B5's N,
# B6's K), the image rows of B5's and B6's tiles, B6's dz channel tile, and
# B5's row segment (62 outputs from a 64-pixel box row, csrc/flatconv.cu).
SIDE_D = 16
SIDE_ROWS = 4
SIDE_DZ_ROWS = 2
SIDE_DZ_TILE = 64
SIDE_FWD_SEG = SEG - 2

Pool = Tuple[torch.Tensor, torch.Tensor]
BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    """How csrc/flatconv.cu runs one launch.

    ``path`` is 'hopper', 'stem' or 'mma'; the weight operand is padded
    to ``tile_n`` output and ``tile_c`` input channels. Hopper path: block
    tiles of ``rows`` image rows x one ``seg``-pixel row segment x
    ``tile_n`` channels, ``tiles`` of them in the order of ``tile``, on
    ``blocks`` blocks (block b takes tiles b, b + blocks, ...). Stem path:
    ``blocks`` blocks, each a run of the n x ``groups`` image rows
    (``stem_wgrad.row_runs``), ``segs`` segments of ``seg`` pixels a row
    and ``n_tiles`` channel tiles a segment."""
    path: str
    tile_n: int
    tile_c: int
    rows: int = 0
    n: int = 0
    groups: int = 0
    segs: int = 0
    n_tiles: int = 0
    blocks: int = 0
    seg: int = SEG

    @property
    def tiles(self) -> int:
        return self.n * self.groups * self.segs * self.n_tiles

    def tile(self, t: int) -> Tuple[int, int, int, int]:
        """(image, first row, first column, first output channel) of tile
        ``t``: the output-channel tile fastest, then the row segment, the
        row group and the image, as the kernel's ``tile_at``."""
        t, nt = divmod(t, self.n_tiles)
        t, seg = divmod(t, self.segs)
        img, grp = divmod(t, self.groups)
        return img, grp * self.rows, seg * self.seg, nt * self.tile_n


@functools.lru_cache(maxsize=None)
def plan(n: int, h: int, w: int, cin: int, cout: int,
         mode: str = "fwd") -> Plan:
    """The path and tiling of one launch of ``mode`` whose product reads
    (n, h, w, cin) and writes (n, h, w, cout).

    With cin and cout multiples of 8 (16-byte rows, as TMA needs) the
    Hopper path takes:
    - the trunk forward and dz: tiles of 4 image rows x 64 output channels
      for cout <= 64, else 2 x 128 (128 float32 accumulators a thread
      either way), 64-channel input chunks;
    - B5 (cout <= SIDE_D): tiles of SIDE_ROWS rows (2 where that would
      leave fewer than two tiles per SM) x SIDE_FWD_SEG pixels x all SIDE_D
      output channels, 64-channel input chunks;
    - B6's dz (cin <= SIDE_D): tiles of SIDE_DZ_ROWS rows x SIDE_DZ_TILE dz
      channels over the SIDE_D channels of g; the blocks are a multiple of
      the channel tiles, so each block keeps one tile's weights.
    Every tile has an even number of rows and starts on an even row and
    column, so the 2x2 pool windows lie in one tile. One block per SM, or
    one per tile when there are fewer. The stem (cin <= STEM_MAX_C) with
    cout a multiple of 8, at most STEM_MAX_D, takes the stem path: one
    block per SM, or one per image row where there are fewer, each a run
    of image rows, while its shared memory (``stem_smem``) fits. Every
    other launch (other channel counts) takes the mma path with the mode's
    tiles."""
    if (mode == "stem" and cin <= STEM_MAX_C and cout % 8 == 0
            and cout <= STEM_MAX_D and stem_smem(w, cin, cout) <= _stem.SMEM_LIMIT):
        return Plan("stem", STEM_TILE_D, 32, 1, n, h, -(-w // STEM_SEG),
                    -(-cout // STEM_TILE_D), min(NUM_SMS, n * h), STEM_SEG)
    if cin % 8 == 0 and cout % 8 == 0:
        if mode in TRUNK_HOPPER_MODES:
            tile_n = 64 if cout <= 64 else 128
            return _hopper(n, h, w, cout, tile_n, CHUNK,
                           4 if tile_n == 64 else 2)
        if mode in SIDE_FWD_MODES and cout <= SIDE_D:
            # 2-row tiles where 4-row ones would not fill two waves
            wide = n * -(-h // SIDE_ROWS) * -(-w // SIDE_FWD_SEG) >= 2 * NUM_SMS
            return _hopper(n, h, w, cout, SIDE_D, CHUNK,
                           SIDE_ROWS if wide else 2, seg=SIDE_FWD_SEG)
        if (mode in SIDE_DZ_MODES and cin <= SIDE_D
                and -(-cout // SIDE_DZ_TILE) <= NUM_SMS):
            return _hopper(n, h, w, cout, SIDE_DZ_TILE, SIDE_D, SIDE_DZ_ROWS,
                           whole_channel_tiles=True)
    _, tn, tc = _MODES[mode]
    return Plan("mma", tn, tc)


def stem_smem(w: int, c: int, d: int) -> int:
    """Dynamic shared memory of a stem-path block (``csrc/stem.cu``
    ``smem_bytes``): each warpgroup's im2col tile and two staging tiles,
    the resident weights, the strip's slots and the zero row."""
    d_p = -(-d // STEM_TILE_D) * STEM_TILE_D
    return (1024 + STEM_WGS * (STEM_SEG * 64 + 2 * STEM_SEG * STEM_TILE_D * 2)
            + d_p * 64 + (STEM_SLOTS + 1) * _stem.slot_bytes(w, c))


def _hopper(n: int, h: int, w: int, cout: int, tile_n: int, tile_c: int,
            rows: int, whole_channel_tiles: bool = False,
            seg: int = SEG) -> Plan:
    groups, segs = -(-h // rows), -(-w // seg)
    n_tiles = -(-cout // tile_n)
    per = n_tiles if whole_channel_tiles else 1
    blocks = min(NUM_SMS // per * per, n * groups * segs * n_tiles)
    return Plan("hopper", tile_n, tile_c, rows, n, groups, segs, n_tiles,
                blocks, seg)


def seq_fwd_takes(n: int, h: int, w: int, c: int, d: int) -> bool:
    """Whether ``conv_fwd_seq`` takes sequences of (N, H, W, C) -> D
    channels: C over STEM_MAX_C, and C and D on the Hopper path (multiples
    of 8)."""
    return c > STEM_MAX_C and plan(n, h, w, c, d, "fwd_fast").path == "hopper"


def conv3x3_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """float32 SAME conv of NHWC ``x``'s values with the bf16-rounded OIHW
    ``weight``, TF32 off: the products the kernels sum."""
    with exact_f32():
        y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.to(BF16).float(),
                     padding=1)
    return y.permute(0, 2, 3, 1)


def _conv3x3_t_f32(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The input gradient of ``conv3x3_f32`` for cotangent ``g``."""
    with exact_f32():
        dx = F.conv_transpose2d(g.float().permute(0, 3, 1, 2),
                                weight.to(BF16).float(), padding=1)
    return dx.permute(0, 2, 3, 1)


def conv_fwd_ref(x, weight, bias, pool=False):
    y = (conv3x3_f32(x, weight) + bias.float()).clamp_min(0).to(BF16)
    return y, (pool_fwd(y) if pool else None)


def conv_fwd_seq_ref(x, weight, bias):
    s, _, c = weight.shape[:3]
    y = torch.cat([conv3x3_f32(x[..., i * c:(i + 1) * c], weight[i]).to(BF16)
                   for i in range(s)], dim=-1)
    return F.relu(y + bias.to(BF16))


def conv_bwd_ref(x, weight, g=None, route: Optional[Tuple] = None):
    if route is not None:
        g = pool_bwd(*route)
    dz = (_conv3x3_t_f32(g, weight) * (x > 0)).to(BF16)
    return (dz, *wgrad_db_ref(x, g), g)


def wgrad_db_ref(x, g):
    return _wgrad.wgrad3x3_ref(x, g), g.float().sum((0, 1, 2))


def stem_bwd_ref(x, g):
    return _stem.stem_wgrad_ref(x, g)


def side_fwd_ref(x, weight, pool=False):
    return (conv3x3_f32(x, weight).to(BF16),
            pool_fwd(x) if pool else None)


def side_bwd_ref(x, weight, g, pool: Optional[Pool] = None):
    dz = _conv3x3_t_f32(g, weight) * (x > 0)
    if pool is not None:
        dz = dz + pool_bwd(x, *pool).float()
    return dz.to(BF16), _wgrad.wgrad3x3_ref(x, g)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def conv_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             pool: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B2: (y, pooled or None) for x (N, H, W, C) bf16, weight (D, C, 3, 3)
    and bias (D,) float32."""
    global fwd_launches
    if x.device.type == "cpu":
        return conv_fwd_ref(x, weight, bias, pool)
    n, h, w, c = _check("conv_fwd", x)
    d = _check_weight("conv_fwd", weight, c)
    mode = "fwd_pool" if pool else ("stem" if c <= STEM_MAX_C else "fwd")
    y = x.new_empty((n, h, w, d))
    pooled = x.new_empty((n, -(-h // 2), -(-w // 2), d)) if pool else None
    _launch(mode, x, weight, cout=d, y=y, bias=_f32(bias, d), pooled=pooled)
    fwd_launches += 1
    return y, pooled


def conv_fwd_seq(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """B2-seq: y (N, H, W, S * D) = relu(bf16(bf16(conv) + b)) of S
    sequences, x (N, H, W, S * C) bf16 with sequence s in the channels [s *
    C, (s + 1) * C), weight (S, D, C, 3, 3) float32, bias (S * D,) bf16
    (sequence s's in [s * D, (s + 1) * D)); C and D multiples of 8 and C
    more than STEM_MAX_C. One pack launch for the S weights, then one
    launch on the Hopper path, counted in ``seq_fwd_launches`` (not in
    ``fwd_launches``); S = 1 is the lone launch."""
    global seq_fwd_launches
    if weight.dim() != 5 or tuple(weight.shape[3:]) != (3, 3):
        raise ValueError(f"conv_fwd_seq: weight of shape {tuple(weight.shape)}, "
                         "expected (S, D, C, 3, 3)")
    s, d, c = weight.shape[:3]
    if x.dim() != 4 or x.shape[-1] != s * c:
        raise ValueError(f"conv_fwd_seq: x of shape {tuple(x.shape)} for "
                         f"{s} sequences of {c} channels")
    if tuple(bias.shape) != (s * d,) or bias.dtype != BF16:
        raise ValueError(f"conv_fwd_seq: bias {bias.dtype} "
                         f"{tuple(bias.shape)}, expected bfloat16 ({s * d},)")
    if x.device.type == "cpu":
        return conv_fwd_seq_ref(x, weight, bias)
    n, h, w, _ = _check("conv_fwd_seq", x)
    if not seq_fwd_takes(n, h, w, c, d):
        raise ValueError(f"conv_fwd_seq: no Hopper path for {c} -> {d} "
                         "channels (C and D multiples of 8, C over 3)")
    if bias.device != x.device or not bias.is_contiguous() or bias.data_ptr() % 16:
        raise ValueError("conv_fwd_seq: the bias must be a contiguous, "
                         "16-byte aligned tensor on x's device")
    y = x.new_empty((n, h, w, s * d))
    _launch("fwd_fast", x, weight, cout=d, y=y, bias=bias, s=s)
    seq_fwd_launches += 1
    return y


def conv_bwd(x: torch.Tensor, weight: torch.Tensor,
             g: Optional[torch.Tensor] = None,
             route: Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = None):
    """B3: (dz, dK, db, g) for the conv of x (N, H, W, C) whose output's
    cotangent is g (N, H, W, D) bf16, or, with ``route`` = (y, pooled,
    d_pooled), the cotangent that the pool of y routes from d_pooled; the
    last output is that cotangent. Two launches: the input gradient
    (``csrc/flatconv.cu``), then dK and db (``wgrad_db``, B4); with
    ``route``, the pool backward (``csrc/pool.cu``, counted as
    ``pool.bwd_launches``) before them."""
    global bwd_launches
    if x.device.type == "cpu":
        return conv_bwd_ref(x, weight, g, route)
    n, h, w, c = _check("conv_bwd", x)
    d = _check_weight("conv_bwd", weight, c)
    if route is not None:
        y, pooled, d_pooled = (_check_like("conv_bwd", t, s) for t, s in zip(
            route, ((n, h, w, d),) + ((n, -(-h // 2), -(-w // 2), d),) * 2))
        g = _pool.max_pool_bwd(y, pooled, d_pooled)
    else:
        g = _check_like("conv_bwd", g, (n, h, w, d))
    dz = torch.empty_like(x)
    _launch("dgrad", g, weight, cout=c, y=dz, z=x, flip=True)
    bwd_launches += 1
    dk, db = wgrad_db(x, g)
    return dz, dk, db, g


def wgrad_db(x: torch.Tensor, g: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: (dK (3, 3, C, D), db (D,)) float32 of the conv of x (N, H, W, C)
    bf16 whose output's cotangent is g (N, H, W, D) bf16: one launch of
    ``csrc/wgrad.cu`` with the bias-gradient column sum."""
    global wgrad_db_launches
    if x.device.type == "cpu":
        return wgrad_db_ref(x, g)
    dk, db = _wgrad.launch(x, g, with_db=True)
    wgrad_db_launches += 1
    return dk, db


def stem_bwd(x: torch.Tensor, g: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, db) of the stem conv of image x (N, H, W, 3) bf16 whose
    output's cotangent is g: one launch of B16 (``csrc/stem_wgrad.cu``),
    counted as ``stem_wgrad.launches``; on CPU tensors its plain version."""
    return _stem.stem_wgrad(x, g)


def side_fwd(x: torch.Tensor, weight: torch.Tensor, pool: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B5: (side (N, H, W, D) bf16, pool of x or None)."""
    global side_fwd_launches
    if x.device.type == "cpu":
        return side_fwd_ref(x, weight, pool)
    n, h, w, c = _check("side_fwd", x)
    d = _check_weight("side_fwd", weight, c)
    side = x.new_empty((n, h, w, d))
    pooled = x.new_empty((n, -(-h // 2), -(-w // 2), c)) if pool else None
    _launch("side_pool" if pool else "side", x, weight, cout=d, y=side,
            pooled=pooled)
    side_fwd_launches += 1
    return side, pooled


def side_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
             pool: Optional[Pool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6: (dz, dK) of the side conv of x with output cotangent g (N, H, W,
    D) bf16; ``pool`` = (pooled, d_pooled) adds the cotangent of x's pool.
    Two launches: ``csrc/flatconv.cu``, then dK from ``csrc/wgrad.cu``."""
    global side_bwd_launches
    if x.device.type == "cpu":
        return side_bwd_ref(x, weight, g, pool)
    n, h, w, c = _check("side_bwd", x)
    d = _check_weight("side_bwd", weight, c)
    g = _check_like("side_bwd", g, (n, h, w, d))
    dz = torch.empty_like(x)
    if pool is not None:
        pooled, d_pooled = (_check_like("side_bwd", t,
                                        (n, -(-h // 2), -(-w // 2), c))
                            for t in pool)
        _launch("side_dgrad_pool", g, weight, cout=c, y=dz, z=x, zp=pooled,
                dzp=d_pooled, flip=True)
    else:
        _launch("side_dgrad", g, weight, cout=c, y=dz, z=x, flip=True)
    dk, _ = _wgrad.launch_checked(x, g, with_db=False)
    side_bwd_launches += 1
    return dz, dk


def _weight_matrix(weight: torch.Tensor, tn: int, tc: int,
                   stem: bool = False) -> torch.Tensor:
    """The bf16 product operand of an OIHW (D, C, 3, 3) weight, zero-padded
    to the kernel's channel tiles: (9, D_p, C_p) [tap][out][in], or for the
    stem (D_p, 32) [out][tap * C + c]."""
    d, c = weight.shape[:2]
    d_pad = -(-d // tn) * tn - d
    if stem:
        m = weight.permute(0, 2, 3, 1).reshape(d, 9 * c).to(BF16)
        return F.pad(m, (0, tc - 9 * c, 0, d_pad)).contiguous()
    m = weight.permute(2, 3, 0, 1).reshape(9, d, c).to(BF16)
    return F.pad(m, (0, -(-c // tc) * tc - c, 0, d_pad)).contiguous()


def pack_weight_ref(weight: torch.Tensor, tile_n: int, tile_c: int,
                    flip: bool = False, stem: bool = False) -> torch.Tensor:
    """Plain version of ``pack_weight``: ``_weight_matrix`` of the OIHW
    weight or, with ``flip``, of its flipped transpose (C, D, 3, 3), the
    weight of an input gradient's product; of S stacked weights (S, D, C,
    3, 3), the S operands stacked."""
    if weight.dim() == 5:
        return torch.stack([pack_weight_ref(wi, tile_n, tile_c, flip, stem)
                            for wi in weight])
    if flip:
        weight = weight.flip(2, 3).transpose(0, 1)
    return _weight_matrix(weight, tile_n, tile_c, stem=stem)


def pack_weight(weight: torch.Tensor, tile_n: int, tile_c: int,
                flip: bool = False, stem: bool = False) -> torch.Tensor:
    """The bf16 product operand of an OIHW (D, C, 3, 3) weight that a
    ``csrc/flatconv.cu`` launch reads: (9, rows_p, cols_p) [tap][out][in]
    with the rows zero-padded to ``tile_n`` and the columns to ``tile_c``;
    with ``flip`` that of the flipped transpose (C rows, D columns); with
    ``stem`` the (D_p, tile_c) [out][tap * C + c] im2col operand; of S
    stacked weights (S, D, C, 3, 3), the S operands (S, ...). One launch of
    the pack kernel on a CUDA weight, counted in ``pack_launches``; the
    plain version on a CPU one."""
    if weight.device.type == "cpu":
        return pack_weight_ref(weight, tile_n, tile_c, flip, stem)
    with launch_stream(weight.device) as stream:
        return _pack(weight, tile_n, tile_c, flip, stem, stream)


def _pack(weight, tile_n, tile_c, flip, stem, stream) -> torch.Tensor:
    global pack_launches
    if weight.dim() not in (4, 5) or tuple(weight.shape[-2:]) != (3, 3):
        raise ValueError(f"pack_weight: weight of shape {tuple(weight.shape)}, "
                         "expected (D, C, 3, 3) or (S, D, C, 3, 3)")
    if weight.dtype != torch.float32 or not weight.is_contiguous():
        weight = weight.to(torch.float32).contiguous()
    lead = tuple(weight.shape[:-4])  # (S,) for stacked weights
    a, b = weight.shape[-4:-2]
    rows, cols = (b, a) if flip else (a, b)
    rows_p = -(-rows // tile_n) * tile_n
    if stem:
        shape = (rows_p, tile_c)
    else:
        shape = (9, rows_p, -(-cols // tile_c) * tile_c)
    out = torch.empty(lead + shape, dtype=BF16, device=weight.device)
    err = _entry("osvos_flat_pack_weight")(
        weight.data_ptr(), out.data_ptr(), a, b, rows_p, out.shape[-1],
        2 if stem else int(flip), lead[0] if lead else 1, stream)
    if err != 0:
        raise RuntimeError(f"flatconv pack_weight kernel launch failed: "
                           f"error {err}")
    pack_launches += 1
    return out


def _f32(t: torch.Tensor, size: int) -> torch.Tensor:
    if t.shape != (size,):
        raise ValueError(f"flatconv: bias of shape {tuple(t.shape)}, "
                         f"expected ({size},)")
    return t.to(torch.float32).contiguous()


def _check(name: str, x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    _check_like(name, x, tuple(x.shape))
    return tuple(x.shape)


def _check_weight(name: str, weight: torch.Tensor, c: int) -> int:
    """The output channels of an OIHW 3x3 weight over c input channels."""
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(f"{name}: weight of shape {tuple(weight.shape)}, "
                         f"expected (D, {c}, 3, 3)")
    return weight.shape[0]


def _check_like(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    if (t.device.type != "cuda" or t.dtype != BF16 or t.dim() != 4
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: expected a contiguous, 16-byte aligned NHWC bfloat16 "
            f"CUDA tensor of shape {tuple(shape)}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}, "
            f"contiguous={t.is_contiguous()}")
    return t


def _launch(mode: str, x: torch.Tensor, weight: torch.Tensor, cout: int,
            y: torch.Tensor, bias=None, pooled=None, z=None, zp=None,
            dzp=None, flip: bool = False, s: int = 1) -> None:
    """One launch of ``csrc/flatconv.cu`` on the path ``plan`` picks, after
    its weight operand's pack (B6's dz on the Hopper path packs its own):
    x is the product's input (the cotangent, for the input gradients),
    weight the layer's OIHW weight (its flipped transpose is the product's
    with ``flip``), cout the product's output channels. Mode 'fwd_fast'
    takes ``s`` sequences (x's channels and the stacked weight's leading
    axis). Counts the launch in ``hopper_launches``, ``stem_launches`` or
    ``mma_launches``."""
    global hopper_launches, mma_launches, stem_launches
    for t in (weight, bias, z, zp, dzp):
        if t is not None and t.device != x.device:
            raise ValueError(f"flatconv {mode}: tensors on two devices")
    number = _MODES[mode][0]
    n, h, w, cin = x.shape
    cin //= s
    p = plan(n, h, w, cin, cout, mode)
    stem = mode == "stem"
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with launch_stream(x.device) as stream:
        if p.path == "stem":
            # the blocks pack the weight operand from the float32 weight
            if weight.dtype != torch.float32 or not weight.is_contiguous():
                weight = weight.to(torch.float32).contiguous()
            err = _entry("osvos_stem_fwd", "stem")(
                x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                n, h, w, cin, cout, p.blocks, stream)
        elif p.path == "hopper" and mode in SIDE_DZ_MODES:
            # each block packs its tile of the flipped operand from the
            # float32 weight itself: no pack launch
            if weight.dtype != torch.float32 or not weight.is_contiguous():
                weight = weight.to(torch.float32).contiguous()
            err = _entry("osvos_flat_side_tma")(
                number, x.data_ptr(), weight.data_ptr(), y.data_ptr(), None,
                z.data_ptr(), ptr(zp), ptr(dzp), n, h, w, cin, cout, SIDE_D,
                p.n_tiles * p.tile_n, p.rows, p.blocks, stream)
        else:
            wm = _pack(weight, p.tile_n, p.tile_c, flip, stem, stream)
            cin_p = p.tile_c if stem else wm.shape[-1]
            if p.path == "hopper" and mode in SIDE_FWD_MODES:
                err = _entry("osvos_flat_side_tma")(
                    number, x.data_ptr(), wm.data_ptr(), y.data_ptr(),
                    ptr(pooled), None, None, None, n, h, w, cin, cout, cin_p,
                    wm.shape[-2], p.rows, p.blocks, stream)
            elif p.path == "hopper":
                err = _entry("osvos_flat_conv3x3_tma")(
                    number, x.data_ptr(), wm.data_ptr(), ptr(bias),
                    y.data_ptr(), ptr(pooled), ptr(z), n, h, w, cin, cout,
                    cin_p, wm.shape[-2], p.tile_n, p.rows, p.blocks, s, stream)
            else:
                err = _entry("osvos_flat_conv3x3")(
                    number, x.data_ptr(), wm.data_ptr(), ptr(bias),
                    y.data_ptr(), ptr(pooled), ptr(z), ptr(zp), ptr(dzp), n,
                    h, w, cin, cout, cin_p, wm.shape[-2], stream)
    if err != 0:
        raise RuntimeError(f"flatconv {mode} kernel ({p.path} path) launch "
                           f"failed: error {err}")
    if p.path == "hopper":
        hopper_launches += 1
    elif p.path == "stem":
        stem_launches += 1
    else:
        mma_launches += 1


_ARGTYPES = {
    "osvos_flat_conv3x3_tma": [ctypes.c_int] + [ctypes.c_void_p] * 6
                              + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    "osvos_flat_side_tma": [ctypes.c_int] + [ctypes.c_void_p] * 7
                           + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "osvos_flat_pack_weight": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                              + [ctypes.c_void_p],
    "osvos_flat_conv3x3": [ctypes.c_int] + [ctypes.c_void_p] * 8
                          + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "osvos_stem_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str, source: str = "flatconv"):
    from osvos_torch.ops.kernels.build import load_library

    fn = getattr(load_library(source), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn
