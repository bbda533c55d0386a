"""The Hopper path of the int8 conv (``int8conv.int8_conv3x3_q``), on the CPU.

The entry takes the bf16 activation and its scale. Here it runs its plain
version: ``quantize_activation``, then the plain I1. Its output is held to
the JAX package's ``_Int8Conv`` under the three scale rules. The kernel's
own arithmetic and layout are restated in numpy and held to the plain
version bit for bit:
- the quantization without division (``q_fast`` in ``csrc/int8conv.cu``:
  a product and two fused multiply-add corrections), over every bf16 value
  at several scales;
- the tiles, the swizzled box and int8 tile, the tap-shifted descriptors,
  the weight packing and the K order of the chunks.
The dynamic rule's max chain and the model's cached static scales are
checked too. No JAX Pallas kernel runs here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.models.vgg_osvos import _Int8Conv
from osvos_torch.configs import ModelConfig
from osvos_torch.models import OSVOS, init_osvos_params
from osvos_torch.models.surgery import spread_head
from osvos_torch.ops.kernels import int8conv
from osvos_torch.ops.pool import max_pool_ceil

TINY8 = ModelConfig(stages=((8, 8), (12, 12), (16, 16, 16), (16, 16, 16),
                            (16, 16, 16)), side_channels=8,
                    compute_mode="int8")
# widths that put every conv after the stem on the Hopper path's shapes
WIDE8 = ModelConfig(stages=((8, 32), (64, 64), (64, 128, 64), (64, 64, 64),
                            (64, 64, 64)), side_channels=8,
                    compute_mode="int8")


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _one_rounding(got, want):
    """bf16 outputs within one bf16 rounding (XLA may contract the
    epilogue's multiply and add): |got - want| <= 2^-7 of the larger."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
    return bool(np.all(np.abs(got - want) <= np.maximum(ulp, 1e-30)))


@pytest.mark.parametrize("rule", ["given", "static", "dynamic"])
@pytest.mark.parametrize("cin,cout", [(32, 64), (12, 16)])
def test_q_entry_equals_jax_int8conv(rule, cin, cout):
    """``int8_conv3x3_q`` on bf16 x against ``_Int8Conv`` (then its ReLU),
    run op by op: within one bf16 rounding; and bit for bit the plain I1
    of the quantized operand, which is what the kernels compute."""
    rng = np.random.RandomState(cin + cout)
    x = (np.abs(rng.randn(2, 7, 11, cin)) * 3).astype(np.float32)
    kernel = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    bias = (rng.randn(cout) * 0.5).astype(np.float32)
    static = 7.3  # under max|x|: some codes clip
    xb = _bf16(x)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    mod = _Int8Conv(features=cout, act_scale=static if rule == "static" else None)
    params = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    traced = jnp.float32(static) if rule == "given" else None
    want = np.asarray(jax.nn.relu(mod.apply(params, xj, act_scale=traced))
                      .astype(jnp.float32))
    w_q, w_scale = int8conv.quantize_weight(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    x_scale = int8conv.activation_scale(
        xb, static=static if rule == "static" else None,
        given=torch.tensor(static) if rule == "given" else None)
    b = torch.from_numpy(bias)
    got = int8conv.int8_conv3x3_q(xb, x_scale, w_q, w_scale, b)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 7, 11, cout)
    assert _one_rounding(got.float().numpy(), want)
    plain = int8conv.int8_conv3x3(int8conv.quantize_activation(xb, x_scale), w_q,
                                  x_scale * w_scale, b)
    assert torch.equal(got, plain)


# --- the kernel's quantization, restated -------------------------------------

def _fma32(a, b, c) -> np.ndarray:
    """RN32(a * b + c) of float32 arrays, rounded once: the product is
    exact in float64; the sum's rounding error is recovered (TwoSum) and
    decides where the float64 sum falls exactly halfway between two
    float32."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    away = np.nextafter(r, np.where(s > r64, np.float32(np.inf), np.float32(-np.inf)))
    halfway = (s != r64) & (2 * s == r64 + away.astype(np.float64))
    beyond = halfway & (np.sign(err) == np.sign(s - r64)) & (err != 0)
    return np.where(beyond, away, r)


def _q_fast(x: np.ndarray, s: np.float32) -> np.ndarray:
    """csrc/int8conv.cu ``q_fast`` in float32 numpy: t = x * RN(1 / s), two
    corrections by fused multiply-adds, t itself where |t| >= 128, the
    clamp, and the round by the add of 1.5 * 2^23."""
    f32 = np.float32
    x = x.astype(f32)
    s = f32(s)
    big = f32(12582912.0)
    r = f32(1.0) / s
    with np.errstate(over="ignore", invalid="ignore"):  # the clamp takes it
        t = x * r
        q1 = _fma32(r, _fma32(-s, t, x), t)
        q = _fma32(r, _fma32(-s, q1, x), q1)
        v = np.where(np.abs(t) < 128, q, t)
        v = np.minimum(np.maximum(v, f32(-127)), f32(127))
    return ((v + big) - big).astype(np.int8)


def _all_bf16() -> np.ndarray:
    """Every finite bf16 value as float32."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    vals = bits.view(np.float32)
    return vals[np.isfinite(vals)]


@pytest.mark.parametrize("scale_from", ["bf16 max", "odd", "tied", "tiny"])
def test_kernel_quantization_equals_quantize_activation(scale_from):
    """The kernel's division-free rule gives ``quantize_activation``'s
    codes for every finite bf16 value: at dynamic scales of bf16 maxes
    (where x / s lands on or near halves often), odd scales, powers of two
    (exact ties) and scales near the ends of the range it takes."""
    vals = _all_bf16()
    xt = torch.from_numpy(vals).to(torch.bfloat16)
    assert torch.equal(xt.float(), torch.from_numpy(vals))
    if scale_from == "bf16 max":
        maxes = [12.25, 46.5, 6.375, 3.953125, 0.0234375, 255.0]
        scales = [int8conv.scale_from_max(torch.tensor(m, dtype=torch.float32))
                  for m in maxes]
    elif scale_from == "odd":
        scales = [torch.tensor(v, dtype=torch.float32) for v in (0.0371, 1.7, 9.3e-3)]
    elif scale_from == "tied":
        scales = [torch.tensor(v, dtype=torch.float32) for v in (0.125, 2.0, 2.0 ** -9)]
    else:
        scales = [torch.tensor(v, dtype=torch.float32)
                  for v in (3e-15, 2.0 ** -59, 2.0 ** 59, 7.1e17)]
    for s in scales:
        want = int8conv.quantize_activation(xt, s).numpy()
        got = _q_fast(vals, np.float32(float(s)))
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (float(s), vals[bad[:5]], got[bad[:5]], want[bad[:5]])


# --- the Hopper path's layout, restated -------------------------------------

def _swz(addr: np.ndarray, bits: int) -> np.ndarray:
    """The 16-byte chunk index of byte address ``addr`` XORed with its bits
    7.. (``bits`` of them: 2 for the 64-byte swizzle, 3 for the 128-byte
    one), as TMA writes and wgmma reads a 1024-byte aligned buffer."""
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def _hopper_model_acc(x_q, packed, cin, cout):
    """csrc/int8conv.cu's Hopper path on int8 codes: per tile and chunk
    the 6 x 66 x 64-channel box in the 128-byte swizzle (x_q as bf16
    codes, quantized with scale 1), the quantizer's units into the int8
    tile in the 64-byte swizzle, each kernel row's weight stage, and nine
    taps x two k32 steps of descriptors started kw rows and kh box rows in,
    read through the 64-byte swizzle."""
    n, h, w, _ = x_q.shape
    tn = int8conv.hopper_tile_n(cout)
    rows, seg, ch = int8conv.HOPPER_ROWS, int8conv.HOPPER_SEG, int8conv.HOPPER_CHUNK
    chunks = -(-cin // ch)
    tiles = n * -(-h // rows) * -(-w // seg) * (cout // tn)
    out = np.full((n, h, w, cout), -1 << 40, np.int64)
    boxw, pix = seg + 2, (rows + 2) * (seg + 2)
    for t in range(tiles):
        img, h0, w0, d0 = int8conv.hopper_tile(t, n, h, w, cout)
        acc = np.zeros((rows, seg, tn), np.int64)
        for c in range(chunks):
            box = np.zeros((rows + 2, boxw, ch), np.int64)
            for r in range(rows + 2):
                for q in range(boxw):
                    hh, ww = h0 - 1 + r, w0 - 1 + q
                    if 0 <= hh < h and 0 <= ww < w:
                        part = x_q[img, hh, ww, ch * c:ch * c + ch]
                        box[r, q, :part.shape[0]] = part
            # the bf16 box as TMA lays it: pixel row p, 16-byte chunk j at
            # the swizzled address; values are the codes (scale 1)
            xs = np.zeros(pix * 128, np.int64)
            flat = box.reshape(pix, ch)
            addr = np.arange(pix)[:, None] * 128 + np.arange(8)[None, :] * 16
            for j in range(8):
                for e in range(8):
                    xs[_swz(addr[:, j], 3) + 2 * e] = flat[:, 8 * j + e]
            # the quantizer's units: (p, c16) reads chunks 2 c16, 2 c16 + 1
            tile = np.zeros(pix * 64, np.int64)
            for u in range(pix * 4):
                p, c16 = divmod(u, 4)
                vals = []
                for j in (2 * c16, 2 * c16 + 1):
                    src = p * 128 + ((j ^ (p & 7)) << 4)
                    vals += [xs[src + 2 * e] for e in range(8)]
                dst = p * 64 + ((c16 ^ ((p >> 1) & 3)) << 4)
                tile[dst:dst + 16] = vals
            for kh in range(3):
                # the stage: taps (kh, 0..2), TN rows of 64 channels each,
                # zero past Cout and Cin, in the 64-byte swizzle
                wst = np.zeros(3 * tn * 64, np.int64)
                for kw in range(3):
                    rowsw = np.zeros((tn, ch), np.int64)
                    part = packed[3 * kh + kw, d0:d0 + tn, ch * c:ch * c + ch]
                    rowsw[:part.shape[0], :part.shape[1]] = part
                    a = kw * tn * 64 + np.arange(tn)[:, None] * 64 + np.arange(64)[None, :]
                    wst[_swz(a, 2)] = rowsw
                for kw in range(3):
                    for kk in range(2):
                        b0 = kw * tn * 64 + kk * 32
                        ba = b0 + np.arange(tn)[:, None] * 64 + np.arange(32)[None, :]
                        bmat = wst[_swz(ba, 2)]
                        for o in range(rows):
                            a0 = ((o + kh) * boxw + kw) * 64 + kk * 32
                            aa = a0 + np.arange(seg)[:, None] * 64 + np.arange(32)[None, :]
                            acc[o] += tile[_swz(aa, 2)] @ bmat.T
        for o in range(rows):
            for m in range(seg):
                if h0 + o < h and w0 + m < w:
                    out[img, h0 + o, w0 + m, d0:d0 + tn] = acc[o, m]
    return out


@pytest.mark.parametrize("cin,cout,h,w", [(32, 64, 1, 70), (64, 64, 3, 67),
                                          (128, 128, 1, 29), (64, 192, 1, 9)])
def test_hopper_layout_equals_ref(cin, cout, h, w):
    rng = np.random.RandomState(cin + cout + w)
    x_q = rng.randint(-127, 128, size=(2, h, w, cin)).astype(np.int8)
    w_q = rng.randint(-127, 128, size=(cout, cin, 3, 3)).astype(np.int8)
    packed = int8conv.pack_weight_hopper(torch.from_numpy(w_q)).numpy()
    assert packed.shape == (9, cout, cin) and int8conv.hopper_takes(cin, cout)
    np.testing.assert_array_equal(
        packed, w_q.transpose(2, 3, 0, 1).reshape(9, cout, cin))
    want = int8conv.int8_conv3x3_acc_ref(torch.from_numpy(x_q),
                                         torch.from_numpy(w_q)).numpy()
    np.testing.assert_array_equal(_hopper_model_acc(x_q, packed, cin, cout), want)


@pytest.mark.parametrize("cin,cout,takes", [(64, 64, True), (512, 512, True),
                                            (32, 128, True), (12, 64, False),
                                            (48, 64, False), (64, 8, False),
                                            (64, 96, False)])
def test_hopper_takes_and_pack_for(cin, cout, takes):
    """The shape alone picks the path, and ``pack_for`` packs for it."""
    assert int8conv.hopper_takes(cin, cout) is takes
    w_q = torch.zeros((cout, cin, 3, 3), dtype=torch.int8)
    want = ((9, cout, cin) if takes else
            (-(-cout // int8conv.TILE_N) * int8conv.TILE_N, int8conv.packed_width(cin)))
    assert tuple(int8conv.pack_for(w_q).shape) == want


def test_hopper_tiles_cover_the_output_once():
    """``hopper_tile`` in the kernel's order covers every output element
    of a ragged shape once, the channel tile fastest."""
    n, h, w, cout = 2, 9, 130, 192
    tn = int8conv.hopper_tile_n(cout)
    seen = np.zeros((n, h, w, cout), np.int64)
    tiles = n * -(-h // 4) * -(-w // 64) * (cout // tn)
    first = [int8conv.hopper_tile(t, n, h, w, cout) for t in range(cout // tn)]
    assert [d for *_, d in first] == list(range(0, cout, tn))
    for t in range(tiles):
        img, h0, w0, d0 = int8conv.hopper_tile(t, n, h, w, cout)
        seen[img, h0:h0 + 4, w0:w0 + 64, d0:d0 + tn] += 1
    assert (seen == 1).all()


# --- the dynamic rule's max chain -------------------------------------------

def _kernel_max(y: torch.Tensor) -> float:
    """The kernel's max: the float bits of the bf16 outputs, -0.0 as +0.0,
    the largest as an unsigned integer."""
    bits = (y.view(torch.int16).numpy().astype(np.uint32) & 0xffff) << 16
    bits[bits == 0x80000000] = 0
    return float(np.uint32(bits.max()).view(np.float32))


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("hw", [(9, 13), (1, 7), (8, 10)])
@pytest.mark.parametrize("case", ["random", "zeros", "negative zero"])
def test_dynamic_max_chain(pool, hw, case):
    """The max that a conv folds into ``max_out`` gives, through
    ``scale_from_max``, the next conv's ``activation_scale`` bit for bit:
    directly and after the ceil-mode pool of a stage boundary, for an
    all-zero output and for one holding -0.0."""
    rng = np.random.RandomState(hw[0] * 31 + hw[1])
    cin, cout = 32, 64
    x = _bf16(np.abs(rng.randn(2, *hw, cin)) * 2)
    w_q, w_scale = int8conv.quantize_weight(torch.from_numpy(
        rng.randn(cout, cin, 3, 3).astype(np.float32)))
    bias = torch.from_numpy((rng.randn(cout) * 0.3).astype(np.float32))
    if case != "random":
        w_scale = torch.zeros_like(w_scale)  # float(acc) * 0 is +-0.0
        bias = torch.full_like(bias, -0.0 if case == "negative zero" else -1.0)
    x_scale = int8conv.activation_scale(x)
    max_out = torch.zeros((), dtype=torch.float32)
    y = int8conv.int8_conv3x3_q(x, x_scale, w_q, w_scale, bias, max_out=max_out)
    if case == "negative zero":
        assert bool((y.view(torch.int16) == -32768).any())  # -0.0 is there
    if case != "random":
        assert float(y.float().abs().max()) == 0.0
    assert float(max_out) == _kernel_max(y)
    nxt = max_pool_ceil(y) if pool else y
    want = int8conv.activation_scale(nxt)
    got = int8conv.scale_from_max(max_out)
    assert got.dtype == want.dtype == torch.float32
    assert got.view(torch.int32).item() == want.view(torch.int32).item()


def test_max_out_folds_into_what_is_there():
    """``max_out`` keeps the larger of what it holds and the output's max,
    and refuses a conv without the ReLU."""
    x = _bf16(np.ones((1, 3, 3, 32)))
    w_q = torch.ones((64, 32, 3, 3), dtype=torch.int8)
    w_scale = torch.full((64,), 1e-3)
    bias = torch.zeros(64)
    m = torch.tensor(1e6, dtype=torch.float32)
    int8conv.int8_conv3x3_q(x, torch.tensor(1 / 127), w_q, w_scale, bias, max_out=m)
    assert float(m) == 1e6
    m = torch.zeros((), dtype=torch.float32)
    y = int8conv.int8_conv3x3_q(x, torch.tensor(1 / 127), w_q, w_scale, bias, max_out=m)
    assert float(m) == float(y.float().max()) > 0


# --- the model's scales -----------------------------------------------------

def _model(cfg, x, seed=0):
    fast = dataclasses.replace(cfg, compute_mode="fast", int8_scales=None)
    model = OSVOS(fast)
    model.load_state_dict(init_osvos_params(fast, torch.Generator().manual_seed(seed)))
    spread_head(model, torch.from_numpy(x))
    int8 = OSVOS(cfg)
    int8.load_state_dict(model.state_dict())
    return int8


def test_static_scales_are_built_once_per_model():
    """The static rule's x_scales are one float32 tensor per model and
    device, each ``float32(static / 127)`` as the division in float64
    gives it, and a forward reuses the tensor."""
    rng = np.random.RandomState(3)
    x = (rng.randn(1, 33, 49, 3) * 40).astype(np.float32)
    scales = tuple(float(v) for v in rng.rand(13) * 50 + 0.1)
    cfg = dataclasses.replace(TINY8, int8_scales=scales)
    model = _model(cfg, x)
    with torch.no_grad():
        model(torch.from_numpy(x), mode="infer")
        table = model._static_x_scales[torch.device("cpu")]
        model(torch.from_numpy(x), mode="infer")
    assert model._static_x_scales[torch.device("cpu")] is table
    assert table.dtype == torch.float32
    np.testing.assert_array_equal(
        table.numpy(), np.array([np.float32(s / 127.0) for s in scales]))
    for i, s in enumerate(scales):
        one = int8conv.activation_scale(torch.zeros(1), static=s)
        assert one.view(torch.int32).item() == table[i].view(torch.int32).item()


@pytest.mark.parametrize("cfg", [TINY8, WIDE8], ids=["tiny", "wide"])
def test_dynamic_model_equals_per_conv_reduction(cfg, monkeypatch):
    """The dynamic rule through the per-forward max buffer gives the maps
    that a max|x| reduction of every int8 conv's input gives, bit for bit
    (the rule before the buffer)."""
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 37, 53, 3) * 40).astype(np.float32)
    model = _model(cfg, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mode="infer_parts")
        monkeypatch.setattr(
            OSVOS, "_x_scale",
            lambda self, x, idx, act_scales, maxes: int8conv.activation_scale(x))
        want = model(torch.from_numpy(x), mode="infer_parts")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
