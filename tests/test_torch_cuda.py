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

from osvos_torch.configs import ModelConfig, OnlineConfig
from osvos_torch.evaluation.infer import make_infer_fn
from osvos_torch.models import OSVOS, init_osvos_params
from osvos_torch.models.surgery import spread_head
from osvos_torch.ops import loss as port_loss
from osvos_torch.ops.kernels import (cbbce, flatconv, fused_head, int8conv,
                                     stem_wgrad, wgrad)
from osvos_torch.ops.kernels import pool as kpool
from osvos_torch.ops.pool import pool_bwd, pool_fwd
from osvos_torch.train.online import make_fine_tune_fn

pytestmark = pytest.mark.cuda

FACTORS = (2, 4, 8, 16)
TINY = ModelConfig(stages=((8, 8), (12, 12), (16, 16, 16), (16, 16, 16),
                           (16, 16, 16)), side_channels=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _contribs(b, h, w, device, seed=0, std=3.0, scales=len(FACTORS)):
    rng = np.random.RandomState(seed)
    shapes = []
    for _ in FACTORS[:scales]:
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


# (B, (H, W), scales): one row, one column, one pixel, a ragged W, B = 7,
# one and two scales, rows wider than a block's 1024 threads, and W = 4000,
# where a piece has fewer rows to fit shared memory
ODD_TAILS = [(2, (1, 854), 4), (3, (480, 1), 4), (2, (1, 1), 4), (2, (33, 17), 4),
             (7, (65, 97), 4), (2, (65, 97), 1), (7, (9, 17), 2), (1, (5, 2500), 4),
             (1, (3, 4000), 4)]


@pytest.mark.parametrize("b,hw,scales", ODD_TAILS)
def test_fused_head_kernel_odd_shapes(cuda, b, hw, scales):
    cs = _contribs(b, *hw, cuda, seed=hw[0] + hw[1], scales=scales)
    bias = torch.tensor([0.5], device=cuda)
    factors = FACTORS[:scales]
    before = fused_head.launches
    got = fused_head.fused_upsample_sigmoid_u8(cs, bias, hw, factors)
    torch.cuda.synchronize()
    assert fused_head.launches == before + 1
    want = fused_head.fused_upsample_sigmoid_u8_ref(cs, bias, hw, factors)
    assert got.dtype == torch.uint8 and got.shape == (b, *hw) and got.is_cuda
    assert int((got.int() - want.int()).abs().max()) <= 1
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


def _logits_labels(b, n, device, seed=0):
    """Logits of std 5 with some at +-100, labels in [0, 1) of which about
    30% reach 0.5."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n).astype(np.float32) * 5
    x.reshape(-1)[::997] = 100.0
    x.reshape(-1)[::1009] = -100.0
    z = rng.rand(b, n).astype(np.float32) * 0.72
    return torch.from_numpy(x).to(device), torch.from_numpy(z).to(device)


CBBCE_SHAPES = [(5, 480 * 854), (3, 33 * 49), (1, 5 * 480 * 854), (2, 7),
                (1, 1), (1, 3), (4096, 33), (7, 4097)]


@pytest.mark.parametrize("b,n", CBBCE_SHAPES)
def test_cbbce_stats_kernel_matches_ref(cuda, b, n):
    """Counts exact; sums within 1e-5 relative (float32 sums taken in
    another order); two launches give the same bits, with a launch on other
    inputs between them."""
    x, z = _logits_labels(b, n, cuda)
    x2, z2 = _logits_labels(b, n, cuda, seed=3)
    before = cbbce.stats_launches
    got = cbbce.cbbce_stats(x, z)
    other = cbbce.cbbce_stats(x2, z2)
    again = cbbce.cbbce_stats(x, z)
    torch.cuda.synchronize()
    assert cbbce.stats_launches == before + 3
    torch.testing.assert_close(other, cbbce.cbbce_stats_ref(x2, z2), rtol=1e-5, atol=0)
    want = cbbce.cbbce_stats_ref(x, z)
    assert got.shape == (b, 4) and got.dtype == torch.float32
    assert torch.equal(got[:, :2], want[:, :2])
    assert torch.equal(got[:, 0] + got[:, 1], torch.full((b,), float(n), device=cuda))
    torch.testing.assert_close(got[:, 2:], want[:, 2:], rtol=1e-5, atol=0)
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("b,n", CBBCE_SHAPES)
def test_cbbce_grad_kernel_matches_ref(cuda, b, n):
    x, z = _logits_labels(b, n, cuda, seed=1)
    w = torch.rand(b, 4, device=cuda) + 0.1
    before = cbbce.grad_launches
    got = cbbce.cbbce_grad(x, z, w)
    torch.cuda.synchronize()
    assert cbbce.grad_launches == before + 1
    want = cbbce.cbbce_grad_ref(x, z, w)
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


def test_cbbce_stats_on_two_streams_equal_serial_calls(cuda):
    """Launches on two streams at once (the per-sample shape and many small
    samples) give the bits of serial calls: nothing is shared between
    calls."""
    inputs = [_logits_labels(5, 480 * 854, cuda, seed=4), _logits_labels(4096, 33, cuda, seed=5)]
    serial = [cbbce.cbbce_stats(x, z) for x, z in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(10):
        for stream, (x, z) in zip(streams, inputs):
            with torch.cuda.stream(stream):
                outs.append(cbbce.cbbce_stats(x, z))
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        assert torch.equal(out, serial[i % 2])


@pytest.mark.parametrize("b,n", [(5, 480 * 854), (1, 5 * 480 * 854)])
def test_cbbce_stats_is_one_device_kernel_per_call(cuda, b, n):
    """Five calls under the profiler, after a warm-up cycle of the
    profiler itself: every device activity is the statistics kernel and
    there are at most five (the profiler can miss an event; a second
    kernel or a memset a call would show ten)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    x, z = _logits_labels(b, n, cuda)
    cbbce.cbbce_stats(x, z)
    torch.cuda.synchronize()
    # a window the profiler returns empty (it happens on the card's
    # machine) is profiled again, as chip_smoke.py's device_events does
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(5):
                    cbbce.cbbce_stats(x, z)
                torch.cuda.synchronize()
                prof.step()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert 0 < len(names) <= 5 and all("stats_kernel" in name for name in names), names


def test_cbbce_kernels_reject_what_they_do_not_take(cuda):
    x, z = _logits_labels(2, 64, cuda)
    with pytest.raises(ValueError):
        cbbce.cbbce_stats(x.double(), z)
    with pytest.raises(ValueError):
        cbbce.cbbce_stats(x.t().contiguous().t(), z)
    with pytest.raises(ValueError):
        cbbce.cbbce_grad(x, z, torch.ones(2, 4, device=cuda).half())
    with pytest.raises(ValueError):
        cbbce.cbbce_grad(x, z.cpu(), torch.ones(2, 4, device=cuda))


@pytest.mark.parametrize("impl_loss", ["whole", "per_sample"])
def test_kernel_loss_matches_plain_loss_on_card(cuda, impl_loss):
    x, z = _logits_labels(3, 65 * 97, cuda, seed=2)
    x = x.reshape(3, 65, 97, 1).requires_grad_(True)
    z = (z > 0.5).float().reshape(3, 65, 97, 1)
    w = torch.tensor([0.5, 1.0, 2.0], device=cuda)
    out = {}
    for impl in ("xla", "pallas"):
        if impl_loss == "whole":
            loss = port_loss.class_balanced_cross_entropy_loss(x, z, impl=impl)
        else:
            loss = (port_loss.class_balanced_cross_entropy_loss_per_sample(
                x, z, impl=impl) * w).sum()
        grad, = torch.autograd.grad(loss, x)
        out[impl] = (loss.detach(), grad)
    torch.testing.assert_close(out["pallas"][0], out["xla"][0], rtol=1e-5, atol=0)
    scale = float(out["xla"][1].abs().max())
    assert float((out["pallas"][1] - out["xla"][1]).abs().max()) <= 1e-5 * scale


WGRAD_SHAPES = [(2, 9, 13, 8, 4), (1, 33, 49, 64, 64), (2, 17, 23, 3, 64),
                (5, 30, 54, 512, 512), (2, 60, 107, 128, 256),
                (2, 11, 100, 64, 128), (3, 1, 37, 128, 16)]


@pytest.mark.parametrize("shape", WGRAD_SHAPES)
def test_wgrad_kernel_matches_ref(cuda, shape):
    """Within 1e-4 of max|dK|: both sum exact bf16 products in float32, in
    another order."""
    n, h, w, c, d = shape
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(n, h, w, d).astype(np.float32)).to(cuda)
    x, g = x.to(torch.bfloat16), g.to(torch.bfloat16)
    before = wgrad.launches
    got = wgrad.wgrad3x3(x, g)
    torch.cuda.synchronize()
    assert wgrad.launches == before + 1
    want = wgrad.wgrad3x3_ref(x, g)
    assert got.shape == (3, 3, c, d) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("shape", [(5, 240, 427, 128, 16), (5, 120, 214, 256, 16),
                                   (5, 60, 107, 512, 16), (5, 30, 54, 512, 16),
                                   (5, 30, 54, 512, 512)])
def test_wgrad_kernel_takes_the_hopper_path(cuda, shape):
    """The four side convs (B6's dK) and a stage-5 trunk conv run the TMA +
    wgmma path, one count per launch, and repeat bitwise; dK within 1e-4 of
    max|dK|, db within 1e-5 of the column sums of |g|."""
    n, h, w, c, d = shape
    x = _bf16_randn((n, h, w, c), cuda, 5, relu=True)
    g = _bf16_randn((n, h, w, d), cuda, 6)
    before = (wgrad.tma_launches, wgrad.wmma_launches)
    dk, db = wgrad.launch(x, g, with_db=True)
    dk2, db2 = wgrad.launch(x, g, with_db=True)
    torch.cuda.synchronize()
    assert (wgrad.tma_launches, wgrad.wmma_launches) == (before[0] + 2, before[1])
    assert torch.equal(dk, dk2) and torch.equal(db, db2)
    _assert_dk(dk, wgrad.wgrad3x3_ref(x, g))
    _assert_db(db, g.float().sum((0, 1, 2)), g)


def test_wgrad_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 9, 13, 8, device=cuda, dtype=torch.bfloat16)
    g = torch.randn(1, 9, 13, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        wgrad.wgrad3x3(x.float(), g)
    with pytest.raises(ValueError):
        wgrad.wgrad3x3(x.transpose(1, 2).contiguous().transpose(1, 2), g)
    with pytest.raises(ValueError):
        wgrad.wgrad3x3(x, g[:, :8])


def test_fast_fine_tune_kernels_match_plain(cuda, monkeypatch):
    """Two fast-mode steps with the kernels and with their plain versions:
    losses within rtol 1e-4, parameter deltas within 1e-2 of each leaf's
    delta scale (the runs differ only in float32 sum order; the pools are
    exact). Per step: one CB-BCE statistics and gradient, one B16 (the
    stem), 12 B17, and four pools forward and backward."""
    cfg_m = dataclasses.replace(TINY, compute_mode="fast")
    cfg = OnlineConfig(n_steps=2, n_ave_grad=3, lr=1e-4, loss_impl="pallas")
    rng = np.random.RandomState(4)
    img = (rng.randn(65, 97, 3) * 40).astype(np.float32)
    yy, xx = np.mgrid[:65, :97]
    mask = ((yy - 30) ** 2 + (xx - 40) ** 2 < 400).astype(np.float32)
    state0 = init_osvos_params(cfg_m, torch.Generator().manual_seed(0))
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(cbbce, "cbbce_stats", cbbce.cbbce_stats_ref)
            monkeypatch.setattr(cbbce, "cbbce_grad", cbbce.cbbce_grad_ref)
            monkeypatch.setattr(wgrad, "wgrad3x3", wgrad.wgrad3x3_ref)
            monkeypatch.setattr(stem_wgrad, "stem_wgrad", stem_wgrad.stem_wgrad_ref)
            monkeypatch.setattr(kpool, "max_pool_fwd", kpool.max_pool_fwd_ref)
            monkeypatch.setattr(kpool, "max_pool_bwd", kpool.max_pool_bwd_ref)
        model = OSVOS(cfg_m)
        model.load_state_dict(state0)
        names = ((cbbce, "stats_launches"), (cbbce, "grad_launches"),
                 (wgrad, "launches"), (kpool, "fwd_launches"),
                 (kpool, "bwd_launches"), (stem_wgrad, "launches"))
        before = [getattr(m, n) for m, n in names]
        losses = make_fine_tune_fn(cfg_m, cfg, pool_size=4, device=cuda)(
            model, img, mask, torch.Generator().manual_seed(1))
        counts = tuple(getattr(m, n) - b for (m, n), b in zip(names, before))
        assert counts == ((0,) * 6 if plain else (2, 2, 24, 8, 8, 2)), counts
        runs.append((losses.cpu(), {k: v.cpu() for k, v in
                                    model.state_dict().items()}))
    (l_k, p_k), (l_p, p_p) = runs
    assert bool(torch.isfinite(l_k).all())
    torch.testing.assert_close(l_k, l_p, rtol=1e-4, atol=0)
    for k in p_k:
        dk, dp = p_k[k] - state0[k], p_p[k] - state0[k]
        scale = float(dp.abs().max())
        # score_dsn is not in the 'infer' graph the fine-tune differentiates
        assert (scale == 0) == k.startswith("score_dsn"), (k, scale)
        assert float((dk - dp).abs().max()) <= 1e-2 * scale, k


# ---------------------------------------------------------------------------
# the flat trunk's kernels (B2-B6) against their plain versions
# ---------------------------------------------------------------------------

# (n, h, w, c, d): the fine-tune step's shapes at batch 5, 480x854, and odd
# small ones (ragged tiles, channel counts off the kernels' tiles)
FLAT_FWD_SHAPES = [(5, 480, 854, 3, 64), (5, 480, 854, 64, 64),
                   (5, 30, 54, 512, 512), (2, 17, 29, 3, 8),
                   (2, 17, 29, 8, 12)]
FLAT_BWD_SHAPES = [(5, 480, 854, 64, 64), (5, 240, 427, 128, 128),
                   (5, 60, 107, 256, 512), (2, 17, 29, 12, 8)]
SIDE_SHAPES = [(5, 240, 427, 128, 16), (5, 60, 107, 512, 16),
               (5, 30, 54, 512, 16), (2, 17, 29, 12, 8), (2, 17, 29, 64, 16),
               (1, 9, 70, 24, 8)]


def _bf16_randn(shape, device, seed, relu=False, levels=0):
    """Seeded bf16 values; ``relu`` keeps the positive part (a post-ReLU
    activation, many zeros), ``levels`` quantizes them to that many values
    so that pool windows tie often."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn(shape, device=device, generator=gen)
    if levels:
        t = torch.round(t * levels / 3) * (3 / levels)
    return (t.clamp_min(0) if relu else t).to(torch.bfloat16)


def _weight(d, c, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(d, c, 3, 3, device=device, generator=gen) * (9 * c) ** -0.5


def _assert_one_rounding(got, want):
    """bf16 outputs of the same float32 sums taken in another order: within
    one bf16 rounding (2^-7 of the value), plus 2^-16 of the scale for
    values that cancel to near zero."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    assert scale > 0
    bad = (g - w).abs() > w.abs() * 2.0 ** -7 + scale * 2.0 ** -16
    assert not bool(bad.any()), (float((g - w).abs().max()), scale)


def _assert_dk(got, want):
    """float32 sums of exact bf16 products in another order: 1e-4 of max|dK|."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _assert_db(got, want, g):
    """float32 column sums of g in another order: 1e-5 of the largest
    column sum of |g|."""
    bound = 1e-5 * float(g.float().abs().sum((0, 1, 2)).max())
    assert float((got - want).abs().max()) <= bound


@pytest.mark.parametrize("shape", FLAT_FWD_SHAPES)
@pytest.mark.parametrize("pool", [False, True])
def test_flat_conv_fwd_kernel_matches_ref(cuda, shape, pool):
    """B2 (and its stem variant at C = 3): y within one rounding of the
    plain version; the pooled map equals the plain pool of the kernel's own
    y bit for bit; two launches give the same bits."""
    n, h, w, c, d = shape
    x = _bf16_randn((n, h, w, c), cuda, 1, relu=c > 3)
    k = _weight(d, c, cuda, 2)
    b = torch.randn(d, device=cuda) * 0.1
    before = flatconv.fwd_launches
    y, pooled = flatconv.conv_fwd(x, k, b, pool=pool)
    y2, pooled2 = flatconv.conv_fwd(x, k, b, pool=pool)
    torch.cuda.synchronize()
    assert flatconv.fwd_launches == before + 2
    want, _ = flatconv.conv_fwd_ref(x, k, b)
    _assert_one_rounding(y, want)
    assert float((y.float() == 0).float().mean()) > 0.05  # the ReLU acted
    assert torch.equal(y, y2)
    if pool:
        assert pooled.shape == (n, -(-h // 2), -(-w // 2), d)
        assert torch.equal(pooled, pool_fwd(y))
        assert torch.equal(pooled, pooled2)
    else:
        assert pooled is None


@pytest.mark.parametrize("shape", FLAT_BWD_SHAPES)
@pytest.mark.parametrize("route", [False, True])
def test_flat_conv_bwd_kernels_match_ref(cuda, shape, route):
    """B3: dz within one rounding, dK within 1e-4 of max|dK|, db within
    1e-5 of the column sums of |g|; the routed cotangent (planted ties)
    equal to the plain pool backward's bit for bit; two runs the same."""
    n, h, w, c, d = shape
    x = _bf16_randn((n, h, w, c), cuda, 3, relu=True)
    k = _weight(d, c, cuda, 4)
    if route:
        y = _bf16_randn((n, h, w, d), cuda, 5, relu=True, levels=4)
        pooled = pool_fwd(y)
        dp = _bf16_randn(pooled.shape, cuda, 6)
        kw = dict(route=(y, pooled, dp))
    else:
        kw = dict(g=_bf16_randn((n, h, w, d), cuda, 5))
    before = (flatconv.bwd_launches, flatconv.wgrad_db_launches)
    got = flatconv.conv_bwd(x, k, **kw)
    again = flatconv.conv_bwd(x, k, **kw)
    torch.cuda.synchronize()
    assert (flatconv.bwd_launches, flatconv.wgrad_db_launches) == \
        (before[0] + 2, before[1] + 2)
    dz, dk, db, g = flatconv.conv_bwd_ref(x, k, **kw)
    assert torch.equal(got[3], g)
    _assert_one_rounding(got[0], dz)
    _assert_dk(got[1], dk)
    _assert_db(got[2], db, g)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)


# (n, h, w, c, d) of csrc/flatconv.cu's Hopper path: W ragged past one or
# two 64-pixel segments, odd H (a ragged pool row), C or D of 8, 16 and
# 192, and a K of 9 * 512
HOPPER_SHAPES = [(2, 9, 70, 64, 64), (1, 17, 130, 8, 16), (2, 7, 54, 16, 192),
                 (1, 5, 107, 192, 8), (1, 6, 64, 512, 136)]


def _path_counts():
    return flatconv.hopper_launches, flatconv.mma_launches


@pytest.mark.parametrize("shape", HOPPER_SHAPES)
@pytest.mark.parametrize("mode", ["fwd", "fwd_pool", "dgrad"])
def test_flat_conv_hopper_path_matches_ref(cuda, shape, mode):
    """Modes 0, 1 and 5 on the Hopper path (TMA + wgmma): within one bf16
    rounding of the plain versions, the pool bit for bit the plain pool of
    the kernel's y, two launches bitwise equal, each launch counted on the
    Hopper path and none on the mma path."""
    n, h, w, c, d = shape
    x = _bf16_randn((n, h, w, c), cuda, 11, relu=True, levels=4 * (mode == "fwd_pool"))
    k = _weight(d, c, cuda, 12)
    before = _path_counts()
    if mode == "dgrad":
        g = _bf16_randn((n, h, w, d), cuda, 13)
        assert flatconv.plan(n, h, w, d, c, mode).path == "hopper"
        got, again = flatconv.conv_bwd(x, k, g)[0], flatconv.conv_bwd(x, k, g)[0]
        torch.cuda.synchronize()
        want = flatconv.conv_bwd_ref(x, k, g)[0]
        assert float((want.float() == 0).float().mean()) > 0.3  # the mask acted
    else:
        pool = mode == "fwd_pool"
        b = torch.randn(d, device=cuda) * 0.1
        assert flatconv.plan(n, h, w, c, d, mode).path == "hopper"
        (got, pooled), (again, pooled2) = (flatconv.conv_fwd(x, k, b, pool=pool),
                                           flatconv.conv_fwd(x, k, b, pool=pool))
        torch.cuda.synchronize()
        want, _ = flatconv.conv_fwd_ref(x, k, b)
        if pool:
            assert torch.equal(pooled, pool_fwd(got))
            assert torch.equal(pooled, pooled2)
    after = _path_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (2, 0)
    _assert_one_rounding(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [(2, 17, 29, 3, 12), (2, 17, 29, 12, 8),
                                   (1, 9, 70, 64, 12)])
def test_flat_conv_mma_path_takes_the_rest(cuda, shape):
    """The stem with D off a multiple of 8 (C = 3, D = 12) and channel
    counts off a multiple of 8 take the mma.sync template: the forward, dz
    and the side conv B5 with such channels."""
    n, h, w, c, d = shape
    x = _bf16_randn((n, h, w, c), cuda, 14, relu=c > 3)
    k = _weight(d, c, cuda, 15)
    b = torch.randn(d, device=cuda) * 0.1
    before = _path_counts()
    y, _ = flatconv.conv_fwd(x, k, b)
    side, _ = flatconv.side_fwd(x, k)
    launches = 2
    if c > 3:
        dz = flatconv.conv_bwd(x, k, _bf16_randn((n, h, w, d), cuda, 16))[0]
        launches += 1
    torch.cuda.synchronize()
    after = _path_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (0, launches)
    _assert_one_rounding(y, flatconv.conv_fwd_ref(x, k, b)[0])


def test_flat_conv_bwd_routes_through_the_pool_kernel(cuda):
    """B3 at a pooled conv: the pool backward kernel (csrc/pool.cu) routes
    d_pooled first, bit for bit the plain pool_bwd with planted ties, and
    the dz launch takes the Hopper path."""
    n, h, w, c, d = 2, 17, 29, 64, 64
    x = _bf16_randn((n, h, w, c), cuda, 17, relu=True)
    k = _weight(d, c, cuda, 18)
    y = _bf16_randn((n, h, w, d), cuda, 19, relu=True, levels=4)
    pooled = pool_fwd(y)
    dp = _bf16_randn(pooled.shape, cuda, 20)
    before = (kpool.bwd_launches, *_path_counts())
    dz, dk, db, g = flatconv.conv_bwd(x, k, route=(y, pooled, dp))
    torch.cuda.synchronize()
    assert (kpool.bwd_launches - before[0], flatconv.hopper_launches - before[1],
            flatconv.mma_launches - before[2]) == (1, 1, 0)
    assert torch.equal(g, pool_bwd(y, pooled, dp))
    want = flatconv.conv_bwd_ref(x, k, route=(y, pooled, dp))
    _assert_one_rounding(dz, want[0])
    _assert_dk(dk, want[1])


@pytest.mark.parametrize("shape", [(5, 480, 854, 64, 64), (5, 60, 107, 256, 512),
                                   (2, 17, 29, 12, 8)])
def test_flat_wgrad_db_kernel_matches_ref(cuda, shape):
    """B4: dK within 1e-4 of max|dK|, db within 1e-5 of the column sums of
    |g|, one count per launch, two launches the same."""
    n, h, w, c, d = shape
    x = _bf16_randn((n, h, w, c), cuda, 7, relu=True)
    g = _bf16_randn((n, h, w, d), cuda, 8)
    before = flatconv.wgrad_db_launches
    got, again = flatconv.wgrad_db(x, g), flatconv.wgrad_db(x, g)
    torch.cuda.synchronize()
    assert flatconv.wgrad_db_launches == before + 2
    dk, db = flatconv.wgrad_db_ref(x, g)
    _assert_dk(got[0], dk)
    _assert_db(got[1], db, g)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    with pytest.raises(ValueError):
        flatconv.wgrad_db(x.float(), g)


@pytest.mark.parametrize("shape", [(5, 480, 854, 3, 64), (2, 17, 29, 3, 8)])
def test_stem_bwd_kernel_matches_ref(cuda, shape):
    """The flat stem's backward is one B16 launch: dK within 1e-4 of
    max|dK|, db within 1e-5 of the column sums of |g|, and not counted as
    B17."""
    n, h, w, c, d = shape
    x = _bf16_randn((n, h, w, c), cuda, 7)
    g = _bf16_randn((n, h, w, d), cuda, 8)
    before, b17 = stem_wgrad.launches, wgrad.launches
    dk, db = flatconv.stem_bwd(x, g)
    torch.cuda.synchronize()
    assert (stem_wgrad.launches, wgrad.launches) == (before + 1, b17)
    want_dk, want_db = flatconv.stem_bwd_ref(x, g)
    _assert_dk(dk, want_dk)
    _assert_db(db, want_db, g)


# (n, h, w, c, d): the stem at the fine-tune's batch 5 and the parent's
# batch 2 at 480x854, and odd ones: ragged row segments and pixel chunks,
# fewer channels, a D off the 16-byte vector and past one channel tile
STEM_SHAPES = [(5, 480, 854, 3, 64), (2, 480, 854, 3, 64), (2, 17, 29, 3, 8),
               (1, 5, 3, 2, 12), (3, 9, 70, 1, 130)]


@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_wgrad_kernel_matches_ref(cuda, shape):
    """B16 on an image of the stem's range (values to about +-150): dK
    within 1e-4 of max|dK|, db within 1e-5 of the column sums of |g|, and
    two launches give the same bits."""
    n, h, w, c, d = shape
    x = (torch.randn((n, h, w, c), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(h))
         * 60).to(torch.bfloat16)
    g = _bf16_randn((n, h, w, d), cuda, w)
    before = stem_wgrad.launches
    dk, db = stem_wgrad.stem_wgrad(x, g)
    dk2, db2 = stem_wgrad.stem_wgrad(x, g)
    torch.cuda.synchronize()
    assert stem_wgrad.launches == before + 2
    want_dk, want_db = stem_wgrad.stem_wgrad_ref(x, g)
    assert dk.shape == (3, 3, c, d) and db.shape == (d,)
    _assert_dk(dk, want_dk)
    _assert_db(db, want_db, g)
    assert torch.equal(dk, dk2) and torch.equal(db, db2)


# (n, h, w, c, d) of the stem's Hopper paths (csrc/stem.cu, B16's TMA
# path): the fine-tune's and the parent's stem, a ragged W with D = 8,
# H = 1, C = 1, C = 2 over two channel tiles, D = 256
STEM_HOPPER_SHAPES = [(5, 480, 854, 3, 64), (2, 480, 854, 3, 64),
                      (2, 17, 29, 3, 8), (1, 1, 200, 3, 16), (3, 9, 70, 1, 16),
                      (2, 7, 130, 2, 72), (1, 3, 40, 3, 256)]


@pytest.mark.parametrize("shape", STEM_HOPPER_SHAPES)
def test_stem_fwd_kernel_takes_the_stem_path(cuda, shape):
    """B2's stem on csrc/stem.cu: within one rounding of the plain version,
    the ReLU acting, two launches bitwise equal, each counted on the stem
    path and none on flatconv.cu's paths or its weight pack."""
    n, h, w, c, d = shape
    x = (torch.randn((n, h, w, c), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(w))
         * 60).to(torch.bfloat16)
    k = _weight(d, c, cuda, 21)
    b = torch.randn(d, device=cuda) * 0.1
    assert flatconv.plan(n, h, w, c, d, "stem").path == "stem"
    counters = ("stem_launches", "hopper_launches", "mma_launches", "pack_launches")
    before = [getattr(flatconv, a) for a in counters]
    (y, _), (y2, _) = flatconv.conv_fwd(x, k, b), flatconv.conv_fwd(x, k, b)
    torch.cuda.synchronize()
    assert [getattr(flatconv, a) - v for a, v in zip(counters, before)] == [2, 0, 0, 0]
    want, _ = flatconv.conv_fwd_ref(x, k, b)
    _assert_one_rounding(y, want)
    assert float((want.float() == 0).float().mean()) > 0.05  # the ReLU acted
    assert torch.equal(y, y2)


@pytest.mark.parametrize("shape", STEM_HOPPER_SHAPES + [(1, 5, 3, 2, 12),
                                                        (3, 9, 70, 1, 130)])
def test_stem_wgrad_kernel_takes_the_tma_path_for_d_a_multiple_of_8(cuda, shape):
    """B16 on its Hopper path (TMA ring of g, rolling image strip, wgmma)
    where D is a multiple of 8, on the mma path elsewhere: each launch
    counted on its path, dK within 1e-4 of max|dK|, db within 1e-5 of the
    column sums of |g|, two launches bitwise equal."""
    n, h, w, c, d = shape
    x = (torch.randn((n, h, w, c), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(h + 1))
         * 60).to(torch.bfloat16)
    g = _bf16_randn((n, h, w, d), cuda, w + 1)
    tma = d % 8 == 0
    assert (stem_wgrad.tma_plan(n, h, w, c, d) is not None) == tma
    before = (stem_wgrad.tma_launches, stem_wgrad.mma_launches)
    (dk, db), (dk2, db2) = stem_wgrad.stem_wgrad(x, g), stem_wgrad.stem_wgrad(x, g)
    torch.cuda.synchronize()
    assert (stem_wgrad.tma_launches - before[0],
            stem_wgrad.mma_launches - before[1]) == ((2, 0) if tma else (0, 2))
    want_dk, want_db = stem_wgrad.stem_wgrad_ref(x, g)
    _assert_dk(dk, want_dk)
    _assert_db(db, want_db, g)
    assert torch.equal(dk, dk2) and torch.equal(db, db2)


def test_stem_wgrad_kernel_rejects_what_it_does_not_take(cuda):
    x = _bf16_randn((1, 9, 13, 3), cuda, 0)
    g = _bf16_randn((1, 9, 13, 16), cuda, 1)
    before = stem_wgrad.launches
    for bad in ((x.float(), g), (x, g.half()),
                (x.transpose(1, 2).contiguous().transpose(1, 2), g),
                (x, g[:, :8]), (_bf16_randn((1, 9, 13, 4), cuda, 2), g),
                (x, g.cpu())):
        with pytest.raises(ValueError):
            stem_wgrad.stem_wgrad(*bad)
    assert stem_wgrad.launches == before


# (n, h, w, c, d, s) of the sequence-batched B17: the Hopper path at trunk
# widths, C = 8 under one 64-channel tile (TMA's zero fill at a sequence's
# own C), D = 72 over a partial D tile, a stage-5 conv, the full-width stage
# 1 at S = 4; the wmma path at C = 12 and at the stem's C = 3; one sequence
# on each path
WGRAD_SEQ_SHAPES = [(2, 33, 49, 64, 64, 2), (1, 17, 23, 8, 16, 3),
                    (2, 9, 70, 128, 72, 2), (5, 30, 54, 512, 512, 2),
                    (5, 480, 854, 64, 64, 4),
                    (2, 9, 13, 12, 4, 3), (2, 17, 23, 3, 64, 2),
                    (2, 33, 49, 64, 64, 1), (2, 9, 13, 12, 4, 1)]


@pytest.mark.parametrize("shape", WGRAD_SEQ_SHAPES)
def test_wgrad3x3_seq_is_lone_launches_bit_for_bit(cuda, shape):
    """One launch of ``wgrad3x3_seq`` over S interleaved sequences: each
    sequence's dK bit for bit a lone ``wgrad3x3`` on its contiguous slice,
    within 1e-4 of max|dK| of the plain version, the launch counted once in
    ``seq_launches`` on the lone shape's path."""
    n, h, w, c, d, s = shape
    x = _bf16_randn((n, h, w, s * c), cuda, 31, relu=True)
    g = _bf16_randn((n, h, w, s * d), cuda, 32)
    path = wgrad.plan(n, h, w, c, d).path
    before = (wgrad.seq_launches, wgrad.launches, wgrad.tma_launches,
              wgrad.wmma_launches)
    got = wgrad.wgrad3x3_seq(x, g, s)
    torch.cuda.synchronize()
    took = (wgrad.seq_launches - before[0], wgrad.launches - before[1],
            wgrad.tma_launches - before[2], wgrad.wmma_launches - before[3])
    assert took == ((1, 0, 1, 0) if path == "tma" else (1, 0, 0, 1))
    assert got.shape == (s, 3, 3, c, d) and got.dtype == torch.float32
    for i in range(s):
        lone = wgrad.wgrad3x3(x[..., i * c:(i + 1) * c].contiguous(),
                              g[..., i * d:(i + 1) * d].contiguous())
        assert torch.equal(got[i], lone), i
    want = wgrad.wgrad3x3_seq_ref(x, g, s)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# (n, h, w, c, d, s) of the sequence-batched B16: its Hopper path (the
# fine-tune's stem at S = 2 and at S = 5, past the S = 4 an interleaved strip
# would fit, a ragged W with D = 8, C = 2 over two channel tiles at S = 4, a
# ragged W at S = 4, C = 1) and its mma path (D = 12, D = 130); one sequence
# on each path
STEM_SEQ_SHAPES = [(5, 480, 854, 3, 64, 2), (5, 480, 854, 3, 64, 5),
                   (2, 17, 29, 3, 8, 3), (2, 7, 130, 2, 72, 4),
                   (2, 11, 131, 2, 72, 4), (3, 9, 70, 1, 16, 2),
                   (1, 5, 3, 2, 12, 2), (3, 9, 70, 1, 130, 3),
                   (2, 17, 29, 3, 8, 1), (1, 5, 3, 2, 12, 1)]


@pytest.mark.parametrize("shape", STEM_SEQ_SHAPES)
def test_stem_wgrad_seq_is_lone_launches_bit_for_bit(cuda, shape):
    """One launch of ``stem_wgrad_seq``: each sequence's dK and db bit for
    bit a lone ``stem_wgrad`` on its slice, within the lone test's bounds of
    the plain version, counted once in ``seq_launches`` on the lone shape's
    path."""
    n, h, w, c, d, s = shape
    x = (torch.randn((n, h, w, s * c), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(w + s))
         * 60).to(torch.bfloat16)
    g = _bf16_randn((n, h, w, s * d), cuda, h + s)
    tma = stem_wgrad.tma_plan(n, h, w, c, d) is not None
    before = (stem_wgrad.seq_launches, stem_wgrad.launches,
              stem_wgrad.tma_launches, stem_wgrad.mma_launches)
    dk, db = stem_wgrad.stem_wgrad_seq(x, g, s)
    torch.cuda.synchronize()
    took = (stem_wgrad.seq_launches - before[0], stem_wgrad.launches - before[1],
            stem_wgrad.tma_launches - before[2], stem_wgrad.mma_launches - before[3])
    assert took == ((1, 0, 1, 0) if tma else (1, 0, 0, 1))
    assert dk.shape == (s, 3, 3, c, d) and db.shape == (s, d)
    want_dk, want_db = stem_wgrad.stem_wgrad_seq_ref(x, g, s)
    for i in range(s):
        gi = g[..., i * d:(i + 1) * d].contiguous()
        lone_dk, lone_db = stem_wgrad.stem_wgrad(x[..., i * c:(i + 1) * c].contiguous(), gi)
        assert torch.equal(dk[i], lone_dk) and torch.equal(db[i], lone_db), i
        _assert_dk(dk[i], want_dk[i])
        _assert_db(db[i], want_db[i], gi)


def test_seq_kernels_reject_what_they_do_not_take(cuda):
    x = _bf16_randn((1, 9, 13, 16), cuda, 0)
    g = _bf16_randn((1, 9, 13, 32), cuda, 1)
    before = (wgrad.seq_launches, stem_wgrad.seq_launches)
    for fn, xs in ((wgrad.wgrad3x3_seq, x),
                   (stem_wgrad.stem_wgrad_seq, x[..., :6].contiguous())):
        for bad, s in (((xs, g), 3), ((xs, g), 0), ((xs.float(), g), 2),
                       ((xs, g[:, :8]), 2), ((xs, g.cpu()), 2),
                       ((xs.transpose(1, 2).contiguous().transpose(1, 2), g), 2)):
            with pytest.raises(ValueError):
                fn(*bad, s)
    assert (wgrad.seq_launches, stem_wgrad.seq_launches) == before


@pytest.mark.parametrize("c,d", [(3, 64), (64, 128)], ids=["stem", "trunk"])
def test_conv3x3_same_seq_weight_gradient_is_the_lone_ones(cuda, c, d):
    """The packed trunk's conv on the card: each sequence's weight gradient
    bit for bit the lone ``conv3x3_same``'s on its slice (one launch of the
    sequence-batched kernel)."""
    from osvos_torch.ops.fastconv import conv3x3_same, conv3x3_same_seq

    s = 2
    x = _bf16_randn((2, 33, 49, s * c), cuda, 40)
    cot = _bf16_randn((2, 33, 49, s * d), cuda, 41)
    weight = (torch.randn(s, d, c, 3, 3, device=cuda) * (9 * c) ** -0.5
              ).requires_grad_()
    conv3x3_same_seq(x, weight).backward(cot)
    for i in range(s):
        wi = weight.detach()[i].clone().requires_grad_()
        conv3x3_same(x[..., i * c:(i + 1) * c].contiguous(), wi).backward(
            cot[..., i * d:(i + 1) * d].contiguous())
        assert torch.equal(weight.grad[i], wi.grad), i


def _assert_two_roundings(got, want, conv):
    """bf16(bf16(acc) + b) from float32 sums taken in another order: the
    conv's rounding may land one bf16 ulp (at most 2^-7 of |conv|) away,
    which the bias add carries into the sum, rounded once more (2^-7 of
    the value), plus 2^-16 of the scale for values that cancel."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    g, w, c = got.float(), want.float(), conv.float()
    scale = float(w.abs().max())
    assert scale > 0
    bad = (g - w).abs() > (c.abs() + w.abs()) * 2.0 ** -7 + scale * 2.0 ** -16
    assert not bool(bad.any()), (float((g - w).abs().max()), scale)


# (n, h, w, c, d, s) of B2-seq: both tile classes (D <= 64 at 4 rows, D >
# 64 at 2), odd H and W, C of 64 and 512 (and 16, 72), S of 1, 2, 3 and 5
FWD_SEQ_SHAPES = [(2, 9, 70, 64, 64, 2), (1, 17, 131, 64, 128, 3),
                  (2, 7, 54, 512, 512, 2), (1, 13, 29, 512, 64, 5),
                  (1, 5, 107, 16, 136, 5), (2, 11, 65, 72, 8, 3),
                  (2, 9, 70, 64, 64, 1), (1, 7, 54, 512, 512, 1)]


@pytest.mark.parametrize("shape", FWD_SEQ_SHAPES)
def test_conv_fwd_seq_is_lone_launches_bit_for_bit(cuda, shape):
    """B2-seq over S interleaved sequences: each sequence's output bit for
    bit the lone launch (S = 1) on its contiguous slice; two launches the
    same bits; within one bf16 ulp of the conv and one of the sum of the plain
    version, relu(bf16(bf16(conv3x3_f32) + b)); one launch counted in
    ``seq_fwd_launches``, ``hopper_launches`` and ``pack_launches``."""
    n, h, w, c, d, s = shape
    x = _bf16_randn((n, h, w, s * c), cuda, 50 + s, relu=True)
    gen = torch.Generator(device=cuda).manual_seed(c + d + s)
    weight = torch.randn(s, d, c, 3, 3, device=cuda, generator=gen) * (9 * c) ** -0.5
    bias = (torch.randn(s * d, device=cuda, generator=gen) * 0.1).to(torch.bfloat16)
    counters = ("seq_fwd_launches", "hopper_launches", "pack_launches",
                "fwd_launches", "mma_launches")
    before = [getattr(flatconv, k) for k in counters]
    y = flatconv.conv_fwd_seq(x, weight, bias)
    torch.cuda.synchronize()
    assert [getattr(flatconv, k) - b for k, b in zip(counters, before)] == [1, 1, 1, 0, 0]
    assert y.shape == (n, h, w, s * d) and y.dtype == torch.bfloat16
    for i in range(s):
        lone = flatconv.conv_fwd_seq(x[..., i * c:(i + 1) * c].contiguous(),
                                     weight[i:i + 1], bias[i * d:(i + 1) * d])
        assert torch.equal(y[..., i * d:(i + 1) * d], lone), i
    assert torch.equal(flatconv.conv_fwd_seq(x, weight, bias), y)
    conv = torch.cat([flatconv.conv3x3_f32(x[..., i * c:(i + 1) * c], weight[i])
                      for i in range(s)], dim=-1).to(torch.bfloat16)
    _assert_two_roundings(y, flatconv.conv_fwd_seq_ref(x, weight, bias), conv)
    assert float((y.float() == 0).float().mean()) > 0.05  # the ReLU acted


@pytest.mark.parametrize("c,d", [(64, 64), (64, 128), (128, 8)])
def test_conv3x3_bias_relu_seq_gradients_are_autograds(cuda, c, d):
    """The fused function on the card against ``conv3x3_same_seq`` + bias +
    ``F.relu`` under autograd, on operands whose sums are exact in any
    order (small integers times powers of two), so that B2-seq's output and
    the library conv's are the same bits: the outputs equal, and the
    gradients of x, the weight and the float32 bias (through its flatten
    and bf16 cast) bit for bit (cuDNN deterministic)."""
    from osvos_torch.ops.fastconv import conv3x3_bias_relu_seq, conv3x3_same_seq

    s = 2
    gen = torch.Generator(device=cuda).manual_seed(c + d)
    x = torch.randint(0, 4, (2, 17, 29, s * c), device=cuda,
                      generator=gen).to(torch.bfloat16)
    weight = torch.randint(-4, 5, (s, d, c, 3, 3), device=cuda,
                           generator=gen).float() * 2.0 ** -6
    bias = torch.randint(-8, 9, (s, d), device=cuda, generator=gen).float() * 2.0 ** -4
    cot = _bf16_randn((2, 17, 29, s * d), cuda, 60)
    outs, grads = [], []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for fused in (True, False):
            xs, ws, bs = (t.clone().requires_grad_() for t in (x, weight, bias))
            b16 = bs.flatten().to(torch.bfloat16)
            z = (conv3x3_bias_relu_seq(xs, ws, b16) if fused
                 else torch.nn.functional.relu(conv3x3_same_seq(xs, ws) + b16))
            z.backward(cot)
            outs.append(z)
            grads.append((xs.grad, ws.grad, bs.grad))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert torch.equal(outs[0], outs[1])
    assert 0.05 < float((outs[0] == 0).float().mean()) < 0.95
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_packed_fast_forward_is_twelve_seq_launches(cuda):
    """One fast ``PackedOSVOS`` forward at the published widths: each of
    the 12 trunk convs after the stem one B2-seq launch (12 more in
    ``seq_fwd_launches``, ``hopper_launches`` and ``pack_launches``), none
    of flatconv's lone forward; the parity mode none."""
    from osvos_torch.parallel.packed import PackedOSVOS

    s = 2
    counters = ("seq_fwd_launches", "hopper_launches", "pack_launches",
                "fwd_launches", "stem_launches")
    for mode, want in (("fast", 12), ("parity", 0)):
        model = PackedOSVOS(ModelConfig(compute_mode=mode), s).to(cuda)
        x = torch.rand(1, 33, 49, 3 * s, device=cuda)
        before = [getattr(flatconv, k) for k in counters]
        out = model(x)
        torch.cuda.synchronize()
        assert out.shape == (1, 33, 49, s)
        took = [getattr(flatconv, k) - b for k, b in zip(counters, before)]
        assert took == [want, want, want, 0, 0], (mode, took)


@pytest.mark.parametrize("d,c,tile_n,flip", [(64, 64, 64, False), (512, 512, 128, False),
                                             (136, 72, 128, False), (64, 128, 64, True)])
def test_pack_weight_kernel_packs_stacked_weights(cuda, d, c, tile_n, flip):
    """One launch of the pack kernel for S stacked weights (S, D, C, 3, 3)
    is bit for bit the S lone packs, one count."""
    s = 3
    gen = torch.Generator(device=cuda).manual_seed(d + c)
    k = torch.randn(s, d, c, 3, 3, device=cuda, generator=gen)
    before = flatconv.pack_launches
    got = flatconv.pack_weight(k, tile_n, 64, flip=flip)
    torch.cuda.synchronize()
    assert flatconv.pack_launches == before + 1
    assert torch.equal(got, flatconv.pack_weight_ref(k, tile_n, 64, flip=flip))
    for i in range(s):
        assert torch.equal(got[i], flatconv.pack_weight(k[i], tile_n, 64, flip=flip))


@pytest.mark.parametrize("shape", SIDE_SHAPES)
@pytest.mark.parametrize("pool", [False, True])
def test_side_kernels_match_ref(cuda, shape, pool):
    """B5 and B6: the side output and dz within one rounding, the pool of
    the input and the routed cotangent (planted ties) bit for bit, dK
    within 1e-4 of max|dK|; with C and D multiples of 8 each launch of
    ``flatconv.cu`` takes the Hopper path, else the mma path."""
    n, h, w, c, d = shape
    x = _bf16_randn((n, h, w, c), cuda, 9, relu=True, levels=4)
    k = _weight(d, c, cuda, 10)
    before = (flatconv.side_fwd_launches, flatconv.side_bwd_launches)
    paths = _path_counts()
    side, pooled = flatconv.side_fwd(x, k, pool=pool)
    want_side, want_pooled = flatconv.side_fwd_ref(x, k, pool=pool)
    _assert_one_rounding(side, want_side)
    g = _bf16_randn((n, h, w, d), cuda, 11)
    bwd_pool = None
    if pool:
        assert torch.equal(pooled, want_pooled)
        bwd_pool = (pooled, _bf16_randn(pooled.shape, cuda, 12))
    dz, dk = flatconv.side_bwd(x, k, g, pool=bwd_pool)
    dz2, dk2 = flatconv.side_bwd(x, k, g, pool=bwd_pool)
    torch.cuda.synchronize()
    assert (flatconv.side_fwd_launches, flatconv.side_bwd_launches) == \
        (before[0] + 1, before[1] + 2)
    hopper = c % 8 == 0 and d % 8 == 0
    took = tuple(a - b for a, b in zip(_path_counts(), paths))
    assert took == ((3, 0) if hopper else (0, 3)), took
    assert flatconv.plan(n, h, w, c, d, "side_pool" if pool else "side").path == \
        flatconv.plan(n, h, w, d, c, "side_dgrad").path == ("hopper" if hopper else "mma")
    want_dz, want_dk = flatconv.side_bwd_ref(x, k, g, pool=bwd_pool)
    _assert_one_rounding(dz, want_dz)
    _assert_dk(dk, want_dk)
    assert torch.equal(dz, dz2) and torch.equal(dk, dk2)
    if pool:  # the routed cotangent alone, bit for bit: a zero side cotangent
        zero = torch.zeros_like(g)
        got = flatconv.side_bwd(x, k, zero, pool=bwd_pool)[0]
        assert torch.equal(got, flatconv.side_bwd_ref(x, k, zero, pool=bwd_pool)[0])


@pytest.mark.parametrize("d,c,tile_n,tile_c", [(16, 128, 16, 64), (16, 512, 16, 64),
                                               (64, 64, 64, 64), (512, 512, 128, 64),
                                               (8, 12, 64, 32), (136, 16, 64, 16)])
@pytest.mark.parametrize("flip", [False, True])
def test_pack_weight_kernel_matches_ref(cuda, d, c, tile_n, tile_c, flip):
    """The weight pack kernel is bit for bit its plain version, the
    weight's operand and the flipped transpose's, one count a launch; and
    the stem's im2col operand."""
    k = _weight(d, c, cuda, d + c)
    before = flatconv.pack_launches
    got = flatconv.pack_weight(k, tile_n, tile_c, flip=flip)
    torch.cuda.synchronize()
    assert flatconv.pack_launches == before + 1
    assert torch.equal(got, flatconv.pack_weight_ref(k, tile_n, tile_c, flip=flip))
    stem = _weight(64, 3, cuda, 1)
    assert torch.equal(flatconv.pack_weight(stem, 64, 32, stem=True),
                       flatconv.pack_weight_ref(stem, 64, 32, stem=True))


def test_flat_kernels_reject_what_they_do_not_take(cuda):
    x = _bf16_randn((1, 9, 13, 16), cuda, 0, relu=True)
    k = _weight(16, 16, cuda, 0)
    b = torch.zeros(16, device=cuda)
    g = _bf16_randn((1, 9, 13, 16), cuda, 1)
    with pytest.raises(ValueError):
        flatconv.conv_fwd(x.float(), k, b)
    with pytest.raises(ValueError):
        flatconv.conv_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), k, b)
    with pytest.raises(ValueError):
        flatconv.conv_fwd(x, k.cpu(), b)
    with pytest.raises(ValueError):
        flatconv.conv_bwd(x, k, g.float())
    with pytest.raises(ValueError):
        flatconv.conv_bwd(x, k, g[:, :8].contiguous())
    with pytest.raises(ValueError):
        flatconv.side_bwd(x, k, g, pool=(x, x))  # pooled map of the wrong size
    with pytest.raises(ValueError):
        flatconv.side_fwd(x.half(), k)


def test_flat_fine_tune_kernels_match_plain(cuda, monkeypatch):
    """Two flat-mode steps with the kernels and with their plain versions:
    every B2-B6 wrapper launches its exact count and B17 none; losses within
    rtol 1e-3 and parameter deltas within 0.1 of each leaf's delta scale.
    Unlike the fast mode's float32-only differences, a bf16 output here may
    round the other way, and in channels 8-16 wide one such flip moves a
    deep leaf's small gradient by some percent (measured: 7.1e-2 of the
    scale at stage5_conv0.weight)."""
    cfg_m = dataclasses.replace(TINY, compute_mode="flat")
    cfg = OnlineConfig(n_steps=2, n_ave_grad=3, lr=1e-4, loss_impl="pallas")
    rng = np.random.RandomState(4)
    img = (rng.randn(65, 97, 3) * 40).astype(np.float32)
    yy, xx = np.mgrid[:65, :97]
    mask = ((yy - 30) ** 2 + (xx - 40) ** 2 < 400).astype(np.float32)
    state0 = init_osvos_params(cfg_m, torch.Generator().manual_seed(0))
    counters = [(flatconv, n) for n in ("fwd_launches", "bwd_launches",
                                        "wgrad_db_launches")]
    counters += [(stem_wgrad, "launches")]
    counters += [(flatconv, n) for n in ("side_fwd_launches", "side_bwd_launches")]
    counters += [(wgrad, "launches")]
    runs = []
    for plain in (False, True):
        if plain:
            for name in ("conv_fwd", "conv_bwd", "stem_bwd", "side_fwd",
                         "side_bwd"):
                monkeypatch.setattr(flatconv, name, getattr(flatconv, name + "_ref"))
        model = OSVOS(cfg_m)
        model.load_state_dict(state0)
        before = [getattr(m, n) for m, n in counters]
        losses = make_fine_tune_fn(cfg_m, cfg, pool_size=4, device=cuda)(
            model, img, mask, torch.Generator().manual_seed(1))
        counts = tuple(getattr(m, n) - b for (m, n), b in zip(counters, before))
        # per step: 13 convs forward, 12 trunk backward (B3 and its B4), the
        # stem, 4 sides
        assert counts == ((0,) * 7 if plain else (26, 24, 24, 2, 8, 8, 0)), counts
        runs.append((losses.cpu(), {k: v.cpu() for k, v in
                                    model.state_dict().items()}))
    (l_k, p_k), (l_p, p_p) = runs
    assert bool(torch.isfinite(l_k).all())
    torch.testing.assert_close(l_k, l_p, rtol=1e-3, atol=0)
    for k in p_k:
        dk, dp = p_k[k] - state0[k], p_p[k] - state0[k]
        scale = float(dp.abs().max())
        assert float((dk - dp).abs().max()) <= 0.1 * scale, k


# ---------------------------------------------------------------------------
# the stage-boundary max pool (B7-B10) against its plain version
# ---------------------------------------------------------------------------

# ((n, h, w, c), dtype): the four boundaries of a batch-5 480x854 step in
# bf16, then float32 (parity mode) at one of them, and odd small shapes off
# the 16-byte channel vector in both
BF16, F32 = torch.bfloat16, torch.float32
POOL_CASES = [((5, 480, 854, 64), BF16), ((5, 240, 427, 128), BF16),
              ((5, 120, 214, 256), BF16), ((5, 60, 107, 512), BF16),
              ((5, 60, 107, 512), F32), ((2, 17, 29, 12), BF16),
              ((2, 17, 29, 12), F32), ((1, 1, 1, 5), BF16), ((3, 9, 4, 3), F32)]


def _nan_equal(got, want):
    """Bit-equal values, NaN where the plain version has NaN."""
    return bool(((got == want) | (got.isnan() & want.isnan())).all())


@pytest.mark.parametrize("shape,dtype", POOL_CASES)
@pytest.mark.parametrize("levels", [0, 4])
def test_pool_kernels_match_ref(cuda, shape, dtype, levels):
    """Forward and backward bit for bit, with heavy ties (``levels``)."""
    x = _bf16_randn(shape, cuda, shape[1] * shape[2], relu=True,
                    levels=levels).to(dtype)
    before = (kpool.fwd_launches, kpool.bwd_launches)
    y = kpool.max_pool_fwd(x)
    want_y = pool_fwd(x)
    assert y.dtype == dtype and y.shape == want_y.shape
    assert torch.equal(y, want_y)
    g = _bf16_randn(y.shape, cuda, 1).to(dtype)
    dx = kpool.max_pool_bwd(x, y, g)
    dx2 = kpool.max_pool_bwd(x, y, g)
    torch.cuda.synchronize()
    assert (kpool.fwd_launches, kpool.bwd_launches) == (before[0] + 1,
                                                        before[1] + 2)
    assert torch.equal(dx, pool_bwd(x, want_y, g)) and torch.equal(dx, dx2)


def test_pool_kernel_propagates_nan(cuda):
    x = _bf16_randn((2, 17, 29, 16), cuda, 3)
    x[0, 4, 5, 3] = float("nan")
    x[1, 16, 28, :] = float("nan")  # a ragged corner window
    y = kpool.max_pool_fwd(x)
    want = pool_fwd(x)
    assert int(y.isnan().sum()) == 17 and _nan_equal(y, want)
    g = _bf16_randn(y.shape, cuda, 4)
    assert torch.equal(kpool.max_pool_bwd(x, y, g), pool_bwd(x, want, g))


def test_pool_kernels_reject_what_they_do_not_take(cuda):
    x = _bf16_randn((1, 9, 13, 16), cuda, 0)
    y = kpool.max_pool_fwd(x)
    with pytest.raises(ValueError):
        kpool.max_pool_fwd(x.half())
    with pytest.raises(ValueError):
        kpool.max_pool_fwd(x.transpose(1, 2))
    with pytest.raises(ValueError):
        kpool.max_pool_bwd(x, y, y.float())
    with pytest.raises(ValueError):
        kpool.max_pool_bwd(x, y[:, :4].contiguous(), y)


INT8_SHAPES = [(2, 33, 49, 64, 64), (1, 7, 13, 12, 17), (3, 1, 9, 3, 1),
               (2, 5, 70, 48, 65), (1, 9, 9, 1, 12)]


def _int8_operands(shape, device, seed):
    n, h, w, c, d = shape
    gen = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, (n, h, w, c), generator=gen, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (d, c, 3, 3), generator=gen, dtype=torch.int8)
    scale = torch.rand(d, generator=gen) * 1e-3 + 1e-5
    bias = torch.randn(d, generator=gen)
    return [t.to(device) for t in (x_q, w_q, scale, bias)]


@pytest.mark.parametrize("shape", INT8_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_int8_conv_kernel_matches_ref(cuda, shape, relu):
    """I1 bit for bit against its plain version, which runs on CPU copies
    (``torch._int_mm`` on CUDA takes only K and Cout multiples of 8), one
    count a launch, two launches equal."""
    ops = _int8_operands(shape, cuda, sum(shape))
    before = int8conv.launches
    y = int8conv.int8_conv3x3(*ops, relu=relu)
    y2 = int8conv.int8_conv3x3(*ops, relu=relu)
    torch.cuda.synchronize()
    assert int8conv.launches == before + 2
    want = int8conv.int8_conv3x3_ref(*[t.cpu() for t in ops], relu=relu)
    assert y.dtype == torch.bfloat16 and y.shape == want.shape
    assert torch.equal(y.cpu(), want) and torch.equal(y, y2)


def test_int8_conv_kernel_rejects_what_it_does_not_take(cuda):
    x_q, w_q, scale, bias = _int8_operands((1, 9, 13, 16, 8), cuda, 0)
    before = int8conv.launches
    for bad in ((x_q.float(), w_q, scale, bias), (x_q, w_q.cpu(), scale, bias),
                (x_q.transpose(1, 2), w_q, scale, bias),
                (x_q, w_q, scale.double(), bias), (x_q, w_q[:4], scale, bias),
                (x_q[..., :8], w_q, scale, bias)):
        with pytest.raises(ValueError):
            int8conv.int8_conv3x3(*bad)
    with pytest.raises(ValueError):
        int8conv.int8_conv3x3(x_q, w_q, scale, bias,
                              packed=int8conv.pack_weight(w_q)[:, :64])
    assert int8conv.launches == before


def test_int8_model_kernel_matches_plain(cuda, monkeypatch):
    """The int8 model on the card through I1, and with the plain I1 on CPU
    copies substituted: the same outputs bit for bit, one launch per trunk
    conv after the stem."""
    cfg = dataclasses.replace(TINY, compute_mode="int8")
    model = OSVOS(cfg)
    model.load_state_dict(init_osvos_params(cfg, torch.Generator().manual_seed(0)))
    model.to(cuda)
    x = torch.from_numpy((np.random.RandomState(0).randn(2, 65, 97, 3) * 40)
                         .astype(np.float32)).to(cuda)
    before = int8conv.launches
    with torch.no_grad():
        got = model(x, mode="infer_parts")
    assert int8conv.launches == before + sum(len(s) for s in cfg.stages) - 1

    def plain(*args, **kw):
        kw.pop("packed", None)
        return int8conv.int8_conv3x3_ref(*[a.cpu() for a in args], **kw).to(cuda)

    monkeypatch.setattr(int8conv, "int8_conv3x3", plain)
    with torch.no_grad():
        want = model(x, mode="infer_parts")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# I1's Hopper path: the 12 trunk convs after the stem of a batch-1 480x854
# frame, then edge shapes (Cin 32, H = 1, W = 1, ragged W, Cout 192 on the
# 64-channel tiles)
INT8_Q_SHAPES = [(1, 480, 854, 64, 64), (1, 240, 427, 64, 128),
                 (1, 240, 427, 128, 128), (1, 120, 214, 128, 256),
                 (1, 120, 214, 256, 256), (1, 120, 214, 256, 256),
                 (1, 60, 107, 256, 512), (1, 60, 107, 512, 512),
                 (1, 60, 107, 512, 512), (1, 30, 54, 512, 512),
                 (1, 30, 54, 512, 512), (1, 30, 54, 512, 512),
                 (2, 1, 70, 32, 64), (1, 9, 1, 64, 64), (3, 5, 131, 64, 192),
                 (1, 4, 64, 128, 128)]


def _int8_q_operands(shape, device, seed, rule):
    """bf16 x, its x_scale by ``rule`` (dynamic: max|x|; clip: 0.6 of it,
    signed x), w_q, w_scale and bias of an int8_conv3x3_q call."""
    n, h, w, c, d = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=gen) * 2
    if rule == "dynamic":
        x = x.relu()
    x = x.to(torch.bfloat16)
    x_scale = int8conv.activation_scale(x)
    if rule == "clip":
        x_scale = x_scale * 0.6
    w_q, w_scale = int8conv.quantize_weight(torch.randn(d, c, 3, 3, generator=gen))
    bias = torch.randn(d, generator=gen) * 0.1
    return [t.to(device) for t in (x, x_scale, w_q, w_scale, bias)]


@pytest.mark.parametrize("shape", INT8_Q_SHAPES)
@pytest.mark.parametrize("rule", ["dynamic", "clip"])
def test_int8_q_kernel_matches_ref(cuda, shape, rule):
    """The Hopper path bit for bit against its plain version, which runs
    on CPU copies; its max_out against the plain max; one Hopper count a
    launch and no mma count; two launches equal."""
    x, x_scale, w_q, w_scale, bias = _int8_q_operands(shape, cuda, sum(shape), rule)
    assert int8conv.hopper_takes(shape[3], shape[4])
    packed = int8conv.pack_for(w_q)
    before, mma = int8conv.hopper_launches, int8conv.launches
    m1 = torch.zeros((), device=cuda)
    y = int8conv.int8_conv3x3_q(x, x_scale, w_q, w_scale, bias, packed=packed,
                                max_out=m1)
    y2 = int8conv.int8_conv3x3_q(x, x_scale, w_q, w_scale, bias, packed=packed)
    torch.cuda.synchronize()
    assert int8conv.hopper_launches == before + 2 and int8conv.launches == mma
    m2 = torch.zeros(())
    want = int8conv.int8_conv3x3_q_ref(*[t.cpu() for t in (x, x_scale, w_q, w_scale, bias)],
                                       max_out=m2)
    assert y.dtype == torch.bfloat16 and y.shape == want.shape
    assert torch.equal(y.cpu(), want) and torch.equal(y, y2)
    assert float(m1) == float(m2)


@pytest.mark.parametrize("shape", [(2, 17, 29, 12, 16), (1, 9, 13, 48, 64),
                                   (1, 7, 13, 64, 8)])
def test_int8_q_odd_shapes_take_the_mma_path(cuda, shape):
    """Off the Hopper shapes the entry quantizes in PyTorch and launches
    the mma.sync kernel: one mma count, no Hopper count, bit for bit."""
    x, x_scale, w_q, w_scale, bias = _int8_q_operands(shape, cuda, 5, "dynamic")
    assert not int8conv.hopper_takes(shape[3], shape[4])
    before, mma = int8conv.hopper_launches, int8conv.launches
    m1 = torch.zeros((), device=cuda)
    y = int8conv.int8_conv3x3_q(x, x_scale, w_q, w_scale, bias, max_out=m1)
    torch.cuda.synchronize()
    assert int8conv.hopper_launches == before and int8conv.launches == mma + 1
    m2 = torch.zeros(())
    want = int8conv.int8_conv3x3_q_ref(*[t.cpu() for t in (x, x_scale, w_q, w_scale, bias)],
                                       max_out=m2)
    assert torch.equal(y.cpu(), want) and float(m1) == float(m2)


def test_int8_q_kernel_rejects_what_it_does_not_take(cuda):
    x, x_scale, w_q, w_scale, bias = _int8_q_operands((1, 9, 13, 64, 64), cuda, 0,
                                                      "dynamic")
    before = int8conv.hopper_launches
    for bad in ((x.float(), x_scale, w_q, w_scale, bias),
                (x.transpose(1, 2), x_scale, w_q, w_scale, bias),
                (x, x_scale.double(), w_q, w_scale, bias),
                (x, x_scale, w_q.cpu(), w_scale, bias),
                (x, x_scale, w_q, w_scale[:8], bias)):
        with pytest.raises(ValueError):
            int8conv.int8_conv3x3_q(*bad)
    with pytest.raises(ValueError):
        int8conv.int8_conv3x3_q(x, x_scale, w_q, w_scale, bias,
                                packed=int8conv.pack_weight(w_q))
    with pytest.raises(ValueError):
        int8conv.int8_conv3x3_q(x, x_scale, w_q, w_scale, bias, relu=False,
                                max_out=torch.zeros((), device=cuda))
    assert int8conv.hopper_launches == before


def test_int8_model_hopper_path_matches_plain(cuda, monkeypatch):
    """The int8 model at widths where every conv after the stem's first
    takes the Hopper path, dynamic scales through the max buffer: the same
    maps as with the plain version on CPU copies substituted."""
    cfg = ModelConfig(stages=((8, 32), (64, 64), (64, 128, 64), (64, 64, 64),
                              (64, 64, 64)), side_channels=8, compute_mode="int8")
    model = OSVOS(cfg)
    model.load_state_dict(init_osvos_params(cfg, torch.Generator().manual_seed(0)))
    model.to(cuda)
    x = torch.from_numpy((np.random.RandomState(0).randn(2, 65, 97, 3) * 40)
                         .astype(np.float32)).to(cuda)
    before, mma = int8conv.hopper_launches, int8conv.launches
    with torch.no_grad():
        got = model(x, mode="infer_parts")
    assert int8conv.hopper_launches == before + 11 and int8conv.launches == mma + 1

    def plain(x, x_scale, w_q, w_scale, bias, relu=True, packed=None, max_out=None):
        m = None if max_out is None else max_out.cpu()
        y = int8conv.int8_conv3x3_q_ref(x.cpu(), x_scale.cpu(), w_q.cpu(),
                                        w_scale.cpu(), bias.cpu(), relu, m)
        if max_out is not None:
            max_out.copy_(m)
        return y.to(cuda)

    monkeypatch.setattr(int8conv, "int8_conv3x3_q", plain)
    with torch.no_grad():
        want = model(x, mode="infer_parts")
    for g, w in zip(got, want):
        assert torch.equal(g, w)

