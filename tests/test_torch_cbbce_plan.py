"""How the CB-BCE statistics kernel (``csrc/cbbce.cu``, B13/B11) divides
and folds its work, held on the CPU: its tile list and each thread's
elements (``ops/kernels/cbbce.py``'s ``stats_tiles`` and ``tile_order``)
cover every element of every sample once, for rows that start on and off a
16-byte boundary; and the kernel's order of sums, restated in numpy float32
(each thread's elements in its order, the block's shuffle tree, a sample's
tile partials folded in chunk order by one warp), is within 1e-5 relative
of the plain version and of the JAX package's per-sample Pallas kernel in
interpret mode, with the counts exact. The kernel itself runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osvos_tpu.ops.pallas.cbbce import _cbbce_stats_per_sample
from osvos_torch.ops.kernels import cbbce

COVER_SHAPES = [(5, 480 * 854), (1, 5 * 480 * 854), (3, 33 * 49), (2, 7),
                (1, 1), (7, 8193)]


def _kernel_constant(name):
    src = (Path(cbbce.__file__).parents[2] / "csrc" / "cbbce.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_python_plan_constants_are_the_kernels():
    assert cbbce.STATS_THREADS == _kernel_constant("kThreads")
    assert cbbce.STATS_UNROLL == _kernel_constant("kUnroll")
    assert cbbce.CHUNK == 4 * cbbce.STATS_UNROLL * cbbce.STATS_THREADS


def _orders(b, n):
    """Per tile, (sample, (threads, slots) element indices in its row): a
    row starts (b * n) % 4 floats past a 16-byte boundary, as rows of a
    16-byte aligned (B, n) tensor do."""
    return [(s, cbbce.tile_order(lo, hi, (s * n) % 4))
            for s, lo, hi in cbbce.stats_tiles(b, n)]


@pytest.mark.parametrize("b,n", COVER_SHAPES)
def test_tiles_cover_every_element_once(b, n):
    tiles = cbbce.stats_tiles(b, n)
    assert len(tiles) == b * -(-n // cbbce.CHUNK)
    cover = np.zeros((b, n), np.int32)
    for s, order in _orders(b, n):
        taken = order[order >= 0]
        np.add.at(cover[s], taken, 1)
    assert (cover == 1).all()


def _terms(x, z):
    """Each element's (count, term to sum_pos, term to sum_neg), float32."""
    pos = z >= 0.5
    t = (np.maximum(np.where(pos, -x, x), 0)
         + np.log1p(np.exp(-np.abs(x)))).astype(np.float32)
    zero = np.float32(0)
    return pos.astype(np.int64), np.where(pos, t, zero), np.where(pos, zero, t)


def _tree(v, width):
    """Lane 0 of a shuffle-down tree over the last axis (``width`` lanes)."""
    v = v.copy()
    off = width // 2
    while off:
        v[..., :off] = v[..., :off] + v[..., off:2 * off]
        off //= 2
    return v[..., 0]


def _restated_stats(x, z):
    """(B, 4) in the kernel's order of sums, float32 throughout."""
    b, n = x.shape
    cnt_t, sp_t, sn_t = _terms(x, z)
    chunks = -(-n // cbbce.CHUNK)
    part = np.zeros((b, chunks, 3), np.float64)
    for t, (s, order) in enumerate(_orders(b, n)):
        acc = [np.zeros(cbbce.STATS_THREADS, dt)
               for dt in (np.int64, np.float32, np.float32)]
        for slot in range(order.shape[1]):
            e = order[:, slot]
            on = e >= 0
            for a, terms in zip(acc, (cnt_t, sp_t, sn_t)):
                a[on] = a[on] + terms[s, e[on]]
        warps = cbbce.STATS_THREADS // 32
        folded = [_tree(_tree(a.reshape(warps, 32), 32), warps) for a in acc]
        part[s, t % chunks] = folded
    out = np.zeros((b, 4), np.float32)
    for s in range(b):
        lanes = [np.zeros(32, dt) for dt in (np.int64, np.float32, np.float32)]
        for j in range(chunks):
            for k, a in enumerate(lanes):
                a[j % 32] = a[j % 32] + a.dtype.type(part[s, j, k])
        cnt, sp, sn = (_tree(a, 32) for a in lanes)
        out[s] = (cnt, n - cnt, sp, sn)
    return out


def _inputs(b, n, seed):
    """Logits of std 5 with some at +-100 (none first: a lone -100 gives a
    sum of 4e-44, whose float32 rounding is all that is compared), labels
    in [0, 0.72) of which about 30% reach 0.5."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, n) * 5).astype(np.float32)
    x.reshape(-1)[1::997] = 100.0
    x.reshape(-1)[2::1009] = -100.0
    z = (rng.rand(b, n) * 0.72).astype(np.float32)
    return x, z


@pytest.mark.parametrize("b,n", [(5, 480 * 854), (3, 33 * 49), (2, 7), (1, 1),
                                 (7, 8193)])
def test_restated_order_matches_ref(b, n):
    x, z = _inputs(b, n, seed=n)
    got = _restated_stats(x, z)
    want = cbbce.cbbce_stats_ref(torch.from_numpy(x), torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-5, atol=0)


def test_restated_order_matches_jax_pallas():
    """Against the JAX package's per-sample statistics kernel (B13) in
    interpret mode, at a small shape with unaligned rows."""
    x, z = _inputs(3, 33 * 49, seed=7)
    got = _restated_stats(x, z)
    want = np.asarray(_cbbce_stats_per_sample(jnp.asarray(x), jnp.asarray(z),
                                              interpret=True))
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-5, atol=0)
