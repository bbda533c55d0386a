"""The packed schedule (``parallel/packed.py``, ``schedule='packed'``) against
the JAX package's packed schedule and the port's rounds, in one process.

At ``tests/test_parallel.py``'s tiny parity config (``dryrun.TINY``) and its
fast twin, 32x48 frames, S = 2, 4 steps in chunks of 2:

- against JAX ``batched_fine_tune(schedule='packed', mesh=None)`` fed the
  same ``_host_pools`` and the draws of its keys: losses within rtol 2e-4;
  each leaf's delta within 5e-3 of its delta scale, the fuse bias against
  the largest bias delta (``tests/test_torch_parallel.py``'s bounds),
  except in fast mode the biases, held to 0.3 of theirs: there the port's
  rounds read exactly what its packed run reads against JAX (side_prep1's
  bias 0.284 of its delta, every kernel within 5e-5 of its own), while
  JAX's packed run equals its rounds. The cause is the JAX package's bias
  gradient on the CPU, whose bf16 reduce rounds its partial sums where the
  port sums in float32 and rounds once (``tests/test_torch_fast_bias.py``);
- against the port's rounds on the same draws and pools, in parity and
  fast, once with ``step_mode='sequential'`` and once with
  ``aug_mode='per_step'``: losses within rtol 1e-4, every leaf within
  rtol 1e-4, atol 1e-7 (``tests/test_parallel.py``'s bounds for JAX's
  packed against the sequential chunk);
- ``conv3x3_same_seq`` against ``conv3x3_same`` on each sequence's slice;
  ``wgrad3x3_seq_ref`` and ``stem_wgrad_seq_ref`` bit for bit their lone
  plain versions a slice; the wrappers' refusals;
- the sequence-batched kernels' index math restated in Python: every
  (sequence, unit, tile) covered once and in the lone launch's order,
  disjoint scratch a sequence, the 5-D and 4-D TMA boxes reading one
  sequence's channels with the zero fill at its own channel count, the
  sequence-major grids of both kernels, and B16's gather into the lone
  strip slots;
- the dispatch rules: ``'auto'`` by the JAX rule, the flat -> fast
  downgrade and its warning, and the pool cap counting ceil(S/D)
  sequences a device.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.configs import OnlineConfig as JaxOnlineConfig
from osvos_tpu.parallel import batched_online as jax_bo
from osvos_torch.configs import OnlineConfig
from osvos_torch.models import OSVOS, init_osvos_params, params_to_jax
from osvos_torch.ops.fastconv import (conv3x3_bias_relu_seq, conv3x3_same,
                                      conv3x3_same_seq)
from osvos_torch.ops.kernels import flatconv, stem_wgrad, wgrad
from osvos_torch.parallel import batched_online as bo
from osvos_torch.parallel import dryrun, packed
from osvos_torch.train.online import Draws

TINY = dryrun.TINY
FAST = dataclasses.replace(TINY, compute_mode="fast")
CFG = OnlineConfig(n_steps=4, n_ave_grad=2, lr=1e-5, scan_chunk=2)
POOL = 4
S = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tiny CPU steps in one thread: beside the other test
    workers, more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state0():
    return init_osvos_params(TINY, torch.Generator().manual_seed(11))


def _replay(step_keys, cfg, pool):
    """The draws of the JAX chunk's pool mode from one sequence's step keys,
    as the port's ``Draws`` (``tests/test_torch_parallel.py``)."""
    flips, idx = [], []
    for key in step_keys:
        row_f, row_i = [], []
        for k in jax.random.split(key, cfg.n_ave_grad):
            ki, kf = jax.random.split(k)
            row_f.append(bool(jax.random.uniform(kf) < cfg.hflip_prob))
            row_i.append(int(jax.random.randint(ki, (), 0, pool)))
        flips.append(row_f)
        idx.append(row_i)
    return Draws(flip=torch.tensor(flips), index=torch.tensor(idx))


@pytest.mark.parametrize("config", [TINY, FAST], ids=["parity", "fast"])
def test_packed_matches_jax_packed(config, monkeypatch):
    imgs, masks = dryrun.pairs(S)
    state0 = _state0()
    jcfg = JaxOnlineConfig(**dataclasses.asdict(CFG))
    want, want_losses = jax_bo.batched_fine_tune(
        jax.tree.map(jnp.asarray, params_to_jax(state0)), jnp.asarray(imgs),
        jnp.asarray(masks), JaxModelConfig(**dataclasses.asdict(config)), jcfg,
        mesh=None, aug_mode="pool", pool_size=POOL, schedule="packed")
    seq_keys = jax.random.split(jax.random.PRNGKey(CFG.seed), S)
    draws = [_replay(jax.random.split(k, CFG.n_steps), CFG, POOL)
             for k in seq_keys]
    pools = jax_bo._host_pools(imgs, masks, jcfg, POOL)
    monkeypatch.setattr(bo, "_host_pools", lambda *a, indices, **k: (
        pools[0][indices], pools[1][indices]))
    got, got_losses = bo.batched_fine_tune(state0, imgs, masks, config, CFG,
                                           draws=draws, pool_size=POOL,
                                           schedule="packed", device="cpu")
    assert got_losses.shape == (S, CFG.n_steps)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses),
                               rtol=2e-4)
    p0 = params_to_jax(state0)
    for i in range(S):
        g = params_to_jax(bo.unstack_params(got, i))
        w = jax.tree.map(np.asarray, jax_bo.unstack_params(want, i))
        gmax = max(float(np.abs(w[m][k] - p0[m][k]).max())
                   for m in p0 for k in p0[m])
        assert gmax > 0, "training moved nothing; the test is vacuous"
        bias_scale = max(float(np.abs(w[m]["bias"] - p0[m]["bias"]).max())
                         for m in p0)
        for m in p0:
            for k in p0[m]:
                dg, dw = g[m][k] - p0[m][k], w[m][k] - p0[m][k]
                scale = bias_scale if (m, k) == ("fuse", "bias") \
                    else float(np.abs(dw).max())
                tol = 0.3 if config.compute_mode == "fast" and k == "bias" \
                    else 5e-3
                atol = tol * scale
                np.testing.assert_allclose(
                    dg, dw, rtol=0, atol=max(atol, 1e-12),
                    err_msg=f"seq {i} delta of {m}.{k}")


@pytest.mark.parametrize("config,step_mode,aug_mode", [
    (TINY, "microbatch", "pool"), (FAST, "microbatch", "pool"),
    (FAST, "sequential", "pool"), (TINY, "microbatch", "per_step")],
    ids=["parity", "fast", "fast-sequential", "parity-per_step"])
def test_packed_matches_the_rounds(config, step_mode, aug_mode):
    imgs, masks = dryrun.pairs(S)
    state0 = _state0()
    kw = dict(pool_size=POOL, step_mode=step_mode, aug_mode=aug_mode,
              device="cpu")
    want, want_losses = bo.batched_fine_tune(state0, imgs, masks, config, CFG,
                                             schedule="rounds", **kw)
    got, got_losses = bo.batched_fine_tune(state0, imgs, masks, config, CFG,
                                           schedule="packed", **kw)
    np.testing.assert_allclose(got_losses.numpy(), want_losses.numpy(),
                               rtol=1e-4)
    assert not torch.equal(got_losses[0], got_losses[1])
    for k, v in want.items():
        assert got[k].shape == v.shape == (S,) + state0[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        # not vacuous: every leaf of the 'infer' graph moved (score_dsn's
        # gradient is zero, and its decay is below float32 resolution here)
        assert k.startswith("score_dsn") or not torch.equal(
            v, state0[k].expand_as(v)), k


@pytest.mark.parametrize("c,d", [(3, 4), (4, 6)], ids=["stem", "trunk"])
def test_conv3x3_same_seq_is_conv3x3_same_a_slice(c, d):
    """Forward, d(input) and d(weight) of the grouped conv against the lone
    conv on each sequence's channels; dK bit for bit (the same plain
    version on the same slice)."""
    gen = torch.Generator().manual_seed(c * d)
    x = torch.randn(2, 7, 9, 3 * c, generator=gen).to(torch.bfloat16)
    weight = torch.randn(3, d, c, 3, 3, generator=gen)
    cot = torch.randn(2, 7, 9, 3 * d, generator=gen).to(torch.bfloat16)
    xs = x.clone().requires_grad_()
    ws = weight.clone().requires_grad_()
    y = conv3x3_same_seq(xs, ws)
    y.backward(cot)
    for i in range(3):
        xi = x[..., i * c:(i + 1) * c].clone().requires_grad_()
        wi = weight[i].clone().requires_grad_()
        yi = conv3x3_same(xi, wi)
        yi.backward(cot[..., i * d:(i + 1) * d])
        torch.testing.assert_close(y[..., i * d:(i + 1) * d], yi, rtol=0, atol=0)
        torch.testing.assert_close(xs.grad[..., i * c:(i + 1) * c], xi.grad,
                                   rtol=0, atol=0)
        assert torch.equal(ws.grad[i], wi.grad), i


@pytest.mark.parametrize("s,c,d", [(2, 8, 16), (3, 12, 4), (1, 16, 8)])
def test_wgrad3x3_seq_ref_is_the_lone_ref_a_slice(s, c, d):
    gen = torch.Generator().manual_seed(s + c + d)
    x = torch.randn(2, 5, 7, s * c, generator=gen).to(torch.bfloat16)
    g = torch.randn(2, 5, 7, s * d, generator=gen).to(torch.bfloat16)
    got, via = wgrad.wgrad3x3_seq_ref(x, g, s), wgrad.wgrad3x3_seq(x, g, s)
    assert got.shape == (s, 3, 3, c, d) and torch.equal(got, via)
    for i in range(s):
        assert torch.equal(got[i], wgrad.wgrad3x3_ref(
            x[..., i * c:(i + 1) * c].contiguous(),
            g[..., i * d:(i + 1) * d].contiguous())), i


@pytest.mark.parametrize("s,c,d", [(2, 3, 8), (4, 1, 12), (3, 2, 64)])
def test_stem_wgrad_seq_ref_is_the_lone_ref_a_slice(s, c, d):
    gen = torch.Generator().manual_seed(s + c + d)
    x = (torch.randn(2, 5, 7, s * c, generator=gen) * 60).to(torch.bfloat16)
    g = torch.randn(2, 5, 7, s * d, generator=gen).to(torch.bfloat16)
    dk, db = stem_wgrad.stem_wgrad_seq_ref(x, g, s)
    via = stem_wgrad.stem_wgrad_seq(x, g, s)
    assert dk.shape == (s, 3, 3, c, d) and db.shape == (s, d)
    assert torch.equal(dk, via[0]) and torch.equal(db, via[1])
    for i in range(s):
        want_dk, want_db = stem_wgrad.stem_wgrad_ref(
            x[..., i * c:(i + 1) * c].contiguous(),
            g[..., i * d:(i + 1) * d].contiguous())
        assert torch.equal(dk[i], want_dk) and torch.equal(db[i], want_db), i


def test_seq_wrappers_refuse_shapes_and_devices():
    x = torch.zeros(1, 4, 5, 6, dtype=torch.bfloat16)
    g = torch.zeros(1, 4, 5, 8, dtype=torch.bfloat16)
    for fn in (wgrad.wgrad3x3_seq, stem_wgrad.stem_wgrad_seq):
        with pytest.raises(ValueError, match="do not divide"):
            fn(x, g, 4)  # 4 sequences do not divide 6 channels
        with pytest.raises(ValueError, match="do not divide"):
            fn(x, g, 0)
        with pytest.raises(ValueError, match="differ in N, H or W"):
            fn(x, g[:, :3], 2)
    with pytest.raises(ValueError, match="input channels a sequence"):
        stem_wgrad.stem_wgrad_seq(torch.zeros(1, 4, 5, 8), g, 2)
    # no kernel off the card: the device checks refuse a CPU tensor
    with pytest.raises(ValueError, match="no kernel for cpu"):
        wgrad._check(x, g)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        stem_wgrad._check(x, g, "stem_wgrad_seq")


# --- the sequence-batched kernels' index math, restated ---------------------


def _tma_box(t, dims, coords, box):
    """A TMA box of a packed tensor seen innermost-first as ``dims``: the
    elements at ``coords + offsets`` for every offset inside ``box``, zero
    where a coordinate falls outside its dimension. ``t`` is flat."""
    flat = t.reshape(-1)
    strides = np.cumprod((1,) + tuple(dims[:-1]))
    out = np.zeros(tuple(reversed(box)), t.dtype)
    for off in np.ndindex(*reversed(box)):
        pos = [coords[i] + off[len(box) - 1 - i] for i in range(len(box))]
        if all(0 <= p < dim for p, dim in zip(pos, dims)):
            out[off] = flat[int(np.dot(pos, strides))]
    return out


@pytest.mark.parametrize("c", [8, 64, 72])
def test_wgrad_5d_box_reads_one_sequence(c):
    """``encode_map5``'s box at sequence s is the lone 4-D box of s's slice,
    the zero fill past its own C; a 4-D box at channel offset s * C over the
    interleaved tensor would read the next sequence's channels at C < 64."""
    n, h, w, s, kw = 2, 3, 5, 3, 4
    x = np.arange(n * h * w * s * c, dtype=np.int64).reshape(n, h, w, s * c) + 1
    for seq in range(s):
        lone = np.ascontiguousarray(x[..., seq * c:(seq + 1) * c])
        for c0, w0, hh, nn in [(0, -1, 0, 0), (64, 3, 2, 1), (0, 2, -1, 1),
                               (0, 0, 1, 0)]:
            if c0 >= c:
                continue
            got = _tma_box(x, (c, s, w, h, n), (c0, seq, w0, hh, nn),
                           (64, 1, kw + 2, 1, 1))
            want = _tma_box(lone, (c, w, h, n), (c0, w0, hh, nn), (64, kw + 2, 1, 1))
            np.testing.assert_array_equal(got.reshape(want.shape), want)
            if c < 64 and seq + 1 < s and want.any():
                naive = _tma_box(x, (s * c, w, h, n), (seq * c + c0, w0, hh, nn),
                                 (64, kw + 2, 1, 1))
                assert not np.array_equal(naive, want)


def test_stem_4d_g_box_reads_one_sequence():
    """B16's g map (D, S, W, N * H): a box at sequence s is the lone 3-D
    rows box of s's slice."""
    n, h, w, s, d = 2, 3, 130, 2, 72
    g = np.arange(n * h * w * s * d, dtype=np.int64).reshape(n * h, w, s * d)
    for seq in range(s):
        lone = np.ascontiguousarray(g[..., seq * d:(seq + 1) * d])
        for d0, seg, r in [(0, 0, 0), (64, 1, 5), (0, 1, 3)]:
            got = _tma_box(g, (d, s, w, n * h), (d0, seq, 128 * seg, r),
                           (64, 1, 128, 1))
            want = _tma_box(lone, (d, w, n * h), (d0, 128 * seg, r), (64, 128, 1))
            np.testing.assert_array_equal(got.reshape(want.shape), want)


def _tma_units(p, s):
    """(grid block, sequence, block, unit, tile, piece) of every K-step of a
    sequence-batched Hopper-path launch: grid block i decodes (``seq_block``)
    to sequence q and rank r, and runs block b = ``p.order(s)[r]`` of q:
    units [b * total / blocks, ...), piece q * pieces + b + t."""
    out = []
    order = p.order(s)
    for i in range(s * p.blocks):
        seq, rank = wgrad.seq_block(i, s)
        b = order[rank]
        lo, hi = p.block_range(b)
        for u in range(lo, hi):
            t = u // p.units
            out.append((i, seq, b, u, t, seq * p.pieces + b + t))
    return out


@pytest.mark.parametrize("shape", [(5, 480, 854, 64, 64), (5, 30, 54, 512, 512),
                                   (5, 120, 214, 256, 16), (2, 9, 13, 8, 16),
                                   (1, 1, 1, 8, 8)])
@pytest.mark.parametrize("s", [2, 3])
def test_wgrad_seq_grid_is_the_lone_grid_a_sequence(shape, s):
    """Sequence-major dispatch: grid blocks i = r * S + q are the block of
    rank r of the S sequences, so blocks dispatched side by side take the
    same unit range of every sequence; the ranks are a permutation of the
    blocks ordered by the pixel their run starts at, then by tile, so where
    the tiles divide the blocks each run of `tiles` ranks starts at the same
    pixel of every tile (a lone launch keeps the tile order); each
    sequence's K-steps, blocks and pieces are the lone launch's, every
    (sequence, unit) once; the pieces of two sequences never meet; the
    second pass folds each sequence's tile from its own pieces in the lone
    block order, and its grid blocks decode the same way to every (sequence,
    output chunk) once."""
    p = wgrad.plan(*shape)
    assert p.path == "tma"
    order = p.order(s)
    assert order == sorted(range(p.blocks), key=lambda b: (
        b * p.tiles % p.blocks, b * p.tiles // p.blocks))
    assert p.order(1) == list(range(p.blocks))  # a lone launch: tile order
    starts = [p.block_range(b)[0] for b in order]
    assert [u % p.units for u in starts] == sorted(u % p.units for u in starts)
    if p.blocks % p.tiles == 0:
        for j in range(0, p.blocks, p.tiles):
            group = starts[j:j + p.tiles]
            assert sorted(u // p.units for u in group) == list(range(p.tiles))
            assert len({u % p.units for u in group}) == 1
    lone = sorted((b, u, t, piece) for _, _, b, u, t, piece in _tma_units(p, 1))
    units = _tma_units(p, s)
    assert len(units) == s * p.total
    assert len({(seq, u) for _, seq, _, u, _, _ in units}) == s * p.total
    for seq in range(s):
        mine = sorted((b, u, t, piece - seq * p.pieces)
                      for _, q, b, u, t, piece in units if q == seq)
        assert mine == lone
    by_block = {}
    for i, _, _, u, _, _ in units:
        by_block.setdefault(i, []).append(u)
    for r in range(p.blocks):
        side = range(r * s, (r + 1) * s)
        assert [wgrad.seq_block(i, s) for i in side] == [(q, r) for q in range(s)]
        assert all(by_block[i] == list(range(*p.block_range(order[r])))
                   for i in side)
    pieces = {}
    for _, seq, b, _, t, piece in units:
        assert seq * p.pieces <= piece < (seq + 1) * p.pieces
        pieces.setdefault(piece, set()).add((seq, b, t))
    assert all(len(v) == 1 for v in pieces.values())
    for seq in range(s):
        for t in range(p.tiles):
            lo, hi = p.blocks_of_tile(t)
            folded = [seq * p.pieces + b + t for b in range(lo, hi + 1)]
            assert all(pieces[f] == {(seq, f - seq * p.pieces - t, t)}
                       for f in folded)
    n_out = 9 * shape[3] * shape[4]
    chunks = -(-n_out // 1024)
    outs = [wgrad.seq_block(i, s) for i in range(chunks * s)]
    assert sorted(outs) == [(q, k) for q in range(s) for k in range(chunks)]


@pytest.mark.parametrize("shape", [(5, 480, 854, 3, 64), (2, 7, 130, 2, 72),
                                   (3, 9, 70, 1, 16)])
@pytest.mark.parametrize("s", [2, 5])
def test_stem_seq_grid_is_the_lone_grid_a_sequence(shape, s):
    """B16's sequence launch: grid block i decodes (``seq_block``) to block
    bb * DT + t of sequence q, so blocks dispatched side by side take the
    same row run and channel tile of every sequence; every (sequence, run,
    tile) once, each sequence's runs the lone launch's, its partial slot
    q * runs + bb."""
    n, h, w, c, d = shape
    runs = stem_wgrad.tma_plan(n, h, w, c, d)
    dt = -(-d // stem_wgrad.TILE_D)
    spans = stem_wgrad.row_runs(n * h, runs)
    got = []
    for i in range(runs * dt * s):
        q, blk = wgrad.seq_block(i, s)
        bb, t = blk // dt, blk % dt
        got.append((q, bb, t, spans[bb], q * runs + bb))
        assert (bb, t) == divmod(i // s, dt)
    assert sorted(got) == sorted((q, bb, t, spans[bb], q * runs + bb)
                                 for q in range(s) for bb in range(runs)
                                 for t in range(dt))


@pytest.mark.parametrize("shape", [(2, 9, 13, 12, 4), (1, 5, 70, 3, 64)])
def test_wgrad_wmma_seq_grid(shape):
    """The wmma path's grid z = D tiles x S decodes to every (sequence, D
    tile) once, and the scratch rows seq * splits + split are disjoint."""
    s = 3
    n, h, w, c, d = shape
    p = wgrad.plan(*shape)
    assert p.path == "wmma"
    dt = -(-d // 64)
    decoded = [(z // dt, (z % dt) * 64) for z in range(dt * s)]
    assert sorted(decoded) == [(q, d0) for q in range(s)
                               for d0 in range(0, dt * 64, 64)]
    rows = [q * p.blocks + split for q in range(s) for split in range(p.blocks)]
    assert rows == list(range(s * p.blocks))


# --- B2-seq: the packed trunk's forward as one sequence launch ---------------


@pytest.mark.parametrize("shape,takes", [
    ((5, 480, 854, 64, 64), True), ((5, 30, 54, 512, 512), True),
    ((5, 60, 107, 256, 512), True), ((2, 9, 13, 8, 16), True),
    ((1, 1, 1, 8, 8), True), ((5, 480, 854, 3, 64), False),
    ((2, 9, 13, 12, 16), False), ((2, 9, 13, 16, 20), False)])
def test_fwd_seq_takes_the_trunk_after_the_stem(shape, takes):
    """B2-seq takes every trunk conv after the stem (C over STEM_MAX_C, C
    and D multiples of 8) and no other, and each sequence of it runs the
    lone forward's plan."""
    n, h, w, c, d = shape
    assert flatconv.seq_fwd_takes(n, h, w, c, d) is takes
    if takes:
        p = flatconv.plan(n, h, w, c, d, "fwd_fast")
        assert p == flatconv.plan(n, h, w, c, d, "fwd") and p.path == "hopper"


@pytest.mark.parametrize("c", [8, 72])
@pytest.mark.parametrize("rows", [4, 2])
def test_fwd_seq_5d_box_reads_one_sequence(c, rows):
    """B2-seq's input map (C, S, W, H, N) with the Hopper path's box of 64
    channels x 66 pixels x R rows: a box at sequence s is the lone 4-D box
    of s's slice, the zero fill past its own C; a 4-D box at channel offset
    s * C over the interleaved tensor would read the next sequence's
    channels at C < 64."""
    n, h, w, s = 2, 5, 70, 3
    x = np.arange(n * h * w * s * c, dtype=np.int64).reshape(n, h, w, s * c) + 1
    for seq in range(s):
        lone = np.ascontiguousarray(x[..., seq * c:(seq + 1) * c])
        for c0, w0, hh, nn in [(0, -1, -1, 0), (64, 63, 3, 1)]:
            if c0 >= c:
                continue
            got = _tma_box(x, (c, s, w, h, n), (c0, seq, w0, hh, nn),
                           (64, 1, flatconv.SEG + 2, rows, 1))
            want = _tma_box(lone, (c, w, h, n), (c0, w0, hh, nn),
                            (64, flatconv.SEG + 2, rows, 1))
            np.testing.assert_array_equal(got.reshape(want.shape), want)
            if c < 64 and seq + 1 < s:
                naive = _tma_box(x, (s * c, w, h, n), (seq * c + c0, w0, hh, nn),
                                 (64, flatconv.SEG + 2, rows, 1))
                assert not np.array_equal(naive, want)


@pytest.mark.parametrize("d,c,tile_n", [(16, 8, 64), (136, 72, 128), (64, 64, 64)])
@pytest.mark.parametrize("flip", [False, True])
def test_stacked_pack_is_the_lone_packs(d, c, tile_n, flip):
    """The pack of S stacked weights (S, D, C, 3, 3) is S lone packs one
    after another, each [tap][out][in] of its own weight rounded to bf16,
    zero-padded to the tiles; B2-seq's weight map (C_p, D_p, 9, S) with a
    (64, TN, 3, 1) box at sequence s reads s's lone operand."""
    s = 3
    gen = torch.Generator().manual_seed(d + c)
    weight = torch.randn(s, d, c, 3, 3, generator=gen)
    got = flatconv.pack_weight(weight, tile_n, 64, flip=flip)
    rows, cols = (c, d) if flip else (d, c)
    rows_p, cols_p = -(-rows // tile_n) * tile_n, -(-cols // 64) * 64
    assert got.shape == (s, 9, rows_p, cols_p) and got.dtype == torch.bfloat16
    for i in range(s):
        lone = flatconv.pack_weight(weight[i], tile_n, 64, flip=flip)
        assert torch.equal(got[i], lone), i
        k = weight[i].flip(2, 3).transpose(0, 1) if flip else weight[i]
        want = torch.zeros(9, rows_p, cols_p, dtype=torch.bfloat16)
        want[:, :rows, :cols] = k.permute(2, 3, 0, 1).reshape(9, rows, cols)
        assert torch.equal(lone, want), i
    ops = got.float().numpy()
    for seq in range(s):
        for c0, d0, kh in [(0, 0, 0), (64, tile_n, 2)]:
            box = _tma_box(ops, (cols_p, rows_p, 9, s), (c0, d0, 3 * kh, seq),
                           (64, tile_n, 3, 1))
            lone = _tma_box(ops[seq], (cols_p, rows_p, 9), (c0, d0, 3 * kh),
                            (64, tile_n, 3))
            np.testing.assert_array_equal(box.reshape(lone.shape), lone)


def test_fast_epilogue_is_torchs_bf16_bias_add():
    """The arithmetic of B2-seq's epilogue, restated: the conv rounded to
    bf16, the bf16 bias added in float32 and the sum rounded to bf16 again
    (round to nearest even, as ``__float2bfloat16_rn``), then the ReLU, is
    bit for bit the fast mode's ``F.relu(bf16(conv) + bf16(b))``; its plain
    version ``conv_fwd_seq_ref`` is that for each sequence's slice."""
    s, c, d = 3, 8, 16
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 7, 9, s * c, generator=gen).to(torch.bfloat16)
    weight = torch.randn(s, d, c, 3, 3, generator=gen)
    bias = (torch.randn(s * d, generator=gen) * 2).to(torch.bfloat16)
    acc = torch.cat([flatconv.conv3x3_f32(x[..., i * c:(i + 1) * c], weight[i])
                     for i in range(s)], dim=-1)
    twice = (acc.to(torch.bfloat16).float() + bias.float()).to(torch.bfloat16)
    want = torch.where(twice.float() > 0, twice, torch.zeros_like(twice))
    assert torch.equal(F.relu(acc.to(torch.bfloat16) + bias), want)
    got = flatconv.conv_fwd_seq(x, weight, bias)
    assert torch.equal(got, want)
    assert torch.equal(got, flatconv.conv_fwd_seq_ref(x, weight, bias))
    once = F.relu(acc + bias.float()).to(torch.bfloat16)  # flat's one rounding
    assert not torch.equal(once, want)
    for bad in (dict(bias=bias.float()), dict(weight=weight[0]),
                dict(x=x[..., :-8])):
        kw = dict(x=x, weight=weight, bias=bias) | bad
        with pytest.raises(ValueError):
            flatconv.conv_fwd_seq(**kw)


@pytest.mark.parametrize("s,c,d", [(2, 8, 16), (3, 16, 8), (1, 8, 8), (2, 3, 8)])
def test_conv3x3_bias_relu_seq_is_todays_ops_on_cpu(s, c, d):
    """The fused function on CPU tensors: the forward and the gradients of
    x, the weight and the float32 bias (through its flatten and bf16 cast)
    bit for bit ``F.relu(conv3x3_same_seq(x, w) + b)``'s under autograd."""
    gen = torch.Generator().manual_seed(s * c + d)
    x = torch.randn(2, 7, 9, s * c, generator=gen).clamp_min(0).to(torch.bfloat16)
    weight = torch.randn(s, d, c, 3, 3, generator=gen) * (9 * c) ** -0.5
    bias = torch.randn(s, d, generator=gen) * 0.1
    cot = torch.randn(2, 7, 9, s * d, generator=gen).to(torch.bfloat16)
    outs, grads = [], []
    for fused in (True, False):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, weight, bias))
        b16 = bs.flatten().to(torch.bfloat16)
        z = (conv3x3_bias_relu_seq(xs, ws, b16) if fused
             else F.relu(conv3x3_same_seq(xs, ws) + b16))
        z.backward(cot)
        outs.append(z)
        grads.append((xs.grad, ws.grad, bs.grad))
    assert torch.equal(outs[0], outs[1])
    assert float((outs[0] == 0).float().mean()) > 0.1  # the ReLU acted
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


class _Held:
    """A saved tensor as the graph holds it, which logs its release."""

    def __init__(self, t, log):
        self.t, self.tag, self.log = t, (tuple(t.shape), t.dtype), log
        log.append(("save", self.tag))

    def __del__(self):
        self.log.append(("free", self.tag))


@pytest.mark.parametrize("s,c,d", [(2, 8, 16), (1, 16, 8), (3, 8, 24), (2, 3, 8)])
def test_conv3x3_bias_relu_seq_holds_what_autograd_holds(s, c, d):
    """The fused function's graph saves what autograd's saves through
    ``conv3x3_same_seq`` + bias + ``F.relu`` and frees it in the same order:
    in the backward the output is read and released before the conv's node
    reads x and the weight, as ReLU's node releases it."""
    gen = torch.Generator().manual_seed(s * c + d)
    x = torch.randn(2, 5, 6, s * c, generator=gen).clamp_min(0).to(torch.bfloat16)
    weight = torch.randn(s, d, c, 3, 3, generator=gen)
    bias = torch.randn(s, d, generator=gen)
    cot = torch.randn(2, 5, 6, s * d, generator=gen).to(torch.bfloat16)
    logs = []
    for fused in (True, False):
        log = []

        def unpack(held):
            log.append(("read", held.tag))
            return held.t

        xs, ws, bs = (t.clone().requires_grad_() for t in (x, weight, bias))
        with torch.autograd.graph.saved_tensors_hooks(lambda t: _Held(t, log), unpack):
            b16 = bs.flatten().to(torch.bfloat16)
            z = (conv3x3_bias_relu_seq(xs, ws, b16) if fused
                 else F.relu(conv3x3_same_seq(xs, ws) + b16))
        z.backward(cot)
        del z
        logs.append(log)
    assert logs[0] == logs[1]
    out = ((2, 5, 6, s * d), torch.bfloat16)
    reads = [tag for ev, tag in logs[0] if ev == "read"]
    assert reads[0] == out and len(reads) == 3
    assert logs[0].index(("free", out)) < logs[0].index(("read", reads[1]))


def _lone_slot(xbytes, r, w, c):
    """The lone launch's strip slot of image row r of a contiguous (N, H, w,
    c) bf16 image (bytes ``xbytes``), as ``strip_load`` and ``strip_halo``
    fill it: the row's 16-byte chunks from LEAD on (zero past the tensor),
    then its two halo pixels zeroed; bytes no chunk writes hold 0xA5.
    Returns (slot, lead)."""
    a0, chunks, lead = stem_wgrad.row_window(r, w, c)
    slot = np.full(stem_wgrad.slot_bytes(w, c), 0xA5, np.uint8)
    for i in range(chunks):
        src = xbytes[a0 + 16 * i:a0 + 16 * i + 16]
        slot[stem_wgrad.LEAD + 16 * i:stem_wgrad.LEAD + 16 * i + 16] = 0
        slot[stem_wgrad.LEAD + 16 * i:stem_wgrad.LEAD + 16 * i + len(src)] = src
    slot[lead - 2 * c:lead] = 0
    slot[lead + 2 * w * c:lead + 2 * w * c + 2 * c] = 0
    return slot, lead


def _bits(x):
    """The bf16 values of x as a flat int16 array."""
    return x.to(torch.bfloat16).view(torch.int16).numpy().reshape(-1)


def _gathered_slot(xs, r, w, c, s, seq):
    """The sequence kernel's slot of row r of sequence ``seq``, from the
    interleaved image's int16 values ``xs``: zeroed at the block's start,
    then written where ``gather_row`` says."""
    offs, src = stem_wgrad.gather_row(r, w, c, s, seq)
    slot = np.zeros(stem_wgrad.slot_bytes(w, c), np.uint8)
    vals = np.where(src.numpy() >= 0, xs[src.numpy().clip(0)], 0).astype(np.int16)
    for o, v in zip(offs.tolist(), vals.view(np.uint8).reshape(-1, 2)):
        slot[o:o + 2] = v
    return slot


@pytest.mark.parametrize("c", [1, 2, 3])
def test_stem_seq_stacked_rows_give_the_lone_gradient(c):
    """The gather of B16's sequence kernel, at S = 2 and 5 (past the S = 4
    an interleaved strip fits): sequence s's slot of every image row, halo
    included, holds the lone strip slot of s's contiguous slice where the
    lone ``build_stacked`` reads it, and the zero row is zero; the stacked
    rows built from those slots (a zero row off the image), times s's
    cotangent, are ``stem_wgrad_ref`` of s's slice (integer-valued inputs,
    so every sum is exact); the slots fit the lone shared memory."""
    n, h, w, d = 2, 3, 13, 8
    assert stem_wgrad.tma_smem(854, c) <= stem_wgrad.SMEM_LIMIT
    for s in (2, 5):
        rng = np.random.RandomState(10 * s + c)
        x = rng.randint(-4, 5, (n, h, w, s * c)).astype(np.float32)
        g = rng.randint(-3, 4, (n, h, w, s * d)).astype(np.float32)
        xs = _bits(torch.from_numpy(x))
        zero = np.zeros(stem_wgrad.slot_bytes(w, c), np.uint8)
        for seq in range(s):
            xc = torch.from_numpy(np.ascontiguousarray(x[..., seq * c:(seq + 1) * c]))
            lone_bytes = _bits(xc).view(np.uint8)
            slots = []
            for r in range(n * h):
                got = _gathered_slot(xs, r, w, c, s, seq)
                want, lead = _lone_slot(lone_bytes, r, w, c)
                read = slice(lead - 2 * c, lead + 2 * (w + 1) * c)
                np.testing.assert_array_equal(got[read], want[read])
                slots.append((got, lead))
            rows = np.zeros((n * h, w, 32), np.float64)
            for r in range(n * h):
                for kh in range(3):
                    hh = r % h + kh - 1
                    slot, lead = (slots[r + kh - 1] if 0 <= hh < h
                                  else (zero, stem_wgrad.LEAD))
                    vals = slot[lead - 2 * c:lead + 2 * (w + 1) * c].view(np.int16)
                    f = torch.from_numpy(vals.copy()).view(torch.bfloat16).float().numpy()
                    for kw in range(3):
                        for ch in range(c):
                            rows[r, :, (3 * kh + kw) * c + ch] = f[kw * c + ch::c][:w]
                rows[r, :, 9 * c] = 1
            out = rows.reshape(-1, 32).T @ g[..., seq * d:(seq + 1) * d].reshape(-1, d)
            dk, db = stem_wgrad.stem_wgrad_ref(
                xc, torch.from_numpy(np.ascontiguousarray(g[..., seq * d:(seq + 1) * d])))
            np.testing.assert_array_equal(out[:9 * c].reshape(3, 3, c, d), dk.numpy())
            np.testing.assert_array_equal(out[9 * c], db.numpy())
            assert not out[9 * c + 1:].any()


# --- the model and the dispatch rules ----------------------------------------


@pytest.mark.parametrize("config", [TINY, FAST], ids=["parity", "fast"])
def test_packed_model_is_each_sequences_osvos(config):
    """``PackedOSVOS`` loads and returns the stacked state, and its channel
    s is sequence s's ``OSVOS.forward(mode='infer')``."""
    states = [init_osvos_params(TINY, torch.Generator().manual_seed(20 + i))
              for i in range(3)]
    stacked = bo.stack_param_list(states)
    model = packed.PackedOSVOS(config, 3).from_stacked(stacked)
    assert sorted(model.to_stacked()) == sorted(stacked)
    assert all(torch.equal(model.to_stacked()[k], v) for k, v in stacked.items())
    imgs, _ = dryrun.pairs(3)
    x = torch.from_numpy(imgs[:, None]).repeat(1, 2, 1, 1, 1)  # (S, N, H, W, 3)
    with torch.no_grad():
        out = model(packed.interleave(x.flatten(0, 1), 3))
        assert out.shape == (2, 32, 48, 3)
        for i, state in enumerate(states):
            one = OSVOS(config)
            one.load_state_dict(state)
            want = one(x[i], mode="infer")[0][..., 0]
            torch.testing.assert_close(out[..., i], want, rtol=1e-5, atol=1e-5)


class _Ran(Exception):
    pass


@pytest.mark.parametrize("mode,mesh,want", [
    ("parity", False, "packed"), ("fast", False, "packed"),
    ("flat", False, "rounds"), ("fast", True, "rounds"),
    ("parity", True, "rounds")])
def test_auto_follows_the_jax_rule(monkeypatch, mode, mesh, want):
    """``'auto'``: the rounds when a mesh is given or the mode is 'flat',
    else packed (``osvos_tpu/parallel/batched_online.py``)."""
    ran = []

    def record(name):
        def fn(*a, **k):
            ran.append(name)
            raise _Ran
        return fn

    monkeypatch.setattr(bo, "_fine_tune_rounds", record("rounds"))
    monkeypatch.setattr(bo, "_fine_tune_packed", record("packed"))
    monkeypatch.setattr(bo, "mesh_size", lambda m: 1 if m is None else 2)
    monkeypatch.setattr(bo, "mesh_rank", lambda m: 0)
    imgs, masks = dryrun.pairs(S)
    with pytest.raises(_Ran):
        bo.batched_fine_tune(_state0(), imgs, masks,
                             dataclasses.replace(TINY, compute_mode=mode), CFG,
                             mesh=object() if mesh else None, pool_size=POOL,
                             device="cpu")
    assert ran == [want]


def test_packed_downgrades_flat_to_fast_with_the_warning(caplog):
    imgs, masks = dryrun.pairs(S)
    flat = dataclasses.replace(TINY, compute_mode="flat")
    with caplog.at_level(logging.WARNING, logger=bo.__name__):
        got, got_losses = bo.batched_fine_tune(
            _state0(), imgs, masks, flat, CFG, pool_size=POOL,
            schedule="packed", device="cpu")
    warned = [r for r in caplog.records if "cannot be packed" in r.getMessage()]
    assert len(warned) == 1 and "compute_mode='fast'" in warned[0].getMessage()
    want, want_losses = bo.batched_fine_tune(_state0(), imgs, masks, FAST, CFG,
                                             pool_size=POOL, schedule="packed",
                                             device="cpu")
    assert torch.equal(got_losses, want_losses)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("schedule,n_dev,want_pool", [
    ("packed", 1, 10), ("packed", 2, 20), ("rounds", 1, 16)])
def test_pool_cap_counts_the_sequences_a_device(monkeypatch, caplog, schedule,
                                                n_dev, want_pool):
    """The budget holds ceil(S/D) pools a device under packed, one under
    the rounds: at 32x48 in float32 (parity) a budget of 10 entries of two
    sequences caps a pool of 16 to 10 for S = 2 on one device, and to 20
    (no cap) on two; the rounds keep 16."""
    seen = []

    def pools(images, masks, cfg, pool_size, **kw):
        seen.append(pool_size)
        raise _Ran

    monkeypatch.setattr(bo, "_host_pools", pools)
    monkeypatch.setattr(bo, "POOL_BUDGET_BYTES", 10 * 2 * 32 * 48 * 4 * 4)
    monkeypatch.setattr(bo, "mesh_size", lambda m: n_dev)
    monkeypatch.setattr(bo, "mesh_rank", lambda m: 0)
    imgs, masks = dryrun.pairs(S)
    with caplog.at_level(logging.WARNING, logger=bo.__name__), \
            pytest.raises(_Ran):
        bo.batched_fine_tune(_state0(), imgs, masks, TINY, CFG, pool_size=16,
                             schedule=schedule, device="cpu",
                             mesh=object() if n_dev > 1 else None)
    assert seen == [min(16, want_pool)]
    capped = [r.getMessage() for r in caplog.records if "capping" in r.getMessage()]
    if want_pool < 16:
        assert capped == [f"batched_fine_tune: capping pool_size 16 -> "
                          f"{want_pool} to fit the per-device pool budget "
                          f"({-(-S // n_dev)} seqs/device at 32x48)"]
    else:
        assert not capped


def test_blocks_are_contiguous_and_padded_with_the_last():
    assert bo._blocks(5, 4).tolist() == [[0, 1], [2, 3], [4, 4], [4, 4]]
    assert bo._blocks(3, 2).tolist() == [[0, 1], [2, 2]]
    assert bo._blocks(2, 1).tolist() == [[0, 1]]
