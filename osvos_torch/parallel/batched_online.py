"""Batched online adaptation: every val sequence fine-tuned in one call.

Counterpart of ``osvos_tpu/parallel/batched_online.py``. The reference
adapts the DAVIS-2016 val sequences one ``train_online.py`` run at a time.
Here one call fine-tunes S sequences over a 1-D ``'seq'`` mesh
(``parallel/mesh.py``) under one of the JAX package's two schedules:

- ``rounds``: ceil(S/D) rounds, rank r of a D-rank mesh taking sequence
  ``r0 + r`` in the round that starts at ``r0``. Each rank runs the online
  chunk (``train/online.make_chunk_fn``, the flat kernels on the card) on
  one model and optimizer, loaded afresh for each of its sequences, over
  ``cfg.scan_chunk``-step chunks. The last round is padded with the last
  sequence and the pads' results are dropped. With ``mesh=None`` the rounds
  are a serial loop over the sequences on one device.
- ``packed``: rank r takes the contiguous block of ceil(S/D) sequences
  (padded with the last sequence) and runs them as ONE model,
  ``parallel/packed.PackedOSVOS``, whose trunk folds the sequences into the
  conv groups: each layer of a step is one launch of each kernel for all
  of them (the JAX package vmaps the chunk over them). A 'flat' compute
  mode is downgraded to 'fast' with the JAX package's warning, as there.
- ``auto``, the JAX package's rule: the rounds when a mesh is given or the
  mode is 'flat', else packed.

When the steps are done the adapted states and losses are all-gathered, so
every rank returns the whole (S, ...) result.

Differences from the JAX package:

- Draws. ``jax.random`` cannot be reproduced in torch. Sequence i's step
  draws are ``make_draws(cfg, aug_mode, cfg.n_steps, pool_size,
  torch.Generator().manual_seed(cfg.seed + i))``: its pool indices and flips
  (or warps) are those of a serial ``run_online`` seeded ``cfg.seed + i``.
  ``draws`` (one ``Draws`` a sequence) replaces them, as the tests do to
  replay the JAX keys.
- Packing. No vmap: ``torch.func.vmap`` would need a batching rule for
  every autograd function around the hand-written kernels. The packed
  model is a grouped-conv model with stacked parameters instead
  (``parallel/packed.py``), and B17 and B16 have sequence-batched launches.
- Pools are kept in bf16 outside parity mode. Under the rounds they stay
  on the host and go to the device one round at a time as a pinned copy,
  made float32 there before the chunk reads them, so a serial
  ``run_online`` handed the same bf16 pool (as float32) computes the same
  steps. Under packed the rank's whole pool is staged once and stays bf16
  on the device; each step's draw is made float32.

Stacked state is a dict of (S, ...) tensors keyed as a ``state_dict``. A
mesh is a 1-D mesh of ``parallel/mesh.make_mesh``, which carries its axis
name: the JAX functions' ``axis_name`` argument is not needed here.
"""

from __future__ import annotations

import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from osvos_torch.configs import ModelConfig, OnlineConfig
from osvos_torch.evaluation.infer import make_infer_fn
from osvos_torch.models.vgg_osvos import OSVOS
from osvos_torch.parallel.mesh import all_gather_stack, mesh_rank, mesh_size
from osvos_torch.parallel.packed import (PackedOSVOS, draws_steps,
                                         make_packed_chunk_fn, stack_draws)
from osvos_torch.train.online import (DeviceLike, Draws, _augment_pool,
                                      build_host_pool, make_chunk_fn,
                                      make_draws, make_online_optimizer,
                                      resolve_device)
from osvos_torch.utils.profiling import count, span

State = Dict[str, torch.Tensor]
ArrayLike = Union[np.ndarray, torch.Tensor]
POOL_BUDGET_BYTES = 4 * 2 ** 30  # pool residency a device

log = logging.getLogger(__name__)


def _numpy(a: ArrayLike) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` padded along dim 0 to ``n`` rows with replicas of its last."""
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])


def _rounds(s: int, d: int) -> torch.Tensor:
    """(ceil(S/D), D) sequence indices: row n is round n, column r rank r's
    sequence in it; the last round padded with the last sequence."""
    return _pad_to(torch.arange(s), -(-s // d) * d).view(-1, d)


def _blocks(s: int, d: int) -> torch.Tensor:
    """(D, ceil(S/D)) sequence indices of the packed schedule: row r is rank
    r's contiguous block, the last padded with the last sequence."""
    return _pad_to(torch.arange(s), -(-s // d) * d).view(d, -1)


def _gather_states(done: Sequence[Tuple[State, torch.Tensor]], mesh
                   ) -> Tuple[List[State], List[torch.Tensor]]:
    """Every rank's (state, losses) of each of its runs, all-gathered in run
    order: ``done[n]`` of rank r is its n-th run's, a (k, ...) state and
    (k, steps) losses over k sequences. Returns each sequence's state and
    losses in the order run 0 of rank 0, of rank 1, ..., run 1 of rank 0,
    ..., pads included."""
    names = list(done[0][0])
    sizes = [done[0][0][k].numel() for k in names]
    states, losses = [], []
    for state, loss in done:
        flat = torch.cat([state[name].reshape(-1) for name in names]
                         + [loss.reshape(-1)])
        for row in all_gather_stack(flat, mesh):
            parts = row.split(sizes + [loss.numel()])
            for j in range(loss.shape[0]):
                states.append({name: p.view_as(state[name])[j]
                               for name, p in zip(names, parts)})
                losses.append(parts[-1].view_as(loss)[j])
    return states, losses


def _host_pools(images: ArrayLike, masks: ArrayLike, cfg: OnlineConfig,
                pool_size: int, n_threads: int = 8,
                indices: Optional[Sequence[int]] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sequence host augmentation pools, built concurrently: sequence i
    by ``build_host_pool(..., seed=cfg.seed + i)``. Returns (S, P, H, W, 3),
    (S, P, H, W, 1) float32 over ``indices`` (default: every sequence)."""
    imgs_np, masks_np = _numpy(images), _numpy(masks)
    idx = range(imgs_np.shape[0]) if indices is None else list(indices)

    def one(i):
        return build_host_pool(imgs_np[i], masks_np[i], cfg, pool_size,
                               seed=cfg.seed + i)

    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        pools = list(ex.map(one, idx))
    return (np.stack([p[0] for p in pools]),
            np.stack([p[1] for p in pools]))


def unstack_params(stacked: Mapping[str, torch.Tensor], index: int) -> State:
    """Sequence ``index``'s ``state_dict`` from the stacked state."""
    return {k: v[index] for k, v in stacked.items()}


def stack_param_list(params_list: Sequence[Mapping[str, torch.Tensor]]
                     ) -> State:
    return {k: torch.stack([p[k] for p in params_list])
            for k in params_list[0]}


class _Staged:
    """A round's pool on its way to the device: on a card, a pinned host
    copy moved by a side stream and an event; ``wait()`` makes the current
    stream wait for it and returns the float32 pool."""

    def __init__(self, pool_imgs: torch.Tensor, pool_masks: torch.Tensor,
                 device: torch.device):
        self.event = None
        if device.type != "cuda":
            self.tensors = (pool_imgs.to(device), pool_masks.to(device))
            return
        pinned = [t.pin_memory() for t in (pool_imgs, pool_masks)]
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            self.tensors = tuple(t.to(device, non_blocking=True)
                                 for t in pinned)
        self.event = torch.cuda.Event()
        self.event.record(stream)
        self._pinned = pinned  # alive until the copy has been waited for

    def wait(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.event is not None:
            current = torch.cuda.current_stream(self.tensors[0].device)
            current.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(current)
            self._pinned = None
        return tuple(t.float() for t in self.tensors)


RoundFn = Callable[[Mapping[str, torch.Tensor], torch.Tensor, torch.Tensor,
                    Draws], Tuple[State, torch.Tensor]]


def make_rounds_fn(chunk, model_config: ModelConfig, cfg: OnlineConfig,
                   device: DeviceLike = None
                   ) -> Tuple[RoundFn, Callable[..., _Staged]]:
    """The per-rank executor of the 'rounds' schedule: ``(fn, put)``.

    ``fn(state, pool_imgs, pool_masks, draws) -> (adapted state, losses)``
    runs this rank's sequence of a round: one model and optimizer, kept
    across rounds, loaded from ``state`` with fresh momentum, then
    ``chunk`` over the ``cfg.scan_chunk``-step pieces of ``draws``. The
    adapted state is a copy on the device; losses are (len(draws),).
    ``put(pool_imgs, pool_masks)`` stages a round's host pool for the
    device (``_Staged``). Each rank runs its own sequence, so, unlike the
    JAX package's, the executor takes no mesh and holds no collective.
    """
    device = resolve_device(device)
    model = OSVOS(model_config).to(device)
    optimizer = make_online_optimizer(model, cfg)
    chunk_len = max(1, cfg.scan_chunk)

    def fn(state, pool_imgs, pool_masks, draws):
        model.load_state_dict(state)
        optimizer.state.clear()  # a fresh momentum buffer a sequence
        draws = draws.to(device)
        losses = [chunk(model, optimizer, pool_imgs, pool_masks,
                        draws.steps(start, start + chunk_len))
                  for start in range(0, len(draws), chunk_len)]
        return ({k: v.detach().clone() for k, v in model.state_dict().items()},
                torch.cat(losses))

    def put(pool_imgs: torch.Tensor, pool_masks: torch.Tensor) -> _Staged:
        return _Staged(pool_imgs, pool_masks, device)

    return fn, put


def _fine_tune_rounds(params_at: Callable[[int], Mapping[str, torch.Tensor]],
                      pool_at: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                      draws_at: Callable[[int], Draws], chunk,
                      model_config: ModelConfig, cfg: OnlineConfig, mesh,
                      s: int, device: torch.device
                      ) -> Tuple[State, torch.Tensor]:
    """ceil(S/D) rounds of one sequence a rank.

    ``params_at(i)``, ``pool_at(i)`` and ``draws_at(i)`` give sequence i's
    starting state, host pool and draws. The next round's pool is staged
    while the current round's steps run. The last round is padded with the
    last sequence; every rank then gathers each round's states and losses
    from the mesh and drops the pads. Returns the stacked (S, ...) state
    and the (S, n_steps) losses on ``device``.
    """
    d, r = mesh_size(mesh), mesh_rank(mesh)
    fn, put = make_rounds_fn(chunk, model_config, cfg, device)
    mine = _rounds(s, d)[:, r].tolist()
    staged = put(*pool_at(mine[0]))
    done: List[Tuple[State, torch.Tensor]] = []
    for n, seq in enumerate(mine):
        pool_imgs, pool_masks = staged.wait()
        done.append(fn(params_at(seq), pool_imgs, pool_masks, draws_at(seq)))
        if n + 1 < len(mine):  # rides under this round's steps
            staged = put(*pool_at(mine[n + 1]))
        del pool_imgs, pool_masks

    if mesh is None:
        states, losses = [st for st, _ in done], [lo for _, lo in done]
    else:
        states, losses = _gather_states(
            [({k: v[None] for k, v in st.items()}, lo[None]) for st, lo in done],
            mesh)
        # the last round's pads dropped
        states, losses = states[:s], losses[:s]
    return stack_param_list(states), torch.stack(losses)


def _fine_tune_packed(params_at: Callable[[int], Mapping[str, torch.Tensor]],
                      pools: Tuple[torch.Tensor, torch.Tensor],
                      draws: Sequence[Draws], chunk, model_config: ModelConfig,
                      cfg: OnlineConfig, mesh, s: int, mine: Sequence[int],
                      device: torch.device) -> Tuple[State, torch.Tensor]:
    """This rank's block ``mine`` of sequences as one ``PackedOSVOS``.

    ``pools``: the block's (len(mine), P, H, W, C) host pools, staged on the
    device once; ``draws``: the block's. The steps run in
    ``cfg.scan_chunk``-step chunks. Every rank then gathers the blocks'
    states and losses and drops the pads. Returns the stacked (S, ...)
    state and the (S, n_steps) losses on ``device``."""
    model = PackedOSVOS(model_config, len(mine)).to(device)
    model.from_stacked(stack_param_list([params_at(i) for i in mine]))
    optimizer = make_online_optimizer(model, cfg)
    pool_imgs, pool_masks = (t.to(device) for t in pools)
    stacked = stack_draws(draws).to(device)
    chunk_len = max(1, cfg.scan_chunk)
    losses = torch.cat([chunk(model, optimizer, pool_imgs, pool_masks,
                              draws_steps(stacked, start, start + chunk_len))
                        for start in range(0, cfg.n_steps, chunk_len)], dim=1)
    state = model.to_stacked()
    if mesh is None:
        return state, losses
    states, rows = _gather_states([(state, losses)], mesh)
    states, rows = states[:s], rows[:s]  # the last block's pads dropped
    return stack_param_list(states), torch.stack(rows)


def pool_cap(s_local: int, h: int, w: int, dtype: torch.dtype) -> int:
    """The largest pool a sequence that fits POOL_BUDGET_BYTES for the
    ``s_local`` sequences a device holds at once (image and mask, 4
    channels of ``dtype`` a pixel), and at least 8."""
    per_entry = s_local * h * w * 4 * dtype.itemsize
    return int(max(8, POOL_BUDGET_BYTES // max(per_entry, 1)))


def batched_fine_tune(
    params: Mapping[str, torch.Tensor],
    images: ArrayLike,   # (S, H, W, 3) first frames, preprocessed
    masks: ArrayLike,    # (S, H, W, 1) first-frame annotations
    model_config: ModelConfig,
    cfg: OnlineConfig,
    mesh=None,
    stacked_params: bool = False,
    aug_mode: str = "pool",
    pool_size: int = 100,
    step_mode: str = "microbatch",
    host_pool: bool = True,
    schedule: str = "auto",
    draws: Optional[Sequence[Draws]] = None,
    device: DeviceLike = None,
) -> Tuple[State, torch.Tensor]:
    """Fine-tune S sequences in one call.

    params: one parent ``state_dict`` for every sequence, or with
    ``stacked_params=True`` a stacked (S, ...) state. Returns (the stacked
    adapted state (S, ...), losses (S, n_steps)) on ``device`` (default:
    the card), the whole result on every rank of ``mesh``.

    schedule: ``'rounds'``, ``'packed'`` or ``'auto'`` (module docstring).
    Pools come from the host (``host_pool=True``: ``_host_pools``, sequence
    i seeded ``cfg.seed + i``) or are warped on the device
    (``train/online._augment_pool``, sequence i from a generator seeded
    ``cfg.seed + 7 + i``). ``draws``: one ``Draws`` of ``cfg.n_steps`` rows
    a sequence (module docstring).
    """
    s = int(images.shape[0])
    if schedule == "auto":
        schedule = ("rounds"
                    if mesh is not None or model_config.compute_mode == "flat"
                    else "packed")
    if schedule not in ("rounds", "packed"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if draws is not None and len(draws) != s:
        raise ValueError(f"draws: {len(draws)} for {s} sequences")
    device = resolve_device(device)
    d, r = mesh_size(mesh), mesh_rank(mesh)
    if schedule == "rounds":
        block = _rounds(s, d)[:, r].tolist()
    else:
        block = _blocks(s, d)[r].tolist()
    mine = sorted(set(block))

    # Pool residency: one round's pool a device under 'rounds', the rank's
    # whole block under 'packed'; bf16 outside parity mode (the trunk
    # computes in bf16), capped to a fixed budget a device.
    pool_dtype = (torch.float32 if model_config.compute_mode == "parity"
                  else torch.bfloat16)
    if aug_mode == "pool":
        s_local = 1 if schedule == "rounds" else -(-s // d)
        h, w = int(images.shape[1]), int(images.shape[2])
        max_pool = pool_cap(s_local, h, w, pool_dtype)
        if pool_size > max_pool:
            log.warning("batched_fine_tune: capping pool_size %d -> %d to fit "
                        "the per-device pool budget (%d seqs/device at %dx%d)",
                        pool_size, max_pool, s_local, h, w)
            pool_size = max_pool

    host: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    if aug_mode != "pool":  # per_step: the pair itself
        imgs_np, masks_np = _numpy(images), _numpy(masks)
        for i in mine:
            host[i] = (torch.from_numpy(np.asarray(imgs_np[i:i + 1], np.float32)),
                       torch.from_numpy(np.asarray(masks_np[i:i + 1], np.float32)))
        pool_size = 1
    elif host_pool:
        built = _host_pools(images, masks, cfg, pool_size, indices=mine)
        for j, i in enumerate(mine):
            host[i] = tuple(torch.from_numpy(np.ascontiguousarray(b[j]))
                            .to(pool_dtype) for b in built)
    else:  # warped on the device, kept on the host between rounds
        imgs_np, masks_np = _numpy(images), _numpy(masks)
        for i in mine:
            pool = _augment_pool(
                torch.from_numpy(np.asarray(imgs_np[i], np.float32)).to(device),
                torch.from_numpy(np.asarray(masks_np[i], np.float32)).to(device),
                cfg, pool_size, torch.Generator().manual_seed(cfg.seed + 7 + i))
            host[i] = tuple(t.to(pool_dtype).cpu() for t in pool)

    def params_at(i):
        return unstack_params(params, i) if stacked_params else params

    def draws_at(i):
        if draws is not None:
            return draws[i]
        return make_draws(cfg, aug_mode, cfg.n_steps, pool_size,
                          torch.Generator().manual_seed(cfg.seed + i))

    if schedule == "rounds":
        chunk = make_chunk_fn(model_config, cfg, aug_mode=aug_mode,
                              step_mode=step_mode)
        return _fine_tune_rounds(params_at, host.__getitem__, draws_at, chunk,
                                 model_config, cfg, mesh, s, device)

    if model_config.compute_mode == "flat":
        # the JAX package's downgrade: its flat kernels do not vmap; here
        # the packed model is the grouped-conv model of the fast trunk
        log.warning(
            "batched_fine_tune(schedule='packed'): the flat-trunk kernels "
            "cannot be packed; running this adaptation with "
            "compute_mode='fast'. Use schedule='rounds' to keep the flat "
            "kernels.")
        model_config = dataclasses.replace(model_config, compute_mode="fast")
    chunk = make_packed_chunk_fn(model_config, cfg, aug_mode=aug_mode,
                                 step_mode=step_mode)
    pools = tuple(torch.stack([host[i][j] for i in block]) for j in range(2))
    return _fine_tune_packed(params_at, pools, [draws_at(i) for i in block],
                             chunk, model_config, cfg, mesh, s, block, device)


def batched_infer(
    stacked_params: Mapping[str, torch.Tensor],
    frames,  # (S, T, H, W, 3) stack OR ragged list of per-seq frame lists
    model_config: ModelConfig,
    mesh=None,
    act_scales: Optional[ArrayLike] = None,  # (S, n_trunk_convs) float32
    hbm_budget_bytes: int = 4 * 2 ** 30,
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-sequence-adapted inference, chunked under a device-memory budget.

    Returns (S, T, H, W) uint8 probability maps (T = the most frames) on
    the host, on every rank. ``frames`` is a padded (S, T, H, W, 3) stack or
    a ragged list of per-sequence frame lists; a shorter sequence is padded
    with its last frame, whose maps fill its tail. Each rank takes its
    contiguous ceil(S/D) sequences (the last one repeated past S) and runs
    them, one model loaded a sequence, through ``make_infer_fn`` (on the
    card the fused-head tail, B1, and in int8 mode I1) in chunks of frames
    sized so that a chunk's residency, ``h*w*(3*4 + 320)`` bytes a frame
    times the rank's sequences, stays within ``hbm_budget_bytes``; every
    chunk is padded to the same length. Then the maps are all-gathered.

    act_scales: row i is sequence i's ``act_scales`` operand of
    ``OSVOS.forward`` (``models/quantize.calibrate_int8_scales_batched``):
    each sequence its own static scales, with no rebuild of the model.
    """
    device = resolve_device(device)
    ragged = isinstance(frames, (list, tuple))
    if ragged:
        t_counts = [len(f) for f in frames]
        s, t_max = len(frames), max(t_counts)
        h, w = np.asarray(frames[0][0]).shape[:2]
    else:
        frames = _numpy(frames)
        s, t_max, h, w = frames.shape[:4]
        t_counts = [t_max] * s

    n_dev = mesh_size(mesh)
    s_local = -(-s // n_dev)
    bytes_per_frame = h * w * (3 * 4 + 320)
    chunk_t = max(1, min(t_max, int(hbm_budget_bytes
                                    // max(s_local * bytes_per_frame, 1))))
    if chunk_t < t_max:
        log.warning("batched_infer: chunking %d frames into calls of %d to "
                    "fit the %.1f GiB/device budget (%d seqs/device at "
                    "%dx%d)", t_max, chunk_t, hbm_budget_bytes / 2 ** 30,
                    s_local, h, w)

    # infer.call's self time: the host's time between the phases below
    with span("infer.call"):
        mine = _pad_to(torch.arange(s), s_local * n_dev).view(n_dev, s_local)[
            mesh_rank(mesh)].tolist()
        with span("infer.load"):
            model = OSVOS(model_config).to(device).eval()
            infer = make_infer_fn(model_config)
        out = torch.empty((s_local, t_max, h, w), dtype=torch.uint8, device=device)
        buf = np.empty((chunk_t, h, w, 3), np.float32)
        for j, si in enumerate(mine):
            with span("infer.load"):
                model.load_state_dict(unstack_params(stacked_params, si))
                scales = None if act_scales is None else torch.as_tensor(
                    _numpy(act_scales)[si], dtype=torch.float32).to(device)
            t_end = t_counts[si]
            for t0 in range(0, t_max, chunk_t):
                tc = min(chunk_t, t_max - t0)
                n_live = min(tc, max(t_end - t0, 0))
                with span("infer.fill"):
                    for tj in range(n_live):
                        buf[tj] = frames[si][t0 + tj]
                    if n_live < chunk_t:  # the pad: the sequence's last frame
                        buf[n_live:] = np.asarray(frames[si][t_end - 1], np.float32)
                with span("infer.h2d"):
                    x = torch.from_numpy(buf).to(device)
                with span("infer.forward"):
                    maps = infer(model, x, act_scales=scales)
                    out[j, t0:t0 + tc] = maps[:tc]
                count("infer.frames_real", n_live)
                count("infer.frames_run", chunk_t)
        with span("infer.gather"):
            if mesh is not None:
                out = all_gather_stack(out, mesh).flatten(0, 1)
            return out[:s].cpu().numpy()
