"""Checkpoints: the port's training snapshots, and model parameters saved
by the JAX package or by the reference.

Counterpart of ``osvos_tpu/utils/checkpoint.py``. ``save_checkpoint`` writes
a training snapshot with ``torch.save``: ``{'params': state_dict,
'opt_state': train/optim.MultiSteps state (mini_step, acc_grads,
momentum), 'step': epoch}``, on the CPU. ``load_training_state`` reads one
back, or the same three from a JAX package ``.ckpt``. ``load_checkpoint``
returns the parameters of any of these files:

- ``.ckpt``: the JAX package's msgpack checkpoint, e.g. the
  ``<seq>_online.ckpt`` that ``scripts/train_online.py`` writes. It is
  decoded here without flax: flax stores an ndarray as msgpack extension
  type 1 holding a packed ``(shape, dtype name, raw bytes)`` tuple, a numpy
  scalar as type 3 with the same payload, and splits large arrays into
  ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` dicts
  whose tuples are dicts keyed "0", "1", ...
- ``.pth`` / ``.pt`` / ``.npz``: a reference OSVOS ``state_dict``, or a
  snapshot of ``save_checkpoint``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from osvos_torch.configs import ModelConfig
from osvos_torch.models.surgery import (State, load_torch_state_dict,
                                        opt_state_from_jax, params_from_jax)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _tuple_from_dict(d: Any) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = _tuple_from_dict(tree["shape"])
        flat = np.concatenate(_tuple_from_dict(tree["chunks"]))
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack_tree(path: str) -> Any:
    """The nested dicts of numpy arrays in a flax msgpack file."""
    import msgpack

    def ext_hook(code: int, data: bytes) -> Any:
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()))
            arr = arr.reshape(shape)
            return arr if code == _EXT_NDARRAY else arr[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def _cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu").clone()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _is_snapshot(obj: Any) -> bool:
    return isinstance(obj, dict) and "params" in obj and "opt_state" in obj


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor],
                    opt_state: Optional[Mapping[str, Any]] = None,
                    step: int = 0) -> str:
    """Write a training snapshot (atomic rename); returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": _cpu(dict(params)),
               "opt_state": _cpu(dict(opt_state)) if opt_state else {},
               "step": int(step)}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_training_state(path: str
                        ) -> Tuple[State, Optional[Dict[str, Any]], int]:
    """(params, optimizer state or None, step) of a ``save_checkpoint``
    snapshot, or of a JAX package ``.ckpt`` written by its parent trainer
    (its optimizer state carried by ``models.surgery.opt_state_from_jax``)."""
    if path.endswith(".ckpt"):
        tree = read_msgpack_tree(path)
        opt = tree.get("opt_state") or None
        return (params_from_jax(tree["params"]),
                opt_state_from_jax(opt) if opt else None,
                int(np.asarray(tree.get("step", 0))))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not _is_snapshot(payload):
        raise ValueError(f"{path} is not a training snapshot")
    return payload["params"], payload["opt_state"] or None, int(payload["step"])


def load_checkpoint(path: str, config: ModelConfig = ModelConfig()) -> State:
    """The port's model state from a ``.ckpt``, ``.pth``/``.pt`` or ``.npz``
    file; ``config`` gives the stage layout of a reference state_dict."""
    if path.endswith((".pth", ".pt")):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if _is_snapshot(state):
            return state["params"]
        return load_torch_state_dict(state, config)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return load_torch_state_dict({k: z[k] for k in z.files}, config)
    return params_from_jax(read_msgpack_tree(path)["params"])
