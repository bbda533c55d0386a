"""Read model parameters saved by the JAX package or by the reference.

Counterpart of ``osvos_tpu/utils/checkpoint.py:load_checkpoint``, for the
parameters only (optimizer state comes with the fine-tune port):

- ``.ckpt``: the JAX package's msgpack checkpoint, e.g. the
  ``<seq>_online.ckpt`` that ``scripts/train_online.py`` writes. It is
  decoded here without flax: flax stores an ndarray as msgpack extension
  type 1 holding a packed ``(shape, dtype name, raw bytes)`` tuple, a numpy
  scalar as type 3 with the same payload, and splits large arrays into
  ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` dicts
  whose tuples are dicts keyed "0", "1", ...
- ``.pth`` / ``.pt`` / ``.npz``: a reference OSVOS ``state_dict``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from osvos_torch.configs import ModelConfig
from osvos_torch.models.surgery import (State, load_torch_state_dict,
                                        params_from_jax)

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


def load_checkpoint(path: str, config: ModelConfig = ModelConfig()) -> State:
    """The port's model state from a ``.ckpt``, ``.pth``/``.pt`` or ``.npz``
    file; ``config`` gives the stage layout of a reference state_dict."""
    if path.endswith((".pth", ".pt")):
        state = torch.load(path, map_location="cpu", weights_only=True)
        return load_torch_state_dict(state, config)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return load_torch_state_dict({k: z[k] for k in z.files}, config)
    return params_from_jax(read_msgpack_tree(path)["params"])
