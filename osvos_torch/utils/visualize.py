"""Network summary and graph drawing behind ``--vis_net``.

Counterpart of ``osvos_tpu/utils/visualize.py`` (the reference's
``util/visualize.py`` ``make_dot``, which the training scripts' ``vis_net``
flag calls):

- ``model_summary``: a text table of a module's parameters (name, shape,
  dtype, elements) with the total, and each output's shape when example
  inputs are given;
- ``make_dot``: a DOT string of the autograd graph that one call of ``fn``
  builds, written as text (no graphviz package). A node per ``grad_fn``,
  labelled with its class name (on the kernel paths the port's own autograd
  Functions: ``_Conv3x3SameBackward``, ``_MaxPoolCeilBackward``,
  ``_FlatConv3x3Backward``, ...), one per parameter leaf (its name and
  shape), one per example tensor and one per output; edges follow
  ``next_functions``, drawn in the direction the data flows. The JAX
  package draws one node per jaxpr equation instead;
- ``save_dot``: write the DOT, and render it only if the ``dot`` binary is
  on PATH.
"""

from __future__ import annotations

import collections
import shutil
import subprocess
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

def _short(t: torch.Tensor) -> str:
    """A tensor's dtype and shape, ``torch.float32 (1, 64, 112, 3)``."""
    return f"{t.dtype} {tuple(t.shape)}"


def _outputs(out) -> List[torch.Tensor]:
    return [out] if isinstance(out, torch.Tensor) else list(out)


def model_summary(model: nn.Module, *example_args) -> str:
    """One row per parameter (name, shape, dtype, elements) and the total;
    with example inputs, also each output's shape after one forward under
    ``torch.no_grad()`` on the model's device."""
    rows = [("name", "shape", "dtype", "elements")]
    params = list(model.named_parameters())
    for name, p in params:
        rows.append((name, str(tuple(p.shape)), str(p.dtype), str(p.numel())))
    if example_args:
        device = params[0][1].device
        args = [a.to(device) if isinstance(a, torch.Tensor) else a
                for a in example_args]
        with torch.no_grad():
            outs = _outputs(model(*args))
        rows += [(f"output {i}", str(tuple(o.shape)), str(o.dtype), "")
                 for i, o in enumerate(outs)]
    widths = [max(len(r[c]) for r in rows) for c in range(3)]
    lines = ["  ".join([r[0].ljust(widths[0]), r[1].ljust(widths[1]),
                        r[2].ljust(widths[2]), r[3]]).rstrip() for r in rows]
    total = sum(p.numel() for _, p in params)
    lines.append(f"total: {total} parameters in {len(params)} tensors")
    return "\n".join(lines)


def make_dot(fn: Callable, *example_args, max_nodes: int = 2000) -> str:
    """DOT graph of the autograd graph of ``fn(*example_args)``.

    ``fn`` runs once with grad enabled. Parameter leaves take their names
    from ``fn.named_parameters()`` where ``fn`` is a module, and are
    labelled ``param`` otherwise. An
    example tensor that requires grad is its own leaf's node; one that
    does not stands alone. At most ``max_nodes`` graph nodes are drawn
    (outputs and inputs aside), and only edges between drawn nodes.
    """
    names: Dict[int, str] = ({id(t): n for n, t in fn.named_parameters()}
                             if isinstance(fn, nn.Module) else {})
    with torch.enable_grad():
        outs = _outputs(fn(*example_args))

    lines = ["digraph autograd {", '  rankdir="TB";',
             '  node [shape=box, fontsize=9, style=filled,'
             ' fillcolor="#e8f0fe"];']
    leaves: Dict[int, str] = {}  # id of a leaf tensor -> its node
    for i, arg in enumerate(example_args):
        if isinstance(arg, torch.Tensor):
            lines.append(f'  in{i} [label="input {i}\\n{_short(arg)}",'
                         ' fillcolor="#d2f8d2"];')
            if arg.requires_grad:
                leaves[id(arg)] = f"in{i}"

    node_of: Dict[object, str] = {}  # grad_fn -> its node
    queue = collections.deque(o.grad_fn for o in outs if o.grad_fn is not None)
    drawn = 0
    while queue:
        fn_node = queue.popleft()
        if fn_node in node_of or drawn >= max_nodes:
            continue
        var = getattr(fn_node, "variable", None)  # AccumulateGrad's leaf
        if var is not None and id(var) in leaves:
            node_of[fn_node] = leaves[id(var)]
        else:
            name = f"n{drawn}"
            node_of[fn_node] = name
            drawn += 1
            if var is None:
                lines.append(f'  {name} [label="{type(fn_node).__name__}"];')
            else:
                label = names.get(id(var), "param")
                lines.append(f'  {name} [label="{label}\\n'
                             f'{tuple(var.shape)}", fillcolor="#fff2cc"];')
                leaves[id(var)] = name
        queue.extend(nxt for nxt, _ in fn_node.next_functions
                     if nxt is not None)
    for fn_node, name in node_of.items():
        for nxt, _ in fn_node.next_functions:
            if nxt in node_of:
                lines.append(f"  {node_of[nxt]} -> {name};")
    for i, out in enumerate(outs):
        lines.append(f'  out{i} [label="output {i}\\n{_short(out)}",'
                     ' fillcolor="#ffd9d9"];')
        if out.grad_fn in node_of:
            lines.append(f"  {node_of[out.grad_fn]} -> out{i};")
    lines.append("}")
    return "\n".join(lines)


def save_dot(dot: str, path: str, render: Optional[str] = "pdf") -> str:
    """Write ``path``(.dot) and render via the ``dot`` binary if present."""
    dot_path = path if path.endswith(".dot") else path + ".dot"
    with open(dot_path, "w") as f:
        f.write(dot)
    if render and shutil.which("dot"):
        subprocess.run(["dot", f"-T{render}", dot_path, "-o",
                        dot_path[:-4] + f".{render}"], check=False)
    return dot_path
