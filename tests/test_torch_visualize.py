"""``osvos_torch/utils/visualize.py`` and ``--vis_net`` against the JAX
package's ``utils/visualize.py``, on the CPU at the tiny widths.

- ``make_dot`` in fast and parity mode, 32x48, on seeded weights carried
  across by ``params_to_jax`` (and back by ``params_from_jax``): the port's
  parameter leaves, each shape put in the JAX layout (OIHW -> HWIO), are as
  a multiset the JAX DOT's inputs other than the image (in fast mode the
  DOT of the jitted forward: the JAX make_dot cannot hash a Literal operand
  of the fast jaxpr); both have 5 outputs; every edge joins declared nodes
  and the graph is acyclic. The port's DOT names the mode's kernel
  Functions;
- in flat mode (the kernels' plain versions on the CPU) the DOT names all
  44 parameter leaves with their shapes and the five flat Functions;
- the node cap keeps every edge between declared nodes;
- ``model_summary`` names ``stage1_conv0`` and ``fuse``, and its total is
  the size of the tree the JAX init builds;
- ``save_dot(..., render=None)`` writes the ``.dot`` file alone;
- ``cli.train_parent --vis_net`` writes ``net.dot`` and prints its line,
  and trains bit for bit as the same run without the flag.
"""

import collections
import dataclasses
import functools
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from osvos_tpu.configs import ModelConfig as JaxModelConfig
from osvos_tpu.models import OSVOS as JaxOSVOS
from osvos_tpu.utils import visualize as jax_vis
from osvos_torch.cli import train_parent as cli
from osvos_torch.configs import ModelConfig
from osvos_torch.models import (OSVOS, init_osvos_params, params_from_jax,
                                params_to_jax)
from osvos_torch.utils.checkpoint import load_training_state
from osvos_torch.utils.visualize import make_dot, model_summary, save_dot

TINY = ModelConfig(stages=((4, 4), (6, 6), (8, 8, 8), (8, 8, 8), (8, 8, 8)),
                   side_channels=4)
H, W = 32, 48
N_LEAVES = 44  # 13 trunk convs, 4 side_prep, 4 score_dsn, fuse: weight, bias
FLAT_FUNCTIONS = ("_FlatConv3x3InputBackward", "_FlatConv3x3Backward",
                  "_ConvPoolBackward", "_SideAndPoolBackward",
                  "_SideConvBackward")
KERNEL_FUNCTIONS = {"fast": ("_Conv3x3SameBackward", "_MaxPoolCeilBackward"),
                    "parity": ("_MaxPoolCeilBackward",),
                    "flat": FLAT_FUNCTIONS}
NODE = re.compile(r'^  (\w+) \[label="([^"]*)"', re.M)
EDGE = re.compile(r"^  (\w+) -> (\w+);$", re.M)
LEAF = re.compile(r"^([\w.]+)\\n\(([\d, ]*)\)$")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph(dot):
    """({node: label}, [(src, dst)]), after checking that every edge joins
    declared nodes and that the graph has no cycle."""
    assert dot.startswith("digraph") and dot.endswith("}")
    nodes = dict(NODE.findall(dot))
    edges = EDGE.findall(dot)
    assert edges and all(a in nodes and b in nodes for a, b in edges)
    indeg = collections.Counter(b for _, b in edges)
    succ = collections.defaultdict(list)
    for a, b in edges:
        succ[a].append(b)
    ready = [n for n in nodes if not indeg[n]]
    seen = 0
    while ready:
        n = ready.pop()
        seen += 1
        for m in succ[n]:
            indeg[m] -= 1
            if not indeg[m]:
                ready.append(m)
    assert seen == len(nodes), "the graph has a cycle"
    return nodes, edges


def _outputs(nodes):
    return sorted(label for label in nodes.values()
                  if label.startswith("output "))


def _leaves(nodes):
    """{parameter name: shape} of the port DOT's parameter leaves."""
    found = [LEAF.match(label) for label in nodes.values()]
    return {m[1]: tuple(int(s) for s in m[2].split(",") if s.strip())
            for m in found if m}


def _jax_layout(name, shape):
    return (shape[2], shape[3], shape[1], shape[0]) \
        if name.endswith(".weight") else shape


@functools.lru_cache(maxsize=None)
def _jax_shapes():
    """{layer: {leaf: shape}} of the tree ``osvos_tpu.models.
    init_osvos_params`` builds at TINY, ``OSVOS.init(key, image)["params"]``,
    by ``jax.eval_shape`` (its eager init takes half a minute here)."""
    tree = jax.eval_shape(JaxOSVOS(JaxModelConfig(**dataclasses.asdict(TINY))).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))["params"]
    return {m: {k: tuple(v.shape) for k, v in leaf.items()}
            for m, leaf in tree.items()}


def _models(mode):
    """A port model with seeded weights and the JAX tree of the same
    values, carried across by ``params_to_jax`` and back by
    ``params_from_jax``."""
    cfg = dataclasses.replace(TINY, compute_mode=mode)
    model = OSVOS(cfg)
    model.load_state_dict(init_osvos_params(cfg, torch.Generator().manual_seed(0)))
    tree = params_to_jax(model)
    assert {m: {k: v.shape for k, v in leaf.items()}
            for m, leaf in tree.items()} == _jax_shapes()
    back = OSVOS(cfg)
    back.load_state_dict(params_from_jax(tree))
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in back.state_dict().items())
    return cfg, model, tree


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_make_dot_matches_the_jax_graph(mode):
    cfg, model, tree = _models(mode)
    jmodel = JaxOSVOS(JaxModelConfig(**dataclasses.asdict(cfg)))
    fn = lambda p, v: jmodel.apply({"params": p}, v)  # noqa: E731
    if mode == "fast":
        # the fast model's jaxpr has a Literal operand, which the JAX
        # make_dot's producer lookup cannot hash under this JAX; the jitted
        # function's jaxpr is one pjit equation over the same in- and outvars
        fn = jax.jit(fn)
    jdot = jax_vis.make_dot(fn, jax.tree.map(jnp.asarray, tree),
                            jnp.zeros((1, H, W, 3), jnp.float32))
    x = torch.from_numpy(np.random.RandomState(0).randn(1, H, W, 3)
                         .astype(np.float32))
    dot = make_dot(model, x)

    jnodes, _ = _graph(jdot)
    nodes, edges = _graph(dot)
    inputs = [re.fullmatch(r"input \d+\\n(\w+)\[([\d,]*)\]", label)
              for label in jnodes.values() if label.startswith("input ")]
    jshapes = [tuple(int(s) for s in m[2].split(",") if s) for m in inputs]
    assert jshapes[-1] == (1, H, W, 3)  # the image, the last invar
    leaves = _leaves(nodes)
    assert len(leaves) == N_LEAVES
    assert sorted(_jax_layout(n, s) for n, s in leaves.items()) == \
        sorted(jshapes[:-1])
    assert _outputs(jnodes) == ["output 0", "output 1", "output 2",
                                "output 3", "output 4"]
    assert [o.split("\\n")[0] for o in _outputs(nodes)] == _outputs(jnodes)
    assert f'in0 [label="input 0\\ntorch.float32 (1, {H}, {W}, 3)"' in dot
    labels = set(nodes.values())
    assert set(KERNEL_FUNCTIONS[mode]) <= labels, labels
    # the example input needs no grad, so it feeds no edge
    assert not any("in0" in e for e in edges)


def test_make_dot_flat_names_every_leaf_and_the_flat_functions():
    _, model, _ = _models("flat")
    dot = make_dot(model, torch.zeros(1, H, W, 3))
    nodes, _ = _graph(dot)
    leaves = _leaves(nodes)
    assert leaves == {name: tuple(p.shape)
                      for name, p in model.named_parameters()}
    assert len(leaves) == N_LEAVES
    assert set(FLAT_FUNCTIONS) <= set(nodes.values())
    assert len(_outputs(nodes)) == 5


def test_make_dot_cap_and_a_grad_input():
    """A capped graph declares at most ``max_nodes`` graph nodes and draws
    only edges between declared nodes; an input that needs grad is a
    source of the graph."""
    _, model, _ = _models("fast")
    x = torch.zeros(1, H, W, 3, requires_grad=True)
    nodes, _ = _graph(make_dot(model, x, max_nodes=40))
    assert len([n for n in nodes if n.startswith("n")]) == 40
    _, edges = _graph(make_dot(model, x))
    assert any(a == "in0" for a, _ in edges)


def test_model_summary_totals_the_jax_tree():
    _, model, _ = _models("fast")
    text = model_summary(model, torch.zeros(1, H, W, 3))
    assert "stage1_conv0" in text and "fuse" in text
    total = int(re.search(r"^total: (\d+) parameters in (\d+) tensors",
                          text, re.M)[1])
    assert total == sum(int(np.prod(shape)) for leaf in _jax_shapes().values()
                        for shape in leaf.values())
    assert text.count("output ") == 5
    assert f"(1, {H}, {W}, 1)" in text
    assert "output" not in model_summary(model)


def test_save_dot_writes_the_dot_alone(tmp_path):
    path = save_dot("digraph g {}", str(tmp_path / "net"), render=None)
    assert path == str(tmp_path / "net.dot")
    assert [p.name for p in tmp_path.iterdir()] == ["net.dot"]
    assert (tmp_path / "net.dot").read_text() == "digraph g {}"


def _scalars(root):
    return [{k: r[k] for k in ("tag", "value", "step")} for r in map(
        json.loads, (root / "logs_parent" / "scalars.jsonl").read_text().splitlines())]


def test_cli_vis_net_draws_and_trains_as_without(tmp_path, capsys):
    args = ["--synthetic", "2", "--tiny", "--device", "cpu", "--epochs", "2",
            "--n_ave_grad", "1", "--no_test", "--input_h", "48",
            "--input_w", "64", "--lr", "1e-4"]
    runs = {}
    for flag in ([], ["--vis_net"]):
        root = tmp_path / ("vis" if flag else "plain")
        assert cli.main(args + flag + ["--save_root", str(root)]) == 0
        out = capsys.readouterr().out
        runs[bool(flag)] = (root, out)
    root, out = runs[True]
    dot_path = root / "net.dot"
    assert f"net graph -> {dot_path}\n" in out
    nodes, _ = _graph(dot_path.read_text())
    assert len(_leaves(nodes)) == N_LEAVES and len(_outputs(nodes)) == 5
    assert 'label="input 0\\ntorch.float32 (1, 64, 112, 3)"' in \
        dot_path.read_text()
    assert "_Conv3x3SameBackward" in set(nodes.values())
    plain_root, plain_out = runs[False]
    assert not (plain_root / "net.dot").exists()
    lines = lambda o, r: [re.sub(r"elapsed=\S+", "", line).replace(  # noqa: E731
        str(r), "<root>") for line in o.splitlines()
        if not line.startswith("net graph")]
    assert lines(out, root) == lines(plain_out, plain_root)
    assert _scalars(root) == _scalars(plain_root)
    want = load_training_state(str(plain_root / "models" / "parent_epoch-1.pt"))
    got = load_training_state(str(root / "models" / "parent_epoch-1.pt"))
    assert got[2] == want[2] == 1
    assert got[0].keys() == want[0].keys()
    assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
    leaves = jax.tree.leaves(want[1])
    assert leaves and all(np.array_equal(np.asarray(a), np.asarray(b))
                          for a, b in zip(jax.tree.leaves(got[1]), leaves))
