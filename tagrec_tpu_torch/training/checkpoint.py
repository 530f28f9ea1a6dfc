"""Params checkpoints in the JAX package's format, both ways
(tagrec_tpu/training/checkpoint.py).

A JAX params tree is a nest of dicts and lists of arrays: DGCF's is
``{"embed": [user, item, tag]}``, KGAT's ``{"user", "entity", "relation",
"transE", "mat": {"W1_0", ...}}``.  Its leaf at path (k1, k2, ...) fills the
model parameter named ``"k1.k2..."`` (``embed.0``, ``mat.W1_0``).

A JAX checkpoint is ``<path>.npz`` with one array per leaf (``leaf_0``,
``leaf_1``, ...) in JAX's flatten order, dict keys sorted at every level and
lists in order, plus a ``<path>.tree`` JSON sidecar holding ``n_leaves`` and
JAX's treedef string.  ``load`` does not parse the treedef string: it
checks the leaf count and every shape instead.  ``save`` writes the string
JAX writes for the same tree, so JAX's ``load`` reads the port's files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    """(dotted path, leaf) pairs of a params tree, in JAX's flatten order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def jax_leaf_order(model: nn.Module) -> List[str]:
    """The model's parameter names in the order JAX flattens its tree: dict
    keys sorted as strings, list indices as numbers."""
    def key(name):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                     for p in name.split("."))
    return sorted((n for n, _ in model.named_parameters()), key=key)


def params_from_jax(model: nn.Module, tree: Dict) -> nn.Module:
    """Copy a JAX params tree (numpy arrays) into ``model``'s parameters of
    the same paths, checking that the two hold the same leaves and shapes;
    returns ``model``."""
    leaves = dict(_leaves(tree))
    params = dict(model.named_parameters())
    if leaves.keys() != params.keys():
        raise ValueError(
            f"params tree leaves {sorted(leaves)} do not match the model's "
            f"parameters {sorted(params)}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(leaves[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name} shape {arr.shape} != model's "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(arr))
    return model


def _tree_of(named: Dict[str, object]) -> Dict:
    """The nest of dicts (and lists, where every key is an index) that
    dotted names describe."""
    tree: Dict = {}
    for name, leaf in named.items():
        node = tree
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def _treedef(tree) -> str:
    """JAX's treedef string of a nest of dicts and lists of leaves."""
    def body(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {body(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(body(v) for v in node) + "]"
        return "*"
    return f"PyTreeDef({body(tree)})"


def save(path: str, model: nn.Module) -> None:
    """Write ``model``'s parameters as the JAX package's ``checkpoint.save``
    writes a params tree: ``<path>`` (.npz) with ``leaf_i`` in JAX's flatten
    order and a ``<path>.tree`` sidecar, so both packages' ``load`` read
    it."""
    names = jax_leaf_order(model)
    params = dict(model.named_parameters())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{f"leaf_{i}": params[n].detach().cpu().numpy()
                      for i, n in enumerate(names)})
    with open(path + ".tree", "w") as f:
        json.dump({"treedef": _treedef(_tree_of(dict.fromkeys(names))),
                   "n_leaves": len(names)}, f)


def load(path: str, model: nn.Module) -> nn.Module:
    """Load a params checkpoint written by the JAX package's
    ``checkpoint.save`` into ``model``; returns ``model``."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    data = np.load(npz_path)
    names = jax_leaf_order(model)
    # save() writes the sidecar at the pre-savez path + ".tree"
    sidecar = next((p for p in (path + ".tree", npz_path + ".tree")
                    if os.path.exists(p)), None)
    if sidecar is not None:
        with open(sidecar) as f:
            n_saved = json.load(f).get("n_leaves")
        if n_saved != len(names):
            raise ValueError(f"checkpoint {path} holds {n_saved} leaves, "
                             f"expected {len(names)}")
    if len(data.files) != len(names):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                         f"expected {len(names)}")
    return params_from_jax(model, _tree_of(
        {name: data[f"leaf_{i}"] for i, name in enumerate(names)}))
