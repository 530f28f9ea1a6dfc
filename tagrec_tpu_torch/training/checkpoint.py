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

A train state (``save_train_state``/``restore_train_state``) is JAX's
``{"opt_state": ..., "params": ..., "step": ...}`` in the same format, so
either package resumes from the other's.  The Adam state maps
``torch.optim.Adam``'s per-parameter ``step``, ``exp_avg`` and
``exp_avg_sq`` to JAX's count, mu and nu: under ``adam_impl="torch"``
JAX's ``TorchAdamState(count, mu, nu)``, one int32 count a leaf, a
parameter that Adam has not stepped yet written as count 0 with zero
moments (and restored with no state); under ``"global"`` optax.adam's
``(ScaleByAdamState(count, mu, nu), EmptyState())``, one count.  Restoring
checks the sidecar's treedef string against the one expected, as JAX's
``load`` does.  A capturable Adam's count is restored onto the
parameter's device, and into the state tensors already there, in place,
so that a captured step keeps reading them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from tagrec_tpu_torch.training import optim


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


@dataclass(frozen=True)
class _Named:
    """A NamedTuple node of a JAX tree (an optimizer state), by class
    name and children."""

    name: str
    children: tuple


def _treedef(tree) -> str:
    """JAX's treedef string of a nest of dicts, lists, tuples and NamedTuple
    nodes; any other node is a leaf."""
    def body(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {body(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(body(v) for v in node) + "]"
        if isinstance(node, _Named):
            return (f"CustomNode(namedtuple[{node.name}], ["
                    + ", ".join(body(v) for v in node.children) + "])")
        if isinstance(node, tuple):
            return "(" + ", ".join(body(v) for v in node) + ")"
        return "*"
    return f"PyTreeDef({body(tree)})"


def _write(path: str, leaves: List[np.ndarray], tree) -> None:
    """``<path>`` (.npz) with ``leaf_i`` in order and the ``<path>.tree``
    sidecar, as JAX's ``checkpoint.save`` writes them."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    with open(path + ".tree", "w") as f:
        json.dump({"treedef": _treedef(tree), "n_leaves": len(leaves)}, f)


def _params_tree(names: List[str]) -> Dict:
    return _tree_of(dict.fromkeys(names))


def save(path: str, model: nn.Module) -> None:
    """Write ``model``'s parameters as the JAX package's ``checkpoint.save``
    writes a params tree: ``<path>`` (.npz) with ``leaf_i`` in JAX's flatten
    order and a ``<path>.tree`` sidecar, so both packages' ``load`` read
    it."""
    names = jax_leaf_order(model)
    params = dict(model.named_parameters())
    _write(path, [params[n].detach().cpu().numpy() for n in names],
           _params_tree(names))


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


# ------------------------------------------------------------ train state

def _state_tree(names: List[str], adam_impl: str):
    """JAX's tree of ``{"opt_state", "params", "step"}`` under
    ``adam_impl``, leaves as None."""
    ptree = _params_tree(names)
    if adam_impl == "torch":
        opt_state = _Named("TorchAdamState", (ptree, ptree, ptree))
    else:
        opt_state = (_Named("ScaleByAdamState", (None, ptree, ptree)),
                     _Named("EmptyState", ()))
    return {"opt_state": opt_state, "params": ptree, "step": None}


def save_train_state(path: str, model: nn.Module,
                     opt: torch.optim.Adam, step: int,
                     adam_impl: str = "torch") -> None:
    """Write ``model``'s parameters, ``opt``'s Adam state and ``step`` as
    JAX's ``save_train_state`` writes (params, opt_state, step)."""
    optim.check_impl(adam_impl)
    names = jax_leaf_order(model)
    params = dict(model.named_parameters())
    counts, mus, nus = [], [], []
    for n in names:
        p = params[n]
        st = opt.state.get(p) or {}
        # a capturable Adam's count lies on the device: read back here,
        # between steps, never inside a captured one
        counts.append(int(st["step"]) if st else 0)
        for out, key in ((mus, "exp_avg"), (nus, "exp_avg_sq")):
            out.append(st[key].detach().cpu().numpy() if st else
                       np.zeros(tuple(p.shape), dtype=np.float32))
    if adam_impl == "torch":
        count_leaves = [np.asarray(c, dtype=np.int32) for c in counts]
    else:
        if len(set(counts)) > 1:
            raise ValueError(f"adam_impl='global' needs one step count for "
                             f"every parameter, found {sorted(set(counts))}")
        count_leaves = [np.asarray(counts[0] if counts else 0,
                                   dtype=np.int32)]
    leaves = (count_leaves + mus + nus
              + [params[n].detach().cpu().numpy() for n in names]
              + [np.asarray(int(step))])
    _write(path, leaves, _state_tree(names, adam_impl))


def restore_train_state(path: str, model: nn.Module,
                        opt: torch.optim.Adam,
                        adam_impl: str = "torch") -> int:
    """Load a train state written by either package's ``save_train_state``
    into ``model`` and ``opt`` -> the saved step (the epoch to resume at).
    A parameter saved with count 0 gets no Adam state, as before its first
    step."""
    optim.check_impl(adam_impl)
    npz_path = path if path.endswith(".npz") else path + ".npz"
    data = np.load(npz_path)
    names = jax_leaf_order(model)
    want = _treedef(_state_tree(names, adam_impl))
    sidecar = next((p for p in (path + ".tree", npz_path + ".tree")
                    if os.path.exists(p)), None)
    if sidecar is not None:
        with open(sidecar) as f:
            saved = json.load(f).get("treedef")
        if saved != want:
            raise ValueError(f"train state structure mismatch for {path}:\n"
                             f"  saved:    {saved}\n  expected: {want}")
    n = len(names)
    n_counts = n if adam_impl == "torch" else 1
    leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if len(leaves) != n_counts + 3 * n + 1:
        raise ValueError(f"train state has {len(leaves)} leaves, expected "
                         f"{n_counts + 3 * n + 1}")
    counts = [int(c) for c in leaves[:n_counts]]
    if adam_impl == "global":
        counts *= n
    mus = leaves[n_counts:n_counts + n]
    nus = leaves[n_counts + n:n_counts + 2 * n]
    params = dict(model.named_parameters())
    for name, mu, nu in zip(names, mus, nus):
        if not tuple(mu.shape) == tuple(nu.shape) == tuple(params[name].shape):
            raise ValueError(f"{name}: Adam moments {mu.shape} {nu.shape} "
                             f"!= the parameter's {tuple(params[name].shape)}")
    params_from_jax(model, _tree_of(dict(zip(names,
                                             leaves[n_counts + 2 * n:-1]))))
    capturable = opt.param_groups[0]["capturable"]
    for name, c, mu, nu in zip(names, counts, mus, nus):
        p = params[name]
        if c == 0:
            opt.state.pop(p, None)
            continue
        # torch keeps an unfused Adam's step on the host, a capturable
        # one's on the parameter's device
        new = {"step": torch.tensor(float(c), dtype=torch.float32,
                                    device=p.device if capturable else None),
               "exp_avg": torch.tensor(mu, dtype=p.dtype, device=p.device),
               "exp_avg_sq": torch.tensor(nu, dtype=p.dtype, device=p.device)}
        old = opt.state.get(p)
        if old is not None and old.keys() == new.keys():
            # in place: a captured step holds these tensors' addresses
            with torch.no_grad():
                for key, t in new.items():
                    old[key].copy_(t)
        else:
            opt.state[p] = new
    return int(leaves[-1])
