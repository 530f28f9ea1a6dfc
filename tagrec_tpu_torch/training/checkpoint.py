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

A sharded train state (``save_sharded``/``load_sharded``, what a run on a
mesh writes) is JAX's layout: ``<dir>/step_{step:08d}/proc_{p}.npz``, one
array per block keyed ``leaf_{i}|{index}`` (``"0:5000,:"`` for a row
block, ``":,:"`` for a whole leaf, ``""`` for a scalar), and ``meta.json``
with the treedef string, the leaf count, the global shapes and dtypes and
the step.  Each rank writes its own blocks, and a restore assembles each
rank's rows from whatever blocks were saved, under any mesh or none, so
either package reads the other's.

On a model row-sharded over a mesh (``parallel.sharding``) the names
stay JAX's (``embed.0``): ``save`` gathers each table and rank 0 writes
it, ``params_from_jax`` copies each rank's rows.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from tagrec_tpu_torch.parallel import launch, sharding
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


def named_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{JAX name: the parameter}, this rank's rows of a row-sharded one."""
    return {sharding.jax_name(n): p for n, p in model.named_parameters()}


def jax_leaf_order(model: nn.Module) -> List[str]:
    """The model's parameter names in the order JAX flattens its tree: dict
    keys sorted as strings, list indices as numbers."""
    def key(name):
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                     for p in name.split("."))
    return sorted(named_params(model), key=key)


def _rows(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{JAX name: [start, stop)} of the row-sharded parameters."""
    return {n: (g.start, g.stop) for n, g in sharding.gathers(model).items()}


def params_from_jax(model: nn.Module, tree: Dict) -> nn.Module:
    """Copy a JAX params tree (numpy arrays) into ``model``'s parameters of
    the same paths, checking that the two hold the same leaves and shapes
    (a row-sharded one takes this rank's rows); returns ``model``."""
    leaves = dict(_leaves(tree))
    params = named_params(model)
    shapes, rows = sharding.full_shapes(model), _rows(model)
    if leaves.keys() != params.keys():
        raise ValueError(
            f"params tree leaves {sorted(leaves)} do not match the model's "
            f"parameters {sorted(params)}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(leaves[name], dtype=np.float32)
            if tuple(arr.shape) != shapes[name]:
                raise ValueError(f"{name} shape {arr.shape} != model's "
                                 f"{shapes[name]}")
            if name in rows:
                arr = arr[rows[name][0]:rows[name][1]]
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
    it.  On a mesh every rank calls it (the tables are gathered) and rank 0
    writes."""
    names = jax_leaf_order(model)
    with torch.no_grad(), sharding.gathered():
        leaves = [sharding.value(model, n).detach().cpu().numpy()
                  for n in names]
    if launch.is_writer():
        _write(path, leaves, _params_tree(names))


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


def _unsharded(model: nn.Module, what: str) -> None:
    if sharding.gathers(model):
        raise ValueError(f"{what} takes a model that is not sharded; a "
                         "sharded one saves with save_sharded")


def _adam_leaves(names, params, opt, adam_impl: str):
    """(JAX's count leaves, mu and nu arrays in ``names``' order) of
    ``opt``'s state; a parameter Adam has not stepped: count 0, zero
    moments."""
    optim.check_impl(adam_impl)
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
        return [np.asarray(c, dtype=np.int32) for c in counts], mus, nus
    if len(set(counts)) > 1:
        raise ValueError(f"adam_impl='global' needs one step count for "
                         f"every parameter, found {sorted(set(counts))}")
    return [np.asarray(counts[0] if counts else 0, dtype=np.int32)], mus, nus


def _set_adam(opt, params, names, counts, mus, nus) -> None:
    """``opt``'s state from JAX's counts and moments (this rank's rows of
    a sharded parameter's); count 0 leaves a parameter without state.
    In place where the state exists: a captured step holds its
    tensors."""
    capturable = opt.param_groups[0]["capturable"]
    for name, c, mu, nu in zip(names, counts, mus, nus):
        p = params[name]
        if not tuple(mu.shape) == tuple(nu.shape) == tuple(p.shape):
            raise ValueError(f"{name}: Adam moments {mu.shape} {nu.shape} "
                             f"!= the parameter's {tuple(p.shape)}")
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
            with torch.no_grad():
                for key, t in new.items():
                    old[key].copy_(t)
        else:
            opt.state[p] = new


def save_train_state(path: str, model: nn.Module,
                     opt: torch.optim.Adam, step: int,
                     adam_impl: str = "torch") -> None:
    """Write ``model``'s parameters, ``opt``'s Adam state and ``step`` as
    JAX's ``save_train_state`` writes (params, opt_state, step)."""
    _unsharded(model, "save_train_state")
    names = jax_leaf_order(model)
    params = named_params(model)
    count_leaves, mus, nus = _adam_leaves(names, params, opt, adam_impl)
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
    _unsharded(model, "restore_train_state")
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
    params = named_params(model)
    for name, mu, nu in zip(names, mus, nus):
        if not tuple(mu.shape) == tuple(nu.shape) == tuple(params[name].shape):
            raise ValueError(f"{name}: Adam moments {mu.shape} {nu.shape} "
                             f"!= the parameter's {tuple(params[name].shape)}")
    params_from_jax(model, _tree_of(dict(zip(names,
                                             leaves[n_counts + 2 * n:-1]))))
    _set_adam(opt, params, names, counts, mus, nus)
    return int(leaves[-1])


# ---------------------------------------------------- sharded train state

def _index_key(ranges, shape) -> str:
    """JAX's block key: ``start:stop`` a dim, ``:`` for a whole dim, ""
    for a scalar."""
    return ",".join(":" if (s, e) == (0, n) else f"{s}:{e}"
                    for (s, e), n in zip(ranges, shape))


def _parse_key(key: str, shape) -> List[Tuple[int, int]]:
    if not shape:
        return []
    out = []
    for n, part in zip(shape, key.split(",")):
        s, e = part.split(":")
        out.append((int(s) if s else 0, int(e) if e else n))
    return out


def save_sharded(ckpt_dir: str, model: nn.Module, opt: torch.optim.Adam,
                 step: int, *, adam_impl: str = "torch",
                 rotate: int = 0) -> str:
    """Write this rank's blocks of the train state (JAX's ``{"opt_state",
    "params", "step"}`` tree) into ``{ckpt_dir}/step_{step:08d}`` ->
    that directory.  On a mesh every rank calls it: the ranks of data
    index 0 write their row blocks of the sharded leaves, rank 0 the
    whole ones and ``meta.json``; each into ``step_dir.tmp{rank}``, then
    rank 0 moves them in place and keeps the newest ``rotate`` steps."""
    names = jax_leaf_order(model)
    params = named_params(model)
    shapes, rows = sharding.full_shapes(model), _rows(model)
    mesh = sharding.mesh_of(model)
    rank = launch.rank()
    first_row = mesh is None or mesh.index("data") == 0
    counts, mus, nus = _adam_leaves(names, params, opt, adam_impl)
    leaves = (counts + [(n, mu) for n, mu in zip(names, mus)]
              + [(n, nu) for n, nu in zip(names, nus)]
              + [(n, params[n].detach().cpu().numpy()) for n in names]
              + [np.asarray(int(step), dtype=np.int32)])
    arrays, g_shapes, dtypes = {}, [], []
    for i, leaf in enumerate(leaves):
        name, block = leaf if isinstance(leaf, tuple) else (None, leaf)
        shape = shapes[name] if name is not None else tuple(block.shape)
        g_shapes.append(list(shape))
        dtypes.append(str(block.dtype))
        if name in rows:
            if first_row:
                r = [rows[name]] + [(0, n) for n in shape[1:]]
                arrays[f"leaf_{i}|{_index_key(r, shape)}"] = block
        elif rank == 0:
            arrays[f"leaf_{i}|{_index_key([(0, n) for n in shape], shape)}"] \
                = block
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = f"{step_dir}.tmp{rank}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"proc_{rank}"), **arrays)
    if rank == 0:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"treedef": _treedef(_state_tree(names, adam_impl)),
                       "n_leaves": len(leaves), "shapes": g_shapes,
                       "dtypes": dtypes, "step": step}, f)
    launch.barrier()  # every rank's blocks are written
    if rank == 0:
        import shutil

        if os.path.exists(step_dir):  # a re-save of the step replaces it
            shutil.rmtree(step_dir)
        os.makedirs(step_dir)
        for p in range(launch.world_size()):
            src = f"{step_dir}.tmp{p}"
            for fn in os.listdir(src):
                os.replace(os.path.join(src, fn), os.path.join(step_dir, fn))
            os.rmdir(src)
        if rotate > 0:
            # ".tmp" anywhere: a crashed run's step_*.tmp{p} is no step
            steps = sorted(d for d in os.listdir(ckpt_dir)
                           if d.startswith("step_") and ".tmp" not in d)
            for old in steps[:-rotate]:
                shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)
    launch.barrier()  # no rank reads the directory before it is whole
    return step_dir


def latest_step_dir(ckpt_dir: str):
    """The newest ``step_*`` directory under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and ".tmp" not in d)
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def load_sharded(step_dir: str, model: nn.Module, opt: torch.optim.Adam,
                 adam_impl: str = "torch") -> int:
    """Restore a train state that either package's ``save_sharded`` wrote
    into ``model`` and ``opt`` -> the saved step.  Each rank reads only the
    blocks that cover its rows (of its mesh, or all of them), whatever
    mesh wrote them."""
    optim.check_impl(adam_impl)
    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)
    names = jax_leaf_order(model)
    want = _treedef(_state_tree(names, adam_impl))
    if meta["treedef"] != want:
        raise ValueError(f"sharded checkpoint structure mismatch:\n"
                         f"  saved:    {meta['treedef']}\n  expected: {want}")
    n = len(names)
    n_counts = n if adam_impl == "torch" else 1
    if meta["n_leaves"] != n_counts + 3 * n + 1:
        raise ValueError(f"{meta['n_leaves']} leaves saved, "
                         f"{n_counts + 3 * n + 1} expected")
    params = named_params(model)
    shapes, rows = sharding.full_shapes(model), _rows(model)
    leaf_names = [None] * n_counts + names * 3 + [None]
    blocks: Dict[int, list] = {}
    for fn in sorted(os.listdir(step_dir)):
        if fn.startswith("proc_") and fn.endswith(".npz"):
            data = np.load(os.path.join(step_dir, fn))
            for key in data.files:
                i, _, idx = key[len("leaf_"):].partition("|")
                blocks.setdefault(int(i), []).append((idx, data, key))

    def read(i):
        shape = tuple(meta["shapes"][i])
        name = leaf_names[i]
        if name is not None and shape != shapes[name]:
            raise ValueError(f"{name}: saved shape {shape} != the model's "
                             f"{shapes[name]}")
        want = [(0, d) for d in shape]
        if name in rows:
            want[0] = rows[name]
        out = np.zeros([e - s for s, e in want],
                       dtype=np.dtype(meta["dtypes"][i]))
        covered = np.zeros(out.shape, dtype=bool)
        for idx, data, key in blocks.get(i, ()):
            have = _parse_key(idx, shape)
            inter = [(max(ws, hs), min(we, he))
                     for (ws, we), (hs, he) in zip(want, have)]
            if any(s >= e for s, e in inter):
                continue
            dst = tuple(slice(s - ws, e - ws)
                        for (s, e), (ws, _) in zip(inter, want))
            src = tuple(slice(s - hs, e - hs)
                        for (s, e), (hs, _) in zip(inter, have))
            out[dst] = data[key][src]
            covered[dst] = True
        if not covered.all():
            raise KeyError(f"leaf {i} ({name or 'count/step'}): the blocks "
                           f"in {step_dir} do not cover rows {want}")
        return out

    leaves = [read(i) for i in range(meta["n_leaves"])]
    counts = [int(c) for c in leaves[:n_counts]]
    if adam_impl == "global":
        counts *= n
    mus = leaves[n_counts:n_counts + n]
    nus = leaves[n_counts + n:n_counts + 2 * n]
    with torch.no_grad():
        for name, arr in zip(names, leaves[n_counts + 2 * n:-1]):
            params[name].copy_(torch.as_tensor(arr, dtype=torch.float32))
    _set_adam(opt, params, names, counts, mus, nus)
    return int(leaves[-1])
