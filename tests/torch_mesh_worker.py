"""Ranks of the port's mesh tests: each a process of torch and the port
only (no JAX), on gloo over the CPU.

``start_ranks(world, scenario, args, tmp)`` starts ``world`` processes
of this file, each initialising a gloo group on a free local port (one
intra-op thread, a 60 s collective timeout) and running
``SCENARIOS[scenario](args, tmp)``; ``wait_ranks`` returns their results
by rank.  It waits up to a deadline, kills every rank when one fails or
the deadline passes, and raises with their output: a hung collective
fails a test instead of stalling the suite.

``train_models`` is also what the parent runs without a mesh, as the
reference the ranks are held against.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import time
from datetime import timedelta

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEADLINE_S = 150

# (name, preset overrides, adj_mode); LightGCN on the gather (ELL) tier,
# DGCF with the distance-correlation term, KGAT's BPR and TransE phases
MODELS = (("lightgcn", {"reg": 1e-4}, "ell"),
          ("dgcf", {"reg": 1e-3, "cor_reg": 0.1}, "auto"),
          ("kgat", {"agg_type": "bi_inter", "transe_batch": 64}, "auto"))
STEPS = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_graph(n_user=40, n_item=90, n_tag=25):
    from tagrec_tpu_torch.data.synthetic import synthetic_graph

    return synthetic_graph(n_user=n_user, n_item=n_item, n_tag=n_tag,
                           avg_deg=8, seed=7)


# the checkpoint scenario's graph: 64 users and 96 items split into row
# blocks over 2 and over 4 ranks, so a 2 x 2 save reshards under 1 x 4
CKPT_GRAPH = {"n_user": 64, "n_item": 96}


def tcfg():
    from tagrec_tpu_torch.config import TrainConfig

    return TrainConfig(train_batch=64, test_batch=16, epochs=2,
                       test_interval=1, patient_epoch=10)


def pipeline(name, over, adj_mode, mesh=None, graph=None):
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import model_preset

    return build_pipeline(graph or tiny_graph(),
                          model_preset(name, adj_mode=adj_mode, **over),
                          tcfg(), device="cpu", mesh=mesh,
                          generator=torch.Generator().manual_seed(0))


def full_params(model):
    """{JAX name: the whole table} (gathered over the mesh's model axis)."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint

    with torch.no_grad(), sharding.gathered():
        return {n: sharding.value(model, n).detach().clone().numpy()
                for n in checkpoint.jax_leaf_order(model)}


def train_models(mesh=None, steps=STEPS):
    """``steps`` steps of each phase of each of MODELS, then one
    evaluation and 3 top-k requests -> {model: {"losses": {phase: [steps,
    n]}, "params": ..., "eval": ..., "ids": ...}}."""
    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.training.train import Trainer

    out = {}
    for name, over, adj_mode in MODELS:
        pipe = pipeline(name, over, adj_mode, mesh)
        trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                          capture=False,
                          generator=torch.Generator().manual_seed(1))
        losses = {ph.name: trainer.run_phase(ph, max_steps=steps)
                  for ph in pipe.phases}
        u_t, i_t = serving.export_tables(pipe.model,
                                         n_item=pipe.graph.n_item)
        r = serving.Retriever(u_t, i_t, device="cpu", mesh=mesh, block=8,
                              train_pad=serving.metrics.pad_lists(
                                  pipe.graph.user_items["train"],
                                  u_t.shape[0], serving.PAD_ID)[0])
        ids, scores = r.topk(list(range(0, 40, 3)), k=10)
        out[name] = {"losses": losses, "params": full_params(pipe.model),
                     "eval": pipe.evaluator.run(pipe.model),
                     "ids": ids, "scores": scores,
                     "placement": trainer.placement}
    return out


# ------------------------------------------------------------- scenarios

def _mesh(args):
    from tagrec_tpu_torch.parallel import launch

    return launch.global_mesh(args["dp"], args["mp"])


def scenario_train(args, tmp):
    """``train_models`` on the mesh, then each of ``args["then"]``."""
    out = {"models": train_models(_mesh(args))}
    for extra in args.get("then", ()):
        out[extra] = SCENARIOS[extra](args, tmp)
    return out


def scenario_checkpoint(args, tmp):
    """On a 2 x 2 mesh: train LightGCN, save_sharded, load it back under
    1 x 4, read the JAX-written directory ``args["jax_dir"]`` if given,
    and resume a meshed ``Trainer.run`` from its state directory."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.early_stop import EarlyStop
    from tagrec_tpu_torch.training.train import Trainer

    mesh = _mesh(args)
    name, over, adj_mode = MODELS[0]
    graph = tiny_graph(**CKPT_GRAPH)
    pipe = pipeline(name, over, adj_mode, mesh, graph)
    trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                      capture=False, generator=torch.Generator().manual_seed(1))
    trainer.run_phase(pipe.phases[0], max_steps=STEPS)
    ck = os.path.join(tmp, "ck")
    step_dir = checkpoint.save_sharded(ck, pipe.model, trainer.opt, 7)
    out = {"saved": full_params(pipe.model), "step_dir": step_dir,
           "adam": adam_full(pipe.model, trainer.opt)}

    wide = make_mesh(4, data_parallel=1)  # 1 x 4
    pipe2 = pipeline(name, over, adj_mode, wide, graph)
    t2 = Trainer(pipe2.model, pipe2.phases, tcfg(), mesh=wide, capture=False,
                 generator=torch.Generator().manual_seed(1))
    out["step_1x4"] = checkpoint.load_sharded(step_dir, pipe2.model, t2.opt)
    out["loaded_1x4"] = full_params(pipe2.model)
    out["adam_1x4"] = adam_full(pipe2.model, t2.opt)
    if args.get("jax_dir"):
        pipe3 = pipeline(name, over, adj_mode, mesh, graph)
        t3 = Trainer(pipe3.model, pipe3.phases, tcfg(), mesh=mesh,
                     capture=False, generator=torch.Generator().manual_seed(1))
        out["jax_step"] = checkpoint.load_sharded(args["jax_dir"],
                                                  pipe3.model, t3.opt)
        out["jax_loaded"] = full_params(pipe3.model)
        out["jax_adam"] = adam_full(pipe3.model, t3.opt)

    # Trainer.run with a state directory: 2 epochs, then resumed to 3
    state = os.path.join(tmp, "state")
    logs = []
    pipe4 = pipeline(name, over, adj_mode, mesh, graph)
    for epochs in (2, 3):
        t4 = Trainer(pipe4.model, pipe4.phases, tcfg().replace(epochs=epochs),
                     mesh=mesh, capture=False,
                     generator=torch.Generator().manual_seed(1))
        t4.run(pipe4.evaluator, EarlyStop(10), log=logs.append,
               state_path=state)
    out["logs"] = logs
    out["latest"] = os.path.basename(checkpoint.latest_step_dir(state))
    return out


def adam_full(model, opt):
    """{JAX name: (count, mu, nu)}, the moments gathered over ``model``."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint

    gs = sharding.gathers(model)
    params = checkpoint.named_params(model)
    out = {}
    for n in checkpoint.jax_leaf_order(model):
        st = opt.state.get(params[n])
        if not st:
            out[n] = None
            continue
        moments = []
        for key in ("exp_avg", "exp_avg_sq"):
            t = st[key]
            if n in gs:
                parts = [torch.empty_like(t)
                         for _ in range(gs[n].mesh.shape["model"])]
                torch.distributed.all_gather(parts, t,
                                             group=gs[n].mesh.group("model"))
                t = torch.cat(parts)
            moments.append(t.numpy().copy())
        out[n] = (int(st["step"]), *moments)
    return out


def scenario_scaling(args, tmp):
    """launch.scaling_report over meshes of 1 and 2 ranks."""
    from tagrec_tpu_torch.parallel import launch, sharding

    def args_fn(mesh, rep):
        return (torch.full((4, 3), float(rep + 1)), mesh)

    def step(x, mesh):
        y = x.clone()
        sharding.data_mean_([y], mesh)
        return y

    return launch.scaling_report(step, args_fn, [1, 2], batch=4, reps=2)


# ---------------------------------------- the partitioned propagation

# 480 joint nodes: over 2 and 4 ranks the degree buckets, the hub block and
# the sector blocks mix row-sharded pieces (80, 84, 120, 300 and 480 rows)
# with whole ones (269 rows, odd; and fewer than 64)
PROP_GRAPH = {"n_user": 120, "n_item": 300, "n_tag": 60}
HUB_MIN = 12  # hub columns on this graph (tests/test_torch_lightgcn.py)
# case -> (family, adj_mode, preset overrides, hub columns)
PROP_CASES = {"ell": ("lightgcn", "ell", {"reg": 1e-4}, False),
              "hub": ("lightgcn", "hybrid", {"reg": 1e-4}, True),
              "sectors": ("lightgcn", "dense", {"reg": 1e-4}, False),
              "ngcf": ("ngcf", "hybrid", {}, True),
              "drop": ("lightgcn", "hybrid", {"reg": 1e-4, "node_drop": 0.1},
                       True)}
DROP_SEED = 5


def prop_graph():
    return tiny_graph(**PROP_GRAPH)


def hub_pair(graph, name, build):
    """The family's stored pair (LightGCN bi_norm, symmetric; NGCF
    si_norm, its own transpose) on the hybrid tier with hub columns;
    ``build`` is either package's ``build_adj_pair``."""
    norm = "bi_norm" if name == "lightgcn" else "si_norm"
    return build(graph.joint_norm_adj(norm, True), symmetric=norm == "bi_norm",
                 mode="hybrid", hub_min_degree=HUB_MIN)


def prop_pipeline(case, mesh=None):
    """The case's pipeline on the CPU: with hub columns, the model's pair
    rebuilt with them, then (under ``mesh``) cut to the rank's rows."""
    from tagrec_tpu_torch.ops import ell

    name, mode, over, hub = PROP_CASES[case]
    pipe = pipeline(name, over, mode, mesh, prop_graph())
    if hub:
        m = pipe.model
        m.adj_host = hub_pair(pipe.graph, name, ell.build_adj_pair)
        m.adj = ell.to_device(m.adj_host if mesh is None
                              else ell.shard_rows(m.adj_host, mesh), "cpu")
    return pipe


def dropped_leaves(adj):
    """{leaf path: values} of ``adj`` under node_drop's dropout from
    DROP_SEED."""
    from tagrec_tpu_torch.ops import ell
    from tagrec_tpu_torch.ops.propagate import edge_dropout

    rate = PROP_CASES["drop"][2]["node_drop"]
    dropped = edge_dropout(adj, rate, torch.Generator().manual_seed(DROP_SEED),
                           True)
    return {p: a.numpy().copy() for p, a in ell.leaves(dropped, "adj.fwd")}


def prop_runs(mesh=None, steps=STEPS):
    """Each of PROP_CASES: the forward, ``steps`` BPR steps (losses, the
    gathered parameters), the graph's placement, leaf shapes and bytes;
    the drop case's dropped tables too."""
    from tagrec_tpu_torch.ops import ell
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training.train import Trainer

    out = {}
    for case in PROP_CASES:
        pipe = prop_pipeline(case, mesh)
        trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                          capture=False,
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad(), sharding.gathered():
            fwd = [t.numpy().copy() for t in pipe.model.forward()]
        adj = pipe.model.adj
        out[case] = {
            "forward": fwd,
            "losses": trainer.run_phase(pipe.phases[0], max_steps=steps),
            "params": full_params(pipe.model),
            "placement": trainer.placement and trainer.placement["graph"],
            "leaves": {p: tuple(a.shape) for p, a in ell.leaves(adj)},
            "bytes": ell.graph_bytes(adj)}
        if case == "drop":
            out[case]["dropped"] = dropped_leaves(adj)
    return out


def full_grads(model):
    """{JAX name: the whole gradient} of ``model``'s parameters after a
    step (a row-sharded one gathered over ``model``)."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint

    gs, params = sharding.gathers(model), checkpoint.named_params(model)
    out = {}
    for n in checkpoint.jax_leaf_order(model):
        g = params[n].grad
        if n in gs:
            parts = [torch.empty_like(g)
                     for _ in range(gs[n].mesh.shape["model"])]
            torch.distributed.all_gather(parts, g,
                                         group=gs[n].mesh.group("model"))
            g = torch.cat(parts)
        out[n] = g.numpy().copy()
    return out


def jax_step(args, mesh=None):
    """One BPR step of the hub case from the JAX parameters and batch in
    ``args`` -> (summed loss terms, the gathered parameters, the gathered
    gradients the step took)."""
    import numpy as np

    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    pipe = prop_pipeline("hub", mesh)
    with np.load(args["jax_params"]) as f:
        checkpoint.params_from_jax(pipe.model, {"embed": [
            f[f"embed.{i}"] for i in range(len(f.files))]})
    trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                      capture=False, generator=torch.Generator().manual_seed(1))
    batch = torch.as_tensor(np.asarray(args["batch"], dtype=np.int64))
    if mesh is not None:
        batch = sharding.constrain_batch(batch, mesh)
    parts = trainer.step(pipe.phases[0], batch)
    return (float(parts.sum()), full_params(pipe.model),
            full_grads(pipe.model))


def scenario_propagate(args, tmp):
    """``prop_runs`` and ``jax_step`` on the mesh."""
    mesh = _mesh(args)
    return {"cases": prop_runs(mesh), "jax_step": jax_step(args, mesh)}


# ------------------------------------- the EdgeMap tier's partition

# case -> (family, preset overrides), each on PROP_GRAPH's EdgeMap
# (adj_mode="ell"): forward buckets of 112, 96, 100 and 64 rows shard over
# 2 and 4 ranks, those of 69 (width 0), 27, 9 and 3 stay whole
EM_CASES = {"dgcf": ("dgcf", {"reg": 1e-3}), "disengcn": ("disengcn", {})}
EM_SEED = 3  # the per-slot values moved by transpose_vals


def em_pipeline(case, mesh=None):
    name, over = EM_CASES[case]
    return pipeline(name, over, "ell", mesh, prop_graph())


def em_slot_values(em_host, f=4):
    """[f, Nb, Kb] values per forward bucket of the whole map, from
    EM_SEED."""
    import numpy as np

    rng = np.random.default_rng(EM_SEED)
    return [rng.standard_normal((f,) + b.idx.shape).astype(np.float32)
            for b in em_host.f.buckets]


def em_transposed(model):
    """``transpose_vals`` of ``em_slot_values`` (each bucket's rows the
    map holds), and back -> (transpose layout, forward layout) tables."""
    from tagrec_tpu_torch.ops import edgemap

    em = model.edges["em"]
    blocks = getattr(em, "f_blocks", [None] * em.n_buckets)
    vals = tuple(torch.as_tensor(cut(v, k))
                 for v, k in zip(em_slot_values(model.em_hosts["em"]),
                                 blocks))
    there = edgemap.transpose_vals(em, vals)
    back = edgemap.transpose_vals(em.transpose(), there)
    return ([t.numpy().copy() for t in there],
            [t.numpy().copy() for t in back])


def cut(a, block):
    """Rows [start, stop) = ``block`` of the last two axes' rows."""
    return a if block is None else a[..., block[0]:block[1], :]


def em_runs(mesh=None, steps=STEPS):
    """Each of EM_CASES: the forward, the moved slot values, ``steps``
    resampling BPR steps (losses, the gathered parameters), the graph's
    placement, leaf shapes and bytes."""
    from tagrec_tpu_torch.ops import edgemap, ell
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training.train import Trainer

    out = {}
    for case in EM_CASES:
        pipe = em_pipeline(case, mesh)
        model = pipe.model
        trainer = Trainer(model, pipe.phases, tcfg(), mesh=mesh,
                          capture=False,
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad(), sharding.gathered():
            fwd = [t.numpy().copy() for t in model.forward()]
        em = model.edges["em"]
        out[case] = {
            "forward": fwd, "transposed": em_transposed(model),
            "blocks": (getattr(em, "f_blocks", None),
                       getattr(em, "b_blocks", None)),
            "losses": trainer.run_phase(pipe.phases[0], max_steps=steps),
            "params": full_params(model),
            "placement": trainer.placement and trainer.placement["graph"],
            "leaves": {p: tuple(a.shape) for p, a in edgemap.leaves(em)},
            "bytes": ell.graph_bytes(em)}
    return out


def em_jax_step(args, mesh=None):
    """One DGCF BPR step from the JAX parameters and batch in ``args`` ->
    (summed loss terms, the gathered parameters, the gathered gradients
    the step took)."""
    import numpy as np

    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    pipe = em_pipeline("dgcf", mesh)
    with np.load(args["jax_params"]) as f:
        checkpoint.params_from_jax(pipe.model, {"embed": [
            f[f"embed.{i}"] for i in range(len(f.files))]})
    trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                      capture=False, generator=torch.Generator().manual_seed(1))
    batch = {"bpr": torch.as_tensor(np.asarray(args["batch"],
                                               dtype=np.int64))}
    if mesh is not None:
        batch = sharding.constrain_batch(batch, mesh)
    parts = trainer.step(pipe.phases[0], batch)
    return (float(parts.sum()), full_params(pipe.model),
            full_grads(pipe.model))


def scenario_edgemap(args, tmp):
    """``em_runs`` and ``em_jax_step`` on the mesh."""
    mesh = _mesh(args)
    return {"cases": em_runs(mesh), "jax_step": em_jax_step(args, mesh)}


# ------------------- the EdgeMap tier of DisenHAN, KGAT and TGCN ``ell``

# case -> (family, preset overrides, over KG_TINY), each on PROP_GRAPH under
# adj_mode="ell": DisenHAN's six maps; KGAT's em, emk, k2n and n2k, on the
# tag graph and over a KG; TGCN's twelve, one forward bucket each, of 120
# and 300 rows (row-sharded over 2 ranks) or 60 (whole)
EMM_CASES = {"disenhan": ("disenhan", {"reg": 1e-3}, False),
             "kgat": ("kgat", {"agg_type": "bi_inter", "transe_batch": 64},
                      False),
             "kgat_kg": ("kgat", {"agg_type": "bi_inter", "transe_batch": 64},
                         True),
             "tgcn": ("tgcn", {"reg": 1e-3, "transtag_batch": 64}, False)}
KG_TINY = {"n_entity": 400, "n_triples": 1200, "n_rela": 3, "seed": 0}
# the map each case's primitives run on
EMM_PRIM = {"disenhan": "ems.1", "kgat": "em", "kgat_kg": "emk",
            "tgcn": "em.i_uw.0"}
PRIM_F, PRIM_D = 2, 3  # the primitives' leading axis and vector width


def emm_pipeline(case, mesh=None):
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.kg import KnowledgeGraph

    name, over, with_kg = EMM_CASES[case]
    graph = prop_graph()
    kg = KnowledgeGraph.synthetic(graph, **KG_TINY) if with_kg else None
    return build_pipeline(graph, model_preset(name, adj_mode="ell", **over),
                          tcfg(), device="cpu", mesh=mesh, kg=kg,
                          generator=torch.Generator().manual_seed(0))


def cut1(a, block):
    """Rows [start, stop) = ``block`` of axis 1 (after the leading F)."""
    return a if block is None else a[:, block[0]:block[1]]


def emm_primitives(model, case):
    """Each primitive over the case's map (and KGAT's ``slot_transfer``),
    from whole seeded inputs cut to the rows the map holds, with a whole
    seeded cotangent cut the same way -> {primitive: {"out": [(block,
    array)], "grad": [(block, array)]}}: a block the rows of axis 1 the
    array holds (None: all of them)."""
    import numpy as np

    from tagrec_tpu_torch.ops import edgemap

    f, d = PRIM_F, PRIM_D
    rng = np.random.default_rng(EM_SEED)

    def draw(shape, block=None):
        return torch.tensor(cut1(rng.standard_normal(shape).astype(
            np.float32), block), requires_grad=True)

    def blocks(key):
        m = model.edges[key]
        return (m.f_blocks if isinstance(m, edgemap.EdgeMapShard)
                else (None,) * m.n_buckets)

    def slots(key, *tail):
        """(whole shapes, blocks) of per-slot values over ``key``'s map."""
        return ([(f,) + b.idx.shape + tail
                 for b in model.em_hosts[key].f.buckets], blocks(key))

    def run(fn, ins, outs_like):
        """``fn`` over ``ins`` ([(whole shape, block)]), its outputs held
        as ``outs_like`` says, then backward from a seeded cotangent."""
        leaves = [draw(shape, k) for shape, k in ins]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cots = [draw(shape, k).detach() for shape, k in outs_like]
        sum((o * c).sum() for o, c in zip(outs, cots)).backward()
        return {"out": [(k, o.detach().numpy().copy())
                        for o, (_, k) in zip(outs, outs_like)],
                "grad": [(k, t.grad.numpy().copy())
                         for t, (_, k) in zip(leaves, ins)]}

    def pairs(shapes_blocks):
        shapes, blks = shapes_blocks
        return list(zip(shapes, blks))

    key = EMM_PRIM[case]
    em, h = model.edges[key], model.em_hosts[key].f
    rows = (f, h.n_rows, d)
    sv, svd = pairs(slots(key)), pairs(slots(key, d))
    part = [((f, len(r), d), k) for r, k in zip(h.rows, blocks(key))]
    res = {
        "rows_gather": run(lambda x: edgemap.rows_gather(em, x),
                           [(rows, None)], part),
        "edge_gather": run(lambda v: edgemap.edge_gather(em, v),
                           [((f, h.n_cols), None)], sv),
        "edge_vgather": run(lambda x: edgemap.edge_vgather(em, x),
                            [((f, h.n_cols, d), None)], svd),
        "edge_softmax": run(lambda *s: edgemap.edge_softmax(em, s), sv, sv),
        "rows_ordered": run(lambda *p: edgemap.rows_ordered(em, p), part,
                            [(rows, None)]),
        "edge_score": run(lambda w, *x: edgemap.edge_score(em, x, w),
                          [((1, d), None)] + svd, sv)}
    if "k2n" in model.em_hosts:
        k2n, n2k = model.edges["k2n"], model.edges["n2k"]
        res["slot_transfer"] = run(
            lambda *v: edgemap.slot_transfer(v, k2n, n2k),
            pairs(slots("emk")), pairs(slots("em")))
    return res


def edges_leaves(model):
    """[(JAX's leaf path, tensor)] of every map and slot map the model
    holds: a map's ``leaves`` (a shard's local tables), a slot map's
    tables (a shard's read tables)."""
    from tagrec_tpu_torch.ops import edgemap

    out = []
    for key in model.em_hosts:
        item = model.edges[key]
        if isinstance(item, (edgemap.EdgeMap, edgemap.EdgeMapShard)):
            out += edgemap.leaves(item, key)
        else:
            out += [(f"{key}.{j}", t) for j, t in enumerate(item.read)]
    return out


def emm_runs(mesh=None, cases=tuple(EMM_CASES), steps=STEPS):
    """Each of ``cases``: the forward, the primitives, ``steps`` steps of
    each phase (losses, the gathered parameters), the graph's placement,
    the maps' leaf shapes and bytes."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training.train import Trainer

    out = {}
    for case in cases:
        pipe = emm_pipeline(case, mesh)
        model = pipe.model
        trainer = Trainer(model, pipe.phases, tcfg(), mesh=mesh,
                          capture=False,
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad(), sharding.gathered():
            fwd = [t.numpy().copy() for t in model.forward()]
        out[case] = {
            "tier": model.tier, "forward": fwd,
            "prims": emm_primitives(model, case),
            "losses": {ph.name: trainer.run_phase(ph, max_steps=steps)
                       for ph in pipe.phases},
            "params": full_params(model),
            "placement": trainer.placement and trainer.placement["graph"],
            "sharded": [k for k in model.em_hosts if isinstance(
                model.edges[k], (edgemap.EdgeMapShard,
                                 edgemap.SlotMapShard))
                and model.edges[k].mesh is not None],
            "leaves": {p: tuple(a.shape) for p, a in edges_leaves(model)},
            "bytes": model.edges.nbytes()}
    return out


def emm_jax_step(args, mesh=None):
    """One KGAT BPR step from the JAX parameters and batch in ``args`` ->
    (summed loss terms, the gathered parameters, the gathered gradients
    the step took)."""
    import numpy as np

    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    pipe = emm_pipeline("kgat", mesh)
    with np.load(args["jax_params"]) as f:
        checkpoint.params_from_jax(pipe.model, checkpoint._tree_of(
            {k: f[k] for k in f.files}))
    trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                      capture=False, generator=torch.Generator().manual_seed(1))
    batch = torch.as_tensor(np.asarray(args["batch"], dtype=np.int64))
    if mesh is not None:
        batch = sharding.constrain_batch(batch, mesh)
    parts = trainer.step(pipe.phases[0], batch)
    return (float(parts.sum()), full_params(pipe.model),
            full_grads(pipe.model))


def scenario_em_models(args, tmp):
    """``emm_runs`` of ``args["cases"]`` on the mesh, and ``emm_jax_step``
    where ``args`` asks for it."""
    mesh = _mesh(args)
    out = {"cases": emm_runs(mesh, args["cases"])}
    if args.get("jax_step"):
        out["jax_step"] = emm_jax_step(args, mesh)
    return out


# ------------------------- TGCN's neighbour tables and dedup buckets

# 556 nodes, one narrow layer: at model = 2 every relation's dedup buckets
# mix row-sharded ones (64 rows or more, an even count) with whole ones, and
# every [N, k] table row-shards
TGCN_GRAPH = {"n_user": 128, "n_item": 300, "n_tag": 128, "seed": 4}
TGCN_CFG = {"dim_latent": 16, "dim_layer_list": (16,), "reg": 1e-3,
            "transtag_batch": 64}
TGCN_CASES = ("auto", "dense_xla")
# planted faults the gradient hold must catch: every rank back-propagates
# the whole buckets (counted model times), or no model sum
TGCN_FAULTS = ("whole_on_every_rank", "no_model_sum")


def tgcn_graph():
    from tagrec_tpu_torch.data.synthetic import synthetic_graph

    return synthetic_graph(**TGCN_GRAPH, avg_deg=8)


def tgcn_pipeline(case, mesh=None):
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import model_preset

    return build_pipeline(tgcn_graph(), model_preset("tgcn", adj_mode=case,
                                                     **TGCN_CFG),
                          tcfg(), device="cpu", mesh=mesh,
                          generator=torch.Generator().manual_seed(0))


def wait_for(path: str, deadline_s: float = DEADLINE_S) -> str:
    """``path`` once it exists (the parent moves it in whole, with
    ``os.replace``, while the ranks run)."""
    end = time.monotonic() + deadline_s
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear in {deadline_s} s")
        time.sleep(0.05)
    return path


class planted:
    """Within it, the port runs with ``fault`` (one of TGCN_FAULTS, or
    None: none): ``propagate.leads`` true on every rank, or no sum over
    ``model`` in ``sum_owner`` (the module whose ``model_sum`` the path
    calls: ``models.tgcn`` by default)."""

    def __init__(self, fault, sum_owner=None):
        from tagrec_tpu_torch.models import tgcn
        from tagrec_tpu_torch.ops import propagate

        self.prop, self.mod = propagate, sum_owner or tgcn
        self.saved = (propagate.leads, self.mod.model_sum)
        self.fault = fault

    def __enter__(self):
        if self.fault == "whole_on_every_rank":
            self.prop.leads = lambda mesh: True
        elif self.fault == "no_model_sum":
            self.mod.model_sum = lambda mesh, *xs: xs
        return self

    def __exit__(self, *exc):
        self.prop.leads, self.mod.model_sum = self.saved


def tgcn_step(case, args, mesh=None, fault=None):
    """One BPR step of ``case`` from the JAX parameters and batch in
    ``args`` -> (summed loss terms, the gathered parameters, the gathered
    gradients the step took)."""
    import numpy as np

    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    pipe = tgcn_pipeline(case, mesh)
    with np.load(wait_for(args["jax_params"])) as f:
        checkpoint.params_from_jax(pipe.model, checkpoint._tree_of(
            {k: f[k] for k in f.files}))
    trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                      capture=False, generator=torch.Generator().manual_seed(1))
    batch = torch.as_tensor(np.asarray(args["batch"], dtype=np.int64))
    if mesh is not None:
        batch = sharding.constrain_batch(batch, mesh)
    with planted(fault):
        parts = trainer.step(pipe.phases[0], batch)
    return (float(parts.sum()), full_params(pipe.model),
            full_grads(pipe.model))


def tgcn_runs(args, mesh=None, steps=STEPS):
    """Each of TGCN_CASES: the forward and the rows each relation fed its
    attention, ``steps`` steps of each phase (losses, the gathered
    parameters), one evaluation, the tables' placement, leaf shapes and
    bytes, and ``tgcn_step``; on ``auto`` under a mesh ``tgcn_step`` with
    each of TGCN_FAULTS too."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training.train import Trainer

    out = {}
    for case in TGCN_CASES:
        pipe = tgcn_pipeline(case, mesh)
        model = pipe.model
        trainer = Trainer(model, pipe.phases, tcfg(), mesh=mesh,
                          capture=False,
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad(), sharding.gathered():
            fwd = [t.numpy().copy() for t in model.forward()]
        out[case] = {
            "tier": model.tier, "forward": fwd,
            "rows": dict(model.attention_rows),
            "losses": {ph.name: trainer.run_phase(ph, max_steps=steps)
                       for ph in pipe.phases},
            "params": full_params(model),
            "eval": pipe.evaluator.run(model),
            "placement": trainer.placement and trainer.placement["graph"],
            "leaves": {p: tuple(t.shape) for p, t in model.table_tensors()},
            "bytes": model.table_nbytes(),
            "step": tgcn_step(case, args, mesh)}
        if mesh is not None and case == "auto":
            out[case]["faults"] = {f: tgcn_step(case, args, mesh, f)
                                   for f in TGCN_FAULTS}
    return out


def scenario_tgcn_rows(args, tmp):
    """``tgcn_runs`` on the mesh, or without one (``args["plain"]``: the
    one-device reference); on a ``model`` = 2 world rank 0 also on a
    one-rank mesh of its own (``one``)."""
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    if args.get("plain"):
        return {"cases": tgcn_runs(args)}
    out = {"cases": tgcn_runs(args, _mesh(args))}
    if args.get("one_rank"):
        one = make_mesh(1)  # every rank of the world makes its groups
        if one.member:
            out["one"] = tgcn_runs(args, one)
    return out


# ------------------------- the kernel tiers' masks over ``model``

# case -> (family, preset overrides), each on PROP_GRAPH's kernel tier
# (adj_mode="auto"): DGCF's and DisenGCN's [480, 480] mask (240 and 120
# rows a rank over 2 and 4), KGAT's flash masks [256, 768], [512, 512],
# [256, 768] and their transposes, whose 768 rows put a rank's block left
# of the split at 512, across it, or right of it
MASK_CASES = {"dgcf": ("dgcf", {"reg": 1e-3}),
              "disengcn": ("disengcn", {}),
              "kgat": ("kgat", {"agg_type": "bi_inter", "transe_batch": 64})}
# the cases whose BPR step is held against JAX's sharded step
MASK_STEPS = ("dgcf", "kgat")
# planted faults the gradient hold must catch, with the case each plants
# into: routed_mm's dx from the rank's rows without the all-gather (the
# other ranks' rows left zero), or dot_bwd_col sweeping a rank's rows of
# fmaskT as the attention's columns 0 .. R (its plane and its k and x rows
# chosen by the row in the block, not by the global column)
MASK_FAULTS = {"no_gather": "dgcf", "local_columns": "kgat"}


def mask_pipeline(case, mesh=None):
    name, over = MASK_CASES[case]
    return pipeline(name, over, "auto", mesh, prop_graph())


class planted_mask_fault:
    """Within it, the sweeps' wrappers run with ``fault`` (one of
    MASK_FAULTS, or None: none)."""

    def __init__(self, fault):
        from tagrec_tpu_torch.ops import flash_attention, flash_routing

        self.fa, self.fr, self.fault = flash_attention, flash_routing, fault
        self.saved = (flash_routing.routed_mm_bwd, flash_attention.dot_bwd_col)

    def __enter__(self):
        bwd, col = self.saved
        if self.fault == "no_gather":
            def ungathered(q, k, mask_t, g, base=0.0, edges=None):
                out = g.new_zeros((g.shape[0], k.shape[1], g.shape[2]))
                out[:, mask_t.start:mask_t.stop] = bwd(
                    q, k, mask_t.local, g, base, row0=mask_t.start,
                    edges=edges)
                return out
            self.fr.routed_mm_bwd = ungathered
        elif self.fault == "local_columns":
            def local(q2, k, mask_t, ms, zs, x, g, delta, split, row0=0,
                      out=None):
                return col(q2, k, mask_t, ms, zs, x, g, delta, split,
                           out=out)
            self.fa.dot_bwd_col = local
        return self

    def __exit__(self, *exc):
        self.fr.routed_mm_bwd, self.fa.dot_bwd_col = self.saved


def mask_step(case, args, mesh=None, fault=None):
    """One BPR step of ``case`` from the JAX parameters in ``args`` (each
    case's file) and its batch -> (summed loss terms, the gathered
    parameters, the gathered gradients the step took)."""
    import numpy as np

    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training import checkpoint
    from tagrec_tpu_torch.training.train import Trainer

    pipe = mask_pipeline(case, mesh)
    with np.load(wait_for(args["jax_params"][case])) as f:
        checkpoint.params_from_jax(pipe.model, checkpoint._tree_of(
            {k: f[k] for k in f.files}))
    trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                      capture=False,
                      generator=torch.Generator().manual_seed(1))
    batch = torch.as_tensor(np.asarray(args["batch"], dtype=np.int64))
    if case in ("dgcf", "disengcn"):  # the resampling phase's batch
        batch = {"bpr": batch}
    if mesh is not None:
        batch = sharding.constrain_batch(batch, mesh)
    with planted_mask_fault(fault):
        parts = trainer.step(pipe.phases[0], batch)
    return (float(parts.sum()), full_params(pipe.model),
            full_grads(pipe.model))


def mask_runs(args, mesh=None, steps=STEPS):
    """Each of MASK_CASES: the forward, ``steps`` steps of each phase
    (losses, the gathered parameters), the masks' placement, leaf shapes
    and bytes; the cases of MASK_STEPS also ``mask_step``, and under a
    mesh of ``model`` > 1 with each of MASK_FAULTS planted in its case."""
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training.train import Trainer

    out = {}
    for case in MASK_CASES:
        pipe = mask_pipeline(case, mesh)
        model = pipe.model
        trainer = Trainer(model, pipe.phases, tcfg(), mesh=mesh,
                          capture=False,
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad(), sharding.gathered():
            fwd = [t.numpy().copy() for t in model.forward()]
        out[case] = {
            "tier": model.tier, "forward": fwd,
            "losses": {ph.name: trainer.run_phase(ph, max_steps=steps)
                       for ph in pipe.phases},
            "params": full_params(model),
            "placement": trainer.placement and trainer.placement["graph"],
            "leaves": {path: tuple(getattr(model, name).shape)
                       for path, name, _, _ in model.mask_hosts},
            "bytes": model.mask_nbytes()}
        if case in MASK_STEPS:
            out[case]["step"] = mask_step(case, args, mesh)
    if mesh is not None and mesh.shape["model"] > 1:
        for fault, case in MASK_FAULTS.items():
            out[case].setdefault("faults", {})[fault] = mask_step(
                case, args, mesh, fault)
    return out


def scenario_masks(args, tmp):
    """``mask_runs`` on the mesh, or without one (``args["plain"]``: the
    one-device reference)."""
    if args.get("plain"):
        return {"cases": mask_runs(args)}
    return {"cases": mask_runs(args, _mesh(args))}


# ------------------------- the chunked dense tiers over ``model``

# case -> (family, preset overrides, adj_mode, over a KG), on PROP_GRAPH:
# DisenHAN's dense tier (one layer: JAX's sharded step compiles in half
# the time of two layers'; masks [120, 300], [300, 120] and [300, 60] cut
# over 2, the tag masks' 60 rows whole), KGAT over a KG of 520 nodes
# (``rel_id`` [520, 520]: a rank's 260 rows hold the 120 user rows and
# entity rows), and the dense_xla tier's [480, 480] mask
DENSE_CASES = {
    "disenhan": ("disenhan", {"reg": 1e-3, "dim_layer_list": (64,)}, "auto",
                 False),
    "kgat_kg": ("kgat", {"agg_type": "bi_inter", "transe_batch": 64}, "auto",
                True),
    "dgcf": ("dgcf", {"reg": 1e-3}, "dense_xla", False),
    "disengcn": ("disengcn", {}, "dense_xla", False),
    "kgat": ("kgat", {"agg_type": "bi_inter", "transe_batch": 64},
             "dense_xla", False)}
# the cases whose BPR step is held against JAX's sharded step
DENSE_STEPS = ("disenhan", "kgat_kg")
# planted faults the gradient hold must catch, with the case each plants
# into: a whole mask's relation back-propagated on every rank (DisenHAN's
# tag masks, whose relations reach the loss through a second layer only),
# or no sum over ``model`` of the inputs read whole
DENSE_FAULTS = {"whole_on_every_rank": "disenhan2",
                "no_model_sum": "kgat_kg"}
# the cases that run only a step, sound and with their fault
DENSE_FAULT_CASES = {
    "disenhan2": ("disenhan", {"reg": 1e-3, "dim_layer_list": (64, 64)},
                  "auto", False)}


def dense_pipeline(case, mesh=None):
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.kg import KnowledgeGraph

    name, over, adj_mode, with_kg = {**DENSE_CASES,
                                     **DENSE_FAULT_CASES}[case]
    graph = prop_graph()
    kg = KnowledgeGraph.synthetic(graph, **KG_TINY) if with_kg else None
    return build_pipeline(graph, model_preset(name, adj_mode=adj_mode,
                                              **over),
                          tcfg(), device="cpu", mesh=mesh, kg=kg,
                          generator=torch.Generator().manual_seed(0))


def dense_step(case, args, mesh=None, fault=None):
    """One BPR step of ``case`` from its initial parameters on the batch
    in ``args`` -> (summed loss terms, the gathered parameters, the
    gathered gradients the step took)."""
    import numpy as np

    from tagrec_tpu_torch.models import base
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training.train import Trainer

    pipe = dense_pipeline(case, mesh)
    trainer = Trainer(pipe.model, pipe.phases, tcfg(), mesh=mesh,
                      capture=False,
                      generator=torch.Generator().manual_seed(1))
    batch = torch.as_tensor(np.asarray(args["batch"], dtype=np.int64))
    if pipe.model.cfg.name in ("dgcf", "disengcn", "disenhan"):
        batch = {"bpr": batch}  # the resampling phase's batch
    if mesh is not None:
        batch = sharding.constrain_batch(batch, mesh)
    with planted(fault, base):
        parts = trainer.step(pipe.phases[0], batch)
    return (float(parts.sum()), full_params(pipe.model),
            full_grads(pipe.model))


def dense_runs(args, mesh=None, steps=STEPS):
    """Each of DENSE_CASES: the forward and the exported tables, ``steps``
    BPR steps (losses, each step's gathered gradients, the gathered
    parameters), the tables' placement, blocks, leaf shapes and bytes;
    the cases of DENSE_STEPS also ``dense_step``, and under a mesh of
    ``model`` > 1 with each of DENSE_FAULTS planted in its case."""
    from tagrec_tpu_torch import serving
    from tagrec_tpu_torch.parallel import sharding
    from tagrec_tpu_torch.training.train import Trainer

    out = {}
    for case in DENSE_CASES:
        pipe = dense_pipeline(case, mesh)
        model = pipe.model
        trainer = Trainer(model, pipe.phases, tcfg(), mesh=mesh,
                          capture=False,
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad(), sharding.gathered():
            fwd = [t.numpy().copy() for t in model.forward()]
        grads = []
        res = out[case] = {
            "tier": model.tier, "forward": fwd,
            "export": serving.export_tables(model,
                                            n_item=pipe.graph.n_item),
            "losses": trainer.run_phase(
                pipe.phases[0], max_steps=steps,
                on_step=lambda i, parts: grads.append(full_grads(model))),
            "grads": grads, "params": full_params(model),
            "placement": trainer.placement and trainer.placement["graph"],
            "blocks": dict(model.mask_blocks),
            "leaves": {path: tuple(getattr(model, name).shape)
                       for path, name, _, _ in model.mask_hosts},
            "bytes": model.mask_nbytes()}
        if case in DENSE_STEPS:
            res["step"] = dense_step(case, args, mesh)
    for case in DENSE_FAULT_CASES:
        out[case] = {"step": dense_step(case, args, mesh)}
    if mesh is not None and mesh.shape["model"] > 1:
        for fault, case in DENSE_FAULTS.items():
            out[case].setdefault("faults", {})[fault] = dense_step(
                case, args, mesh, fault)
    return out


def scenario_dense(args, tmp):
    """``dense_runs`` on the mesh, or without one (``args["plain"]``: the
    one-device reference)."""
    if args.get("plain"):
        return {"cases": dense_runs(args)}
    return {"cases": dense_runs(args, _mesh(args))}


SCENARIOS = {"train": scenario_train, "checkpoint": scenario_checkpoint,
             "scaling": scenario_scaling, "propagate": scenario_propagate,
             "edgemap": scenario_edgemap, "em_models": scenario_em_models,
             "tgcn_rows": scenario_tgcn_rows, "masks": scenario_masks,
             "dense": scenario_dense}


# ------------------------------------------------------------ the parent

def start_ranks(world: int, scenario: str, args: dict, tmp: str):
    """Start ``scenario`` on ``world`` gloo ranks -> a handle for
    ``wait_ranks``."""
    port = free_port()
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, scenario, tmp, json.dumps(args)],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT), log))
    return {"scenario": scenario, "world": world, "tmp": tmp, "procs": procs}


def wait_ranks(*handles, deadline_s: float = DEADLINE_S):
    """Wait for every rank of ``handles`` -> each handle's results by
    rank.  When a rank fails or the deadline passes, every rank of every
    handle is killed and the ranks' output raised."""
    procs = [p for h in handles for p, _ in h["procs"]]
    end = time.monotonic() + deadline_s
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            failed = "a rank failed"
        elif time.monotonic() > end:
            failed = f"deadline of {deadline_s} s passed"
        else:
            time.sleep(0.05)
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    if failed:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        logs = []
        for h in handles:
            for rank, (p, log) in enumerate(h["procs"]):
                log.seek(0)
                logs.append(f"--- {h['scenario']} rank {rank}/{h['world']} "
                            f"(exit {p.returncode}):\n{log.read()[-3000:]}")
        raise RuntimeError(f"mesh test ranks: {failed}\n" + "\n".join(logs))
    out = []
    for h in handles:
        res = []
        for rank, (_, log) in enumerate(h["procs"]):
            log.close()
            with open(os.path.join(h["tmp"], f"result{rank}.pkl"), "rb") as f:
                res.append(pickle.load(f))
        out.append(res)
    return out


def main():
    scenario, tmp, args = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    torch.set_num_threads(1)
    from tagrec_tpu_torch.parallel import launch

    launch.initialize(device="cpu", timeout=timedelta(seconds=60))
    try:
        result = SCENARIOS[scenario](args, tmp)
        with open(os.path.join(tmp, f"result{launch.rank()}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        launch.shutdown()


if __name__ == "__main__":
    main()
