"""Composition root (tagrec_tpu/compose.py): each family's model, its
phases and the full-catalog evaluator.  LightGCN and NGCF train one BPR
phase; KGAT BPR over the train interactions, then TransE over the six
tag-graph relations (or, with ``kg=``, over the knowledge graph's
triplets); TGCN BPR, then TransTag over the (user, tag, item)
assignments; DGCF, DisenGCN and DisenHAN the resampling BPR phase, with
the distance-correlation ids.  Every phase steps the Trainer's one Adam.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from tagrec_tpu_torch.config import ModelConfig, TrainConfig
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.ops import sampling
from tagrec_tpu_torch.training.evaluate import Evaluator
from tagrec_tpu_torch.training.train import (PhaseSpec, bpr_phase,
                                             resampling_phase, triple_phase)
from tagrec_tpu_torch.utils import profiling

# the families trained by the resampling phase
RESAMPLED = ("dgcf", "disengcn", "disenhan")
# the families whose graph tables a mesh row-shards over ``model``: the
# adjacency pair, the EdgeMap tier's maps, the kernel and chunked tiers'
# masks (and the KG's relation ids), or TGCN's tables on every tier
GRAPH_SHARDED = ("lightgcn", "ngcf", "dgcf", "disengcn", "disenhan", "kgat",
                 "tgcn")


@dataclass
class Pipeline:
    model: torch.nn.Module
    phases: List[PhaseSpec]
    graph: HeteroGraph
    evaluator: Evaluator


def relation_triples(graph: HeteroGraph) -> np.ndarray:
    """[T, 3] (h, r, t) over the six relations, relation 0..5 in order."""
    rel = graph.relation_edges()
    return np.concatenate([
        np.stack([rel[k][0], np.full(rel[k].shape[1], k, dtype=np.int64),
                  rel[k][1]], axis=1)
        for k in sorted(rel)])


def build_pipeline(graph: HeteroGraph, mcfg: ModelConfig, tcfg: TrainConfig,
                   *, generator: torch.Generator, device="cuda",
                   kg=None, mesh=None) -> Pipeline:
    """The model, its phases and the evaluator on ``device``;
    ``generator`` (CPU) draws the weights.  ``kg``: an optional
    ``data.kg.KnowledgeGraph``, which puts KGAT over the knowledge graph
    (other families ignore it).  ``mesh``: an optional
    ``parallel.Mesh``, which makes the evaluation sharded and gives
    LightGCN and NGCF, the other families on the EdgeMap tier, the
    kernel tiers or the chunked dense tiers (the masks, the KG's
    ``rel_id``), and TGCN, only this rank's rows of their graph tables,
    cut before the upload
    (the Trainer takes the same mesh for training, as JAX's).  Its stages
    are the spans ``build.model``, ``build.pos_table``, ``build.phases``
    and ``build.evaluator`` under ``build_pipeline``."""
    cls = model_class(mcfg.name)
    dev = resolve(device)
    kw = {"kg": kg} if mcfg.name == "kgat" and kg is not None else {}
    if mesh is not None and mcfg.name in GRAPH_SHARDED:
        kw["mesh"] = mesh
    with profiling.span("build_pipeline"):
        with profiling.span("build.model"):
            model = cls(graph, mcfg, generator=generator, device=dev, **kw)
        with profiling.span("build.pos_table"):
            pt = sampling.build_pos_table(graph.user_items["train"],
                                          graph.n_user, graph.n_item,
                                          device=dev)
        with profiling.span("build.phases"):
            phases = _phases(graph, mcfg, tcfg, model, pt, kg, dev)
        with profiling.span("build.evaluator"):
            evaluator = Evaluator(graph, tcfg, mesh=mesh, device=dev)
    return Pipeline(model=model, phases=phases, graph=graph,
                    evaluator=evaluator)


def _phases(graph, mcfg, tcfg, model, pt, kg, dev) -> List[PhaseSpec]:
    """The family's training phases over ``model``."""
    over_kg = mcfg.name == "kgat" and kg is not None
    edges = graph.edge_index["train"]
    if mcfg.name in RESAMPLED:
        def routed_loss_fn(batch, gen):
            return model.bpr_loss(batch["bpr"], cor=batch.get("cor"),
                                  generator=gen)

        # JAX's step count, one more than the batches the edges fill
        steps = len(edges) // tcfg.train_batch + 1
        user_ids = np.asarray(sorted(graph.user_items["train"]),
                              dtype=np.int64)
        cor_sizes = {"user": (mcfg.cor_batch, graph.n_user),
                     "item": (mcfg.cor_batch, graph.n_item)}
        if mcfg.use_tag and graph.has_tags:
            cor_sizes["tag"] = (mcfg.cor_batch, graph.n_tag)
        phases = [resampling_phase(
            "bpr", user_ids, pt, tcfg.train_batch, steps, routed_loss_fn,
            cor_sizes=cor_sizes, neg_rounds=tcfg.neg_resample_rounds)]
    else:
        def bpr_loss_fn(batch, gen):
            return model.bpr_loss(batch, generator=gen)

        phases = [bpr_phase("bpr", edges, pt, tcfg.train_batch, bpr_loss_fn,
                            neg_rounds=tcfg.neg_resample_rounds)]
    if mcfg.name == "kgat":
        def transe_loss_fn(batch, gen):
            return model.transe_loss(batch)

        if over_kg:
            trips, n_rel = kg.all_triplet, kg.num_relation
            n_ids = graph.n_user + kg.num_entity
        else:
            trips, n_rel, n_ids = relation_triples(graph), 6, graph.n_nodes
        phases.append(triple_phase(
            "transe", trips, n_rel, n_ids, mcfg.transe_batch, transe_loss_fn,
            neg_rounds=tcfg.neg_resample_rounds,
            window=mcfg.transe_sampler == "reference_windows", device=dev))
    if mcfg.name == "tgcn":
        # TransTag over (user, tag, item): heads are users, relations tags
        # and tails items
        def transtag_loss_fn(batch, gen):
            return model.transtag_loss(batch)

        phases.append(triple_phase(
            "transtag", graph.uit_data[:, [0, 2, 1]].astype(np.int64),
            graph.n_tag, graph.n_item, mcfg.transtag_batch, transtag_loss_fn,
            neg_rounds=tcfg.neg_resample_rounds, device=dev))
    return phases
