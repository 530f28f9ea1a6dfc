"""Composition root (tagrec_tpu/compose.py), cut to the families the port
trains: LightGCN and NGCF (one BPR phase), KGAT (BPR over the train
interactions and TransE over the six tag-graph relations, both stepping
the Trainer's one Adam), and DGCF, DisenGCN and DisenHAN (the resampling
BPR phase, with the distance-correlation ids), each with the full-catalog
evaluator.
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

TRAINED = ("dgcf", "disengcn", "disenhan", "kgat", "lightgcn", "ngcf")
# the families still to port, with their ROADMAP.md labels
NOT_PORTED = {"tgcn": "A16"}
# the families trained by the resampling phase
RESAMPLED = ("dgcf", "disengcn", "disenhan")


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
                   *, generator: torch.Generator, device="cuda") -> Pipeline:
    """The model, its phases and the evaluator on ``device``;
    ``generator`` (CPU) draws the weights."""
    if mcfg.name not in TRAINED:
        label = NOT_PORTED.get(mcfg.name)
        raise NotImplementedError(
            f"training {mcfg.name!r} is not ported: the port trains "
            f"{', '.join(TRAINED)}"
            + (f" ({mcfg.name} is ROADMAP.md {label})" if label else ""))
    dev = resolve(device)
    model = model_class(mcfg.name)(graph, mcfg, generator=generator,
                                   device=dev)
    pt = sampling.build_pos_table(graph.user_items["train"], graph.n_user,
                                  graph.n_item, device=dev)
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

        phases.append(triple_phase(
            "transe", relation_triples(graph), 6, graph.n_nodes,
            mcfg.transe_batch, transe_loss_fn,
            neg_rounds=tcfg.neg_resample_rounds,
            window=mcfg.transe_sampler == "reference_windows", device=dev))
    return Pipeline(model=model, phases=phases, graph=graph,
                    evaluator=Evaluator(graph, tcfg, device=dev))
