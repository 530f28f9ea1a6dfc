"""Multi-phase training loop (tagrec_tpu/training/train.py).

An epoch runs the model's phases in order (BPR for LightGCN; BPR, then
TransE for KGAT; DGCF and DisenGCN's resampling BPR), all stepping ONE
shared Adam.  Batches have fixed shapes: steps = E // batch and the
remainder is dropped (the resampling phase takes its step count from the
caller).  Sampling (shuffles,
negatives) runs on the tables' device from one ``torch.Generator``.  The
step loop is plain Python; a step ends without a host sync, and the losses
come back to the host once per phase.  ``Trainer.run`` adds the periodic
evaluation, the early stop, the metrics stream and the train-state file
that a run resumes from.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tagrec_tpu_torch.config import TrainConfig
from tagrec_tpu_torch.ops import sampling
from tagrec_tpu_torch.training import checkpoint, optim


@dataclass
class PhaseSpec:
    """One training phase.

    epoch_reset(gen, data)           -> epoch state (e.g. shuffled edges)
    make_batch(gen, i, state, data)  -> the batch of step i
    loss_fn(batch, gen)              -> tuple of scalar loss terms, summed for
                                        the gradient and logged apart
    """

    name: str
    steps_per_epoch: int
    epoch_reset: Callable
    make_batch: Callable
    loss_fn: Callable
    data: object = None


def bpr_phase(name: str, edges: np.ndarray, pos_table: sampling.PosTable,
              batch: int, loss_fn, neg_rounds: int = 16) -> PhaseSpec:
    """BPR over all train interactions: each epoch shuffles every (u, i+)
    pair and pairs each with one uniform negative outside the user's
    positives."""
    batch = min(batch, len(edges))  # tiny datasets: one full batch
    steps = max(len(edges) // batch, 1)
    data = {"edges": torch.as_tensor(np.asarray(edges, dtype=np.int64),
                                     device=pos_table.table.device),
            "pt": pos_table}

    def epoch_reset(gen, data):
        e = data["edges"]
        return e[torch.randperm(e.shape[0], generator=gen, device=e.device)]

    def make_batch(gen, i, shuffled, data):
        sl = shuffled[i * batch:(i + 1) * batch]
        users, pos = sl[:, 0], sl[:, 1]
        neg = sampling.sample_negatives(gen, data["pt"], users,
                                        rounds=neg_rounds)
        return torch.stack([users, pos, neg], dim=1)

    return PhaseSpec(name, steps, epoch_reset, make_batch, loss_fn, data)


def resampling_phase(name: str, user_ids: np.ndarray,
                     pos_table: sampling.PosTable, batch: int, steps: int,
                     loss_fn, cor_sizes: Optional[Dict[str, tuple]] = None,
                     neg_rounds: int = 16) -> PhaseSpec:
    """The DGCF family's phase: every step draws ``batch`` users of
    ``user_ids``, one positive and one negative each -> {"bpr": [B, 3]},
    and, per entry ``name: (n, hi)`` of ``cor_sizes``, n ids below hi for
    the distance-correlation term -> {"cor": {name: [n]}}.

    Users are drawn without replacement within a batch only when
    ``len(user_ids) > batch``, a strict inequality (at equality the
    reference draws with replacement, a quirk kept on purpose), with
    replacement otherwise."""
    cor_sizes = cor_sizes or {}
    n_users = len(user_ids)
    without_replacement = n_users > batch
    device = pos_table.table.device
    data = {"users": torch.as_tensor(np.asarray(user_ids, dtype=np.int64),
                                     device=device),
            "pt": pos_table}

    def epoch_reset(gen, data):
        return None  # stateless

    def make_batch(gen, i, _, data):
        if without_replacement:
            sel = torch.randperm(n_users, generator=gen,
                                 device=device)[:batch]
        else:
            sel = torch.randint(0, n_users, (batch,), generator=gen,
                                device=device)
        users = data["users"][sel]
        pos = sampling.sample_positive(gen, data["pt"], users)
        neg = sampling.sample_negatives(gen, data["pt"], users,
                                        rounds=neg_rounds)
        out = {"bpr": torch.stack([users, pos, neg], dim=1)}
        if cor_sizes:
            out["cor"] = {key: torch.randint(0, hi, (nb,), generator=gen,
                                             device=device)
                          for key, (nb, hi) in cor_sizes.items()}
        return out

    return PhaseSpec(name, steps, epoch_reset, make_batch, loss_fn, data)


def triple_phase(name: str, triples: np.ndarray, n_rel: int, n_ids: int,
                 batch: int, loss_fn, neg_rounds: int = 16,
                 window: bool = False, device="cuda") -> PhaseSpec:
    """TransE phase over (h, r, t) triples; each batch draws a corrupted tail
    outside the observed (h, r, *) set.

    ``window=False``: each epoch shuffles all triples and takes disjoint
    batches.  ``window=True`` reproduces the reference KGAT sampler (quirk
    #5): the triples are never shuffled, and step i trains on
    ``triples[i : i + batch]``, i stepping by one, for ``len // batch``
    steps."""
    ts, keys = sampling.build_triple_set(triples, n_rel, n_ids, device=device)
    batch = min(batch, len(triples))  # tiny datasets: one full batch
    steps = max(len(triples) // batch, 1)
    data = {"trips": torch.as_tensor(np.asarray(triples, dtype=np.int64),
                                     device=device),
            "keys": keys, "ts": ts}

    def epoch_reset(gen, data):
        if window:  # quirk #5: no shuffle, ever
            return data["trips"], data["keys"]
        perm = torch.randperm(data["trips"].shape[0], generator=gen,
                              device=data["trips"].device)
        return data["trips"][perm], data["keys"][perm]

    def make_batch(gen, i, state, data):
        trips, tkeys = state
        start = i if window else i * batch
        neg = sampling.sample_negatives_from_set(
            gen, data["ts"], tkeys[start:start + batch], rounds=neg_rounds)
        return torch.cat([trips[start:start + batch], neg[:, None]], dim=1)

    return PhaseSpec(name, steps, epoch_reset, make_batch, loss_fn, data)


class Trainer:
    """Steps ``phases`` in order over one Adam on ``model``'s parameters,
    drawing every sample from ``generator``."""

    def __init__(self, model: torch.nn.Module, phases: List[PhaseSpec],
                 cfg: TrainConfig, *, generator: torch.Generator, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "SPMD training needs the parallel port (ROADMAP.md A18)")
        self.model = model
        self.phases = phases
        self.cfg = cfg
        self.generator = generator
        self.opt = optim.make_optimizer(model.parameters(), cfg)

    def step(self, phase: PhaseSpec, batch) -> torch.Tensor:
        """One optimizer step on ``batch`` -> the loss terms [n_terms]."""
        self.opt.zero_grad(set_to_none=True)
        parts = phase.loss_fn(batch, self.generator)
        sum(parts).backward()
        if self.cfg.adam_impl == "global":
            optim.fill_missing_grads(self.opt)
        self.opt.step()
        return torch.stack([p.detach() for p in parts])

    def run_phase(self, phase: PhaseSpec, max_steps: Optional[int] = None,
                  on_step: Optional[Callable] = None) -> np.ndarray:
        """One epoch of ``phase``, cut to ``max_steps`` steps when given ->
        the loss terms [steps, n_terms]; raises on a non-finite loss.
        ``on_step(i, parts)``, when given, runs after each step."""
        state = phase.epoch_reset(self.generator, phase.data)
        steps = phase.steps_per_epoch
        if max_steps is not None:
            steps = min(steps, max_steps)
        parts = []
        for i in range(steps):
            parts.append(self.step(phase, phase.make_batch(
                self.generator, i, state, phase.data)))
            if on_step is not None:
                on_step(i, parts[-1])
        parts = torch.stack(parts).cpu().numpy()
        if not np.isfinite(parts).all():
            raise FloatingPointError(f"non-finite loss in phase {phase.name}")
        return parts

    def run_epoch(self, max_steps: Optional[int] = None):
        """Every phase in order -> {phase name: loss terms [steps, n]}."""
        return {ph.name: self.run_phase(ph, max_steps) for ph in self.phases}

    def run(self, evaluator, early_stop, *, log=print, metrics=None,
            state_path: Optional[str] = None) -> Dict:
        """``cfg.epochs`` epochs of every phase, an evaluation after every
        ``cfg.test_interval``-th epoch (epoch 0 first) fed to ``early_stop``,
        which may end the run.  -> {"best_epoch", "best_result"}; the model
        keeps the last epoch's parameters, ``early_stop.best_params`` the
        best ones.

        ``metrics``: an optional ``utils.MetricsWriter``, given each phase's
        mean loss and time and each evaluation's results.  ``state_path``: a
        train-state file, written at every evaluation (the epoch to resume
        at, the parameters and Adam's state) and restored first when it
        exists.  A non-finite loss raises FloatingPointError naming the
        epoch, the phase and the last saved state."""
        cfg = self.cfg
        start_ep = 0
        if state_path and os.path.exists(state_path):
            start_ep = checkpoint.restore_train_state(
                state_path, self.model, self.opt, cfg.adam_impl)
            log(f"resumed from {state_path} at epoch {start_ep}")
        for ep in range(start_ep, cfg.epochs):
            for pi, phase in enumerate(self.phases):
                t0 = time.time()
                try:
                    parts = self.run_phase(phase)
                except FloatingPointError:
                    # the epoch has already corrupted the parameters: stop;
                    # the last eval-time state is the recovery point
                    msg = (f"non-finite loss in epoch {ep} phase "
                           f"{phase.name}; last saved state: "
                           f"{state_path or '(none)'}")
                    log(f"FATAL: {msg}")
                    raise FloatingPointError(msg) from None
                dt = time.time() - t0
                log(f"[Epoch:{ep}][{phase.name}][{dt:.2f}s] "
                    f"avg_loss: {parts.sum(axis=1).mean():.5f} "
                    f"parts_sum: {[float(v) for v in parts.sum(axis=0)]}")
                if metrics is not None:
                    metrics.scalars(ep, {
                        f"train/loss_{pi}": float(parts.sum(axis=1).mean()),
                        f"train/epoch_time_{pi}": dt})
            if ep % cfg.test_interval == 0:
                t0 = time.time()
                results = evaluator.run(self.model)
                log(f"[Epoch {ep}][eval {time.time() - t0:.2f}s] {results}")
                if metrics is not None:
                    metrics.results(ep, results, cfg.topks)
                if state_path:
                    checkpoint.save_train_state(state_path, self.model,
                                                self.opt, ep + 1,
                                                cfg.adam_impl)
                if early_stop(self.model, results, ep):
                    log(f"early stop trigger at epoch {ep}")
                    break
        log(f"best result [{early_stop.best_epoch}:{early_stop.best_result}]")
        return {"best_epoch": early_stop.best_epoch,
                "best_result": early_stop.best_result}
