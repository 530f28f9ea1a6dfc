"""Shared by test_torch_dgcf_training.py and test_torch_disengcn.py: one
model of the DGCF family trained on the CPU by the JAX package and by the
port, from the same params on the same batches.

JAX draws the batches with its own resampling phase (``make_batch``) and
steps ``torch_adam`` under jit (its Pallas kernels in interpret mode); the
port gets JAX's params through ``params_from_jax`` and the same batches,
and steps its Trainer's torch Adam.  TF32 stays off on the port's side.
"""

import numpy as np
import jax
import optax
import torch

from tagrec_tpu import compose as jcompose
from tagrec_tpu.config import TrainConfig as JaxTrainConfig
from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.training import optim as joptim
from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.checkpoint import params_from_jax
from tagrec_tpu_torch.training.train import Trainer

TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
BATCH, STEPS = 32, 3


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_trajectory(graph, name, cfg):
    """JAX's ``STEPS`` Adam steps of ``name`` from its init params on the
    batches of its resampling phase -> {"params", "batches", "steps"
    (steps_per_epoch), "parts" and "grads" (named) of the first step,
    "losses" of every step, "counts" (torch_adam's per-leaf step counts),
    "forward" (the init params' forward tables)}."""
    pipe = jcompose.build_pipeline(graph, jax_preset(name, **cfg),
                                   JaxTrainConfig(train_batch=BATCH))
    model, gdev, (phase,) = pipe.model, pipe.gdev, pipe.phases
    make_batch = jax.jit(phase.make_batch)
    batches = [make_batch(jax.random.PRNGKey(i), i, None, phase.data)
               for i in range(STEPS)]
    params = model.init(jax.random.PRNGKey(0))
    opt = joptim.torch_adam(JaxTrainConfig().lr)

    @jax.jit
    def step(p, s, batch):
        def total(q):
            parts = model.bpr_loss(q, gdev, batch["bpr"],
                                   cor=batch.get("cor"))
            return sum(parts), parts

        (_, parts), grads = jax.value_and_grad(total, has_aux=True)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, parts, grads

    p, s, losses = params, opt.init(params), []
    for i, b in enumerate(batches):
        p, s, parts, grads = step(p, s, b)
        losses.append(float(sum(parts)))
        if i == 0:
            first = ([float(x) for x in parts],
                     dict(checkpoint._leaves(numpy_tree(grads))))
    return {"params": numpy_tree(params), "batches": numpy_tree(batches),
            "steps": phase.steps_per_epoch, "parts": first[0],
            "grads": first[1], "losses": losses,
            "counts": {k: int(v) for k, v in
                       checkpoint._leaves(numpy_tree(s.count))},
            "forward": [np.asarray(e) for e in jax.jit(
                lambda q: model.forward(q, gdev, training=False))(params)]}


def torch_batch(batch):
    """A JAX batch dict as the port's (int64 tensors)."""
    out = {"bpr": torch.from_numpy(batch["bpr"].astype(np.int64))}
    if "cor" in batch:
        out["cor"] = {k: torch.from_numpy(v.astype(np.int64))
                      for k, v in batch["cor"].items()}
    return out


def port_pipeline(name, cfg, params=None):
    """The port's pipeline and Trainer for ``name`` on the tiny graph, on
    the CPU; JAX's ``params`` copied in when given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig(train_batch=BATCH)
    pipe = build_pipeline(graph, model_preset(name, **cfg), tcfg,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    if params is not None:
        params_from_jax(pipe.model, params)
    trainer = Trainer(pipe.model, pipe.phases, tcfg,
                      generator=torch.Generator().manual_seed(0))
    return pipe, trainer


def first_step(model, batch):
    """The port's loss parts and named gradients on one JAX batch."""
    b = torch_batch(batch)
    parts = model.bpr_loss(b["bpr"], cor=b.get("cor"))
    model.zero_grad(set_to_none=True)
    sum(parts).backward()
    return ([float(x.detach()) for x in parts],
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def trajectory(pipe, trainer, batches):
    """The port's Trainer steps on JAX's batches -> (summed losses, Adam's
    per-parameter step counts)."""
    (phase,) = pipe.phases
    losses = [float(trainer.step(phase, torch_batch(b)).sum())
              for b in batches]
    state = trainer.opt.state
    return losses, {n: int(state[p]["step"]) if p in state else 0
                    for n, p in pipe.model.named_parameters()}
