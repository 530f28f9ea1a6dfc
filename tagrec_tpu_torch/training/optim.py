"""The optimizer (tagrec_tpu/training/optim.py).

The reference trains its two-phase models with ONE ``torch.optim.Adam`` over
all parameters, its grads cleared to None between steps: a parameter that a
phase does not touch has no grad, and Adam skips it, its step count and
moments frozen.  JAX's ``torch_adam`` imitates exactly that; here it is the
thing itself (``adam_impl="torch"``, the default).

``adam_impl="global"`` is JAX's ``optax.adam``: one step count, and every
parameter updated every step.  The same ``torch.optim.Adam`` gives it when
every parameter holds a gradient at every step, a zero one where the phase
does not reach it (``fill_missing_grads``), so that every per-parameter
count advances together.

On the card the Adam is ``capturable``: its step counts live on the device
and its update reads no value back to the host, so a CUDA graph can hold
it.  The Trainer's eager steps on the card use the same Adam, so an eager
and a captured run differ only by the replay.
"""

from __future__ import annotations

from typing import Iterable

import torch

from tagrec_tpu_torch.config import TrainConfig

ADAM_IMPLS = ("torch", "global")


def check_impl(impl: str) -> str:
    if impl not in ADAM_IMPLS:
        raise ValueError(f"unknown adam_impl {impl!r}; known: torch, global")
    return impl


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.Adam:
    """One Adam at ``cfg.lr`` (betas 0.9, 0.999, eps 1e-8) over ``params``,
    ``capturable`` when they lie on the card.

    Callers clear grads with ``zero_grad(set_to_none=True)``; under
    ``cfg.adam_impl == "global"`` they call ``fill_missing_grads`` after
    the backward."""
    check_impl(cfg.adam_impl)
    params = list(params)
    on_card = any(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, lr=cfg.lr, capturable=on_card)


def fill_missing_grads(opt: torch.optim.Optimizer) -> None:
    """Give every parameter of ``opt`` that has no gradient a zero one."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
