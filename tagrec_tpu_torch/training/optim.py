"""The optimizer (tagrec_tpu/training/optim.py).

The reference trains its two-phase models with ONE ``torch.optim.Adam`` over
all parameters, its grads cleared to None between steps: a parameter that a
phase does not touch has no grad, and Adam skips it, its step count and
moments frozen.  JAX's ``torch_adam`` imitates exactly that; here it is the
thing itself.
"""

from __future__ import annotations

from typing import Iterable

import torch

from tagrec_tpu_torch.config import TrainConfig


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.Adam:
    """One Adam at ``cfg.lr`` (betas 0.9, 0.999, eps 1e-8) over ``params``.

    Callers clear grads with ``zero_grad(set_to_none=True)``.  Only
    ``adam_impl="torch"`` exists here: JAX's ``"global"`` (optax.adam's one
    step count) is not ported."""
    if cfg.adam_impl != "torch":
        raise NotImplementedError(
            f"adam_impl={cfg.adam_impl!r}: the port has torch's Adam only")
    return torch.optim.Adam(params, lr=cfg.lr)
