"""Early stopping with best-checkpoint tracking
(tagrec_tpu/training/early_stop.py)."""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from tagrec_tpu_torch.training import checkpoint


class EarlyStop:
    """Tracks ``key`` (NDCG by default) at the FIRST entry of ``topks``
    (quirk #15: @10, not @20), keeps a copy of the parameters and saves a
    checkpoint on each improvement, and stops after ``patience`` evaluations
    without one."""

    def __init__(self, patience: int, key: str = "ndcg",
                 save_path: Optional[str] = None):
        self.patience = patience
        self.key = key
        self.save_path = save_path
        self.best_value = None
        self.best_result: Optional[Dict] = None
        self.best_epoch = 0
        self.best_params: Optional[Dict] = None
        self.count = 0
        # higher is better for the ranking metrics, lower for anything else
        self.higher = key in ("precision", "recall", "ndcg", "hr", "auc")

    def __call__(self, model: nn.Module, results: Dict, epoch: int) -> bool:
        """Record one evaluation of ``model``; True when training should
        stop."""
        cur = results[self.key]
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if (self.best_value is None
                or (cur > self.best_value if self.higher
                    else cur < self.best_value)):
            self.best_value, self.best_result = cur, results
            self.best_epoch, self.count = epoch, 0
            self.best_params = {n: p.detach().clone()
                                for n, p in model.named_parameters()}
            if self.save_path:
                checkpoint.save(self.save_path, model)
        else:
            self.count += 1
        return self.count > self.patience
