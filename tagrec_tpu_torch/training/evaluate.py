"""Full-catalog top-k evaluation, the reference protocol
(tagrec_tpu/training/evaluate.py).

One forward per pass gives the user and item tables; then, per block of
``test_batch`` users: sigmoid(U_sel @ I^T) over every item (or every entity,
for KGAT), the train positives masked to -1024, top-k, recall / precision /
HR / NDCG at each k of ``topks`` and the mean AUC, optionally broken down
into cold-start user groups.  Per-block sums stay on the device and come to
the host once per pass.

Under a (data, model) mesh the item table is row-sharded over ``model``
(``parallel.topk.shard_items``) and each block goes through
``parallel.topk.sharded_eval_metrics``: per-shard scoring, the top-k
merge and the count-based AUC.  Every rank evaluates every user (users
are replicated, as in JAX) and gets the same results.  The last block is
shorter, never padded, on either path.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from tagrec_tpu_torch.config import TrainConfig
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.ops import metrics as M
from tagrec_tpu_torch.parallel import sharding
from tagrec_tpu_torch.parallel import topk as ptopk
from tagrec_tpu_torch.utils import profiling


def _padded(lists: Dict[int, List[int]], n_user: int, fill: int, device):
    """([n_user, P] int64 ids padded with ``fill``, [n_user] int64 counts) on
    ``device``."""
    pad, deg = M.pad_lists(lists, n_user, fill)
    return (torch.as_tensor(pad, dtype=torch.int64, device=device),
            torch.as_tensor(deg, dtype=torch.int64, device=device))


class Evaluator:
    """Evaluates a model's tables on ``device``: the test split, or the
    validation split when ``cfg.has_val`` and not ``istest``.  ``mesh``:
    an optional ``parallel.Mesh``; every rank of it runs ``run`` together
    (its collectives span the ``model`` axis)."""

    def __init__(self, graph: HeteroGraph, cfg: TrainConfig, *, mesh=None,
                 device="cuda"):
        dev = resolve(device)
        self.cfg = cfg
        self.mesh = mesh
        self.pos_ui = graph.user_items["train"]
        self.true_ui = {"test": graph.user_items["test"]}
        if cfg.has_val:
            self.true_ui["val"] = graph.user_items["val"]
        self._train_pad, self._train_deg = _padded(self.pos_ui, graph.n_user,
                                                   M.PAD_ID, dev)
        self._test = {split: _padded(tui, graph.n_user, -1, dev)
                      for split, tui in self.true_ui.items()}

    def run(self, model, istest: bool = False, group_k: int = 0) -> Dict:
        """{metric: [value per k]} plus {"auc": [mean]}; with ``group_k`` > 1,
        one such dict per user group, keyed ``inter<{bound}-{n_users}`` as
        the reference keys them."""
        profiling.count("eval.passes")
        with profiling.span("eval.pass"):
            split = "val" if (not istest and self.cfg.has_val) else "test"
            true_ui = self.true_ui[split]
            with profiling.span("eval.forward"), torch.no_grad(), \
                    sharding.gathered():
                embs = model.forward()
            u_all, i_all = embs[0], embs[1]
            n_valid = None
            if self.mesh is not None:
                i_all, n_valid = ptopk.shard_items(i_all, self.mesh)
            if group_k > 1:
                return {f"inter<{bound}-{len(users)}":
                        self._eval_users(u_all, i_all, split, users, n_valid)
                        for bound, users in user_group_split(
                            true_ui, self.pos_ui, group_k).items()}
            return self._eval_users(u_all, i_all, split, sorted(true_ui),
                                    n_valid)

    def _block(self, u_all, i_all, u, test_pad, test_deg, n_valid):
        """One block's sums, on one device or over the mesh's shards."""
        topks = tuple(self.cfg.topks)
        te, td = test_pad[u], test_deg[u]
        if self.mesh is not None:
            return ptopk.sharded_eval_metrics(
                u_all[u], i_all, self._train_pad[u], te, td,
                self._train_deg[u], topks, self.mesh, n_valid=n_valid)
        scores = torch.sigmoid(u_all[u] @ i_all.T)
        with profiling.span("eval.sync"):  # its boolean index waits
            masked = M.mask_train_positives(scores, self._train_pad[u])
        top = torch.topk(masked, max(topks), dim=1).indices
        block = M.batch_metric_sums(M.hit_labels(top, te), td, topks)
        block["auc"] = M.batch_auc_sum(masked, te, td,
                                       self._train_deg[u])[None]
        return block

    @torch.no_grad()
    def _eval_users(self, u_all, i_all, split: str, users: List[int],
                    n_valid=None) -> Dict:
        topks = tuple(self.cfg.topks)
        test_pad, test_deg = self._test[split]
        users_t = torch.as_tensor(np.asarray(users, dtype=np.int64),
                                  device=u_all.device)
        sums = []
        profiling.count("eval.users", len(users))
        for i in range(0, len(users), self.cfg.test_batch):
            u = users_t[i:i + self.cfg.test_batch]
            profiling.count("eval.blocks")
            with profiling.span("eval.block", users=len(u)):
                block = self._block(u_all, i_all, u, test_pad, test_deg,
                                    n_valid)
                sums.append(torch.cat([block[k] for k in
                                       ("recall", "precision", "hr", "ndcg",
                                        "auc")]))
        # one transfer per pass; blocks summed in order in float32, as JAX
        acc = np.zeros(4 * len(topks) + 1, dtype=np.float32)
        with profiling.span("eval.sync"):
            rows = torch.stack(sums).cpu().numpy()
        for row in rows:
            acc += row
        n, nk = len(users), len(topks)
        out = {name: [float(v) / n for v in acc[j * nk:(j + 1) * nk]]
               for j, name in enumerate(("recall", "precision", "hr", "ndcg"))}
        out["auc"] = [float(acc[-1] / n)]
        return out


MEASURES = ("interaction", "user", "interval", "degree")


def user_group_split(test_ui: Dict[int, List[int]],
                     train_ui: Dict[int, List[int]],
                     k: int, method: str = "interaction") -> Dict[int, List[int]]:
    """Cold-start user groups (the reference's training/utils.py:58-109).

    Test users are ordered by their interaction count n (train + test) and
    cut into about ``k`` groups of equal measure; a group is keyed by the
    largest n it holds.  A group closes at the first n whose measure
    reaches the next of the bounds total/k, 2 total/k, ..., total (integer
    steps).  The reference's four measures, running over the sorted n:

    * "interaction" (the default, what ``Evaluator.run`` cuts by): the
      interactions of the users so far;
    * "user": the users so far;
    * "interval": n itself;
    * "degree": the distinct n so far."""
    by_n = defaultdict(list)
    for u, items in test_ui.items():
        by_n[len(items) + len(train_ui.get(u, ()))].append(u)
    ns = sorted(by_n)
    if method == "interaction":
        measure = np.cumsum([n * len(by_n[n]) for n in ns])
    elif method == "user":
        measure = np.cumsum([len(by_n[n]) for n in ns])
    elif method == "interval":
        measure = np.asarray(ns)
    elif method == "degree":
        measure = np.arange(1, len(ns) + 1)
    else:
        raise ValueError(f"unknown measure {method!r}; known: {MEASURES}")
    total = int(measure[-1])
    step = total // k if k >= 1 else 0
    if step < 1:
        raise ValueError(f"cannot cut a measure of {total} into {k} groups")
    bounds = list(range(step, total + 1, step))
    bounds[-1] = total
    groups, pending, nxt = {}, [], 0
    for n, m in zip(ns, measure):
        pending += by_n[n]
        if nxt < len(bounds) and m >= bounds[nxt]:
            groups[n], pending, nxt = pending, [], nxt + 1
    return groups
