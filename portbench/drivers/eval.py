"""The evaluation window: full-catalog passes of the port's ``Evaluator``
over every test user, one after another, each ending when its metrics are
read back.

Set-up builds the graph, ``compose.build_pipeline`` (its evaluator) and
the leaves drawn from the seed, and runs one pass, which warms the shapes.
The window repeats ``Evaluator.run(model)`` until ``--seconds`` have
passed: test users evaluated over its wall time, whole passes only.  Each
block's top-k ids are kept as the evaluator hands them to
``ops.metrics.hit_labels`` (a reference held, no copy), so the last pass's
lists and the metrics and AUC it returns are what the reference judges.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

from portbench import common, graphs
from portbench.reference import _eval
from portbench.reference._common import Precision


def _record_topk(tops: list):
    """Wrap ``ops.metrics.hit_labels`` so that each block's top-k ids are
    appended to ``tops``; returns the function that undoes it."""
    from tagrec_tpu_torch.ops import metrics

    inner = metrics.hit_labels

    def hit_labels(topk_ids, test_pad):
        tops.append(topk_ids)
        return inner(topk_ids, test_pad)

    metrics.hit_labels = hit_labels
    return lambda: setattr(metrics, "hit_labels", inner)


def build(ctx) -> dict:
    from tagrec_tpu_torch.compose import build_pipeline
    from tagrec_tpu_torch.config import TrainConfig

    cfg, mix, dev = ctx.config, ctx.mix, torch.device(ctx.device)
    t_graph = time.perf_counter()
    raw = graphs.make(**mix["graph"])
    tcfg = TrainConfig(test_batch=mix["test_batch"],
                       topks=tuple(mix["topks"]), lr=cfg["lr"])
    common.sync(dev)
    t0 = time.perf_counter()
    hetero = graphs.to_hetero(raw)
    pipe = build_pipeline(hetero, common.model_config(cfg), tcfg,
                          generator=torch.Generator().manual_seed(ctx.seed),
                          device=dev)
    common.sync(dev)
    build_s = time.perf_counter() - t0
    ref = ctx.reference()
    specs = ref.leaves(raw, cfg)
    common.load_leaves(pipe.model, specs,
                       common.draw_leaves(specs, ctx.seed, dev))
    tops: list = []
    undo = _record_topk(tops)
    t_warm = time.perf_counter()
    pipe.evaluator.run(pipe.model)
    stages = {"to_graph_s": t_graph - ctx.t_start, "graph_s": t0 - t_graph,
              "build_s": build_s, "leaves_s": t_warm - t0 - build_s,
              "warm_pass_s": time.perf_counter() - t_warm}
    return {"raw": raw, "pipe": pipe, "tops": tops, "undo": undo,
            "build_s": build_s, "users": len(hetero.user_items["test"]),
            "stages": stages}


def _pass(state: dict):
    state["tops"].clear()
    with record_function("Evaluator.run"):
        return state["pipe"].evaluator.run(state["pipe"].model)


def window(state: dict, seconds: float) -> dict:
    ends = []
    t0 = time.perf_counter()
    while True:
        result = _pass(state)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    passes = len(ends)
    return {"seconds": ends[-1], "passes": passes, "pass_ends_s": ends,
            "users": passes * state["users"], "result": result,
            "tops": torch.cat(state["tops"]).cpu().numpy()}


def trace(ctx, state: dict, win: dict) -> dict:
    model = state["pipe"].model
    out = {"driver": "eval", "build_s": state["build_s"],
           "window": {k: win[k] for k in ("seconds", "passes", "users")},
           "pass_flops": ctx.counts().eval_flops(
               state["raw"], ctx.config, state["users"]), "kernels": {}}
    inner = model.forward

    def forward(*a, **k):
        with record_function("forward"):
            return inner(*a, **k)

    model.forward = forward
    try:
        _, out["profile"] = common.profiled(lambda: _pass(state),
                                            "Evaluator.run")
    finally:
        del model.forward
    return out


def compare(prog: dict, ref: dict, raw, mix: dict) -> dict:
    """The numbers that decide ``correct``, of the last pass:
    ``topk_diff``, the share of test users whose top-k list (ids in order)
    differs from the reference's; ``metric_gap``, the worst relative gap
    of a recall, precision, HR or NDCG value to the same metric worked
    out in float64 from the program's own lists, so that the hits are
    exact and only the arithmetic is judged; ``auc_gap``, the AUC's
    relative gap to the reference's.  A gap is over the larger of the
    value and 1 / users, one user's whole share."""
    res = prog["result"]
    judged = _eval.metrics_of(torch.as_tensor(prog["tops"]), raw.test,
                              raw.n_item, mix["topks"], mix["test_batch"])
    floor = 1.0 / len(prog["tops"])
    metric_gap = max(abs(res[m][j] - v) / max(abs(v), floor)
                     for m, vals in judged.items()
                     for j, v in enumerate(vals))
    auc = ref["result"]["auc"][0]
    return {"topk_diff": float(np.mean(np.any(prog["tops"] != ref["tops"],
                                              axis=1))),
            "metric_gap": metric_gap,
            "auc_gap": abs(res["auc"][0] - auc) / max(abs(auc), floor)}


def reference_run(ctx, raw, mode: str) -> dict:
    ref = ctx.reference()
    specs = ref.leaves(raw, ctx.config)
    w = common.draw_leaves(specs, ctx.seed, ctx.device)
    prec = Precision(mode)
    users, items = ref.final_tables(raw, ctx.config, w, prec, ctx.device)
    tops, result = _eval.evaluate(users, items, raw.train, raw.test,
                                  ctx.mix["topks"], ctx.mix["test_batch"],
                                  prec)
    return {"tops": tops, "result": result}


def run(ctx) -> dict:
    state = build(ctx)
    t_window = time.perf_counter()
    host = {"before": common.host_state(), "cpu_s": time.process_time()}
    win = window(state, ctx.seconds)
    card = common.card_state()  # just after the window
    host.update(cpu_s=time.process_time() - host["cpu_s"],
                after=common.host_state())
    on_card = torch.device(ctx.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr = trace(ctx, state, win) if ctx.trace else None
    state["undo"]()
    raw, stages = state["raw"], state["stages"]
    del state
    if on_card:
        torch.cuda.empty_cache()
    numbers = compare(win, reference_run(ctx, raw, "ref"), raw, ctx.mix)
    ends = win["pass_ends_s"]
    gaps = [b - a for a, b in zip([0.0] + ends, ends)]
    notes = {"set-up": stages, "pass s min/median/max": [
        min(gaps), sorted(gaps)[len(gaps) // 2], max(gaps)], "card": card,
        "host": host}
    return {"attempted": win["users"], "failed": 0, "notes": notes,
            "e2e": {"setup_s": t_window - ctx.t_start,
                    "eval_users_per_s": win["users"] / win["seconds"]},
            "trace": tr, "checks": numbers, "memory_peak_bytes": peak}
