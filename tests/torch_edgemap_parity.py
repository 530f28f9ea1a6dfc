"""Shared by test_torch_edgemap_models.py and
test_torch_edgemap_disenhan_tgcn.py: one model's EdgeMap tier
(``adj_mode="ell"``) on the CPU against JAX's EdgeMap tier, and against
the port's own dense tier.

JAX's params are carried across with ``params_from_jax`` (the tiers share
one parameter tree); TGCN gets JAX's neighbour tables.  The forward tables
at rtol 1e-4, atol 1e-5; the BPR loss parts (and KGAT's TransE, TGCN's
TransTag) at rtol 1e-4 and every gradient at rtol 5e-4, atol 1e-5.  JAX's
forward and gradients are one jitted program per model, its device data
an argument.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tagrec_tpu.config import model_preset as jax_preset
from tagrec_tpu.data.kg import KnowledgeGraph as JaxKG
from tagrec_tpu.models import MODEL_REGISTRY as JAX_MODELS
from tagrec_tpu_torch.config import model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.data.kg import KnowledgeGraph
from tagrec_tpu_torch.models import model_class
from tagrec_tpu_torch.training import checkpoint

RTOL, ATOL, GRAD_RTOL = 1e-4, 1e-5, 5e-4
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)  # = tiny_graph
KG = dict(n_entity=120, n_triples=400, n_rela=3, seed=0)
NARROW = dict(dim_latent=16, dim_layer_list=(16, 8))
# case -> (model, config, over a KG with parallel edges)
CASES = {
    "dgcf": ("dgcf", dict(dim_layer_list=(64, 64)), False),
    "disengcn": ("disengcn", dict(dim_layer_list=(64, 64), reg=1e-3),
                 False),
    "disenhan": ("disenhan", dict(dim_layer_list=(64,), reg=1e-3), False),
    "kgat": ("kgat", dict(agg_type="bi_inter", **NARROW, dim_relation=16,
                          reg=1e-4, cor_reg=1e-4), False),
    "kgat_kg": ("kgat", dict(agg_type="bi_inter", **NARROW,
                             dim_relation=16, reg=1e-4, cor_reg=1e-4), True),
    "tgcn": ("tgcn", dict(**NARROW, reg=1e-3), False),
}
# the second loss of the two-phase models
SECOND = {"kgat": "transe_loss", "tgcn": "transtag_loss"}


def _parallel(kg):
    """``kg`` with one (h, t) pair under a second relation: the
    relation-dense tier cannot hold it."""
    h, r, t = kg.kg_data[0]
    kg.kg_data = np.concatenate([kg.kg_data,
                                 [[h, (r + 1) % kg.num_rela, t]]])
    kg._finish_init()
    return kg


def _batches(graph, name, kg):
    rng = np.random.default_rng(5)
    bpr = np.stack([rng.integers(0, graph.n_user, 48),
                    rng.integers(0, graph.n_item, 48),
                    rng.integers(0, graph.n_item, 48)], axis=1)
    second = None
    if name == "kgat":
        n_node = graph.n_user + (kg.num_entity if kg is not None
                                 else graph.n_item + graph.n_tag)
        n_rel = kg.num_relation if kg is not None else 6
        second = np.stack([rng.integers(0, n_node, 64),
                           rng.integers(0, n_rel, 64),
                           rng.integers(0, n_node, 64),
                           rng.integers(0, n_node, 64)], axis=1)
    elif name == "tgcn":
        second = np.stack([rng.integers(0, graph.n_user, 64),
                           rng.integers(0, graph.n_tag, 64),
                           rng.integers(0, graph.n_item, 64),
                           rng.integers(0, graph.n_item, 64)], axis=1)
    return bpr.astype(np.int64), second


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_runs(tiny_graph):
    """case -> JAX's EdgeMap-tier run: params, forward, the BPR (and second
    loss's) parts and grads, TGCN's tables; computed once per case."""
    done = {}

    def run(case):
        if case in done:
            return done[case]
        name, cfg, with_kg = CASES[case]
        kw = {}
        kg = None
        if with_kg:
            kg = _parallel(KnowledgeGraph.synthetic(
                tsyn.synthetic_graph(**TINY), **KG))
            kw["kg"] = _parallel(JaxKG.synthetic(tiny_graph, **KG))
        model = JAX_MODELS[name](tiny_graph, jax_preset(name, adj_mode="ell",
                                                        **cfg), **kw)
        gdev = model.device_data()
        assert "em" in gdev or "ems" in gdev
        params = model.init(jax.random.PRNGKey(0))
        bpr, second = _batches(tiny_graph, name, kg)
        losses = [(model.bpr_loss, bpr)]
        if second is not None:
            losses.append((getattr(model, SECOND[name]), second))

        @jax.jit
        def all_runs(p, g, batches):
            """The forward, and each loss's parts and gradients: one
            program, the device data an argument (not a constant)."""
            runs = []
            for (loss_fn, _), b in zip(losses, batches):
                def total(q):
                    parts = loss_fn(q, g, b)
                    return sum(parts), parts

                (_, parts), grads = jax.value_and_grad(total,
                                                       has_aux=True)(p)
                runs.append((parts, grads))
            return model.forward(p, g), runs

        fwd, runs = all_runs(params, gdev, [jnp.asarray(b, jnp.int32)
                                            for _, b in losses])
        out = {"params": _np(params), "kg": kg, "bpr": bpr,
               "second": second, "forward": [np.asarray(e) for e in fwd]}
        for key, (parts, grads) in zip(("bpr_run", "second_run"), runs):
            out[key] = ([float(x) for x in parts],
                        dict(checkpoint._leaves(_np(grads))))
        if name == "tgcn":
            out["tables"] = model._tables
        done[case] = out
        return out
    return run


def _port(case, run, adj_mode="ell", dtype=torch.float32):
    name, cfg, _ = CASES[case]
    kw = {"kg": run["kg"]} if run["kg"] is not None else {}
    if name == "tgcn":
        kw["tables"] = run["tables"]
    model = model_class(name)(tsyn.synthetic_graph(**TINY),
                              model_preset(name, adj_mode=adj_mode, **cfg),
                              device="cpu",
                              generator=torch.Generator().manual_seed(1),
                              **kw)
    checkpoint.params_from_jax(model, run["params"])
    return model.to(dtype)


def _parts_grads(model, loss_fn, batch):
    model.zero_grad(set_to_none=True)
    parts = loss_fn(torch.from_numpy(batch))
    sum(parts).backward()
    return ([float(x.detach()) for x in parts],
            {n: p.grad.double().numpy() for n, p in model.named_parameters()
             if p.grad is not None})


def _hold(got, want, rtol, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=rtol,
                                   atol=atol)


def check_equals_jax(jax_run, case):
    run = jax_run(case)
    model = _port(case, run)
    assert model.tier == "ell"
    assert not [n for n, _ in model.named_buffers()
                if n.startswith("mask") or n == "rel_id"]
    with torch.no_grad():
        got = model.forward()
    assert len(got) == len(run["forward"])
    _hold([t.numpy() for t in got], run["forward"], RTOL, ATOL)
    runs = [("bpr", model.bpr_loss)]
    if run["second"] is not None:
        runs.append(("second", getattr(model, SECOND[CASES[case][0]])))
    for key, fn in runs:
        parts, grads = _parts_grads(model, fn, run[key])
        want_parts, want_grads = run[f"{key}_run"]
        np.testing.assert_allclose(parts, want_parts, rtol=RTOL, atol=1e-7)
        assert grads.keys() <= want_grads.keys()
        for name, g in grads.items():
            np.testing.assert_allclose(g, want_grads[name], rtol=GRAD_RTOL,
                                       atol=ATOL, err_msg=name)
        assert any(np.abs(g).max() > 0 for g in grads.values())


# the port's own tier beside its EdgeMap tier: the chunked dense tier,
# and TGCN's default tier (``auto``, its dedup buckets)
DENSE_MODE = {"tgcn": "auto"}


def check_equals_the_dense_tier(jax_run, case):
    """The port's EdgeMap tier against its dense tier in float64 on the
    same weights: the forward, and the BPR gradients of every
    parameter."""
    run = jax_run(case)
    outs = []
    for mode in ("ell", DENSE_MODE.get(case, "dense_xla")):
        model = _port(case, run, mode, torch.float64)
        with torch.no_grad():
            fwd = [t.numpy() for t in model.forward()]
        outs.append((fwd, _parts_grads(model, model.bpr_loss, run["bpr"])))
    (f_ell, (p_ell, g_ell)), (f_dense, (p_dense, g_dense)) = outs
    _hold(f_ell, f_dense, 1e-9, 1e-12)
    np.testing.assert_allclose(p_ell, p_dense, rtol=1e-9)
    assert g_ell.keys() == g_dense.keys()
    for name in g_ell:
        np.testing.assert_allclose(g_ell[name], g_dense[name], rtol=1e-7,
                                   atol=1e-12, err_msg=name)
