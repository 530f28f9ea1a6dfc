#!/usr/bin/env python3
"""Which per-bucket operation of the EdgeMap tier gives a row a result
that depends on how many rows the call holds, on one NVIDIA GPU.

Under a ``model`` mesh a rank computes its block of a row-sharded bucket
(``ops.ell.row_sharded``): half the rows at ``model`` = 2.  A library
kernel chosen by the row count may then sum a row in another order than
over the whole bucket, and the mesh is no longer bit for bit with one
device.  For every row-sharded forward bucket of the maps of TGCN
hetrec ``ell``, KGAT ``bi_inter`` over phase K's KG with parallel triples
and KGAT 10x (the graphs of ``chip_smoke.py``), this script computes each
operation over the whole bucket and over its two halves, on seeded
inputs at the models' widths, and prints per operation the buckets
tried, the buckets whose halves equal the whole bit for bit, the largest
difference, and the device ms of the whole calls (CUDA events):

    python3 experiments/torch_row_count_bits.py

The operations: the slot dot products of ``edge_dot`` (``_dot_bucket``,
batched products over blocks of a fixed row count, and one batched
product over the rows given), ``edge_softmax``, ``gather_reduce``, and
TGCN's attention: its scores and its weighted slot sum as the port runs
them (``edge_score``, ``slot_sums``: library products over fixed row
blocks) and in two more forms each, one library product (matrix-vector
or batched) and a product and a sum, and the per-row sums of the score
weight's gradient in the latter two.  Needs one NVIDIA GPU;
prints the card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

BUDGET_ELEMS = 1 << 28  # skip a variant whose gathered [n, k, d] is larger


def compare(op, n: int):
    """(bit for bit, max |difference|) of op over rows [0, n) against op
    over [0, n/2) and [n/2, n), concatenated on the row axis."""
    whole = op(slice(0, n))
    h = n // 2
    halves = torch.cat([op(slice(0, h)), op(slice(h, n))])
    diff = (whole.double() - halves.double()).abs().max().item()
    return bool(torch.equal(whole, halves)), diff


def bucket_ops(idx, deg, n_cols, d, a_dim, gen):
    """{name: op(rows)} over one bucket, on seeded inputs."""
    from tagrec_tpu_torch.ops import dma_gather as dg
    from tagrec_tpu_torch.ops import edgemap

    n, k = idx.shape
    dev = idx.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, ar, s = randn(n_cols, d), randn(n, d), randn(n, k)
    ops = {
        "edge_dot (_dot_bucket)": lambda r: edgemap._dot_bucket(
            ar[r], idx[r], x),
        "edge_softmax": lambda r: edgemap.edge_softmax(
            types.SimpleNamespace(f_idx=(idx[r],), f_deg=(deg[r],)),
            (s[r],))[0],
        "gather_reduce": lambda r: dg.gather_reduce(
            x, idx[r].contiguous(), s[r].contiguous(), deg[r].contiguous()),
    }
    if n * k * max(d, a_dim) <= BUDGET_ELEMS:
        h, v = randn(n, k, a_dim), randn(1, a_dim)
        j = x[idx]
        ops.update({
            "edge_dot, one batched product": lambda r: torch.einsum(
                "nd,nkd->nk", ar[r], j[r]),
            "score, edge_score (blocks)": lambda r: edgemap.edge_score(
                None, (h[r],), v)[0],
            "slot sum, slot_sums (blocks)": lambda r: edgemap.slot_sums(
                (s[r],), (j[r],))[0],
            "score, matrix-vector": lambda r: (h[r] @ v.T)[..., 0],
            "score, product and sum": lambda r: (h[r] * v[0]).sum(dim=-1),
            "slot sum, batched product": lambda r: torch.einsum(
                "nk,nkd->nd", s[r], j[r]),
            "slot sum, product and sum": lambda r: (
                s[r][..., None] * j[r]).sum(dim=-2),
            "score weight rows, batched product": lambda r: torch.einsum(
                "nk,nka->na", s[r], h[r]),
            "score weight rows, product and sum": lambda r: (
                s[r][..., None] * h[r]).sum(dim=-2),
        })
    return ops


def sharded_buckets(em):
    from tagrec_tpu_torch.ops import ell

    return [(i, d) for i, d in zip(em.f_idx, em.f_deg)
            if i.shape[1] and ell.row_sharded(i.shape[0], 2)]


def run_case(label, maps, d, a_dim, gen):
    """maps: [(key, EdgeMap, n_cols)] -> prints one JSON line per op."""
    table = {}
    for key, em, n_cols in maps:
        for idx, deg in sharded_buckets(em):
            for name, op in bucket_ops(idx, deg, n_cols, d, a_dim,
                                       gen).items():
                same, diff = compare(op, idx.shape[0])
                ms = cs.time_ms(torch, lambda: op(slice(0, idx.shape[0])), 5)
                t = table.setdefault(name, {"buckets": 0, "bit_for_bit": 0,
                                            "max_abs_diff": 0.0, "ms": 0.0,
                                            "unequal": []})
                t["buckets"] += 1
                t["bit_for_bit"] += same
                t["max_abs_diff"] = max(t["max_abs_diff"], diff)
                t["ms"] += ms
                if not same:
                    t["unequal"].append(f"{key} {tuple(idx.shape)}")
    for name, t in table.items():
        t["unequal"] = t["unequal"][:6]
        print(json.dumps({"case": label, "op": name, **t}))


def main() -> int:
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_limit(), torch.__version__, torch.version.cuda)
    _build.build(["gather_reduce", "gather_rows"])
    graph = synthetic_graph_large(cs.N_USER, cs.N_ITEM, cs.N_TAG, cs.N_EDGES,
                                  cs.TAG_PER_INTER, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def build(name, g, **kw):
        over = kw.pop("over", {"adj_mode": "ell"})
        return model_class(name)(g, model_preset(name, **over),
                                 device="cuda",
                                 generator=torch.Generator().manual_seed(0),
                                 **kw)

    model = build("tgcn", graph)
    cfg = model.cfg
    maps = [(k, model.edges[k], h.f.n_cols)
            for k, h in model.em_hosts.items() if k.endswith(".0")]
    run_case("TGCN hetrec ell", maps, cfg.dim_latent, cfg.dim_atten, gen)
    del model
    for label, g, kw in (
            ("KGAT KG fallback", graph, {"kg": cs.parallel_kg(graph),
                                         "over": {"adj_mode": "ell",
                                                  "agg_type": "bi_inter"}}),
            ("KGAT 10x", synthetic_graph_large(*cs.LGCN_10X,
                                               cs.TAG_PER_INTER, seed=0),
             {"over": {"agg_type": "bi_inter"}})):
        model = build("kgat", g, **kw)
        assert model.tier == "ell", model.tier
        d = model.transE.shape[-1]
        run_case(label, [(k, model.edges[k], model.em_hosts[k].f.n_cols)
                         for k in ("em", "emk")], d, d, gen)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
