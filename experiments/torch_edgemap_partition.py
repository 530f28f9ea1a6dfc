#!/usr/bin/env python3
"""Phase R3, R4, R5, R6 or R7 of ``chip_smoke.py`` alone: the EdgeMap
tier, TGCN's tables, the kernel tiers' masks, or the chunked dense
tiers' tables, row-sharded over ``model`` on one NVIDIA GPU.

Builds the phase's kernels and the hetrec and 10x graphs of
``chip_smoke.py``, prints a host report, then runs the phase with every
hold of the full smoke run.  A quicker loop than the whole
``chip_smoke.py`` for work on this path:

    python3 experiments/torch_edgemap_partition.py R3
    python3 experiments/torch_edgemap_partition.py R4
    python3 experiments/torch_edgemap_partition.py R5
    python3 experiments/torch_edgemap_partition.py R6
    python3 experiments/torch_edgemap_partition.py R7

R3 (DGCF's and DisenGCN's maps): the host's build of DGCF 10x's EdgeMap
and of one rank's cut and exchange plan at ``model`` = 2
(``ops.edgemap.shard_edge_map``), timed; then ``chip_smoke.em_phase``: R3a
(DGCF 10x captured on a one-rank NCCL mesh against the unmeshed captured
run) and R3b (two ``chip_smoke.py em-rank`` processes on gloo, DGCF and
DisenGCN hetrec ``ell`` and DGCF 10x, against the one-device run).

R4 (DisenHAN's, KGAT's and TGCN ``ell``'s maps): for each map of every
R4b path the share of its slots in buckets JAX's rule row-shards over
``model`` = 2 (``ops.ell.row_sharded``), and the time of the maps' host
build and of one rank's cut and exchange plans
(``ops.edgemap.maps_to_device``'s host part); then
``chip_smoke.em4_phase``: R4a (KGAT ``bi_inter`` 10x captured on a
one-rank NCCL mesh against the unmeshed captured run) and R4b (two
``chip_smoke.py em4-rank`` processes on gloo: DisenHAN, KGAT and TGCN
hetrec ``ell``, KGAT over phase K's KG with parallel triples, KGAT 10x,
against the one-device run).

R5 (TGCN's neighbour tables and dedup buckets): for each R5b path the
share of its table slots and of its attention rows in leaves JAX's rule
row-shards over ``model`` = 2, and the time of the tables' host build
and of one rank's cut; then ``chip_smoke.tgcn_rows_phase``: R5a (TGCN
``auto`` hetrec captured on a one-rank NCCL mesh against the unmeshed
captured run) and R5b (two ``chip_smoke.py tgcn-rank`` processes on
gloo: TGCN ``auto``, ``dense_xla`` and ``ell`` at hetrec, against the
one-device run).  R5 needs no kernel and no 10x graph.

R6 (the kernel tiers' masks: DGCF's and DisenGCN's routing mask, KGAT
``bi_inter``'s flash masks and their transposes): for each R6b path the
masks' host build and rank 0's cut at ``model`` = 2, timed, and the mask
bytes rank 0 holds; then ``chip_smoke.masks_phase``: the seven sweeps
over a block of rows against their plain versions and the whole
launch's rows, R6a (DGCF hetrec captured on a one-rank NCCL mesh against
the unmeshed captured run) and R6b (two ``chip_smoke.py mask-rank``
processes on gloo: DGCF, DisenGCN and KGAT ``bi_inter`` at hetrec,
against the one-device run).  R6 builds the routing and flash kernels
and needs no 10x graph.

R7 (the chunked dense tiers' tables: DisenHAN's six relation masks and
the KG's ``rel_id`` under ``auto``, the ``dense_xla`` mask of DGCF,
DisenGCN and KGAT): first, for each R7b path, the prediction from the
shapes: each table's rows and rank 0's rows of it at ``model`` = 2, the
table bytes rank 0 holds, and its rows of the attention matrix P in
bytes where the path builds one, against ``chip_smoke.R7_PREDICTED``;
then ``chip_smoke.dense_phase``: R7a (KGAT over phase K's KG captured on
a one-rank NCCL mesh against the unmeshed captured run) and R7b (two
``chip_smoke.py dense-rank`` processes on gloo, against the one-device
run).  R7 builds the flash kernels (KGAT ``dense_xla``'s hold against
its kernel tier) and needs no 10x graph.

Needs one NVIDIA GPU; prints the card's name and power limit first and
last.  Exits non-zero when a hold fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def r3_report(graphs) -> None:
    """DGCF 10x's EdgeMap built on the host, and rank 0's cut and plan at
    ``model`` = 2, timed on the host clock."""
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    coo = graphs["10x"].joint_norm_adj("plain", True)
    host = edgemap.build_edge_map(coo.row, coo.col, coo.val, *coo.shape)
    print(f"DGCF 10x EdgeMap built on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    shard = edgemap.shard_edge_map(host, make_mesh(2, 1, rank=0))
    print(f"rank 0 of model = 2: cut and exchange plan in "
          f"{time.perf_counter() - t0:.1f} s (host clock); forward blocks "
          f"{shard.f_blocks}; forward-to-transpose splits send "
          f"{shard.f_x.send_splits}, receive {shard.f_x.recv_splits}; "
          f"transpose-to-forward {shard.b_x.send_splits}, "
          f"{shard.b_x.recv_splits}")


def split_shares(hosts, m: int = 2) -> dict:
    """{map key: the share of its forward and transpose slots in buckets
    JAX's rule row-shards over ``m``} of a model's EdgeMapHosts."""
    from tagrec_tpu_torch.ops import edgemap, ell

    out = {}
    for key, h in hosts.items():
        if not isinstance(h, edgemap.EdgeMapHost):
            continue
        sizes = [(b.idx.size, ell.row_sharded(b.idx.shape[0], m))
                 for side in (h.f, h.b) for b in side.buckets]
        total = sum(n for n, _ in sizes)
        out[key] = round(sum(n for n, cut in sizes if cut) / max(total, 1), 4)
    return out


def r4_report(graphs) -> None:
    """The split shares of every R4b path's maps, their host build and one
    rank's cut and plans, timed on the host clock."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.ops import edgemap
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    graphs = dict(graphs, kg=cs.parallel_kg(graphs["hetrec"]))
    for label, name, over, g, _, _ in cs.EM4_PATHS:
        t0 = time.perf_counter()
        kw = {"kg": graphs["kg"]} if g == "kg" else {}
        model = model_class(name)(
            graphs["hetrec" if g == "kg" else g],
            model_preset(name, **{"adj_mode": "ell", **over}), device="cpu",
            generator=torch.Generator().manual_seed(0), **kw)
        built = time.perf_counter() - t0
        t0 = time.perf_counter()
        edgemap.maps_to_device(model.em_hosts, "cpu",
                               make_mesh(2, 1, rank=0))
        print(f"{label}: maps built on the host in {built:.1f} s, rank 0's "
              f"cut and exchange plans at model = 2 in "
              f"{time.perf_counter() - t0:.1f} s; slots in row-sharded "
              f"buckets {split_shares(model.em_hosts)}")
        del model


def r5_report(graphs) -> None:
    """Per R5b path: the tables' host build and rank 0's cut at
    ``model`` = 2, timed on the host clock; the share of the table bytes
    and of the attention's rows a forward rank 0 holds."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models.tgcn import TGCN
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    for label, mode, *_ in cs.TGCN_PATHS:
        t0 = time.perf_counter()
        model = TGCN(graphs["hetrec"], model_preset("tgcn", adj_mode=mode),
                     device="cpu", generator=torch.Generator().manual_seed(0))
        built = time.perf_counter() - t0
        mesh = make_mesh(2, 1, rank=0)
        t0 = time.perf_counter()
        cut = model.table_leaves(mesh)
        cut_s = time.perf_counter() - t0
        whole = dict(model.table_leaves())
        held = sum(a.nbytes for _, a in cut)
        total = sum(a.nbytes for a in whole.values())
        blocks = model.leaf_blocks(mesh)
        rows = {name: sum(whole[p].shape[0] if blocks[p] is None
                          else blocks[p][1] - blocks[p][0]
                          for p in model.piece_paths(name))
                for name in model.REL_ORDER}
        want = {name: sum(whole[p].shape[0] for p in model.piece_paths(name))
                for name in model.REL_ORDER}
        print(f"{label}: tables built on the host in {built:.1f} s, rank "
              f"0's cut at model = 2 in {cut_s:.2f} s (host clock); rank 0 "
              f"holds {held} of {total} table bytes on the host "
              f"({held / total:.4f}); attention rows a layer on rank 0 "
              f"{rows} of {want} "
              f"({sum(rows.values()) / sum(want.values()):.4f})")
        del model


def r5_run(torch, dg, graphs, card):
    cs.tgcn_rows_phase(torch, graphs["hetrec"], card)
    return 0


def r6_report(graphs) -> None:
    """Per R6b path: the masks' host build and rank 0's cut at ``model`` =
    2, timed on the host clock, and the mask bytes rank 0 holds."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    for label, name, over, _ in cs.MASK_PATHS:
        t0 = time.perf_counter()
        model = model_class(name)(graphs["hetrec"], model_preset(name, **over),
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(0))
        built = time.perf_counter() - t0
        whole = model.mask_nbytes()
        t0 = time.perf_counter()
        model.place_masks(make_mesh(2, 1, rank=0), "cpu")
        print(f"{label}: masks built on the host in {built:.1f} s, rank 0's "
              f"cut at model = 2 in {time.perf_counter() - t0:.2f} s (host "
              f"clock); rank 0 holds {model.mask_nbytes()} of {whole} mask "
              f"bytes, blocks {model.mask_blocks}")
        del model


def r6_run(torch, dg, graphs, card):
    from tagrec_tpu_torch.ops import flash_attention as fa
    from tagrec_tpu_torch.ops import flash_routing as fr

    records = {k: {"max_abs_err": 0.0} for k in cs.SWEEPS}
    launches = cs.masks_phase(torch, fr, fa, graphs["hetrec"], records, card)
    print(f"largest error of each sweep over a block of rows: "
          f"{ {k: v['max_abs_err'] for k, v in records.items()} }")
    return launches


def r7_report(graphs) -> None:
    """Per R7b path, from the shapes: each table's rows and rank 0's rows
    of it at ``model`` = 2 (JAX's rule), the table bytes rank 0 holds and
    its bytes of P (rows x N x 4), against ``chip_smoke.R7_PREDICTED``;
    the tables' host build timed on the host clock."""
    from tagrec_tpu_torch.config import model_preset
    from tagrec_tpu_torch.data.kg import KnowledgeGraph
    from tagrec_tpu_torch.models import model_class
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    kg = KnowledgeGraph.synthetic(graphs["hetrec"], **cs.KG_SIZE)
    for label, name, over, with_kg, _ in cs.DENSE_PATHS:
        t0 = time.perf_counter()
        kw = {"kg": kg} if with_kg else {}
        model = model_class(name)(graphs["hetrec"], model_preset(name, **over),
                                  device="cpu", **kw,
                                  generator=torch.Generator().manual_seed(0))
        built = time.perf_counter() - t0
        rows = {path: host.shape[0] for path, _, host, _ in model.mask_hosts}
        whole = model.mask_nbytes()
        model.place_masks(make_mesh(2, 1, rank=0), "cpu")
        held = model.mask_nbytes()
        blocks = dict(model.mask_blocks)
        p_bytes = None
        if name == "kgat":  # one table, rows [start, stop) of P
            start, stop = next(iter(blocks.values()))
            p_bytes = (stop - start) * model.n * 4
        same = (held, p_bytes) == cs.R7_PREDICTED[label]
        print(f"{label} (prediction from the shapes): tables built on the "
              f"host in {built:.1f} s; rows {rows}, rank 0's blocks at "
              f"model = 2 {blocks}; rank 0 holds {held} of {whole} table "
              f"bytes ({held / whole:.4f}), P bytes {p_bytes}; "
              f"R7_PREDICTED {cs.R7_PREDICTED[label]} "
              f"{'equal' if same else 'DIFFERENT'}")
        del model


def r7_run(torch, dg, graphs, card):
    launches = cs.dense_phase(torch, graphs["hetrec"], card)
    return launches


ROUTING_FLASH = ["routed_rowsum", "routed_mm", "dot_flash_stats",
                 "dot_flash_apply", "dot_flash_bwd_row", "dot_flash_bwd_col"]
GATHERS = ["gather_reduce", "gather_rows"]
# phase -> (host report, the phase, the kernels it builds)
PHASES = {"R3": (r3_report, cs.em_phase, GATHERS),
          "R4": (r4_report, cs.em4_phase, GATHERS),
          "R5": (r5_report, r5_run, GATHERS),
          "R6": (r6_report, r6_run, ROUTING_FLASH),
          "R7": (r7_report, r7_run, ROUTING_FLASH)}


def main() -> int:
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.ops import _build
    from tagrec_tpu_torch.ops import dma_gather as dg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=sorted(PHASES))
    phase = ap.parse_args().phase
    report, run, kernels = PHASES[phase]
    if not torch.cuda.is_available():
        print("no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_name_and_limit()
    print(card, torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    _build.build(kernels)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graphs = {"hetrec": synthetic_graph_large(cs.N_USER, cs.N_ITEM, cs.N_TAG,
                                              cs.N_EDGES, cs.TAG_PER_INTER,
                                              seed=0)}
    if phase in ("R3", "R4"):
        graphs["10x"] = synthetic_graph_large(*cs.LGCN_10X, cs.TAG_PER_INTER,
                                              seed=0)
    print(f"graphs built in {time.perf_counter() - t0:.1f} s")
    report(graphs)
    try:
        launches = run(torch, dg, graphs, card)
    except Exception:
        traceback.print_exc()
        return 1
    print(f"kernel launches on phase {phase}'s main paths: {launches}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
