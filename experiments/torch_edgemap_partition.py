#!/usr/bin/env python3
"""Phase R3 of ``chip_smoke.py`` alone: DGCF's and DisenGCN's EdgeMap
tier row-sharded over ``model`` on one NVIDIA GPU.

Builds the gather kernels, the hetrec and 10x graphs of ``chip_smoke.py``,
times the host's build of DGCF 10x's EdgeMap and of one rank's cut and
exchange plan at ``model`` = 2 (``ops.edgemap.shard_edge_map``), then runs
``chip_smoke.em_phase``: R3a (DGCF 10x captured on a one-rank NCCL mesh
against the unmeshed captured run) and R3b (two ``chip_smoke.py em-rank``
processes on gloo, DGCF and DisenGCN hetrec ``ell`` and DGCF 10x, against
the one-device run), with every hold of the full smoke run.  A quicker
loop than the whole ``chip_smoke.py`` for work on this path:

    python3 experiments/torch_edgemap_partition.py

Needs one NVIDIA GPU; prints the card's name and power limit first and
last.  Exits non-zero when a hold fails.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from tagrec_tpu_torch.data.synthetic import synthetic_graph_large
    from tagrec_tpu_torch.ops import _build, edgemap
    from tagrec_tpu_torch.ops import dma_gather as dg
    from tagrec_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        print("no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_name_and_limit()
    print(card, torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    _build.build(["gather_reduce", "gather_rows"])
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graph = synthetic_graph_large(cs.N_USER, cs.N_ITEM, cs.N_TAG, cs.N_EDGES,
                                  cs.TAG_PER_INTER, seed=0)
    graph_10x = synthetic_graph_large(*cs.LGCN_10X, cs.TAG_PER_INTER, seed=0)
    print(f"graphs built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    coo = graph_10x.joint_norm_adj("plain", True)
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
    del host, shard, coo
    try:
        launches = cs.em_phase(torch, dg, {"10x": graph_10x,
                                           "hetrec": graph}, card)
    except Exception:
        traceback.print_exc()
        return 1
    print(f"gather_reduce launches on phase R3's main paths: {launches}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
