"""Command-line training entry (tagrec_tpu/cli.py), on the card by default.

``python -m tagrec_tpu_torch.cli --model lightgcn --data_root /data --dataset lastfm``
runs: seed, load graph, compose pipeline, train with early stopping, reload the
best checkpoint, final test + 4-group cold-start breakdown, optional serving
export.  ``--dataset synthetic`` trains on a generated graph (no files
needed); ``--device cpu`` runs the plain PyTorch path without a card.

It writes JAX's ``out_dir`` layout (``metrics.jsonl``, ``model.npz``,
``results.json``), and its checkpoints, train states and serving artifacts
are JAX's formats, so either package reads the other's.  ``--model kgat
--use_kg`` over a dataset with a ``kg_final.txt`` trains KGAT over the
knowledge graph.  ``--dp``/``--mp`` train on a (data, model) mesh of
that many processes, one card each, as torchrun starts them:
``torchrun --standalone --nproc_per_node 4 -m tagrec_tpu_torch.cli --dp 2
--mp 2`` (add ``--device cpu`` for gloo ranks on the CPU); a world of
another size raises SystemExit naming the size needed.  Rank 0 prints and
writes the run directory, the params checkpoint and the export; every
rank writes its own shards of the ``--resume`` directory.  ``--adj_mode dense_xla`` takes the
chunked dense tier for DGCF, DisenGCN and KGAT, and TGCN's plain table
takes (``dense`` for LightGCN and NGCF); ``--adj_mode ell`` the EdgeMap
tier for DGCF, DisenGCN, DisenHAN, KGAT and TGCN, which ``auto`` also
takes for a graph over the dense budget.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.data.kg import KnowledgeGraph
from tagrec_tpu_torch.data.synthetic import synthetic_graph, synthetic_graph_large
from tagrec_tpu_torch.device import resolve
from tagrec_tpu_torch.parallel import launch
from tagrec_tpu_torch.training import checkpoint
from tagrec_tpu_torch.training.early_stop import EarlyStop
from tagrec_tpu_torch.training.train import Trainer
from tagrec_tpu_torch.utils import MetricsWriter, printc, profiling


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tagrec_tpu_torch training CLI")
    p.add_argument("--model", type=str, default="lightgcn")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--train_batch", type=int, default=512)
    p.add_argument("--test_batch", type=int, default=512)
    p.add_argument("--has_val", action="store_true")
    p.add_argument("--no_tag", action="store_true")
    p.add_argument("--patient_epoch", type=int, default=10)
    p.add_argument("--test_interval", type=int, default=5)
    p.add_argument("--early_stop_key", type=str, default="ndcg")
    p.add_argument("--topks", type=int, nargs="+", default=[10, 20])
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--reg", type=float, default=0.0)
    p.add_argument("--cor_reg", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--dim_latent", type=int, default=64)
    p.add_argument("--dim_layer_list", type=int, nargs="+", default=[64, 32, 16])
    p.add_argument("--message_drop_list", type=float, nargs="+", default=[0., 0., 0.])
    p.add_argument("--node_drop", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--out_dir", type=str, default="run")
    p.add_argument("--group_k", type=int, default=4)
    p.add_argument("--use_kg", action="store_true",
                   help="KGAT: use kg_final.txt (true KG) instead of the tag "
                        "graph")
    p.add_argument("--transe_sampler", type=str, default=None,
                   choices=["full_pass", "reference_windows"],
                   help="KGAT TransE phase: the reference's overlapping "
                        "prefix windows (quirk #5, kgat preset default) or "
                        "a full shuffled pass")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh size (batch axis); dp x mp > 1 "
                        "runs under torchrun with dp x mp processes")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel mesh size (embedding-table rows)")
    p.add_argument("--adj_mode", type=str, default="auto",
                   choices=["auto", "dense", "dense_xla", "ell"],
                   help="adjacency/attention execution mode (semantics-neutral)")
    p.add_argument("--resume", type=str, default="",
                   help="train-state file for save/resume across restarts")
    p.add_argument("--profile", type=str, default="",
                   help="capture a CPU and CUDA trace of the training run "
                        "into this directory (utils/profiling.py)")
    p.add_argument("--export", type=str, default="",
                   help="after training, freeze the best model into a serving "
                        "artifact (.npz + meta) at this path; query it with "
                        "python -m tagrec_tpu_torch.serving")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    mcfg = model_preset(
        args.model,
        dim_latent=args.dim_latent,
        dim_layer_list=tuple(args.dim_layer_list),
        message_drop_list=tuple(args.message_drop_list),
        node_drop=args.node_drop,
        reg=args.reg,
        cor_reg=args.cor_reg,
        use_tag=not args.no_tag,
        adj_mode=args.adj_mode,
        **({"transe_sampler": args.transe_sampler}
           if args.transe_sampler else {}),
    )
    tcfg = TrainConfig(
        train_batch=args.train_batch, test_batch=args.test_batch,
        has_val=args.has_val, patient_epoch=args.patient_epoch,
        test_interval=args.test_interval, early_stop_key=args.early_stop_key,
        topks=tuple(args.topks), lr=args.lr, epochs=args.epochs, seed=args.seed)
    mesh, say, show = None, print, printc
    dev = resolve(args.device)
    if args.dp * args.mp > 1:
        n = args.dp * args.mp
        launch.initialize(device=dev)
        if launch.world_size() != n:
            raise SystemExit(
                f"--dp {args.dp} x --mp {args.mp} needs {n} processes "
                f"(torchrun --nproc_per_node {n}), have "
                f"{launch.world_size()}")
        if dev.type == "cuda":
            dev = resolve(f"cuda:{launch.local_rank()}")
        mesh = launch.global_mesh(args.dp, args.mp)
        if not launch.is_writer():
            say = show = lambda *a, **k: None  # noqa: E731
        say(f"mesh: data={args.dp} model={args.mp} on {dev.type}")
    try:
        return _train(args, mcfg, tcfg, dev, mesh, say, show)
    finally:
        if mesh is not None:
            launch.shutdown()


def _train(args, mcfg, tcfg, dev, mesh, say, show):
    """The run on ``dev``, on ``mesh`` when given; ``say`` and ``show``
    print (rank 0's) lines."""
    writer = launch.is_writer()
    out_dir = os.path.join(args.out_dir, args.model, args.dataset,
                           time.strftime("%m-%d-%H-%M"))
    if writer:
        os.makedirs(out_dir, exist_ok=True)

    seconds = {}
    t0 = profiling.clock(dev)
    kg = None
    if args.dataset == "synthetic":
        graph = synthetic_graph(seed=args.seed)
    elif args.dataset == "synthetic_large":
        # hetrec movielens-2k scale benchmark graph
        graph = synthetic_graph_large(n_user=2000, n_item=10000, n_tag=3000,
                                      n_edges=400_000, tag_per_inter=0.3,
                                      seed=args.seed)
    else:
        graph = HeteroGraph.load(args.data_root, args.dataset,
                                 has_val=args.has_val, use_tag=not args.no_tag)
        kg_path = os.path.join(args.data_root, args.dataset, "kg_final.txt")
        if args.model == "kgat" and args.use_kg and os.path.exists(kg_path):
            kg = KnowledgeGraph(graph, args.data_root, args.dataset)
            say(f"knowledge graph: {kg.num_entity} entities, "
                f"{kg.num_relation} relations, {len(kg.all_triplet)} triples")
    say(f"graph ready: {graph.num}")

    pipe = build_pipeline(graph, mcfg, tcfg, device=dev, kg=kg, mesh=mesh,
                          generator=torch.Generator().manual_seed(tcfg.seed))
    seconds["build"] = profiling.clock(dev) - t0

    ckpt_path = os.path.join(out_dir, "model.npz")
    metrics = MetricsWriter(out_dir) if writer else None
    if metrics is not None:
        metrics.text("config", json.dumps({"model": mcfg.__dict__,
                                           "train": tcfg.__dict__},
                                          default=str))
    stop = EarlyStop(tcfg.patient_epoch, tcfg.early_stop_key, save_path=ckpt_path)
    trainer = Trainer(pipe.model, pipe.phases, tcfg, mesh=mesh,
                      generator=torch.Generator(device=dev).manual_seed(
                          tcfg.seed))
    profile = args.profile and writer
    if profile:
        profiling.start_trace(args.profile)
    t0 = profiling.clock(dev)
    try:
        trainer.run(pipe.evaluator, stop, metrics=metrics, log=say,
                    state_path=args.resume or None)
    finally:
        if profile:
            profiling.stop_trace()
            say(f"device trace written to {args.profile}")
    seconds["train"] = profiling.clock(dev) - t0

    # reload the best checkpoint for the final report (main.py:24); the
    # model holds the last epoch's parameters.  On a mesh every rank takes
    # its rows of the best parameters from memory (rank 0 wrote the file)
    if mesh is None and os.path.exists(ckpt_path):
        checkpoint.load(ckpt_path, pipe.model)
    elif stop.best_params is not None:
        with torch.no_grad():
            for name, p in pipe.model.named_parameters():
                p.copy_(stop.best_params[name])
    t0 = profiling.clock(dev)
    results = pipe.evaluator.run(pipe.model, istest=True)
    seconds["test"] = profiling.clock(dev) - t0
    show(f"test result: {results}")
    t0 = profiling.clock(dev)
    groups = pipe.evaluator.run(pipe.model, istest=True, group_k=args.group_k)
    seconds["group"] = profiling.clock(dev) - t0
    show(f"group result: {groups}")
    if writer:
        metrics.text("final", json.dumps(results, default=float))
        metrics.close()
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump({"test": results,
                       "group": {k: v for k, v in groups.items()},
                       "best_epoch": stop.best_epoch}, f, indent=2,
                      default=float)

    if args.export:
        from tagrec_tpu_torch import serving

        t0 = profiling.clock(dev)
        u_t, i_t = serving.export_tables(pipe.model, n_item=graph.n_item)
        if writer:
            meta = serving.save_export(
                args.export, u_t, i_t, model_name=args.model,
                train_pos=graph.user_items["train"],
                extra={"dataset": args.dataset,
                       "best_epoch": stop.best_epoch})
            seconds["export"] = profiling.clock(dev) - t0
            show(f"serving artifact: {args.export} {meta}")
    say(f"stage seconds (host clock): {json.dumps(seconds)}")
    return results


if __name__ == "__main__":
    main()
