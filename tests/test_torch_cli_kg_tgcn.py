"""The training CLI's KGAT over a knowledge graph (``--use_kg``) and TGCN,
on the CPU (``--device cpu``), one epoch each: train, evaluate, the final
test and group pass, export.  The KG line is held against what JAX's
loader counts for the same files.
"""

import contextlib
import glob
import io
import json
import math
import os

import numpy as np
from test_preprocess import make_dat  # the .dat fixture of the JAX tests
from torch_threads import one_torch_thread  # noqa: F401

from tagrec_tpu.data import preprocess as jpp
from tagrec_tpu.data.graph import HeteroGraph as JaxGraph
from tagrec_tpu.data.kg import KnowledgeGraph as JaxKG
from tagrec_tpu_torch import cli, serving

METRICS = ("recall", "precision", "hr", "ndcg", "auc")


def _run(argv):
    """-> (stdout, results.json)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--device", "cpu", "--epochs", "1", "--group_k", "2"]
                 + argv)
    out_dir = argv[argv.index("--out_dir") + 1]
    (path,) = glob.glob(os.path.join(out_dir, "**", "results.json"),
                        recursive=True)
    with open(path) as f:
        res = json.load(f)
    assert res["group"] and all(k.startswith("inter<") for k in res["group"])
    for block in [res["test"], *res["group"].values()]:
        assert all(math.isfinite(v) for m in METRICS for v in block[m])
    return out.getvalue(), res


def test_kgat_use_kg(tmp_path):
    root = make_dat(tmp_path)
    jpp.preprocess_hetrec(root, "hetrec2011-lastfm-2k",
                          out_dir=str(tmp_path / "ds"))
    graph = JaxGraph.load(str(tmp_path), "ds")
    rng = np.random.default_rng(0)
    n_ent = graph.n_item + 40
    kg = np.stack([rng.integers(0, n_ent, 500), rng.integers(0, 4, 500),
                   rng.integers(0, n_ent, 500)], axis=1)
    np.savetxt(tmp_path / "ds" / "kg_final.txt", kg, fmt="%d")
    want = JaxKG(graph, str(tmp_path), "ds")
    out, res = _run(["--model", "kgat", "--use_kg", "--data_root",
                     str(tmp_path), "--dataset", "ds", "--out_dir",
                     str(tmp_path / "run"), "--export",
                     str(tmp_path / "art")])
    assert (f"knowledge graph: {want.num_entity} entities, "
            f"{want.num_relation} relations, {len(want.all_triplet)} triples"
            in out)
    assert "[Epoch:0][bpr]" in out and "[Epoch:0][transe]" in out
    data, meta = serving.load_export(str(tmp_path / "art"))
    assert data["item_table"].shape == (graph.n_item, 64)


def test_tgcn(tmp_path):
    out, res = _run(["--model", "tgcn", "--dataset", "synthetic",
                     "--out_dir", str(tmp_path / "run"), "--export",
                     str(tmp_path / "art")])
    assert "[Epoch:0][bpr]" in out and "[Epoch:0][transtag]" in out
    assert 0.0 < res["test"]["auc"][0] < 1.0 and len(res["group"]) == 2
    data, meta = serving.load_export(str(tmp_path / "art"))
    assert meta["model"] == "tgcn" and meta["dim"] == 176
    assert np.isfinite(data["user_table"]).all()
