"""The port's copies of JAX's jax-free modules on the CPU: offline
preprocessing (the same files byte for byte), the graph's load-time
``summary`` and ``COO.row_degrees``, the metrics stream (the same JSONL
records apart from their time), and the profiler capture."""

import glob
import json
import os

import numpy as np
import pytest
from test_preprocess import make_dat  # the .dat fixture of the JAX tests

from tagrec_tpu.data import preprocess as jpp
from tagrec_tpu.data.graph import HeteroGraph as JaxGraph
from tagrec_tpu.data.synthetic import synthetic_graph as jax_synthetic
from tagrec_tpu.utils import logging as jlogging
from tagrec_tpu_torch.data import preprocess as pp
from tagrec_tpu_torch.data.graph import HeteroGraph
from tagrec_tpu_torch.data.synthetic import synthetic_graph
from tagrec_tpu_torch.utils import MetricsWriter, printc, profiling

DATASET = "hetrec2011-lastfm-2k"
TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)


def _files(d):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "*")))}


def _assert_graphs_equal(got, want):
    assert got.num == want.num
    assert got.user_items == want.user_items
    np.testing.assert_array_equal(got.uit_data, want.uit_data)
    for adj in ("ui_adj", "ut_adj", "it_adj"):
        a, b = getattr(got, adj), getattr(want, adj)
        for f in ("row", "col", "val"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.row_degrees(), b.row_degrees())
        assert a.row_degrees().dtype == b.row_degrees().dtype
    assert got.summary() == want.summary()


@pytest.mark.parametrize("seed", [0, 5])
def test_preprocess_writes_jaxs_files(tmp_path, seed):
    root = make_dat(tmp_path, seed=seed)
    want = jpp.preprocess_hetrec(root, DATASET, out_dir=str(tmp_path / "jax"),
                                 seed=seed)
    got = pp.preprocess_hetrec(root, DATASET, out_dir=str(tmp_path / "port"),
                               seed=seed)
    assert {k: v for k, v in got.items() if k != "out_dir"} == \
        {k: v for k, v in want.items() if k != "out_dir"}
    files = _files(tmp_path / "port")
    assert sorted(files) == ["item_map.txt", "tag_map.txt", "test.txt",
                             "train.txt", "user_item_tag.txt", "user_map.txt"]
    assert files == _files(tmp_path / "jax")
    _assert_graphs_equal(HeteroGraph.load(str(tmp_path), "port"),
                         JaxGraph.load(str(tmp_path), "jax"))


def test_preprocess_main_refuses_a_missing_dat(tmp_path):
    with pytest.raises(FileNotFoundError, match="user_taggedartists.dat"):
        pp.main(["--data_root", str(tmp_path), "--dataset", DATASET])


def test_summary_and_row_degrees_equal_jax():
    got, want = synthetic_graph(**TINY), jax_synthetic(**TINY)
    _assert_graphs_equal(got, want)
    summary = got.summary()
    assert summary["train_pairs"] == got.ui_adj.nnz
    assert set(summary) == {"num", "train_pairs", "max_multiplicity",
                            "train", "test", "uit"}
    joint = got.joint_norm_adj("bi_norm")
    np.testing.assert_array_equal(
        joint.row_degrees(),
        want.joint_norm_adj("bi_norm").row_degrees())
    assert joint.row_degrees().sum() == joint.nnz


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "t"}
                for line in f]


def test_metrics_writer_writes_jaxs_records(tmp_path):
    results = {"recall": [0.1, 0.2], "ndcg": [0.3, 0.4], "auc": [0.6]}
    for d, writer in (("port", MetricsWriter), ("jax", jlogging.MetricsWriter)):
        w = writer(str(tmp_path / d))
        w.scalars(3, {"train/loss_0": 0.5, "train/epoch_time_0": 1.25})
        w.scalars(4, {"a": 1})
        w.results(4, results, (10, 20))
        w.text("final", json.dumps(results))
        w.close()
    got = _records(tmp_path / "port" / "metrics.jsonl")
    assert got == _records(tmp_path / "jax" / "metrics.jsonl")
    assert got[2] == {"step": 4, "test/recall@10": 0.1, "test/recall@20": 0.2,
                      "test/ndcg@10": 0.3, "test/ndcg@20": 0.4,
                      "test/auc": 0.6}


def test_printc_prints_as_jax(capsys):
    printc("x")
    got = capsys.readouterr().out
    jlogging.printc("x")
    assert got == capsys.readouterr().out == "\033[0;33;40mx\033[0m\n"


def test_trace_writes_a_file_with_the_annotations(tmp_path):
    """A span opened during a capture is in the profiler's file; the
    capture turns the recorder on, and off again when it stops."""
    import torch

    d = str(tmp_path / "trace")
    assert not profiling.enabled()
    profiling.start_trace(d)
    with pytest.raises(RuntimeError, match="already"):
        profiling.start_trace(d)
    try:
        with profiling.span("tagrec_step"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    finally:
        profiling.stop_trace()
    assert not profiling.enabled()
    assert [s["name"] for s in profiling.snapshot()["spans"]] == ["tagrec_step"]
    profiling.reset()
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()
    (path,) = glob.glob(os.path.join(d, "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "tagrec_step" in names
