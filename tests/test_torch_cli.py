"""The port's training CLI against the JAX package's on the CPU.

Each CLI runs once per module on ``--dataset synthetic --model lightgcn
--epochs 2 --test_interval 1 --train_batch 128 --group_k 4`` (the port with
``--device cpu``, a train-state file and an export).  The two runs train
from different random streams, so they are held by what does not depend
on them: the graph line, the keys of ``results.json`` and the group keys
letter for letter, finite metrics and AUC above 0.52 (JAX's bar in
test_cli_mesh.py).  The port's final report, run on either CLI's best
``model.npz``, must equal that run's ``results.json`` within atol 1e-6; the
port's run peaks at its first epoch, so its report holds the reload of the
best checkpoint, and the last epoch's parameters (its train state) report
otherwise.  Then the port's artifact through JAX's ``load_export``,
``--resume`` and ``--profile`` through the CLI, NGCF, DisenHAN and
``--adj_mode dense_xla`` through it, and the flags and models that raise.
"""

import contextlib
import glob
import io
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch
from test_preprocess import make_dat  # the .dat fixture of the JAX tests
from torch_threads import one_torch_thread  # noqa: F401

from tagrec_tpu import cli as jcli
from tagrec_tpu import serving as jserving
from tagrec_tpu.data import preprocess as jpp
from tagrec_tpu_torch import cli
from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data.synthetic import synthetic_graph
from tagrec_tpu_torch.training import checkpoint

ATOL = 1e-6
ARGS = ["--dataset", "synthetic", "--model", "lightgcn", "--epochs", "2",
        "--test_interval", "1", "--train_batch", "128", "--group_k", "4"]
METRICS = ("recall", "precision", "hr", "ndcg", "auc")


def _run(main, argv):
    """-> (stdout, the run's directory)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    out_dir = argv[argv.index("--out_dir") + 1]
    (run_dir,) = {os.path.dirname(p) for p in
                  glob.glob(os.path.join(out_dir, "**", "results.json"),
                            recursive=True)}
    return out.getvalue(), run_dir


def _results(run_dir):
    with open(os.path.join(run_dir, "results.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    jax_out, jax_dir = _run(jcli.main, ARGS + ["--out_dir", str(tmp / "jax")])
    port_args = ARGS + ["--device", "cpu", "--out_dir", str(tmp / "port"),
                        "--resume", str(tmp / "state.npz"),
                        "--export", str(tmp / "art")]
    port_out, port_dir = _run(cli.main, port_args)
    # the last epoch's train state, before the resume test trains on
    for p in glob.glob(str(tmp / "state.npz*")):
        shutil.copy(p, p.replace("state.npz", "last.npz"))
    return {"tmp": tmp, "jax": (jax_out, jax_dir),
            "port": (port_out, port_dir)}


def _line(out, prefix):
    (line,) = [x for x in out.splitlines() if x.startswith(prefix)]
    return line


def test_graph_line_equals_jax(runs):
    assert _line(runs["port"][0], "graph ready:") == \
        _line(runs["jax"][0], "graph ready:")


def test_results_have_jaxs_keys(runs):
    got, want = _results(runs["port"][1]), _results(runs["jax"][1])
    assert sorted(got) == sorted(want) == ["best_epoch", "group", "test"]
    assert list(got["group"]) == list(want["group"])
    assert len(got["group"]) == 4
    assert all(k.startswith("inter<") for k in got["group"])
    assert sorted(os.listdir(runs["port"][1])) == sorted(
        os.listdir(runs["jax"][1]))


@pytest.mark.parametrize("side", ["port", "jax"])
def test_metrics_are_finite_and_learned(runs, side):
    res = _results(runs[side][1])
    for block in [res["test"], *res["group"].values()]:
        assert sorted(block) == sorted(METRICS)
        assert all(math.isfinite(v) for m in METRICS for v in block[m])
    assert res["test"]["auc"][0] > 0.52


def _pipe():
    return build_pipeline(synthetic_graph(seed=2020), model_preset("lightgcn"),
                          TrainConfig(train_batch=128, test_interval=1,
                                      epochs=2),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")


def _report(pipe):
    """The CLI's final report: the test and the 4-group breakdown."""
    return (pipe.evaluator.run(pipe.model, istest=True),
            pipe.evaluator.run(pipe.model, istest=True, group_k=4))


@pytest.mark.parametrize("side", ["port", "jax"])
def test_report_on_best_checkpoint_equals_results(runs, side):
    """The port's final report on a run's best ``model.npz`` is what that
    run's CLI wrote: the port's own, and JAX's."""
    run_dir = runs[side][1]
    want = _results(run_dir)
    pipe = _pipe()
    checkpoint.load(os.path.join(run_dir, "model.npz"), pipe.model)
    test, groups = _report(pipe)
    assert list(groups) == list(want["group"])
    for got, ref in [(test, want["test"])] + [
            (groups[k], want["group"][k]) for k in groups]:
        for m in METRICS:
            np.testing.assert_allclose(got[m], ref[m], rtol=0, atol=ATOL,
                                       err_msg=m)


def test_report_is_not_the_last_epochs(runs):
    """The port's run peaks before its last epoch, and the last epoch's
    parameters, which its train state holds, report otherwise: the CLI
    reloaded the best checkpoint."""
    want = _results(runs["port"][1])
    assert want["best_epoch"] < 1
    pipe = _pipe()
    opt = torch.optim.Adam(pipe.model.parameters())
    assert checkpoint.restore_train_state(
        str(runs["tmp"] / "last.npz"), pipe.model, opt) == 2
    test, _ = _report(pipe)
    assert not np.allclose(test["ndcg"], want["test"]["ndcg"], rtol=0,
                           atol=ATOL)


def test_metrics_stream_has_jaxs_records(runs):
    """The same records with the same tags in the same order, and the
    same run configuration."""
    def records(run_dir):
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    def tags(recs):
        return [sorted(set(r) - {"t"}) if "text" not in r
                else sorted(r["text"]) for r in recs]
    got, want = records(runs["port"][1]), records(runs["jax"][1])
    assert tags(got) == tags(want)
    assert got[0]["text"]["config"] == want[0]["text"]["config"]


def test_export_loads_in_jax(runs):
    data, meta = jserving.load_export(str(runs["tmp"] / "art"))
    assert meta["model"] == "lightgcn" and meta["dataset"] == "synthetic"
    assert meta["best_epoch"] == _results(runs["port"][1])["best_epoch"]
    assert data["user_table"].shape == (300, 64)
    assert data["item_table"].shape == (800, 64)
    assert np.isfinite(data["user_table"]).all()
    r = jserving.Retriever.from_export(str(runs["tmp"] / "art"))
    ids, _ = r.topk(np.arange(3), k=5)
    assert ids.shape == (3, 5)


def test_resume_trains_only_the_epochs_left(runs):
    state = str(runs["tmp"] / "state.npz")
    out, _ = _run(cli.main, ARGS[:4] + [
        "--epochs", "3", "--test_interval", "1", "--train_batch", "128",
        "--device", "cpu", "--resume", state,
        "--out_dir", str(runs["tmp"] / "resumed")])
    assert f"resumed from {state} at epoch 2" in out
    epochs = [x.split("]")[0] for x in out.splitlines()
              if x.startswith("[Epoch")]
    assert epochs == ["[Epoch:2", "[Epoch 2"]


def test_profile_writes_a_trace(tmp_path):
    trace = str(tmp_path / "trace")
    out, _ = _run(cli.main, ARGS[:4] + [
        "--epochs", "1", "--train_batch", "256", "--device", "cpu",
        "--profile", trace, "--out_dir", str(tmp_path / "run")])
    assert f"device trace written to {trace}" in out
    assert glob.glob(os.path.join(trace, "*.pt.trace.json"))
    # the program's spans of the whole run beside it, the stages' among them
    with open(os.path.join(trace, "program_spans.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"cli.build", "build_pipeline", "cli.train", "trainer.epoch",
            "eval.pass", "cli.test", "cli.group"} <= names
    (line,) = [x for x in out.splitlines() if x.startswith("stage seconds")]
    assert list(json.loads(line.split(": ", 1)[1])) == [
        "build", "train", "test", "group"]


@pytest.mark.parametrize("argv", [
    ["--model", "ngcf"], ["--model", "disenhan"],
    ["--model", "dgcf", "--adj_mode", "dense_xla"]],
    ids=["ngcf", "disenhan", "dgcf-dense_xla"])
def test_ported_models_and_tiers_run(tmp_path, argv):
    """NGCF, DisenHAN and DGCF's chunked dense tier train, test, group and
    export through the CLI."""
    out, run_dir = _run(cli.main, [
        "--device", "cpu", "--dataset", "synthetic", "--epochs", "1",
        "--train_batch", "256", "--group_k", "2", "--out_dir",
        str(tmp_path / "run"), "--export", str(tmp_path / "art")] + argv)
    res = _results(run_dir)
    assert len(res["group"]) == 2
    for block in [res["test"], *res["group"].values()]:
        assert all(math.isfinite(v) for m in METRICS for v in block[m])
    assert f"serving artifact: {tmp_path / 'art'}" in out
    data, meta = jserving.load_export(str(tmp_path / "art"))
    assert meta["model"] == argv[1]
    assert np.isfinite(data["user_table"]).all()


@pytest.mark.parametrize("argv, error, match", [
    (["--dp", "2"], SystemExit, "needs 2 processes.*have 1"),
    (["--mp", "2"], SystemExit, "needs 2 processes.*have 1"),
    (["--model", "nosuch"], ValueError, "unknown model"),
    (["--dataset", "missing_dir"], FileNotFoundError, "train.txt"),
])
def test_unported_and_wrong_flags_raise(tmp_path, argv, error, match):
    with pytest.raises(error, match=match):
        cli.main(["--device", "cpu", "--epochs", "1",
                  "--data_root", str(tmp_path),
                  "--out_dir", str(tmp_path / "run")] + argv)


def test_kgat_over_a_knowledge_graph_raises(tmp_path, capsys):
    """``--use_kg`` loads the KG; one whose entities do not cover the items
    (items are the low entity ids) raises, as JAX's does.  KGAT over a KG
    that covers them trains in test_torch_cli_kg_tgcn.py."""
    root = make_dat(tmp_path)
    jpp.preprocess_hetrec(root, "hetrec2011-lastfm-2k",
                          out_dir=str(tmp_path / "ds"))
    (tmp_path / "ds" / "kg_final.txt").write_text("0 0 1\n")
    argv = ["--device", "cpu", "--model", "kgat", "--data_root",
            str(tmp_path), "--dataset", "ds", "--out_dir",
            str(tmp_path / "run"), "--epochs", "1"]
    with pytest.raises(AssertionError, match="prefix of the entity space"):
        cli.main(argv + ["--use_kg"])
    assert ("knowledge graph: 2 entities, 4 relations"
            in capsys.readouterr().out)


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--out_dir", str(tmp_path)])
