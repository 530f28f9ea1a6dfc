"""The port's recorder of spans and counters (``utils/profiling.py``) on the
CPU: off it records nothing and puts nothing on a profiler's timeline; on,
it nests spans, counts, writes Chrome-trace JSON and stamps on the
profiler's own clock; and the spans the Trainer, the Evaluator and
``build_pipeline`` open."""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tagrec_tpu_torch.compose import build_pipeline
from tagrec_tpu_torch.config import TrainConfig, model_preset
from tagrec_tpu_torch.data import synthetic as tsyn
from tagrec_tpu_torch.training.train import Trainer
from tagrec_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(n_user=40, n_item=90, n_tag=25, avg_deg=8, seed=7)
STEPS = 3


@pytest.fixture
def on():
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


def _tree(spans):
    """{name: [names of its children]} of a snapshot's spans."""
    names = {s["id"]: s["name"] for s in spans}
    out = {}
    for s in spans:
        if s["parent"] is not None:
            out.setdefault(names[s["parent"]], []).append(s["name"])
    return out


def test_off_records_nothing_and_emits_no_event():
    assert not profiling.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("off.outer", k=1) as a, profiling.span("off.b") \
                as b:
            profiling.count("off.n")
    assert a is b  # the one shared no-op
    with profiling.timed("off.timed") as t:
        sum(range(1000))
    assert t.seconds > 0
    assert profiling.snapshot() == {"spans": [], "counters": {}}
    assert not {e.name for e in prof.events()} & {"off.outer", "off.b",
                                                  "off.timed"}


def test_on_nests_spans_counts_and_writes_chrome_json(on, tmp_path):
    with profiling.span("outer", phase="bpr"):
        with profiling.span("inner", n=2):
            profiling.count("things", 3)
        with profiling.timed("sibling") as t:
            pass
        profiling.count("things")
    snap = profiling.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    assert [s["name"] for s in snap["spans"]] == ["inner", "sibling", "outer"]
    assert by["outer"]["parent"] is None
    assert by["inner"]["parent"] == by["sibling"]["parent"] == by["outer"]["id"]
    assert by["outer"]["attrs"] == {"phase": "bpr"}
    assert by["inner"]["attrs"] == {"n": 2}
    assert (by["outer"]["start_ns"] <= by["inner"]["start_ns"]
            <= by["inner"]["end_ns"] <= by["sibling"]["start_ns"]
            <= by["outer"]["end_ns"])
    assert t.seconds == pytest.approx(
        (by["sibling"]["end_ns"] - by["sibling"]["start_ns"]) / 1e9)
    assert snap["counters"] == {"things": 4}
    path = tmp_path / "spans.json"
    profiling.write(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(xs) == {"outer", "inner", "sibling"}
    assert xs["inner"]["ts"] == by["inner"]["start_ns"] / 1e3
    assert xs["inner"]["args"]["parent"] == by["outer"]["id"]
    (c,) = [e for e in events if e["ph"] == "C"]
    assert c["args"] == {"things": 4}
    profiling.reset()
    assert profiling.snapshot() == {"spans": [], "counters": {}}


def test_spans_share_the_profilers_clock(on):
    """A span's start lies within 1 ms of its own ``record_function``
    event's, the event's mapped to Unix time through ``trace_start_ns``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("clocked"):
                torch.ones(4) + 1
    base_us = prof.profiler.kineto_results.trace_start_ns() / 1e3
    events = sorted((e for e in prof.events() if e.name == "clocked"),
                    key=lambda e: e.time_range.start)
    spans = [s for s in profiling.snapshot()["spans"] if s["name"] == "clocked"]
    assert len(events) == len(spans) == 3
    for e, s in zip(events, spans):
        assert abs(base_us + e.time_range.start - s["start_ns"] / 1e3) < 1e3


@pytest.fixture(scope="module")
def recorded():
    """The spans and counters of ``build_pipeline``, a Trainer's
    construction and one eager epoch of STEPS steps, and one evaluation
    pass, LightGCN on the tiny graph."""
    graph = tsyn.synthetic_graph(**TINY)
    tcfg = TrainConfig(train_batch=64, test_batch=16)
    profiling.reset()
    profiling.enable()
    try:
        pipe = build_pipeline(graph, model_preset("lightgcn"), tcfg,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
        trainer = Trainer(pipe.model, pipe.phases, tcfg, capture=False,
                          generator=torch.Generator().manual_seed(0))
        trainer.run_epoch(max_steps=STEPS)
        pipe.evaluator.run(pipe.model)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    return snap, len(graph.user_items["test"]), tcfg.test_batch


def test_build_pipeline_spans_its_four_stages(recorded):
    snap, _, _ = recorded
    assert _tree(snap["spans"])["build_pipeline"] == [
        "build.model", "build.pos_table", "build.phases", "build.evaluator"]


def test_trainer_epoch_spans_and_counters(recorded):
    snap, _, _ = recorded
    (epoch,) = [s for s in snap["spans"] if s["name"] == "trainer.epoch"]
    assert epoch["attrs"] == {"phase": "bpr", "steps": STEPS}
    assert _tree(snap["spans"])["trainer.epoch"] == (
        ["trainer.epoch_reset"] + ["trainer.eager"] * STEPS
        + ["trainer.readback"])
    assert [s["name"] for s in snap["spans"]].count("trainer.init") == 1
    assert snap["counters"]["trainer.eager_steps"] == STEPS
    assert snap["counters"]["trainer.epochs"] == 1
    assert "trainer.captures" not in snap["counters"]


def test_evaluator_pass_spans_and_counters(recorded):
    snap, users, test_batch = recorded
    tree = _tree(snap["spans"])
    blocks = math.ceil(users / test_batch)
    assert tree["eval.pass"] == (["eval.forward"] + ["eval.block"] * blocks
                                 + ["eval.sync"])
    assert tree["eval.block"] == ["eval.sync"] * blocks
    sizes = [s["attrs"]["users"] for s in snap["spans"]
             if s["name"] == "eval.block"]
    assert sum(sizes) == users and max(sizes) == test_batch
    c = snap["counters"]
    assert (c["eval.passes"], c["eval.blocks"], c["eval.users"]) == (
        1, blocks, users)
