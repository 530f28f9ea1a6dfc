"""``BENCHMARK.json`` against the benchmark's contract, and the imports of
the benchmark's files."""

import ast
import os
import re

import pytest

from portbench import harness

MAN = harness.read_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = harness.HERE


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in MAN["workloads"]])


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    names += [w[k] for w in MAN["workloads"] for k in ("config", "traffic")]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in MAN[k]}) == len(MAN[k])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)


def test_per_layer_moves_what_its_cells_report():
    e2e = {m["name"]: set(_cells(m)) for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e, m
        assert set(_cells(m)) <= e2e[m["moves"]], m


def test_every_cell_reports_enough_and_every_config_has_a_cell():
    cells = {w["name"] for w in MAN["workloads"]}
    for cell in cells:
        e2e = [m["name"] for m in MAN["end_to_end"] if cell in _cells(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, (cell, e2e)
        assert any(cell in _cells(m) for m in MAN["per_layer"]), cell
    assert {c["name"] for c in MAN["configs"]} == {
        w["config"] for w in MAN["workloads"]}


def test_one_chip_a_cell_and_bounds():
    assert all(w["chips"] == 1 for w in MAN["workloads"])
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_files_found_by_name(w):
    cfg = [c for c in MAN["configs"] if c["name"] == w["config"]][0]
    assert cfg["file"].startswith("portbench/")
    mix = harness.read_json(f"portbench/mixes/{w['traffic']}.json")
    for rel in (f"drivers/{mix['driver']}.py", f"reference/{w['config']}.py",
                f"counts/{w['config']}.py", f"limits/{w['name']}.json"):
        assert os.path.exists(os.path.join(HERE, rel)), rel
    for m in MAN["per_layer"]:
        if w["name"] in _cells(m):
            assert hasattr(harness.load(f"metrics/{m['name']}.py"), "read")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _files(sub=""):
    for d, _, fs in os.walk(os.path.join(HERE, sub)):
        yield from (os.path.join(d, f) for f in fs if f.endswith(".py"))


def test_no_file_imports_jax_or_the_jax_package():
    for f in _files():
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "tagrec_tpu"}, f


def test_references_import_nothing_of_the_port():
    for f in _files("reference"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert "tagrec_tpu_torch" not in tops, f
