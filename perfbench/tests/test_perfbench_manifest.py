"""BENCHMARK.json against the rules its checks hold it to, and every file that its
names lead to."""
from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH_DIR

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = spec.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(line_ok(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p and not p.endswith("_torch")
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"]), word
    assert len((spec.MANIFEST).read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    configs = [c["name"] for c in BENCH["configs"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (configs, CELLS, metrics):
        assert len(group) == len(set(group))
    for n in configs + CELLS + metrics:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line_ok(w["why"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


def test_end_to_end_metrics_and_bounds():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert all(c in CELLS for c in m.get("workloads", CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_metric_and_a_layer(cell):
    e2e = [m["name"] for m in spec.metrics_of("end_to_end", cell, BENCH)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of("per_layer", cell, BENCH)


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert "workloads" in m, f"{m['name']} lists no cells (the harness reports a per-layer metric in the cells it lists)"
        assert line_ok(m["layer"]) and m["moves"] in E2E
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["moves"] in [e["name"] for e in spec.metrics_of("end_to_end", cell, BENCH)], (m["name"], cell)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["source"] in ("device_trace", "host_clock")


def test_each_configuration_is_used_and_its_file_found():
    files = set()
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        conf = spec.config_file(c["name"], BENCH)
        assert conf["name"] == c["name"] and conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert spec.reference(conf["reference"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_harness_finds_each_cells_files_by_name(cell):
    w = spec.cell(cell, BENCH)
    traffic = spec.traffic_file(w["traffic"])
    assert hasattr(spec.generator(traffic), "run")
    limits = spec.workload_file(cell)["limits"]
    assert limits and all(v > 0 for v in limits.values())
    for m in spec.metrics_of("per_layer", cell, BENCH):
        assert hasattr(spec.metric_reader(m["name"]), "read")


def test_files_under_paths_are_named_from_name_characters():
    for f in BENCH_DIR.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(BENCH_DIR.parent).as_posix()
        assert PATH.match(rel), rel


def test_the_manifest_is_json_with_no_other_keys():
    json.loads(spec.MANIFEST.read_text())
