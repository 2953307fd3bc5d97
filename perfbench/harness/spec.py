"""The manifest (``BENCHMARK.json``) and the files that its names lead to.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by its name:

* ``configs/<config>.json``: the model as it is run;
* ``traffic/<traffic>.json``: the mix's parameters (lengths, batch), with
  the ``generator`` (``traffic/<generator>.py``) that runs it;
* ``workloads/<cell>.json``: what the cell's correctness check compares
  (its sample's size) and each number's limit;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``reference/<family>.py``: a plain reference that configurations name,
  with all the harness knows of the family: the weights' layout, the model
  FLOPs, the attention calls, the decode state and how it is compared.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def cell(name: str, bench: dict | None = None) -> dict:
    """The ``workloads`` entry of ``BENCHMARK.json`` named ``name``."""
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {[w['name'] for w in bench['workloads']]}")


def config_entry(name: str, bench: dict | None = None) -> dict:
    bench = bench or manifest()
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config_file(name: str, bench: dict | None = None) -> dict:
    return load_json(ROOT / config_entry(name, bench)["file"])


def traffic_file(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def workload_file(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name`` (file names
    may hold dots and dashes, which ``import`` does not take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(traffic: dict):
    return load_module(BENCH_DIR / "traffic" / f"{traffic['generator']}.py", f"perfbench_generator_{traffic['generator']}")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))


def reference(family: str):
    """The reference module ``reference/<family>.py`` (that directory is on
    ``sys.path``, as its modules import each other by name)."""
    return importlib.import_module(family)


def metrics_of(kind: str, cell_name: str, bench: dict | None = None) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell_name``
    reports: an end-to-end metric without ``workloads`` is every cell's; a
    per-layer metric lists its cells."""
    bench = bench or manifest()
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]
