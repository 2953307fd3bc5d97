"""A cell run on the card through ``run.py``, as the checks run it, with a
short window: the result line's shape, and ``correct``.  Marked ``cuda``;
skips without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import BENCH_DIR

from harness import spec

BENCH = spec.manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", cell, "--seed", str(2**32 + 7),
                          "--seconds", "5", "--trace", str(trace)],
                         cwd=BENCH_DIR.parent, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_of(kind, cell, BENCH)}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for m in line["metrics"].values():
            assert m["value"] <= 105
