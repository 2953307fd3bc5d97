"""The port's serve entry point against the JAX package's, and the port's
independence from JAX."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.launch import serve as ref_serve
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--requests", "2", "--duration", "10"]


def _planning_lines(text):
    """The plan, predicted and simulated lines (everything before the real
    execution, whose latencies are wall-clock)."""
    lines = text.splitlines()
    return lines[: next(i for i, l in enumerate(lines) if l.startswith("real execution"))]


def test_serve_prints_the_reference_plan_predictions_and_simulation(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", *ARGS])
    ref_serve.main()
    want = capsys.readouterr().out
    plan, done = serve.main([*ARGS, "--device", "cpu"])
    got = capsys.readouterr().out
    assert _planning_lines(got) == _planning_lines(want)
    assert len(_planning_lines(got)) == 5
    # Then the real requests, all completed on the host.
    assert len(done) == 4 and all(c.ok for c in done)
    assert "real execution: 4 requests completed" in got
    assert plan.partition == (7, 4)


def test_serve_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(ARGS)


def _run(code, cwd=ROOT):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
    )


def test_port_and_chip_smoke_import_neither_jax_nor_the_reference():
    proc = _run(
        """
        import importlib, pkgutil, sys
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(mod.name)
        sys.path.insert(0, ".")
        import chip_smoke
        bad = sorted(
            n for n in sys.modules
            if n in ("jax", "repro") or n.startswith(("jax.", "jaxlib", "repro."))
        )
        print("imported:", len([n for n in sys.modules if n.startswith("repro_torch")]))
        print("bad:", bad)
        sys.exit(1 if bad else 0)
        """
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bad: []" in proc.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    # With no CUDA device, and in a directory holding chip_smoke.py alone,
    # the script exits non-zero and prints no result line.
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=script.parent,
            capture_output=True, text=True, timeout=120,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        )
        assert proc.returncode != 0, script
        assert '"ok"' not in proc.stdout
