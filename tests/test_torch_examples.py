"""The port's examples (``examples/torch_*.py``) against the JAX package's.

* The three host-only examples (quickstart, dynamic adaptation, fleet
  serving) print the reference examples' lines: plans and predictions
  ``==`` (the host float64 paths), simulated latencies within the device
  stepper's statistical contract (1e-4 relative, plus half of the last
  printed digit), allocator wall-clock times not compared.
* The serving and training examples run reduced on the host: the serving
  example's plan equals the reference's and every real request completes
  with finite outputs; the training example's loss falls and its
  checkpoint (the reference's file) reads back leaf for leaf.
* Every example defaults to the card and refuses to run without one, and
  none imports JAX or the reference package.
"""
import ast
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORTED = {
    "quickstart": "torch_quickstart",
    "multi_tenant_serve": "torch_multi_tenant_serve",
    "dynamic_adaptation": "torch_dynamic_adaptation",
    "fleet_serve": "torch_fleet_serve",
    "train_small": "torch_train_small",
}
NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return buf.getvalue().splitlines(), result


def _simulated(line: str) -> bool:
    """Whether a line reports a simulated latency (or a share derived from
    one), which the device stepper reproduces within its contract."""
    return any(w in line for w in ("simulated", "mean latency", "placement win", "lower)", "baseline"))


def _same_line(got: str, want: str) -> None:
    g, w = NUMBER.findall(got), NUMBER.findall(want)
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want), (got, want)
    if "allocator time" in want:            # a wall-clock time
        g, w = g[:2], w[:2]
    if not _simulated(want):
        assert g == w, (got, want)
        return
    for a, b in zip(g, w, strict=True):
        half = 0.5 * 10.0 ** -len(b.partition(".")[2]) if "." in b else 0.5
        assert abs(float(a) - float(b)) <= half + 1e-4 * abs(float(b)), (got, want)


@pytest.mark.parametrize("name", ["quickstart", "dynamic_adaptation", "fleet_serve"])
def test_host_examples_print_the_references_plans_and_predictions(name):
    want, _ = _stdout(_load(name).main)
    got, _ = _stdout(_load(PORTED[name]).main, ["--device", "cpu"])
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        _same_line(g, w)


def test_multi_tenant_serve_runs_reduced_on_the_host():
    from repro.configs.paper_models import paper_profile
    from repro.core import latency
    from repro.core.allocator import swapless_plan
    from repro.core.planner import TenantSpec
    from repro.hw.specs import EDGE_TPU_PLATFORM

    example = _load("torch_multi_tenant_serve")
    lines, done = _stdout(example.main, ["--device", "cpu", "--requests", "2", "--duration", "300"])
    tenants = [TenantSpec(paper_profile(n), r) for n, r in zip(example.NAMES, example.RATES)]
    plan = swapless_plan(tenants, EDGE_TPU_PLATFORM, example.K_MAX)
    alphas = latency.predict(tenants, plan, EDGE_TPU_PLATFORM).alphas
    assert lines[0] == "plan: " + str(dict(zip(example.NAMES, zip(plan.partition, plan.cores))))
    assert lines[1] == "alphas: " + str([f"{a:.2f}" for a in alphas])
    assert "real engine: 6/6 requests completed" in lines
    assert len(done) == 6 and all(c.error is None and torch.isfinite(c.output).all() for c in done)
    assert sum("outputs_finite=True" in line for line in lines) == 3


def test_train_small_runs_reduced_on_the_host(tmp_path):
    lines, losses = _stdout(_load("torch_train_small").main,
                            ["--device", "cpu", "--steps", "12", "--checkpoint", str(tmp_path / "ckpt")])
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert lines[0].startswith("step   0 loss ") and "checkpoint round-trip OK" in lines
    # The checkpoint is the reference's file: its restore reads it.
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_arch
    from repro.models.transformer import init_params
    from repro.training.checkpoint import restore

    like = init_params(get_arch("minicpm-2b").reduced(), jax.random.PRNGKey(0), dtype=jnp.float32)
    restored = restore(str(tmp_path / "ckpt"), like)
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(restored))


@pytest.mark.parametrize("name", sorted(PORTED.values()))
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])


@pytest.mark.parametrize("name", sorted(PORTED.values()))
def test_examples_import_neither_jax_nor_the_reference(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    # And importing it (with JAX unimportable) pulls in neither.
    code = ("import sys, importlib.util\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            f"spec = importlib.util.spec_from_file_location('x', {str(EXAMPLES / (name + '.py'))!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
