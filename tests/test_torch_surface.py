"""The port's package surface against the reference's.

Each of ``repro_torch.configs``, ``.core``, ``.data``, ``.hw``,
``.launch``, ``.models``, ``.profiler``, ``.roofline``, ``.serving`` and
``.training`` re-exports the reference package's public names, less the
ones whose modules are not ported yet (listed here, so that a slice that
ports one must take its names off the list).
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

NOT_YET_PORTED = {
    "configs": (),
    "core": (),
    "data": (),
    "hw": (),
    "launch": (),
    "models": (),
    "profiler": (),
    "roofline": (),
    "serving": (),
    "training": (),
}


@pytest.mark.parametrize("package", sorted(NOT_YET_PORTED))
def test_all_is_the_references_less_what_is_not_ported(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = NOT_YET_PORTED[package]
    assert set(missing) <= set(ref.__all__), set(missing) - set(ref.__all__)
    assert sorted(port.__all__) == sorted(set(ref.__all__) - set(missing))
    assert len(port.__all__) == len(set(port.__all__))


@pytest.mark.parametrize("package", sorted(NOT_YET_PORTED))
def test_every_listed_name_imports(package):
    port = importlib.import_module(f"repro_torch.{package}")
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    ns = {}
    exec(f"from repro_torch.{package} import *", ns)
    assert set(port.__all__) <= set(ns)


def test_reference_idiom_imports_without_jax():
    """``from repro_torch.core import Plan``, the CNN module (which imports
    ``serving.engine``), the simulators, the device stepper and evaluator,
    the controller and the fleet layers, the training package, the data
    pipeline, the train launcher and the dry run import in a fresh
    interpreter, with neither JAX nor the reference package loaded."""
    code = (
        "import sys\n"
        "from repro_torch.core import Plan, swapless_plan\n"
        "from repro_torch.serving import ServingEngine, poisson_trace\n"
        "from repro_torch.hw import EDGE_TPU_PLATFORM\n"
        "import repro_torch.models.cnn\n"
        "import repro_torch.serving.des, repro_torch.serving.torch_stepper\n"
        "import repro_torch.serving.controller, repro_torch.serving.fleet\n"
        "import repro_torch.core.torch_eval, repro_torch.core.fleet\n"
        "from repro_torch.training import make_train_step, AdamWConfig\n"
        "from repro_torch.data import batches_for_arch\n"
        "import repro_torch.launch.train, repro_torch.training.checkpoint\n"
        "import repro_torch.launch.dryrun, repro_torch.roofline.counter\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), timeout=120)


def _env():
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env
