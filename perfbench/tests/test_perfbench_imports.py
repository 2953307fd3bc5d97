"""Nothing under perfbench/ imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the plain references import nothing of the program either."""
from __future__ import annotations

import ast

import pytest
from conftest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH_DIR).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.models".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch", "harness"})


def test_ranges_name_only_the_program(monkeypatch):
    from harness import spec

    for m in spec.manifest()["per_layer"]:
        for mod, _ in getattr(spec.metric_reader(m["name"]), "RANGES", []):
            assert mod.split(".")[0] == "repro_torch"


def test_a_run_on_the_host_loads_no_jax(tmp_path):
    """A tiny run of a prefill cell in a fresh process: once its window
    has closed, ``sys.modules`` holds nothing of JAX or the JAX package."""
    import subprocess
    import sys

    script = tmp_path / "probe.py"
    script.write_text(
        "import sys, json\n"
        f"sys.path[:0] = [{str(BENCH_DIR / 'tests')!r}]\n"
        "import conftest, run\n"
        "from harness import spec\n"
        "conf, t = conftest.tiny_conf('hymba-1.5b'), conftest.tiny_traffic('prefill-1k4k')\n"
        "check = spec.workload_file('hymba-1.5b.prefill-1k4k')['check']\n"
        "spec.generator(t).run(conftest.cpu_ctx(conf, t, check))\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
