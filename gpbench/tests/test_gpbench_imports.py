"""Nothing the chip run imports is JAX or the JAX package, and the
reference imports nothing of the program either; names are compared as
whole top-level module names (online_gp_torch begins with online_gp_t...)."""

import ast
import json
import subprocess
import sys

import pytest

from gpbench import run, spec
from gpbench.tests.small import CELLS, ROOT

JAX = {"jax", "jaxlib", "flax", "online_gp_tpu"}

TOP = "import sys, json; print(json.dumps(sorted({k.split('.')[0] for k in list(sys.modules)})))"


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\n" + TOP], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_neither_jax_nor_the_program():
    """The reference, the check, the generator and every op (whose
    ``replay`` drives the reference) load nothing of the program."""
    mods = _modules("import gpbench.reference, gpbench.check, gpbench.counts, gpbench.traffic\n"
                    "from gpbench import spec\n"
                    "for p in (spec.HERE / 'ops').glob('*.py'):\n"
                    "    spec.op(p.stem)")
    assert not mods & (JAX | {"online_gp_torch"})


# the harness's files that import the program: the systems under test, and
# the diagnosis of the program's faults (its functional core in float64)
IMPORTERS = {"wrappers/online_ski_regression.py", "wrappers/online_ski_classifier.py", "diagnose.py"}


def _imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_only_the_factories_import_the_program():
    """Outside its tests, the harness imports the program in the factory
    files alone (and in ``diagnose.py``), and nothing imports JAX."""
    files = [p for p in spec.HERE.rglob("*.py") if "tests" not in p.relative_to(spec.HERE).parts]
    found = {str(p.relative_to(spec.HERE)) for p in files if "online_gp_torch" in _imports(p)}
    assert found == IMPORTERS
    assert not set().union(*map(_imports, files)) & JAX


@pytest.mark.parametrize("cell", [CELLS[0], "classifier"])
def test_a_run_imports_no_jax(cell):
    made = f"small_cell({cell!r})" if cell != "classifier" else "classifier_cell({}, grid=8, pool=20000)"
    code = ("import time\n"
            "from gpbench.tests.small import small_cell\nfrom gpbench.tests.classifier import classifier_cell\n"
            "from gpbench import run\n"
            f"out = run.run_cell({made}, 7, 0.2, False, 'cpu', time.perf_counter())\n"
            "assert out['failed'] == 0")
    mods = _modules(code)
    assert "online_gp_torch" in mods
    assert not mods & JAX


@pytest.mark.parametrize("loaded,flagged", [
    ("online_gp_torch.api", []), ("online_gp_tpu.ops", ["online_gp_tpu"]), ("jaxtyping", []),
    ("jax.numpy", ["jax"]), ("flax", ["flax"]), ("online_gp_tpu_extra", []),
])
def test_whole_name_comparison(monkeypatch, loaded, flagged):
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, loaded, sys)
    assert run.forbidden_modules() == sorted(set(before) | set(flagged))
