"""Nothing the benchmark runs loads the JAX stack or the JAX package
(compared by whole top-level module name: the port's name begins with the
JAX package's), and the plain reference takes nothing of the program."""

import ast
import subprocess
import sys

import pytest

from portbench import harness as H

SOURCES = sorted(p for p in H.HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCES = sorted({H.read_json(H.config_file(H.manifest(), c["name"]))["reference"]
                     for c in H.manifest()["configs"]})


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(H.HERE)))
def test_no_jax_import(path):
    assert not imported_tops(path) & set(H.FORBIDDEN_MODULES)


@pytest.mark.parametrize("name", REFERENCES)
def test_reference_imports_nothing_of_the_program(name):
    path = H.HERE / "configs" / f"{name}.py"
    assert imported_tops(path) <= {"__future__", "contextlib", "math", "typing", "torch"}


def test_forbidden_names_compared_whole():
    assert "tpu_reid_torch" not in H.FORBIDDEN_MODULES
    mods = dict(sys.modules)
    try:
        sys.modules["tpu_reid_torch_fake"] = object()
        assert "tpu_reid_torch_fake" not in H.forbidden_loaded()
        sys.modules["jax"] = object()
        assert "jax" in H.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_a_whole_tiny_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "from portbench import harness as H, run as R\n"
            "from portbench.tests.tiny import tiny_cell\n"
            "for name in ('market.embed', 'market.train'):\n"
            "    R.run_cell(tiny_cell(name), 7, 0.2, False, torch.device('cpu'),\n"
            "               H.SetupClock(0.0))\n"
            "print(H.forbidden_loaded())\n") % str(H.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=H.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
