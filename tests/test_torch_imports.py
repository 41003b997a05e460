"""The port's import rule: no module of ``repro_torch`` imports ``jax`` (or
any ``jax*`` package) or anything of the reference package ``repro``, and
no module of the port's analyzer ``tools/analyze_torch`` imports those or
the reference's analyzer ``tools.analyze``. A fresh interpreter imports
every module under ``src/repro_torch`` and ``tools/analyze_torch`` in
turn and notes, after each, the ``jax*``, ``repro.*`` and
``tools.analyze.*`` modules that appeared; each module is then one case.
The module list is read from the file tree, so every test worker
collects the same cases."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _modules():
    out = []
    for base, rel in ((SRC, "repro_torch"),
                      (ROOT, os.path.join("tools", "analyze_torch"))):
        for dirpath, dirnames, files in os.walk(os.path.join(base, rel)):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            pkg = os.path.relpath(dirpath, base).replace(os.sep, ".")
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(pkg if f == "__init__.py" else
                               f"{pkg}.{f[:-3]}")
    return out


MODULES = _modules()

_PROBE = """
import importlib, json, sys
found = {}
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
    found[name] = sorted(m for m in sys.modules
                         if m == "jax" or m.startswith("jax")
                         or m == "repro" or m.startswith("repro.")
                         or m == "tools.analyze"
                         or m.startswith("tools.analyze."))
print(json.dumps(found))
"""


@pytest.fixture(scope="module")
def imported():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, ROOT)))
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_module_is_found():
    assert "repro_torch.launch.dryrun" in MODULES
    assert "repro_torch.core.cost_model" in MODULES
    assert "tools.analyze_torch.trace_safety" in MODULES
    assert "tools.analyze_torch.__main__" in MODULES
    assert len(MODULES) > 70


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_no_jax_and_no_reference(imported, name):
    assert imported[name] == [], (name, imported[name])


_RUN_PROBE = """
import json, sys
from tools.analyze_torch import run_all
run_all(device="cpu")
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax")
                        or m == "repro" or m.startswith("repro.")
                        or m == "tools.analyze"
                        or m.startswith("tools.analyze."))))
"""


def test_analyzer_run_imports_no_jax_and_no_reference():
    """Every pass of ``tools/analyze_torch`` run to its end (the packed
    pass on the CPU) in a fresh interpreter, its lazy imports included:
    no jax, nothing of the reference, not the reference's analyzer."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((SRC, ROOT)))
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", _RUN_PROBE],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
