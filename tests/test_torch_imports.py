"""The port's import rule: no module of ``repro_torch`` imports ``jax`` (or
any ``jax*`` package) or anything of the reference package ``repro``. A
fresh interpreter imports every module under ``src/repro_torch`` in turn
and notes, after each, the ``jax*`` and ``repro.*`` modules that appeared;
each module is then one case. The module list is read from the file
tree, so every test worker collects the same cases."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _modules():
    out = []
    root = os.path.join(SRC, "repro_torch")
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        pkg = os.path.relpath(dirpath, SRC).replace(os.sep, ".")
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
                         or m == "repro" or m.startswith("repro."))
print(json.dumps(found))
"""


@pytest.fixture(scope="module")
def imported():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_module_is_found():
    assert "repro_torch.launch.dryrun" in MODULES
    assert "repro_torch.core.cost_model" in MODULES
    assert len(MODULES) > 60


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_no_jax_and_no_reference(imported, name):
    assert imported[name] == [], (name, imported[name])
