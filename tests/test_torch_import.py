"""The port stands without JAX: importing it, or any of its modules, loads no
JAX module, and no source file of the package imports one.

The import check runs in a subprocess, because this test process already
holds JAX (``tests/conftest.py`` imports it).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "xsdba_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import xsdba_tpu_torch
for m in pkgutil.walk_packages(xsdba_tpu_torch.__path__, "xsdba_tpu_torch."):
    importlib.import_module(m.name)
new = sorted(set(sys.modules) - before)
print(json.dumps({
    "jax": [m for m in new if m.split(".")[0] in ("jax", "jaxlib", "xsdba_tpu")],
    "port": [m for m in new if m.startswith("xsdba_tpu_torch")],
    "all": sorted(xsdba_tpu_torch.__all__),
}))
"""


def test_import_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["jax"] == []
    assert "xsdba_tpu_torch.ops.cuda.interp_kernel" in out["port"]
    assert set(out["all"]) >= {
        "date_range", "DataArray", "Dataset", "Grouper", "set_options", "get_option",
        "EmpiricalQuantileMapping", "QuantileDeltaMapping",
    }


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")))
def test_no_source_file_imports_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "xsdba_tpu")], path
