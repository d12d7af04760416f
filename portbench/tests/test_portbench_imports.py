"""What the benchmark may import: nothing of JAX or the JAX package, and
in the reference nothing of the port either.  Top-level module names are
compared whole: ``xsdba_tpu_torch`` is not ``xsdba_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run

PKG = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "xsdba_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of the absolute imports of a file, and ``.`` for a
    relative import that leaves its package."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                out.add(node.module.partition(".")[0])
            elif node.level > 1:
                out.add(".")
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(arg.value.partition(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert not _imports(path) & JAX, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").rglob("*.py"):
        names = _imports(path)
        assert "xsdba_tpu_torch" not in names and "." not in names, path
        assert names <= {"__future__", "dataclasses", "numpy", "scipy"}, (path, names)


def test_names_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["xsdba_tpu_torch_probe"] = sys
        assert "xsdba_tpu" not in run.forbidden_modules()
        sys.modules["xsdba_tpu.models"] = sys
        assert "xsdba_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax(tiny_root):
    """A whole run of a cell (on the CPU, at a tiny size) in a fresh
    interpreter leaves no module of JAX or the JAX package loaded."""
    code = (
        "import xsdba_tpu_torch as xt\n"
        "from portbench import run\n"
        "with xt.set_options(selection_backend=False):\n"
        f"    r = run.run('eqm_doy31_tas.cal30_sim150', 3, 0.2, False, 'cpu', root={str(tiny_root)!r}, log=lambda s: None)\n"
        "assert r['correct'], r\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
