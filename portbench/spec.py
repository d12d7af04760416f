"""Everything a cell is made of, found by name from ``BENCHMARK.json``.

- a cell is an entry of ``workloads``; its ``config`` names an entry of
  ``configs``, whose ``file`` holds the configuration as it is run, and
  its ``traffic`` names ``portbench/mixes/<traffic>.json``;
- the configuration names its data (``generators/<generator>.py``), its
  plain reference (``reference/<reference>.py``), the inputs of each
  call and the period each covers, and the port's options it runs under;
- ``portbench/limits/<cell>.json`` holds the numbers that decide
  ``correct`` in that cell, each with the output it compares, its measure
  (``measures/<measure>.py``) and its limit;
- every metric, end to end or per layer, is read by
  ``portbench/metrics/<metric name>.py``, whose ``read(ctx)`` returns its
  value or None where it finds nothing to read;
- ``portbench/layers/<key>.json`` names the port's source files (and,
  where a file serves two layers, its functions) whose device work forms
  the layer ``<key>``.

A cell, configuration, mix, metric, measure or layer is added by adding
its files and its ``BENCHMARK.json`` entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, cell_: dict, root: Path = ROOT) -> dict:
    entry = _entry(bench["configs"], cell_["config"], "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def _pkg(root: Path) -> Path:
    return Path(root) / PKG.name


def mix(cell_: dict, root: Path = ROOT) -> dict:
    return json.loads((_pkg(root) / "mixes" / f"{cell_['traffic']}.json").read_text())


def limits(cell_: dict, root: Path = ROOT) -> dict:
    """{number: {"output", "measure", "limit"}} of the cell."""
    return json.loads((_pkg(root) / "limits" / f"{cell_['name']}.json").read_text())["numbers"]


def layers(root: Path = ROOT) -> dict:
    """{layer key: its description} of every file under ``layers/``."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((_pkg(root) / "layers").glob("*.json"))}


def metrics(bench: dict, cell_: dict, section: str) -> list[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports: those without ``workloads`` and those listing it."""
    return [m for m in bench[section] if "workloads" not in m or cell_["name"] in m["workloads"]]


def module(kind: str, name: str, root: Path = ROOT):
    """The module ``portbench/<kind>/<name>.py`` of the checkout at
    ``root``, loaded from its file as ``portbench.<kind>.<name>``, so that
    its relative imports reach the benchmark's own modules."""
    path = _pkg(root) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{PKG.name}.{kind}.{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The metric reader ``metrics/<name>.py``."""
    return module("metrics", name, root)


def reference(config_: dict, root: Path = ROOT):
    """The plain reference ``reference/<config's reference>.py``."""
    return module("reference", config_["reference"], root)
