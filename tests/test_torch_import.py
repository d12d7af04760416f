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
import torch
import xsdba_tpu_torch
for m in pkgutil.walk_packages(xsdba_tpu_torch.__path__, "xsdba_tpu_torch."):
    importlib.import_module(m.name)
new = sorted(set(sys.modules) - before)
print(json.dumps({
    "jax": [m for m in new if m.split(".")[0] in ("jax", "jaxlib", "xsdba_tpu")],
    "port": [m for m in new if m.startswith("xsdba_tpu_torch")],
    "all": sorted(xsdba_tpu_torch.__all__),
    "processing": sorted(xsdba_tpu_torch.processing.__all__),
    "detrending": sorted(xsdba_tpu_torch.detrending.__all__),
    "accelerator": [m for m in new if m.split(".")[0] == "triton"],
    "cuda_initialized": torch.cuda.is_initialized(),
    "native_lib_loaded": sys.modules["xsdba_tpu_torch.native"]._lib is not None,
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
    # the multivariate slice's modules import like the rest: no JAX, no
    # Triton, no CUDA context and no build (nothing here has nvcc)
    assert set(out["port"]) >= {
        "xsdba_tpu_torch.processing", "xsdba_tpu_torch.models.mbcn", "xsdba_tpu_torch.models._npdft", "xsdba_tpu_torch.models.scaling",
        "xsdba_tpu_torch.ops.escore", "xsdba_tpu_torch.ops.rotation", "xsdba_tpu_torch.utils.rng",
        # the DQM slice's
        "xsdba_tpu_torch.detrending", "xsdba_tpu_torch.models.dqm", "xsdba_tpu_torch.ops.detrend", "xsdba_tpu_torch.ops.loess",
        # the remaining classes' (the EMD solver's library is built at first use, not on import)
        "xsdba_tpu_torch.models.extremes", "xsdba_tpu_torch.models.pca", "xsdba_tpu_torch.models.otc", "xsdba_tpu_torch.models.sbck",
        "xsdba_tpu_torch.ops.clusters", "xsdba_tpu_torch.ops.fitting", "xsdba_tpu_torch.ops.pca", "xsdba_tpu_torch.ops.ot",
        "xsdba_tpu_torch.native",
    }
    assert out["accelerator"] == [] and out["cuda_initialized"] is False
    assert set(out["all"]) >= {
        "date_range", "DataArray", "Dataset", "Grouper", "set_options", "get_option",
        "EmpiricalQuantileMapping", "QuantileDeltaMapping", "MBCn", "NpdfTransform", "Scaling", "LOCI", "processing",
        "DetrendedQuantileMapping", "detrending",
        "ExtremeValues", "PrincipalComponents", "OTC", "dOTC", "generate_sbck_classes",
    }
    assert out["native_lib_loaded"] is False
    assert set(out["processing"]) == {
        "standardize", "unstandardize", "reordering", "stack_variables", "unstack_variables", "escore",
        "adapt_freq", "jitter", "jitter_under_thresh", "jitter_over_thresh",
        # the rest of the JAX package's processing.py (ROADMAP A7)
        "normalize", "uniform_noise_like", "to_additive_space", "from_additive_space", "stack_periods", "unstack_periods",
        "estimate_delta_from_cf", "spectral_filter", "grouped_time_indexes", "rank", "sort_along_dim", "get_clusters",
        "broadcast", "interp_on_quantiles",
    }
    assert "xsdba_tpu_torch.utils.helpers" in out["port"]
    assert set(out["detrending"]) == {"BaseDetrend", "NoDetrend", "MeanDetrend", "PolyDetrend", "LoessDetrend", "RollingMeanDetrend"}


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


def _top_level_names():
    """(name, module) of every name ``xsdba_tpu`` resolves through its lazy
    ``__getattr__``: the public names of its models, processing, detrending,
    properties and measures, the first module in that order that has each.
    Left out: modules, the JAX namespace, and the JAX package's key stream
    ``next_key`` (the port's stream is ``utils/rng.py:next_generator``, C4)."""
    import importlib
    import inspect

    import xsdba_tpu

    seen = {}
    for modname in ("models", "processing", "detrending", "properties", "measures"):
        mod = importlib.import_module(f"xsdba_tpu.{modname}")
        for name in dir(mod):
            obj = getattr(mod, name)
            if name.startswith("_") or name in seen or name == "next_key" or inspect.ismodule(obj):
                continue
            if (getattr(obj, "__module__", None) or "").split(".")[0] in ("jax", "jaxlib"):
                continue
            assert getattr(xsdba_tpu, name) is obj
            seen[name] = modname
    return sorted(seen.items())


def test_top_level_resolves_the_reference_names():
    """ROADMAP C23: the port's top level resolves each of those names to the
    same-named object of the same module (so ``mean`` is
    ``properties.mean`` in both), and refuses private and unknown names."""
    import importlib

    import xsdba_tpu_torch

    names = _top_level_names()
    assert len(names) > 100 and ("mean", "properties") in names and ("PolyDetrend", "detrending") in names
    for name, modname in names:
        assert getattr(xsdba_tpu_torch, name) is getattr(importlib.import_module(f"xsdba_tpu_torch.{modname}"), name), name
    for name in ("_private", "not_a_name"):
        with pytest.raises(AttributeError):
            getattr(xsdba_tpu_torch, name)


def test_statistical_property_takes_units():
    """ROADMAP C24: ``units=`` is accepted and ignored, as in the JAX package."""
    import inspect

    from xsdba_tpu.properties import StatisticalProperty as JProperty
    from xsdba_tpu_torch.properties import StatisticalProperty

    assert list(inspect.signature(StatisticalProperty).parameters) == list(inspect.signature(JProperty).parameters)
    prop = StatisticalProperty("double", "marginal", lambda da, group="time": da, units="K")
    assert prop.identifier == "double" and not hasattr(prop, "units")
