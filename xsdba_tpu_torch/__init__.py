"""xsdba_tpu_torch — statistical downscaling and bias adjustment in PyTorch.

The PyTorch/CUDA port of ``xsdba_tpu``: the same containers, time grouping
lowered to static indexes, and train/adjust schemes, as plain functions over
tensors.  A tensor is computed on its own device; numpy data handed to the
public entry points goes to the ``device`` option's device, CUDA unless the
caller asks for the CPU (``set_options(device="cpu")``).  On an NVIDIA GPU
every Pallas kernel of the JAX package has a hand-written CUDA counterpart:
the quantile-table lookups (``ops/cuda/interp_kernel.py``, grouped and
per-row), the windowed quantile's merge engine (``ops/merge.py``) and the
counting-selection engine's key–payload row sort (``ops/sort.py``).
All eleven train/adjust classes of the JAX package are ported:
EmpiricalQuantileMapping, QuantileDeltaMapping and DetrendedQuantileMapping,
with plain and windowed groupings and the dry-day preprocessing of
precipitation (``processing``'s ``adapt_freq`` and jitter); the detrending
objects of ``detrending``; the multivariate MBCn and NpdfTransform, with
``processing``'s ``stack_variables`` / ``unstack_variables``, ``standardize`` /
``unstandardize``, ``reordering`` and ``escore``; Scaling and LOCI; the
second-order ExtremeValues (cluster maxima and Generalized Pareto fits);
PrincipalComponents; OTC and dOTC, whose transport plans are solved on the
host (the port's own C++ network simplex, built by ``g++`` at first use);
and the SBCK gateway ``generate_sbck_classes``.  The diagnostics that
validate an adjustment are ported too: ``properties`` (the 28 statistical
properties: marginal moments and quantiles, spell lengths, annual cycles,
trends, GEV return values, inter-variable and inter-site correlations) and
``measures`` (bias, relative bias, circular bias, ratio, RMSE, MAE, the
annual-cycle correlation, the spatial correlation ratio and the Taylor
diagram), over ``ops/fitting.py``'s batched GEV fits and regressions.
``parallel`` is the multi-device layer: a device mesh over the ranks of a
``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU), inputs
sharded by site, and the spatial diagnostics' and the multivariate
rotation's collectives.
"""

from . import detrending, measures, processing, properties
from .models import (
    LOCI,
    OTC,
    DetrendedQuantileMapping,
    EmpiricalQuantileMapping,
    ExtremeValues,
    MBCn,
    NpdfTransform,
    PrincipalComponents,
    QuantileDeltaMapping,
    Scaling,
    dOTC,
    generate_sbck_classes,
)
from .utils.calendar import TimeIndex, date_range
from .utils.container import DataArray, Dataset
from .utils.grouper import Grouper
from .utils.options import get_option, set_options

__version__ = "0.1.0"

__all__ = [
    "DataArray",
    "Dataset",
    "DetrendedQuantileMapping",
    "EmpiricalQuantileMapping",
    "ExtremeValues",
    "Grouper",
    "LOCI",
    "MBCn",
    "NpdfTransform",
    "OTC",
    "PrincipalComponents",
    "QuantileDeltaMapping",
    "Scaling",
    "TimeIndex",
    "date_range",
    "dOTC",
    "detrending",
    "generate_sbck_classes",
    "get_option",
    "measures",
    "processing",
    "properties",
    "set_options",
]


def __getattr__(name):
    # The JAX package's lazy public API (``xsdba_tpu/__init__.py``): any
    # public name of these modules, searched in this order, resolves at the
    # top level (so ``mean`` is ``properties.mean``).  Their submodules do
    # not: ``from xsdba_tpu_torch import base`` must import the top-level
    # ``base`` module, not find ``models.base`` (ROADMAP C27).
    import importlib
    import inspect

    if name.startswith("_"):
        raise AttributeError(f"module 'xsdba_tpu_torch' has no attribute {name!r}")
    for modname in ("models", "processing", "detrending", "properties", "measures"):
        mod = importlib.import_module(f".{modname}", __name__)
        if hasattr(mod, name) and not inspect.ismodule(getattr(mod, name)):
            return getattr(mod, name)
    raise AttributeError(f"module 'xsdba_tpu_torch' has no attribute {name!r}")
