"""xsdba_tpu_torch — statistical downscaling and bias adjustment in PyTorch.

The PyTorch/CUDA port of ``xsdba_tpu``: the same containers, time grouping
lowered to static indexes, and train/adjust schemes, as plain functions over
tensors on whatever device the data lies.  On an NVIDIA GPU the grouped
quantile-table lookup (``ops/cuda/interp_kernel.py``) and the windowed
quantile's merge engine (``ops/merge.py``) run in hand-written CUDA kernels.
Ported so far: EmpiricalQuantileMapping and QuantileDeltaMapping without
preprocessing, with plain and windowed groupings (ROADMAP.md lists the
rest).
"""

from .models import EmpiricalQuantileMapping, QuantileDeltaMapping
from .utils.calendar import TimeIndex, date_range
from .utils.container import DataArray, Dataset
from .utils.grouper import Grouper
from .utils.options import get_option, set_options

__version__ = "0.1.0"

__all__ = [
    "DataArray",
    "Dataset",
    "EmpiricalQuantileMapping",
    "Grouper",
    "QuantileDeltaMapping",
    "TimeIndex",
    "date_range",
    "get_option",
    "set_options",
]
