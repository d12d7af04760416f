import operator as _op

import numpy as _np

from .calendar import TimeIndex, date_range, interpolate_doy_calendar, max_doy
from .container import DataArray, Dataset
from .grouper import GroupIndexes, Grouper, parse_group, period_blocks
from .helpers import (
    add_cyclic_bounds,
    copy_all_attrs,
    ecdf,
    ensure_longest_doy,
    get_clusters_1d,
    map_cdf,
    map_cdf_1d,
    rand_rot_matrix,
    random_tiebreak,
)
from .options import get_option, set_options
from .units import Quantity, convert_units_to, harmonize_units, infer_sampling_units, pint2cfattrs, str2quantity, units2str

# Kernel-layer names the reference exposes through ``xsdba.utils``,
# re-exported lazily (PEP 562) because ops and processing import this package.
_LAZY = {
    "pc_matrix": "..ops.pca",
    "best_pc_orientation_simple": "..ops.pca",
    "best_pc_orientation_full": "..ops.pca",
    "bin_width_estimator": "..ops.ot",
    "histogram": "..ops.ot",
    "optimal_transport": "..ops.ot",
    "eps_cholesky": "..ops.ot",
    "broadcast": "..processing",
    "equally_spaced_nodes": "..ops.correction",
    "get_correction": "..ops.correction",
    "apply_correction": "..ops.correction",
    "invert": "..ops.correction",
    "rank": "..processing",
    "sort_along_dim": "..processing",
    "get_clusters": "..processing",
    "interp_on_quantiles": "..processing",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


#: Season string -> integer (reference utils.py:403).
SEASON_MAP = {"DJF": 0, "MAM": 1, "JJA": 2, "SON": 3}

#: Vectorized season-string -> int mapper (reference utils.py:405).
map_season_to_int = _np.vectorize(SEASON_MAP.get)

#: Comparison-operator lookup (reference base.py:859-890).
OPERATORS = {
    ">": _op.gt, "gt": _op.gt, "<": _op.lt, "lt": _op.lt,
    ">=": _op.ge, "ge": _op.ge, "<=": _op.le, "le": _op.le,
    "==": _op.eq, "eq": _op.eq, "!=": _op.ne, "ne": _op.ne,
}


def get_op(op: str):
    """The comparison function of an operator string (reference
    base.py:859-890)."""
    try:
        return OPERATORS[op]
    except KeyError as err:
        raise ValueError(f"Operation `{op}` not recognized.") from err
