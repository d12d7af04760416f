"""The reference's ``xsdba.base`` import path.

Beside the re-exports, this module carries eager forms of the reference's
dask helpers (``map_blocks``, ``map_groups``, ``uses_dask``,
``ensure_chunk_size``, ``duck_empty``; reference base.py:541-860): the
port's data are whole tensors, never dask blocks, and grouping is lowered
to static indexes, so each helper's single-block semantics is its whole
contract here.
"""

from __future__ import annotations

import functools

import numpy as np

from .processing import stack_periods, unstack_periods  # noqa: F401
from .utils import get_op  # noqa: F401
from .utils.calendar import (  # noqa: F401
    MAX_DOY as max_doy,
    compare_offsets,
    construct_offset,
    interpolate_doy_calendar,
    parse_offset,
)
from .utils.container import DataArray
from .utils.grouper import Grouper, parse_group  # noqa: F401
from .utils.params import Parametrizable, ParametrizableWithDataset  # noqa: F401

#: Calendars with a fixed year length (reference base.py:1048).
uniform_calendars = ("noleap", "all_leap", "365_day", "366_day", "360_day")


def uses_dask(*das) -> bool:
    """Whether any input wraps a dask array (reference base.py:834-846).

    The port holds numpy arrays and torch tensors, never dask arrays, so
    this is always False: user code that branches on it takes the eager
    path."""
    return False


def ensure_chunk_size(da, **minchunks):
    """Identity (reference base.py:782-831 rechunks dask blocks): tensors
    have no chunks to repair."""
    return da


def duck_empty(dims, sizes, dtype="float64", chunks=None) -> DataArray:
    """An uninitialised DataArray of the given dims and sizes (reference
    base.py:541-560), held in host memory as the reference holds it; the
    ``chunks`` argument is accepted and ignored."""
    shape = tuple(int(sizes[d]) for d in dims)
    return DataArray(np.empty(shape, dtype=dtype), tuple(dims), {}, {}, None)


def map_blocks(reduces=None, **out_vars):
    """Decorator marking a function as block-mappable (reference
    base.py:563-726).  With whole tensors the input is one block, so the
    wrapper calls ``func`` on it; ``reduces`` and ``out_vars`` are kept as
    metadata only."""

    def _decorator(func):
        @functools.wraps(func)
        def _wrapped(ds, **kwargs):
            return func(ds, **kwargs)

        _wrapped.__mapped__ = True
        _wrapped.__reduces__ = reduces
        _wrapped.__out_vars__ = out_vars
        return _wrapped

    return _decorator


def map_groups(reduces=None, main_only: bool = False, **out_vars):
    """Decorator for functions acting on one group's samples (reference
    base.py:729-779).  The decorated function has the reference signature
    ``func(da, *, dim, **kwargs)``, ``dim`` naming the stacked sample
    dimension; the wrapper is called as ``wrapped(da, group=Grouper(...),
    **kwargs)`` and runs ``func`` over every group at once through
    ``Grouper.apply``: the samples gathered along a trailing ``dim`` axis
    (window members included, NaN-padded) on the data's device (numpy data
    on the ``device`` option's), which ``func`` reduces.  The DataArray
    reductions (``mean``, ``std``, ...) skip the padding; the result carries
    the group coordinate.
    """

    def _decorator(func):
        @functools.wraps(func)
        def _wrapped(da, *, group, **kwargs):
            if isinstance(group, str):
                group = Grouper(group)
            member_dim = "stacked_sample"

            def _on_gathered(v):
                # v: [..., G, L]: batch dims, padded groups, gathered members
                nb = v.ndim - 2
                dims = tuple(f"dim_{i}" for i in range(nb)) + (group.prop_name, member_dim)
                out = func(DataArray(v, dims, {}, {}, None), dim=member_dim, **kwargs)
                return out.data if isinstance(out, DataArray) else out

            return group.apply(_on_gathered, da, main_only=main_only)

        _wrapped.__mapped__ = True
        _wrapped.__reduces__ = reduces
        _wrapped.__out_vars__ = out_vars
        return _wrapped

    return _decorator
