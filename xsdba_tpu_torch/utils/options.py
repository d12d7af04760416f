"""Global/context options — mirrors reference ``options.py:12-83``.

Beyond the reference's two output options, the TPU build exposes its
windowed-quantile ENGINE choices here (the reference's pattern of
config-as-options, ``options.py:28-83``): which backend computes windowed
grouped quantiles, its extraction mode, and two Pallas program-shape
toggles.  Each engine option's process default can also be set by an
environment variable (``XSDBA_SELECTION_BACKEND=0`` etc.) so an A/B flip
never needs a source edit.

Engine options are resolved OUTSIDE jit at call sites and threaded into the
compiled programs as static arguments, so flipping one under ``set_options``
re-traces correctly (no stale-cache hazard).
"""

from __future__ import annotations

import contextlib
import os

__all__ = [
    "AS_DATASET",
    "EXTRA_OUTPUT",
    "EXTRACT_FLAT",
    "EXTRACT_MODE",
    "FUSE_FOLD_CLASSES",
    "OPTIONS",
    "SELECTION_BACKEND",
    "SELECTION_MODE",
    "SELECTION_ON_TPU",
    "SELECTION_SORT",
    "get_option",
    "set_options",
]

EXTRA_OUTPUT = "extra_output"
AS_DATASET = "as_dataset"
#: Allow the counting-selection backend for windowed grouped quantiles
#: (ops/selquant.py).  False forces the merge cascade everywhere.
SELECTION_BACKEND = "selection_backend"
#: Route TPU windowed quantiles through the selection backend too (the
#: measured default keeps the merge cascade on TPU; docs/PERFORMANCE.md
#: "Selection-class roofline").
SELECTION_ON_TPU = "selection_on_tpu"
#: Selection extraction engine: "auto" (per-backend measured default:
#: gather on CPU, emit on TPU), "emit", or "gather".
SELECTION_MODE = "selection_mode"
#: Selection stage-1 sort implementation: "auto" (Pallas bitonic network on
#: TPU f32 — measured 14% under ``lax.sort`` at the heavy shape,
#: docs/PERFORMANCE.md; ``lax.sort`` elsewhere), "pallas", "xla" (the same
#: network lowered through plain XLA — the CPU-testable form), or "lax".
SELECTION_SORT = "selection_sort"
#: Run all merge-fold classes in ONE Pallas program (measured faster on
#: v5e) vs per-class launches.
FUSE_FOLD_CLASSES = "fuse_fold_classes"
#: Static-count extraction form: flat constant-index gather (True) vs
#: 32-wide strip selects (False); bit-identical outputs.  Subsumed by
#: ``extract_mode`` — kept as the back-compat boolean.
EXTRACT_FLAT = "extract_flat"
#: Static-count extraction engine: "strip" (32-wide static slices +
#: constant-mask selects), "flat" (one constant-index gather from the
#: flattened group axis), "matmul" (one-hot MXU contraction at
#: Precision.HIGHEST — bit-exact for f32, see ops/quantile.py), or "auto"
#: (the measured per-backend default; honors ``extract_flat=True``).
EXTRACT_MODE = "extract_mode"


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "no", "off", "")


_DEFAULTS = {
    EXTRA_OUTPUT: False,
    AS_DATASET: False,
    SELECTION_BACKEND: _env_bool("XSDBA_SELECTION_BACKEND", True),
    SELECTION_ON_TPU: _env_bool("XSDBA_SELECTION_ON_TPU", False),
    SELECTION_MODE: os.environ.get("XSDBA_SELECTION_MODE", "auto"),
    SELECTION_SORT: os.environ.get("XSDBA_SELECTION_SORT", "auto"),
    FUSE_FOLD_CLASSES: _env_bool("XSDBA_FUSE_FOLD_CLASSES", True),
    EXTRACT_FLAT: _env_bool("XSDBA_EXTRACT_FLAT", False),
    EXTRACT_MODE: os.environ.get("XSDBA_EXTRACT_MODE", "auto"),
}

_VALIDATORS = {
    SELECTION_MODE: lambda v: v in ("auto", "emit", "gather"),
    SELECTION_SORT: lambda v: v in ("auto", "pallas", "xla", "lax"),
    EXTRACT_MODE: lambda v: v in ("auto", "strip", "flat", "matmul"),
}
# process-global, like the reference's plain OPTIONS dict (options.py:12-83):
# a main-thread set_options(...) must be visible to worker threads
_GLOBAL_STACK = [dict(_DEFAULTS)]


def _stack():
    return _GLOBAL_STACK


def get_option(name: str):
    return _stack()[-1][name]


class set_options(contextlib.AbstractContextManager):
    """Set options globally or as a context manager.

    >>> with set_options(extra_output=True):
    ...     ...
    """

    def __init__(self, **kwargs):
        bad = set(kwargs) - set(_DEFAULTS)
        if bad:
            raise ValueError(f"Unknown options: {sorted(bad)}")
        for k, v in kwargs.items():
            check = _VALIDATORS.get(k)
            if check is not None and not check(v):
                raise ValueError(f"Invalid value for option {k!r}: {v!r}")
        new = dict(_stack()[-1])
        new.update(kwargs)
        _stack().append(new)
        self._entered = False

    def __enter__(self):
        self._entered = True
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False

    def __del__(self):
        # Used without `with`: apply globally (keep on the stack).
        pass


class _OptionsView:
    """Read-only live mapping of the CURRENT option values (reference
    options.py:17-20 exposes a plain ``OPTIONS`` dict; here options are a
    thread-local context stack, so this view always reads the stack top)."""

    def __getitem__(self, name):
        return get_option(name)

    def __iter__(self):
        return iter(_stack()[-1])

    def __len__(self):
        return len(_stack()[-1])

    def __contains__(self, name):
        return name in _stack()[-1]

    def keys(self):
        return _stack()[-1].keys()

    def items(self):
        return _stack()[-1].items()

    def __repr__(self):
        return f"OPTIONS({dict(_stack()[-1])})"


OPTIONS = _OptionsView()
