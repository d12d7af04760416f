"""Global/context options — mirrors reference ``options.py:12-83``.

Beyond the reference's two output options, the JAX package exposes its
windowed-quantile ENGINE choices here (the reference's pattern of
config-as-options, ``options.py:28-83``); the port keeps their names, so one
``set_options`` call means the same in both packages, and resolves them at
each call from the data's device.  Each engine option's process default can
also be set by an environment variable (``XSDBA_SELECTION_BACKEND=0`` etc.).
The port adds one option of its own, ``device``: where numpy data handed to
the public entry points is computed (CUDA unless the caller asks for the
CPU).
"""

from __future__ import annotations

import contextlib
import os

__all__ = [
    "AS_DATASET",
    "DEVICE",
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
#: Allow the counting-selection engine for windowed grouped quantiles
#: (ops/selquant.py).  False forces the merge engine everywhere.
SELECTION_BACKEND = "selection_backend"
#: Route CUDA windowed quantiles through the selection engine too.  The
#: name is the JAX package's (there: TPU); in the port the CPU selects by
#: default and CUDA takes the merge engine unless this is True.
SELECTION_ON_TPU = "selection_on_tpu"
#: Selection extraction engine: "emit" (the dense emission: the
#: hand-written kernel csrc/emit_kernel.cu on CUDA, the reference's plain
#: form on the CPU), "gather" (the per-query block gather) or "auto", which
#: is "gather" on the CPU and "emit" on CUDA, as the reference resolves it
#: per backend (ops/selquant.py:default_mode).  Equal outputs.
SELECTION_MODE = "selection_mode"
#: Selection stage-1 sort: "auto" (the row sort's CUDA kernel, K7, for
#: float32 on CUDA; a stable ``torch.sort`` elsewhere), "pallas" (the row
#: sort's wrapper: K7 on a CUDA tensor, its plain twin on a CPU tensor),
#: "xla" (the plain twin), or "lax" (a stable ``torch.sort``).
SELECTION_SORT = "selection_sort"
#: Accepted for parity with the JAX package, with no effect: there it picks
#: one Pallas program for every merge-fold class or one a class (a TPU
#: choice); the port's fold is one kernel launch a call (K6), which serves
#: every value with equal output.
FUSE_FOLD_CLASSES = "fuse_fold_classes"
#: Accepted for parity, with no effect: the JAX package's back-compat
#: boolean for ``extract_mode`` (flat gather against strip selects).
EXTRACT_FLAT = "extract_flat"
#: Accepted for parity, with no effect: the JAX package's static-count
#: extraction forms ("strip", "flat", "matmul", "auto") are TPU forms of one
#: gather with equal outputs; the port has one extraction form, which
#: serves every value.
EXTRACT_MODE = "extract_mode"
#: Device of numpy data entering the public entry points (``train``,
#: ``adjust``, ``Grouper.apply``): "cuda" (the default; raises when no GPU
#: is available) or "cpu", or a "cuda:N" device.  Tensors keep their own
#: device.
DEVICE = "device"


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
    DEVICE: "cuda",
}

_VALIDATORS = {
    SELECTION_MODE: lambda v: v in ("auto", "emit", "gather"),
    SELECTION_SORT: lambda v: v in ("auto", "pallas", "xla", "lax"),
    EXTRACT_MODE: lambda v: v in ("auto", "strip", "flat", "matmul"),
    DEVICE: lambda v: str(v).split(":")[0] in ("cpu", "cuda"),
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
