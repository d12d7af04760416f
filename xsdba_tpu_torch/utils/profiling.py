"""Profiling helpers: spans and counters inside the port, a trace of the
card in one line, and a synchronised wall time.

``span`` marks a stretch of the port's host code.  Spans are on exactly
while a ``torch.profiler`` session records (``trace`` below, or any other
capture): each enters a ``record_function`` range named ``xsdba.<name>``,
which sits in the trace on the same clock as the kernels, and keeps an
in-memory record (:func:`calls`).  Otherwise ``span`` returns a shared
no-op context and costs one flag check.  The outermost span of a stack is
a call: the public ``train`` and ``adjust`` are the outermost spans of the
port's classes.  A call keeps its spans (name, parent, host nanoseconds)
and the deltas of every counter over its interval; the last
``CALLS_KEPT`` calls are kept.

Counters are always on, as integer increments: ``sync.<site>`` counts the
places the port reads tensor values to the host (on CUDA each one waits for
the card), ``upload.arrays`` and ``upload.bytes`` its copies of host arrays
to a device (``utils/tensor.py:upload``), and the kernel wrappers' launch
counters, kept as attributes of their modules (``MODULE_COUNTERS``), are
read into the same snapshot (:func:`counters`).  The sites count on every
device, so that a run on the CPU shows what the card would wait for.

``trace`` records a ``torch.profiler`` capture (the host's operators and,
where there is a GPU, the card's kernels and copies) and writes it into a
directory as a Chrome-trace JSON file (chrome://tracing, Perfetto).
``timed`` takes the best wall time of a call, each sample ending with
``torch.cuda.synchronize`` on the device of the first tensor of its output:
PyTorch returns before the card finishes, so a host clock without it
measures only the launches.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import math
import os
import sys
import threading
import time

import torch

__all__ = ["calls", "count", "counters", "reset_counters", "reset_spans", "span", "timed", "trace"]

#: public calls (outermost spans) whose records are kept
CALLS_KEPT = 4096
#: counters kept as attributes of the modules that count them: (name in
#: the snapshot, module, attribute, key of a dict attribute or None)
MODULE_COUNTERS = (
    ("launch.sort_rows_alternating", "xsdba_tpu_torch.ops.merge", "launches", "sort_rows_alternating"),
    ("launch.build_levels", "xsdba_tpu_torch.ops.merge", "launches", "build_levels"),
    ("launch.fold_windows", "xsdba_tpu_torch.ops.merge", "launches", "fold_windows"),
    ("launch.merged_window_rows", "xsdba_tpu_torch.ops.merge", "launches", "merged_window_rows"),
    ("launch.interp_table_3d", "xsdba_tpu_torch.ops.cuda.interp_kernel", "launches", None),
    ("launch.interp_table_2d", "xsdba_tpu_torch.ops.cuda.interp_kernel", "launches_2d", None),
    ("launch.interp_bracketed", "xsdba_tpu_torch.ops.cuda.interp_kernel", "launches_bracketed", None),
    ("launch.sort_rows_with_payload", "xsdba_tpu_torch.ops.sort", "launches", None),
    ("launch.fma", "xsdba_tpu_torch.ops.cuda.fma_kernel", "launches", None),
    ("launch.emit", "xsdba_tpu_torch.ops.cuda.emit_kernel", "launches", None),
    ("device_cache.misses", "xsdba_tpu_torch.models._wrap", "misses", None),
)

_COUNTS: dict[str, int] = {}
_CALLS: collections.deque = collections.deque(maxlen=CALLS_KEPT)
_CALL_IDS = itertools.count(1)
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters(prefix: str = "") -> dict[str, int]:
    """One flat snapshot of every counter: those of :func:`count` and
    ``MODULE_COUNTERS`` (0 where the module is not loaded).  With
    ``prefix``, only the counters whose names start with it, the prefix
    taken off (``counters("launch.")`` maps each kernel wrapper to its
    launches)."""
    out = dict(_COUNTS)
    for name, module, attr, key in MODULE_COUNTERS:
        v = getattr(sys.modules.get(module), attr, 0)
        out[name] = int(v.get(key, 0) if isinstance(v, dict) else v)
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def reset_counters() -> None:
    """Set every counter to 0, the module attributes too."""
    _COUNTS.clear()
    for _, module, attr, key in MODULE_COUNTERS:
        mod = sys.modules.get(module)
        if mod is None:
            continue
        if key is None:
            setattr(mod, attr, 0)
        else:
            getattr(mod, attr)[key] = 0


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Span:
    """An open span (see :func:`span`)."""

    __slots__ = ("name", "range", "call", "record", "before", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        if parent is not None and parent.name == self.name:
            return self  # a re-entry: the enclosing span of the same name covers it
        self.range = torch.profiler.record_function("xsdba." + self.name)
        self.range.__enter__()
        if parent is None:
            self.call = {"call": next(_CALL_IDS), "name": self.name, "ns": None, "spans": [], "counters": None}
            self.before = counters()
        else:
            self.call = parent.call
        self.record = {"name": self.name, "parent": parent.name if parent else None, "ns": None, "call": self.call["call"]}
        self.call["spans"].append(self.record)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.range is None:
            return False
        ns = time.perf_counter_ns() - self.t0
        stack = _stack()
        stack.pop()
        self.record["ns"] = ns
        if not stack:
            after = counters()
            self.call["ns"] = ns
            self.call["counters"] = {k: v - self.before.get(k, 0) for k, v in after.items() if v != self.before.get(k, 0)}
            _CALLS.append(self.call)
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking a stretch of the port's host code as the
    span ``name`` (see the module docstring).  Off, while no profiler
    records, it is a shared no-op context.  A span opened directly inside
    one of the same name adds nothing: the outer one covers it."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def calls() -> list[dict]:
    """The kept calls, oldest first, each a dict: ``call`` (its id),
    ``name`` (its outermost span's), ``ns`` (host nanoseconds), ``spans``
    (every span of the call in the order they opened, each a dict of
    ``name``, ``parent`` (the enclosing span's name, None for the
    outermost), ``ns`` and ``call``) and ``counters`` (each counter that
    moved over the call, by its delta)."""
    return list(_CALLS)


def reset_spans() -> None:
    """Forget the kept calls."""
    _CALLS.clear()


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """Capture a ``torch.profiler`` trace of the block and write it into
    ``logdir`` as ``trace_<pid>_<ns>.json`` (Chrome-trace format).

    >>> with trace("traces"):
    ...     scen = eqm.adjust(sim)

    Where ``torch.cuda.is_available()``, the card's activity is recorded,
    and a capture that records none (no kernel and no copy ran on the
    card) raises a ``RuntimeError`` and writes no file.  The JAX profiler's
    ``host_tracer_level`` maps to what is recorded on the host: 0 nothing
    (the card's activity alone; a ``ValueError`` without a GPU), 1 the
    operators, 2 (the default) also their input shapes, 3 also the Python
    call stacks.  A block that raises is not written either.
    """
    from torch.profiler import ProfilerActivity, profile

    if host_tracer_level not in (0, 1, 2, 3):
        raise ValueError(f"host_tracer_level must be 0, 1, 2 or 3, got {host_tracer_level!r}")
    on_card = torch.cuda.is_available()
    if host_tracer_level == 0 and not on_card:
        raise ValueError("host_tracer_level=0 records the card's activity alone, and torch.cuda.is_available() is False")
    activities = ([ProfilerActivity.CPU] if host_tracer_level > 0 else []) + ([ProfilerActivity.CUDA] if on_card else [])
    prof = profile(activities=activities, record_shapes=host_tracer_level >= 2, with_stack=host_tracer_level >= 3)
    prof.start()
    try:
        yield
    finally:
        if on_card:
            torch.cuda.synchronize()
        prof.stop()
    if on_card and not any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no CUDA activity: nothing in the traced block ran on the card")
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _first_tensor(out):
    """The first tensor of ``out`` (a tensor, a DataArray, a Dataset, or a
    list, tuple or dict of them, depth first), or None."""
    from .container import DataArray, Dataset

    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, DataArray):
        return _first_tensor(out.data)
    items = out.values() if isinstance(out, (Dataset, dict)) else out if isinstance(out, (list, tuple)) else ()
    for x in items:
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def _sync(out):
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return out


def timed(fn, *args, reps: int = 3, warmup: int = 1, **kwargs):
    """Best-of-``reps`` wall time of ``fn(*args, **kwargs)`` after
    ``warmup`` calls, each call ended by ``torch.cuda.synchronize`` on the
    device of its output's first tensor (none when that tensor is on the
    CPU).  The host's launch time is in it, so on the card it is at least
    the call's device time.

    Returns ``(best_seconds, last_output)``.
    """
    out = None
    for _ in range(max(warmup, 0)):
        out = _sync(fn(*args, **kwargs))
    best = math.inf
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = _sync(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best, out
