"""Profiling helpers: a trace of the card in one line, and a synchronised
wall time.

``trace`` records a ``torch.profiler`` capture (the host's operators and,
where there is a GPU, the card's kernels and copies) and writes it into a
directory as a Chrome-trace JSON file (chrome://tracing, Perfetto).
``timed`` takes the best wall time of a call, each sample ending with
``torch.cuda.synchronize`` on the device of the first tensor of its output:
PyTorch returns before the card finishes, so a host clock without it
measures only the launches.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import torch

from .container import DataArray, Dataset

__all__ = ["timed", "trace"]


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
