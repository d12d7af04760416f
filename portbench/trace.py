"""Device traces of a few blocks, read from ``torch.profiler``'s Chrome
trace: busy and idle time, launches, the device time of each layer.

A capture covers whole blocks, each inside a ``portbench.block`` range;
the traced window runs from the first block's start to the last block's
end on the trace's clock.

- Busy time is the union of the device's kernels, copies and fills in the
  window; the idle gaps are named by what the host was doing in the middle
  of each (the innermost host event there).
- Layers: a device operation belongs to every layer one of whose source
  files (``layers/<key>.json``) is on the Python stack of the host call
  that launched it (the launch's correlation id, then the Python frames
  around the launch on its thread; ``with_stack`` captures only).
  Operations under no layer are ``other``; those whose launch or stack
  the trace lacks are ``unattributed``.
- A capture is sound only if it holds a kernel record for every kernel
  launch the host recorded, and a kernel of the right name for every
  launch the port's own counters (``counters.json``) counted.  A profiler
  session in a long-lived process was seen to lose the device records of
  the first 5 to 16 kernels it traced, with their launches recorded
  (PERF.md, PR 20): a listing by kernel then silently lacks them.
"""

from __future__ import annotations

import heapq
import importlib
import json
import os
import re
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
#: host calls that launch one kernel each
KERNEL_LAUNCH = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel")
BLOCK = "portbench.block"


def capture(run, stacks: bool, tmpdir: str) -> list[dict]:
    """Run ``run()`` under ``torch.profiler`` (host and device) and return
    the trace's events; ``stacks`` records the Python calls as well."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_stack=stacks) as prof:
        run()
    path = os.path.join(tmpdir, "portbench_trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _span(e: dict) -> tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def containing(intervals: list[dict], points: list[float]) -> list[list[dict]]:
    """For each point, the intervals (events with ``ts``, ``dur``) that
    contain it."""
    order = sorted(range(len(points)), key=points.__getitem__)
    evs = sorted(intervals, key=lambda e: float(e["ts"]))
    out: list[list[dict]] = [[] for _ in points]
    heap: list = []
    i = 0
    for k in order:
        p = points[k]
        while i < len(evs) and float(evs[i]["ts"]) <= p:
            heapq.heappush(heap, (_span(evs[i])[1], i))
            i += 1
        while heap and heap[0][0] < p:
            heapq.heappop(heap)
        out[k] = [evs[j] for _, j in heap]
    return out


def _merged(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def _port_frame(evs: list[dict]) -> str | None:
    """The innermost frame of the port among host events, or None."""
    frames = [e for e in evs if e.get("cat") == "python_function" and "xsdba_tpu_torch/" in e["name"]]
    return max(frames, key=lambda e: float(e["ts"]))["name"] if frames else None


def window(events: list[dict]) -> dict:
    """Busy and idle time of the device over the traced blocks, its
    operations by time and the idle gaps by what the host was doing: the
    innermost host event in the middle of the gap, after the innermost
    frame of the port where the capture has stacks."""
    blocks = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == BLOCK]
    if not blocks:
        raise RuntimeError("the trace holds no portbench.block range")
    w0 = min(_span(b)[0] for b in blocks)
    w1 = max(_span(b)[1] for b in blocks)
    host_tid = blocks[0].get("tid")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    busy = _merged([(max(a, w0), min(b, w1)) for a, b in map(_span, dev) if b > w0 and a < w1])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X" and e.get("tid") == host_tid]
    around = containing(host, [(a + b) / 2 for a, b in gaps])
    idle: dict = defaultdict(float)
    for (a, b), evs in zip(gaps, around):
        inner = max(evs, key=lambda e: float(e["ts"]), default=None)
        name = inner["name"] if inner else "(no host event)"
        frame = _port_frame(evs)
        idle[_short(f"{frame} > {name}" if frame and frame != name else name)] += (b - a) * 1e-6
    ops: dict = defaultdict(float)
    for e in dev:
        ops[_short(e["name"])] += float(e.get("dur", 0.0)) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return {
        "blocks": len(blocks),
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": sum(1 for e in dev if e["cat"] == "kernel"),
        "device_ops": top(ops),
        "idle_gaps": top(idle),
    }


def _matcher(pattern: str):
    """A frame matcher for ``path/to/file.py`` (any function of the file)
    or ``path/to/file.py:function``."""
    path, _, func = pattern.partition(":")
    if func:
        return lambda name: path + "(" in name and name.endswith("): " + func)
    return lambda name: path in name


def layer_times(events: list[dict], layers: dict) -> dict:
    """{layer: device seconds} over the capture, with ``other``,
    ``unattributed`` and ``total``; a layer inside another counts in both."""
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    py_by_tid = defaultdict(list)
    for e in events:
        if e.get("cat") == "python_function" and e.get("ph") == "X":
            py_by_tid[e.get("tid")].append(e)
    match = {k: [_matcher(p) for p in v["frames"]] for k, v in layers.items()}
    out: dict = defaultdict(float)
    out["total"] = sum(float(d.get("dur", 0.0)) for d in dev) * 1e-6
    by_tid = defaultdict(list)
    for d in dev:
        src = launch.get(d.get("args", {}).get("correlation"))
        if src is None:
            out["unattributed"] += float(d.get("dur", 0.0)) * 1e-6
        else:
            by_tid[src.get("tid")].append((d, float(src["ts"])))
    for tid, items in by_tid.items():
        stacks = containing(py_by_tid.get(tid, []), [p for _, p in items])
        for (d, _), frames in zip(items, stacks):
            sec = float(d.get("dur", 0.0)) * 1e-6
            if not frames:
                out["unattributed"] += sec
                continue
            names = [f["name"] for f in frames]
            hit = [k for k, ms in match.items() if any(m(n) for m in ms for n in names)]
            for k in hit or ["other"]:
                out[k] += sec
    return dict(out)


def load_counters(path: Path) -> list[dict]:
    return json.loads(Path(path).read_text())["counters"]


def read_counters(counters: list[dict]) -> list[int]:
    """The current value of each counter (0 where the port lacks it)."""
    vals = []
    for c in counters:
        try:
            v = getattr(importlib.import_module(c["module"]), c["attr"])
        except (ImportError, AttributeError):
            vals.append(0)
            continue
        vals.append(int(v.get(c["key"], 0) if "key" in c else v))
    return vals


def missing_kernels(counters: list[dict], before: list[int], after: list[int], events: list[dict]) -> list[str]:
    """What the trace lacks: one line if it holds fewer kernel records than
    the host recorded kernel launches, and one for each of the counters'
    name patterns with fewer kernels traced than launches counted."""
    names = [e["name"] for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    launched = sum(1 for e in events if e.get("cat") in LAUNCH_CATS and KERNEL_LAUNCH.match(e.get("name", "")))
    out = [f"{launched} kernel launches recorded on the host, {len(names)} kernels traced"] if len(names) < launched else []
    counted: dict = defaultdict(int)
    for c, b, a in zip(counters, before, after):
        counted[c["kernels"]] += a - b
    for pattern, n in counted.items():
        if n > 0:
            seen = sum(1 for nm in names if re.search(pattern, nm))
            if seen < n:
                out.append(f"{pattern}: {n} launches counted, {seen} kernels traced")
    return out
