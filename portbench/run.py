"""The port's benchmark: one cell, one seed, one run.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``) is a configuration of ``xsdba_tpu_torch`` under
a traffic mix.  Set-up makes a pool of distinct blocks of sites on the card
from the seed (``gen.py``), each block's ref, hist and sim wrapped as the
port's ``DataArray``s, and runs one block of each to build and warm every
kernel.
The loop is closed, with one client: a climate service's batch job that
works through its chip's share of a grid one block after another, each
block one public call pair

    <Class>.train(*train_inputs, **config["train"]).adjust(*adjust_inputs, **config["adjust"])

ended by ``torch.cuda.synchronize()``.  The window cycles through the pool
for ``--seconds`` and ends with the block that crosses it.

``--trace 0`` reports the cell's end-to-end metrics.  ``--trace 1`` runs
the window with a synchronisation between train and adjust (the public
calls' host times), then profiles a few blocks twice: once for the
device's busy time, operations and idle gaps, once with Python stacks for
the device time of each layer (``trace.py``); it reports the per-layer
metrics and a breakdown.

Every block keeps the rows of sampled sites of the outputs compared; once
the window has closed and the program's state is freed, the plain
reference checks them (``check.py``).  The last line of standard output is the result; the
numbers compared, each with its limit, end standard error.  The process
runs PyTorch's CPU operators on one thread.  No result is
printed, and the exit code is not 0, without a CUDA device, with fewer
devices than the cell asks for, with a program found outside this
checkout, or when a run has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import check, gen, roofline, spec, trace
from .reference import calendar

FORBIDDEN = ("jax", "jaxlib", "flax", "xsdba_tpu")
PROGRAM = "xsdba_tpu_torch"
#: blocks of each profiled capture of a traced run: without and with stacks
TRACED_BLOCKS = (5, 2)
#: host threads of PyTorch's CPU operators: one client with few threads;
#: an idle pool of eight spread the window's rate and tail between runs
THREADS = 1


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run must not load, each
    compared whole (``xsdba_tpu_torch`` is not ``xsdba_tpu``)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What the metric readers (``metrics/<name>.py``) read from."""

    def __init__(self, config: dict, mix: dict, days: dict):
        self.config, self.mix, self.days = config, mix, days
        self.sites = int(mix["sites_per_block"])
        self.sim_years = int(mix["sim_years"])
        self.setup_s = None
        self.block_s: list[float] = []
        self.window_s = None
        self.block_peak_bytes = None
        self.api_ms: dict[str, list[float]] = {"train": [], "adjust": []}
        self.trace = None            # trace.window() of the capture without stacks
        self.layers = None           # trace.layer_times() of the capture with stacks
        self.layer_blocks = 0

    def shapes(self) -> dict | None:
        """The sizes of a block for the roofline formulas, or None where
        the configuration's grouping has none."""
        return roofline.shapes(self.config, self.mix, self.days)

    def layer_s(self, key: str):
        """Device seconds a block of layer ``key``, or None where the
        traced blocks ran none of it."""
        if not self.layers or not self.layer_blocks or not self.layers.get(key):
            return None
        return self.layers[key] / self.layer_blocks


class Cell:
    """A cell's configuration, mix, limits and sizes, and its pool of blocks
    on ``device`` once :meth:`setup` has run."""

    def __init__(self, name: str, root=spec.ROOT):
        self.bench = spec.load_benchmark(root)
        self.cell = spec.cell(self.bench, name)
        self.config = spec.config(self.bench, self.cell, root)
        self.mix = spec.mix(self.cell, root)
        self.limits = spec.limits(self.cell, root)
        self.root = root
        m = self.mix
        self.calendar = m.get("calendar", self.config["calendar"])
        self.days = {p: calendar.days(self.calendar, m[f"{p}_start"], int(m[f"{p}_years"])) for p in ("train", "sim")}

    def setup(self, seed: int, device):
        import torch

        import xsdba_tpu_torch as xt

        self.marks = [("imports", time.perf_counter())]
        m, cfg = self.mix, self.config
        self.torch, self.device = torch, torch.device(device)
        self.cls = getattr(xt, cfg["class"])
        # the configuration's options of the port (``xsdba_tpu_torch.set_options``), until free()
        self.options = xt.set_options(**cfg.get("options", {})).__enter__()
        dtype = getattr(torch, cfg["dtype"])
        # periods that coincide share one time index, as one dataset's would
        index = {}
        for p, d in self.days.items():
            key = (m[f"{p}_start"], d.n)
            if key not in index:
                index[key] = xt.date_range(key[0], periods=d.n, freq="D", calendar=self.calendar)
        times = {p: index[(m[f"{p}_start"], d.n)] for p, d in self.days.items()}
        self.pool = gen.make_pool(seed, cfg, m, self.days, self.device, dtype, self.root)
        dims = spec.module("generators", cfg["generator"], self.root).DIMS
        attrs = {"units": cfg["units"]}
        self.das = [{k: xt.DataArray(x, dims, {"time": times[cfg["inputs"][k]]}, attrs, cfg["variable"]) for k, x in b.items()}
                    for b in self.pool]
        self.sites = check.sample_sites(seed, len(self.pool), int(m["sites_per_block"]), int(m["sample_sites"]))
        self.site_idx = [torch.as_tensor(s, device=self.device) for s in self.sites]
        self.outputs = check.outputs(self.limits)
        self.records: list = []
        self.seen: dict = {}         # pool entry -> (its first outputs' rows on the device, their host copy)
        self.raised = 0
        self.errors: list[str] = []
        self.sync()
        self.marks.append(("the pool on the device", time.perf_counter()))

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def train(self, k: int):
        return self.cls.train(*(self.das[k][n] for n in self.config["train_inputs"]), **self.config["train"])

    def adjust(self, obj, k: int):
        return obj.adjust(*(self.das[k][n] for n in self.config["adjust_inputs"]), **self.config["adjust"])

    def keep(self, k: int, obj, scen):
        """Keep the sampled sites' rows of the block's outputs compared
        (``scen``, or a variable of the trained dataset).  Rows equal bit
        for bit to the first rows of the same pool entry are recorded as
        those (the host copy already kept, judged once); others are copied
        to the host, so that the device holds no more from block to block
        and the window copies little."""
        idx = self.site_idx[k]
        rows = {o: (scen if o == "scen" else obj.ds[o]).data.index_select(0, idx) for o in self.outputs}
        first = self.seen.get(k)
        if first is not None and all(same_bits(rows[o], first[0][o]) for o in rows):
            self.records.append((k, first[1]))
            return
        host = {o: t.cpu().numpy() for o, t in rows.items()}
        self.seen.setdefault(k, (rows, host))
        self.records.append((k, host))

    def block(self, i: int, api: dict | None = None) -> float:
        """Run block ``i`` (pool entry ``i % pool``); its wall seconds, from
        the start of its train to the synchronisation after its adjust.
        With ``api``, also synchronise after train and add each call's
        milliseconds to it."""
        k = i % len(self.pool)
        t0 = time.perf_counter()
        try:
            obj = self.train(k)
            if api is not None:
                self.sync()
                t1 = time.perf_counter()
            scen = self.adjust(obj, k)
            self.sync()
        except Exception as exc:  # a failed block counts against the run, which goes on
            self.raised += 1
            if len(self.errors) < 3:
                self.errors.append(f"block {i}: {type(exc).__name__}: {exc}")
            self.sync()
            return time.perf_counter() - t0
        t2 = time.perf_counter()
        if api is not None:
            api["train"].append((t1 - t0) * 1e3)
            api["adjust"].append((t2 - t1) * 1e3)
        self.keep(k, obj, scen)
        return t2 - t0

    def window(self, seconds: float, i0: int, api: dict | None = None) -> tuple[list[float], float, int]:
        """Blocks from ``i0`` until ``seconds`` have passed: (block
        seconds, window seconds, next block)."""
        times, i = [], i0
        t0 = time.perf_counter()
        while True:
            times.append(self.block(i, api))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                return times, time.perf_counter() - t0, i

    def samples_to_host(self) -> tuple[list, dict]:
        """The kept rows and each pool entry's sampled inputs, on the host."""
        inputs = {k: {n: a.index_select(0, self.site_idx[k]).cpu().numpy() for n, a in b.items()} for k, b in enumerate(self.pool)}
        return self.records, inputs

    def free(self):
        self.options.__exit__(None, None, None)
        self.pool = self.das = self.records = self.seen = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def expected(self, inputs: dict, rnd=None) -> dict:
        """{pool entry: {output: rows}} of the plain reference on each pool
        entry's sampled inputs (``rnd``: the reference's rounding; the
        control's is bfloat16)."""
        ref_mod = spec.reference(self.config, self.root)
        kw = {"rnd": rnd} if rnd is not None else {}
        return {k: ref_mod.train_adjust(self.config, x, self.days, **kw) for k, x in inputs.items()}

    def verify(self, got: list, inputs: dict) -> dict:
        """Hold the kept rows against the plain reference."""
        return check.compare(got, self.expected(inputs), self.limits, raised=self.raised, root=self.root)


def same_bits(a, b) -> bool:
    """Whether two tensors hold the same bits (a NaN equals a NaN of the
    same pattern, and -0.0 differs from +0.0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.reshape(-1).view(ints), b.reshape(-1).view(ints))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: no reading"
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def run(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda", root=spec.ROOT,
        t_start: float | None = None, log=None) -> dict:
    """One run of cell ``name``; returns the result (see the module
    docstring).  ``log`` receives the lines meant for standard error."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    c = Cell(name, root)
    c.setup(seed, device)
    torch = c.torch
    on_card = c.device.type == "cuda"
    warm = len(c.pool)  # one block of each pool entry builds and loads the kernels, and keeps its first rows
    for i in range(warm):
        c.block(i)
        c.marks.append((f"warm block {i + 1}", time.perf_counter()))
    c.records = []  # a failure among the warm-up blocks still counts
    ctx = Context(c.config, c.mix, c.days)
    ctx.setup_s = time.perf_counter() - t_start
    log("[portbench] set-up seconds: " + ", ".join(
        f"{k} {t - p!r}" for (k, t), p in zip(c.marks, [t_start] + [t for _, t in c.marks[:-1]])))
    setup_peak = torch.cuda.max_memory_allocated(c.device) if on_card else None

    if on_card:
        torch.cuda.reset_peak_memory_stats(c.device)
        base = torch.cuda.memory_allocated(c.device)
    if not traced:
        ctx.block_s, ctx.window_s, _ = c.window(seconds, warm)
        ms = sorted(t * 1e3 for t in ctx.block_s)
        log(f"[portbench] {len(ms)} blocks in {ctx.window_s!r} s; block ms: first {[round(t * 1e3, 3) for t in ctx.block_s[:6]]}, "
            f"min {ms[0]!r}, median {ms[len(ms) // 2]!r}, max {ms[-1]!r}")
    else:
        _, _, nxt = c.window(seconds, warm, api=ctx.api_ms)
        if on_card:
            traced_blocks(c, ctx, nxt, log)
    peak = torch.cuda.max_memory_allocated(c.device) if on_card else None
    if on_card:
        ctx.block_peak_bytes = peak - base
    card = card_line() if on_card else "cpu"

    got, inputs = c.samples_to_host()
    c.free()
    verdict = c.verify(got, inputs)

    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics(c.bench, c.cell, section):
        value = spec.reader(m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            log(f"[portbench] {m['name']} {value!r} {m['unit']} [{card}]")
    if traced and ctx.layers and ctx.layers["total"]:
        per = {k: v / ctx.layer_blocks for k, v in sorted(ctx.layers.items())}
        log("[portbench] device seconds a block by layer (a layer inside another counts in both): "
            + ", ".join(f"{k} {v!r}" for k, v in per.items())
            + f"; other {100 * per.get('other', 0) / per['total']!r} % and unattributed "
            f"{100 * per.get('unattributed', 0) / per['total']!r} % of the device time")

    result = {
        "correct": verdict["correct"],
        "attempted": verdict["attempted"],
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(c.device) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": max(setup_peak, peak) if on_card else 0,
        },
    }
    if traced and ctx.trace:
        result["device"]["busy_s"] = ctx.trace["busy_s"]
        result["device"]["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"], "idle_gaps": ctx.trace["idle_gaps"]}
    result["compared"] = verdict["compared"]
    for line in c.errors:
        log(f"[portbench] {line}")
    log(f"[portbench] {verdict['attempted']} blocks attempted, {verdict['failed']} failed; correct {verdict['correct']}")
    for k, v in verdict["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    return result


def traced_blocks(c: Cell, ctx: Context, i0: int, log):
    """The two profiled captures of a traced run (see the module docstring)."""
    from torch.profiler import record_function

    counters = trace.load_counters(spec.PKG / "counters.json")

    def blocks(n, start):
        def go():
            for i in range(start, start + n):
                with record_function(trace.BLOCK):
                    c.block(i)
        return go

    with tempfile.TemporaryDirectory() as tmp:
        for stacks, n in zip((False, True), TRACED_BLOCKS):
            before = trace.read_counters(counters)
            events = trace.capture(blocks(n, i0), stacks, tmp)
            i0 += n
            lost = trace.missing_kernels(counters, before, trace.read_counters(counters), events)
            if lost:
                raise RuntimeError("the profile is not sound: " + "; ".join(lost))
            if stacks:
                ctx.layers, ctx.layer_blocks = trace.layer_times(events, spec.layers(c.root)), n
                slow = trace.window(events)
                log(f"[portbench] idle gaps of the capture with stacks (the tracer slows the host; seconds over {n} blocks): "
                    + "; ".join(f"{name} {sec!r}" for name, sec in slow["idle_gaps"]))
            else:
                ctx.trace = trace.window(events)
            del events


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(prog="portbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load_benchmark(), a.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {a.workload} needs {cell['chips']} devices, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    found = importlib.util.find_spec(PROGRAM)
    if found is None or spec.ROOT not in Path(found.origin).resolve().parents:
        print(f"portbench: {PROGRAM} is not in this checkout ({spec.ROOT})", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.set_num_threads(THREADS)
    result = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; the benchmark runs the port alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0

