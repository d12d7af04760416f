"""Smoke run of the PyTorch/CUDA port (``xsdba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on lines of its own:

1. device: requires ``torch.cuda.is_available()``; prints the torch version
   and the card's name and power limit (``nvidia-smi``);
2. build: compiles every CUDA source under ``xsdba_tpu_torch/csrc/`` (one
   ``nvcc`` each, all at once);
3. kernel: each kernel against its plain PyTorch twin, on the card, on the
   inputs its path gives it: the lookup (K1) at the headline partition
   shape with every edge case it has, bit for bit; the row sort (K3), the
   level build (K5) and the window fold (K6) on the heavy path's slab of
   512 rows (ref and hist of 256 sites), and the per-group merge (K4) on the
   window-5 path's slab, each printing how many values differ under ``==``
   (-0.0 equals +0.0);
4. main path: ``QuantileDeltaMapping.train(...).adjust(...)`` on CUDA
   tensors of 512 sites x 150 noleap years, f32, ``nquantiles=50``,
   monthly groups; finite, through K1, and equal to the port's CPU path on
   the first 8 sites at rtol = atol = 2e-6;
5. heavy: ``EmpiricalQuantileMapping.train(group="time.dayofyear",
   window=31).adjust(interp="linear")`` on CUDA tensors of 256 sites x 150
   noleap years (``bench.py``'s heavy data: seed 1, ref ~ N(10, 2), hist ~
   N(12, 3), sim ~ N(13, 3), f32, ``nquantiles=50``); finite, through K3,
   K5, K6 and K1, and equal on the first 4 sites to the port's CPU path and
   to the re-sort oracle (``eqm_train_from_raw`` + ``qm_adjust_core``) at
   rtol = atol = 2e-6; then the same at window 5, through K3 and K4;
6. times (2 warm-ups, median of 5 and the spread): the fused QDM and
   windowed EQM steps in gridpoint-years/s (CUDA events), the public calls
   on the same data (host clock), each kernel against its twin (CUDA
   events, in turns), the peak device memory of the heavy step and of the
   heavy public call, and for each fused step the five kernels that take
   the most device time plus the port's own kernels (``torch.profiler``).

Each path's kernel launches are counted from 0 just before it runs and read
just after; launches made to compare a kernel with its twin do not count.
The line before the last is one JSON object describing the kernels (K1's
launches are the QDM path's, K3, K5 and K6's the heavy path's, K4's the
window-5 path's); the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import xsdba_tpu_torch as xp
from xsdba_tpu_torch.models._algos import eqm_train_adjust_windowed, eqm_train_from_raw, qdm_train_adjust_core, qm_adjust_core
from xsdba_tpu_torch.models._wrap import device_brackets
from xsdba_tpu_torch.ops import merge
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes
from xsdba_tpu_torch.ops.cuda import _build, interp_kernel
from xsdba_tpu_torch.ops.interp import _compact_nan_pairs
from xsdba_tpu_torch.ops.quantile import merge_slab

N_SITES, N_YEARS, NQ = 512, 150, 50
CHECK_SITES = 8
HEAVY_SITES, HEAVY_YEARS, HEAVY_WINDOW = 256, 150, 31
HEAVY_CHECK = 4
SMALL_WINDOW = 5
TOL = dict(rtol=2e-6, atol=2e-6)
_SRC = "xsdba_tpu_torch/csrc/"
_PALLAS = "xsdba_tpu/ops/pallas/"
KERNELS = {
    "K1": dict(name="interp_table_3d", route="cuda", source=_SRC + "interp_kernel.cu", replaces=_PALLAS + "interp_kernel.py:101"),
    "K3": dict(name="sort_rows_alternating", route="cuda", source=_SRC + "merge_kernel.cu", replaces=_PALLAS + "merge_kernel.py:171"),
    "K4": dict(name="merged_window_rows", route="cuda", source=_SRC + "merge_kernel.cu", replaces=_PALLAS + "merge_kernel.py:271"),
    "K5": dict(name="build_levels", route="cuda", source=_SRC + "merge_kernel.cu", replaces=_PALLAS + "merge_kernel.py:477"),
    "K6": dict(name="fold_windows", route="cuda", source=_SRC + "merge_kernel.cu", replaces=_PALLAS + "merge_kernel.py:636"),
}


def lookup_inputs(B, Gp, Lp, nq, seed=0, device="cpu"):
    """Compacted f32 lookup tables [B, Gp, nq] and values [B, Gp, Lp] with
    every edge case of the lookup: NaN pairs inside tables, whole-NaN rows
    (nvalid = 0), single-node rows with values exactly on the node (and a
    NaN y in the pad slot), NaN values, and values below and above each
    table.  Returns (v, xs, ys, nvalid int32) on ``device``."""
    rng = np.random.default_rng(seed)
    R = B * Gp
    xq = np.sort(rng.normal(0, 1, (R, nq)), axis=-1)
    yq = rng.normal(0, 1, (R, nq))
    rows = rng.permutation(R)
    k = max(R // 50, 1)
    nan_pair, empty, single = rows[:k], rows[k : 2 * k], rows[2 * k : 3 * k]
    xq[nan_pair, rng.integers(0, nq, k)] = np.nan
    yq[nan_pair, rng.integers(0, nq, k)] = np.nan
    xq[empty] = np.nan
    xq[single, 1:] = np.nan
    yq[single, 1:] = np.nan
    xs, ys, nv = _compact_nan_pairs(torch.as_tensor(xq, dtype=torch.float32), torch.as_tensor(yq, dtype=torch.float32))
    v = rng.normal(0, 3, (R, Lp)).astype(np.float32)   # ~half outside [x_first, x_last]
    v[rng.random((R, Lp)) < 0.01] = np.nan
    v[single, ::7] = xs[single, :1].numpy()             # exactly on the single node
    shape = lambda a, *tail: a.reshape(B, Gp, *tail).contiguous().to(device)  # noqa: E731
    return shape(torch.from_numpy(v), Lp), shape(xs, nq), shape(ys, nq), shape(nv.to(torch.int32))


def example_problem(n_sites, n_years, seed=0, start="2000-01-01"):
    """The headline data recipe (``__graft_entry__._example_problem``):
    numpy f32 ref ~ N(10, 2), hist ~ N(12, 3), sim ~ N(13, 3), drawn in turn
    from one generator, over ``n_years`` noleap years of daily data."""
    t = xp.date_range(start, periods=365 * n_years, freq="D", calendar="noleap")
    rng = np.random.default_rng(seed)
    T = len(t)
    data = [rng.normal(mu, sd, (n_sites, T)).astype(np.float32) for mu, sd in ((10, 2), (12, 3), (13, 3))]
    return t, data


def heavy_problem(n_sites, n_years):
    """The heavy data recipe (``bench.py:174-183``): the same distributions
    from seed 1, noleap days from 1950."""
    return example_problem(n_sites, n_years, seed=1, start="1950-01-01")


def _da(x, t, name):
    return xp.DataArray(x, ("site", "time"), {"time": t}, {"units": "K"}, name)


def run_main_path(ref, hist, sim, t):
    """The public QDM path on [site, time] tensors (on their device)."""
    qdm = xp.QuantileDeltaMapping.train(_da(ref, t, "ref"), _da(hist, t, "hist"), group="time.month", nquantiles=NQ, kind="+")
    return qdm.adjust(_da(sim, t, "sim"), interp="linear").data


def run_windowed_path(ref, hist, sim, t, window=HEAVY_WINDOW):
    """The public windowed EQM path (dayofyear groups, ``window`` days) on
    [site, time] tensors (on their device)."""
    eqm = xp.EmpiricalQuantileMapping.train(
        _da(ref, t, "ref"), _da(hist, t, "hist"), group="time.dayofyear", window=window, nquantiles=NQ, kind="+"
    )
    return eqm.adjust(_da(sim, t, "sim"), interp="linear").data


def resort_oracle(ref, hist, sim, t, window=HEAVY_WINDOW):
    """Windowed EQM by the re-sort path: every group's window gathered and
    sorted (``eqm_train_from_raw``), then ``qm_adjust_core``."""
    gi = xp.Grouper("time.dayofyear", window=window).indexes(t)
    q = torch.as_tensor(equally_spaced_nodes(NQ), dtype=ref.dtype, device=ref.device)
    af, hist_q = eqm_train_from_raw(ref, hist, torch.as_tensor(gi.gather_idx, device=ref.device), q, kind="+")
    return qm_adjust_core(sim, hist_q, af, device_brackets(gi, "linear", ref.device), kind="+", interp="linear", extrapolation="constant", tables_compact=True)


def _nan_equal(a, b):
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _max_abs(a, b):
    d = torch.where(_nan_equal(a, b), torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def _compare(label, got, want):
    """Print and return (values differing under ==, max abs diff)."""
    torch.cuda.synchronize()
    n_diff = int((~_nan_equal(got, want)).sum())
    err = _max_abs(got, want)
    print(f"[kernel] {label} {tuple(got.shape)}: {n_diff} of {got.numel()} values differ from the twin (max abs diff {err:.3g})", flush=True)
    assert n_diff == 0, f"{label}: kernel and twin disagree"
    return err


def _time_ms(fn, warmup=2, reps=5):
    """CUDA-event times (ms) of ``reps`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _host_ms(fn, warmup=2, reps=5):
    """Host-clock times (ms) of ``reps`` synchronised calls after ``warmup``."""
    out = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def _summary(ms):
    med = statistics.median(ms)
    return {"median_ms": med, "min_ms": min(ms), "max_ms": max(ms), "spread": (max(ms) - min(ms)) / med, "samples": len(ms)}


def _fmt(s):
    return f"median {s['median_ms']:.3f} ms (spread {s['spread']:.3f}, n={s['samples']})"


def _in_turns(run_kern, run_twin, reps=5):
    """Kernel and twin timed in turns (twin, kernel, kernel, twin, ...)
    after two warm-ups each; returns (kernel, twin) summaries."""
    _time_ms(run_kern, warmup=2, reps=0)
    _time_ms(run_twin, warmup=2, reps=0)
    kern_ms, twin_ms = [], []
    for i in range(reps):
        for fn, acc in ((run_twin, twin_ms), (run_kern, kern_ms))[:: 1 if i % 2 == 0 else -1]:
            acc += _time_ms(fn, warmup=0, reps=1)
    return _summary(kern_ms), _summary(twin_ms)


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _profile(label, step, ours):
    """One step under ``torch.profiler``: device busy time, the top 5
    kernels by device time and the port's own kernels (names in ``ours``)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    wall_us = start.elapsed_time(end) * 1e3
    kernels = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    kernels.sort(key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in kernels)
    if not kernels:
        print(f"[profile] {label}: torch.profiler recorded no device time", flush=True)
        return
    print(f"[profile] {label}: {wall_us / 1e3:.3f} ms between CUDA events, {busy_us / 1e3:.3f} ms of kernel time "
          f"over {sum(e.count for e in kernels)} kernels (device idle {100 * max(wall_us - busy_us, 0) / wall_us:.1f} %); "
          "top 5 by device time, then the port's own:", flush=True)
    mine = [e for e in kernels if any(k in e.key for k in ours)]
    for e in kernels[:5] + [e for e in mine if e not in kernels[:5]]:
        print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms  {100 * _device_us(e) / busy_us:5.1f}%  x{e.count:<4d} {e.key[:110]}", flush=True)


def _reset_counts():
    interp_kernel.launches = 0
    for k in merge.launches:
        merge.launches[k] = 0


def _counts():
    return dict(merge.launches, interp_table_3d=interp_kernel.launches)


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}), {torch.cuda.device_count()} device(s): {smi}", flush=True)

    # 2. build: every source at once
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    print(f"[build] {', '.join(f'{p.name} ({s:.2f} s)' for p, s in built.values())}; {time.perf_counter() - t0:.2f} s in all", flush=True)

    # 3. each kernel against its twin, on the inputs of its path
    err = {}
    t, (ref_np, hist_np, sim_np) = example_problem(N_SITES, N_YEARS)
    gi = xp.Grouper("time.month").indexes(t)
    Gp, Lp = gi.bracket_partitions("linear")["part0"].shape
    v, xs, ys, nv = lookup_inputs(N_SITES, Gp, Lp, NQ, seed=1, device=dev)
    lookup = lambda: interp_kernel.interp_table_3d(v, xs, ys, nv)  # noqa: E731
    lookup_twin = lambda: interp_kernel.interp_table_3d_reference(v, xs, ys, nv)  # noqa: E731
    err["K1"] = _compare(f"K1 lookup nq={NQ}", lookup(), lookup_twin())

    th, (href_np, hhist_np, hsim_np) = heavy_problem(HEAVY_SITES, HEAVY_YEARS)
    href, hhist, hsim = (torch.from_numpy(a).to(dev) for a in (href_np, hhist_np, hsim_np))
    plan = xp.Grouper("time.dayofyear", window=HEAVY_WINDOW).indexes(th).merge_plan
    G = plan.w1_gather.shape[0] - 2 * plan.half
    slab, _, L = merge_slab(torch.stack([href, hhist]), plan)
    ymax = plan.w1_gather.shape[1]
    err["K3"] = _compare("K3 row sort", merge.sort_rows_alternating(slab), merge.sort_rows_alternating_reference(slab))
    ordered = merge.sort_rows_alternating(slab)
    levels = merge.build_levels(ordered, L)
    err["K5"] = _compare(f"K5 level build L={L}", levels, merge.build_levels_reference(ordered, L))
    folded = merge.fold_windows(ordered, levels, HEAVY_WINDOW, G, ymax=ymax)
    err["K6"] = _compare(f"K6 window fold w={HEAVY_WINDOW}", folded, merge.fold_windows_reference(ordered, levels, HEAVY_WINDOW, G, folded.shape[-1]))
    lead = slice(0, 16)  # the composed twins (sort, levels, fold) on the first 16 rows
    o16 = merge.sort_rows_alternating_reference(slab[lead].contiguous())
    composed = merge.fold_windows_reference(o16, merge.build_levels_reference(o16, L), HEAVY_WINDOW, G, folded.shape[-1])
    err["K6"] = max(err["K6"], _compare("K3+K5+K6 against the composed twins, first 16 rows", folded[lead], composed))
    del folded, composed, o16
    plan5 = xp.Grouper("time.dayofyear", window=SMALL_WINDOW).indexes(th).merge_plan
    slab5, _, _ = merge_slab(torch.stack([href, hhist]), plan5)
    ordered5 = merge.sort_rows_alternating(slab5)
    merged5 = merge.merged_window_rows(ordered5, SMALL_WINDOW, G, ymax=ymax)
    err["K4"] = _compare(f"K4 per-group merge w={SMALL_WINDOW}", merged5, merge.merged_window_rows_reference(ordered5, SMALL_WINDOW, G, merged5.shape[-1]))
    del merged5

    # 4. headline QDM through the public API
    ref, hist, sim = (torch.from_numpy(a).to(dev) for a in (ref_np, hist_np, sim_np))
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    scen = run_main_path(ref, hist, sim, t)
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    qdm_counts = _counts()
    assert scen.is_cuda and scen.dtype == torch.float32, (scen.device, scen.dtype)
    assert tuple(scen.shape) == (N_SITES, 365 * N_YEARS), tuple(scen.shape)
    assert bool(torch.isfinite(scen).all()), "non-finite output"
    assert qdm_counts["interp_table_3d"] >= 2, f"QDM path launched K1 {qdm_counts['interp_table_3d']} times"
    cut = slice(0, CHECK_SITES)
    want = run_main_path(*(torch.from_numpy(a[cut]) for a in (ref_np, hist_np, sim_np)), t)
    cpu_err = float((scen[cut].cpu() - want).abs().max())
    torch.testing.assert_close(scen[cut].cpu(), want, **TOL)
    print(f"[main path] QDM train+adjust {tuple(scen.shape)} f32 on {dev}: finite, launches {qdm_counts}, "
          f"{api_s:.3f} s first call; first {CHECK_SITES} sites vs CPU port max abs diff {cpu_err:.3g}", flush=True)
    del scen

    # 5. heavy windowed EQM through the public API, then the window-5 path
    hcut = slice(0, HEAVY_CHECK)
    small = [torch.from_numpy(a[hcut]) for a in (href_np, hhist_np, hsim_np)]
    paths = {}
    for window in (HEAVY_WINDOW, SMALL_WINDOW):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        hscen = run_windowed_path(href, hhist, hsim, th, window)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = paths[window] = _counts()
        assert hscen.is_cuda and tuple(hscen.shape) == (HEAVY_SITES, 365 * HEAVY_YEARS), (hscen.device, tuple(hscen.shape))
        assert bool(torch.isfinite(hscen).all()), f"window {window}: non-finite output"
        need = ("sort_rows_alternating", "build_levels", "fold_windows") if window >= 9 else ("sort_rows_alternating", "merged_window_rows")
        assert all(counts[k] >= 1 for k in need + ("interp_table_3d",)), f"window {window}: launches {counts}"
        cpu = run_windowed_path(*small, th, window)
        oracle = resort_oracle(*(a.to(dev) for a in small), th, window).cpu()
        cpu_err, oracle_err = (float((hscen[hcut].cpu() - w).abs().max()) for w in (cpu, oracle))
        torch.testing.assert_close(hscen[hcut].cpu(), cpu, **TOL)
        torch.testing.assert_close(hscen[hcut].cpu(), oracle, **TOL)
        print(f"[heavy] EQM dayofyear window={window} train+adjust {tuple(hscen.shape)} f32 on {dev}: finite, launches {counts}, "
              f"{first_s:.3f} s first call; first {HEAVY_CHECK} sites vs CPU port max abs diff {cpu_err:.3g}, "
              f"vs re-sort oracle {oracle_err:.3g}", flush=True)
        del hscen

    # 6. times
    q = torch.as_tensor(equally_spaced_nodes(NQ), dtype=torch.float32, device=dev)
    idx = [torch.as_tensor(a, device=dev) for a in (gi.gather_idx, gi.group_idx, gi.scatter_slot)]
    brackets = device_brackets(gi, "linear", dev)

    def qdm_step():
        return qdm_train_adjust_core(ref, hist, sim, *idx, brackets, q, kind="+", interp="linear", extrapolation="constant")

    fused = _summary(_time_ms(qdm_step))
    print(f"[time] fused qdm_train_adjust_core {N_SITES} sites x {N_YEARS} yr: {N_SITES * N_YEARS / (fused['median_ms'] / 1e3):,.0f} "
          f"gridpoint-years/s ({_fmt(fused)})", flush=True)
    api = _summary(_host_ms(lambda: run_main_path(ref, hist, sim, t)))
    print(f"[time] public QDM train+adjust, same data (host clock): {_fmt(api)}", flush=True)

    hgi = xp.Grouper("time.dayofyear", window=HEAVY_WINDOW).indexes(th)
    hbrackets = device_brackets(hgi, "linear", dev)

    def heavy_step():
        return eqm_train_adjust_windowed(href, hhist, hsim, hgi.merge_plan, q, hbrackets, kind="+", interp="linear", extrapolation="constant", assume_finite=True)

    heavy = _summary(_time_ms(heavy_step))
    print(f"[time] fused eqm_train_adjust_windowed doy+{HEAVY_WINDOW} {HEAVY_SITES} sites x {HEAVY_YEARS} yr: "
          f"{HEAVY_SITES * HEAVY_YEARS / (heavy['median_ms'] / 1e3):,.0f} gridpoint-years/s ({_fmt(heavy)})", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    heavy_step()
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated(dev)
    hapi = _summary(_host_ms(lambda: run_windowed_path(href, hhist, hsim, th)))
    torch.cuda.reset_peak_memory_stats(dev)
    run_windowed_path(href, hhist, hsim, th)
    torch.cuda.synchronize()
    api_peak = torch.cuda.max_memory_allocated(dev)
    print(f"[time] public windowed EQM train+adjust, same data (host clock): {_fmt(hapi)}", flush=True)
    print(f"[memory] heavy fused step: peak {step_peak / 2**30:.3f} GiB allocated ({(step_peak - base) / 2**30:.3f} GiB above "
          f"the {base / 2**30:.3f} GiB held before it); public call: peak {api_peak / 2**30:.3f} GiB", flush=True)

    times = {"K1": _in_turns(lookup, lookup_twin)}
    times["K3"] = _in_turns(lambda: merge.sort_rows_alternating(slab), lambda: merge.sort_rows_alternating_reference(slab))
    times["K5"] = _in_turns(lambda: merge.build_levels(ordered, L), lambda: merge.build_levels_reference(ordered, L))
    width = HEAVY_WINDOW * ymax
    times["K6"] = _in_turns(
        lambda: merge.fold_windows(ordered, levels, HEAVY_WINDOW, G, ymax=ymax),
        lambda: merge.fold_windows_reference(ordered, levels, HEAVY_WINDOW, G, width),
    )
    times["K4"] = _in_turns(
        lambda: merge.merged_window_rows(ordered5, SMALL_WINDOW, G, ymax=ymax),
        lambda: merge.merged_window_rows_reference(ordered5, SMALL_WINDOW, G, SMALL_WINDOW * ymax),
    )
    shapes = {"K1": tuple(v.shape), "K3": tuple(slab.shape), "K5": tuple(ordered.shape), "K6": tuple(ordered.shape), "K4": tuple(ordered5.shape)}
    for k, (kern, twin) in times.items():
        print(f"[time] {k} {KERNELS[k]['name']} {shapes[k]}: kernel {_fmt(kern)}; plain twin {_fmt(twin)}", flush=True)

    ours = ("interp_table_3d_kernel", "sort_rows_alt_kernel", "build_level_kernel", "fold_windows_kernel")
    _profile("one fused QDM step", qdm_step, ours)
    _profile(f"one fused windowed EQM step (doy+{HEAVY_WINDOW})", heavy_step, ours)

    launches = {
        "K1": qdm_counts["interp_table_3d"],
        "K3": paths[HEAVY_WINDOW]["sort_rows_alternating"],
        "K5": paths[HEAVY_WINDOW]["build_levels"],
        "K6": paths[HEAVY_WINDOW]["fold_windows"],
        "K4": paths[SMALL_WINDOW]["merged_window_rows"],
    }
    rows = [
        dict(KERNELS[k], launches=launches[k], max_abs_err=err[k], ms=times[k][0]["median_ms"], plain_ms=times[k][1]["median_ms"])
        for k in ("K1", "K3", "K4", "K5", "K6")
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
