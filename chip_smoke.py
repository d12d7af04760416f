"""Smoke run of the PyTorch/CUDA port (``xsdba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: requires ``torch.cuda.is_available()``; prints the torch version
   and the card's name and power limit (``nvidia-smi``);
2. build: compiles the CUDA lookup kernel from ``xsdba_tpu_torch/csrc/``;
3. kernel: the kernel against its plain PyTorch twin, on the card, at the
   headline partition shape, on inputs with every edge case the lookup has;
   bit for bit (the build passes ``-fmad=false``);
4. main path: ``QuantileDeltaMapping.train(...).adjust(...)`` through the
   public API on CUDA tensors of 512 sites x 150 noleap years, f32,
   ``nquantiles=50``, monthly groups; the output must be finite, must have
   gone through the kernel, and must match the port's plain CPU path on the
   first 8 sites at rtol = atol = 2e-6;
5. times (2 warm-ups, median of 5 and the spread): the fused
   ``qdm_train_adjust_core`` step in gridpoint-years/s (CUDA events), the
   public train+adjust call on the same data (host clock), the kernel
   against its twin (CUDA events, in turns), and the five kernels that take
   the most device time in one step, plus the lookup kernel's own line
   (``torch.profiler``).

The line before the last is one JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with code 2 and prints no result.
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
from xsdba_tpu_torch.models._algos import qdm_train_adjust_core
from xsdba_tpu_torch.models._wrap import device_brackets
from xsdba_tpu_torch.ops.correction import equally_spaced_nodes
from xsdba_tpu_torch.ops.cuda import interp_kernel
from xsdba_tpu_torch.ops.interp import _compact_nan_pairs

N_SITES, N_YEARS, NQ = 512, 150, 50
CHECK_SITES = 8
TOL = dict(rtol=2e-6, atol=2e-6)
KERNEL = {
    "name": "interp_table_3d",
    "route": "cuda",
    "source": "xsdba_tpu_torch/csrc/interp_kernel.cu",
    "replaces": "xsdba_tpu/ops/pallas/interp_kernel.py:101",
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


def example_problem(n_sites, n_years, seed=0):
    """The headline data recipe (``__graft_entry__._example_problem``):
    numpy f32 ref ~ N(10, 2), hist ~ N(12, 3), sim ~ N(13, 3) over
    ``n_years`` noleap years of daily data, and the monthly grouping."""
    t = xp.date_range("2000-01-01", periods=365 * n_years, freq="D", calendar="noleap")
    rng = np.random.default_rng(seed)
    T = len(t)
    data = [rng.normal(mu, sd, (n_sites, T)).astype(np.float32) for mu, sd in ((10, 2), (12, 3), (13, 3))]
    return t, data


def run_main_path(ref, hist, sim, t):
    """The public QDM path on [site, time] tensors (on their device)."""
    mk = lambda x, name: xp.DataArray(x, ("site", "time"), {"time": t}, {"units": "K"}, name)  # noqa: E731
    qdm = xp.QuantileDeltaMapping.train(mk(ref, "ref"), mk(hist, "hist"), group="time.month", nquantiles=NQ, kind="+")
    return qdm.adjust(mk(sim, "sim"), interp="linear").data


def _nan_equal(a, b):
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _max_abs(a, b):
    d = torch.where(_nan_equal(a, b), torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


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


def _summary(ms):
    med = statistics.median(ms)
    return {"median_ms": med, "min_ms": min(ms), "max_ms": max(ms), "spread": (max(ms) - min(ms)) / med, "samples": len(ms)}


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


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

    # 2. build
    lib, build_s = interp_kernel.build(verbose=True)
    print(f"[build] {lib.name} built in {build_s:.2f} s", flush=True)

    # 3. kernel against its twin, at the headline partition shape
    t, (ref_np, hist_np, sim_np) = example_problem(N_SITES, N_YEARS)
    gi = xp.Grouper("time.month").indexes(t)
    Gp, Lp = gi.bracket_partitions("linear")["part0"].shape
    v, xs, ys, nv = lookup_inputs(N_SITES, Gp, Lp, NQ, seed=1, device=dev)
    got = interp_kernel.interp_table_3d(v, xs, ys, nv)
    twin = interp_kernel.interp_table_3d_reference(v, xs, ys, nv)
    torch.cuda.synchronize()
    n_diff = int((~_nan_equal(got, twin)).sum())
    max_abs_err = _max_abs(got, twin)
    n_nan = int(torch.isnan(twin).sum())
    print(f"[kernel] shape {tuple(v.shape)} nq={NQ}: {n_diff} of {v.numel()} values differ from the twin "
          f"(max abs diff {max_abs_err:.3g}; {n_nan} NaN in both)", flush=True)
    assert n_diff == 0, "kernel and twin disagree"

    # 4. main path through the public API, on the card
    ref, hist, sim = (torch.from_numpy(a).to(dev) for a in (ref_np, hist_np, sim_np))
    torch.cuda.synchronize()
    interp_kernel.launches = 0
    t0 = time.perf_counter()
    scen = run_main_path(ref, hist, sim, t)
    torch.cuda.synchronize()
    api_s = time.perf_counter() - t0
    launches = interp_kernel.launches
    assert scen.is_cuda and scen.dtype == torch.float32, (scen.device, scen.dtype)
    assert tuple(scen.shape) == (N_SITES, 365 * N_YEARS), tuple(scen.shape)
    assert bool(torch.isfinite(scen).all()), "non-finite output"
    assert launches >= 2, f"main path launched the kernel {launches} times"
    cut = slice(0, CHECK_SITES)
    want = run_main_path(*(torch.from_numpy(a[cut]) for a in (ref_np, hist_np, sim_np)), t)
    cpu_err = float((scen[cut].cpu() - want).abs().max())
    torch.testing.assert_close(scen[cut].cpu(), want, **TOL)
    print(f"[main path] QDM train+adjust {tuple(scen.shape)} f32 on {dev}: finite, {launches} kernel launches, "
          f"{api_s:.3f} s first call; first {CHECK_SITES} sites vs CPU port max abs diff {cpu_err:.3g}", flush=True)

    # 5. times
    q = torch.as_tensor(equally_spaced_nodes(NQ), dtype=torch.float32, device=dev)
    idx = [torch.as_tensor(a, device=dev) for a in (gi.gather_idx, gi.group_idx, gi.scatter_slot)]
    brackets = device_brackets(gi, "linear", dev)

    def step():
        return qdm_train_adjust_core(ref, hist, sim, *idx, brackets, q, kind="+", interp="linear", extrapolation="constant")

    fused = _summary(_time_ms(step))
    rate = N_SITES * N_YEARS / (fused["median_ms"] / 1e3)
    print(f"[time] fused qdm_train_adjust_core {N_SITES} sites x {N_YEARS} yr: {rate:,.0f} gridpoint-years/s "
          f"(median {fused['median_ms']:.3f} ms, spread {fused['spread']:.3f}, n={fused['samples']})", flush=True)

    def api_ms():
        t0 = time.perf_counter()
        run_main_path(ref, hist, sim, t)
        torch.cuda.synchronize()
        return [(time.perf_counter() - t0) * 1e3]

    api_ms()
    api_ms()
    api = _summary([x for _ in range(5) for x in api_ms()])
    print(f"[time] public QDM train+adjust, same data (host clock): median {api['median_ms']:.3f} ms "
          f"(spread {api['spread']:.3f}, n={api['samples']})", flush=True)

    run_kern = lambda: interp_kernel.interp_table_3d(v, xs, ys, nv)  # noqa: E731
    run_twin = lambda: interp_kernel.interp_table_3d_reference(v, xs, ys, nv)  # noqa: E731
    _time_ms(run_kern, warmup=2, reps=0)
    _time_ms(run_twin, warmup=2, reps=0)
    kern_ms, twin_ms = [], []
    for i in range(5):  # in turns: twin, kernel, kernel, twin, ...
        for fn, acc in ((run_twin, twin_ms), (run_kern, kern_ms))[:: 1 if i % 2 == 0 else -1]:
            acc += _time_ms(fn, warmup=0, reps=1)
    kern, plain = _summary(kern_ms), _summary(twin_ms)
    gbps = 2 * v.numel() * 4 / (kern["median_ms"] / 1e3) / 1e9
    print(f"[time] kernel {tuple(v.shape)} nq={NQ}: {kern['median_ms']:.4f} ms (spread {kern['spread']:.3f}, n={kern['samples']}, "
          f"{gbps:.0f} GB/s of v read+write); plain twin {plain['median_ms']:.4f} ms (spread {plain['spread']:.3f}, "
          f"n={plain['samples']})", flush=True)

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
        print("[profile] torch.profiler recorded no device time", flush=True)
    else:
        print(f"[profile] one fused step: {wall_us / 1e3:.3f} ms between CUDA events, {busy_us / 1e3:.3f} ms of kernel time "
              f"over {sum(e.count for e in kernels)} kernels; top 5 by device time:", flush=True)
        ours = [e for e in kernels if "interp_table_3d_kernel" in e.key]
        for e in kernels[:5] + [e for e in ours if e not in kernels[:5]]:
            print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms  {100 * _device_us(e) / busy_us:5.1f}%  x{e.count:<4d} {e.key[:110]}", flush=True)

    print(smi, flush=True)
    print(json.dumps({"kernels": [dict(KERNEL, launches=launches, max_abs_err=max_abs_err, ms=kern["median_ms"], plain_ms=plain["median_ms"])]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
