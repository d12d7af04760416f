"""Split the bracketed lookup's time on an NVIDIA GPU, and time the kernel
as it stood before its H100 redesign (the tile kernel) against the port's,
in turns.

    python3 scripts/probe_bracketed.py

Builds ``scripts/probe_bracketed.cu`` (the tile kernel and four cut-down
variants of it) with the port's ``nvcc`` flags into ``build/``, holds the
tile kernel and the port's ``interp_bracketed`` to their plain twin by bit
pattern at the headline shape ([512, 54750] values, the monthly brackets,
Gp 14, nq 50), then times in turns, each sample the mean of 10 calls queued
behind a spin of the card, 7 rounds:

- the tile kernel (a block per 8192-step tile, two seven-probe lookups a value);
- its shell: the same staging, then v copied to out (the streaming alone);
- one lookup a value in place of two (the second table and its loads cut);
- both lookups with g0, g1 and w fixed (no per-step loads);
- the staging alone;
- the port's kernel (through ``ops/cuda/interp_kernel.py:interp_bracketed``),
  and five copies of it with one part cut: its shell (its staging, then v
  copied to out), no search (one of the first 32 records picked by the value's bits), no
  division (a product in its place), no per-step loads (groups and weight
  fixed), and one table pair a warp (the loads kept, the groups fixed).

Prints the card's name and power limit, then a line a timing.  Exits 2
without a CUDA device.  Imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = {"tile kernel": 0, "tile kernel's shell (staging, v copied)": 1, "tile kernel, one lookup a value": 2,
            "tile kernel, both lookups, steps fixed": 3, "tile kernel's staging alone": 4}
CUTS = {"port's shell (staging, v copied)": 1, "port's kernel, no search": 2, "port's kernel, no division": 3,
        "port's kernel, no per-step loads": 4, "port's kernel, one table pair a warp": 5}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bracketed: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import xsdba_tpu_torch as xp
    from xsdba_tpu_torch.ops.cuda import _build
    from xsdba_tpu_torch.ops.cuda import interp_kernel as k

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[probe] {smi}; torch {torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    lib_path = out_dir / "probe_bracketed.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(ROOT / "scripts" / "probe_bracketed.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.tile_bracketed.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tile_bracketed.restype = ctypes.c_int
    lib.cut_bracketed.argtypes = lib.tile_bracketed.argtypes
    lib.cut_bracketed.restype = ctypes.c_int
    dev = torch.device("cuda", 0)

    t, _ = cs.example_problem(1, cs.N_YEARS)
    b = xp.Grouper("time.month").indexes(t).bracket_partitions("linear")
    args = cs.bracket_inputs(cs.N_SITES, b["part0"].shape[0], cs.NQ, b["g0"], b["g1"], b["w"], seed=4, device=dev)
    v, xs = args[0], args[1]

    def launch(entry, variant):
        out = torch.empty_like(v)
        rc = getattr(lib, entry)(variant, *(a.data_ptr() for a in args), out.data_ptr(), v.shape[0], v.shape[1], xs.shape[1], xs.shape[2],
                                 torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry}({variant}) launch failed: cudaError {rc}")
        return out

    want = k.interp_bracketed_reference(*args)
    for label, got in (("tile kernel", launch("tile_bracketed", 0)), ("port's kernel", k.interp_bracketed(*args))):
        cs._compare_bits(f"{label} at {tuple(v.shape)}", got, want)
    steps = {label: (lambda i=i: launch("tile_bracketed", i)) for label, i in VARIANTS.items()}
    steps["port's kernel"] = lambda: k.interp_bracketed(*args)
    steps.update({label: (lambda i=i: launch("cut_bracketed", i)) for label, i in CUTS.items()})
    for label, s in cs._steps_in_turns(steps, reps=7, batch=cs.KERNEL_BATCH).items():
        print(f"[probe] {label} {tuple(v.shape)}, Gp {xs.shape[1]}, nq {xs.shape[2]}: {cs._fmt(s)}, least {s['min_ms']:.4f} ms [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
