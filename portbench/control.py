"""The readings that the limits of ``correct`` are set from, at a cell's
own size, on the card:

    python3 -m portbench.control --workload <cell> --seeds <n> ... [--control <k>]

For each seed, set-up makes the cell's pool of blocks as a run does, the
program runs one block of each pool entry through the timed call pair,
and the numbers compared are read against the float64 reference, as in a
run (the lower readings).  For the first ``--control`` seeds the control
is read too: the plain reference computed in bfloat16, the precision
below the configuration's float32, put in the program's place (the upper
readings).  One JSON line per seed; the benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import check, spec
from .reference.qm import bfloat16
from .run import THREADS, Cell


def readings(name: str, seed: int, control: bool, device: str = "cuda", root=spec.ROOT) -> dict:
    c = Cell(name, root)
    c.setup(seed, device)
    for i in range(len(c.pool)):
        c.block(i)
    got, inputs = c.samples_to_host()
    c.free()
    want = c.expected(inputs)
    out = {"workload": name, "seed": seed, "program": check.compare(got, want, c.limits, raised=c.raised, root=root)}
    if control:
        low = c.expected(inputs, rnd=bfloat16)
        out["control"] = check.compare(sorted(low.items()), want, c.limits, root=root)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3, help="seeds (the first ones) on which the control is read too")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    for i, seed in enumerate(a.seeds):
        print(json.dumps(readings(a.workload, seed, i < a.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
