"""Time the lookup kernel K1 on ordered tables and on tables with +inf holes,
and the public adjust step that meets such tables, on an NVIDIA GPU, in turns.

    python3 scripts/time_k1_holes.py TAG

Run from the root of a checkout: it imports that checkout's ``chip_smoke``
and ``xsdba_tpu_torch`` (so to compare two commits, run it from each
checkout's root in turns: parent, change, change, parent).  At the windowed
adjust's short rows ([256, 367, 150] values, nq 50, a warp a row; the
inputs of ``chip_smoke.py`` phase 6), it times K1 on ``lookup_inputs``'
ordered tables and on ``holey_tables`` (quantile-trained tables with NaN
factors inside, ROADMAP C31), each with ``linear`` and ``nearest``, in turns
(7 rounds, a sample the mean of 10 calls queued behind a spin of the card),
and K1 ``linear`` on the ordered tables against its plain twin as phase 6
times it.  Then the public step: a ``kind="*"`` dayofyear + 31
``QuantileDeltaMapping`` trained on ``dry_day_problem``'s pr (512 sites x
150 years, nq 50; ``chip_smoke.py`` phase 4e), whose adjust looks values up
in tables with +inf holes through K1; its ``adjust`` of the sim (already on
the card) with ``nearest`` and ``linear``, in turns (5 rounds, a sample one
call, CUDA events).  Prints one JSON line with TAG, the card's name and
power limit, the medians (ms) and their spreads.  Imports no JAX.
"""

import json
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
import xsdba_tpu_torch as xp  # noqa: E402
from xsdba_tpu_torch.ops.cuda import interp_kernel as ik  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("time_k1_holes.py needs a CUDA device")
dev = torch.device("cuda", 0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
hgp, hlp = xp.Grouper("time.dayofyear", window=31).indexes(cs.heavy_problem(1, 150)[0]).bracket_partitions("linear")["part0"].shape
vh, xsh, ysh, nvh = cs.lookup_inputs(256, hgp, hlp, 50, seed=3, device=dev)
hx, hy, hn = (a.to(dev) for a in cs.holey_tables(256, hgp, 50, seed=16))
steps = {
    "linear ordered": lambda: ik.interp_table_3d(vh, xsh, ysh, nvh),
    "linear holes": lambda: ik.interp_table_3d(vh, hx, hy, hn),
    "nearest ordered": lambda: ik.interp_table_3d(vh, xsh, ysh, nvh, "nearest"),
    "nearest holes": lambda: ik.interp_table_3d(vh, hx, hy, hn, "nearest"),
}
res = cs._steps_in_turns(steps, reps=7, batch=10)
kern, twin = cs._in_turns(steps["linear ordered"], lambda: ik.interp_table_3d_reference(vh, xsh, ysh, nvh), batch=10)
del vh, xsh, ysh, nvh, hx, hy, hn
t, (ref, hist, sim) = cs.dry_day_problem(cs.N_SITES, cs.N_YEARS)
group = xp.Grouper("time.dayofyear", window=cs.HEAVY_WINDOW)
qdm = xp.QuantileDeltaMapping.train(cs._pr_da(ref, t, "ref"), cs._pr_da(hist, t, "hist"), kind="*", group=group, nquantiles=cs.NQ)
sim_d = cs._pr_da(torch.from_numpy(sim).to(dev), t, "sim")
public = cs._steps_in_turns({f"adjust {m}": (lambda m=m: qdm.adjust(sim_d, interp=m)) for m in ("nearest", "linear")}, reps=5)
res.update(public)
print(json.dumps({"tree": sys.argv[1] if len(sys.argv) > 1 else "", "smi": smi, "shape": [256, hgp, hlp], "adjust shape": list(sim.shape),
                  **{k: v["median_ms"] for k, v in res.items()}, "spread": {k: round(v["spread"], 3) for k, v in res.items()},
                  "linear ordered vs twin": [kern["median_ms"], twin["median_ms"]]}), flush=True)
