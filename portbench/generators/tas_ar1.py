"""Daily tas blocks: a site mean, an annual cycle and AR(1) anomalies.

A block is ``sites`` rows of three daily series, made on the device in
the configuration's dtype from the run's ``torch.Generator``:

- ``ref``: a site mean, an annual cycle (a cosine of the day of year that
  peaks on ``cycle_peak_doy``) and AR(1) daily anomalies;
- ``hist``: the same site with a bias: a mean offset, a scaled cycle and
  scaled anomalies, drawn independently of ref's;
- ``sim``: hist's climate with its own anomalies and a linear warming of
  ``sim_warming_K_per_century`` about the middle of the training period,
  so that its first and last decades run past hist's range and reach the
  tables' constant extrapolation.

Each site's parameters are drawn uniformly from the ranges in the
configuration's ``assumed``.  Every seed draws the same sizes in the same
order, so the work of a run does not depend on its seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.calendar import Days

#: dimensions of every input, sites first
DIMS = ("site", "time")

#: site parameters, in the order of their draws
_PARAMS = ("site_mean_K", "cycle_amplitude_K", "anomaly_sd_K", "hist_offset_K", "hist_cycle_scale", "hist_sd_scale")


def ar1(e: torch.Tensor, phi: float) -> torch.Tensor:
    """Stationary AR(1) anomalies of unit variance from iid N(0, 1) draws
    ``e`` [..., T]: ``x[t] = phi x[t-1] + sqrt(1 - phi^2) e[t]``, by a
    doubling scan (log2 T elementwise steps, no loop over days)."""
    x = e * math.sqrt(1 - phi * phi)
    s, f = 1, phi
    while s < x.shape[-1]:
        x = torch.cat([x[..., :s], x[..., s:] + f * x[..., :-s]], dim=-1)
        s, f = 2 * s, f * f
    return x


def _cycle(days: Days, peak: float, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.cos(2 * np.pi * (days.doy - peak) / 365), dtype=dtype, device=device)


def make_block(g: torch.Generator, assumed: dict, sites: int, days: dict, device, dtype) -> dict:
    """{"ref", "hist": [sites, train days], "sim": [sites, sim days]}."""
    train, sim = days["train"], days["sim"]
    lo = torch.tensor([assumed[k][0] for k in _PARAMS], dtype=dtype, device=device)
    hi = torch.tensor([assumed[k][1] for k in _PARAMS], dtype=dtype, device=device)
    p = lo + (hi - lo) * torch.rand((sites, len(_PARAMS)), generator=g, device=device, dtype=dtype)
    mean, amp, sd, off, amp_x, sd_x = (p[:, i : i + 1] for i in range(len(_PARAMS)))
    phi, peak = float(assumed["ar1_phi"]), float(assumed["cycle_peak_doy"])
    c_train, c_sim = _cycle(train, peak, device, dtype), _cycle(sim, peak, device, dtype)

    def anomalies(n):
        return ar1(torch.randn((sites, n), generator=g, device=device, dtype=dtype), phi)

    ref = mean + amp * c_train + sd * anomalies(train.n)
    hist = mean + off + amp * amp_x * c_train + sd * sd_x * anomalies(train.n)
    mid = train.start_year + train.years / 2
    years = torch.as_tensor(sim.year + (sim.doy - 0.5) / 365 - mid, dtype=dtype, device=device)
    warming = float(assumed["sim_warming_K_per_century"]) / 100 * years
    out = mean + off + amp * amp_x * c_sim + sd * sd_x * anomalies(sim.n) + warming
    return {"ref": ref, "hist": hist, "sim": out}
