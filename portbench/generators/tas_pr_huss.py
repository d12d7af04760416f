"""Daily tas, pr and huss blocks, dependent on one another, for MBCn.

A block is ``sites`` rows of three variables (``multivar``: tas, pr,
huss, in that order) over the days of a period, made on the device in the
configuration's dtype from the run's ``torch.Generator``:

- tas (K): a site mean, an annual cycle (a cosine of the day of year that
  peaks on ``cycle_peak_doy``) and AR(1) daily anomalies, as ``tas_ar1``;
- pr (mm/d): a day is wet where a latent Gaussian, correlated with the
  standardised tas anomaly (``pr_tas_corr``), lies in its upper
  ``wet_fraction``; a wet day's intensity is ``wet_threshold_mm_d`` plus a
  Weibull quantile of the latent's place inside the wet range, so that
  heavier rain goes with the latent; a dry day is U(0, ``dry_max_mm_d``),
  what ``jitter_under_thresh(pr, "0.01 mm/d")`` leaves, so every value is
  positive and a multiplicative factor is finite;
- huss (kg/kg): the saturation specific humidity at tas (Tetens' formula
  over water at ``surface_pressure_pa``) times a relative humidity: a
  site mean plus noise correlated with pr's latent (``rh_pr_corr``),
  clipped to [``rh_min``, 1].

``hist`` is the same site with biased marginals (an offset, scaled cycle
and anomalies of tas; a scaled wet fraction and intensity of pr; an
offset relative humidity) and its own dependence between the variables
(``hist_pr_tas_corr``, ``hist_rh_pr_corr``), drawn independently of ref's;
``sim`` is hist's climate with its own anomalies and a linear warming of
``sim_warming_K_per_century`` about the middle of the training period,
which huss follows through the saturation curve, so that a period late in
the century leaves hist's range and reaches the tables' constant
extrapolation.

Each site's parameters are drawn uniformly from the ranges in the
configuration's ``assumed``.  Every seed draws the same sizes in the same
order, so the work of a run does not depend on its seed.

The harness gives the ``multivar`` dimension no coordinate (its arrays
carry ``time`` alone).  A program whose ``MBCn.adjust`` needs one raises
on every block, and a run would time train alone; :func:`check_program`
makes such a program fail at set-up instead, before the first block.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .tas_ar1 import _cycle, ar1

#: dimensions of every input, sites first
DIMS = ("site", "multivar", "time")

#: site parameters, in the order of their draws
_PARAMS = (
    "site_mean_K", "cycle_amplitude_K", "anomaly_sd_K", "hist_offset_K", "hist_cycle_scale", "hist_sd_scale",
    "wet_fraction", "hist_wet_scale", "pr_scale_mm_d", "hist_pr_scale", "pr_weibull_shape",
    "pr_tas_corr", "hist_pr_tas_corr", "rh_mean", "rh_sd", "hist_rh_offset", "rh_pr_corr", "hist_rh_pr_corr",
)


def qsat(tas: torch.Tensor, pressure_pa: float) -> torch.Tensor:
    """Saturation specific humidity (kg/kg) at ``tas`` (K): Tetens' vapour
    pressure over water, ``611.2 exp(17.67 (T - 273.15) / (T - 29.65))`` Pa."""
    es = 611.2 * torch.exp(17.67 * (tas - 273.15) / (tas - 29.65))
    return 0.622 * es / (pressure_pa - 0.378 * es)


@functools.cache
def check_program() -> None:
    """One tiny public MBCn pair on the CPU (one site, two years, one
    rotation) on arrays laid out as the harness lays them out; raises what
    the program raises.  Once a process."""
    import xsdba_tpu_torch as xt

    x = torch.as_tensor(np.random.default_rng(0).gamma(2.0, 1.0, (1, 3, 730)))
    da = xt.DataArray(x, DIMS, {"time": xt.date_range("2000-01-01", periods=730, freq="D", calendar="noleap")}, {"units": "1"}, "probe")
    kws = {"interp": "nearest", "extrapolation": "constant"}
    obj = xt.MBCn.train(da, da, base_kws={"nquantiles": 20, "group": "time"}, adj_kws=kws, n_iter=1, n_escore=-1, rot_matrices=np.eye(3)[None])
    obj.adjust(da, da, da, adj_kws=kws)


def make_block(g: torch.Generator, assumed: dict, sites: int, days: dict, device, dtype) -> dict:
    """{"ref", "hist": [sites, 3, train days], "sim": [sites, 3, sim days]}."""
    check_program()
    train, sim = days["train"], days["sim"]
    lo = torch.tensor([assumed[k][0] for k in _PARAMS], dtype=dtype, device=device)
    hi = torch.tensor([assumed[k][1] for k in _PARAMS], dtype=dtype, device=device)
    p = dict(zip(_PARAMS, (lo + (hi - lo) * torch.rand((sites, len(_PARAMS)), generator=g, device=device, dtype=dtype)).T[:, :, None]))
    phi, peak = float(assumed["ar1_phi"]), float(assumed["cycle_peak_doy"])
    latent_phi = float(assumed["pr_latent_ar1_phi"])
    threshold, dry_max = float(assumed["wet_threshold_mm_d"]), float(assumed["dry_max_mm_d"])
    rh_min, pressure = float(assumed["rh_min"]), float(assumed["surface_pressure_pa"])

    def normal(n):
        return torch.randn((sites, n), generator=g, device=device, dtype=dtype)

    def uniform(n):
        return torch.rand((sites, n), generator=g, device=device, dtype=dtype)

    def series(cycle: torch.Tensor, biased: bool, warming) -> torch.Tensor:
        n = cycle.shape[-1]
        a = ar1(normal(n), phi)                                           # the standardised tas anomaly
        if biased:
            tas = p["site_mean_K"] + p["hist_offset_K"] + p["cycle_amplitude_K"] * p["hist_cycle_scale"] * cycle
            tas = tas + p["anomaly_sd_K"] * p["hist_sd_scale"] * a + warming
            rho, c = p["hist_pr_tas_corr"], p["hist_rh_pr_corr"]
            wet = (p["wet_fraction"] * p["hist_wet_scale"]).clamp(max=0.95)
            scale, rh_mean = p["pr_scale_mm_d"] * p["hist_pr_scale"], p["rh_mean"] + p["hist_rh_offset"]
        else:
            tas = p["site_mean_K"] + p["cycle_amplitude_K"] * cycle + p["anomaly_sd_K"] * a
            rho, c, wet, scale, rh_mean = p["pr_tas_corr"], p["rh_pr_corr"], p["wet_fraction"], p["pr_scale_mm_d"], p["rh_mean"]
        z = rho * a + torch.sqrt(1 - rho * rho) * ar1(normal(n), latent_phi)
        u = torch.special.ndtr(z)                                         # U(0, 1), dependent on the tas anomaly
        inside = ((u - (1 - wet)) / wet).clamp(1e-6, 1 - 1e-6)            # the latent's place in the wet range
        intensity = threshold + scale * (-torch.log1p(-inside)) ** (1 / p["pr_weibull_shape"])
        pr = torch.where(u > 1 - wet, intensity, dry_max * uniform(n))
        rh = (rh_mean + p["rh_sd"] * (c * z + torch.sqrt(1 - c * c) * normal(n))).clamp(rh_min, 1.0)
        return torch.stack([tas, pr, qsat(tas, pressure) * rh], dim=1)

    c_train, c_sim = _cycle(train, peak, device, dtype), _cycle(sim, peak, device, dtype)
    ref = series(c_train, False, 0.0)
    hist = series(c_train, True, 0.0)
    mid = train.start_year + train.years / 2
    years = torch.as_tensor(sim.year + (sim.doy - 0.5) / 365 - mid, dtype=dtype, device=device)
    out = series(c_sim, True, float(assumed["sim_warming_K_per_century"]) / 100 * years)
    return {"ref": ref, "hist": hist, "sim": out}
