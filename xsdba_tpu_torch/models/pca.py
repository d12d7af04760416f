"""Principal-component adjustment (Hnilica 2017; reference
``adjustment.py:1053-1236``)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pca import pc_transform_matrix
from ..ops.segment import gather_groups
from ..utils.container import DataArray, Dataset
from ..utils.grouper import Grouper
from ..utils.tensor import as_tensor, input_tensor
from .base import TrainAdjust

__all__ = ["PrincipalComponents"]


def _points_last(da: DataArray, crd_dim: str):
    """(the data as a tensor [..., M, T], sim's dims with time last, the
    axis of ``crd_dim`` there)."""
    dac = da.move_dim_last("time")
    ax = dac.dims.index(crd_dim)
    return torch.movedim(input_tensor(dac.data), ax, -2), dac, ax


def _blocks_MP(da: DataArray, gi, crd_dim: str):
    """[..., M, T] data -> group blocks [..., G, M, L] (NaN padded)."""
    arr = _points_last(da, crd_dim)[0]
    return torch.movedim(gather_groups(arr, gi.gather_idx), -3, -2)


class PrincipalComponents(TrainAdjust):
    r"""Map simulation values to observation space through principal
    components: ``scen = e_R + T (sim − e_S)`` with ``T = (R·orient) H⁻¹``
    per group (reference adjustment.py:1053-1236).
    """

    @classmethod
    def _train(cls, ref: DataArray, hist: DataArray, *, crd_dim: str, best_orientation: str = "simple", group: str | Grouper = "time"):
        group = Grouper(group) if isinstance(group, str) else group
        if best_orientation not in ("simple", "full"):
            raise ValueError(f"Unknown `best_orientation` method: {best_orientation}.")
        gi = group.indexes(ref.time)
        refb = _blocks_MP(ref, gi, crd_dim)
        histb = _blocks_MP(hist, gi, crd_dim).to(refb.device)
        trans, ref_mean, hist_mean = pc_transform_matrix(refb, histb, best_orientation=best_orientation)

        gdim = group.prop_name if gi.prop != "group" else "group"
        crd = np.asarray(ref.coords.get(crd_dim, np.arange(trans.shape[-1])))
        coords = {gdim: gi.coord, crd_dim: crd, crd_dim + "_out": crd}
        batch = tuple(d for d in ref.dims if d not in (crd_dim, "time"))
        ds = Dataset(
            {
                "trans": DataArray(trans, batch + (gdim, crd_dim + "_out", crd_dim), coords, {"long_name": "Transformation from training to target spaces."}, "trans"),
                "ref_mean": DataArray(ref_mean, batch + (gdim, crd_dim), coords, {"long_name": "Centroid point of target."}, "ref_mean"),
                "hist_mean": DataArray(hist_mean, batch + (gdim, crd_dim), coords, {"long_name": "Centroid point of training."}, "hist_mean"),
            }
        )
        return ds, {"group": group, "crd_dim": crd_dim, "best_orientation": best_orientation}

    def _adjust(self, sim: DataArray):
        gi = self.group.indexes(sim.time)
        arr, simc, ax = _points_last(sim, self.crd_dim)                         # [..., M, T]
        # the per-group mean of sim (reference adjustment.py:1219: vmean)
        sim_mean = torch.nanmean(gather_groups(arr, gi.gather_idx), dim=-1)   # [..., M, G]
        trans = as_tensor(self.ds["trans"].data, dtype=arr.dtype, device=arr.device)         # [..., G, M, M]
        ref_mean = as_tensor(self.ds["ref_mean"].data, dtype=arr.dtype, device=arr.device)   # [..., G, M]
        gidx = torch.as_tensor(gi.group_idx, device=arr.device).long()
        # a time step t: scen[:, t] = ref_mean[g(t)] + trans[g(t)] @ (sim[:, t] - sim_mean[g(t)])
        centred = arr - sim_mean[..., gidx]                                      # [..., M, T]
        rotated = (trans[..., gidx, :, :] @ centred.movedim(-1, -2)[..., None])[..., 0]   # [..., T, M]
        scen = ref_mean[..., gidx, :].movedim(-1, -2) + rotated.movedim(-1, -2)
        res = DataArray(torch.movedim(scen, -2, ax), simc.dims, dict(simc.coords), dict(sim.attrs), "scen")
        return res.transpose(*sim.dims) if simc.dims != sim.dims else res
