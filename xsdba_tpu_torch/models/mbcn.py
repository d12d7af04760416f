"""MBCn and NpdfTransform — multivariate bias adjustment.

Reference: ``adjustment.py:1718-1973`` (MBCn), ``adjustment.py:1239-1391`` +
``_adjustment.py:977-1057`` (NpdfTransform), with the npdft engine in
``models/_npdft.py``.  Group blocks are static gather matrices; the per-block
loops of the reference collapse into batched cores (blocks are a leading
batch axis), walked in chunks of blocks under an element budget.

Everything runs on the device of the data it is given (numpy data on the
``device`` option's device).  On float32 CUDA tensors every rotation's factor
lookup, and the per-block univariate QDM's, is one launch of the row lookup
kernel (``ops/interp.py:interp1d_table``, K2) with these schemes' default
``nearest`` method.  ``base_kws_vars`` may give a variable
``adapt_freq_thresh`` and ``jitter_under_thresh_value``: its ref, hist and
sim are jittered, then hist's and sim's blocks frequency-adapted, before
the block's QDM (as the JAX package does, on every chunk of blocks).
"""

from __future__ import annotations

import inspect
import warnings
from typing import Any

import numpy as np
import torch

from ..ops.correction import equally_spaced_nodes
from ..ops.escore import escore as escore_fn
from ..ops.interp import interp1d_table
from ..ops.quantile import nan_quantile
from ..ops.rank import rank_pct_rescaled
from ..ops.rotation import rand_rot_matrix
from ..ops.segment import gather_groups
from ..processing import _adapt_freq_grouped, _jitter_core, _reordering_core
from ..utils.container import DataArray, Dataset
from ..utils.grouper import Grouper
from ..utils.options import set_options
from ..utils.profiling import span
from ..utils.tensor import nanstd, numpy_dtype, upload
from ..utils.units import convert_units_to
from ._npdft import _escore_stride, _rotate, npdf_transform_core, npdft_adjust_core, npdft_train_core, standardize_lastaxis
from ._wrap import to_device_cached
from .base import Adjust, TrainAdjust
from .eqm import EmpiricalQuantileMapping, QuantileDeltaMapping

__all__ = ["MBCn", "NpdfTransform"]

# peak elements per gathered chunk of group blocks (patchable for tests)
_TRAIN_CHUNK_BUDGET = 1 << 27


def _to_vtime_layout(da: DataArray, pts_dim: str) -> DataArray:
    """Normalize to the cores' [V, ..., T] dim order."""
    order = (pts_dim,) + tuple(d for d in da.dims if d not in (pts_dim, "time")) + ("time",)
    return da.transpose(*order) if da.dims != order else da


def _mbcn_group(group) -> Grouper:
    group = Grouper(group) if isinstance(group, str) else group
    if group.prop == "month":
        raise NotImplementedError("Monthly grouping is not currently supported in the MBCn class.")
    if group.add_dims:
        raise NotImplementedError("`add_dims` is not supported in the MBCn class.")
    return group


def _quantile_nodes(nquantiles) -> np.ndarray:
    return equally_spaced_nodes(int(nquantiles)) if np.isscalar(nquantiles) else np.asarray(nquantiles)


def _rotations(rot_matrices, n_features: int, n_iter: int, like: torch.Tensor) -> torch.Tensor:
    """The injected rotations, or ``n_iter`` drawn from the global stream on
    ``like``'s device in its dtype, as a tensor like ``like``."""
    if rot_matrices is None:
        return rand_rot_matrix(n_features, num=max(n_iter, 2), dtype=like.dtype, device=like.device)[:n_iter]
    rot = rot_matrices.data if isinstance(rot_matrices, DataArray) else rot_matrices
    return upload(rot, dtype=like.dtype, device=like.device)


def _chunk_size(n_groups: int, batch: int, width: int) -> int:
    """Group blocks a chunk holds under ``_TRAIN_CHUNK_BUDGET`` elements."""
    return max(1, min(n_groups, _TRAIN_CHUNK_BUDGET // max(batch * width, 1)))


def _mbcn_train_block(refa, hista, gidx_chunk, rot, q, *, interp, extrap, n_escore):
    """One npdft training pass over a chunk of group blocks: refa/hista
    [V, ..., T], gidx_chunk [C, Lw] -> (af_q [..., C, I, V, nq],
    escores [..., C, I])."""
    refb = torch.movedim(gather_groups(refa, gidx_chunk), 0, -2)   # [..., C, V, Lw]
    histb = torch.movedim(gather_groups(hista, gidx_chunk), 0, -2)
    return npdft_train_core(refb, histb, rot, q, interp=interp, extrap=extrap, n_escore=n_escore)


class MBCn(TrainAdjust):
    r"""N-dimensional pdf transform bias adjustment (Cannon 2018).

    Train: iterative univariate quantile corrections in ``n_iter`` random
    rotations of the standardized multivariate space, factors stored per
    (group block, iteration, variable).  Adjust: replay the stored factors on
    sim, run a univariate base adjustment (QDM) per variable, and reorder it
    by the npdft ranks.  Parameters mirror reference adjustment.py:1718-1973.
    ``rot_matrices`` injects the rotations; without it they are drawn from
    the global generator stream (``utils/rng.py``) on the data's device.
    """

    _allow_diff_calendars = False
    _allow_diff_training_times = False
    _allow_diff_time_sizes = False

    @classmethod
    def _train(
        cls,
        ref: DataArray,
        hist: DataArray,
        *,
        base_kws: dict[str, Any] | None = None,
        adj_kws: dict[str, Any] | None = None,
        n_escore: int = -1,
        n_iter: int = 20,
        pts_dim: str = "multivar",
        rot_matrices=None,
    ):
        base_kws = dict(base_kws or {})
        adj_kws = dict(adj_kws or {})
        base_kws.setdefault("nquantiles", 20)
        base_kws.setdefault("group", Grouper("time", 1))
        adj_kws.setdefault("interp", "nearest")
        adj_kws.setdefault("extrapolation", "constant")
        group = _mbcn_group(base_kws["group"])
        quantiles = _quantile_nodes(base_kws["nquantiles"])

        # the cores run in [V, ..., T] layout — normalize any input dim order
        ref = _to_vtime_layout(ref, pts_dim)
        hist = _to_vtime_layout(hist, pts_dim)
        refa = to_device_cached(ref.data)                       # [V, ..., T]
        hista = to_device_cached(hist.data, refa.device)
        V = refa.shape[0]
        rot = _rotations(rot_matrices, V, n_iter, refa)
        quantiles = quantiles.astype(numpy_dtype(refa.dtype))
        q = upload(quantiles, device=refa.device)

        # Chunk over group blocks so windowed-doy training never materializes
        # the full [batch, G, V, window*years] tensor — each block trains
        # independently, like the reference's per-block loop
        # (_adjustment.py:386-417) but batched within each chunk.  The last
        # chunk is simply shorter: a Python loop has no static shape to pad to.
        gi = group.indexes(ref.time)
        G, Lw = gi.gather_idx.shape
        chunk = _chunk_size(G, int(np.prod(refa.shape[:-1], dtype=np.int64)), Lw)
        gidx = upload(gi.gather_idx, device=refa.device)
        kw = dict(interp=adj_kws["interp"], extrap=adj_kws["extrapolation"], n_escore=int(n_escore))
        parts = [_mbcn_train_block(refa, hista, gidx[g0 : g0 + chunk], rot, q, **kw) for g0 in range(0, G, chunk)]
        af_q = torch.cat([p[0] for p in parts], dim=-4)      # [..., G, I, V, nq]
        escores = torch.cat([p[1] for p in parts], dim=-2)   # [..., G, I]

        gdim = group.prop_name if gi.prop != "group" else "group"
        vnames = np.asarray(ref.coords.get(pts_dim, np.arange(V)))
        # extra batch dims (e.g. site) ride ahead of the grouped axes
        bdims = tuple(d for d in ref.dims if d not in (pts_dim, "time"))
        bcoords = {d: ref.coords[d] for d in bdims if d in ref.coords}
        ds = Dataset(
            {
                "af_q": DataArray(
                    af_q,
                    bdims + (gdim, "iterations", pts_dim + "_prime", "quantiles"),
                    {**bcoords, gdim: np.arange(gi.n_groups), "quantiles": quantiles, pts_dim + "_prime": vnames},
                    {"standard_name": "Adjustment factors", "long_name": "Quantile mapping adjustment factors"},
                    "af_q",
                ),
                "escores": DataArray(
                    escores, bdims + (gdim, "iterations"), {**bcoords, gdim: np.arange(gi.n_groups)}, {}, "escores"
                ),
                "rot_matrices": DataArray(
                    rot, ("iterations", pts_dim, pts_dim + "_prime"), {pts_dim: vnames, pts_dim + "_prime": vnames}, {}, "rot_matrices"
                ),
            }
        )
        params = {
            "group": group,
            "quantiles": quantiles,
            "interp": adj_kws["interp"],
            "extrapolation": adj_kws["extrapolation"],
            "pts_dims": [pts_dim, pts_dim + "_prime"],
            "n_escore": int(n_escore),
        }
        return ds, params

    def _adjust(
        self,
        sim: DataArray,
        ref: DataArray,
        hist: DataArray,
        *,
        base: type[TrainAdjust] = QuantileDeltaMapping,
        base_kws_vars: dict[str, Any] | None = None,
        adj_kws: dict[str, Any] | None = None,
        period_dim: str | None = None,
    ):
        # With period_dim, sim is a stack of periods whose extra dim flows
        # through every core as a leading batch axis (the reference's
        # apply_ufunc dims=[period_dim, "time"] path, _adjustment.py:539-541);
        # sim's time length must still match ref's.  ``base`` is accepted
        # for the reference's signature; the per-block step is QDM.
        self._check_matching_time_sizes(ref, hist)
        if sim.sizes["time"] != ref.sizes["time"]:
            raise ValueError("`sim` must have the same time length as `ref` (slice stacked periods accordingly).")

        pts_dim = self.pts_dims[0]
        group: Grouper = self.group
        # normalize to the cores' [V, ..., T] layout; restore sim's original
        # dim order on the way out
        orig_dims = sim.dims
        sim = _to_vtime_layout(sim, pts_dim)
        ref = _to_vtime_layout(ref, pts_dim)
        hist = _to_vtime_layout(hist, pts_dim)
        # a dimension without a coordinate is labelled 0..V-1, as in _train
        vnames = [str(v) for v in np.asarray(sim.coords.get(pts_dim, np.arange(sim.sizes[pts_dim])))]
        base_kws_vars = {k: dict(v) for k, v in (base_kws_vars or {}).items()}
        for v in vnames:
            base_kws_vars.setdefault(v, {})
            g = base_kws_vars[v].pop("group", group)
            g = Grouper(g) if isinstance(g, str) else g
            if g != group:
                raise ValueError(f"`group` input in _train and _adjust must be the same. Got {group} and {g}")
            base_kws_vars[v].setdefault("nquantiles", np.asarray(self.ds["af_q"].coords["quantiles"]))
        adj_kws = dict(adj_kws or {})
        adj_kws.setdefault("interp", self.interp)
        adj_kws.setdefault("extrapolation", self.extrapolation)

        gi = group.indexes(ref.time)
        gi_sim = group.indexes(sim.time)

        var_attrs = sim.attrs.get("_variable_attrs", {})
        sima = to_device_cached(sim.data)                        # [V, ..., T]
        dev = sima.device
        refa = to_device_cached(ref.data, dev)
        hista = to_device_cached(hist.data, dev)
        af_q_all = upload(self.ds["af_q"].data, device=dev)
        rots = upload(self.ds["rot_matrices"].data, dtype=af_q_all.dtype, device=dev)
        quantiles = upload(np.asarray(self.ds["af_q"].coords["quantiles"]), dtype=af_q_all.dtype, device=dev)

        G, Lw = gi_sim.gather_idx.shape
        chunk = _chunk_size(G, int(np.prod(sima.shape[:-1], dtype=np.int64)), Lw)
        group_idx = np.asarray(gi_sim.group_idx, dtype=np.int64)
        slot = np.asarray(gi_sim.scatter_slot, dtype=np.int64)

        scen = torch.zeros(sima.shape, dtype=af_q_all.dtype, device=dev)   # [V, ..., T] layout
        for g0 in range(0, G, chunk):
            g1 = min(g0 + chunk, G)
            rows_ref = upload(gi.gather_idx[g0:g1], device=dev)
            rows_sim = upload(gi_sim.gather_idx[g0:g1], device=dev)

            # --- 1. univariate base adjustment per variable, per block ------
            with span("mbcn.univariate"):
                scen_block = torch.stack(
                    [
                        _per_block_univariate(
                            refa[iv], hista[iv], sima[iv], rows_ref, rows_sim, base_kws_vars[v], adj_kws, var_attrs.get(v, {}).get("units") or ""
                        )
                        for iv, v in enumerate(vnames)
                    ],
                    dim=-2,
                )                                               # [..., C, V, Lw]

            # --- 2. npdft adjustment of standardized sim blocks -------------
            simb = torch.movedim(gather_groups(sima, rows_sim), 0, -2)   # [..., C, V, Lw]
            npdft_block = npdft_adjust_core(
                standardize_lastaxis(simb),
                af_q_all[..., g0:g1, :, :, :],
                rots,
                quantiles,
                interp=self.interp,
                extrap=self.extrapolation,
            )

            # --- 3. reorder the univariate scen by the npdft ranks ----------
            reordered = _reordering_core(npdft_block, scen_block)   # [..., C, V, Lw]

            # --- 4. write back window centers for this chunk's groups -------
            r2 = torch.movedim(reordered, -2, 0)                # [V, ..., C, Lw]
            steps = np.nonzero((group_idx >= g0) & (group_idx < g1))[0]
            at = upload(steps, device=dev)
            scen[..., at] = r2[..., upload(group_idx[steps] - g0, device=dev), upload(slot[steps], device=dev)]

        out = DataArray(scen, sim.dims, dict(sim.coords), dict(sim.attrs), "scen")
        if sim.dims != orig_dims:
            out = out.transpose(*orig_dims)
        return out


def _per_block_univariate(refa, hista, sima, rows_ref, rows_sim, base_kws, adj_kws, units: str = ""):
    """Train+adjust the univariate QDM per windowed group block, batched, on
    one variable's [..., T] tensors (in ``units``).

    Reference ``_adjustment.py:552-559``: inside each block the base is
    trained with group="time" on the block members — i.e. the block axis IS
    the group axis, so this is one grouped QDM over the gather matrices.
    ``jitter_under_thresh_value`` jitters ref, hist and sim first, and
    ``adapt_freq_thresh`` adapts hist's blocks to ref's and sim's with
    hist's trained P0 and pth.  Returns gathered scen blocks [..., C, Lw].
    """
    kws = dict(base_kws)
    nquantiles = _quantile_nodes(kws.pop("nquantiles"))
    kind = kws.pop("kind", "+")
    adapt_freq_thresh = kws.pop("adapt_freq_thresh", None)
    jitter_under = kws.pop("jitter_under_thresh_value", None)
    if kws:
        raise NotImplementedError(f"Unsupported base_kws_vars options: {sorted(kws)}")

    q = upload(nquantiles, dtype=refa.dtype, device=refa.device)
    if jitter_under is not None:
        lo = convert_units_to(jitter_under, units)
        refa, hista, sima = (_jitter_core(a, lo, None, None) for a in (refa, hista, sima))
    refg = gather_groups(refa, rows_ref)      # [..., C, Lw]
    histg = gather_groups(hista, rows_ref)
    simg = gather_groups(sima, rows_sim)
    if adapt_freq_thresh is not None:
        th = convert_units_to(adapt_freq_thresh, units)
        histg, P0_ref, P0_hist, pth, _ = _adapt_freq_grouped(refg, histg, th)
        simg, *_ = _adapt_freq_grouped(None, simg, th, P0_ref=P0_ref, P0_hist=P0_hist, pth=pth)

    # QDM train on blocks
    ref_q = nan_quantile(refg, q, axis=-1)
    hist_q = nan_quantile(histg, q, axis=-1)
    af = ref_q / hist_q if kind == "*" else ref_q - hist_q
    # QDM adjust within each block
    rnk = rank_pct_rescaled(simg, axis=-1)
    af_t = interp1d_table(rnk, q.expand(af.shape), af, adj_kws["interp"], adj_kws["extrapolation"])
    return simg * af_t if kind == "*" else simg + af_t


class NpdfTransform(Adjust):
    r"""N-dimensional pdf transform (Pitié 2005 / Cannon 2018 step 1).

    One-shot scheme: iterative univariate adjustment of hist & sim toward ref
    in random rotations of the multivariate space
    (reference adjustment.py:1239-1391, _adjustment.py:977-1057).
    Returns scen (the transformed sim); with ``extra_output``, also scenh
    (transformed hist) and escores.  ``base`` is QuantileDeltaMapping or
    EmpiricalQuantileMapping (the batched cores) or any other ported
    ``TrainAdjust`` class (a loop through its public train/adjust).
    """

    @classmethod
    def _adjust(
        cls,
        ref: DataArray,
        hist: DataArray,
        sim: DataArray,
        *,
        base: type[TrainAdjust] = QuantileDeltaMapping,
        base_kws: dict[str, Any] | None = None,
        adj_kws: dict[str, Any] | None = None,
        n_escore: int = 0,
        n_iter: int = 20,
        pts_dim: str = "multivar",
        rot_matrices=None,
    ):
        base_kws = dict(base_kws or {})
        adj_kws = dict(adj_kws or {})
        if "kind" in base_kws:
            warnings.warn(f'The adjustment kind cannot be controlled when using {cls.__name__}, it defaults to "+".', stacklevel=2)
        base_kws.setdefault("kind", "+")
        base_kws.setdefault("nquantiles", 20)
        group = base_kws.pop("group", "time")
        group = Grouper(group) if isinstance(group, str) else group
        quantiles = _quantile_nodes(base_kws["nquantiles"])
        interp = adj_kws.get("interp", "nearest")
        extrap = adj_kws.get("extrapolation", "constant")
        # any other TrainAdjust subclass (reference adjustment.py:1283-1307)
        # runs the reference's python loop over rotations, dispatching each
        # univariate step through the base's own public train/adjust
        base_name = {QuantileDeltaMapping: "qdm", EmpiricalQuantileMapping: "eqm"}.get(base)

        # normalize to the cores' [V, ..., T] layout
        ref = _to_vtime_layout(ref, pts_dim)
        hist = _to_vtime_layout(hist, pts_dim)
        sim = _to_vtime_layout(sim, pts_dim)

        refa = torch.movedim(to_device_cached(ref.data), 0, -2)  # [..., V, T]
        hista = torch.movedim(to_device_cached(hist.data, refa.device), 0, -2)
        sima = torch.movedim(to_device_cached(sim.data, refa.device), 0, -2)
        rot = _rotations(rot_matrices, refa.shape[-2], n_iter, refa)

        if base_name is None:
            scenh, scens, escores = _npdf_loop_general(
                base, base_kws, adj_kws, group, quantiles, ref, hist, sim, refa, hista, sima, rot, int(n_escore)
            )
            return cls._npdft_wrap_outputs(scenh, scens, escores, sim, hist)

        gi = group.indexes(ref.time)
        gi_sim = group.indexes(sim.time)
        scenh, scens, escores = npdf_transform_core(
            refa,
            hista,
            sima,
            rot,
            quantiles,
            gi.gather_idx,
            gi.group_idx,
            gi.scatter_slot,
            gi_sim.gather_idx,
            gi_sim.group_idx,
            gi_sim.scatter_slot,
            gi.frac_idx,
            gi.positions,
            gi_sim.frac_idx,
            gi_sim.positions,
            interp=interp,
            extrap=extrap,
            n_escore=int(n_escore),
            base=base_name,
        )
        return cls._npdft_wrap_outputs(scenh, scens, escores, sim, hist)

    @classmethod
    def _npdft_wrap_outputs(cls, scenh, scens, escores, sim, hist):
        def _wrap(a, like, name):
            return DataArray(torch.movedim(a, -2, 0), like.dims, dict(like.coords), dict(like.attrs), name)

        # escores: [batch..., n_iter] — batch dims are sim's dims without the
        # leading pts_dim and trailing time (the cores' [batch, V, T] layout)
        bdims = sim.dims[1:-1]
        bcoords = {d: sim.coords[d] for d in bdims if d in sim.coords}
        return Dataset(
            {
                "scen": _wrap(scens, sim, "scen"),
                "scenh": _wrap(scenh, hist, "scenh"),
                "escores": DataArray(escores, bdims + ("iterations",), bcoords, {}, "escores"),
            }
        )


def _npdf_loop_general(base, base_kws, adj_kws, group, quantiles, ref, hist, sim, refa, hista, sima, rots, n_escore):
    """NpdfTransform with an arbitrary TrainAdjust base: the reference's
    per-iteration loop (``_adjustment.py:1005-1037``) — rotate, train the base
    on the rotated pair, adjust rotated hist & sim, rotate back — dispatched
    through the base class's own public train/adjust (``skip_input_checks``
    avoids re-validating the rotated, unit-less space each iteration).
    ref/hist/sim are the [V, ..., T] arrays (for their labels), refa/hista/
    sima their [..., V, T] tensors.  A base whose ``_train`` takes no
    ``nquantiles`` (Scaling) is trained without it; the JAX package hands
    it to every base and so refuses such a one."""

    def wrap(a, like):
        return DataArray(torch.movedim(a, -2, 0), like.dims, dict(like.coords), dict(like.attrs), like.name)

    def unwrap(da):
        return torch.movedim(to_device_cached(da.move_dim_last("time").data), 0, -2)

    stride = _escore_stride(refa.shape[-1], n_escore)
    mu = torch.nanmean(refa, dim=-1, keepdim=True)
    sd = nanstd(refa, axis=-1, keepdims=True, ddof=1)
    ref_n = ((refa - mu) / sd)[..., ::stride]

    train_kws = dict(base_kws)
    train_kws.pop("nquantiles", None)
    accepted = inspect.signature(base._train).parameters
    if "nquantiles" in accepted or any(p.kind is p.VAR_KEYWORD for p in accepted.values()):
        train_kws["nquantiles"] = np.asarray(quantiles)
    escores = []
    h, s = hista, sima
    for R in rots:
        refp, hp, sp = _rotate(R, refa), _rotate(R, h), _rotate(R, s)
        with set_options(extra_output=False, as_dataset=False):
            ADJ = base.train(wrap(refp, ref), wrap(hp, hist), group=group, skip_input_checks=True, **train_kws)
            scenhp = ADJ.adjust(wrap(hp, hist), skip_input_checks=True, **adj_kws)
            # sim must carry its OWN time coords: the base adjustment derives
            # its group indexes (and any calendar logic) from the wrapped time
            scensp = ADJ.adjust(wrap(sp, sim), skip_input_checks=True, **adj_kws)
        h = _rotate(R, unwrap(scenhp), transpose=True)
        s = _rotate(R, unwrap(scensp), transpose=True)
        if n_escore >= 0:
            escores.append(escore_fn(ref_n, ((h - mu) / sd)[..., ::stride]))
        else:
            escores.append(torch.full(h.shape[:-2], torch.nan, dtype=h.dtype, device=h.device))
    return h, s, torch.stack(escores, dim=-1)
