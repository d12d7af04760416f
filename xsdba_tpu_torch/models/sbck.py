"""SBCK wrapper gateway (reference ``adjustment.py:1976-2076``).

The reference generates one ``Adjust`` class for each SBCK (Eigen/C++)
bias-correction class with a fit/predict interface.  SBCK is an optional
dependency there and is not installed here; the same generation activates
when an SBCK-compatible module is importable and raises a clear error
otherwise.  SBCK works on host numpy arrays, so the wrapped classes hand it
the data on the CPU and return the result as a tensor on the device of
``sim``.  The core SBCK algorithms (OTC, dOTC, QM...) have native
equivalents in this package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.container import DataArray
from ..utils.tensor import default_device, to_numpy
from .base import Adjust

__all__ = ["generate_sbck_classes"]


def _time_last(da: DataArray) -> np.ndarray:
    return to_numpy(da.move_dim_last("time").data)


def _wrap_sbck_class(sbck_cls) -> type:
    """An ``Adjust`` subclass around an SBCK fit/predict class (reference
    adjustment.py:1984-2052)."""

    class _SBCKAdjust(Adjust):
        sbck = sbck_cls

        @classmethod
        def _adjust(cls, ref: DataArray, hist: DataArray, sim: DataArray, *, multi_dim=None, **kwargs):
            def _apply(r, h, s):
                obj = cls.sbck(**kwargs)
                obj.fit(Y0=r, X0=h, X1=s)
                return np.asarray(obj.predict(X1=s))

            simc = sim.move_dim_last("time")
            device = sim.data.device if isinstance(sim.data, torch.Tensor) else default_device()
            if multi_dim is not None:
                # SBCK expects [time, variables]: one joint fit over multi_dim
                def _tv(da):
                    dac = da.move_dim_last("time")
                    return np.moveaxis(to_numpy(dac.data), dac.dims.index(multi_dim), -1)

                out = np.moveaxis(_apply(_tv(ref), _tv(hist), _tv(sim)), -1, simc.dims.index(multi_dim))
            else:
                # without multi_dim, every other dim is a separate univariate
                # fit (the reference's apply_ufunc(vectorize=True))
                r, h, s = _time_last(ref), _time_last(hist), _time_last(sim)
                rf, hf, sf = (a.reshape(-1, a.shape[-1]) for a in (r, h, s))
                rows = [_apply(rf[i][:, None], hf[i][:, None], sf[i][:, None]).reshape(-1) for i in range(sf.shape[0])]
                out = np.stack(rows).reshape(s.shape)
            return DataArray(torch.as_tensor(out, device=device), simc.dims, dict(simc.coords), dict(sim.attrs), "scen")

    return _SBCKAdjust


def generate_sbck_classes() -> list[tuple[str, type]]:
    """Discover the SBCK classes with a fit/predict interface and wrap them
    (reference ``__init__.py:45-47`` activation).  Raises ``ImportError``
    when no module named ``SBCK`` is importable."""
    try:
        import SBCK  # noqa: N811
    except ImportError as err:
        raise ImportError(
            "The optional dependency SBCK is not installed in this environment. "
            "Native equivalents of its main methods are available: OTC, dOTC, "
            "EmpiricalQuantileMapping, QuantileDeltaMapping..."
        ) from err
    out = []
    for name in dir(SBCK):
        obj = getattr(SBCK, name)
        if isinstance(obj, type) and hasattr(obj, "fit") and hasattr(obj, "predict"):
            cls = _wrap_sbck_class(obj)
            cls.__name__ = f"SBCK_{name}"
            out.append((cls.__name__, cls))
    return out
