"""Parametrizable objects + trained-state persistence.

The reference's checkpoint contract (SURVEY §5): the *trained adjustment
object is the checkpoint* — params jsonpickled into ``ds.attrs`` plus the
training arrays in NetCDF (``base.py:26-100``).  Here the same contract is a
plain-JSON header (no arbitrary code execution, unlike jsonpickle) plus an
``.npz`` of the training arrays; ``from_file``/``from_dataset`` restore a
working object.  The layout is the one ``xsdba_tpu`` writes, so a file saved
by either package loads in the other.  Arrays load as numpy and move to the
device of the data they later adjust.
"""

from __future__ import annotations

import json

import numpy as np

from .container import DataArray, Dataset
from .grouper import Grouper
from .tensor import to_numpy

__all__ = ["Parametrizable", "ParametrizableWithDataset"]

_ATTRIBUTE = "_xsdba_parameters"


def _encode_param(v):
    if isinstance(v, Grouper):
        return {"__grouper__": True, "group": v.name, "window": v.window, "add_dims": list(v.add_dims or [])}
    if isinstance(v, np.ndarray):
        return {"__ndarray__": True, "data": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _decode_param(v):
    if isinstance(v, dict) and v.get("__grouper__"):
        return Grouper(v["group"], window=v["window"], add_dims=v.get("add_dims") or None)
    if isinstance(v, dict) and v.get("__ndarray__"):
        return np.asarray(v["data"], dtype=v["dtype"])
    return v


class Parametrizable(dict):
    """Frozen parameter record with a helpful repr — reference base.py:26-72."""

    _repr_hide_params: list[str] = []

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as err:
            raise AttributeError(name) from err

    @property
    def parameters(self) -> dict:
        return dict(self)

    def __repr__(self):
        shown = {k: v for k, v in self.items() if k not in self._repr_hide_params}
        params = ", ".join(f"{k}={v!r}" for k, v in shown.items())
        return f"{self.__class__.__name__}({params})"

    def to_json(self) -> str:
        return json.dumps(
            {"cls": self.__class__.__name__, "params": {k: _encode_param(v) for k, v in self.items()}}
        )


class ParametrizableWithDataset(Parametrizable):
    """Parametrizable holding a training Dataset; persists to .npz
    (reference base.py:75-100 round-trip contract)."""

    _attribute = _ATTRIBUTE

    @classmethod
    def _registry(cls):
        def _walk(c):
            yield c
            for s in c.__subclasses__():
                yield from _walk(s)

        return {c.__name__: c for c in _walk(ParametrizableWithDataset)}

    @classmethod
    def from_dataset(cls, ds: Dataset) -> "ParametrizableWithDataset":
        """Restore the trained object from a Dataset carrying the params attr."""
        header = json.loads(ds.attrs[cls._attribute])
        klass = cls._registry().get(header["cls"], cls)
        obj = klass(**{k: _decode_param(v) for k, v in header["params"].items()})
        obj.set_dataset(ds)
        return obj

    def set_dataset(self, ds: Dataset):
        self.ds = ds
        self.ds.attrs[self._attribute] = self.to_json()

    def __getattr__(self, name):
        if name == "ds":
            raise AttributeError("no dataset set")
        return super().__getattr__(name)

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)

    # -- file persistence --------------------------------------------------

    def save(self, path: str):
        """Write params + training arrays to ``path`` (.npz)."""
        arrays = {}
        meta = {"header": self.ds.attrs[self._attribute], "vars": {}, "attrs": self.ds.attrs}
        for name, da in self.ds.items():
            arrays[f"var_{name}"] = to_numpy(da.data)
            coords = {}
            for cname, c in da.coords.items():
                if hasattr(c, "year"):  # TimeIndex
                    arrays[f"time_{name}_{cname}"] = np.stack([c.year, c.month, c.day])
                    coords[cname] = {"__time__": True, "calendar": c.calendar}
                else:
                    arrays[f"coord_{name}_{cname}"] = np.asarray(c)
                    coords[cname] = {"__time__": False}
            meta["vars"][name] = {"dims": da.dims, "attrs": da.attrs, "coords": coords}
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        # np.savez appends ".npz" to extension-less paths; normalize so
        # save(p) / from_file(p) round-trip for any p
        if not str(path).endswith(".npz"):
            path = f"{path}.npz"
        np.savez(path, **arrays)

    @classmethod
    def from_file(cls, path: str) -> "ParametrizableWithDataset":
        from .calendar import TimeIndex

        import os

        if not os.path.exists(path) and os.path.exists(f"{path}.npz"):
            path = f"{path}.npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            data_vars = {}
            for name, vmeta in meta["vars"].items():
                coords = {}
                for cname, cinfo in vmeta["coords"].items():
                    if cinfo["__time__"]:
                        y, m, d = z[f"time_{name}_{cname}"]
                        coords[cname] = TimeIndex(y, m, d, cinfo["calendar"])
                    else:
                        coords[cname] = z[f"coord_{name}_{cname}"]
                data_vars[name] = DataArray(z[f"var_{name}"], tuple(vmeta["dims"]), coords, vmeta["attrs"], name)
        ds = Dataset(data_vars, dict(meta["attrs"]))
        ds.attrs[cls._attribute] = meta["header"]
        return cls.from_dataset(ds)
