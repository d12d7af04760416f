"""CF history / provenance helpers — reference ``formatting.py:69-202``."""

from __future__ import annotations

import datetime as _dt

__all__ = ["gen_call_string", "merge_attributes", "update_history", "update_xsdba_history"]


def gen_call_string(funcname: str, **kwargs) -> str:
    """Generate a readable call string like ``name(a=1, b='x')``
    (reference formatting.py:160-202)."""
    elements = []
    for k, v in kwargs.items():
        if hasattr(v, "name") and getattr(v, "name", None):
            v = getattr(v, "name")
        elif hasattr(v, "dims"):
            v = "<array>"
        elements.append(f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}")
    return f"{funcname}({', '.join(elements)})"


def merge_attributes(attribute: str, *inputs, new_line: str = "\n", missing_str=None) -> str:
    """Merge an attribute from several DataArrays (reference formatting.py:20-66)."""
    parts = []
    for da in inputs:
        name = getattr(da, "name", None) or "input"
        val = getattr(da, "attrs", {}).get(attribute, missing_str)
        if val is not None:
            parts.append(f"{name}: {val}")
    return new_line.join(parts)


def update_history(hist_str: str, *inputs, new_name: str | None = None) -> str:
    """Timestamped CF history line prepended to merged input histories
    (reference formatting.py:69-115)."""
    from .. import __version__

    merged = merge_attributes("history", *inputs, missing_str="")
    now = _dt.datetime.now(_dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S")
    line = f"[{now}] {new_name or ''}: {hist_str} - xsdba_tpu_torch version: {__version__}"
    return (merged + "\n" if merged else "") + line


def update_xsdba_history(func):
    """Decorator auto-filling the ``history`` attribute of the first output
    from the call signature (reference formatting.py:119-157).  The wrapped
    function's DataArray/Dataset output gains a timestamped history line
    merging its DataArray inputs' histories."""
    import functools

    @functools.wraps(func)
    def _call_and_add_history(*args, **kwargs):
        outs = func(*args, **kwargs)
        out = outs[0] if isinstance(outs, tuple) else outs
        attrs = getattr(out, "attrs", None)
        if attrs is None:
            raise TypeError(
                f"update_xsdba_history received a non-DataArray/Dataset output from {func.__name__}."
            )
        # DataArrays passed by keyword count as inputs too: their histories
        # merge and they appear (by name) in the rendered call string
        das = [a for a in args if hasattr(a, "dims")] + [v for v in kwargs.values() if hasattr(v, "dims")]
        attrs["history"] = update_history(
            gen_call_string(func.__name__, **kwargs), *das, new_name=getattr(out, "name", None)
        )
        return outs

    return _call_and_add_history
