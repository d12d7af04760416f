"""The reference's ``xsdba.loess`` import path; the smoother is
``ops/loess.py`` (the gathered-window core, and an FFT interior on long
equally spaced series)."""

from .ops.loess import loess_smoothing  # noqa: F401
