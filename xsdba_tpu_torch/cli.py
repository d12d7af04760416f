"""Command line interface of the port: ``xsdba-tpu-torch`` or
``python -m xsdba_tpu_torch.cli``.

``selftest`` trains and adjusts a small EQM on the ``device`` option's
device (CUDA unless the caller asks for the CPU) and checks that the bias
is removed; ``bench`` would run the port's benchmark, which this checkout
does not have yet (ROADMAP A3).  The JAX package's ``bench`` runs
``bench.py``, which imports JAX, so the port never runs it.
"""

from __future__ import annotations

import argparse
import sys


def _selftest_run():
    """The selftest's EQM (the JAX package's ``cli._selftest``): returns
    (mean |scen - ref|, the device ``scen`` was computed on)."""
    import numpy as np
    from scipy import stats

    import xsdba_tpu_torch as xp
    from xsdba_tpu_torch.utils.tensor import to_numpy

    t = xp.date_range("2000-01-01", periods=365 * 3, freq="D", calendar="noleap")
    u = np.random.default_rng(0).random(len(t))
    ref = xp.DataArray(stats.norm.ppf(u, 10, 1), ("time",), {"time": t}, {"units": "K"}, "tas")
    hist = xp.DataArray(stats.norm.ppf(u, 12, 2), ("time",), {"time": t}, {"units": "K"}, "tas")
    eqm = xp.EmpiricalQuantileMapping.train(ref, hist, group="time.month", nquantiles=20)
    scen = eqm.adjust(hist, interp="linear")
    return float(np.abs(to_numpy(scen.data) - ref.data).mean()), scen.data.device


def _selftest() -> int:
    from .native import have_native

    bias, device = _selftest_run()
    ok = bias < 0.5
    print(f"selftest on {device}: residual |bias| = {bias:.9f} -> {'OK' if ok else 'FAIL'}")
    print(f"native EMD solver: {'available' if have_native() else 'unavailable (g++ missing?)'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="xsdba-tpu-torch", description="Statistical downscaling and bias adjustment in PyTorch (CUDA by default)."
    )
    parser.add_argument("--version", action="store_true", help="Print the version and exit.")
    sub = parser.add_subparsers(dest="cmd")
    sub.add_parser("selftest", help="Train+adjust a small EQM on the device option's device and check the bias is removed.")
    sub.add_parser("bench", help="The port's throughput benchmark (ROADMAP A3; not in this checkout yet).")
    args = parser.parse_args(argv)
    if args.version:
        from . import __version__

        print(__version__)
        return 0
    if args.cmd == "selftest":
        return _selftest()
    if args.cmd == "bench":
        # the JAX package's bench.py imports JAX: never run it from the port
        print("the port's benchmark (ROADMAP A3) is not in this checkout; bench.py is the JAX package's and needs JAX.", file=sys.stderr)
        return 1
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
