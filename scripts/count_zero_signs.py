"""Count the signs of zero on which the merge engines disagree, on the CPU.

    JAX_PLATFORMS=cpu python scripts/count_zero_signs.py [--port-root DIR]

Runs the cases of ``tests/test_torch_merge_zeros.py`` (precipitation-like
data, 45 % of the days ±0.0) through three merge engines and prints, as
one JSON object, how many values of each pair differ by bit pattern (any
NaN equal to any NaN):

- ``port``: the port's merge engine (``selection_backend=False``; on a
  standard calendar also the CPU's default, which cannot select there);
- ``kernels``: the reference's with its Pallas merge kernels in interpret
  mode;
- ``xla``: the reference's CPU default, its XLA fallback merge.

The cases: ``windowed_group_quantile`` at the test's windows and calendars,
then the public ``kind="*"`` dayofyear QDM train (``af``, ``hist_q``) on a
standard calendar at window 31 with default options and on noleap at
window 5 on the merge engines.  ``--port-root`` imports ``xsdba_tpu_torch``
from another checkout (another commit's port, with this checkout's cases).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port-root", type=Path, default=ROOT, help="checkout whose xsdba_tpu_torch is counted")
    args = ap.parse_args()
    sys.path[:0] = [str(args.port_root.resolve()), str(ROOT), str(ROOT / "tests")]

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import pytest
    import torch

    import test_torch_merge_zeros as cases
    import xsdba_tpu as xt
    import xsdba_tpu_torch as xp
    from xsdba_tpu.ops import quantile as jquant
    from xsdba_tpu_torch.ops import quantile as pquant
    from xsdba_tpu_torch.ops.correction import equally_spaced_nodes

    assert Path(xp.__file__).resolve().is_relative_to(args.port_root.resolve()), xp.__file__
    xp.set_options(device="cpu")

    def differ(a, b):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        ints = np.int32 if a.dtype == np.float32 else np.int64
        nan = np.isnan(a) & np.isnan(b)
        return int(((np.ascontiguousarray(a).view(ints) != np.ascontiguousarray(b).view(ints)) & ~nan).sum())

    out = {"port": str(xp.__file__), "quantiles": {}, "trains": {}}
    for calendar, window, dtype in cases.ENGINE_CASES:
        kw = dict(periods=365 * 4, freq="D", calendar=calendar)
        gj = xt.Grouper("time.dayofyear", window=window).indexes(xt.date_range("2001-01-01", **kw))
        gp = xp.Grouper("time.dayofyear", window=window).indexes(xp.date_range("2001-01-01", **kw))
        x = cases.dry((2, 365 * 4), dtype, seed=window)
        q = equally_spaced_nodes(50).astype(dtype)
        kernels = jquant.windowed_group_quantile(x, gj.merge_plan, q, use_kernel=True, interpret=True)
        xla = jquant.windowed_group_quantile(x, gj.merge_plan, q, use_kernel=False)
        with xp.set_options(selection_backend=False):
            port = pquant.windowed_group_quantile(torch.as_tensor(x), gp.merge_plan, torch.as_tensor(q))
        out["quantiles"][f"{calendar} w={window} {np.dtype(dtype).name}"] = {
            "of": port.numel(), "port/kernels": differ(port, kernels), "xla/kernels": differ(np.asarray(xla), kernels)}

    for calendar, window, n_days, engine in (("standard", 31, 1461, {}), ("noleap", 5, 1460, {"selection_backend": False})):
        kw = dict(periods=n_days, freq="D", calendar=calendar)
        tj, tp = xt.date_range("2000-01-01", **kw), xp.date_range("2000-01-01", **kw)
        data = cases._dry_problem(n_days)
        port = cases._train(xp, tp, data, xp.Grouper("time.dayofyear", window=window), engine).ds
        xla = cases._train(xt, tj, data, xt.Grouper("time.dayofyear", window=window), engine).ds
        with pytest.MonkeyPatch.context() as mp:
            cases._through_pallas_kernels(mp)
            kernels = cases._train(xt, tj, data, xt.Grouper("time.dayofyear", window=window), engine).ds
        res = {"of": port["af"].data.numel()}
        for v in ("af", "hist_q"):
            res[f"{v} port/kernels"] = differ(port[v].data, kernels[v].data)
            res[f"{v} port/xla"] = differ(port[v].data, xla[v].data)
            res[f"{v} xla/kernels"] = differ(np.asarray(xla[v].data), kernels[v].data)
        out["trains"][f"{calendar} w={window} {'default options' if not engine else 'merge engines'}"] = res
    print(json.dumps(out))


if __name__ == "__main__":
    main()
