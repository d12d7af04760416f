"""Where float32 npdft training parts between the port and the JAX package.

The inputs of ``tests/test_torch_npdft.py::test_npdft_train_core`` (20
rotations) go through both packages' ``npdft_train_core``; this prints, for
float32 and float64, each rotation's largest factor difference, the first
rotation whose factors differ by more than the test's tolerance (where the
states part, ROADMAP C12), the share of later factors off, and the energy
scores' relative differences.  The reference's side needs JAX, the port's
only PyTorch, so the two can run on different machines:

    python scripts/npdft_parting.py save ref.npz   # inputs + the JAX package's result
    python scripts/npdft_parting.py read ref.npz   # the port on this machine's CPU
    python scripts/npdft_parting.py both           # both here
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TOL = {"float32": 5e-5, "float64": 1e-10}
KW = dict(interp="nearest", extrap="constant", n_escore=100)


def save(path=None):
    import jax

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_npdft as M
    from xsdba_tpu.ops.rotation import rand_rot_matrix
    from xsdba_tpu.utils.rng import seed

    seed(7)
    rots = np.array(rand_rot_matrix(M.V, num=20, dtype=np.float64))
    out = {}
    for dt in (np.float32, np.float64):
        ref, hist = M._blocks(dt)
        r, q = rots.astype(dt), M.Q.astype(dt)
        af, esc = (np.asarray(a) for a in M.J.npdft_train_core(ref, hist, r, q, **KW))
        n = np.dtype(dt).name
        out.update({f"ref_{n}": ref, f"hist_{n}": hist, f"r_{n}": r, f"q_{n}": q, f"af_{n}": af, f"esc_{n}": esc})
    if path:
        np.savez(path, **out)
    return out


def read(d):
    import torch

    import xsdba_tpu_torch as xp
    from xsdba_tpu_torch.models import _npdft as T

    print("torch", torch.__version__, flush=True)
    for n, tol in TOL.items():
        with xp.set_options(device="cpu"):
            args = (torch.from_numpy(d[f"{k}_{n}"]) for k in ("ref", "hist", "r", "q"))
            af, esc = (a.numpy() for a in T.npdft_train_core(*args, **KW))
        want, wesc = d[f"af_{n}"], d[f"esc_{n}"]
        diff = np.abs(af - want)
        per = np.nanmax(diff, axis=(0, 2, 3))
        p = int(np.argmax(per > tol)) if (per > tol).any() else len(per)
        after = diff[:, p:][np.isfinite(want[:, p:])]
        print(f"[npdft {n}] NaN pattern equal: {np.array_equal(np.isnan(af), np.isnan(want))}; "
              f"largest factor difference a rotation: {per.tolist()}; parting rotation {p}; "
              f"share off after it {float(np.mean(after > tol)) if after.size else 0.0}; "
              f"largest difference / factor range {float(np.nanmax(diff) / (np.nanmax(want) - np.nanmin(want)))}; "
              f"scores' relative differences {np.abs(esc[0] / wesc[0] - 1).tolist()}", flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "both"
    if mode == "save":
        save(sys.argv[2])
    elif mode == "read":
        read(np.load(sys.argv[2]))
    else:
        read(save())
