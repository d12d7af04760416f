"""Host C++ components: the exact optimal-transport solver.

The reference takes its exact transport plans from the C++ POT package
(``utils.py:1083``); the port keeps its own network-simplex solver
(``emd.cpp``: ``emd_solve``, and the successive-shortest-paths
``emd_solve_ssp`` that cross-checks it).  This is host code, not a GPU
kernel: OTC and dOTC solve their plans on the CPU whatever the data's
device.  ``g++ -O3 -shared -fPIC`` builds it at first use into the
git-ignored build directory of the port's CUDA libraries
(``ops/cuda/_build.py``), named after a hash of the source and flags, and
``ctypes`` binds it.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..ops.cuda._build import _build_dir

__all__ = ["emd", "emd_ssp", "library_path"]

SOURCE = Path(__file__).resolve().parent / "emd.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the solver's library is (or will be) built."""
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return _build_dir() / f"libxsdba_emd_{tag}.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            arr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
            for fn in (lib.emd_solve, lib.emd_solve_ssp):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_int, ctypes.c_int, arr, arr, arr, arr]
            _lib = lib
        return _lib


def _solve(name: str, mu, nu, cost) -> np.ndarray:
    mu, nu, cost = (np.ascontiguousarray(a, dtype=np.float64) for a in (mu, nu, cost))
    n, m = cost.shape
    plan = np.zeros((n, m), dtype=np.float64)
    # masses normalized to equal totals (POT does this for the reference)
    rc = getattr(_load(), name)(n, m, mu / mu.sum(), nu / nu.sum(), cost, plan)
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc}")
    return plan


def emd(mu, nu, cost) -> np.ndarray:
    """Exact optimal transport plan [n, m] between masses ``mu`` [n] and
    ``nu`` [m] under ``cost`` [n, m] (POT's ``ot.emd``), by network simplex."""
    return _solve("emd_solve", mu, nu, cost)


def emd_ssp(mu, nu, cost) -> np.ndarray:
    """An optimal plan by successive shortest paths: slower, and not on any
    path of the package; the tests check ``emd``'s plans against it."""
    return _solve("emd_solve_ssp", mu, nu, cost)
