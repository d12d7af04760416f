"""Build and bind the port's CUDA sources (``xsdba_tpu_torch/csrc/*.cu``).

Each source has a plain C interface and becomes its own shared library,
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside the
package (or ``$XSDBA_TORCH_BUILD_DIR``) and bound with ``ctypes``.  A library
is named after its source and a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a library built from the same source is
reused and a changed source or header is rebuilt.  :func:`build` compiles every stale source at once, one ``nvcc``
process each, all started together; :func:`library` builds (if needed) and
loads one.  The flags pass ``-fmad=false``, so no FMA contraction separates
a kernel from its plain PyTorch twin.  Importing this module needs neither
``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build", "library", "sources"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names (file stems) of every CUDA source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _build_dir() -> Path:
    env = os.environ.get("XSDBA_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[1] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit to build")


def _target(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _build_dir() / f"libxsdba_{name}_{tag}.so"


def build(names=None, verbose: bool = False) -> dict[str, tuple[Path, float]]:
    """Compile the named sources (every source by default) unless a library
    built from the same source and flags exists.  Stale sources compile in
    parallel.  Returns {name: (library path, seconds its nvcc took)}, 0.0
    for a library that was already there.  ``verbose`` rebuilds with
    ``-Xptxas -v`` and prints each compiler report.  Raises on any failure."""
    names = sources() if names is None else list(names)
    out: dict[str, tuple[Path, float]] = {}
    jobs = []
    for name in names:
        lib = _target(name)
        if lib.exists() and not verbose:
            out[name] = (lib, 0.0)
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
        cmd = [_nvcc(), *flags, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc, time.perf_counter()))
    failed = []
    for name, lib, tmp, proc, t0 in jobs:
        report, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{report}")
            continue
        if verbose:
            print(f"[build] {name}.cu:\n{report}", flush=True)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
        out[name] = (lib, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    each function of ``signatures`` ({function: (argtypes, restype)})
    declared."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, (args, res) in signatures.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        _loaded[name] = lib
    return lib
