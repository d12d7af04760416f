"""The port's public surface against the JAX package's, by ``inspect``.

For every public module of either package (a dotted path with no part that
starts with ``_``):

- the module exists in both packages;
- each public name of either side resolves in the other;
- each function and class, at the module that defines it, has the same
  ``inspect.signature`` on both sides (parameter names, their order, their
  kinds and their defaults), and so has each public method of a class.

A module's public names are its ``__all__`` where it has one, else every
attribute that is not private and not a module and is a constant or a
function or class of one of the two packages; to either, the functions and
classes the module defines itself are added.

Every difference is keyed ``(module, name, parameter)``: name None for a
whole module, parameter None for a whole name, ``Class.method`` for a
method.  Each must be in ``ALLOWED`` with its one-line reason, and each entry
of ``ALLOWED`` must still be a difference, so the list cannot go stale or
cover new drift.  A difference that is a fault is repaired, not listed.
"""

import functools
import importlib
import inspect
import math
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = "xsdba_tpu", "xsdba_tpu_torch"

ALLOWED = {
    # modules one package has and the other has not
    ("ops.pallas", None, None): "the Pallas kernels; the port's hand-written CUDA kernels are ops/cuda, ops/merge.py and ops/sort.py",
    ("ops.pallas.interp_kernel", None, None): "Pallas K1 / K2; ported as csrc/interp_kernel.cu behind ops/cuda/interp_kernel.py",
    ("ops.pallas.merge_kernel", None, None): "Pallas K3-K6; ported as csrc/merge_kernel.cu behind ops/merge.py",
    ("ops.pallas.sort_kernel", None, None): "Pallas K7; ported as csrc/sort_kernel.cu behind ops/sort.py",
    ("parallel.dryrun", None, None): "the port's dry run of its parallel layer over spawned ranks (the reference's is in __graft_entry__)",
    ("ops.cuda", None, None): "the port's kernel wrappers and their build (the JAX package's are ops/pallas)",
    ("ops.cuda.emit_kernel", None, None): "the selection engine's dense emission as a CUDA kernel and its plain twin (plain JAX in the reference)",
    ("ops.cuda.fma_kernel", None, None): "x * y + z rounded once: XLA contracts it in the reference's compiled programs (C9)",
    ("ops.cuda.interp_kernel", None, None): "the wrappers of csrc/interp_kernel.cu (K1, K2, the bracketed lookup)",
    ("ops.merge", None, None): "the wrappers of csrc/merge_kernel.cu (K3-K6) and their plain twins",
    ("ops.sort", None, None): "the wrapper of csrc/sort_kernel.cu (K7) and its plain twin",
    ("utils.tensor", None, None): "the port's tensor helpers (devices, NaN reductions, the fma emulation); JAX has jnp",
    # names one side resolves and the other does not
    ("native", "library_path", None): "where the port builds the solver's library (a hashed name in the build directory)",
    ("ops.fitting", "betainc", None): "PyTorch has no regularized incomplete beta; jax.scipy.special provides the reference's",
    ("ops.interp", "bracket_steps", None): "the per-step brackets as the port's bracketed lookup kernel takes them (no Pallas counterpart)",
    ("ops.interp", "lookup_route", None): "the port's choice between its lookup kernels, a function of shape, dtype and device",
    ("ops.quantile", "speculative_static_dispatch", None): "a hedge against a remote TPU relay's latency; the port checks finiteness once",
    ("utils.grouper", "partition_by_group", None): "host partition layout feeding the port's lookup kernels",
    ("utils.options", "DEVICE", None): "the port's device option: where numpy inputs are computed (CUDA by default)",
    ("options", "DEVICE", None): "the port's device option, re-exported beside the reference's options",
    ("utils.rng", "next_key", None): "JAX's Threefry key stream; the port draws from torch.Generators (C4)",
    ("utils.rng", "next_generator", None): "the port's stream of torch.Generators, one a device (C4)",
    ("utils.profiling", "span", None): "the port's spans: record_function ranges and in-memory records while a torch.profiler session records",
    ("utils.profiling", "calls", None): "the public calls the port's spans recorded, with their counter deltas",
    ("utils.profiling", "reset_spans", None): "forgets the calls the port's spans recorded",
    ("utils.profiling", "count", None): "the port's counters of host reads and uploads",
    ("utils.profiling", "counters", None): "one snapshot of the port's counters, its kernel launch counters included",
    ("utils.profiling", "reset_counters", None): "zeroes the port's counters",
    ("", "generate_sbck_classes", None): "the port's models package re-exports the SBCK gateway, so its top level resolves it",
    ("models", "generate_sbck_classes", None): "the port's models package re-exports the SBCK gateway (the JAX package's: models.sbck)",
    ("ops.quantile", "merge_slab", None): "the port's merge-engine slab build, public for its kernels' smoke run; JAX builds it inline",
    ("ops.selquant", "max_chunk", None): "the port's site chunk bound of the gather engine; JAX computes its own inline",
    ("ops.selquant", "plan_labels", None): "the port's per-device cache of a plan's packed labels",
    ("models.eqm", "EmpiricalQuantileMapping.from_params", None): "builds a port object from a JAX-trained one's parameters",
    ("models.eqm", "QuantileDeltaMapping.from_params", None): "builds a port object from a JAX-trained one's parameters",
    # parameters
    ("ops.quantile", "nan_quantile", "fused"): "eager reference callers round the type-7 arithmetic unfused, compiled ones fused (C11)",
    ("ops.quantile", "vecquantiles", "fused"): "eager reference callers round the type-7 arithmetic unfused, compiled ones fused (C11)",
    ("ops.quantile", "windowed_group_quantile", "use_kernel"): "picks the Pallas merge kernels; the port picks its kernels from the device",
    ("ops.quantile", "windowed_group_quantile", "interpret"): "Pallas interpret mode; a CUDA kernel has none (CPU tensors take the twins)",
    ("ops.interp", "interp_grouped_partitioned", "regular0"): "the reference's regular-period fast path; on CUDA the port takes its bracketed kernel",
    ("ops.interp", "interp_grouped_partitioned", "steps"): "the per-step brackets (bracket_steps) that route the lookup to the bracketed kernel",
    ("ops.ot", "optimal_transport", "device"): "where the port's sinkhorn solver runs (emd solves on the host)",
    ("ops.rotation", "rand_rot_matrix", "key"): "a JAX PRNG key; the port takes a torch.Generator (C4)",
    ("ops.rotation", "rand_rot_matrix", "generator"): "the port's torch.Generator in place of a JAX key (C4)",
    ("ops.rotation", "rand_rot_matrix", "device"): "where the port draws the matrices",
    ("ops.rotation", "rand_rot_matrix", "dtype"): "jnp.float32 against torch.float32: each package's float32",
    ("ops.selquant", "selection_ok", "device"): "the port decides per device (CPU selects by default, CUDA on request)",
    ("ops.selquant", "default_sort_impl", "device"): "the stage-1 sort's default depends on the device (K7 on CUDA)",
    ("ops.selquant", "default_mode", "device"): "resolves auto by the data's device, as the reference resolves it by jax.default_backend()",
}


def _module_paths(pkg):
    """The public dotted module paths of a package, from its files."""
    base = ROOT / pkg
    out = set()
    for f in base.rglob("*.py"):
        parts = f.relative_to(base).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if not any(p.startswith("_") for p in parts):
            out.add(".".join(parts))
    return out


MODULES = sorted(_module_paths(JAX) | _module_paths(PORT))


def _import(pkg, path):
    try:
        return importlib.import_module(f"{pkg}.{path}" if path else pkg)
    except ModuleNotFoundError as e:  # the module, or a package above it, is absent
        if not f"{pkg}.{path}".startswith(e.name or "<none>"):
            raise
        return None


def _ours(obj):
    return (inspect.isfunction(obj) or inspect.isclass(obj)) and (getattr(obj, "__module__", "") or "").split(".")[0] in (JAX, PORT)


def _public(mod):
    if hasattr(mod, "__all__"):
        names = set(mod.__all__)
    else:
        names = set()
        for n in dir(mod):
            obj = getattr(mod, n)
            if n.startswith("_") or n == "annotations" or isinstance(obj, types.ModuleType):
                continue
            if _ours(obj) or not callable(obj):
                names.add(n)
    for n in dir(mod):
        obj = getattr(mod, n)
        if not n.startswith("_") and _ours(obj) and obj.__module__ == mod.__name__:
            names.add(n)
    return names


def _same_default(a, b):
    if a is b:
        return True
    if callable(a) and callable(b):
        return getattr(a, "__qualname__", None) == getattr(b, "__qualname__", None)
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    return bool(a == b)


def _signature_diffs(a, b):
    """{parameter: what differs} between two callables' signatures."""
    try:
        sa, sb = inspect.signature(a), inspect.signature(b)
    except (TypeError, ValueError):  # builtins without a signature
        return {}
    pa, pb = sa.parameters, sb.parameters
    out = {p: "JAX package only" for p in pa if p not in pb}
    out.update({p: "port only" for p in pb if p not in pa})
    common = [p for p in pa if p in pb]
    if common != [p for p in pb if p in pa]:
        out["<order>"] = f"{common} against {[p for p in pb if p in pa]}"
    for p in common:
        if pa[p].kind != pb[p].kind:
            out[p] = f"kind {pa[p].kind} against {pb[p].kind}"
        elif not _same_default(pa[p].default, pb[p].default):
            out[p] = f"default {pa[p].default!r} against {pb[p].default!r}"
    return out


def _class_diffs(a, b):
    """{(method, parameter): what differs} over the public methods."""
    out = {}
    for m in sorted(set(dir(a)) | set(dir(b))):
        if m.startswith("_"):
            continue
        ma, mb = getattr(a, m, None), getattr(b, m, None)
        if not callable(ma) and not callable(mb):
            continue  # attributes and properties
        if not (callable(ma) and callable(mb)):
            out[(m, None)] = "a method of the JAX package only" if callable(ma) else "a method of the port only"
            continue
        for p, d in _signature_diffs(ma, mb).items():
            out[(m, p)] = d
    return out


@functools.lru_cache(maxsize=None)
def differences(path):
    """{(module, name, parameter): what differs} for one module path."""
    j, t = _import(JAX, path), _import(PORT, path)
    if j is None or t is None:
        return {(path, None, None): f"a module of the {'port' if j is None else 'JAX package'} only"}
    out = {}
    for n in sorted(_public(j) | _public(t)):
        if not (hasattr(j, n) and hasattr(t, n)):
            out[(path, n, None)] = f"resolves in the {'JAX package' if hasattr(j, n) else 'port'} only"
            continue
        a, b = getattr(j, n), getattr(t, n)
        # compared where the JAX package defines it (a re-export is checked there)
        if not _ours(a) or a.__module__ != j.__name__:
            continue
        for p, d in _signature_diffs(a, b).items():
            out[(path, n, p)] = d
        if inspect.isclass(a) and inspect.isclass(b):
            for (m, p), d in _class_diffs(a, b).items():
                out[(path, f"{n}.{m}", p)] = d
    return out


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p or "<top level>")
def test_public_surface_matches_the_reference(path):
    unlisted = {k: d for k, d in differences(path).items() if k not in ALLOWED}
    assert not unlisted, "differences from the JAX package that ALLOWED does not list:\n" + "\n".join(f"{k}: {d}" for k, d in unlisted.items())


@pytest.mark.parametrize("key", sorted(ALLOWED, key=str), ids=lambda k: ":".join(str(p) for p in k if p is not None))
def test_allowlist_entry_is_still_a_difference(key):
    assert key[0] in MODULES, f"{key}: no such module in either package"
    assert key in differences(key[0]), f"{key} is no longer a difference: remove it from ALLOWED"
    assert ALLOWED[key] and "\n" not in ALLOWED[key]
