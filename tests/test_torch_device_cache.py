"""The port's device-copy cache (``models/_wrap.py:to_device_cached``)
against the JAX package's (``xsdba_tpu/models/_wrap.py``), on the CPU.

The fingerprint is the reference's, value for value; an entry is keyed by
the owning buffer, the view, the fingerprint and the device, dies with its
owner, goes past 32 entries, and is never made for an owner that takes no
weak reference.  The public train and adjust upload a numpy input once,
and nothing they do writes into the shared copy.
"""

import gc

import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from xsdba_tpu.models._wrap import _fingerprint as ref_fingerprint
from xsdba_tpu_torch.models import _wrap


@pytest.fixture(autouse=True)
def _fresh_cache():
    """Each test starts from an empty cache on the CPU."""
    _wrap.clear_device_cache()
    with xp.set_options(device="cpu"):
        yield
    _wrap.clear_device_cache()


def _arrays():
    rng = np.random.default_rng(3)
    big = rng.normal(size=(7, 1000)).astype(np.float32)
    return {
        "float32": big,
        "row view": big[2:5, 13:],
        "transpose": big.T,
        "float64 strided": rng.normal(size=(40, 30))[::3, ::2],
        "int32": np.arange(5000, dtype=np.int32),
        "small": np.array([1.5, -0.0, np.nan]),
        "empty": np.zeros((0, 4)),
    }


@pytest.mark.parametrize("name", list(_arrays()))
def test_fingerprint_is_the_references(name):
    a = _arrays()[name]
    assert _wrap._fingerprint(a) == ref_fingerprint(a)


def test_hit_returns_the_same_copy():
    a = np.random.default_rng(0).normal(size=(3, 50))
    before = _wrap.misses
    t1 = _wrap.to_device_cached(a)
    t2 = _wrap.to_device_cached(a)
    assert t1 is t2 and _wrap.misses == before + 1
    np.testing.assert_array_equal(t1.numpy(), a)
    assert t1.data_ptr() != a.__array_interface__["data"][0]      # the cache's own copy
    # a second view of the same bytes hits too; another view is another entry
    assert _wrap.to_device_cached(a[1:]) is _wrap.to_device_cached(a[1:])
    assert _wrap.to_device_cached(a[1:]) is not t1
    # a tensor keeps its device and is never cached; a device given moves it
    t = torch.ones(3)
    assert _wrap.to_device_cached(t) is t and _wrap.to_device_cached(t, "cpu") is t
    assert _wrap.to_device_cached(t, "meta").device.type == "meta" and len(_wrap._DEV_CACHE) == 2


def test_mutation_misses():
    a = np.zeros((4, 300))
    t1 = _wrap.to_device_cached(a)
    a += 1.0
    t2 = _wrap.to_device_cached(a)
    assert t2 is not t1 and float(t2.sum()) == a.size and float(t1.sum()) == 0.0


def test_edit_between_samples_reuses_the_stale_copy():
    """The documented limit, the reference's too: one element changed
    between the fingerprint's samples leaves the key as it was, so the
    cached copy, now stale, comes back."""
    a = np.zeros(100_000)
    fp, ref_fp = _wrap._fingerprint(a), ref_fingerprint(a)
    t1 = _wrap.to_device_cached(a)
    a[1] = 5.0                                     # the samples are every 97th value and the last 8
    assert _wrap._fingerprint(a) == fp and ref_fingerprint(a) == ref_fp
    t2 = _wrap.to_device_cached(a)
    assert t2 is t1 and float(t2[1]) == 0.0


def test_device_is_part_of_the_key():
    a = np.arange(12.0)
    cpu = _wrap.to_device_cached(a, "cpu")
    meta = _wrap.to_device_cached(a, "meta")
    assert cpu.device.type == "cpu" and meta.device.type == "meta"
    assert _wrap.to_device_cached(a, "meta") is meta and _wrap.to_device_cached(a) is cpu


def test_eviction_at_32_entries():
    arrays = [np.full(10, float(i)) for i in range(_wrap._DEV_CACHE_MAX + 1)]
    first = _wrap.to_device_cached(arrays[0])
    for a in arrays[1:]:
        _wrap.to_device_cached(a)
    assert len(_wrap._DEV_CACHE) == _wrap._DEV_CACHE_MAX
    before = _wrap.misses
    again = _wrap.to_device_cached(arrays[0])                        # the oldest went first
    assert again is not first and _wrap.misses == before + 1
    assert _wrap.to_device_cached(arrays[-1]) is _wrap.to_device_cached(arrays[-1])


def test_entry_dies_with_its_owner():
    a = np.ones((5, 5))
    _wrap.to_device_cached(a[1:])
    _wrap.to_device_cached(a)
    assert len(_wrap._DEV_CACHE) == 2
    del a
    gc.collect()
    assert len(_wrap._DEV_CACHE) == 0


def test_no_entry_for_an_owner_without_weak_references():
    a = np.frombuffer(np.arange(8.0).tobytes(), dtype=np.float64)     # owned by a bytes object
    t = _wrap.to_device_cached(a)
    np.testing.assert_array_equal(t.numpy(), np.arange(8.0))
    assert len(_wrap._DEV_CACHE) == 0


@pytest.mark.parametrize("cls,group", [("QuantileDeltaMapping", "time.month"), ("EmpiricalQuantileMapping", ("time.dayofyear", 31))])
def test_train_adjust_adjust_upload_once(cls, group):
    """train, adjust, adjust on the same numpy arrays: the second adjust
    uploads nothing, gives the same scen, and leaves the shared copies as
    they were uploaded."""
    t = xp.date_range("2001-01-01", periods=365 * 3, freq="D", calendar="noleap")
    rng = np.random.default_rng(8)
    ref, hist, sim = (rng.normal(m, 2, (3, len(t))).astype(np.float32) for m in (10, 12, 13))
    hist[1, ::7] = np.nan
    das = [xp.DataArray(a, ("site", "time"), {"time": t}, {"units": "K"}, "tas") for a in (ref, hist, sim)]
    g = group if isinstance(group, str) else xp.Grouper(*group)
    trained = getattr(xp, cls).train(das[0], das[1], group=g, nquantiles=15)
    first = trained.adjust(das[2], interp="linear").data.clone()
    copies = {k: v.clone() for k, v in _wrap._DEV_CACHE.items()}
    assert len(copies) == 3
    before = _wrap.misses
    second = trained.adjust(das[2], interp="linear").data
    assert _wrap.misses == before
    np.testing.assert_array_equal(second.numpy(), first.numpy())
    for k, v in copies.items():
        torch.testing.assert_close(_wrap._DEV_CACHE[k], v, rtol=0, atol=0, equal_nan=True)
    for a, c in zip((ref, hist, sim), (_wrap.to_device_cached(a) for a in (ref, hist, sim))):
        np.testing.assert_array_equal(c.numpy(), a)
