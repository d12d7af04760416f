"""Where the port computes: numpy data handed to the public entry points goes
to the ``device`` option's device (CUDA by default), tensors keep their own
device, and a CUDA default without a GPU raises instead of falling back to
the CPU.  CPU only: the "no GPU" cases hide any card the machine has."""

import numpy as np
import pytest
import torch

import xsdba_tpu_torch as xp
from xsdba_tpu_torch.utils import options
from xsdba_tpu_torch.utils.tensor import default_device, input_tensor


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port computes numpy inputs on CUDA by default; these tests ask for the CPU."""
    with xp.set_options(device="cpu"):
        yield


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _arrays(n_sites=2, years=2, seed=0):
    t = xp.date_range("2001-01-01", periods=365 * years, freq="D", calendar="noleap")
    rng = np.random.default_rng(seed)
    mk = lambda x: xp.DataArray(x, ("site", "time"), {"time": t}, {"units": "K"}, "tas")  # noqa: E731
    return [mk(rng.normal(10 + i, 2, (n_sites, len(t))).astype(np.float32)) for i in range(3)]


def test_the_default_is_cuda_and_the_option_is_checked():
    assert options._DEFAULTS[options.DEVICE] == "cuda"
    assert xp.get_option("device") == "cpu"
    with xp.set_options(device="cuda:1"):
        assert xp.get_option("device") == "cuda:1"
    with pytest.raises(ValueError, match="device"):
        xp.set_options(device="tpu")


@pytest.mark.parametrize("group,window", [("time.month", 1), ("time.dayofyear", 31), ("time", 1)])
def test_numpy_data_lands_on_the_option_device(group, window):
    ref, hist, sim = _arrays()
    eqm = xp.EmpiricalQuantileMapping.train(ref, hist, group=group, window=window, nquantiles=10)
    assert eqm.ds["af"].data.device.type == "cpu"
    assert eqm.adjust(sim, interp="linear").data.device.type == "cpu"
    assert input_tensor(np.zeros(3)).device.type == "cpu"


def test_grouper_apply_follows_the_option():
    ref, _, _ = _arrays()
    out = xp.Grouper("time.month").apply("mean", ref)
    assert isinstance(out.data, torch.Tensor) and out.data.device.type == "cpu"


def test_cuda_default_without_a_gpu_raises(no_gpu):
    ref, hist, _ = _arrays()
    with xp.set_options(device="cuda"):
        with pytest.raises(RuntimeError, match=r"set_options\(device='cpu'\)"):
            default_device()
        with pytest.raises(RuntimeError, match=r"set_options\(device='cpu'\)"):
            xp.EmpiricalQuantileMapping.train(ref, hist, group="time.month", nquantiles=10)


def test_tensors_keep_their_device_under_the_cuda_default(no_gpu):
    """CPU tensors compute on the CPU whatever the option says; a trained
    object whose parameters are numpy arrays adjusts them on sim's device."""
    ref, hist, sim = (xp.DataArray(torch.from_numpy(a.data), a.dims, a.coords, a.attrs, a.name) for a in _arrays())
    with xp.set_options(device="cuda"):
        qdm = xp.QuantileDeltaMapping.train(ref, hist, group="time.month", nquantiles=10)
        built = xp.QuantileDeltaMapping.from_params(
            qdm.ds["af"].data.numpy(), qdm.ds["hist_q"].data.numpy(), np.asarray(qdm.ds["af"].coords["quantiles"]),
            group="time.month", kind="+",
        )
        got = built.adjust(sim, interp="linear").data
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, qdm.adjust(sim, interp="linear").data, rtol=0, atol=0)


def _mv_arrays(n_sites=2, years=2):
    t = xp.date_range("2001-01-01", periods=365 * years, freq="D", calendar="noleap")
    rng = np.random.default_rng(1)
    mk = lambda mu: xp.DataArray(  # noqa: E731
        rng.normal(mu, 2, (n_sites, 2, len(t))).astype(np.float32), ("site", "multivar", "time"),
        {"time": t, "multivar": np.array(["a", "b"])}, {"units": ""}, "mv",
    )
    return mk(10), mk(11), mk(12)


MULTI = {
    "MBCn": lambda r, h, s: xp.MBCn.train(r, h, base_kws={"nquantiles": 6}, n_iter=2).adjust(s, r, h),
    "NpdfTransform": lambda r, h, s: xp.NpdfTransform.adjust(r, h, s, base_kws={"nquantiles": 6}, n_iter=2, n_escore=10),
    "Scaling": lambda r, h, s: xp.Scaling.train(r, h, group="time.month").adjust(s, interp="linear"),
    "LOCI": lambda r, h, s: xp.LOCI.train(r, h, group="time.month", thresh="9 K").adjust(s),
}


@pytest.mark.parametrize("cls", sorted(MULTI))
def test_new_classes_follow_the_device_option(cls):
    """Numpy-fed MBCn, NpdfTransform, Scaling and LOCI compute on the
    ``device`` option's device, and keep their trained parameters there."""
    arrays = _mv_arrays() if cls in ("MBCn", "NpdfTransform") else _arrays()
    out = MULTI[cls](*arrays)
    assert isinstance(out.data, torch.Tensor) and out.data.device.type == "cpu" and out.data.dtype == torch.float32
    assert out.dims == arrays[2].dims or cls == "NpdfTransform"
    if cls == "MBCn":
        trained = xp.MBCn.train(arrays[0], arrays[1], base_kws={"nquantiles": 6}, n_iter=2)
        assert all(trained.ds[n].data.device.type == "cpu" for n in ("af_q", "escores", "rot_matrices"))


@pytest.mark.parametrize("cls", sorted(MULTI))
def test_new_classes_raise_without_a_gpu_under_the_cuda_default(no_gpu, cls):
    arrays = _mv_arrays() if cls in ("MBCn", "NpdfTransform") else _arrays()
    with xp.set_options(device="cuda"):
        with pytest.raises(RuntimeError, match=r"set_options\(device='cpu'\)"):
            MULTI[cls](*arrays)


def test_processing_follows_the_device_option(no_gpu):
    ref, _, sim = _arrays()
    assert xp.processing.reordering(ref, sim).data.device.type == "cpu"
    assert xp.processing.standardize(ref)[0].data.device.type == "cpu"
    with xp.set_options(device="cuda"):
        with pytest.raises(RuntimeError, match=r"set_options\(device='cpu'\)"):
            xp.processing.reordering(ref, sim)
