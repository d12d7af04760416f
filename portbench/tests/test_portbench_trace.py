"""The trace reader on a synthetic Chrome trace: busy and idle time, the
idle gaps' host events, the layers of each kernel by the Python frames
around its launch, and the kernels the port counted that the trace lacks."""

import pytest

from portbench import spec, trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def _events():
    return [
        _x("user_annotation", trace.BLOCK, 0, 100),
        _x("user_annotation", trace.BLOCK, 100, 100),
        _x("python_function", "xsdba_tpu_torch/models/eqm.py(200): _adjust", 0, 190),
        _x("python_function", "xsdba_tpu_torch/ops/quantile.py(300): _windowed_group_quantile_core", 5, 60),
        _x("python_function", "xsdba_tpu_torch/ops/merge.py(242): sort_rows_alternating", 10, 5),
        _x("python_function", "xsdba_tpu_torch/ops/segment.py(60): grouped_rank", 70, 20),
        _x("python_function", "xsdba_tpu_torch/ops/segment.py(30): gather_groups", 72, 4),
        _x("python_function", "xsdba_tpu_torch/ops/interp.py(433): interp_grouped_partitioned", 120, 30),
        _x("cpu_op", "aten::copy_", 150, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 73, 1, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 121, 1, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 195, 1, correlation=5),
        _x("kernel", "sort_rows_warp_kernel<float, 8>", 20, 30, tid=7, correlation=1),
        _x("kernel", "at::native::index_elementwise_kernel", 50, 10, tid=7, correlation=2),
        _x("kernel", "at::native::index_elementwise_kernel", 80, 10, tid=7, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD", 85, 10, tid=7, correlation=4),
        _x("kernel", "interp_rows_kernel<8, false>", 130, 20, tid=7, correlation=4),
        _x("kernel", "fma_rows_kernel<float>", 196, 2, tid=7, correlation=99),
    ]


def test_window():
    w = trace.window(_events())
    assert w["blocks"] == 2 and w["window_s"] == pytest.approx(200e-6) and w["kernels"] == 5
    # busy: 20-60, 80-95, 130-150, 196-198
    assert w["busy_s"] == pytest.approx(77e-6)
    gaps = dict(w["idle_gaps"])
    # the gap 150-196 falls in the copy, inside the adjust frame
    assert gaps["xsdba_tpu_torch/models/eqm.py(200): _adjust > aten::copy_"] == pytest.approx(46e-6)
    assert dict(w["device_ops"])["sort_rows_warp_kernel<float, 8>"] == pytest.approx(30e-6)


def test_layer_times():
    got = trace.layer_times(_events(), spec.layers())
    assert got["merge"] == pytest.approx(30e-6)
    assert got["quantile"] == pytest.approx(40e-6)       # the merge kernel and the gather inside quantile.py
    assert got["rank"] == pytest.approx(10e-6)           # gather_groups under grouped_rank
    assert got["lookup"] == pytest.approx(30e-6)         # the copy and the kernel launched in interp.py
    assert got["unattributed"] == pytest.approx(2e-6)    # no launch record
    assert got["total"] == pytest.approx(82e-6) and "other" not in got


def test_missing_kernels():
    counters = [{"module": "m", "attr": "a", "kernels": "sort_rows_(warp|alt)_kernel"},
                {"module": "m", "attr": "b", "kernels": "fold_windows_kernel"}]
    assert trace.missing_kernels(counters, [0, 0], [1, 0], _events()) == []
    lost = trace.missing_kernels(counters, [0, 0], [2, 1], _events())
    assert lost == ["sort_rows_(warp|alt)_kernel: 2 launches counted, 1 kernels traced",
                    "fold_windows_kernel: 1 launches counted, 0 kernels traced"]


def test_lost_kernel_records():
    """A launch recorded on the host whose kernel the trace lacks."""
    ev = _events() + [_x("cuda_runtime", "cudaLaunchKernel", 96, 1, correlation=6),
                      _x("cuda_driver", "cuLaunchKernel", 97, 1, correlation=7)]
    assert trace.missing_kernels([], [], [], ev) == ["7 kernel launches recorded on the host, 5 kernels traced"]


def test_containing():
    ev = [_x("c", "a", 0, 10), _x("c", "b", 2, 3), _x("c", "d", 20, 5)]
    got = trace.containing(ev, [3, 1, 22, 15])
    assert [sorted(e["name"] for e in g) for g in got] == [["a", "b"], ["a"], ["d"], []]
