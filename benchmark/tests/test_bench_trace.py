"""The trace reader: the union of device intervals, the idle gaps and their
labels, kernel groups and launches, on a made-up profile."""

import pathlib
import types

import numpy as np
import pytest
from torch.autograd import DeviceType

from benchmark import trace

BENCH = pathlib.Path(__file__).resolve().parents[1]


def test_union_of_intervals():
    iv = np.array([[0, 10], [5, 12], [20, 30], [30, 31], [40, 41], [1, 2]], float)
    assert trace.union_seconds(iv) == pytest.approx((12 + 11 + 1) * 1e-6)
    np.testing.assert_array_equal(trace.merge(iv), [[0, 12], [20, 31], [40, 41]])
    assert trace.union_seconds(np.zeros((0, 2))) == 0.0


def _ev(name, start, end, device=DeviceType.CPU, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_read_profile():
    cuda = DeviceType.CUDA
    events = [
        _ev(trace.WINDOW_MARK, 0, 100),
        _ev(trace.WINDOW_MARK, 0, 100, cuda, True),  # the range on the device: not work
        _ev("void (anonymous namespace)::fwd_kernel<8, float, true>(int)", 10, 20, cuda),
        _ev("void (anonymous namespace)::ell_fused_fwd_kernel<float>(int)", 15, 25, cuda),
        _ev("Memset (Device)", 60, 70, cuda),
        _ev("cudaGraphLaunch", 5, 6), _ev("cudaLaunchKernel", 55, 56),
        _ev("cudaStreamSynchronize", 26, 59), _ev("aten::item", 25, 60),
        _ev("cudaLaunchKernel", 200, 201),  # outside the window
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    rec = trace.read_profile(prof, trace.load_groups(BENCH))
    assert rec["busy_s"] == pytest.approx(25e-6)
    assert rec["trace_window_s"] == pytest.approx(100e-6)
    assert rec["launches"] == 2
    assert rec["group_s"]["flash"] == pytest.approx(10e-6)
    assert set(rec["group_s"]) == {"flash"}  # the ELL kernel is in no group
    gaps = dict(rec["idle_gaps"])
    # each gap goes to the innermost host call under its middle: 25-60 to
    # the synchronize inside aten::item, 0-10 to the graph launch at 5,
    # 70-100 to none
    assert gaps["cudaStreamSynchronize"] == pytest.approx(35e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["python"] == pytest.approx(30e-6)
    assert rec["device_ops"][0][1] == pytest.approx(10e-6)


def test_a_profile_without_the_window_mark_raises():
    prof = types.SimpleNamespace(events=lambda: [_ev("cudaLaunchKernel", 1, 2)])
    with pytest.raises(RuntimeError):
        trace.read_profile(prof, {})
