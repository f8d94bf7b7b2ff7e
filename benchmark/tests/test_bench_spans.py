"""The span reader and the metrics that read it, on a made-up profile: the
program's ``han.*`` spans, the device work linked to them through the
launching op's parents, and the idle gaps by span."""

import json
import types

import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans, trace
from benchmark.metrics import batch_wait_ms, dispatch_ms, eval_share, save_share

CUDA = DeviceType.CUDA


def _ev(name, start, end, id=0, parent=None, device=DeviceType.CPU, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 id=id, cpu_parent=parent,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _profile(program_spans=True):
    """A 100 µs window as the card's profiler gives it: a train step (a copy
    and a graph launch), an evaluation around its eval step and its
    read-back, a batch's wait and upload; a device event shares its runtime
    call's id, and the ops' ids count apart. 27 µs of device work, 24 of
    it launched inside spans."""
    name = (lambda n: n) if program_spans else (lambda n: n.replace("han.", "other."))
    train = _ev(name("han.train_step"), 10, 30, id=1, annotation=True)
    evaluate = _ev(name("han.evaluate"), 40, 80, id=3, annotation=True)
    eval_step = _ev(name("han.eval_step"), 45, 60, id=4, parent=evaluate, annotation=True)
    batch = _ev(name("han.next_batch"), 85, 91, id=6, annotation=True)
    copy = _ev("aten::copy_", 12, 14, id=2, parent=train)
    item = _ev("aten::item", 62, 70, id=5, parent=evaluate)
    upload = _ev("aten::_to_copy", 86, 88, id=7, parent=batch)
    return [
        _ev(trace.WINDOW_MARK, 0, 100, id=9, annotation=True),
        _ev(trace.WINDOW_MARK, 0, 100, id=9, device=CUDA, annotation=True),
        train, copy, evaluate, eval_step, item, batch, upload,
        _ev("cudaMemcpyAsync", 12.5, 13.5, id=100, parent=copy),
        _ev("cudaGraphLaunch", 15, 16, id=101, parent=train),
        _ev("cudaGraphLaunch", 46, 47, id=102, parent=eval_step),
        _ev("cudaStreamSynchronize", 63, 69, id=103, parent=item),
        _ev("cudaMemcpyAsync", 86.5, 87, id=104, parent=upload),
        # ops and profiler records whose ids equal a runtime call's
        _ev("aten::add", 32, 34, id=101),
        _ev("Activity Buffer Request", 35, 36, id=104),
        _ev(name("han.train_step"), 120, 130, id=8, annotation=True),  # after the window
        # the device: a span's range there is no work
        _ev(name("han.train_step"), 15, 26, id=1, device=CUDA, annotation=True),
        _ev("Memcpy HtoD", 13, 15, id=100, device=CUDA),
        _ev("fwd_kernel", 16, 26, id=101, device=CUDA),
        _ev("eval_kernel", 47, 57, id=102, device=CUDA),
        _ev("copy_kernel", 87, 89, id=104, device=CUDA),
        _ev("orphan_kernel", 92, 95, id=999, device=CUDA),
    ]


def test_spans_linked_device_time_and_idle_by_span():
    rec = spans.read_spans(_profile())
    s = rec["spans"]
    assert set(s) == {"han.train_step", "han.evaluate", "han.eval_step", "han.next_batch"}
    assert s["han.train_step"]["count"] == 1  # the one after the window is out
    assert s["han.train_step"]["host_s"] == pytest.approx(20e-6)
    # the graph's kernel through its launch, the copy through its op
    assert s["han.train_step"]["device_s"] == pytest.approx(12e-6)
    # the innermost span: the eval step's kernel goes to it, not to the evaluation
    assert s["han.eval_step"]["device_s"] == pytest.approx(10e-6)
    assert s["han.evaluate"]["device_s"] == 0.0
    assert s["han.evaluate"]["host_s"] == pytest.approx(40e-6)
    # through the runtime call, not the record that shares its id
    assert s["han.next_batch"]["device_s"] == pytest.approx(2e-6)
    assert rec["device_s"] == pytest.approx(27e-6)
    assert rec["linked_s"] == pytest.approx(24e-6)
    assert rec["window_s"] == pytest.approx(100e-6)
    # gaps 0-13, 26-47, 95-100 under no span; 15-16 in the train step;
    # 57-87 (middle 72) in the evaluation, not in its eval step; 89-92
    # (middle 90.5) in the batch's span
    idle = rec["idle_by_span"]
    assert idle == pytest.approx({"none": 39e-6, "han.evaluate": 30e-6,
                                  "han.next_batch": 3e-6, "han.train_step": 1e-6})
    assert sum(idle.values()) == pytest.approx(100e-6 - 27e-6)
    assert list(idle)[0] == "none"  # largest first


def test_a_profile_without_links_reads():
    # the fields of test_bench_trace's made-up profile: no ids or parents
    old = [types.SimpleNamespace(name=e.name, device_type=e.device_type,
                                 is_user_annotation=e.is_user_annotation,
                                 time_range=e.time_range) for e in _profile()]
    rec = spans.read_spans(old)
    assert rec["linked_s"] == 0.0 and rec["device_s"] == pytest.approx(27e-6)
    assert rec["spans"]["han.train_step"]["host_s"] == pytest.approx(20e-6)
    with pytest.raises(RuntimeError):
        spans.read_spans(old[2:])


def _run(busy=27e-6):
    return {"trace": {"busy_s": busy, "trace_window_s": 100e-6}, "train_steps": 2,
            "window_s": 100e-6}


def test_the_metrics_read_the_traced_window(capsys):
    # the readers find the window among their callers' locals, as in harness.main
    win = harness.Window(1.0, True)
    win.prof = types.SimpleNamespace(events=_profile)
    run = _run()
    assert dispatch_ms.read(run) == pytest.approx((20e-6 + 15e-6) / 2 * 1e3)
    assert eval_share.read(run) == pytest.approx(10 / 27 * 100)
    assert batch_wait_ms.read(run) == pytest.approx(6e-6 / 2 * 1e3)
    assert save_share.read(run) == 0.0  # spans, but no save in the window
    err = capsys.readouterr().err.splitlines()
    # read and printed once a run, on standard error
    assert [line.split()[0] for line in err] == ["spans", "idle_by_span"]
    assert json.loads(err[1][len("idle_by_span "):])["han.evaluate"] == pytest.approx(30e-6)
    assert json.loads(err[0][len("spans "):])["traced_train_steps"] == 2
    assert run["spans"] is not None and win.prof is not None


def test_without_program_spans_or_device_work_the_metrics_find_nothing(capsys):
    win = harness.Window(1.0, True)
    win.prof = types.SimpleNamespace(events=lambda: _profile(program_spans=False))
    run = _run()
    for reader in (dispatch_ms, eval_share, batch_wait_ms, save_share):
        assert reader.read(run) is None
    # the parent program: every idle gap under no span
    err = capsys.readouterr().err.splitlines()
    assert list(json.loads(err[-1][len("idle_by_span "):])) == ["none"]
    idle = _run(busy=0.0)  # no device work: the profile is not read
    assert all(r.read(idle) is None for r in (dispatch_ms, eval_share, save_share))
    assert "spans" not in idle and win.prof is not None


def test_no_traced_window_no_reading():
    assert spans.reading(_run()) is None
