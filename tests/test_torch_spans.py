"""The program's spans (``utils/prof.span``): nothing made while no
profiler runs; under a profiler started with ``.start()``, as the benchmark
starts it, the trainers' ``han.*`` spans at their host boundaries, on the
main thread only and never inside a captured body."""

import contextlib
import threading

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from han_tpu_torch.train import sampled as tsampled
from han_tpu_torch.train import trainer as ttrainer
from han_tpu_torch.train.config import preset
from han_tpu_torch.utils import prof


@contextlib.contextmanager
def profiled():
    """A CPU profiler started and stopped by hand (``harness.Window``'s
    way); yields the list that holds its events once it has stopped."""
    p = profile(activities=[ProfilerActivity.CPU])
    p.start()
    events = []
    try:
        yield events
    finally:
        p.stop()
        events.extend(p.events())


def count(events, name):
    return sum(1 for e in events if e.name == name)


def test_span_off_is_one_shared_null_context(monkeypatch):
    class Refused:
        def __init__(self, name):
            raise AssertionError(f"record_function({name!r}) made with the profiler off")

    real = prof.record_function
    monkeypatch.setattr(prof, "record_function", Refused)
    off = prof.span("han.train_step")
    assert off is prof.span("han.save")
    with off, prof.span("han.eval_step"):
        pass
    monkeypatch.setattr(prof, "record_function", real)
    with profiled() as events:
        on = prof.span("han.train_step")
        assert isinstance(on, real)
        with on:
            pass
    assert count(events, "han.train_step") == 1
    assert prof.span("han.train_step") is off  # off again once the profiler stopped


def test_trainer_epochs_record_their_steps(tiny_ds, tmp_path):
    cfg = preset("dblp")
    cfg.data.tile_bm = cfg.data.tile_bn = 128
    cfg.train.checkpoint_dir = str(tmp_path)
    t = ttrainer.Trainer(tiny_ds, cfg, device="cpu", logger=ttrainer.MetricLogger(echo=False))
    with profiled() as events:
        for _ in range(2):  # the benchmark's epoch: a train step, then the validation's loss
            float(t.train_step()[0])
            float(t.eval_step(t.masks["val"])[0])
    assert count(events, "han.train_step") == 2 and count(events, "han.eval_step") == 2
    assert count(events, "han.save") == 0
    cfg.train.epochs = 2
    with profiled() as events:
        t.fit()
    # two epochs and the test evaluation; the first epoch is a best one
    assert count(events, "han.train_step") == 2 and count(events, "han.eval_step") == 3
    assert count(events, "han.save") >= 1


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: the capture runs the body once,
    a replay runs nothing."""

    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


def test_sampled_fit_spans_sit_on_the_main_thread_outside_captures(tiny_ds, tmp_path,
                                                                   monkeypatch):
    """Two epochs of ``fit(sampler="device")`` with its steps captured (a
    stand-in graph on the CPU): a ``han.next_batch`` a train step, closed
    before the step's ``han.train_step`` opens; an ``han.eval_step`` inside
    each ``han.evaluate``; a save on the first, best epoch; and every span
    opened on the main thread while no capture runs."""
    capturing, opened = [], []

    @contextlib.contextmanager
    def capture(graph, capture_error_mode="global"):
        capturing.append(True)
        try:
            yield
        finally:
            capturing.pop()

    real = prof.record_function

    def recorded(name):
        opened.append((name, threading.get_ident(), bool(capturing)))
        return real(name)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(prof, "record_function", recorded)
    cfg = preset("acm")
    cfg.model.impl, cfg.model.hid_units, cfg.model.n_heads = "ell", (8,), (4, 1)
    cfg.train.epochs, cfg.train.patience = 2, 50
    cfg.train.log_file, cfg.train.checkpoint_dir = "", str(tmp_path)
    t = tsampled.SampledTrainer(tiny_ds, cfg, batch_size=8, fanout=3, sampler="device",
                                device="cpu", logger=ttrainer.MetricLogger(echo=False))
    t.capture = True  # the stand-in graph captures on the CPU
    with profiled() as events:
        result = t.fit()
    steps = len(result["step_train_loss"])
    assert steps == 2 * int(np.ceil(tiny_ds.train_mask.sum() / 8))
    assert sum(g.replays for g in t._train_steps.values()) == steps - 1  # the first eager
    assert count(events, "han.train_step") == steps == count(events, "han.next_batch")
    assert count(events, "han.evaluate") == 3  # a validation an epoch, then the test nodes
    assert count(events, "han.save") >= 1
    han = sorted((e for e in events if e.name.startswith("han.")),
                 key=lambda e: e.time_range.start)
    for e in han:
        if e.name == "han.eval_step":
            assert e.cpu_parent is not None and e.cpu_parent.name == "han.evaluate"
        if e.name == "han.next_batch":  # closed before the step it feeds opens
            nxt = next(f for f in han if f.time_range.start >= e.time_range.end)
            assert nxt.name == "han.train_step"
    evaluations = [e for e in han if e.name == "han.evaluate"]
    assert all(any(c.name == "han.eval_step" for c in e.cpu_children) for e in evaluations)
    main = threading.get_ident()
    assert opened and all(tid == main and not cap for _, tid, cap in opened)
    assert len({e.thread for e in han}) == 1
    # no span opens inside another but an evaluation's steps
    assert {e.name for e in han if e.cpu_parent is not None
            and e.cpu_parent.name.startswith("han.")} == {"han.eval_step"}
