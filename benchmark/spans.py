"""The program's own spans in a traced run: the ``han.*`` ranges that the
program records while the profiler runs (``han_tpu_torch/utils/prof.py:
span``), read from the profile that ``trace.py`` reads, on its clock.

- ``spans``: for each ``han.*`` name, its count, its host seconds clipped
  to the traced window, and the device seconds of the work launched inside
  it. The profiler's own link finds that work: a device event's ``id`` is
  its CUDA correlation id, which the runtime call that launched it
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, a graph's ``cudaGraphLaunch``
  for all of its kernels) shares, and that call's ``cpu_parent`` chain
  leads up to the innermost ``han.*`` span around it.
- ``idle_by_span``: the seconds of the device's idle gaps by the innermost
  ``han.*`` span under each gap's midpoint ("none" where none covers it).
- ``device_s``: all device seconds in the window (kernels, copies, fills,
  clipped to it), and ``linked_s``: those that reached a ``han.*`` span.

The harness hands a metric reader its summary of the profile, not the
profiler: :func:`reading` finds the traced window (``harness.Window``)
among the locals of the frames that called the reader, reads it once a
run, keeps the record in the run's dict under ``spans`` and prints it and
``idle_by_span`` on standard error, before the harness's ``check`` lines.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from benchmark.trace import WINDOW_MARK, merge

PREFIX = "han."
NONE = "none"


def read_spans(events) -> dict:
    """The span record (module docstring) of a finished profile's events;
    RuntimeError when the trace has no window mark. Attributes that a
    made-up profile may lack are read with defaults: no id, no parent."""
    from torch.autograd import DeviceType

    window, host, dev = None, [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(e)
        elif e.name == WINDOW_MARK:
            window = (e.time_range.start, e.time_range.end)
        else:
            host.append(e)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_MARK!r} range")
    lo, hi = window
    spans = [e for e in host if e.name.startswith(PREFIX)
             and e.time_range.end > lo and e.time_range.start < hi]
    # the runtime calls by correlation id; the ops' ids count apart and may
    # equal a call's, so only the runtime API's own names (cuda*, cu*) count
    calls = {e.id: e for e in host if getattr(e, "id", None) is not None
             and e.name.startswith("cu") and "::" not in e.name}
    innermost: dict[int, str] = {}

    def span_of(dev_event) -> str:
        cid = getattr(dev_event, "id", None)
        if cid not in innermost:
            e = calls.get(cid)
            while e is not None and not e.name.startswith(PREFIX):
                e = getattr(e, "cpu_parent", None)
            innermost[cid] = NONE if e is None else e.name
        return innermost[cid]

    out = {n: {"count": 0, "host_s": 0.0, "device_s": 0.0}
           for n in sorted({e.name for e in spans})}
    for e in spans:
        rec = out[e.name]
        rec["count"] += 1
        rec["host_s"] += (min(e.time_range.end, hi) - max(e.time_range.start, lo)) * 1e-6
    clipped, device_s, linked_s = [], 0.0, 0.0
    for e in dev:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t <= s:
            continue
        clipped.append((s, t))
        sec = (t - s) * 1e-6
        device_s += sec
        name = span_of(e)
        if name in out:
            out[name]["device_s"] += sec
            linked_s += sec
    iv = np.array(clipped, dtype=np.float64).reshape(-1, 2)
    return {"window_s": (hi - lo) * 1e-6, "device_s": device_s, "linked_s": linked_s,
            "spans": out, "idle_by_span": idle_by_span(merge(iv), lo, hi, spans)}


def idle_by_span(merged: np.ndarray, lo: float, hi: float, spans: list) -> dict:
    """Idle seconds between the disjoint busy intervals ``merged`` (µs) in
    [lo, hi], by the innermost of ``spans`` under each gap's midpoint."""
    bounds = np.concatenate([[lo], merged.reshape(-1), [hi]]).reshape(-1, 2)
    length = bounds[:, 1] - bounds[:, 0]
    keep = length > 0
    mids, length = bounds[keep].mean(axis=1), length[keep]  # in time order
    names = sorted({e.name for e in spans})
    label = np.full(len(mids), len(names))  # len(names): no span
    # longest first, so that a span nested in another paints over it
    for e in sorted(spans, key=lambda e: e.time_range.start - e.time_range.end):
        a = np.searchsorted(mids, e.time_range.start, side="left")
        b = np.searchsorted(mids, e.time_range.end, side="right")
        label[a:b] = names.index(e.name)
    sums = np.bincount(label, weights=length, minlength=len(names) + 1) * 1e-6
    out = {n: float(s) for n, s in zip([*names, NONE], sums) if s > 0}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _traced_window():
    """The harness's traced window among the callers' locals, or None."""
    from benchmark.harness import Window

    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, Window) and value.prof is not None:
                return value
        frame = frame.f_back
    return None


def reading(run: dict) -> dict | None:
    """The run's span record, read once (module docstring); None where the
    traced window holds no device work, no traced window is found, or the
    program recorded no ``han.*`` span there."""
    tr = run["trace"]
    if not tr or tr["busy_s"] <= 0.0:
        return None
    if "spans" not in run:
        win = _traced_window()
        run["spans"] = rec = None if win is None else read_spans(win.prof.events())
        if rec is not None:
            print("spans " + json.dumps({
                "traced_train_steps": run["train_steps"], "traced_s": run["window_s"],
                "window_s": rec["window_s"], "device_s": rec["device_s"],
                "linked_s": rec["linked_s"], "spans": rec["spans"]}), file=sys.stderr)
            print("idle_by_span " + json.dumps(rec["idle_by_span"]), file=sys.stderr)
    rec = run["spans"]
    return rec if rec is not None and rec["spans"] else None


def host_s(rec: dict, *names: str) -> float:
    """Host seconds of the spans ``names`` in the window."""
    return sum(rec["spans"][n]["host_s"] for n in names if n in rec["spans"])
