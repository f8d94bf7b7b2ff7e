"""The traced run's reading of ``torch.profiler``: device busy time as the
union of device intervals, launches, device time by kernel group, and the
breakdown (the device operations that took most time and the longest idle
gaps by what the host was doing).

Device work is every CUDA event that is not a user annotation: a
``record_function`` range shows on the device too, spanning the kernels
launched inside it, and counting it would count them twice (the filter of
``han_tpu_torch/utils/prof.py:device_events``, copied).
"""

from __future__ import annotations

import json
import pathlib
import re

import numpy as np

WINDOW_MARK = "benchmark.window"
# host calls that start work on the device: kernel launches and graph launches
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def load_groups(root: pathlib.Path) -> dict:
    """group name → (layer, compiled patterns), one ``kernels/<group>.json``
    a group."""
    groups = {}
    for path in sorted((root / "kernels").glob("*.json")):
        spec = json.loads(path.read_text())
        groups[path.stem] = (spec["layer"], [re.compile(p) for p in spec["patterns"]])
    return groups


def union_seconds(intervals: np.ndarray) -> float:
    """Seconds covered by the union of (start, end) intervals in µs."""
    merged = merge(intervals)
    return float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6 if merged.size else 0.0


def merge(intervals: np.ndarray) -> np.ndarray:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    if len(intervals) == 0:
        return np.zeros((0, 2))
    iv = np.asarray(intervals, dtype=np.float64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new merged interval starts where an interval begins after every
    # earlier one has ended
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.append(last[1:] - 1, len(iv) - 1)]
    return np.stack([starts, stops], axis=1)


def read_profile(prof, groups: dict, top: int = 10, gap_sample: int = 1000) -> dict:
    """The record of one traced window from a finished profiler."""
    from torch.autograd import DeviceType

    dev, host, window = [], [], None
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name == WINDOW_MARK:
            window = (e.time_range.start, e.time_range.end)
        else:
            host.append((e.name, e.time_range.start, e.time_range.end))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_MARK!r} range")
    lo, hi = window
    dev = [(n, max(s, lo), min(t, hi)) for n, s, t in dev if t > lo and s < hi]
    iv = np.array([(s, t) for _, s, t in dev], dtype=np.float64).reshape(-1, 2)
    busy = union_seconds(iv)
    by_name: dict[str, float] = {}
    for n, s, t in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
    group_s = {g: sum(sec for n, sec in by_name.items() if any(p.search(n) for p in pats))
               for g, (_, pats) in groups.items()}
    launches = sum(1 for n, s, _ in host if n in LAUNCH_CALLS and lo <= s <= hi)
    return {"busy_s": busy, "trace_window_s": (hi - lo) * 1e-6, "group_s": group_s,
            "launches": launches,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": _idle_gaps(merge(iv), lo, hi, host, top, gap_sample)}


def _idle_gaps(merged: np.ndarray, lo: float, hi: float, host: list, top: int,
               sample: int) -> list:
    """The idle time of the ``sample`` longest gaps between device work,
    summed by the innermost host call under each gap's midpoint
    ("python" where none was recorded), the ``top`` largest sums."""
    bounds = np.concatenate([[lo], merged.reshape(-1), [hi]]).reshape(-1, 2)
    length = bounds[:, 1] - bounds[:, 0]
    order = np.argsort(-length)[:sample]
    names = [n for n, _, _ in host]
    starts = np.array([s for _, s, _ in host], dtype=np.float64)
    ends = np.array([t for _, _, t in host], dtype=np.float64)
    sums: dict[str, float] = {}
    for i in order:
        if length[i] <= 0:
            continue
        mid = 0.5 * (bounds[i, 0] + bounds[i, 1])
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        label = ("python" if inside.size == 0
                 else names[inside[np.argmin(ends[inside] - starts[inside])]])
        sums[label] = sums.get(label, 0.0) + length[i] * 1e-6
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]
