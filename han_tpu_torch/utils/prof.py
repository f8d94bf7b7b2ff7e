"""Tracing, profiling and numerics utilities (counterpart of
han_tpu/utils/prof.py):

- ``trace(dir)`` — ``torch.profiler`` over CPU and CUDA activities around
  the enclosed block, writing a chrome trace;
- ``annotate(name)`` — a named range (``record_function``) that groups
  kernels in the trace;
- ``edges_per_sec`` — the throughput counter (nnz × heads / step time);
- ``checked(fn)`` — raises when an output is not finite;
- ``device_memory_stats`` — per-card memory snapshot;
- ``StepTimer`` — host-clock step timer that ends each step in
  ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str = "traces", name: str = "trace.json"):
    """Profile the enclosed block (CPU and CUDA activities); on exit the
    chrome trace is written to ``log_dir/name`` (open it in Perfetto or
    chrome://tracing). Yields the profiler, for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """Named range for trace readability: ``with annotate('sddmm'): ...``"""
    return torch.profiler.record_function(name)


def edges_per_sec(n_edges: int, n_heads: int, step_time_s: float,
                  n_devices: int = 1) -> float:
    """edges·heads/s per card for an attention aggregate step."""
    return n_edges * n_heads / max(step_time_s, 1e-12) / n_devices


def _all_finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return not out.is_floating_point() or bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return all(_all_finite(o) for o in out)
    if isinstance(out, dict):
        return all(_all_finite(o) for o in out.values())
    return True


def checked(fn: Callable) -> Callable:
    """Wrap fn so that it raises FloatingPointError when any floating
    tensor it returns (nested in tuples, lists or dicts) holds a NaN or an
    Inf. The check reads the outputs back (one device sync a call). Unlike
    han_tpu's checkify wrapper it sees outputs only: no check inside the
    function and no out-of-bounds indexing check."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not _all_finite(out):
            raise FloatingPointError(f"{getattr(fn, '__name__', fn)} returned a non-finite value")
        return out

    return wrapper


def device_memory_stats() -> list[dict]:
    """Per-card memory snapshot from ``torch.cuda.memory_stats`` (bytes in
    use, peak, and the card's total); empty without CUDA."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out


class StepTimer:
    """Host-clock step timer; each step ends in ``torch.cuda.synchronize()``
    so that the time covers the work it enqueued."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)

    @property
    def median(self) -> float:
        s = sorted(self.times)
        return s[len(s) // 2] if s else float("nan")
