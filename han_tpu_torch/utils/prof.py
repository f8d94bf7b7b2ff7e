"""Tracing, profiling and numerics utilities (counterpart of
han_tpu/utils/prof.py):

- ``trace(dir)`` — ``torch.profiler`` over CPU and CUDA activities around
  the enclosed block, writing a chrome trace;
- ``span(name)`` — the program's named host range (``record_function``)
  while the profiler runs, a shared null context otherwise;
- ``edges_per_sec`` — the throughput counter (nnz × heads / step time);
- ``checked(fn)`` — raises when an output is not finite;
- ``device_memory_stats`` — per-card memory snapshot;
- ``StepTimer`` — host-clock step timer that ends each step in
  ``torch.cuda.synchronize()``;
- ``profile_steps(step, steps)`` — the profile reader of the
  ``scripts/prof_*_torch.py`` scripts: host-clock step times, then a
  profiler window read per step;
- ``device_events(events)`` — the device work among a profile's events
  (what every device time here sums);
- ``card()`` and ``write_runs`` — the card's name and power limit, and the
  scripts' report.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import pathlib
import statistics
import subprocess
import time
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function


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


# what span returns while no profiler runs: one shared context that does
# nothing (a nullcontext may be entered any number of times)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program's host work, ``with span("han.save"):
    ...``. While the autograd profiler runs (``torch.profiler.profile``
    started, by ``with`` or ``.start()``), a ``record_function``: the range
    lands in the profiler's trace on its clock, above the kernels launched
    inside it. Otherwise the one shared null context: a flag read and a
    call, no object made.

    The program's spans are named ``han.*`` and sit at host boundaries of
    the main thread only: never inside a captured body (a replay runs no
    Python, so the range would mark the capture alone), never on the
    prefetch thread, and never open across a ``yield`` or a preemption
    guard's poll (a caller may start or stop the profiler there)."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


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


def device_events(events) -> list:
    """The CUDA events of ``prof.key_averages()`` that are device work:
    kernels, copies, fills. A ``record_function`` range (such as
    ``Optimizer.step#Adam.step``) shows on the device too, spanning the
    kernels launched inside it, and summing it would count them twice."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_steps(step: Callable, steps: int, warmup: int = 3, window: int = 5) -> dict:
    """Where the time of ``step()`` goes on the card. ``step()`` runs one
    train step and returns its loss as a device tensor; each call ends in
    ``float(loss)``. After ``warmup`` untimed steps (a trainer that
    captures its step runs the first eagerly and captures it on the
    second, so the timed steps are replays): the median of ``steps`` steps
    on the host clock, then a ``torch.profiler`` window of ``window``
    steps, read per step: device time (the self time of every CUDA event
    of :func:`device_events`: kernels, copies, fills, those of replayed
    graphs included), kernel
    launches (``cudaLaunchKernel`` calls), graph launches
    (``cudaGraphLaunch``), ``launches`` (the two together),
    the collectives (c10d ops) with their host self time and that of
    ``record_param_comms`` around them, the ops with the most host self
    time and the device events with the most device time. The device
    share is device time / median step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        float(step())
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        float(step())
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(window):
            float(step())
        torch.cuda.synchronize()
    events = prof.key_averages()
    per_step = lambda us: us / window / 1e3  # profiler µs over the window → ms a step
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    cuda = device_events(events)
    device_ms = per_step(sum(e.self_device_time_total for e in cuda))
    c10d = [e for e in cpu if e.key.startswith("c10d::")]
    comms = [e for e in cpu if e.key == "record_param_comms"]
    median_ms = statistics.median(times) * 1e3
    kernels, graphs = (sum(e.count for e in cpu if e.key == key) / window
                       for key in ("cudaLaunchKernel", "cudaGraphLaunch"))
    return {
        "steps": steps, "median_step_ms": median_ms, "min_step_ms": min(times) * 1e3,
        "device_ms": device_ms, "device_share": device_ms / median_ms,
        "kernel_launches": kernels,
        "graph_launches": graphs,
        "launches": kernels + graphs,
        "collectives": {e.key: e.count / window for e in c10d},
        "collective_host_ms": per_step(sum(e.self_cpu_time_total for e in c10d)),
        "record_param_comms_host_ms": per_step(sum(e.self_cpu_time_total for e in comms)),
        "fills": sum(e.count for e in cpu if e.key == "aten::fill_") / window,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "top_host_ops": [(e.key[:48], per_step(e.self_cpu_time_total), e.count / window)
                         for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:12]],
        "top_device_ops": [(e.key[:64], per_step(e.self_device_time_total), e.count / window)
                           for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:12]],
    }


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def write_runs(out: str, card_line: str, runs: list[dict]) -> None:
    """Print one JSON line per run and write them all, with the card, to
    ``out`` (its directory made as needed)."""
    for r in runs:
        print(json.dumps(r), flush=True)
    path = pathlib.Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"card": card_line, "runs": runs}, indent=1))
