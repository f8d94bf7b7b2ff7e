"""A training or evaluation step captured as a CUDA graph and replayed: the
port's counterpart of han_tpu's jitted steps (han_tpu/train/trainer.py
:236-294, one program a full-graph step or evaluation;
han_tpu/train/sampled.py:401-416, ``lax.scan`` over C seed descriptors in
one dispatch; han_tpu/train/sampled.py:297-350, the host-sampled block's
step, compiled once for its static shapes; han_tpu/train/inductive.py
:114-121, the step over a padded graph batch).

:class:`GraphedStep` runs ``body(*inputs)`` eagerly for its first
``warmup`` calls (the first call of a trainer builds the kernels, creates
Adam's state and sets the kernels' shared-memory attributes, and is a real
step, so the trajectory stays the eager one), then captures it once as a
``torch.cuda.CUDAGraph`` and replays the graph on every later call:

- the capture runs on a side stream (``torch.cuda.graph``), in
  ``thread_local`` error mode, so that a trainer's prefetch thread may go
  on pinning host memory while the step is captured;
- the run's device generators are registered with the graph
  (``CUDAGraph.register_generator_state``), so every replay draws new
  dropout masks and new flash seeds (ops/flash_gat.draw_seed) from them and
  advances them as the eager step would;
- inputs are copied into static buffers made at the capture, and the
  outputs are the capture's tensors, rewritten by every replay: read or
  clone them before the next call;
- the kernel wrappers count launches on the host (``COUNTERS``), and a
  replay runs no Python. The capture runs the wrappers once and launches
  nothing: it records what each counter gained, puts the counters back,
  and every replay adds the recorded gains, so the counts stay those of
  the launches that ran.

There is no fallback: a capture or replay that fails raises. With
``capture=False`` (the CPU, or a caller that asks for eager steps) every
call runs the body eagerly.

What captures (``want_capture``): every step of a run on one CUDA device
whose mesh axes hold no process group (``Axis.group is None``): one card,
or a mesh whose every axis has one rank, where each collective is the
identity. That is the full-graph step and evaluation on every format the
mesh runs, the host and device samplers' steps and evaluations (one graph
a block shape), and the inductive step over its padded graph batch. A run
with a process group on an axis runs eagerly: NCCL collectives inside a
captured graph are not ported, and ``capture=True`` raises there.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Iterable, Sequence

import torch

from han_tpu_torch.ops import ell_fused, flash_gat, tree_ell

# the launch counters of the kernels (and the tree attention's call count)
# a step may run: (module, attribute)
COUNTERS = tuple((mod, name) for mod, names in (
    (flash_gat, ("flash_fwd_launches", "flash_fwd_wide_launches", "flash_bwd_launches",
                 "flash_bwd_wide_launches", "flash_bwd_row_launches", "flash_bwd_col_launches")),
    (ell_fused, ("ell_fused_launches",)),
    (tree_ell, ("tree_ell_calls", "tree_ell_bwd_launches"))) for name in names)


def want_capture(capture: bool | None, device: torch.device, axes: Iterable = ()) -> bool:
    """Whether a trainer captures its steps. ``axes``: the mesh axes of the
    run (``parallel/mesh.Axis``; none on one device). None: on for a CUDA
    device when no axis holds a process group, else off. True where an
    axis holds a group raises NotImplementedError, True on the CPU
    ValueError."""
    grouped = any(ax.group is not None for ax in axes)
    if capture is None:
        return device.type == "cuda" and not grouped
    if capture and grouped:
        raise NotImplementedError(
            "capture=True: a mesh axis of this run holds a process group, and NCCL "
            "collectives inside a captured CUDA graph are not ported (the run's steps run "
            "eagerly with capture=None)")
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, got {device} (steps on the "
                         "CPU run eagerly: pass capture=None or False)")
    return bool(capture)


class GraphedStep:
    """``body(*inputs)`` as a CUDA graph on ``device`` after ``warmup``
    eager calls (see the module docstring). ``generators`` are the CUDA
    generators the body draws from. ``replays`` counts graph launches. A
    bound method ``body`` is held weakly: a trainer that holds its own
    steps would otherwise be a reference cycle, and its graph's memory pool
    would outlive it until the garbage collector ran."""

    def __init__(self, body: Callable[..., Any], *, capture: bool, device: torch.device,
                 generators: Sequence[torch.Generator] = (), warmup: int = 1):
        self._body = (weakref.WeakMethod(body) if hasattr(body, "__self__")
                      else lambda: body)
        self.capture = capture
        self.device = device
        self.generators = tuple(generators)
        self.warmup = warmup
        self.calls = 0
        self.replays = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.inputs: list[torch.Tensor] = []
        self.outputs: Any = None
        self.gained: list[int] = []

    def __call__(self, *inputs: torch.Tensor):
        self.calls += 1
        if not self.capture or self.calls <= self.warmup:
            return self._body()(*inputs)
        if self.graph is None:
            with torch.cuda.device(self.device):
                self._capture(inputs)
        else:
            for buf, x in zip(self.inputs, inputs, strict=True):
                if buf.shape != x.shape or buf.dtype != x.dtype:
                    raise ValueError(f"a replay takes the captured input {buf.dtype} "
                                     f"{tuple(buf.shape)}, got {x.dtype} {tuple(x.shape)}")
                buf.copy_(x, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        for (mod, name), n in zip(COUNTERS, self.gained):
            if n:
                setattr(mod, name, getattr(mod, name) + n)
        return self.outputs

    def expect_uncaptured(self, what: str) -> None:
        """Raises RuntimeError once the body is captured: ``what`` (a state
        load that puts new tensors where the graph reads the old ones, such
        as ``Optimizer.load_state_dict``) must come before the capture, or
        the replays would go on reading the stale buffers."""
        if self.graph is not None:
            raise RuntimeError(f"{what} after the step was captured: its replays would "
                               "read the old buffers (load the state before the first step)")

    def _capture(self, inputs) -> None:
        self.inputs = [x.detach().to(self.device, copy=True) for x in inputs]
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = [getattr(mod, name) for mod, name in COUNTERS]
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.outputs = self._body()(*self.inputs)
        finally:
            after = [getattr(mod, name) for mod, name in COUNTERS]
            for (mod, name), n in zip(COUNTERS, before):
                setattr(mod, name, n)
        self.gained = [a - b for a, b in zip(after, before)]
        self.graph = graph
