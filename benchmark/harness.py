"""One benchmark run: a cell of ``BENCHMARK.json`` set up, timed for a window
and checked against the plain reference, in one process that prints one
JSON line last on its standard output.

Everything a cell needs is found by name, so that a later change adds a
cell, a configuration, a generator, a traffic mix, a metric or a kernel
group as a new file (paths relative to this folder):

- the cell's traffic mix ``traffic/<cell>.json`` names its configuration,
  its loop (``loops/<loop>.py``: ``run``, ``shape`` and ``reference_plan``;
  the loop builds the program's dataset and training object) and the
  loop's parameters;
- the configuration's file (``BENCHMARK.json``'s ``file``) holds the
  program's settings (``program``: sections and keys of the program's
  ``Config``, every one applied, an unknown one refused; the traffic's own
  ``program`` is applied over them), its inputs (``inputs``: a generator
  ``generators/<name>.py`` and its arguments) and its ``family``, which
  names the plain reference (``reference/<family>.py``: ``follow``) and
  the counts (``counts/<family>.py``);
- each metric of the cell is read by ``metrics/<metric>.py`` (``read(run)``,
  None when it finds nothing to read; a name with a dot is a quantity's
  split by cells, read by the reader of its part before the first dot),
  the end-to-end ones with ``--trace 0``, the per-layer ones with
  ``--trace 1``;
- kernel groups are ``kernels/<group>.json``; the limits of the cell's
  compared numbers ``limits/<cell>.json``; the peaks ``peaks.json``.

A run: the inputs and weights from ``--seed``; the cell's loop builds the
program's training object, runs its first steps, then the window of
``--seconds`` (with ``--trace 1`` under ``torch.profiler``, shortened to
the traffic's ``trace_seconds``); the peak memory is read and the program
freed; then the reference follows the program's first steps and
evaluations (the loop's ``reference_plan``) and ``compare.py`` decides
``correct``. The result line carries the compared
numbers and their limits under ``checks``, its last key; they are also the
last lines on standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "han_tpu")


def banned_modules(names) -> list:
    """The banned top-level names among module names ``names``."""
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


class Window:
    """The measured window: its start on the host clock and its length.
    With tracing it has two parts: ``lead`` seconds untraced, then the rest
    under ``torch.profiler`` with its range marked for the reader; the loop
    calls :meth:`tick` after every step's read."""

    def __init__(self, seconds: float, trace: bool, lead: float = 0.0):
        self.seconds, self.trace, self.lead = seconds, trace, lead
        self.t0 = self.t_end = self.t_trace = None
        self.prof = self.mark = None
        self.closed = False

    def __enter__(self):
        found = banned_modules(list(sys.modules))
        if found:  # the set-up loaded them
            raise RuntimeError(f"modules loaded that a run may not load: {found}")
        self.t0 = time.perf_counter()
        if self.trace and self.lead <= 0.0:
            self._begin_trace(self.t0)
        return self

    def _begin_trace(self, t: float) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.mark = torch.profiler.record_function("benchmark.window")
        self.mark.__enter__()
        self.t_trace = t

    def tick(self, t: float) -> bool:
        """After a step read at host time ``t``: starts the traced part when
        its time has come; True when the window is over."""
        if self.trace and self.t_trace is None and t - self.t0 >= self.lead:
            self._begin_trace(t)
        return t - self.t0 >= self.seconds

    def close(self, t: float) -> None:
        """Ends the window at host time ``t`` (the last step's read)."""
        if self.closed:
            return
        self.closed, self.t_end = True, t
        if self.prof is not None:
            self.mark.__exit__(None, None, None)
            self.prof.stop()

    def __exit__(self, *exc):
        if not self.closed:
            self.close(time.perf_counter())
        return False


def merged_settings(config: dict, traffic: dict) -> dict:
    """The program's settings of a cell: the configuration's ``program``
    sections with the traffic's ``program`` applied over them."""
    out = {sec: dict(keys) for sec, keys in config.get("program", {}).items()}
    for sec, keys in traffic.get("program", {}).items():
        out.setdefault(sec, {}).update(keys)
    return out


def apply_settings(cfg, settings: dict):
    """Sets every key of ``settings`` (section → key → value) on the
    program's ``Config`` ``cfg``; ValueError on a section or key that the
    Config does not have. A list becomes a tuple, as the Config holds it."""
    for sec, keys in settings.items():
        obj = getattr(cfg, sec, None)
        if obj is None or not dataclasses.is_dataclass(obj):
            raise ValueError(f"the program's Config has no section {sec!r}")
        names = {f.name for f in dataclasses.fields(obj)}
        for key, value in keys.items():
            if key not in names:
                raise ValueError(f"the program's Config.{sec} has no key {key!r}")
            setattr(obj, key, tuple(value) if isinstance(value, list) else value)
    return cfg


class Context:
    """What a loop needs from the harness: the inputs, the program's
    settings and device, the benchmark's weights, and the window."""

    def __init__(self, *, root, config, traffic, seed, device, capture, seconds, trace):
        self.root, self.config, self.traffic = root, config, traffic
        self.settings = merged_settings(config, traffic)
        self.seed, self.train_seed = seed, seed
        self.device, self.capture = device, capture
        self.seconds, self.trace = seconds, trace
        self.inputs = None
        self.win = None
        self.peak_bytes = 0
        self.block_edges = None
        self.checkpoint_dir = None
        self.marks = {}  # set-up phase → host time at its end

    def mark(self, phase: str) -> None:
        self.marks[phase] = time.perf_counter()

    def program_config(self):
        """The program's ``Config`` with the cell's settings, the run's
        seed, no log file and the run's checkpoint directory."""
        from han_tpu_torch.train.config import Config

        cfg = apply_settings(Config(), self.settings)
        cfg.data.dataset, cfg.train.seed = self.config["name"], self.train_seed
        cfg.train.log_file, cfg.train.checkpoint_dir = "", self.checkpoint_dir
        return cfg

    def load_weights(self, model) -> dict:
        """Copies the benchmark's weights into ``model``'s parameters and
        returns them (name → tensor)."""
        import torch

        from benchmark.weights import make_weights

        named = dict(model.named_parameters())
        w = make_weights({k: tuple(v.shape) for k, v in named.items()}, self.seed + 17,
                         self.device)
        with torch.no_grad():
            for k, v in named.items():
                v.copy_(w[k])
        return w

    @staticmethod
    def adam_grads(opt, model) -> dict:
        """The gradient Adam got at its first step: its first moment over
        1 − β₁, by parameter name (zero where Adam holds no state)."""
        import torch

        beta1 = opt.param_groups[0]["betas"][0]
        return {k: (opt.state[v]["exp_avg"].detach().clone() / (1.0 - beta1)
                    if "exp_avg" in opt.state.get(v, {}) else torch.zeros_like(v.detach()))
                for k, v in model.named_parameters()}

    @staticmethod
    def snapshot(model) -> dict:
        return {k: v.detach().clone() for k, v in model.named_parameters()}

    @staticmethod
    def record(losses, grads, params, evals):
        from benchmark.reference.han import Record

        return Record(list(losses), grads, params, list(evals))

    def window(self) -> Window:
        """The run's window; a traced run's is the traffic's
        ``trace_seconds`` untraced, then as long again traced."""
        if self.trace:
            lead = self.traffic["trace_seconds"]
            self.win = Window(2 * lead, True, lead)
        else:
            self.win = Window(self.seconds, False)
        return self.win

    def read_peak(self) -> None:
        """The window is over: reads the peak device memory."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)


def _load(kind: str, name: str):
    return importlib.import_module(f"benchmark.{kind}.{name}")


def _cell_metrics(spec: dict, cell: str, kind: str) -> list:
    return [m for m in spec[kind] if "workloads" not in m or cell in m["workloads"]]


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(description="one run of a benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--cpu-dry-run", action="store_true",
                   help="for the CPU tests only: run the cell on the CPU through the "
                        "program's plain paths; no device metric is read")
    return p.parse_args(argv)


def load_cell(root: pathlib.Path, name: str) -> dict:
    """The cell's entries and files: ``spec``, ``cell``, ``config``,
    ``traffic`` and ``limits``; KeyError when BENCHMARK.json has no such
    cell, ValueError when its traffic is of another configuration or its
    limits name a number that ``compare.py`` does not know."""
    spec = json.loads((root.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[name]
    conf_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root.parent / conf_entry["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{name}.json").read_text())
    if traffic["config"] != cell["config"]:
        raise ValueError(f"traffic {name} is of {traffic['config']}, the cell of "
                         f"{cell['config']}")
    limits = json.loads((root / "limits" / f"{name}.json").read_text())
    from benchmark.compare import NUMBERS

    if not set(limits) <= set(NUMBERS):
        raise ValueError(f"limits of {name} name numbers that compare.py does not know: "
                         f"{sorted(set(limits) - set(NUMBERS))}")
    return {"spec": spec, "cell": cell, "config": config, "traffic": traffic,
            "limits": limits}


def follow(ctx: Context, loop, reference, params0: dict, **kw):
    """The reference's record of the steps and evaluations that the loop's
    ``reference_plan`` names, from ``params0``; ``kw`` (``products``,
    ``fault``) puts a control or a fault in its place."""
    batches, evals = loop.reference_plan(ctx)
    return reference.follow(ctx.settings, params0, batches, evals=evals,
                            gen_seed=ctx.train_seed + 1, device=ctx.device, **kw)


def make_context(root, c: dict, seed: int, device, *, seconds=0.0, trace=False,
                 checkpoint_dir=None) -> Context:
    """A context with the cell's inputs made from ``seed``."""
    from benchmark import data

    ctx = Context(root=root, config=c["config"], traffic=c["traffic"], seed=seed,
                  device=device, capture=None if device.type == "cuda" else False,
                  seconds=seconds, trace=trace)
    ctx.checkpoint_dir = checkpoint_dir
    ctx.inputs = data.make_inputs(c["config"]["inputs"], seed)
    ctx.mark("inputs")
    return ctx


def main(argv=None, *, t_start: float | None = None, root: pathlib.Path = ROOT) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        c = load_cell(root, args.workload)
    except (KeyError, ValueError) as err:
        print(f"workload {args.workload!r}: {err!r}", file=sys.stderr)
        return 2
    spec, cell, config, traffic, limits = (c[k] for k in ("spec", "cell", "config",
                                                          "traffic", "limits"))

    import torch

    if not args.cpu_dry_run:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s): available "
                  f"{torch.cuda.is_available()}, count "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.empty(0, device=device)  # the context and the allocator, then the peak's start
        torch.cuda.reset_peak_memory_stats(device)
    else:
        device = torch.device("cpu")
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = _cell_metrics(spec, cell["name"], kind)
    readers = {m["name"]: _load("metrics", m["name"].split(".")[0]) for m in metrics}
    loop = _load("loops", traffic["loop"])
    reference = _load("reference", config["family"])
    counts = _load("counts", config["family"])
    peaks = {k: v["value"] for k, v in json.loads((root / "peaks.json").read_text()).items()
             if isinstance(v, dict)}
    from benchmark import compare, trace as trace_mod

    with tempfile.TemporaryDirectory(prefix="bench-ckpt-") as ckpt:
        t_ready = time.perf_counter()
        ctx = make_context(root, c, args.seed, device, seconds=args.seconds,
                           trace=bool(args.trace), checkpoint_dir=ckpt)
        ctx.marks["imports and device"] = t_ready
        res = loop.run(ctx)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = banned_modules(list(sys.modules))
    if found:
        print(f"modules loaded that a run may not load: {found}", file=sys.stderr)
        return 4
    win = ctx.win
    tr = (trace_mod.read_profile(win.prof, trace_mod.load_groups(root))
          if win.trace else None)

    ref = follow(ctx, loop, reference, res["params0"])
    nums = compare.numbers(res["program"], ref, res["params0"])
    correct = compare.verdict(nums, limits) and res["failed"] == 0

    # a traced run's per-layer metrics read the traced part of its window
    t0 = win.t_trace if win.trace else win.t0
    steps = sum(1 for t in res["reads"] if t > t0)
    run = {"setup_s": win.t0 - t_start, "window_s": win.t_end - t0, "t0": t0,
           "reads": [t for t in res["reads"] if t > t0], "train_steps": steps,
           "eval_steps": res["eval_steps"](t0), "peak_bytes": ctx.peak_bytes, "trace": tr,
           "settings": ctx.settings, "shape": loop.shape(ctx), "peaks": peaks,
           "counts": counts}
    out_metrics = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu", "count": cell["chips"], "memory_peak_bytes": ctx.peak_bytes}
    result = {"correct": bool(correct), "attempted": res["train_steps"],
              "failed": res["failed"], "metrics": out_metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr["busy_s"], window_s=tr["trace_window_s"])
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in tr["device_ops"]],
                               "idle_gaps": [[n[:160], s] for n, s in tr["idle_gaps"]]}
    result["checks"] = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    result["checks"]["failed_steps"] = {"value": res["failed"], "limit": 0}

    found = banned_modules(list(sys.modules))
    if found:
        print(f"modules loaded that a run may not load: {found}", file=sys.stderr)
        return 4
    if device.type == "cuda":
        print(f"card: {_card_line()}", file=sys.stderr)
    phases, last = [], t_start
    for phase, t in sorted(ctx.marks.items(), key=lambda kv: kv[1]):
        phases.append(f"{phase} {t - last:.3f} s")
        last = t
    print(f"steps {res['train_steps']} in {win.t_end - win.t0:.4f} s, setup {run['setup_s']:.3f} s "
          f"({', '.join(phases)}, the rest {win.t0 - last:.3f} s), left out of update_gap: "
          f"{compare.still(ref.grads)}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
