"""Where the time of the dblp preset's train step goes on one CUDA card, one
device against the graph-axis backends: ``bcsr`` (one device),
``partitioned_bcsr``, ``ring_bcsr`` under deterministic mode (the split
backward), then ``bcsr`` again, all in one NCCL rank of a spawned world
(the partitioned formats as 1-shard partitions, so the collectives run
through NCCL with one rank), on ``dblp_synthetic``.

For each format: the median of ``--steps`` train steps on the host clock
(after 3 untimed steps; each step ends in ``float(loss)``), then a
``torch.profiler`` window of 5 steps, read per step: device time (the self
time of every CUDA event: kernels, copies, fills), kernel launches
(``cudaLaunchKernel`` calls), the collectives (c10d ops) with their host
self time and that of ``record_param_comms`` around them, the ops with the
most host self time, and the device events (kernels, copies, fills) with
the most device time. The device share is device time / median step.
The last ``bcsr`` run shows how far the host clock drifts within one
process.

    python3 scripts/prof_mesh_torch.py [--steps 20] [--out chiprun_out/prof_mesh.json]

Prints the card's name and power limit, one JSON line per format, and
writes them all to ``--out``. Needs a CUDA card; exits non-zero without.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

WARMUP = 3
PROFILED = 5
RUNS = (("bcsr", False), ("partitioned_bcsr", False), ("ring_bcsr", True), ("bcsr", False))


def measure(fmt: str, deterministic: bool, steps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from han_tpu_torch.datasets.registry import dblp_synthetic
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer

    cfg = preset("dblp")
    cfg.data.graph_format = fmt
    t = Trainer(dblp_synthetic(seed=0), cfg, logger=MetricLogger(echo=False))
    torch.use_deterministic_algorithms(deterministic)
    try:
        for _ in range(WARMUP):
            float(t.train_step()[0])
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            float(t.train_step()[0])
            times.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                float(t.train_step()[0])
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    events = prof.key_averages()
    per_step = lambda us: us / PROFILED / 1e3  # profiler µs over the window → ms a step
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = per_step(sum(e.self_device_time_total for e in cuda))
    c10d = [e for e in cpu if e.key.startswith("c10d::")]
    comms = [e for e in cpu if e.key == "record_param_comms"]
    launches = sum(e.count for e in cpu if e.key == "cudaLaunchKernel")
    median_ms = statistics.median(times) * 1e3
    return {
        "format": fmt, "deterministic": deterministic, "steps": steps,
        "median_step_ms": median_ms, "min_step_ms": min(times) * 1e3,
        "device_ms": device_ms, "device_share": device_ms / median_ms,
        "kernel_launches": launches / PROFILED,
        "collectives": {e.key: e.count / PROFILED for e in c10d},
        "collective_host_ms": per_step(sum(e.self_cpu_time_total for e in c10d)),
        "record_param_comms_host_ms": per_step(sum(e.self_cpu_time_total for e in comms)),
        "fills": sum(e.count for e in cpu if e.key == "aten::fill_") / PROFILED,
        "top_host_ops": [(e.key[:48], per_step(e.self_cpu_time_total), e.count / PROFILED)
                         for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:12]],
        "top_device_ops": [(e.key[:64], per_step(e.self_device_time_total), e.count / PROFILED)
                           for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:12]],
    }


def rank_body(steps: int) -> list[dict]:
    return [measure(fmt, det, steps) for fmt, det in RUNS]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default="chiprun_out/prof_mesh.json")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("prof_mesh_torch: no CUDA device (torch.cuda.is_available() is false)")
    from han_tpu_torch.parallel.launch import spawn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    # deterministic mode makes cuBLAS raise without this workspace setting,
    # which must be in place before the rank initializes CUDA
    results = spawn(rank_body, 1, "nccl", args=(args.steps,),
                    env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})[0]
    for r in results:
        print(json.dumps(r), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "runs": results}, indent=1))


if __name__ == "__main__":
    main()
