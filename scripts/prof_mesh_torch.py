"""Where the time of the dblp preset's train step goes on one CUDA card, one
device against the graph-axis backends: ``bcsr`` (one device, its step
captured as a CUDA graph), ``bcsr`` run eagerly, ``partitioned_bcsr``,
``ring_bcsr`` under deterministic mode (the split backward), then the
captured ``bcsr`` again, all in one NCCL rank of a spawned world (the
partitioned formats as 1-shard partitions, so the collectives run through
NCCL with one rank, eagerly: a mesh step is not captured), on
``dblp_synthetic``.

For each format, ``utils/prof.profile_steps``: the median of ``--steps``
train steps on the host clock (after 3 untimed steps; each step ends in
``float(loss)``), then a ``torch.profiler`` window of 5 steps, read per
step: device time (the self time of every CUDA event: kernels, copies,
fills), kernel and graph launches (``cudaLaunchKernel``,
``cudaGraphLaunch``; a captured step is one graph launch), the collectives
(c10d ops) with their host self time and that of ``record_param_comms``
around them, the ops with the most host self time, and the device events
(kernels, copies, fills) with the most device time. The device share is
device time / median step. The last ``bcsr`` run shows how far the host
clock drifts within one process.

    python3 scripts/prof_mesh_torch.py [--steps 20] [--out chiprun_out/prof_mesh.json]

Prints the card's name and power limit, one JSON line per format, and
writes them all to ``--out``. Needs a CUDA card; exits non-zero without.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# (graph_format, deterministic mode, captured)
RUNS = (("bcsr", False, True), ("bcsr", False, False), ("partitioned_bcsr", False, False),
        ("ring_bcsr", True, False), ("bcsr", False, True))


def measure(fmt: str, deterministic: bool, captured: bool, steps: int) -> dict:
    import torch

    from han_tpu_torch.datasets.registry import dblp_synthetic
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer
    from han_tpu_torch.utils.prof import profile_steps

    cfg = preset("dblp")
    cfg.data.graph_format = fmt
    t = Trainer(dblp_synthetic(seed=0), cfg, logger=MetricLogger(echo=False),
                capture=None if captured else False)
    if t.capture != captured:
        raise RuntimeError(f"{fmt}: capture is {t.capture}, want {captured}")
    torch.use_deterministic_algorithms(deterministic)
    try:
        stats = profile_steps(lambda: t.train_step()[0], steps)
    finally:
        torch.use_deterministic_algorithms(False)
    return {"format": fmt, "deterministic": deterministic, "captured": captured, **stats}


def rank_body(steps: int) -> list[dict]:
    return [measure(fmt, det, captured, steps) for fmt, det, captured in RUNS]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default="chiprun_out/prof_mesh.json")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("prof_mesh_torch: no CUDA device (torch.cuda.is_available() is false)")
    from han_tpu_torch.parallel.launch import spawn
    from han_tpu_torch.utils.prof import card, write_runs

    card_line = card()
    print(card_line, flush=True)
    # deterministic mode makes cuBLAS raise without this workspace setting,
    # which must be in place before the rank initializes CUDA
    results = spawn(rank_body, 1, "nccl", args=(args.steps,),
                    env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})[0]
    write_runs(args.out, card_line, results)


if __name__ == "__main__":
    main()
