"""Scale benchmark of han_tpu_torch on one CUDA card: sampled HAN training on
a graph too big for dense forms (the PyTorch counterpart of
scripts/bench_scale.py).

BASELINE.json's scaling configuration — a synthetic 100M-edge
heterogeneous graph with meta-path neighbor sampling — end to end: the CSR
meta-path graphs are generated directly (graph/synthetic.big_csr), and
training runs over seed-node batches with L-hop bounded-fanout sampled
blocks (train/sampled.py) and the one-ahead host prefetch.

    python3 scripts/bench_scale_torch.py                           # 10M edges
    python3 scripts/bench_scale_torch.py --nodes 500000 --avg-degree 100
    python3 scripts/bench_scale_torch.py --nodes 500000 --avg-degree 100 --sampler device
    python3 scripts/bench_scale_torch.py --nodes 500000 --avg-degree 100 --sampler device \
        --steps-per-call 4

With the device sampler each dispatch is a captured CUDA graph, of
``--steps-per-call`` steps (the epoch's tail as single steps), as
scripts/bench_scale.py's ``--steps-per-call`` scans C steps per jit call.
Prints one JSON line: sampled edges·heads per second of train step
(forward + backward), the step time, and the host-block / device split
(train/sampled.step_breakdown). Needs a CUDA card; exits non-zero without.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

WARMUP = 3  # untimed dispatches before the timed loop


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=500_000)
    p.add_argument("--avg-degree", type=int, default=20)
    p.add_argument("--metapaths", type=int, default=2)
    p.add_argument("--feats", type=int, default=64)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--fanout", type=int, default=16)
    p.add_argument("--steps", type=int, default=30,
                   help="train batches in the epoch (the first WARMUP dispatches are untimed)")
    p.add_argument("--impl", default="ell_fused", choices=["ell", "ell_fused"])
    p.add_argument("--sampler", default="host", choices=["host", "device"])
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="device sampler: C steps per dispatch (one captured graph)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_scale_torch: no CUDA device (torch.cuda.is_available() is false)")
    from han_tpu_torch import native
    from han_tpu_torch.graph.synthetic import scale_dataset
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.sampled import SampledTrainer, step_breakdown

    dev = torch.device("cuda", 0)
    n = args.nodes
    t0 = time.perf_counter()
    ds = scale_dataset(n, args.avg_degree, n_metapaths=args.metapaths,
                       n_feats=args.feats, n_classes=args.classes,
                       n_train=args.batch_size * args.steps,
                       n_val=args.batch_size, seed=args.seed)
    total_edges = sum(int(a.nnz) for a in ds.metapath_adjs)
    print(f"# graph: {n} nodes, {total_edges} edges, built in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)

    cfg = preset("acm")
    cfg.model.impl = args.impl
    cfg.train.log_file = ""
    trainer = SampledTrainer(ds, cfg, batch_size=args.batch_size,
                             fanout=args.fanout, eval_batches=1,
                             sampler=args.sampler, steps_per_call=args.steps_per_call,
                             device=dev)
    train_idx = np.where(ds.train_mask)[0]

    # timed loop: one epoch over --steps batches with prefetch, as fit();
    # the first WARMUP dispatches warm up (kernel build and load, the
    # caching and pinned-memory allocators, cuBLAS, the eager first
    # dispatch and the capture)
    batches = trainer._prefetched_indexed(
        enumerate(trainer._seed_batches(train_idx, shuffle=True, epoch=0)),
        lambda bi: bi)
    if trainer.steps_per_call > 1:
        batches = trainer._chunked(batches)
    for _ in range(WARMUP):
        _, batch = next(batches)
        final_loss = float(trainer._train_call(batch)[0][-1])
    if trainer.steps_per_call > 1:
        # capture the one-step dispatch too (the chunker's tail uses it),
        # as scripts/bench_scale.py warms its per-step program
        seeds = np.asarray(train_idx[:args.batch_size], np.int32)
        trainer._train_call(trainer._make_batch(seeds, np.ones(seeds.shape[0], bool), 999))
    edges0 = trainer.flush_sampled_edges()
    torch.cuda.reset_peak_memory_stats(dev)
    step_times = []
    t_loop0 = time.perf_counter()
    t_step = t_loop0
    for _, batch in batches:
        losses, _ = trainer._train_call(batch)
        final_loss = float(losses[-1])  # waits for the dispatch, as fit() does
        now = time.perf_counter()
        step_times.extend([(now - t_step) / len(losses)] * len(losses))
        t_step = now
    t_total = time.perf_counter() - t_loop0
    edges_per_step = (trainer.flush_sampled_edges() - edges0) / len(step_times)
    peak = torch.cuda.max_memory_allocated(dev)
    split = step_breakdown(trainer, train_idx)

    heads = cfg.model.n_heads[0]
    step_ms = t_total / len(step_times) * 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    result = {
        "metric": (f"sampled-edges·heads/s (train fwd+bwd, impl={args.impl}, "
                   f"sampler={args.sampler}, steps_per_call={args.steps_per_call}, "
                   f"N={n}, E={total_edges}, B={args.batch_size}, f={args.fanout})"),
        "value": edges_per_step * heads / (t_total / len(step_times)),
        "unit": "edges·heads/s",
        "detail": {
            "steps": len(step_times), "step_time_ms": step_ms,
            "step_time_ms_median": statistics.median(step_times) * 1e3,
            "host_block_ms_median": split["host_block_ms"],
            "device_ms": split["device_ms"],
            "device_fraction_of_step": (split["device_ms"] / step_ms
                                        if split["device_ms"] else None),
            "kernel_launches_per_step": split["kernel_launches"],
            "graph_launches_per_step": split["graph_launches"],
            "captured": trainer.capture,
            "graph_edges": total_edges,
            "sampled_edges_per_step": edges_per_step,
            "final_loss": final_loss,
            "max_memory_allocated": peak,
            "native_sampler": native.available(),
            "device": torch.cuda.get_device_name(dev),
            "card": card[0] if card else None,
        },
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
