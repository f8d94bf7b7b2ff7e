"""Where the time of the GAT presets' train step goes on one CUDA card: the
pubmed preset (GAT, hid 8, heads (8, 1), dropouts 0.6) on the Pubmed-shaped
Planetoid fixture (datasets/planetoid.write_planetoid, written to a
temporary directory) through flash on BCSR graphs and through csr, each
with its step captured as a CUDA graph and run eagerly, and the ppi
preset's inductive step, which runs eagerly (two graphs of ppi_synthetic
at PPI's shape: 24 graphs of up to 3,200 nodes, 50 features, 121 labels;
dense attention).

Each run is read by ``utils/prof.profile_steps``, the reader of
``scripts/prof_mesh_torch.py``: the median of ``--steps`` train steps on
the host clock, then a ``torch.profiler`` window of 5 steps read per step
(device time, kernel and graph launches, the device events with the most
device time, peak memory).

    python3 scripts/prof_gat_torch.py [--steps 20] [--out chiprun_out/prof_gat.json]

Prints the card's name and power limit and one JSON line per run, and
writes them all to ``--out``. Needs a CUDA card; exits non-zero without.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default="chiprun_out/prof_gat.json")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("prof_gat_torch: no CUDA device (torch.cuda.is_available() is false)")
    from han_tpu_torch.datasets.planetoid import write_planetoid
    from han_tpu_torch.datasets.ppi import ppi_synthetic
    from han_tpu_torch.datasets.registry import load_dataset
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.inductive import InductiveTrainer
    from han_tpu_torch.train.trainer import MetricLogger, Trainer
    from han_tpu_torch.utils.prof import card, profile_steps, write_runs

    card_line = card()
    print(card_line, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        write_planetoid(tmp)
        pubmed = load_dataset("pubmed", root=tmp)
    results = []
    for impl, fmt in (("flash", "bcsr"), ("csr", "csr")):
        for captured in (True, False):
            cfg = preset("pubmed")
            cfg.model.impl, cfg.data.graph_format = impl, fmt
            torch.cuda.reset_peak_memory_stats()
            t = Trainer(pubmed, cfg, logger=MetricLogger(echo=False), capture=captured)
            results.append({"run": f"pubmed {impl} {'captured' if captured else 'eager'}",
                            **profile_steps(lambda: t.train_step()[0], args.steps)})
            del t
    ppi = ppi_synthetic(n_graphs=24, nodes_per_graph=3200, n_feats=50, n_labels=121,
                        avg_degree=28, seed=0)
    cfg = preset("ppi")
    torch.cuda.reset_peak_memory_stats()
    t = InductiveTrainer.from_config(ppi, cfg)
    batch = next(t.batches("train"))
    results.append({"run": "ppi", **profile_steps(lambda: t.train_step(*batch), args.steps)})
    write_runs(args.out, card_line, results)


if __name__ == "__main__":
    main()
