"""Train HAN or GAT with han_tpu_torch on one device (the card unless
``--device cpu``), or on a graph-axis mesh of one process per device — the
PyTorch counterpart of scripts/train.py. ``--dataset`` takes every preset
name (ppi trains inductively; cora, citeseer and pubmed train a GAT).

    python3 scripts/train_torch.py --dataset dblp_synthetic
    python3 scripts/train_torch.py --dataset dblp_synthetic --set train.epochs=10
    python3 scripts/train_torch.py --dataset dblp_synthetic --set model.dtype=bfloat16
    python3 scripts/train_torch.py --dataset acm_synthetic --set data.graph_format=csr --set model.impl=csr
    python3 scripts/train_torch.py --device cpu --dataset acm_synthetic --set train.epochs=2
    python3 scripts/train_torch.py --dataset ppi --set train.epochs=3
    python3 scripts/train_torch.py --dataset pubmed   # Planetoid shards in data_cache/planetoid
    torchrun --nproc-per-node 4 scripts/train_torch.py --dataset dblp_synthetic \
        --set mesh.graph_axis=4 --set data.graph_format=ring_bcsr

``--device`` is ``cuda`` (the default; raises when CUDA is unavailable) or
``cpu`` (under torchrun: a gloo group). Prints per-epoch metrics
(train/val loss and accuracy, mean semantic attention, step time) and the
final test metrics; under torchrun only rank 0 prints.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    from han_tpu_torch.parallel import launch
    from han_tpu_torch.train import trainer
    from han_tpu_torch.train.config import parse_cli

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args, rest = p.parse_known_args(argv)
    cfg = parse_cli(rest)
    launch.init_distributed(args.device)  # no-op unless started by torchrun
    try:
        result = trainer.run(cfg, device=args.device)
    finally:
        coordinator = launch.is_coordinator()
        launch.shutdown()
    if coordinator:
        print({k: v for k, v in result.items() if not k.startswith("epoch_")})
    return result


if __name__ == "__main__":
    main()
