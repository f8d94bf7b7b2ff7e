"""Train HAN with han_tpu_torch on one device (CUDA when available) — the
PyTorch counterpart of scripts/train.py.

    python3 scripts/train_torch.py --dataset dblp_synthetic
    python3 scripts/train_torch.py --dataset dblp_synthetic --set train.epochs=10
    python3 scripts/train_torch.py --dataset acm_synthetic --set data.graph_format=csr --set model.impl=csr

Prints per-epoch metrics (train/val loss and accuracy, mean semantic
attention, step time) and the final test metrics.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    from han_tpu_torch.train import trainer
    from han_tpu_torch.train.config import parse_cli

    result = trainer.run(parse_cli(argv))
    print({k: v for k, v in result.items() if not k.startswith("epoch_")})
    return result


if __name__ == "__main__":
    main()
