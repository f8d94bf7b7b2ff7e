"""Typed configuration (copy of han_tpu/train/config.py) with per-dataset
presets reproducing the reference hyperparameters (ex_acm3025.py:16-31).

Differences from han_tpu: no TPU scoped-VMEM budget; the ``dblp`` preset
also answers to ``dblp_synthetic`` (the DBLP-shaped planted dataset,
datasets/registry.py), as ``acm`` does to ``acm_synthetic``; and the mesh
has the graph axis only (one process per device, train/trainer.py).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence


@dataclasses.dataclass
class ModelConfig:
    arch: str = "han"  # han | han_shared | gat
    hid_units: Sequence[int] = (8,)
    n_heads: Sequence[int] = (8, 1)
    semantic_dim: int = 128  # mp_att_size (gat.py:37)
    residual: bool = False
    attn_drop: float = 0.6
    ffd_drop: float = 0.6
    impl: str = "auto"  # dense | csr | flash (bcsr graphs) | ell | ell_fused (sampled) | auto
    vmap_towers: bool = False  # meta-path EP: the towers stacked (nn/models.HAN)
    dtype: str = "float32"  # float32 | bfloat16 (feature compute type, nn/layers.GATConv)


@dataclasses.dataclass
class DataConfig:
    dataset: str = "acm"
    featype: str = "fea"  # 'fea' | 'adj' (ex_acm3025.py:92-93)
    edge_pad_to: int = 128
    # dense | csr | bcsr; on a mesh (or as a 1-shard partition):
    # partitioned_bcsr (= bcsr with graph_axis > 1) | ring_bcsr |
    # partitioned (= csr with graph_axis > 1) | ring
    graph_format: str = "dense"
    tile_bm: int = 0  # BCSR tile height (0 = graph/bcsr.py default)
    tile_bn: int = 0  # BCSR tile width  (0 = default)


@dataclasses.dataclass
class TrainConfig:
    lr: float = 0.005
    l2_coef: float = 0.001
    epochs: int = 200
    patience: int = 100
    seed: int = 42
    checkpoint_dir: str = "checkpoints"  # <checkpoint_dir>/<dataset>[_sampled|_inductive]/<step>.pt
    checkpoint_every: int = 0  # additionally every N epochs (0 = only on best)
    log_file: str = ""  # jsonl metrics log ("" = stdout only)
    sampled: bool = False  # neighbor-sampled mini-batch training (train/sampled.py)
    batch_size: int = 512
    fanout: int = 16
    sampler: str = "host"  # host (C++ sampler) | device


@dataclasses.dataclass
class MeshConfig:
    """Device mesh axes: graph × heads × mp, whose product is the world
    size of the process group (torchrun; one process per device)."""

    graph_axis: int = 1
    head_axis: int = 1
    mp_axis: int = 1


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def preset(name: str) -> Config:
    """Per-dataset presets mirroring the reference constants
    (lr 0.005, L2 1e-3, hid 8, heads [8,1], dropout 0.6, patience 100 —
    ex_acm3025.py:16-31 / han.pdf §5.3)."""
    cfg = Config()
    cfg.data.dataset = name
    if name in ("acm", "acm_synthetic"):
        pass  # defaults are the ACM constants
    elif name in ("dblp", "dblp_synthetic"):
        # APCPA/APTPA are multi-million-edge: block-sparse tiles + the
        # fused flash kernels
        cfg.data.graph_format = "bcsr"
        cfg.model.impl = "flash"
    elif name in ("imdb", "imdb_strict"):
        pass
    elif name == "ppi":
        # batches of 2 graphs, each batch one block-diagonal graph on the
        # sparse path (train/inductive.py, whose format follows impl);
        # auto: flash on PPI's tiles, a BCSR union
        cfg.data.graph_format = "bcsr"
        cfg.model.impl = "auto"
        cfg.train.batch_size = 2
        cfg.model.arch = "gat"
        cfg.model.hid_units = (256, 256)
        cfg.model.n_heads = (4, 4, 6)
        cfg.model.residual = True
        cfg.model.attn_drop = 0.0
        cfg.model.ffd_drop = 0.0
        cfg.train.lr = 0.005
        cfg.train.l2_coef = 0.0
    elif name == "powerlaw":
        cfg.data.graph_format = "csr"
        cfg.model.impl = "csr"
    elif name in ("cora", "citeseer", "pubmed"):
        cfg.model.arch = "gat"
        cfg.train.l2_coef = 0.0005
        if name == "pubmed":  # N=19717: dense N^2 is wasteful
            cfg.data.graph_format = "bcsr"
            cfg.model.impl = "flash"
    else:
        raise KeyError(f"no preset for dataset {name!r}")
    return cfg


def _apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply 'section.key=value' CLI overrides."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        section, _, field = key.partition(".")
        obj = getattr(cfg, section)
        cur = getattr(obj, field)  # raises on unknown field
        if isinstance(cur, bool):
            parsed = val.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            parsed = int(val)
        elif isinstance(cur, float):
            parsed = float(val)
        elif isinstance(cur, (tuple, list)):
            parsed = tuple(int(v) for v in val.split(",") if v)
        else:
            parsed = val
        setattr(obj, field, parsed)
    return cfg


def parse_cli(argv: Sequence[str] | None = None) -> Config:
    p = argparse.ArgumentParser(description="han_tpu_torch trainer")
    p.add_argument("--dataset", default="acm")
    p.add_argument("--set", action="append", default=[], metavar="sec.key=val",
                   help="config override, e.g. --set train.lr=0.01")
    args = p.parse_args(argv)
    cfg = preset(args.dataset)
    return _apply_overrides(cfg, args.set)
