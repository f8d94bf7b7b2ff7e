"""Dataset registry: name → loader (port of han_tpu/datasets/registry.py).

Answers ``acm``/``acm3025`` (the ``.mat`` file when present, else the
ACM3025-shaped fixture, as han_tpu does), ``acm_synthetic``,
``dblp_synthetic`` (the port's DBLP-shaped fixture) and ``powerlaw``. The
other names that han_tpu answers, and that ``train/config.py:preset``
accepts, need loaders that are not ported yet and raise
NotImplementedError naming them.
"""

from __future__ import annotations

import dataclasses

from han_tpu_torch.datasets.acm import acm_synthetic, load_acm3025
from han_tpu_torch.graph.synthetic import HeteroDataset, planted_hetero, powerlaw_hetero

__all__ = ["acm_synthetic", "dblp_synthetic", "load_dataset"]

# name → the han_tpu loader it needs
_NOT_PORTED = {
    "dblp": "han_tpu/datasets/dblp.py:load_dblp",
    "imdb": "han_tpu/datasets/imdb.py:load_imdb",
    "imdb_strict": "han_tpu/datasets/imdb.py:load_imdb",
    "ppi": "han_tpu/datasets/ppi.py:load_ppi and ppi_synthetic",
    "cora": "han_tpu/datasets/planetoid.py:load_planetoid",
    "citeseer": "han_tpu/datasets/planetoid.py:load_planetoid",
    "pubmed": "han_tpu/datasets/planetoid.py:load_planetoid",
}


def dblp_synthetic(seed: int = 0) -> HeteroDataset:
    """DBLP-shaped planted fixture: 4057 authors, 334 features, 4 classes,
    3 meta-paths, 800/400/2857 split (han.pdf Table 2), and an average
    degree that gives 1.6-2.3 M edges per meta-path with self-loops
    (6.1 M in all at seed 0), the scale of DBLP's APA/APCPA/APTPA."""
    ds = planted_hetero(
        n_nodes=4057, n_feats=334, n_classes=4, n_metapaths=3,
        avg_degree=1232, train_per_class=200, n_val=400, seed=seed,
        name="dblp_synthetic")
    return dataclasses.replace(ds, metapath_names=("APA", "APCPA", "APTPA"))


def load_dataset(name: str, **kwargs) -> HeteroDataset:
    if name in ("acm", "acm3025"):
        return load_acm3025(**kwargs)
    if name == "acm_synthetic":
        return acm_synthetic(**kwargs)
    if name == "dblp_synthetic":
        return dblp_synthetic(**kwargs)
    if name == "powerlaw":
        return powerlaw_hetero(**kwargs)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} needs {_NOT_PORTED[name]}, which is not ported yet "
            "(ROADMAP.md queue 1); the port loads acm, acm3025, acm_synthetic, "
            "dblp_synthetic and powerlaw")
    raise KeyError(f"unknown dataset {name!r}; known: acm, acm3025, acm_synthetic, "
                   f"dblp_synthetic, powerlaw, and not ported yet: {sorted(_NOT_PORTED)}")
