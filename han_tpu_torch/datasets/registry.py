"""Dataset registry: name → loader (port of han_tpu/datasets/registry.py).

Answers every name han_tpu answers, with the same fallbacks and defaults:
``acm``/``acm3025`` (the ``.mat`` file when present, else the
ACM3025-shaped fixture), ``acm_synthetic``, ``dblp`` (the raw files; no
fallback), ``imdb`` (``subset="all"``) and ``imdb_strict``, ``powerlaw``,
``ppi`` (GraphSAGE files under ``root``, default ``data_cache/ppi``, else
``ppi_synthetic``; a MultiGraphDataset, which ``train/trainer.run`` routes
to the inductive trainer) and ``cora``/``citeseer``/``pubmed`` (Planetoid
shards, default root ``data_cache/planetoid``). The port adds
``dblp_synthetic``, its DBLP-shaped fixture.
"""

from __future__ import annotations

import dataclasses
import pathlib

from han_tpu_torch.datasets.acm import acm_synthetic, load_acm3025
from han_tpu_torch.datasets.ppi import MultiGraphDataset
from han_tpu_torch.graph.synthetic import HeteroDataset, planted_hetero, powerlaw_hetero

__all__ = ["acm_synthetic", "dblp_synthetic", "load_dataset"]


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


def load_dataset(name: str, **kwargs) -> HeteroDataset | MultiGraphDataset:
    if name in ("acm", "acm3025"):
        return load_acm3025(**kwargs)
    if name == "acm_synthetic":
        return acm_synthetic(**kwargs)
    if name == "dblp_synthetic":
        return dblp_synthetic(**kwargs)
    if name == "dblp":
        from han_tpu_torch.datasets.dblp import load_dblp
        return load_dblp(**kwargs)
    if name == "imdb":
        from han_tpu_torch.datasets.imdb import load_imdb
        kwargs.setdefault("subset", "all")
        return load_imdb(**kwargs)
    if name == "imdb_strict":
        from han_tpu_torch.datasets.imdb import load_imdb
        return load_imdb(subset="strict", **kwargs)
    if name == "powerlaw":
        return powerlaw_hetero(**kwargs)
    if name == "ppi":
        from han_tpu_torch.datasets.ppi import load_ppi, ppi_synthetic
        root = pathlib.Path(kwargs.pop("root", "data_cache/ppi"))
        if (root / "ppi-G.json").exists():
            return load_ppi(root, **kwargs)
        return ppi_synthetic(**kwargs)
    if name in ("cora", "citeseer", "pubmed"):
        from han_tpu_torch.datasets.planetoid import load_planetoid
        kwargs.setdefault("root", "data_cache/planetoid")
        return load_planetoid(name=name, **kwargs)
    raise KeyError(f"unknown dataset {name!r}; known: acm, acm3025, acm_synthetic, "
                   "dblp, dblp_synthetic, imdb, imdb_strict, ppi, powerlaw, cora, "
                   "citeseer, pubmed")
