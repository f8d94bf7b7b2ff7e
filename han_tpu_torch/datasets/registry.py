"""Dataset registry: name → loader.

Only the in-repo generators are ported. The raw-file loaders (ACM3025
``.mat``, DBLP, IMDB) need files that are not in the repository, and the
DBLP one needs sklearn; they wait for a later port.
"""

from __future__ import annotations

import dataclasses

from han_tpu_torch.graph.synthetic import HeteroDataset, planted_hetero


def acm_synthetic(seed: int = 0) -> HeteroDataset:
    """ACM3025-shaped planted fixture (as han_tpu.datasets.acm.acm_synthetic)."""
    ds = planted_hetero(
        n_nodes=3025, n_feats=1870, n_classes=3, n_metapaths=2,
        avg_degree=29.0, train_per_class=200, n_val=300, seed=seed,
        name="acm_synthetic")
    return dataclasses.replace(ds, metapath_names=("PAP", "PSP"))


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
    if name == "acm_synthetic":
        return acm_synthetic(**kwargs)
    if name == "dblp_synthetic":
        return dblp_synthetic(**kwargs)
    raise KeyError(f"unknown dataset {name!r}; the port knows acm_synthetic "
                   "and dblp_synthetic (raw-file loaders are not ported)")
