"""Dataset cache and data locations shared by the loaders (numpy copy of
han_tpu/datasets/base.py:1-64: the same npz layout and environment
variables).

- ``REFERENCE_DATA``: where the raw files are read (``$HAN_TPU_REFERENCE_DATA``,
  else ``data_cache/reference`` in the repository).
- ``CACHE_DIR``: where processed datasets are cached (``$HAN_TPU_CACHE``,
  else ``data_cache`` in the repository, which ``.gitignore`` lists).
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import scipy.sparse as sp

from han_tpu_torch.graph.synthetic import HeteroDataset

_REPO = pathlib.Path(__file__).resolve().parents[2]
REFERENCE_DATA = pathlib.Path(os.environ.get("HAN_TPU_REFERENCE_DATA",
                                             _REPO / "data_cache" / "reference"))
CACHE_DIR = pathlib.Path(os.environ.get("HAN_TPU_CACHE", _REPO / "data_cache"))


def cache_path(name: str) -> pathlib.Path:
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    return CACHE_DIR / f"{name}.npz"


def save_dataset(ds: HeteroDataset, path: pathlib.Path) -> None:
    payload = {
        "features": ds.features,
        "labels": ds.labels,
        "train_mask": ds.train_mask,
        "val_mask": ds.val_mask,
        "test_mask": ds.test_mask,
        "n_metapaths": np.array(len(ds.metapath_adjs)),
        "metapath_names": np.array(list(ds.metapath_names), dtype=object),
        "name": np.array(ds.name),
    }
    for i, a in enumerate(ds.metapath_adjs):
        a = a.tocsr()
        payload[f"adj{i}_indptr"] = a.indptr
        payload[f"adj{i}_indices"] = a.indices
        payload[f"adj{i}_shape"] = np.array(a.shape)
    np.savez_compressed(path, **payload, allow_pickle=True)


def load_cached(path: pathlib.Path) -> HeteroDataset | None:
    if not path.exists():
        return None
    z = np.load(path, allow_pickle=True)
    p = int(z["n_metapaths"])
    adjs = []
    for i in range(p):
        indptr = z[f"adj{i}_indptr"]
        indices = z[f"adj{i}_indices"]
        shape = tuple(z[f"adj{i}_shape"])
        adjs.append(sp.csr_matrix(
            (np.ones(indices.shape[0], np.float32), indices, indptr), shape=shape))
    return HeteroDataset(
        metapath_adjs=adjs,
        features=z["features"].astype(np.float32),
        labels=z["labels"].astype(np.float32),
        train_mask=z["train_mask"].astype(bool),
        val_mask=z["val_mask"].astype(bool),
        test_mask=z["test_mask"].astype(bool),
        name=str(z["name"]),
        metapath_names=tuple(str(s) for s in z["metapath_names"]),
    )
