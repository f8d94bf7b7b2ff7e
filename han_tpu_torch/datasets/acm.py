"""ACM3025 dataset loader (numpy copy of han_tpu/datasets/acm.py:33-83;
reference ex_acm3025.py:57-87 semantics).

The ``.mat`` blob is missing from the reference checkout
(.MISSING_LARGE_BLOBS), so this loader:

1. loads the real file when one is found (keys ``label``, ``feature``,
   ``PAP``, ``PLP``, ``train_idx``/``val_idx``/``test_idx``; the identity is
   subtracted from each precomputed meta-path adjacency exactly as
   ex_acm3025.py:61 — self-loops are re-added downstream where the
   attention masks are made);
2. otherwise falls back to a deterministic planted fixture with the real
   dataset's exact shape (3025 nodes / 1870 feats / 3 classes / PAP+PSP /
   600-300-2125 split, han.pdf Table 2) so the full pipeline and benchmarks
   run unchanged.

The file is looked for where han_tpu looks: ``data_cache/ACM3025.mat`` in
the repository, then ``acm/ACM3025.mat`` under ``$HAN_TPU_REFERENCE_DATA``
(han_tpu/datasets/base.py:15-16; the port reads that directory only when
the variable is set).
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import scipy.sparse as sp

from han_tpu_torch.graph.synthetic import HeteroDataset, planted_hetero

_REPO = pathlib.Path(__file__).resolve().parents[2]


def _search() -> list[pathlib.Path]:
    paths = [_REPO / "data_cache" / "ACM3025.mat"]
    if os.environ.get("HAN_TPU_REFERENCE_DATA"):
        paths.append(pathlib.Path(os.environ["HAN_TPU_REFERENCE_DATA"]) / "acm" / "ACM3025.mat")
    return paths


def acm_synthetic(seed: int = 0) -> HeteroDataset:
    """ACM3025-shaped planted fixture (deterministic in seed)."""
    ds = planted_hetero(
        n_nodes=3025, n_feats=1870, n_classes=3, n_metapaths=2,
        avg_degree=29.0,  # nnz density in the same ballpark as real PAP/PSP
        train_per_class=200, n_val=300, seed=seed, name="acm_synthetic",
    )
    return HeteroDataset(
        metapath_adjs=ds.metapath_adjs, features=ds.features, labels=ds.labels,
        train_mask=ds.train_mask, val_mask=ds.val_mask, test_mask=ds.test_mask,
        name="acm_synthetic", metapath_names=("PAP", "PSP"),
    )


def load_acm3025(path=None, *, allow_synthetic: bool = True) -> HeteroDataset:
    candidates = [pathlib.Path(path)] if path is not None else _search()
    mat_path = next((p for p in candidates if p.exists()), None)
    if mat_path is None:
        if not allow_synthetic:
            raise FileNotFoundError(
                f"ACM3025.mat not found in {candidates}; the blob is absent from "
                "the reference checkout (.MISSING_LARGE_BLOBS)")
        return acm_synthetic()

    import scipy.io as sio

    data = sio.loadmat(str(mat_path))
    labels = data["label"].astype(np.float32)
    feats = data["feature"].astype(np.float32)
    n = feats.shape[0]
    adjs = []
    for key in ("PAP", "PLP"):
        a = np.asarray(data[key], dtype=np.float32) - np.eye(n, dtype=np.float32)
        m = sp.csr_matrix((a > 0).astype(np.float32))
        adjs.append(m)

    def mask_of(idx):
        m = np.zeros(n, bool)
        m[np.asarray(idx).ravel()] = True
        return m

    return HeteroDataset(
        metapath_adjs=adjs,
        features=feats,
        labels=labels,
        train_mask=mask_of(data["train_idx"]),
        val_mask=mask_of(data["val_idx"]),
        test_mask=mask_of(data["test_idx"]),
        name="acm3025",
        metapath_names=("PAP", "PSP"),
    )
