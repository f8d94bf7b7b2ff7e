"""Frozen copy of the program's ``scale_dataset`` and ``big_csr``
(``han_tpu_torch/graph/synthetic.py``): P meta-paths of ``avg_degree``
community-clustered column draws a node, standard-normal features, uniform
classes and a fixed split. ``tests/test_bench_data.py`` holds it
bit-identical to the program's at small sizes."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from benchmark.data import Inputs


def big_csr_cols(n: int, avg_degree: int, *, n_comm: int = 64, seed: int = 0) -> np.ndarray:
    """The (n, degree) int32 column draws of the program's ``big_csr``:
    row i's columns are ``cols[i]``, in draw order, duplicates kept."""
    rng = np.random.default_rng(seed)
    deg = avg_degree
    comm_of = (np.arange(n, dtype=np.int64) * n_comm) // n
    comm_size = n // n_comm
    local = rng.integers(0, max(comm_size, 1), size=(n, deg), dtype=np.int64)
    cols = (comm_of * comm_size)[:, None] + local
    far = rng.random((n, deg)) > 0.8
    cols[far] = rng.integers(0, n, size=int(far.sum()), dtype=np.int64)
    return np.minimum(cols, n - 1).astype(np.int32)


def big_csr(cols: np.ndarray) -> sp.csr_matrix:
    """The program's ``big_csr`` matrix over :func:`big_csr_cols`' draws
    (one row a node, not canonicalized, as the program builds it)."""
    n, deg = cols.shape
    row_ptr = np.arange(n + 1, dtype=np.int64) * deg
    flat = cols.reshape(-1)
    return sp.csr_matrix((np.ones(flat.shape[0], dtype=np.float32), flat, row_ptr),
                         shape=(n, n))


def scale_arrays(n, avg_degree, *, n_metapaths, n_feats, n_classes, n_train, n_val,
                 n_test, seed):
    """Copy of the program's ``scale_dataset``: returns (cols per meta-path,
    features, labels, train_mask, val_mask, test_mask)."""
    rng = np.random.default_rng(seed)
    cols = [big_csr_cols(n, avg_degree, seed=seed + 31 * p) for p in range(n_metapaths)]
    feats = rng.standard_normal((n, n_feats)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n)
    labels = np.zeros((n, n_classes), np.float32)
    labels[np.arange(n), y] = 1.0
    train_mask = np.zeros(n, bool)
    train_mask[:n_train] = True
    val_mask = np.zeros(n, bool)
    val_mask[-n_val:] = True
    test_mask = ~(train_mask | val_mask)
    if n_test is not None:
        test_mask[n_train + n_test:] = False
    return cols, feats, labels, train_mask, val_mask, test_mask


def make_inputs(args: dict, seed: int) -> Inputs:
    args = dict(args)
    n, deg = args.pop("n_nodes"), args.pop("avg_degree")
    cols, *rest = scale_arrays(n, deg, **args, seed=seed)
    return Inputs([big_csr(c) for c in cols], *rest, raw_cols=cols)
