"""Seeded synthetic heterogeneous graphs: the planted generator and the
power-law scale graphs (numpy copies of han_tpu/graph/synthetic.py:27-221)
and the scale configuration's graph and data (``big_csr`` and
``scale_dataset``, copies of scripts/bench_scale.py:30-46,77-91);
bit-identical output for equal arguments, held so by
tests/test_torch_graph.py, tests/test_torch_sampled.py and
tests/test_torch_datasets.py."""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from han_tpu_torch.graph.build import symmetric_metapath


@dataclasses.dataclass
class HeteroDataset:
    """In-memory heterogeneous node-classification dataset (host arrays)."""

    metapath_adjs: list[sp.csr_matrix]  # P square N×N meta-path graphs (no self-loops implied)
    features: np.ndarray  # float32[N, F]
    labels: np.ndarray  # float32[N, C] one-hot
    train_mask: np.ndarray  # bool[N]
    val_mask: np.ndarray
    test_mask: np.ndarray
    name: str = "synthetic"
    metapath_names: tuple[str, ...] = ()

    @property
    def n_nodes(self) -> int:
        return int(self.features.shape[0])

    @property
    def n_classes(self) -> int:
        return int(self.labels.shape[1])


def planted_hetero(
    *,
    n_nodes: int = 3025,
    n_feats: int = 1870,
    n_classes: int = 3,
    n_metapaths: int = 2,
    avg_degree: float = 10.0,
    homophily: float = 0.85,
    feat_signal: float = 1.5,
    train_per_class: int = 200,
    n_val: int = 300,
    n_communities: int | None = None,
    shuffle_nodes: bool = False,
    seed: int = 0,
    name: str = "synthetic",
) -> HeteroDataset:
    """Planted-partition heterogeneous graph with *clustered* cross edges.

    Nodes belong to ``n_communities`` contiguous communities (default
    4 × n_classes); class = community mod n_classes. A fraction
    ``homophily`` of each node's edges stay inside its community; the rest
    go to the two ring-adjacent communities, so the contiguous layout gives
    a block-tridiagonal adjacency, which the block-sparse flash kernel
    exploits. Defaults mirror the ACM3025 shape (han.pdf Table 2).
    """
    rng = np.random.default_rng(seed)
    n_comm = n_communities or max(4 * n_classes, 8)
    comm = (np.arange(n_nodes) * n_comm) // n_nodes  # contiguous communities
    y = comm % n_classes

    members = [np.where(comm == c)[0] for c in range(n_comm)]

    adjs = []
    for p in range(n_metapaths):
        # per-metapath homophily varies a bit so semantic attention has signal
        h = homophily if p == 0 else max(0.55, homophily - 0.2 * p)
        n_edges = int(n_nodes * avg_degree / 2)
        src = rng.integers(0, n_nodes, size=n_edges)
        stay = rng.random(n_edges) < h
        ring = rng.integers(0, 2, size=n_edges) * 2 - 1  # ±1 neighbor community
        dst_comm = np.where(stay, comm[src], (comm[src] + ring) % n_comm)
        sizes = np.array([m.shape[0] for m in members])
        offs = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        flat = np.concatenate(members)
        dst = flat[offs[dst_comm] + rng.integers(0, 1 << 30, size=n_edges) % sizes[dst_comm]]
        a = sp.coo_matrix(
            (np.ones(n_edges, dtype=np.float32), (src, dst)),
            shape=(n_nodes, n_nodes))
        a = ((a + a.T) > 0).astype(np.float32).tocsr()
        a.setdiag(0)
        a.eliminate_zeros()
        adjs.append(a)

    # class-structured sparse features
    feats = (rng.random((n_nodes, n_feats)) < 0.02).astype(np.float32)
    block = n_feats // n_classes
    for cidx in range(n_classes):
        members = np.where(y == cidx)[0]
        lo, hi = cidx * block, (cidx + 1) * block
        boost = (rng.random((members.shape[0], hi - lo)) < 0.02 * feat_signal).astype(np.float32)
        feats[members[:, None], np.arange(lo, hi)[None, :]] += boost
    feats = np.minimum(feats, 1.0)

    labels = np.zeros((n_nodes, n_classes), dtype=np.float32)
    labels[np.arange(n_nodes), y] = 1.0

    train_mask = np.zeros(n_nodes, dtype=bool)
    for cidx in range(n_classes):
        members = np.where(y == cidx)[0]
        pick = rng.permutation(members)[:train_per_class]
        train_mask[pick] = True
    rest = np.where(~train_mask)[0]
    rest = rng.permutation(rest)
    val_mask = np.zeros(n_nodes, dtype=bool)
    val_mask[rest[:n_val]] = True
    test_mask = np.zeros(n_nodes, dtype=bool)
    test_mask[rest[n_val:]] = True

    if shuffle_nodes:
        perm = rng.permutation(n_nodes)
        adjs = [a.tocsr()[perm][:, perm] for a in adjs]
        feats = feats[perm]
        labels = labels[perm]
        train_mask = train_mask[perm]
        val_mask = val_mask[perm]
        test_mask = test_mask[perm]

    return HeteroDataset(
        metapath_adjs=adjs,
        features=feats,
        labels=labels,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name=name,
        metapath_names=tuple(f"MP{p}" for p in range(n_metapaths)),
    )


def powerlaw_bipartite(
    n_left: int,
    n_right: int,
    n_edges: int,
    *,
    alpha: float = 1.5,
    seed: int = 0,
) -> sp.csr_matrix:
    """Power-law bipartite incidence (e.g. paper→author) for scale tests.

    Right-node popularity follows a Zipf-like distribution with exponent
    ``alpha`` — models the degree skew called out in SURVEY.md §7 (conference
    nodes with ~14k papers in DBLP APCPA).
    """
    rng = np.random.default_rng(seed)
    popularity = 1.0 / np.arange(1, n_right + 1, dtype=np.float64) ** alpha
    popularity /= popularity.sum()
    src = rng.integers(0, n_left, size=n_edges)
    dst = rng.choice(n_right, size=n_edges, p=popularity)
    m = sp.coo_matrix(
        (np.ones(n_edges, dtype=np.float32), (src, dst)), shape=(n_left, n_right)
    ).tocsr()
    m.sum_duplicates()
    m.data = np.ones_like(m.data)
    return m


def powerlaw_hetero(
    *,
    n_nodes: int = 100_000,
    n_feats: int = 128,
    n_classes: int = 8,
    edges_per_metapath: int = 2_000_000,
    n_metapaths: int = 2,
    seed: int = 0,
) -> HeteroDataset:
    """Large synthetic heterogeneous graph via meta-path composition over
    power-law bipartite incidences (the BASELINE.json 100M-edge config scaled
    by arguments)."""
    rng = np.random.default_rng(seed)
    adjs = []
    for p in range(n_metapaths):
        n_mid = max(64, n_nodes // (8 * (p + 1)))
        inc = powerlaw_bipartite(
            n_nodes, n_mid, edges_per_metapath // 4, alpha=1.2 + 0.2 * p, seed=seed + 13 * p
        )
        a = symmetric_metapath(inc)
        a.setdiag(0)
        a.eliminate_zeros()
        adjs.append(a)
    y = rng.integers(0, n_classes, size=n_nodes)
    feats = rng.standard_normal((n_nodes, n_feats)).astype(np.float32)
    labels = np.zeros((n_nodes, n_classes), dtype=np.float32)
    labels[np.arange(n_nodes), y] = 1.0
    train_mask = rng.random(n_nodes) < 0.1
    val_mask = (~train_mask) & (rng.random(n_nodes) < 0.1)
    test_mask = ~(train_mask | val_mask)
    return HeteroDataset(
        metapath_adjs=adjs,
        features=feats,
        labels=labels,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name="powerlaw",
        metapath_names=tuple(f"PL{p}" for p in range(n_metapaths)),
    )


def big_csr(n: int, avg_degree: int, *, n_comm: int = 64, seed: int = 0) -> sp.csr_matrix:
    """Community-clustered fixed-degree CSR built directly from index arrays
    (never materializes COO duplicates or dense forms)."""
    rng = np.random.default_rng(seed)
    deg = avg_degree
    row_ptr = (np.arange(n + 1, dtype=np.int64) * deg)
    comm_of = (np.arange(n, dtype=np.int64) * n_comm) // n
    comm_size = n // n_comm
    # 80% of neighbors inside the node's community, rest uniform
    local = rng.integers(0, max(comm_size, 1), size=(n, deg), dtype=np.int64)
    base = (comm_of * comm_size)[:, None]
    cols = base + local
    far = rng.random((n, deg)) > 0.8
    cols[far] = rng.integers(0, n, size=int(far.sum()), dtype=np.int64)
    cols = np.minimum(cols, n - 1).astype(np.int32).reshape(-1)
    data = np.ones(cols.shape[0], dtype=np.float32)
    return sp.csr_matrix((data, cols, row_ptr), shape=(n, n))


def scale_dataset(n: int, avg_degree: int, *, n_metapaths: int = 2,
                  n_feats: int = 64, n_classes: int = 8, n_train: int,
                  n_val: int, n_test: int | None = None,
                  seed: int = 0) -> HeteroDataset:
    """The scale benchmark's dataset: ``n_metapaths`` big_csr meta-path
    graphs, standard-normal features and uniform random labels; the first
    ``n_train`` nodes train, the last ``n_val`` validate, and the
    ``n_test`` nodes after the train nodes test (all the rest when None)."""
    rng = np.random.default_rng(seed)
    adjs = [big_csr(n, avg_degree, seed=seed + 31 * p) for p in range(n_metapaths)]
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
    return HeteroDataset(adjs, feats, labels, train_mask, val_mask, test_mask,
                         name="scale")
