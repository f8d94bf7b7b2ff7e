"""The port's embedding evaluation (train/eval_embed.py, plain torch)
against han_tpu's (scikit-learn): knn_eval on the same embedding and seed,
F1/NMI/ARI against scikit-learn's on random label pairs, KMeans on
separable blobs and its inertia against scikit-learn's, and the keys
Trainer.fit returns for HAN."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sklearn.cluster import KMeans  # noqa: E402
from sklearn.metrics import adjusted_rand_score, f1_score, normalized_mutual_info_score  # noqa: E402

from han_tpu.train import eval_embed as jeval  # noqa: E402
from han_tpu_torch.train import eval_embed as teval  # noqa: E402


def embedding(seed, n=150, dim=8, n_classes=4):
    """Class-shifted gaussian embedding and its one-hot labels."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    x = rng.standard_normal((n, dim)) + 1.2 * np.eye(n_classes, dim)[y]
    return x.astype(np.float32), np.eye(n_classes, dtype=np.float32)[y]


@pytest.mark.parametrize("seed,n_classes", [(0, 3), (1, 4), (2, 6)])
def test_knn_eval_matches_han_tpu(seed, n_classes):
    """The same permutations (default_rng(seed)), neighbours and vote:
    every macro/micro-F1 within 1e-12 of han_tpu's."""
    x, y = embedding(seed, n_classes=n_classes)
    got, want = teval.knn_eval(x, y, seed=seed), jeval.knn_eval(x, y, seed=seed)
    assert got.keys() == want.keys() and len(got) == 8
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    # a torch tensor is evaluated where it lives, to the same numbers
    again = teval.knn_eval(torch.from_numpy(x), torch.from_numpy(y), seed=seed)
    assert again == got


@pytest.mark.parametrize("seed", range(4))
def test_scores_match_sklearn(seed):
    """macro/micro-F1 over the union of labels, NMI (arithmetic) and ARI
    on random label pairs, within 1e-12; including a prediction with labels
    the truth lacks and a single-cluster case."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(3, 60))
        a = rng.integers(0, int(rng.integers(1, 5)), n)
        b = rng.integers(0, int(rng.integers(1, 7)), n)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        macro, micro = teval.f1_scores(ta, tb)
        for got, want in ((macro, f1_score(a, b, average="macro")),
                          (micro, f1_score(a, b, average="micro")),
                          (teval.nmi_score(ta, tb), normalized_mutual_info_score(a, b)),
                          (teval.ari_score(ta, tb), adjusted_rand_score(a, b))):
            assert abs(got - want) <= 1e-12, (a, b, got, want)


def test_knn_vote_tie_goes_to_the_smallest_label():
    x_train = torch.tensor([[0.0], [1.0], [-1.0], [2.0], [-2.0]], dtype=torch.float64)
    y_train = torch.tensor([3, 1, 1, 3, 0])
    pred = teval.knn_predict(x_train, y_train, torch.zeros((1, 1), dtype=torch.float64), k=4)
    assert pred.tolist() == [1]  # 1 and 3 have two votes each


def test_kmeans_recovers_separable_blobs():
    """Three far-apart blobs: the clustering equals the blob labels up to a
    permutation, so NMI = ARI = 1."""
    rng = np.random.default_rng(0)
    y = rng.permutation(np.repeat(np.arange(3), 40))
    x = rng.standard_normal((120, 5)) * 0.1 + 20.0 * np.eye(3, 5)[y]
    labels, inertia = teval.kmeans(x, 3, seed=7)
    pairs = set(zip(labels.tolist(), y.tolist()))
    assert len(pairs) == 3 and len({p[0] for p in pairs}) == 3
    assert teval.kmeans_eval(x, np.eye(3)[y], seed=1) == {"nmi": 1.0, "ari": 1.0}
    assert inertia > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_inertia_near_sklearn(seed):
    """Overlapping gaussian clusters: the best of 10 k-means++ runs has an
    inertia within 1 % of scikit-learn's KMeans(n_init=10)."""
    x, _ = embedding(seed, n=300, dim=6, n_classes=4)
    _, inertia = teval.kmeans(x, 4, seed=seed)
    want = KMeans(n_clusters=4, n_init=10, random_state=seed).fit(x.astype(np.float64)).inertia_
    assert abs(inertia - want) <= 0.01 * want, (inertia, want)


def test_fit_reports_the_embedding_scores_han_tpu_does(tiny_ds):
    """Trainer.fit on HAN ends with KNN and KMeans of the test embedding:
    the keys han_tpu's fit adds (its knn_eval's and kmeans_eval's,
    han_tpu/train/trainer.py:418-422), each score in range."""
    from han_tpu_torch.train import trainer as ttrainer
    from han_tpu_torch.train.config import preset

    x, y = embedding(0, n=40)
    keys = {*jeval.knn_eval(x, y, repeats=1), *jeval.kmeans_eval(x, y, repeats=1)}
    cfg = preset("acm")
    cfg.data.graph_format, cfg.model.impl, cfg.train.epochs = "csr", "csr", 2
    got = ttrainer.Trainer(tiny_ds, cfg, device="cpu",
                           logger=ttrainer.MetricLogger(echo=False)).fit()
    assert len(keys) == 10 and keys <= got.keys()
    for k in keys:
        assert -1.0 <= got[k] <= 1.0, k
