"""Downstream embedding evaluation: KNN classification and KMeans clustering
(port of han_tpu/train/eval_embed.py:22-85, which calls scikit-learn;
reference jhyexp.py:20-86). Plain torch in float64 on the embedding's
device; no scikit-learn.

- ``knn_eval``: the same permutations as han_tpu (``np.random.default_rng
  (seed)``), k euclidean nearest neighbours, majority vote with a tie going
  to the smallest label (scikit-learn's mode), macro- and micro-F1 over the
  union of true and predicted labels (0 for a class never predicted).
- ``kmeans_eval``: greedy k-means++ seeding and Lloyd iterations as
  scikit-learn's ``KMeans(n_init=10)`` runs them (2 + ln k candidates a
  centre, tolerance 1e-4 of the mean feature variance, 300 iterations),
  drawn from a ``torch.Generator`` seeded ``seed + r``, so its draws are
  not scikit-learn's; the run with the least inertia is kept. NMI with the
  arithmetic mean and ARI, as scikit-learn computes them, and with
  ``with_silhouette`` the euclidean silhouette of each repeat's assignment
  (:func:`silhouette_score`, scikit-learn's).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _as_f64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float64)


def _label_ids(y) -> torch.Tensor:
    y = torch.as_tensor(y)
    return y.argmax(dim=1) if y.ndim > 1 else y.long()


def f1_scores(y_true: torch.Tensor, y_pred: torch.Tensor) -> tuple[float, float]:
    """(macro-F1, micro-F1) of integer labels over the union of the true and
    predicted labels, a class without predictions or support scoring 0
    (scikit-learn's ``f1_score``)."""
    labels = torch.unique(torch.cat([y_true, y_pred]))
    hit = y_true[:, None] == labels[None]
    said = y_pred[:, None] == labels[None]
    tp = (hit & said).sum(0).to(torch.float64)
    fp = (~hit & said).sum(0).to(torch.float64)
    fn = (hit & ~said).sum(0).to(torch.float64)
    denom = 2 * tp + fp + fn
    per_class = torch.where(denom > 0, 2 * tp / denom.clamp_min(1), 0.0)
    micro_den = float(2 * tp.sum() + fp.sum() + fn.sum())
    micro = float(2 * tp.sum()) / micro_den if micro_den > 0 else 0.0
    return float(per_class.mean()), micro


def knn_predict(x_train: torch.Tensor, y_train: torch.Tensor, x_test: torch.Tensor,
                k: int) -> torch.Tensor:
    """Majority label of the k euclidean nearest training rows; a tie in
    the vote goes to the smallest label."""
    dist = torch.cdist(x_test, x_train, compute_mode="donot_use_mm_for_euclid_dist")
    nbr = dist.topk(min(k, x_train.shape[0]), dim=1, largest=False).indices
    n_labels = int(y_train.max()) + 1
    votes = torch.zeros((x_test.shape[0], n_labels), dtype=torch.int64, device=x_test.device)
    votes.scatter_add_(1, y_train[nbr], torch.ones_like(nbr))
    return votes.argmax(dim=1)  # the first (smallest) label of the largest count


def knn_eval(x, y, *, k: int = 5, split_list=(0.2, 0.4, 0.6, 0.8), repeats: int = 10,
             seed: int = 0) -> dict[str, float]:
    """k-NN classification over the frozen embedding at several train
    fractions, averaged over shuffled repeats; returns
    {'macro_f1@0.2': ..., 'micro_f1@0.2': ..., ...}."""
    x = _as_f64(x)
    y = _label_ids(y).to(x.device)
    rng = np.random.default_rng(seed)
    out: dict[str, float] = {}
    for frac in split_list:
        split = int(x.shape[0] * frac)
        macro, micro = [], []
        for _ in range(repeats):
            perm = torch.from_numpy(rng.permutation(x.shape[0])).to(x.device)
            xp, yp = x[perm], y[perm]
            pred = knn_predict(xp[:split], yp[:split], xp[split:], k)
            ma, mi = f1_scores(yp[split:], pred)
            macro.append(ma)
            micro.append(mi)
        out[f"macro_f1@{frac}"] = float(np.mean(macro))
        out[f"micro_f1@{frac}"] = float(np.mean(micro))
    return out


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances of x's rows (n, d) to centres c (..., k, d):
    (..., n, k)."""
    d = (x * x).sum(1)[:, None] - 2 * x @ c.transpose(-1, -2) + (c * c).sum(-1)[..., None, :]
    return d.clamp_min(0.0)


def _kmeans_plusplus(x: torch.Tensor, n_clusters: int, n_init: int,
                     gen: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ for n_init runs at once: the first centre uniform,
    then each centre the best of 2 + ln k candidates drawn in proportion to
    the squared distance. Returns (n_init, k, d)."""
    n = x.shape[0]
    runs = torch.arange(n_init, device=x.device)
    trials = 2 + int(math.log(n_clusters))
    first = torch.randint(n, (n_init,), generator=gen, device=x.device)
    centers = [x[first]]
    closest = _sq_dist(x, x[first]).T  # (n_init, n)
    for _ in range(1, n_clusters):
        r = (torch.rand((n_init, trials), generator=gen, device=x.device, dtype=torch.float64)
             * closest.sum(1, keepdim=True))
        cand = torch.searchsorted(closest.cumsum(1), r).clamp_max(n - 1)
        d = torch.minimum(closest[:, None], _sq_dist(x, x[cand]).transpose(1, 2))
        best = d.sum(2).argmin(1)  # (n_init,): the candidate of least potential
        closest = d[runs, best]
        centers.append(x[cand[runs, best]])
    return torch.stack(centers, 1)


def _lloyd(x: torch.Tensor, centers: torch.Tensor, tol: float,
           max_iter: int = 300) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations of each run (centers (B, k, d)) until its assignment
    repeats or its centres move by at most tol; an emptied cluster takes the
    point farthest from its centre. Returns (labels (B, n), inertia (B,))."""
    n_runs, k, _ = centers.shape
    active = torch.ones(n_runs, dtype=torch.bool, device=x.device)
    labels = None
    for _ in range(max_iter):
        d = _sq_dist(x, centers)  # (B, n, k)
        new = d.argmin(2)
        if labels is not None:
            active &= ~(new == labels).all(1)
        labels = new if labels is None else torch.where(active[:, None], new, labels)
        if not bool(active.any()):
            break
        onehot = F.one_hot(labels, k).to(x.dtype)  # (B, n, k)
        counts, sums = onehot.sum(1), onehot.transpose(1, 2) @ x
        empty = (counts == 0) & active[:, None]
        for b in empty.any(1).nonzero().flatten().tolist():
            gone = empty[b].nonzero().flatten()
            far = d[b].gather(1, labels[b, :, None])[:, 0].topk(gone.numel()).indices
            sums[b, gone], counts[b, gone] = x[far], 1.0
        moved = sums / counts[..., None]
        settled = active & (((moved - centers) ** 2).sum((1, 2)) <= tol)
        centers = torch.where(active[:, None, None], moved, centers)
        labels = torch.where(settled[:, None], _sq_dist(x, centers).argmin(2), labels)
        active &= ~settled
    inertia = _sq_dist(x, centers).gather(2, labels[..., None]).sum((1, 2))
    return labels, inertia


def _kmeans_seeds(x: torch.Tensor, n_clusters: int, n_init: int,
                  seeds) -> list[tuple[torch.Tensor, float]]:
    """For each seed, the best of n_init k-means++ + Lloyd runs drawn by one
    ``torch.Generator`` seeded with it; all runs iterate together."""
    tol = float(x.var(dim=0, unbiased=False).mean()) * 1e-4
    inits = [_kmeans_plusplus(x, n_clusters, n_init,
                              torch.Generator(device=x.device).manual_seed(seed))
             for seed in seeds]
    labels, inertia = _lloyd(x, torch.cat(inits), tol)
    out = []
    for i in range(len(inits)):
        # the first of equal inertias, as a sequential loop keeps
        best = i * n_init + int(inertia[i * n_init:(i + 1) * n_init].argmin())
        out.append((labels[best], float(inertia[best])))
    return out


def kmeans(x, n_clusters: int, *, n_init: int = 10, seed: int = 0) -> tuple[torch.Tensor, float]:
    """Best of n_init k-means++ + Lloyd runs, one ``torch.Generator``
    seeded ``seed`` on x's device drawing all of them: (labels, inertia)."""
    return _kmeans_seeds(_as_f64(x), n_clusters, n_init, [seed])[0]


def _entropy(counts: torch.Tensor) -> torch.Tensor:
    p = counts[counts > 0].to(torch.float64)
    total = p.sum()
    return -((p / total) * (torch.log(p) - torch.log(total))).sum()


def nmi_score(y_true: torch.Tensor, y_pred: torch.Tensor) -> float:
    """Normalized mutual information, arithmetic-mean normalization
    (scikit-learn's ``normalized_mutual_info_score``)."""
    classes, ti = torch.unique(y_true, return_inverse=True)
    clusters, pi = torch.unique(y_pred, return_inverse=True)
    if classes.numel() == clusters.numel() == 1 or classes.numel() == clusters.numel() == 0:
        return 1.0
    cont = torch.zeros((classes.numel(), clusters.numel()), dtype=torch.int64,
                       device=y_true.device)
    cont.index_put_((ti, pi), torch.ones_like(ti), accumulate=True)
    nz = cont > 0
    nzv = cont[nz].to(torch.float64)
    total = nzv.sum()
    row, col = cont.sum(1), cont.sum(0)
    ri, ci = nz.nonzero(as_tuple=True)
    outer = (row[ri] * col[ci]).to(torch.float64)
    log_outer = -torch.log(outer) + torch.log(row.sum().double()) + torch.log(col.sum().double())
    pnm = nzv / total
    mi = pnm * (torch.log(nzv) - torch.log(total)) + pnm * log_outer
    mi = torch.where(mi.abs() < torch.finfo(torch.float64).eps, 0.0, mi)
    mi = float(mi.sum().clamp_min(0.0))
    if mi == 0.0:
        return 0.0
    h = (float(_entropy(torch.bincount(ti))) + float(_entropy(torch.bincount(pi)))) / 2
    return mi / h


def ari_score(y_true: torch.Tensor, y_pred: torch.Tensor) -> float:
    """Adjusted Rand index from the pair confusion matrix, in Python
    integers (scikit-learn's ``adjusted_rand_score``)."""
    _, ti = torch.unique(y_true, return_inverse=True)
    _, pi = torch.unique(y_pred, return_inverse=True)
    cont = torch.zeros((int(ti.max()) + 1, int(pi.max()) + 1), dtype=torch.int64,
                       device=y_true.device)
    cont.index_put_((ti, pi), torch.ones_like(ti), accumulate=True)
    n = int(y_true.numel())
    n_c, n_k = cont.sum(1), cont.sum(0)
    sq = int((cont ** 2).sum())
    c01 = int((cont * n_k[None]).sum()) - sq  # no integer matmul on CUDA
    c10 = int((cont * n_c[:, None]).sum()) - sq
    tp, fp, fn = sq - n, c01, c10
    tn = n * n - c01 - c10 - sq
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def silhouette_score(x, labels, *, block: int = 4096) -> float:
    """Mean euclidean silhouette coefficient of the assignment ``labels``
    (scikit-learn's ``silhouette_score``), in float64 on x's device: per
    sample, a = the mean distance to the rest of its cluster, b = the least
    mean distance to another cluster, s = (b - a) / max(a, b), and 0 for a
    sample alone in its cluster. Distances are taken ``block`` rows at a
    time. Raises ValueError unless 2 <= #clusters <= #samples - 1."""
    x = _as_f64(x)
    _, lab = torch.unique(torch.as_tensor(labels).to(x.device), return_inverse=True)
    n, k = x.shape[0], int(lab.max()) + 1
    if not 2 <= k <= n - 1:
        raise ValueError(f"the silhouette needs 2 <= clusters <= samples - 1, got {k} "
                         f"clusters of {n} samples")
    onehot = F.one_hot(lab, k).to(torch.float64)
    counts = onehot.sum(dim=0)
    sums = torch.cat([  # (N, K): summed distances from each sample to each cluster
        torch.cdist(x[i:i + block], x, compute_mode="donot_use_mm_for_euclid_dist") @ onehot
        for i in range(0, n, block)])
    rest = counts[lab] - 1
    a = sums.gather(1, lab[:, None])[:, 0] / rest.clamp_min(1)
    b = (sums / counts).scatter(1, lab[:, None], float("inf")).amin(dim=1)
    s = torch.where(rest > 0, (b - a) / torch.maximum(a, b), 0.0)
    return float(torch.nan_to_num(s).mean())


def kmeans_eval(x, y, *, n_clusters: int | None = None, repeats: int = 10,
                seed: int = 0, with_silhouette: bool = False) -> dict[str, float]:
    """KMeans clustering of the embedding; NMI and ARI averaged over
    repeats. ``n_clusters`` defaults to the number of distinct labels.
    ``with_silhouette`` adds the euclidean silhouette of each repeat's
    assignment, averaged (the data/exp.py:25-63 ``my_Kmeans`` variant)."""
    x = _as_f64(x)
    y = _label_ids(y).to(x.device)
    k = int(n_clusters or torch.unique(y).numel())
    nmi, ari, sil = [], [], []
    for pred, _ in _kmeans_seeds(x, k, 10, [seed + r for r in range(repeats)]):
        nmi.append(nmi_score(y, pred))
        ari.append(ari_score(y, pred))
        if with_silhouette:
            sil.append(silhouette_score(x, pred))
    out = {"nmi": float(np.mean(nmi)), "ari": float(np.mean(ari))}
    if with_silhouette:
        out["silhouette"] = float(np.mean(sil))
    return out
