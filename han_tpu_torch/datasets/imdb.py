"""IMDB-5000 heterogeneous dataset built from the raw CSV (numpy copy of
han_tpu/datasets/imdb.py:36-146).

HAN setup (han.pdf Table 2 / §5.2): movies labeled by genre
{Action, Comedy, Drama}; meta-paths MAM (shared actor) and MDM (shared
director); features = bag-of-words over plot keywords; split 300/300/rest.
Movies whose genre list hits a target genre are labeled by GENRES
priority order (Action > Comedy > Drama). Two subsets:

- ``subset="strict"``: require a named director and >=1 named actor,
  dedupe by (title, director) → 4,180 movies;
- ``subset="all"``: keep every genre-hit movie (rows without a director
  simply have no MDM edges) → 4,380 movies.
"""

from __future__ import annotations

import csv
from collections import Counter

import numpy as np
import scipy.sparse as sp

from han_tpu_torch.datasets import base
from han_tpu_torch.graph.synthetic import HeteroDataset

GENRES = ("Action", "Comedy", "Drama")


def load_imdb(
    path=None,
    *,
    train_size: int = 300,
    val_size: int = 300,
    min_keyword_count: int = 2,
    seed: int = 0,
    use_cache: bool = True,
    subset: str = "all",  # "all" (4,380, better micro-F1) | "strict" (4,180)
) -> HeteroDataset:
    cache_name = "imdb" if subset == "strict" else f"imdb_{subset}"
    cached = base.load_cached(base.cache_path(cache_name)) if use_cache else None
    if cached is not None:
        return cached

    path = (base.REFERENCE_DATA / "imdb" / "movie_metadata.csv") if path is None else path

    movies = []  # (title, label, director, actors, keywords)
    with open(path, newline="", encoding="utf-8", errors="replace") as f:
        for row in csv.DictReader(f):
            genres = set((row.get("genres") or "").split("|"))
            hits = [g for g in GENRES if g in genres]
            if not hits:
                continue  # unlabeled
            director = (row.get("director_name") or "").strip()
            actors = [a.strip() for a in (
                row.get("actor_1_name"), row.get("actor_2_name"), row.get("actor_3_name"))
                if a and a.strip()]
            if subset == "strict" and (not director or not actors):
                continue
            kws = [k.strip() for k in (row.get("plot_keywords") or "").split("|") if k.strip()]
            title = (row.get("movie_title") or "").strip()
            movies.append((title, GENRES.index(hits[0]), director, actors, kws))

    if subset == "strict":
        # dedupe by (title, director)
        seen = set()
        uniq = []
        for m in movies:
            key = (m[0], m[2])
            if key not in seen:
                seen.add(key)
                uniq.append(m)
        movies = uniq
    n = len(movies)

    directors = sorted({m[2] for m in movies if m[2]})
    d_index = {d: i for i, d in enumerate(directors)}
    actors = sorted({a for m in movies for a in m[3]})
    a_index = {a: i for i, a in enumerate(actors)}

    def incidence(col_index, items_fn):
        rows, cols = [], []
        for i, m in enumerate(movies):
            for it in items_fn(m):
                rows.append(i)
                cols.append(col_index[it])
        mat = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                            shape=(n, len(col_index))).tocsr()
        mat.sum_duplicates()
        mat.data = np.ones_like(mat.data)
        return mat

    ma = incidence(a_index, lambda m: m[3])
    md = incidence(d_index, lambda m: [m[2]] if m[2] else [])
    mam = (ma @ ma.T).tocsr()
    mdm = (md @ md.T).tocsr()
    adjs = []
    for a in (mam, mdm):
        a.data = np.ones_like(a.data)
        a.setdiag(0)
        a.eliminate_zeros()
        adjs.append(a)

    # plot-keyword bag-of-words features
    counter = Counter(k for m in movies for k in set(m[4]))
    kws = sorted(k for k, v in counter.items() if v >= min_keyword_count)
    kw_index = {k: i for i, k in enumerate(kws)}
    feats = np.zeros((n, len(kws)), dtype=np.float32)
    for i, m in enumerate(movies):
        for k in m[4]:
            j = kw_index.get(k)
            if j is not None:
                feats[i, j] = 1.0

    labels = np.zeros((n, len(GENRES)), dtype=np.float32)
    labels[np.arange(n), [m[1] for m in movies]] = 1.0

    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    train_mask[perm[:train_size]] = True
    val_mask[perm[train_size:train_size + val_size]] = True
    test_mask = ~(train_mask | val_mask)

    ds = HeteroDataset(
        metapath_adjs=adjs,
        features=feats,
        labels=labels,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name="imdb",
        metapath_names=("MAM", "MDM"),
    )
    if use_cache:
        base.save_dataset(ds, base.cache_path(cache_name))
    return ds
