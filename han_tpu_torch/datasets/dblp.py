"""DBLP four-area dataset built from the raw heterogeneous files (numpy copy
of han_tpu/datasets/dblp.py:32-183; the stop words are
datasets/stopwords.py's copy of scikit-learn's list).

- nodes: labeled authors (4,057; labels 0=DB 1=DM 2=AI 3=IR from
  author_label.txt);
- meta-paths (han.pdf Table 2): APA (co-authorship), APCPA (same
  conference), APTPA (shared term);
- author features: binary bag-of-words over frequent paper-title keywords
  (count > 50 after stopword removal, preprocess_dblp.py:2-27 semantics);
- split: class-balanced in node order, train_size/4 then val_size/4 per
  class, rest test (preprocess_dblp.py:56-92 ``split_idx`` semantics;
  defaults 800/400/2857 per han.pdf Table 2).

Without the raw files it raises FileNotFoundError; there is no fallback
(``dblp_synthetic`` is the DBLP-shaped fixture, datasets/registry.py).
"""

from __future__ import annotations

import pathlib
import re
from collections import Counter

import numpy as np
import scipy.sparse as sp

from han_tpu_torch.datasets import base
from han_tpu_torch.datasets.stopwords import ENGLISH_STOP_WORDS
from han_tpu_torch.graph.synthetic import HeteroDataset

_TOKEN = re.compile(r"[a-zA-Z0-9]+")


def _read_pairs(path):
    out = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0] and parts[1]:
                out.append((parts[0], parts[1]))
    return out


def _incidence(pairs, row_index: dict, col_index: dict) -> sp.csr_matrix:
    rows, cols = [], []
    for a, b in pairs:
        i = row_index.get(a)
        j = col_index.get(b)
        if i is not None and j is not None:
            rows.append(i)
            cols.append(j)
    m = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)),
        shape=(len(row_index), len(col_index)),
    ).tocsr()
    m.sum_duplicates()
    m.data = np.ones_like(m.data)
    return m


def load_dblp(
    root=None,
    *,
    train_size: int = 800,
    val_size: int = 400,
    min_keyword_count: int = 50,
    use_cache: bool = True,
) -> HeteroDataset:
    cached = base.load_cached(base.cache_path("dblp")) if use_cache else None
    if cached is not None:
        return cached

    root = (base.REFERENCE_DATA / "DBLP_four_area") if root is None else pathlib.Path(root)

    # --- labeled authors (node set) -------------------------------------
    author_rows = []
    with open(root / "author_label.txt", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                author_rows.append((parts[0], int(parts[1])))
    author_rows.sort(key=lambda t: int(t[0]))  # deterministic node order by id
    author_index = {aid: i for i, (aid, _) in enumerate(author_rows)}
    n_authors = len(author_rows)
    y = np.array([lab for _, lab in author_rows], dtype=np.int64)
    n_classes = int(y.max()) + 1

    # --- link tables -----------------------------------------------------
    pa_pairs = _read_pairs(root / "paper_author.txt")  # (paper, author)
    pc_pairs = _read_pairs(root / "paper_conf.txt")
    pt_pairs = _read_pairs(root / "paper_term.txt")

    # papers that touch a labeled author (the rest never enter any meta-path)
    papers = sorted({p for p, a in pa_pairs if a in author_index}, key=int)
    paper_index = {p: i for i, p in enumerate(papers)}
    confs = sorted({c for _, c in pc_pairs}, key=int)
    conf_index = {c: i for i, c in enumerate(confs)}

    # terms: the stopword-filtered list when present (reference
    # modify_term.py output term_modify.txt), else the raw term list
    term_file = root / "term_modify.txt"
    if not term_file.exists():
        term_file = root / "term.txt"
    with open(term_file, encoding="utf-8", errors="replace") as f:
        terms = sorted({t.split("\t")[0] for t in f if t.strip()}, key=int)
    term_index = {t: i for i, t in enumerate(terms)}

    ap = _incidence([(a, p) for p, a in pa_pairs], author_index, paper_index)  # A×P
    pc = _incidence(pc_pairs, paper_index, conf_index)  # P×C
    pt = _incidence(pt_pairs, paper_index, term_index)  # P×T

    # --- meta-path adjacencies ------------------------------------------
    apa = (ap @ ap.T).tocsr()
    apc = (ap @ pc).tocsr()
    apcpa = (apc @ apc.T).tocsr()
    apt = (ap @ pt).tocsr()
    aptpa = (apt @ apt.T).tocsr()
    adjs = []
    for a in (apa, apcpa, aptpa):
        a.data = np.ones_like(a.data)
        a.setdiag(0)
        a.eliminate_zeros()
        adjs.append(a)

    # --- author features: frequent title keywords ------------------------
    paper_tokens: dict[str, list[str]] = {}
    counter: Counter = Counter()
    with open(root / "paper.txt", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            toks = [t for t in _TOKEN.findall(parts[1].lower())
                    if t not in ENGLISH_STOP_WORDS]
            if parts[0] in paper_index:
                paper_tokens[parts[0]] = toks
                counter.update(toks)
    keywords = sorted(k for k, v in counter.items() if v > min_keyword_count)
    kw_index = {k: i for i, k in enumerate(keywords)}

    feats = np.zeros((n_authors, len(keywords)), dtype=np.float32)
    author_papers: dict[int, list[str]] = {}
    for p, a in pa_pairs:
        ai = author_index.get(a)
        if ai is not None and p in paper_tokens:
            author_papers.setdefault(ai, []).append(p)
    for ai, plist in author_papers.items():
        for p in plist:
            for t in paper_tokens[p]:
                j = kw_index.get(t)
                if j is not None:
                    feats[ai, j] = 1.0

    labels = np.zeros((n_authors, n_classes), dtype=np.float32)
    labels[np.arange(n_authors), y] = 1.0

    # --- class-balanced split in node order (split_idx semantics) --------
    train_per, val_per = train_size // n_classes, val_size // n_classes
    seen = np.zeros(n_classes, dtype=np.int64)
    train_mask = np.zeros(n_authors, bool)
    val_mask = np.zeros(n_authors, bool)
    for i in range(n_authors):
        c = y[i]
        if seen[c] < train_per:
            train_mask[i] = True
        elif seen[c] < train_per + val_per:
            val_mask[i] = True
        seen[c] += 1
    test_mask = ~(train_mask | val_mask)

    ds = HeteroDataset(
        metapath_adjs=adjs,
        features=feats,
        labels=labels,
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name="dblp",
        metapath_names=("APA", "APCPA", "APTPA"),
    )
    if use_cache:
        base.save_dataset(ds, base.cache_path("dblp"))
    return ds
