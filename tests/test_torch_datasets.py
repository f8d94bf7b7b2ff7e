"""The port's dataset front door (han_tpu_torch/datasets/registry.py)
against han_tpu's: the names ``acm``/``acm3025`` (the ``.mat`` loader and
its fallback to the ACM3025-shaped fixture), ``powerlaw`` (the numpy copies
of the power-law generators), ``run()`` loading the acm preset's dataset by
name, and every other name ``preset()`` accepts — dblp, imdb, imdb_strict,
ppi, cora, citeseer, pubmed — read from the same tiny files (written here)
or fallbacks by both packages: equal arrays, the cache round trip, the
missing-file errors and the stop-word copy."""

import csv
import json
import pathlib

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

pytest.importorskip("jax")

from han_tpu.datasets import acm as jacm  # noqa: E402
from han_tpu.datasets.registry import load_dataset as jload  # noqa: E402
from han_tpu_torch.datasets import acm as tacm  # noqa: E402
from han_tpu_torch.datasets.planetoid import write_planetoid  # noqa: E402
from han_tpu_torch.datasets.registry import load_dataset as tload  # noqa: E402
from han_tpu_torch.graph import synthetic as tsyn  # noqa: E402
from han_tpu_torch.train.config import preset  # noqa: E402
from han_tpu_torch.train.trainer import run  # noqa: E402


def assert_same_dataset(got, want):
    """Every array of two HeteroDatasets equal, adjacencies included."""
    assert got.name == want.name and tuple(got.metapath_names) == tuple(want.metapath_names)
    for field in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert len(got.metapath_adjs) == len(want.metapath_adjs)
    for a, b in zip(got.metapath_adjs, want.metapath_adjs):
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a != b).nnz == 0


@pytest.mark.parametrize("name", ["acm", "acm3025"])
def test_acm_name_loads_what_han_tpu_loads(name):
    """With ACM3025.mat where han_tpu looks for it or absent (it is not in
    the repository), the port answers "acm" with the same arrays: the
    ACM3025-shaped fixture when no file is found."""
    got, want = tload(name), jload(name)
    assert_same_dataset(got, want)
    if not any(p.exists() for p in tacm._search()):
        assert got.name == "acm_synthetic" and got.n_nodes == 3025
        assert got.features.shape == (3025, 1870)


def test_powerlaw_matches_han_tpu():
    kw = dict(n_nodes=2000, edges_per_metapath=20000)
    assert_same_dataset(tload("powerlaw", **kw), jload("powerlaw", **kw))


def test_powerlaw_bipartite_is_a_copy():
    from han_tpu.graph import synthetic as jsyn

    a = tsyn.powerlaw_bipartite(300, 40, 5000, alpha=1.4, seed=9)
    b = jsyn.powerlaw_bipartite(300, 40, 5000, alpha=1.4, seed=9)
    assert a.shape == b.shape and (a != b).nnz == 0 and a.dtype == b.dtype


def tiny_mat(path: pathlib.Path, n=12, f=5, seed=0) -> None:
    """A tiny ACM3025-format .mat: one-hot labels, features, PAP and PLP
    with the identity included (the loader subtracts it), index lists."""
    rng = np.random.default_rng(seed)
    labels = np.eye(3)[rng.integers(0, 3, n)]
    adj = lambda: np.maximum((rng.random((n, n)) < 0.3), np.eye(n, dtype=bool)).astype(np.float64)
    perm = rng.permutation(n)
    sio.savemat(str(path), {
        "label": labels, "feature": rng.standard_normal((n, f)), "PAP": adj(), "PLP": adj(),
        "train_idx": perm[:4][None, :], "val_idx": perm[4:7][None, :],
        "test_idx": perm[7:][None, :]})


def test_load_acm3025_reads_a_mat_file_as_han_tpu(tmp_path):
    path = tmp_path / "ACM3025.mat"
    tiny_mat(path)
    got = tload("acm", path=path)
    assert_same_dataset(got, jacm.load_acm3025(path))
    assert got.name == "acm3025" and got.n_nodes == 12
    assert all(a.diagonal().sum() == 0 for a in got.metapath_adjs)  # identity removed
    with pytest.raises(FileNotFoundError):
        tload("acm", path=tmp_path / "absent.mat", allow_synthetic=False)


def test_run_trains_the_acm_preset_by_name():
    """run(preset("acm")) with no dataset loads it by name, as
    scripts/train_torch.py does with its default --dataset acm (csr
    attention here, to keep the test small)."""
    cfg = preset("acm")
    cfg.data.graph_format, cfg.model.impl = "csr", "csr"
    cfg.train.epochs, cfg.train.log_file = 2, ""
    result = run(cfg, device="cpu")
    losses = result["epoch_train_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all() and np.isfinite(result["test_loss"])




def test_acm_synthetic_is_the_fixture():
    assert_same_dataset(tload("acm_synthetic"), jload("acm_synthetic"))


# ---------------------------------------------------------------------------
# the remaining preset names: tiny raw files written here, read by both
# packages
# ---------------------------------------------------------------------------


TITLE_WORDS = ("graph", "mining", "query", "learning", "database", "neural", "retrieval",
               "index", "the", "of", "and", "a", "for", "on")


def write_dblp(root: pathlib.Path, n_authors=40, n_papers=90, seed=0) -> None:
    """DBLP_four_area-format files: labeled authors listed out of id order,
    papers with labeled and unlabeled authors, conferences, terms, and
    titles with stop words (and one line without a title)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(100, 100 + n_authors))
    labels = np.arange(n_authors) % 4
    rows = lambda pairs: "".join(f"{a}\t{b}\n" for a, b in pairs)
    (root / "author_label.txt").write_text(rows(zip(ids, labels)))
    authors = np.concatenate([ids, np.arange(500, 510)])  # 10 unlabeled authors
    pa = {(p, int(a)) for p in range(n_papers) for a in rng.choice(authors, 3)}
    (root / "paper_author.txt").write_text(rows(sorted(pa)))
    (root / "paper_conf.txt").write_text(rows((p, rng.integers(0, 5)) for p in range(n_papers)))
    (root / "term.txt").write_text(rows((t, f"term{t}") for t in range(12)))
    (root / "paper_term.txt").write_text(rows(
        {(p, int(t)) for p in range(n_papers) for t in rng.integers(0, 12, 2)}))
    titles = [" ".join(rng.choice(TITLE_WORDS, 5)).title() for _ in range(n_papers)]
    (root / "paper.txt").write_text(rows(enumerate(titles)) + "77\n")


def write_imdb(path: pathlib.Path, n=40, seed=0) -> None:
    """movie_metadata.csv-format rows: genre lists with and without the
    target genres, rows without a director or actors, and repeated
    (title, director) pairs."""
    rng = np.random.default_rng(seed)
    genres = ("Action", "Comedy", "Drama", "Horror", "Romance")
    kws = [f"kw{i}" for i in range(10)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["movie_title", "genres", "director_name", "actor_1_name", "actor_2_name",
                    "actor_3_name", "plot_keywords"])
        for i in range(n):
            g = "|".join(rng.choice(genres, int(rng.integers(1, 3)), replace=False))
            director = "" if i % 7 == 3 else f"dir{rng.integers(0, 8)}"
            actors = [f"act{rng.integers(0, 15)}" if rng.random() < 0.8 else "" for _ in range(3)]
            if i % 11 == 5:
                actors = ["", "", ""]
            title = f"movie{i % 33}"  # titles 0-6 repeat
            w.writerow([title, g, director, *actors, "|".join(rng.choice(kws, 3))])


def write_graphsage_ppi(root: pathlib.Path, tiny_splits=("test", "test"), seed=0) -> None:
    """ppi-G.json, -id_map.json, -class_map.json and -feats.npy: components
    of 4-9 nodes with their own split flags, two 2-node components (tiny:
    regrouped into one bucket a split) in ``tiny_splits``, a constant
    feature column, multi-hot labels."""
    rng = np.random.default_rng(seed)
    nodes, links, start = [], [], 0
    for c, size in enumerate([7, 5, 9, 6, 4, 8, 2, 2]):
        split = ("train", "train", "train", "val", "test", "train", *tiny_splits)[c]
        for i in range(size):
            nodes.append({"id": start + i, "val": split == "val", "test": split == "test"})
        for i in range(1, size):  # a spanning path and a few chords
            links.append({"source": start + i - 1, "target": start + i})
        for _ in range(size // 2):
            u, v = rng.integers(start, start + size, 2)
            links.append({"source": int(u), "target": int(v)})
        start += size
    n = start
    id_map = {str(i): i for i in range(n)}  # links index the node list (node-link format)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    feats[:, 2] = 3.0
    class_map = {str(i): rng.integers(0, 2, 5).tolist() for i in range(n)}
    for name, obj in (("G", {"nodes": nodes, "links": links}), ("id_map", id_map),
                      ("class_map", class_map)):
        (root / f"ppi-{name}.json").write_text(json.dumps(obj))
    np.save(root / "ppi-feats.npy", feats)


def assert_same_multigraph(got, want, feature_atol=0.0):
    assert got.name == want.name
    for field in ("adj", "features", "labels", "node_mask", "graph_split"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_allclose(a, b, atol=feature_atol if field == "features" else 0,
                                   rtol=0, err_msg=field)


def files_for(name: str, root: pathlib.Path) -> dict:
    """Write name's raw files under root; the loader arguments that read them."""
    if name == "dblp":
        write_dblp(root)
        return {"root": root, "use_cache": False, "min_keyword_count": 3}
    if name in ("imdb", "imdb_strict"):
        write_imdb(root / "movie_metadata.csv")
        return {"path": root / "movie_metadata.csv", "use_cache": False, "train_size": 8,
                "val_size": 6}
    if name == "ppi":
        return {"root": root}  # no ppi-G.json: the synthetic fallback
    write_planetoid(root, name, n_nodes=60, n_feats=12, n_edges=90, n_train=9, n_test=20,
                    gaps=(3, 11) if name == "citeseer" else ())
    return {"root": root}


@pytest.mark.parametrize("name", ["dblp", "imdb", "imdb_strict", "ppi", "cora", "citeseer",
                                  "pubmed"])
def test_every_preset_name_loads_as_han_tpu(name, tmp_path):
    """Every other name preset() accepts loads in the port, with the arrays
    han_tpu loads from the same files (or the same fallback)."""
    preset(name)  # the name is a preset
    kw = files_for(name, tmp_path)
    got, want = tload(name, **dict(kw)), jload(name, **dict(kw))
    if name == "ppi":
        assert_same_multigraph(got, want)
        assert got.name == "ppi_synthetic"
    else:
        assert_same_dataset(got, want)
        assert got.n_nodes > 0 and all(a.nnz > 0 for a in got.metapath_adjs)
    with pytest.raises(KeyError):
        tload("no_such_dataset")


@pytest.mark.parametrize("subset", ["all", "strict"])
def test_imdb_subsets_match_han_tpu(subset, tmp_path):
    from han_tpu.datasets.imdb import load_imdb as jimdb
    from han_tpu_torch.datasets.imdb import load_imdb as timdb

    write_imdb(tmp_path / "m.csv", n=60, seed=3)
    kw = dict(path=tmp_path / "m.csv", use_cache=False, train_size=10, val_size=10, seed=5,
              subset=subset)
    got = timdb(**kw)
    assert_same_dataset(got, jimdb(**kw))
    assert got.train_mask.sum() == 10 and got.val_mask.sum() == 10


def test_load_ppi_reads_graphsage_files(tmp_path):
    """The "ppi" name with GraphSAGE files under root reads them: equal
    arrays, features (standardized on the train nodes) within 1e-6."""
    from han_tpu.datasets.ppi import load_ppi as jppi

    write_graphsage_ppi(tmp_path)
    got = tload("ppi", root=tmp_path)
    assert_same_multigraph(got, jppi(tmp_path), feature_atol=1e-6)
    assert got.n_graphs == 7 and got.adj.shape[1] == 9  # 6 components + the test bucket
    assert sorted(got.node_mask.sum(1).tolist()) == [4, 4, 5, 6, 7, 8, 9]
    train = got.node_mask & (got.graph_split == 0)[:, None]
    np.testing.assert_allclose(got.features[train].mean(0), np.zeros(6), atol=1e-6)
    assert (got.features[train][:, 2] == 0).all()  # constant column: scale 1


def test_tiny_components_in_two_splits_get_a_bucket_each(tmp_path):
    """A fault of han_tpu's batch_components: once it has made a bucket for
    the tiny components of one split, its lookup for the next split indexes
    past the component sizes (IndexError), so only tiny components of the
    test split load there. The port reads the sizes once and makes one
    bucket a split."""
    from han_tpu.datasets.ppi import load_ppi as jppi

    write_graphsage_ppi(tmp_path, tiny_splits=("val", "train"))
    with pytest.raises(IndexError):
        jppi(tmp_path)
    got = tload("ppi", root=tmp_path)
    assert got.n_graphs == 8 and sorted(got.graph_split.tolist()) == [0, 0, 0, 0, 0, 1, 1, 2]
    sizes = got.node_mask.sum(1)
    assert sorted(sizes.tolist()) == [2, 2, 4, 5, 6, 7, 8, 9]


@pytest.mark.parametrize("kw", [{}, {"n_graphs": 5, "nodes_per_graph": 30, "seed": 3},
                                {"n_feats": 7, "n_labels": 4, "avg_degree": 2.5}])
def test_ppi_synthetic_is_a_copy(kw):
    from han_tpu.datasets.ppi import ppi_synthetic as jsyn
    from han_tpu_torch.datasets.ppi import ppi_synthetic as tsyn

    assert_same_multigraph(tsyn(**kw), jsyn(**kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_standard_scale_is_sklearns(seed):
    from sklearn.preprocessing import StandardScaler

    from han_tpu_torch.datasets.ppi import standard_scale

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((80, 7)) * rng.random(7) * 10 + rng.standard_normal(7)).astype(
        np.float32)
    x[:, 3] = 2.5  # constant
    rows = rng.random(80) < 0.6
    want = StandardScaler().fit(x[rows]).transform(x).astype(np.float32)
    got = standard_scale(x, rows)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,gaps", [("cora", ()), ("citeseer", (2, 5, 17)),
                                       ("pubmed", ())])
def test_planetoid_matches_han_tpu(name, gaps, tmp_path):
    from han_tpu.datasets.planetoid import load_planetoid as jplan
    from han_tpu_torch.datasets.planetoid import load_planetoid as tplan

    write_planetoid(tmp_path, name, n_nodes=80, n_feats=10, n_edges=150, n_train=12,
                    n_test=25, gaps=gaps, seed=4)
    got = tplan(tmp_path, name)
    assert_same_dataset(got, jplan(tmp_path, name))
    assert got.test_mask.sum() == 25 - len(gaps) and got.train_mask.sum() == 12
    for g in gaps:  # isolated test nodes re-inserted as zero rows
        assert got.features[80 - 25 + g].sum() == 0 and got.labels[80 - 25 + g].sum() == 0


def test_graph_build_helpers_are_copies():
    from han_tpu.graph import build as jbuild
    from han_tpu_torch.graph import build as tbuild

    rng = np.random.default_rng(0)
    dense = (rng.random((30, 30)) < 0.1).astype(np.float32)
    dense[4] = 0  # a zero-degree row
    a = sp.csr_matrix(dense)
    x = rng.random((30, 5)).astype(np.float32)
    x[7] = 0
    for fn in ("normalize_adj", "preprocess_adj"):
        got, want = getattr(tbuild, fn)(a), getattr(jbuild, fn)(a)
        assert got.dtype == want.dtype and abs(got - want).max() == 0, fn
    np.testing.assert_array_equal(tbuild.row_normalize_features(x),
                                  jbuild.row_normalize_features(x))


def test_stopwords_are_sklearns():
    from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS

    from han_tpu_torch.datasets.stopwords import ENGLISH_STOP_WORDS as ours

    assert isinstance(ours, frozenset) and ours == ENGLISH_STOP_WORDS and len(ours) == 318


def test_dataset_cache_round_trips(tmp_path, monkeypatch):
    """A first load writes CACHE_DIR/dblp.npz in han_tpu's layout; the next
    load reads it back, raw files gone; han_tpu's reader reads it too."""
    from han_tpu.datasets.base import load_cached as jcached
    from han_tpu_torch.datasets import base

    monkeypatch.setattr(base, "CACHE_DIR", tmp_path / "cache")
    write_dblp(tmp_path)
    first = tload("dblp", root=tmp_path, min_keyword_count=3)
    path = tmp_path / "cache" / "dblp.npz"
    assert path.exists()
    assert_same_dataset(tload("dblp", root=tmp_path / "absent"), first)
    assert_same_dataset(jcached(path), first)
    for i, a in enumerate(first.metapath_adjs):
        assert a.dtype == np.float32, i


@pytest.mark.parametrize("name", ["dblp", "imdb"])
def test_missing_raw_files_raise(name, tmp_path):
    """Without the raw files both packages raise FileNotFoundError (no
    fallback)."""
    kw = ({"root": tmp_path / "absent"} if name == "dblp"
          else {"path": tmp_path / "absent.csv"})
    for load in (tload, jload):
        with pytest.raises(FileNotFoundError):
            load(name, use_cache=False, **kw)
