"""han_tpu_torch/datasets/dblp_kg.py against han_tpu/datasets/dblp_kg.py on
DBLP_four_area-format files written here (han_tpu's own tests need the raw
files and skip without them): the returned lists and counts are equal, and
every file both write is byte-equal (the pickle also equal once loaded)."""

import pathlib
import pickle

import numpy as np
import pytest

pytest.importorskip("jax")

from han_tpu.datasets import dblp_kg as jkg  # noqa: E402
from han_tpu_torch.datasets import dblp_kg as tkg  # noqa: E402

WORDS = ("graph", "The", "data", "mining", "of", "neural", "AND", "retrieval",
         "système", "above", "learning", "x")


def write_four_area(root: pathlib.Path, seed: int = 0) -> None:
    """The files hin_to_kg and clean_terms read: entity tables (authors,
    papers, terms, with stop words in several cases, conferences) and the
    three link tables, with a blank line, a line without a tab and a
    duplicate link among them."""
    rng = np.random.default_rng(seed)
    rows = lambda pairs: "".join(f"{a}\t{b}\n" for a, b in pairs)
    (root / "author.txt").write_text(rows((100 + i, f"Author {i}") for i in range(15)))
    (root / "paper.txt").write_text(
        rows((i, " ".join(rng.choice(WORDS, 4))) for i in range(20)) + "\n77\n",
        encoding="utf-8")
    (root / "term.txt").write_text(rows(enumerate(WORDS)), encoding="utf-8")
    (root / "conf.txt").write_text(rows((c, f"CONF{c}") for c in range(4)))
    pa = [(p, 100 + int(a)) for p in range(20) for a in rng.integers(0, 15, 2)]
    (root / "paper_author.txt").write_text(rows(pa + pa[:1]))
    (root / "paper_conf.txt").write_text(rows((p, rng.integers(0, 4)) for p in range(20)))
    (root / "paper_term.txt").write_text(
        rows((p, int(t)) for p in range(20) for t in rng.integers(0, len(WORDS), 3)) + "\n")


@pytest.fixture
def four_area(tmp_path):
    root = tmp_path / "DBLP_four_area"
    root.mkdir()
    write_four_area(root)
    return root


def assert_same_files(a: pathlib.Path, b: pathlib.Path, names) -> None:
    assert sorted(p.name for p in a.iterdir()) == sorted(p.name for p in b.iterdir()) \
        == sorted(names)
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_hin_to_kg_writes_what_han_tpu_writes(four_area, tmp_path):
    got = tkg.hin_to_kg(four_area, tmp_path / "port")
    want = jkg.hin_to_kg(four_area, tmp_path / "jax")
    assert got == want
    assert tkg.RELATIONS == jkg.RELATIONS and got[1] == ["PA", "PC", "PT"]
    ents, _, trips = got
    assert len(ents) == 15 + 20 + len(WORDS) + 4 and len(trips) == 41 + 20 + 60
    assert_same_files(tmp_path / "port", tmp_path / "jax",
                      ("DBLP_Triplets.pickle", "entity2id.txt", "relation2id.txt", "train.txt"))
    with open(tmp_path / "port" / "DBLP_Triplets.pickle", "rb") as f:
        assert pickle.load(f) == [ents, ["PA", "PC", "PT"], trips]
    assert tkg.hin_to_kg(four_area) == want  # no out_dir: nothing written


@pytest.mark.parametrize("stopwords", [None, {"data", "graph"}])
def test_clean_terms_writes_what_han_tpu_writes(four_area, tmp_path, stopwords):
    got = tkg.clean_terms(four_area, tmp_path / "port", stopwords=stopwords)
    want = jkg.clean_terms(four_area, tmp_path / "jax", stopwords=stopwords)
    assert got == want
    # scikit-learn's list drops "The", "of", "AND" and "above"
    assert got["terms_dropped"] == (4 if stopwords is None else 2)
    assert got["terms_kept"] + got["terms_dropped"] == len(WORDS)
    assert_same_files(tmp_path / "port", tmp_path / "jax",
                      ("term_modify.txt", "paper_term_modify.txt"))
