"""DBLP heterogeneous-information-network export and term cleanup (copy of
han_tpu/datasets/dblp_kg.py; the stop words are datasets/stopwords.py's
copy of scikit-learn's list, so the port needs no scikit-learn).

The reference's two standalone preprocessing scripts as functions:

- :func:`hin_to_kg`: the HIN → knowledge-graph triple export
  (data/DBLP_four_area/hin2kg.py:17-89). Entities are type-prefixed ids
  (``A…/P…/T…/C…``), relations ``PA/PC/PT``, triples ``(P<pid>, <X><xid>,
  rel)`` read from the ``paper_*.txt`` link tables. With ``out_dir`` it
  writes the FB15K-style ``entity2id.txt``, ``relation2id.txt`` and
  ``train.txt`` and the pickle ``DBLP_Triplets.pickle``.
- :func:`clean_terms`: the stop-word cleanup
  (data/DBLP_four_area/modify_term.py:26-49). The reference builds its
  stop-word list and never applies it; as in han_tpu the filter is
  applied: stop-word terms leave ``term_modify.txt`` and their rows
  ``paper_term_modify.txt``.

Both read the raw files under ``root`` and write only under ``out_dir``.
"""

from __future__ import annotations

import pickle
from pathlib import Path

from han_tpu_torch.datasets.base import REFERENCE_DATA
from han_tpu_torch.datasets.stopwords import ENGLISH_STOP_WORDS

RELATIONS = ("PA", "PC", "PT")
_LINK_FILES = {"PA": "paper_author.txt", "PC": "paper_conf.txt", "PT": "paper_term.txt"}
_TARGET_PREFIX = {"PA": "A", "PC": "C", "PT": "T"}


def _read_tsv(path: Path):
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0]:
                yield parts[0], parts[1]


def hin_to_kg(root=None, out_dir=None) -> tuple[list, list, list]:
    """The DBLP HIN as (ent_list, rel_list, trip_list).

    Entities in the reference's order (authors, papers, terms, confs:
    hin2kg.py:46-50); triples are ``(head, tail, relation)`` string tuples
    in PA, PC, PT order (hin2kg.py:60-86). With ``out_dir``, writes
    ``DBLP_Triplets.pickle`` and the FB15K-style id and train files.
    """
    root = Path(root) if root is not None else REFERENCE_DATA / "DBLP_four_area"

    ent_list: list[str] = []
    for prefix, fname in (("A", "author.txt"), ("P", "paper.txt"),
                          ("T", "term.txt"), ("C", "conf.txt")):
        ent_list.extend(prefix + eid for eid, _ in _read_tsv(root / fname))

    trip_list: list[tuple[str, str, str]] = []
    for rel in RELATIONS:
        tgt = _TARGET_PREFIX[rel]
        trip_list.extend(("P" + pid, tgt + xid, rel)
                         for pid, xid in _read_tsv(root / _LINK_FILES[rel]))

    rel_list = list(RELATIONS)
    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "DBLP_Triplets.pickle", "wb") as f:
            pickle.dump([ent_list, rel_list, trip_list], f)
        with open(out / "entity2id.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{e}\t{i}\n" for i, e in enumerate(ent_list))
        with open(out / "relation2id.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{r}\t{i}\n" for i, r in enumerate(rel_list))
        with open(out / "train.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{h}\t{t}\t{r}\n" for h, t, r in trip_list)
    return ent_list, rel_list, trip_list


def clean_terms(root=None, out_dir=None, *, stopwords=None) -> dict[str, int]:
    """Drop stop-word terms from ``term.txt`` and ``paper_term.txt``.

    Returns the counts {'terms_kept', 'terms_dropped', 'links_kept',
    'links_dropped'}; with ``out_dir``, writes ``term_modify.txt`` and
    ``paper_term_modify.txt`` there. The default list is scikit-learn's
    English stop words (han_tpu's stand-in for NLTK's, whose corpus needs
    a download).
    """
    root = Path(root) if root is not None else REFERENCE_DATA / "DBLP_four_area"
    stop = frozenset(stopwords) if stopwords is not None else ENGLISH_STOP_WORDS

    kept: dict[str, str] = {}
    dropped = 0
    for tid, word in _read_tsv(root / "term.txt"):
        if word.lower() in stop:
            dropped += 1
        else:
            kept[tid] = word

    links_kept, links_dropped = [], 0
    for pid, tid in _read_tsv(root / "paper_term.txt"):
        if tid in kept:
            links_kept.append((pid, tid))
        else:
            links_dropped += 1

    if out_dir is not None:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "term_modify.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{tid}\t{word}\n" for tid, word in kept.items())
        with open(out / "paper_term_modify.txt", "w", encoding="utf-8") as f:
            f.writelines(f"{pid}\t{tid}\n" for pid, tid in links_kept)

    return {"terms_kept": len(kept), "terms_dropped": dropped,
            "links_kept": len(links_kept), "links_dropped": links_dropped}
