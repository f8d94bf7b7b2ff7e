"""The benchmark's inputs, made from the run's seed by generators of the
benchmark's own (``generators/<name>.py``, each with ``make_inputs(args,
seed)``), so that a change to the program's own generators cannot change
the yardstick.

A configuration's ``inputs`` section names its generator; its other keys
are the generator's arguments. A heterogeneous-graph generator returns
:class:`Inputs` (plain numpy and scipy arrays), which a loop hands to the
program as its ``HeteroDataset`` (:func:`hetero_dataset`) and to the plain
reference as they are.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass
class Inputs:
    """One configuration's data: P meta-path graphs (no self-loops),
    features, one-hot labels and the split. ``raw_cols`` holds a big_csr
    graph's (n, degree) column draws, from which the reference reads a
    node's neighbours without building a CSR."""

    adjs: list
    features: np.ndarray
    labels: np.ndarray
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    raw_cols: list | None = None

    @property
    def n_nodes(self) -> int:
        return int(self.features.shape[0])

    def neighbours(self, p: int, u: int) -> np.ndarray:
        """Node ``u``'s in-neighbours in meta-path ``p`` with one self-loop,
        sorted, duplicates kept: the row the samplers read (the graph with
        its existing diagonal dropped and one self-loop spliced in)."""
        if self.raw_cols is not None:
            cols = self.raw_cols[p][u]
        else:
            a = self.adjs[p]
            cols = a.indices[a.indptr[u]:a.indptr[u + 1]]
        cols = cols[cols != u]
        return np.sort(np.concatenate([cols, [u]]).astype(np.int64), kind="stable")


def make_inputs(spec: dict, seed: int):
    """A configuration's ``inputs`` section and the run's seed → the
    arrays of the generator it names."""
    gen = importlib.import_module(f"benchmark.generators.{spec['generator']}")
    return gen.make_inputs({k: v for k, v in spec.items() if k != "generator"}, seed)


def hetero_dataset(inputs: Inputs, name: str):
    """The program's ``HeteroDataset`` of ``inputs``."""
    from han_tpu_torch.graph.synthetic import HeteroDataset

    i = inputs
    return HeteroDataset(i.adjs, i.features, i.labels, i.train_mask, i.val_mask,
                         i.test_mask, name=name)
