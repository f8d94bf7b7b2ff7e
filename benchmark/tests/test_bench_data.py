"""The generators and sampler rules: the frozen copies against the
program's own at small sizes (the yardstick's inputs are the program's
inputs today), and the stated edge counts of ``community_pairs``."""

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.generators import community_pairs, scale_dataset
from benchmark.reference import sampling
from benchmark.reference.samplers import device as device_rule
from han_tpu_torch.graph import synthetic
from han_tpu_torch.graph.build import with_self_loops
from han_tpu_torch.train import sampled as prog_sampled


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_scale_dataset_is_the_programs(seed):
    args = dict(n_metapaths=2, n_feats=8, n_classes=5, n_train=40, n_val=16, n_test=32)
    cols, *rest = scale_dataset.scale_arrays(640, 9, **args, seed=seed)
    theirs = synthetic.scale_dataset(640, 9, **args, seed=seed)
    for c, b in zip(cols, theirs.metapath_adjs):
        _same_csr(scale_dataset.big_csr(c), b)
    for x, y in zip(rest, (theirs.features, theirs.labels, theirs.train_mask,
                           theirs.val_mask, theirs.test_mask)):
        np.testing.assert_array_equal(x, y)


DBLP_LIKE = dict(generator="community_pairs", n_nodes=257, n_feats=30, n_classes=4,
                 edges_with_self_loops=[257 + 60, 257 + 9000, 257 + 50000],
                 homophily=[0.85, 0.65, 0.55], train_per_class=10, n_val=20)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_community_pairs_has_the_stated_edges(seed):
    inp = data.make_inputs(DBLP_LIKE, seed)
    for a, edges in zip(inp.adjs, DBLP_LIKE["edges_with_self_loops"]):
        assert a.nnz + inp.n_nodes == edges
        assert (a != a.T).nnz == 0 and a.diagonal().sum() == 0
        assert set(np.unique(a.data)) == {1.0}
    # a sparse meta-path keeps about its homophily inside the communities
    comm = (np.arange(257) * 16) // 257
    coo = inp.adjs[0].tocoo()
    assert 0.7 < np.mean(comm[coo.row] == comm[coo.col]) <= 1.0
    assert inp.train_mask.sum() == 40 and inp.val_mask.sum() == 20
    assert not (inp.train_mask & inp.val_mask).any()
    assert (inp.train_mask | inp.val_mask | inp.test_mask).all()
    again = data.make_inputs(DBLP_LIKE, seed)
    for a, b in zip(inp.adjs, again.adjs):
        _same_csr(a, b)
    np.testing.assert_array_equal(inp.features, again.features)


def test_community_pairs_refuses_an_odd_count():
    with pytest.raises(ValueError):
        data.make_inputs({**DBLP_LIKE, "edges_with_self_loops": [258, 300, 400]}, 1)


def test_metapath_pairs_fills_a_dense_graph():
    comm = (np.arange(40) * 4) // 40
    a = community_pairs.metapath_pairs(np.random.default_rng(3), comm, 40 * 39 // 2, 0.9)
    assert a.nnz == 40 * 39


@pytest.mark.parametrize("gen", ["community_pairs", "scale_dataset"])
def test_neighbours_are_the_samplers_rows(gen):
    if gen == "community_pairs":
        cfg = DBLP_LIKE
    else:
        cfg = dict(generator=gen, n_nodes=640, avg_degree=9, n_metapaths=2, n_feats=4,
                   n_classes=3, n_train=32, n_val=8, n_test=8)
    inp = data.make_inputs(cfg, 3)
    for p, a in enumerate(inp.adjs):
        view = prog_sampled._ScipyCSRView(with_self_loops(a))
        for u in range(0, inp.n_nodes, 7):
            row = view.col_idx[view.row_ptr[u]:view.row_ptr[u + 1]]
            np.testing.assert_array_equal(inp.neighbours(p, u), row)


@pytest.mark.parametrize("sample_seed", [0, 65_537 * 2 + 9, 2 ** 31 + 3])
def test_device_block_is_the_device_samplers(sample_seed):
    inp = data.make_inputs(dict(generator="scale_dataset", n_nodes=3000, avg_degree=20,
                                n_metapaths=2, n_feats=4, n_classes=3, n_train=64, n_val=8,
                                n_test=8), 5)
    b, f = 40, 6
    seeds = np.random.default_rng(4).permutation(3000)[:b].astype(np.int32)
    valid = np.ones(b, bool)
    valid[-3:] = False
    for p, a in enumerate(inp.adjs):
        view = prog_sampled._ScipyCSRView(with_self_loops(a))
        key = prog_sampled.sample_key(
            torch.tensor([sample_seed & 0xFFFFFFFF], dtype=torch.int64), p)
        nbr, _, nodes, _ = prog_sampled._device_sample_block(
            torch.from_numpy(view.row_ptr), torch.from_numpy(view.col_idx),
            torch.from_numpy(seeds), torch.from_numpy(valid), key, fanout=f, hops=1,
            block_size=b * (f + 1))
        ours_nodes, ours_nbr = device_rule.block(inp, p, seeds, valid, f, b * (f + 1),
                                                 sample_seed, "cpu")
        np.testing.assert_array_equal(ours_nodes, nodes.numpy())
        np.testing.assert_array_equal(ours_nbr, nbr.numpy())


class _T:  # the trainer's batch rule needs only its config and batch size
    batch_size = 64

    class cfg:
        class train:
            seed = 2 ** 31 + 1


@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_are_the_trainers(shuffle):
    idx = np.arange(5, 205)
    theirs = list(prog_sampled.SampledTrainer._seed_batches(_T, idx, shuffle=shuffle,
                                                            epoch=0))
    if shuffle:
        ours = sampling.epoch_batches(idx, 64, _T.cfg.train.seed, 0)
        assert [x[2] for x in ours] == list(range(len(ours)))
    else:
        ours = sampling.ordered_batches(idx, 64)
    assert len(ours) == len(theirs)
    for (s, v, *_), (s2, v2) in zip(ours, theirs):
        np.testing.assert_array_equal(s, s2)
        np.testing.assert_array_equal(v, v2)
