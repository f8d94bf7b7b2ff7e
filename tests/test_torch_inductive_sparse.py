"""The inductive trainer's sparse path (train/inductive.py, graph/union.py):
a batch of graphs as one block-diagonal graph through the flash kernels'
plain versions or the csr backend, against the dense path and the
benchmark's plain reference (benchmark/reference/gat.py); the unions'
layout and static shapes; the spans and counters."""

import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import compare
from benchmark.reference import gat as ref_gat
from benchmark.reference.han import Record
from han_tpu_torch.datasets.ppi import MultiGraphDataset, ppi_synthetic
from han_tpu_torch.graph.bcsr import BCSRGraph
from han_tpu_torch.graph.union import GraphUnion, slot_rows, tile_count, union_graph
from han_tpu_torch.ops.flash_gat import tile_adjacency
from han_tpu_torch.train.config import preset
from han_tpu_torch.train.inductive import InductiveTrainer

# graphs of 75-150 nodes with self-loops; D = 40 > 32 on the hidden layers
DS = dict(n_graphs=10, nodes_per_graph=150, n_feats=12, n_labels=5, avg_degree=4.0, seed=3)
MODEL = dict(hid_units=(40, 40), n_heads=(2, 2, 3), residual=True, lr=0.01, l2_coef=1e-3,
             seed=4, batch_size=2, device="cpu")
SETTINGS = {"model": {"n_heads": [2, 2, 3], "residual": True, "attn_drop": 0.0,
                      "ffd_drop": 0.0},
            "train": {"lr": 0.01, "l2_coef": 1e-3}}
BETA1 = 0.9
# Limits of the benchmark's measures (benchmark/compare.py: the relative
# loss gaps, and by leaf the gradient's and the three steps' change's norm
# gaps, the change over the elements whose gradient is not round-off).
# The sparse paths and the dense path sum the same float32 products in
# other orders (a segment sum or the flash plain versions' exp(z − lse)
# against a dense masked row; one union against a loop of graphs), and the
# reference takes a matmul a head: the largest readings, over flash, csr
# and auto (and csr on BCSR tiles, which took the csr route) against the
# dense path and the reference, are loss 1.7e-7,
# gradient 6.1e-8, update 7.7e-7, evaluation 8.7e-8. The reference in TF32
# products reads loss 1.8e-6, gradient 3.8e-5, update 1.1e-3
# (test_tf32_reference_departs). Each limit sits 3-16x above the first
# readings and 3x or more below TF32's.
LIMITS = {"loss_gap": 6e-7, "grad_gap": 1e-6, "update_gap": 1e-5, "eval_gap": 6e-7}


@pytest.fixture(scope="module")
def ds():
    return ppi_synthetic(**DS)


def three_steps(t: InductiveTrainer) -> dict:
    """Three Adam steps of epoch 0's order and an evaluation of the
    validation graphs: the losses, the first gradient (Adam's first moment
    over 1 − β₁), the parameters after and the evaluation loss."""
    p0 = {k: v.detach().clone() for k, v in t.model.named_parameters()}
    losses, grads = [], None
    for i, batch in enumerate(itertools.islice(t.batches("train", t.order_rng(0)), 3)):
        losses.append(float(t.train_step(*batch)))
        if i == 0:
            grads = {k: t.opt.state[v]["exp_avg"].clone() / (1 - BETA1)
                     for k, v in t.model.named_parameters()}
    return {"p0": p0, "losses": losses, "grads": grads,
            "params": {k: v.detach().clone() for k, v in t.model.named_parameters()},
            "eval": t.evaluate("val")["loss"]}


def reference_run(ds: MultiGraphDataset, t: InductiveTrainer, p0: dict, products="f32"):
    """The reference's record of the same steps and evaluation."""
    def graph(g):
        n = int(ds.node_mask[g].sum())
        return ref_gat.Graph(x=torch.from_numpy(ds.features[g, :n]),
                             labels=torch.from_numpy(ds.labels[g, :n]),
                             adj=torch.from_numpy(ds.adj[g, :n, :n]) | torch.eye(n, dtype=bool))

    train, val = ds.graph_ids("train"), ds.graph_ids("val")
    order = np.arange(len(train))
    t.order_rng(0).shuffle(order)
    steps = [ref_gat.Batch([graph(train[i]) for i in order[s:s + 2]], 2) for s in (0, 2, 4)]
    evals = [ref_gat.Batch([graph(g) for g in val[s:s + 2]], 2) for s in range(0, len(val), 2)]
    return ref_gat.follow(SETTINGS, p0, steps, evals={3: evals}, gen_seed=0, device="cpu",
                          products=products)


def gaps(run: dict, want) -> dict:
    """benchmark/compare.py's numbers of ``run`` against ``want`` (a run or
    a reference record)."""
    if isinstance(want, dict):
        want = record(want)
    return compare.numbers(record(run), want, run["p0"])


def record(run: dict) -> Record:
    return Record(run["losses"], run["grads"], run["params"], [run["eval"]])


@pytest.fixture(scope="module")
def dense_run(ds):
    t = InductiveTrainer(ds, impl="dense", **MODEL)
    return t, three_steps(t)


@pytest.mark.parametrize("impl, route, fmt", [("dense", "dense", "dense"),
                                              ("csr", "csr", "csr"),
                                              ("flash", "flash", "bcsr"),
                                              ("auto", "flash", "bcsr")])
def test_impl_picks_the_route(ds, impl, route, fmt):
    """impl alone picks the path: dense batches hold the padded (B, N, N)
    adjacency, the others one union of the route's format, whose layers
    all run the route (auto: flash on these graphs' tiles)."""
    t = InductiveTrainer(ds, impl=impl, **MODEL)
    assert (t.route, t.graph_format) == (route, fmt)
    assert all(layer.impl == route for layer in t.model.layers)
    batch = next(t.batches("train"))
    n_max = ds.node_mask.shape[1]
    assert any(b.shape == (2, n_max, n_max) for b in batch) == (impl == "dense")
    if impl != "dense":
        assert union_graph(batch[:-3], fmt).n_nodes == 2 * slot_rows(ds.node_mask.shape[1])


@pytest.mark.parametrize("impl", ["flash", "csr", "auto"])
def test_sparse_matches_dense_and_reference(ds, dense_run, impl):
    """Loss, each leaf's first gradient and its change over three steps,
    and the evaluation loss: the sparse path against the dense path and
    the reference, from the same initial weights."""
    t = InductiveTrainer(ds, impl=impl, **MODEL)
    assert t.route == ("csr" if impl == "csr" else "flash")
    got = three_steps(t)
    _, dense = dense_run
    for k in dense["p0"]:
        assert torch.equal(got["p0"][k], dense["p0"][k])
    for want in (dense, reference_run(ds, t, got["p0"])):
        nums = gaps(got, want)
        assert all(nums[k] <= v for k, v in LIMITS.items()), nums


def test_tf32_reference_departs(ds, dense_run):
    """The reference in TF32 products (the nearest precision below float32)
    fails the limits that the program's paths meet, by the gradient and the
    update."""
    t, run = dense_run
    nums = gaps(run, reference_run(ds, t, run["p0"], products="tf32"))
    assert nums["grad_gap"] > LIMITS["grad_gap"] and nums["update_gap"] > LIMITS["update_gap"]


def test_union_is_block_diagonal(ds):
    """Graphs a and b in slots 0 and 1: the union's tiles hold exactly each
    graph's edges on its own diagonal block, the tiles past the used ones
    are blank and in no map; the csr union's edges are the same, its pads
    the sentinel."""
    ids = ds.graph_ids("train")
    edges = [ds.graph_edges(g) for g in ids]
    rows = slot_rows(ds.node_mask.shape[1], 128, 128)
    bcsr = GraphUnion(edges, slots=2, rows=rows, fmt="bcsr")
    csr = GraphUnion(edges, slots=2, rows=rows, fmt="csr")
    for sel in ([0, 3], [5, 1], [2, -1]):
        want = torch.zeros((2 * rows, 2 * rows), dtype=torch.bool)
        n_edges = 0
        for i, g in enumerate(sel):
            if g >= 0:
                r, c = (torch.from_numpy(a.astype(np.int64)) for a in edges[g])
                want[r + i * rows, c + i * rows] = True
                n_edges += r.numel()
        tensors = bcsr.union(sel)
        graph = union_graph(tensors, "bcsr")
        assert isinstance(graph, BCSRGraph) and graph.n_nodes == 2 * rows
        assert torch.equal(tile_adjacency(graph), want)
        used = int(sum(bcsr.n_tiles[g] for g in sel if g >= 0))
        assert graph.tiles.shape[0] == bcsr.budget > used
        assert not graph.tiles[used:].any()
        for count, tile in ((graph.fwd_count, graph.fwd_tile), (graph.bwd_count, graph.bwd_tile)):
            live = torch.arange(tile.shape[1])[None, :] < count[:, None].long()
            assert int(tile[live].max()) < used
        assert bcsr.counts(sel) == (used * 128 * 128, n_edges)
        g2 = union_graph(csr.union(sel), "csr")
        got = torch.zeros_like(want)
        real = g2.row_idx < 2 * rows
        got[g2.row_idx[real], g2.col_idx[real]] = True
        assert torch.equal(got, want) and int(real.sum()) == n_edges
        assert (g2.col_idx[~real] == 2 * rows).all() and g2.n_edges == csr.budget
        assert int(g2.row_ptr[-1]) == n_edges


def test_batches_of_other_graphs_have_one_shape(ds):
    """Two batches of different graphs give the same shapes: one capture
    key, one train step and one evaluation step a split."""
    t = InductiveTrainer(ds, impl="flash", **MODEL)
    batches = list(t.batches("train", t.order_rng(0)))
    assert len(batches) >= 2
    shapes = {tuple(tuple(x.shape) for x in b) for b in batches}
    assert len(shapes) == 1
    t.fit(epochs=1, log=lambda rec: None)
    assert len(t._train_steps) == 1
    assert {tuple(x.shape) for x in next(t.batches("val"))} != set(shapes.pop())


def test_mesh_share_is_a_union_of_its_own(ds):
    """On a graph axis of two ranks each rank's share of a batch is a
    union of one slot (this process: rank 0's)."""
    from torch_parallel_ranks import stand_in_mesh

    t = InductiveTrainer(ds, impl="flash", **MODEL, mesh=stand_in_mesh(2))
    batch = next(t.batches("train"))
    assert union_graph(batch[:7], "bcsr").n_nodes == slot_rows(ds.node_mask.shape[1], 128, 128)
    assert batch[7].shape[0] == 1


def test_edges_only_dataset_keeps_no_dense_adjacency(ds):
    """A dataset of edge lists alone trains on the sparse path without
    building (G, N_max, N_max), and equals the dense-adjacency dataset."""
    lists = MultiGraphDataset(adj=None, features=ds.features, labels=ds.labels,
                              node_mask=ds.node_mask, graph_split=ds.graph_split,
                              edges=[ds.graph_edges(g) for g in range(ds.n_graphs)])
    a = InductiveTrainer(lists, impl="flash", **MODEL)
    b = InductiveTrainer(ds, impl="flash", **MODEL)
    assert a.evaluate("val") == b.evaluate("val") and lists.adj is None
    assert np.array_equal(lists.dense_adj(), ds.adj)


def test_preset_takes_the_sparse_path(ds):
    cfg = preset("ppi")
    assert (cfg.data.graph_format, cfg.model.impl, cfg.train.batch_size) == ("bcsr", "auto", 2)
    cfg.model.hid_units, cfg.train.checkpoint_dir = (16, 16), ""
    t = InductiveTrainer.from_config(ds, cfg, device="cpu")
    assert t.route == "flash" and t.batch_size == 2
    assert all(layer.impl == "flash" for layer in t.model.layers)


def test_spans_and_counters(ds):
    """A sparse epoch under the profiler opens han.next_batch a batch,
    han.train_step a train step and han.eval_step an evaluation step; the
    counters sum the unions' tile elements and real edges."""
    t = InductiveTrainer(ds, impl="flash", **MODEL)
    p = profile(activities=[ProfilerActivity.CPU])
    p.start()
    try:
        t.fit(epochs=1, log=lambda rec: None)
    finally:
        p.stop()
    names = [e.name for e in p.events()]
    n_train, n_val, n_test = (-(-len(ds.graph_ids(s)) // 2) for s in ("train", "val", "test"))
    assert names.count("han.train_step") == n_train
    assert names.count("han.eval_step") == n_val + n_test
    assert names.count("han.next_batch") == n_train + n_val + n_test
    graphs = np.concatenate([ds.graph_ids(s) for s in ("train", "val", "test")])
    tiles = sum(tile_count(*ds.graph_edges(g), 128, 128) for g in graphs)
    edges = sum(int(ds.adj[g].sum()) for g in graphs)
    assert t.counters == {"tile_elems": tiles * 128 * 128, "edges": edges}
