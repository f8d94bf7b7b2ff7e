"""The sampled path of han_tpu_torch against han_tpu: the copied C++ sampler
and the generators, the device sampler, the port's counterparts of
tests/test_sampled_trainer.py's exactness checks, and the slice as a whole
(three sampled train steps with ell_fused in both packages, on the same
host-sampled blocks and the same flax initial weights)."""

import filecmp
import runpy

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from han_tpu import native as jnative  # noqa: E402
from han_tpu.graph import sampling as jsampling  # noqa: E402
from han_tpu.graph import synthetic as jsyn  # noqa: E402
from han_tpu.train import sampled as jsampled  # noqa: E402
from han_tpu.train.config import preset as jpreset  # noqa: E402
from han_tpu_torch import native as tnative  # noqa: E402
from han_tpu_torch.graph import sampling as tsampling  # noqa: E402
from han_tpu_torch.graph import synthetic as tsyn  # noqa: E402
from han_tpu_torch.graph.build import metapath_to_csr  # noqa: E402
from han_tpu_torch.graph.containers import ell_from_csr  # noqa: E402
from han_tpu_torch.nn.convert import params_from_flax  # noqa: E402
from han_tpu_torch.train import sampled as tsampled  # noqa: E402
from han_tpu_torch.train.config import preset as tpreset  # noqa: E402
from han_tpu_torch.train.preempt import PreemptionGuard  # noqa: E402
from han_tpu_torch.train.trainer import MetricLogger, run  # noqa: E402


@pytest.fixture(scope="module")
def small_ds():
    return jsyn.planted_hetero(
        n_nodes=128, n_feats=24, n_classes=3, n_metapaths=2,
        avg_degree=6.0, train_per_class=16, n_val=24, seed=3)


def small_cfg(preset, impl="ell", epochs=5):
    cfg = preset("acm")
    cfg.model.impl = impl
    cfg.model.hid_units = (8,)
    cfg.model.n_heads = (4, 1)
    cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
    cfg.train.epochs, cfg.train.patience = epochs, 50
    cfg.train.log_file = ""
    return cfg


def make_trainer(ds, *, impl="ell", epochs=5, **kw):
    return tsampled.SampledTrainer(ds, small_cfg(tpreset, impl, epochs), device="cpu",
                                   logger=MetricLogger(echo=False), **kw)


def max_degree(ds):
    # +1: the trainer adds self-loops, as the full-graph path does
    return 1 + max(int(np.diff(a.indptr).max()) for a in ds.metapath_adjs)


def full_graph_logits(t, ds):
    """The port's model on the whole graph (ell over full ELL lists)."""
    graphs = [ell_from_csr(metapath_to_csr(a)) for a in ds.metapath_adjs]
    x = torch.from_numpy(np.asarray(ds.features, np.float32))
    with torch.no_grad():
        return t.model(graphs, [x, x])[0]


# -- copied host code ---------------------------------------------------------


def test_native_sampler_is_a_copy():
    """graphcore.cpp is byte for byte han_tpu's, the C++ library builds, and
    every binding gives han_tpu.native's arrays."""
    assert filecmp.cmp("han_tpu_torch/native/graphcore.cpp",
                       "han_tpu/native/graphcore.cpp", shallow=False)
    assert tnative.available() and jnative.available()
    csr = sp.random(300, 300, density=0.05, random_state=4, format="csr")
    rp, ci = csr.indptr.astype(np.int64), csr.indices.astype(np.int32)
    seeds = np.array([3, 7, 7, 150, 299, 0], np.int32)
    for hops, fanout, block in ((1, 4, 30), (2, 3, 80), (2, 50, 300)):
        got = tnative.sample_block(rp, ci, seeds, fanout=fanout, hops=hops,
                                   block_size=block, seed=11)
        want = jnative.sample_block(rp, ci, seeds, fanout=fanout, hops=hops,
                                    block_size=block, seed=11)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tnative.sample_neighbors(rp, ci, 4, seed=2),
                                  jnative.sample_neighbors(rp, ci, 4, seed=2))
    coo = csr.tocoo()
    for fn, args in ((tnative.csr_from_coo, (300, coo.row, coo.col)),
                     (tnative.spgemm_binary, (rp, ci, rp, ci, 300, 300)),
                     (tnative.connected_components, (rp, ci))):
        for g, w in zip(fn(*args), getattr(jnative, fn.__name__)(*args)):
            np.testing.assert_array_equal(g, w)


def test_sample_subgraph_and_neighbor_sampler_match(small_ds):
    jcsr = jsampled._ScipyCSRView(small_ds.metapath_adjs[0])
    tcsr = tsampled._ScipyCSRView(small_ds.metapath_adjs[0])
    seeds = np.arange(10, 26, dtype=np.int32)
    a = jsampling.sample_subgraph(jcsr, seeds, fanout=3, hops=2, block_size=100, seed=5)
    b = tsampling.sample_subgraph(tcsr, seeds, fanout=3, hops=2, block_size=100, seed=5)
    for f in ("nodes", "nbr", "seed_mask"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert b.n_real == a.n_real
    np.testing.assert_array_equal(b.ell().deg.numpy(), np.asarray(a.ell().deg))
    ja = jsampling.NeighborSampler(jcsr, fanout=4, seed=1).sample(3)
    tb = tsampling.NeighborSampler(tcsr, fanout=4, seed=1).sample(3)
    np.testing.assert_array_equal(tb.nbr.numpy(), np.asarray(ja.nbr))
    assert tb.n_edges == ja.n_edges


def test_big_csr_is_bench_scale_copy():
    """graph/synthetic.big_csr is bit-identical to scripts/bench_scale.py's;
    scale_dataset's meta-paths are big_csr at seeds seed + 31·p, with the
    requested splits."""
    ref = runpy.run_path("scripts/bench_scale.py", run_name="not_main")["big_csr"]
    for n, deg, seed in ((2000, 12, 0), (1500, 7, 31)):
        a, b = ref(n, deg, seed=seed), tsyn.big_csr(n, deg, seed=seed)
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(b, attr), getattr(a, attr))
            assert getattr(b, attr).dtype == getattr(a, attr).dtype
    ds = tsyn.scale_dataset(1500, 7, n_train=300, n_val=100, n_test=200, seed=0)
    np.testing.assert_array_equal(ds.metapath_adjs[1].indices, ref(1500, 7, seed=31).indices)
    assert ds.train_mask[:300].all() and ds.val_mask[-100:].all() and ds.test_mask[300:500].all()
    assert (ds.train_mask.sum(), ds.val_mask.sum(), ds.test_mask.sum()) == (300, 100, 200)
    assert ds.features.shape == (1500, 64) and ds.labels.sum(1).tolist() == [1.0] * 1500


# -- device sampler -----------------------------------------------------------


def test_device_sample_block_exhaustive_matches_jax(small_ds):
    """With fanout >= max degree the device sampler takes every neighbor, so
    the port's blocks equal han_tpu's whatever the random streams (the
    port's counter hash, han_tpu's jax.random key): nbr, deg, nodes and the
    edge count, one and two hops, with masked seeds."""
    csr = tsampled._ScipyCSRView(small_ds.metapath_adjs[1])
    f = max_degree(small_ds)
    seeds = np.array([0, 5, 9, 33, 64, 127], np.int32)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    for hops in (1, 2):
        block = sum(6 * f ** h for h in range(hops + 1)) + 3
        want = jsampled._device_sample_block(
            jnp.asarray(csr.row_ptr, jnp.int32), jnp.asarray(csr.col_idx), jnp.asarray(seeds),
            jnp.asarray(valid), jax.random.PRNGKey(0), fanout=f, hops=hops, block_size=block)
        got = tsampled._device_sample_block(
            torch.from_numpy(csr.row_ptr), torch.from_numpy(csr.col_idx),
            torch.from_numpy(seeds), torch.from_numpy(valid),
            tsampled.sample_key(torch.tensor(0, dtype=torch.int32), 0), fanout=f,
            hops=hops, block_size=block)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_offsets_stay_below_degree():
    """The draw fed u = 1 - 2**-24 (the largest float32 below 1) at degrees
    from 2**24 up, where float32 spaces its integers 2 to 256 apart: every
    offset stays in [deg - 256, deg). At u = 1 the clamp, not the rounding,
    keeps the offset at deg - 1."""
    u = torch.full((1, 1), 1.0 - 2.0 ** -24)
    degs = torch.cat([torch.arange(2 ** 24, 2 ** 24 + 64),
                      torch.arange(2 ** 31 - 64, 2 ** 31)])[:, None]
    off = tsampled.sample_offsets(u, degs)
    assert bool((off < degs).all()) and bool((off >= degs - 256).all())
    degs = torch.tensor([[1], [7], [2 ** 24 + 3]])
    np.testing.assert_array_equal(tsampled.sample_offsets(torch.ones(1, 1), degs),
                                  degs - 1)


# -- the trainer --------------------------------------------------------------


def test_train_steps_match_jax(small_ds):
    """The slice as a whole: han_tpu's SampledTrainer(impl="ell_fused", its
    Pallas kernel interpreted) and the port run three train steps on the
    same seed batches and the same host-sampled blocks (asserted equal),
    from the same flax initial weights, dropout off. Loss and accuracy agree
    at rtol 1e-4 (Adam amplifies float differences of small gradients)."""
    import tempfile

    jcfg = small_cfg(jpreset, "ell_fused")
    jcfg.train.checkpoint_dir = tempfile.mkdtemp()
    jt = jsampled.SampledTrainer(small_ds, jcfg, batch_size=16, fanout=4)
    tt = make_trainer(small_ds, impl="ell_fused", batch_size=16, fanout=4)
    train_idx = np.where(small_ds.train_mask)[0]
    jseeds = list(jt._seed_batches(train_idx, shuffle=True, epoch=0))[:3]
    tseeds = list(tt._seed_batches(train_idx, shuffle=True, epoch=0))[:3]
    params = opt_state = None
    rng = jax.random.PRNGKey(0)
    for bi, ((js, jv), (ts, tv)) in enumerate(zip(jseeds, tseeds)):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tv, jv)
        jb = jt._make_batch(js, jv, sample_seed=bi)
        tb = tt._make_batch(ts, tv, sample_seed=bi)
        tgraphs, txs, _, tmask = tt._host_blocks(tb[0].flat())
        for jg, tg, jx, tx in zip(jb[0], tgraphs, jb[1], txs):
            np.testing.assert_array_equal(tg.nbr.numpy(), np.asarray(jg.nbr))
            np.testing.assert_array_equal(tg.deg.numpy(), np.asarray(jg.deg))
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jb[3]))
        if params is None:
            params = jt._init_params_from(jax.random.PRNGKey(0), jb[0], jb[1])
            opt_state = jt.tx.init(params)
            tt.model.load_state_dict(params_from_flax(params))
        params, opt_state, rng, jloss, jacc = jt._train_step(params, opt_state, rng, *jb)
        tloss, tacc, _ = tt._train_step(*tb)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, err_msg=f"step {bi}")
        np.testing.assert_allclose(float(tacc), float(jacc), rtol=1e-4, err_msg=f"step {bi}")
    assert tt.sampled_edge_count == jt.sampled_edge_count > 0


@pytest.mark.parametrize("sampler,resident", [("host", True), ("host", False),
                                              ("device", True)])
def test_seed_rows_match_full_graph(small_ds, sampler, resident):
    """With fanout >= max degree and hops = #layers, the sampled block gives
    the seeds exactly their full neighborhood, so their logits equal the
    full-graph forward (port of tests/test_sampled_trainer.py:37-61, plus
    streamed (non-resident) features and the device sampler's tree
    blocks)."""
    f = max_degree(small_ds)
    t = make_trainer(small_ds, batch_size=16, fanout=f, block_size=16 * (f + 1),
                     sampler=sampler, resident_features=resident)
    seeds = np.arange(16, dtype=np.int32)
    graphs, xs, _, _, _ = t._materialize(*t._make_batch(seeds, np.ones(16, bool), 0))
    assert type(graphs[0]).__name__ == ("TreeEllGraph" if sampler == "device" else "EllGraph")
    with torch.no_grad():
        block_logits = t.model(graphs, xs)[0]
    np.testing.assert_allclose(block_logits[:16].numpy(),
                               full_graph_logits(t, small_ds)[seeds].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_exact_eval_matches_full_graph(small_ds):
    """evaluate(exact=True) builds full-neighborhood blocks (fanout = max
    degree), so the metric equals full-graph evaluation whatever the
    trainer's own small fanout (port of
    tests/test_sampled_trainer.py:64-94)."""
    t = make_trainer(small_ds, batch_size=16, fanout=3)
    val_idx = np.where(small_ds.val_mask)[0]
    l_s, _ = t.evaluate(val_idx)
    l_e, a_e = t.evaluate(val_idx, exact=True)
    logits = full_graph_logits(t, small_ds)[val_idx]
    lbl = torch.from_numpy(small_ds.labels[val_idx])
    ref_l = float(-(lbl * torch.log_softmax(logits, -1)).sum(-1).mean())
    ref_a = float((logits.argmax(-1) == lbl.argmax(-1)).float().mean())
    np.testing.assert_allclose(l_e, ref_l, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a_e, ref_a, rtol=1e-6)
    assert abs(l_s - ref_l) > 1e-6  # the sampled metric really is sampled
    assert t.exact_eval_plan(max_block=64) is None


def test_device_sampler_fit_learns_and_flushes_edge_counts(small_ds):
    """fit() with the device sampler and ell_fused dropout on: finite
    losses, learning above chance, and the device edge counts in their
    train and evaluation accumulators, all folded into sampled_edge_count
    (han_tpu keeps a pending list)."""
    cfg = small_cfg(tpreset, "auto", epochs=12)
    cfg.model.attn_drop = cfg.model.ffd_drop = 0.3
    t = tsampled.SampledTrainer(small_ds, cfg, batch_size=24, fanout=6, sampler="device",
                                device="cpu", logger=MetricLogger(echo=False))
    assert cfg.model.impl == "ell_fused"  # auto trains on the fused kernel
    result = t.fit()
    assert np.isfinite(result["epoch_train_loss"]).all()
    assert result["test_acc"] > 0.55  # 3 classes → chance is 0.33
    train, ev = t._edge_sums.tolist()  # the train and evaluation accumulators
    assert train > 0 and ev > 0 and t.sampled_edge_count == train + ev
    assert result["edges_heads_per_s"] > 0


@pytest.mark.parametrize("dtype,impl", [("float32", "ell_fused"), ("bfloat16", "ell_fused")])
def test_auto_takes_ell_fused_only_where_the_kernel_takes_the_dtype(small_ds, dtype, impl):
    """impl="auto" asks ops/ell_fused.kernel_takes (the feature dtype,
    never the device): float32 and bf16 features train on ell_fused (han_tpu's
    auto takes ell, for a TPU compile reason); either fit() runs."""
    from han_tpu_torch.ops.ell_fused import kernel_takes

    cfg = small_cfg(tpreset, "auto", epochs=2)
    cfg.model.dtype = dtype
    t = tsampled.SampledTrainer(small_ds, cfg, batch_size=24, fanout=6, device="cpu",
                                logger=MetricLogger(echo=False))
    assert cfg.model.impl == impl
    assert kernel_takes(getattr(torch, dtype)) == (impl == "ell_fused")
    result = t.fit()
    assert len(result["epoch_train_loss"]) == 2 and np.isfinite(result["epoch_train_loss"]).all()
    assert np.isfinite(result["test_loss"])


def test_run_routes_sampled_training_and_rejects_unported(tmp_path, monkeypatch):
    """scripts/train_torch.py --set train.sampled=true reaches the sampled
    trainer through run(); guard= and fit(resume=True) are ported (with no
    checkpoint the run starts fresh); steps_per_call > 1 with the host
    sampler raises ValueError, as in han_tpu. mesh.graph_axis = 2 routes to
    DPSampledTrainer on the graph axis' mesh (a stand-in of 2 ranks here)
    with the sampler passed through, so the device sampler raises
    NotImplementedError there (han_tpu's run() drops it)."""
    main = runpy.run_path("scripts/train_torch.py", run_name="not_main")["main"]
    result = main(["--device", "cpu", "--dataset", "acm_synthetic", "--set", "train.sampled=true",
                   "--set", "train.batch_size=64", "--set", "train.epochs=1",
                   "--set", "model.ffd_drop=0.0"])
    assert len(result["epoch_train_loss"]) == 1 and np.isfinite(result["test_loss"])
    ds = jsyn.planted_hetero(n_nodes=64, n_feats=8, n_classes=2, n_metapaths=1,
                             avg_degree=4.0, train_per_class=8, n_val=8, seed=0)
    cfg = small_cfg(tpreset)
    cfg.train.checkpoint_dir, cfg.train.epochs = str(tmp_path), 1
    res = tsampled.SampledTrainer(ds, cfg, batch_size=8, fanout=3, device="cpu",
                                  guard=PreemptionGuard(install=False)).fit(resume=True)
    assert np.isfinite(res["test_loss"]) and len(res["epoch_train_loss"]) == 1
    with pytest.raises(ValueError, match="steps_per_call > 1 needs sampler='device'"):
        tsampled.SampledTrainer(ds, cfg, batch_size=8, fanout=3, steps_per_call=2,
                                device="cpu")
    from torch_parallel_ranks import stand_in_mesh

    from han_tpu_torch.train import trainer as ttrainer

    built = []
    monkeypatch.setattr(ttrainer, "make_mesh", stand_in_mesh)
    monkeypatch.setattr(tsampled.DPSampledTrainer, "fit", lambda self: built.append(self) or {})
    cfg.train.sampled, cfg.mesh.graph_axis, cfg.train.batch_size = True, 2, 8
    assert run(cfg, ds, device="cpu") == {}
    assert isinstance(built[0], tsampled.DPSampledTrainer) and built[0].n_shards == 2
    assert built[0].block_size == 4 * (cfg.train.fanout + 1) ** 1
    cfg.train.sampler = "device"
    with pytest.raises(NotImplementedError, match="device sampler"):
        run(cfg, ds, device="cpu")


# -- steps_per_call and the descriptor-keyed device sampler ------------------


def test_device_sampler_key_comes_from_descriptor(small_ds):
    """The device sampler keys its offsets from the sample seed in the
    descriptor (its last element), on the device: a sample seed gives the
    same blocks whichever batches were sampled before, and another seed
    gives other blocks at a fanout below the degree. The draws are
    uniforms in [0, 1)."""
    t = make_trainer(small_ds, batch_size=16, fanout=2, sampler="device")
    seeds, valid = np.arange(16, dtype=np.int32), np.ones(16, bool)
    blocks = {}
    for order in ((3, 5), (5, 3)):
        for sample_seed in order:
            desc = t._make_batch(seeds, valid, sample_seed)[0]
            assert int(desc.packed[-1]) == sample_seed
            graphs, xs, _, _, ne = t._materialize(desc, None, None, None)
            got = [g.nbr.numpy() for g in graphs] + [x.numpy() for x in xs] + [int(ne)]
            if sample_seed in blocks:
                for a, b in zip(got[:-1], blocks[sample_seed][:-1]):
                    np.testing.assert_array_equal(a, b)
                assert got[-1] == blocks[sample_seed][-1]
            blocks[sample_seed] = got
    assert any((a != b).any() for a, b in zip(blocks[3][2:4], blocks[5][2:4]))
    u = tsampled.sample_uniform(tsampled.sample_key(torch.tensor([7], dtype=torch.int32), 1),
                                0, 64, 16, "cpu")
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert 0.4 < float(u.mean()) < 0.6 and torch.unique(u).numel() > 1000


class _Rows(MetricLogger):
    """Keeps the per-epoch (epoch, train loss, val loss) rows of fit()."""

    def __init__(self):
        super().__init__("", echo=False)
        self.rows = []

    def log(self, rec):
        if "train_loss" in rec:
            self.rows.append((rec["epoch"], rec["train_loss"], rec["val_loss"]))


def test_device_sampler_chunked_dispatch_matches(small_ds):
    """steps_per_call = 3 runs C descriptors per dispatch (on the CPU, the
    same body a captured graph holds, eagerly): the (epoch, train loss,
    val loss) rows equal those of single-step dispatch (port of
    tests/test_sampled_trainer.py:367-394, its tolerances), with dropout
    on, and the chunker yields full stacks then the tail as single
    descriptors."""
    rows = {}
    for spc in (1, 3):
        cfg = small_cfg(tpreset, epochs=4)
        cfg.model.attn_drop = cfg.model.ffd_drop = 0.3
        log = _Rows()
        # 48 train nodes in batches of 10: a chunk of 3, then 2 single steps
        t = tsampled.SampledTrainer(small_ds, cfg, batch_size=10, fanout=6, sampler="device",
                                    steps_per_call=spc, device="cpu", logger=log)
        t.fit()
        rows[spc] = log.rows
        if spc == 3:
            assert sorted(t._train_steps) == [1, 3]  # chunks of 3 and the tail
    assert rows[1] and len(rows[1]) == len(rows[3])
    for (e1, l1, v1), (e3, l3, v3) in zip(rows[1], rows[3]):
        assert e1 == e3
        np.testing.assert_allclose(l1, l3, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(v1, v3, rtol=1e-6, atol=1e-7)
    t = make_trainer(small_ds, batch_size=8, fanout=6, sampler="device", steps_per_call=3)
    batches = [(bi, t._make_batch(np.full(8, bi, np.int32), np.ones(8, bool), bi))
               for bi in range(7)]
    chunks = list(t._chunked(iter(batches)))
    assert [bi for bi, _ in chunks] == [2, 5, 6]
    assert [tuple(b[0].packed.shape) for _, b in chunks] == [(3, 17), (3, 17), (17,)]
    np.testing.assert_array_equal(chunks[1][1][0].packed[2].numpy(),
                                  batches[5][1][0].packed.numpy())


def test_chunked_steps_match_jax(small_ds):
    """The port against han_tpu at steps_per_call = 3: two dispatches of 3
    device-sampled steps from the same flax initial weights, fanout >= max
    degree (so both samplers take every neighbor: the same blocks whatever
    their keys), dropout off, the same packed descriptors (asserted
    equal). The per-step losses agree at rtol 1e-5, the accuracies at rtol
    1e-6."""
    import tempfile

    f = max_degree(small_ds)
    jcfg = small_cfg(jpreset)
    jcfg.train.checkpoint_dir = tempfile.mkdtemp()
    jt = jsampled.SampledTrainer(small_ds, jcfg, batch_size=8, fanout=f, sampler="device",
                                 steps_per_call=3)
    tt = make_trainer(small_ds, batch_size=8, fanout=f, sampler="device", steps_per_call=3)
    train_idx = np.where(small_ds.train_mask)[0]
    seeds = list(tt._seed_batches(train_idx, shuffle=True, epoch=0))[:6]
    jpacks, tbatches = [], []
    for bi, (s, v) in enumerate(seeds):
        jpacks.append(jt._make_batch(s, v, sample_seed=bi)[0])
        tbatches.append((bi, tt._make_batch(s, v, sample_seed=bi)))
        np.testing.assert_array_equal(tbatches[-1][1][0].packed.numpy(), jpacks[-1])
    params = jt._init_params_from(jax.random.PRNGKey(0), jpacks[0], None)
    init_edges = jt.sampled_edge_count  # han_tpu inits through one host block
    opt_state = jt.tx.init(params)
    tt.model.load_state_dict(params_from_flax(params))
    rng = jax.random.PRNGKey(0)
    for c, (_, tb) in enumerate(tt._chunked(iter(tbatches))):
        stack = np.stack(jpacks[3 * c: 3 * c + 3])
        params, opt_state, rng, jloss, jacc = jt._train_step(params, opt_state, rng, stack,
                                                             None, None, None)
        tloss, tacc = tt._train_call(tb)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5,
                                   err_msg=f"dispatch {c}")
        np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-6,
                                   err_msg=f"dispatch {c}")
    assert tt.flush_sampled_edges() == jt.flush_sampled_edges() - init_edges > 0
