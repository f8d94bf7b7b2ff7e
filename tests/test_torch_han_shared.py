"""The port's last model variants and helpers against han_tpu, on the CPU,
from the same numpy inputs and han_tpu's parameters carried across by
nn/convert.py, dropout off: HANShared (dense and csr, with and without
coefficients), ConstAttention, edge_attention_coefs, the container
conversions, the silhouette (against scikit-learn), entry(), and the dblp
preset trained with arch="han_shared"."""

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from sklearn.metrics import silhouette_score as sk_silhouette  # noqa: E402

import __graft_entry__  # noqa: E402
from han_tpu.graph import bcsr as jbcsr  # noqa: E402
from han_tpu.graph import build as jbuild  # noqa: E402
from han_tpu.graph import containers as jcont  # noqa: E402
from han_tpu.nn import layers as jlayers  # noqa: E402
from han_tpu.nn.models import HANShared as JHANShared  # noqa: E402
from han_tpu.ops import attention as jattn  # noqa: E402
from han_tpu_torch.entry import entry  # noqa: E402
from han_tpu_torch.graph import bcsr as tbcsr  # noqa: E402
from han_tpu_torch.graph import build as tbuild  # noqa: E402
from han_tpu_torch.graph import containers as tcont  # noqa: E402
from han_tpu_torch.nn import layers as tlayers  # noqa: E402
from han_tpu_torch.nn.convert import params_from_flax  # noqa: E402
from han_tpu_torch.nn.models import HANShared as THANShared  # noqa: E402
from han_tpu_torch.ops import attention as tattn  # noqa: E402
from han_tpu_torch.train import trainer as ttrainer  # noqa: E402
from han_tpu_torch.train.config import preset  # noqa: E402
from han_tpu_torch.train.eval_embed import kmeans_eval, silhouette_score  # noqa: E402


@pytest.mark.parametrize("impl", ["dense", "csr"])
@pytest.mark.parametrize("return_coefs", [False, True])
def test_han_shared_matches_flax(tiny_ds, impl, return_coefs):
    ds = tiny_ds
    jfmt = jbuild.metapath_to_dense if impl == "dense" else jbuild.metapath_to_csr
    tfmt = tbuild.metapath_to_dense if impl == "dense" else tbuild.metapath_to_csr
    jgraphs = [jfmt(a) for a in ds.metapath_adjs]
    tgraphs = [tfmt(a) for a in ds.metapath_adjs]
    jmodel = JHANShared(n_classes=ds.n_classes, hid_units=(8,), n_heads=(4, 2), impl=impl,
                        return_coefs=return_coefs)
    params = jmodel.init(jax.random.PRNGKey(0), jgraphs, jnp.asarray(ds.features))
    jouts = jmodel.apply(params, jgraphs, jnp.asarray(ds.features))

    tmodel = THANShared(ds.features.shape[1], ds.n_classes, 2, hid_units=(8,),
                        n_heads=(4, 2), impl=impl, return_coefs=return_coefs)
    tmodel.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        touts = tmodel(tgraphs, torch.from_numpy(ds.features))
    assert len(touts) == len(jouts) == 3 + return_coefs
    for name, t, j in zip(("logits", "embedding", "alphas"), touts, jouts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    if return_coefs:
        for p, (t, j) in enumerate(zip(touts[3], jouts[3])):
            want = (ds.n_nodes, ds.n_nodes) if impl == "dense" else (tgraphs[p].e_pad,)
            assert tuple(t.shape) == want
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
            if impl == "csr":  # each row's coefficients sum to 1
                rows = tgraphs[p].row_idx[: tgraphs[p].n_edges]
                sums = torch.zeros(ds.n_nodes, dtype=t.dtype).index_add_(
                    0, rows, t[: tgraphs[p].n_edges])
                np.testing.assert_allclose(sums.numpy(), 1.0, atol=1e-5)


def test_han_shared_raises_for_coefficients_on_flash(tiny_ds):
    graphs = [tbuild.metapath_to_bcsr(a) for a in tiny_ds.metapath_adjs]
    model = THANShared(tiny_ds.features.shape[1], 3, 2, impl="flash", return_coefs=True)
    with pytest.raises(NotImplementedError):
        model(graphs, torch.from_numpy(tiny_ds.features))


@pytest.mark.parametrize("concat", [True, False])
def test_const_attention_matches_flax(tiny_ds, concat):
    a = tiny_ds.metapath_adjs[0]
    x = tiny_ds.features
    jconv = jlayers.ConstAttention(out_dim=5, num_heads=3, concat_heads=concat)
    jg = jbuild.metapath_to_dense(a)
    params = jconv.init(jax.random.PRNGKey(1), jg, jnp.asarray(x))
    want = np.asarray(jconv.apply(params, jg, jnp.asarray(x)))
    tconv = tlayers.ConstAttention(x.shape[1], 5, 3, concat_heads=concat)
    tconv.load_state_dict(params_from_flax(params))
    got = tconv(tbuild.metapath_to_dense(a), torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError):
        tconv(tbuild.metapath_to_csr(a), torch.from_numpy(x))
    # dropout draws from the run's generator and keeps the shapes
    drop = tlayers.ConstAttention(x.shape[1], 5, 3, attn_drop=0.5, ffd_drop=0.5)
    out = drop(tbuild.metapath_to_dense(a), torch.from_numpy(x), deterministic=False,
               rngs=tlayers.DropoutGenerators(torch.Generator().manual_seed(0)))
    assert out.shape == (x.shape[0], 15) and torch.isfinite(out).all()


def test_edge_attention_coefs_match_jax(tiny_ds):
    rng = np.random.default_rng(0)
    a = tiny_ds.metapath_adjs[1]
    n, k = a.shape[0], 4
    ld, ls = (rng.standard_normal((n, k)).astype(np.float32) for _ in range(2))
    want = np.asarray(jattn.edge_attention_coefs(
        jbuild.metapath_to_csr(a), jnp.asarray(ld), jnp.asarray(ls)))
    tg = tbuild.metapath_to_csr(a)
    got = tattn.edge_attention_coefs(tg, torch.from_numpy(ld), torch.from_numpy(ls))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (got[tg.n_edges:] == 0).all()
    # the head-at-a-time coefficients are the csr path's
    full = tattn.segment_softmax(tg, tattn.sddmm_edge_logits(
        tg, torch.from_numpy(ld), torch.from_numpy(ls)))
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-6)


def test_container_conversions_match():
    # 300 nodes in 128 x 128 tiles, where both packages pick the same tiles
    a = np.random.default_rng(300).random((300, 300)) < 0.05
    a[5] = False  # a row without edges
    for src in (a, jcont.DenseGraph(adj=jnp.asarray(a), n_nodes=a.shape[0])):
        jc = jcont.csr_from_dense(src, edge_pad_to=64)
        tsrc = src if isinstance(src, np.ndarray) else tcont.DenseGraph(
            adj=torch.from_numpy(a), n_nodes=a.shape[0])
        tc = tcont.csr_from_dense(tsrc, edge_pad_to=64)
        assert tc.n_edges == jc.n_edges and tc.n_nodes == jc.n_nodes
        for f in ("row_ptr", "col_idx", "row_idx"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    np.testing.assert_array_equal(tcont.dense_from_csr(tc).adj.numpy(),
                                  np.asarray(jcont.dense_from_csr(jc).adj))
    np.testing.assert_array_equal(tcont.dense_from_csr(tc).adj.numpy(), a)
    jb = jbcsr.bcsr_from_csr(jc, bm=128, bn=128)
    tb = tbcsr.bcsr_from_csr(tc, bm=128, bn=128)
    assert (tb.n_edges, tb.n_tiles, tb.n_pad) == (jb.n_edges, jb.n_tiles, jb.n_pad)
    for f in ("tiles", "fwd_count", "fwd_col", "fwd_tile", "bwd_count", "bwd_row",
              "bwd_tile"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)
    # a scipy matrix's csr goes to the same tiles
    ts = tbcsr.bcsr_from_csr(tcont.csr_from_scipy(sp.csr_matrix(a)), bm=128, bn=128)
    np.testing.assert_array_equal(ts.tiles.numpy(), tb.tiles.numpy())


def test_silhouette_matches_sklearn():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(c, 1.0, (40, 6)) for c in (0.0, 3.0, 6.0)])
    labels = rng.integers(0, 4, x.shape[0])
    labels[7] = 9  # a cluster of one sample scores 0
    np.testing.assert_allclose(silhouette_score(x, labels, block=32),
                               sk_silhouette(x, labels, metric="euclidean"), atol=1e-10)
    y = np.repeat(np.arange(3), 40)
    out = kmeans_eval(x, y, repeats=2, with_silhouette=True)
    assert -1.0 <= out["silhouette"] <= 1.0 and set(out) == {"nmi", "ari", "silhouette"}
    with pytest.raises(ValueError):
        silhouette_score(x, np.zeros(x.shape[0], int))


def test_entry_matches_graft_entry():
    jforward, (params, xs) = __graft_entry__.entry()
    want = np.asarray(jforward(params, xs))
    forward, (tparams, txs) = entry("cpu")
    assert forward(tparams, txs).shape == (3025, 3)
    got = forward(params_from_flax(params), txs)
    assert got.shape == want.shape == (3025, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_han_shared_preset_trains(tiny_ds, tmp_path):
    """arch="han_shared" on the dblp preset (bcsr, flash) trains through
    run() and feeds the towers one feature tensor."""
    cfg = preset("dblp")
    cfg.model.arch = "han_shared"
    cfg.data.tile_bm = cfg.data.tile_bn = 128
    cfg.train.epochs = 3
    cfg.train.checkpoint_dir = str(tmp_path)
    res = ttrainer.run(cfg, tiny_ds, device="cpu")
    assert len(res["epoch_train_loss"]) == 3 and np.isfinite(res["test_loss"])
    t = ttrainer.Trainer(tiny_ds, cfg, device="cpu", logger=ttrainer.MetricLogger(echo=False))
    assert isinstance(t.model, THANShared)
    logits, embed, alphas = t._apply(deterministic=True)
    assert logits.shape == (tiny_ds.n_nodes, tiny_ds.n_classes) and alphas.shape[1] == 2
