"""han_tpu_torch's GAT family against han_tpu's: the GAT model with flax
weights converted (logits and every gradient, dense, csr and flash — flash
in JAX's interpret mode against the port's plain versions on a tiny BCSR
graph), the reverse weight map, the four new losses, the arch="gat"
trainer's steps, and run() on the GAT presets' datasets on the CPU."""

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from han_tpu.graph import build as jbuild  # noqa: E402
from han_tpu.nn import losses as jlosses  # noqa: E402
from han_tpu.nn.models import GAT as JGAT  # noqa: E402
from han_tpu.train import trainer as jtrainer  # noqa: E402
from han_tpu.train.config import preset as jpreset  # noqa: E402
from han_tpu_torch.datasets.planetoid import write_planetoid  # noqa: E402
from han_tpu_torch.graph import build as tbuild  # noqa: E402
from han_tpu_torch.nn import losses as tlosses  # noqa: E402
from han_tpu_torch.nn.convert import flax_from_params, params_from_flax  # noqa: E402
from han_tpu_torch.nn.models import GAT as TGAT  # noqa: E402
from han_tpu_torch.nn.models import HANShared as THANShared  # noqa: E402
from han_tpu_torch.train import trainer as ttrainer  # noqa: E402
from han_tpu_torch.train.config import preset as tpreset  # noqa: E402

GRAPHS = {
    "dense": (jbuild.metapath_to_dense, tbuild.metapath_to_dense),
    "csr": (jbuild.metapath_to_csr, tbuild.metapath_to_csr),
    "flash": (lambda a: jbuild.metapath_to_bcsr(a, bm=128, bn=128),
              lambda a: tbuild.metapath_to_bcsr(a, bm=128, bn=128)),
}


@pytest.mark.parametrize("impl", ["dense", "csr", "flash"])
def test_gat_matches_flax(tiny_ds, impl):
    """Two hidden layers (the second residual through res_kernel) and a
    2-head output layer: logits and every gradient of the masked loss plus
    L2 agree to atol 1e-5; the reverse map restores the flax tree."""
    a = sp.csr_matrix(tiny_ds.metapath_adjs[0])
    jfmt, tfmt = GRAPHS[impl]
    jg, tg = jfmt(a), tfmt(a)
    x = jnp.asarray(tiny_ds.features)
    kw = dict(hid_units=(6, 5), n_heads=(3, 2, 2), residual=True)
    jmodel = JGAT(n_classes=tiny_ds.n_classes, impl=impl, **kw)
    params = jmodel.init(jax.random.PRNGKey(3), jg, x)
    labels, mask = jnp.asarray(tiny_ds.labels), jnp.asarray(tiny_ds.train_mask)

    def loss_fn(p):
        logits = jmodel.apply(p, jg, x)
        return (jlosses.masked_softmax_cross_entropy(logits, labels, mask)
                + jlosses.l2_regularizer(p, 1e-3)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    tmodel = TGAT(tiny_ds.features.shape[1], tiny_ds.n_classes, impl=impl, **kw)
    tmodel.load_state_dict(params_from_flax(params))
    logits = tmodel(tg, torch.from_numpy(tiny_ds.features))
    tloss = (tlosses.masked_softmax_cross_entropy(
        logits, torch.from_numpy(tiny_ds.labels), torch.from_numpy(tiny_ds.train_mask))
        + tlosses.l2_regularizer(tmodel.parameters(), 1e-3))
    tloss.backward()
    assert logits.shape == (tiny_ds.n_nodes, tiny_ds.n_classes)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6)
    jflat = params_from_flax(jgrads)
    tgrads = {k: v.grad for k, v in tmodel.named_parameters()}
    assert set(tgrads) == set(jflat) and "layers.1.res_kernel" in jflat
    assert "layers.0.res_kernel" not in jflat and "layers.2.res_kernel" not in jflat
    for k in jflat:
        np.testing.assert_allclose(tgrads[k].numpy(), jflat[k].numpy(), atol=1e-5, err_msg=k)
    back = flax_from_params(tmodel.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, dict(params)))
    for k, v in params_from_flax(back).items():
        np.testing.assert_array_equal(v.numpy(), params_from_flax(params)[k].numpy())


def loss_cases():
    rng = np.random.default_rng(0)
    n, c = 60, 5
    logits = (3 * rng.standard_normal((n, c))).astype(np.float32)
    multi = (rng.random((n, c)) < 0.4).astype(np.float32)
    mask = rng.random(n) < 0.5
    ids = rng.integers(0, c, n)
    weights = rng.random(c).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    return {
        "masked_sigmoid_cross_entropy": [
            (lambda m=m: tlosses.masked_sigmoid_cross_entropy(t(logits), t(multi), t(m)),
             lambda m=m: jlosses.masked_sigmoid_cross_entropy(j(logits), j(multi), j(m)))
            for m in (mask, np.zeros_like(mask))],
        "micro_f1": [
            (lambda m=m: tlosses.micro_f1(t(logits), t(multi), t(m)),
             lambda m=m: jlosses.micro_f1(j(logits), j(multi), j(m)))
            for m in (mask, np.zeros_like(mask))],
        "confusion_matrix": [
            (lambda: tlosses.confusion_matrix(t(logits), t(ids), c),
             lambda: jlosses.confusion_matrix(j(logits), j(ids), c))],
        "class_weighted_cross_entropy": [
            (lambda: tlosses.class_weighted_cross_entropy(t(logits), t(ids), c, t(weights)),
             lambda: jlosses.class_weighted_cross_entropy(j(logits), j(ids), c, j(weights)))],
    }


@pytest.mark.parametrize("name", ["masked_sigmoid_cross_entropy", "micro_f1",
                                  "confusion_matrix", "class_weighted_cross_entropy"])
def test_new_losses_match_jax(name):
    """Each equals han_tpu's at rtol 1e-6 (an empty mask gives 0, not NaN);
    micro_f1 from the same integer counts."""
    for tfn, jfn in loss_cases()[name]:
        got, want = tfn(), np.asarray(jfn())
        assert got.shape == want.shape and np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    if name == "confusion_matrix":
        assert got.dtype == torch.int32 and int(got.sum()) == 60


def gat_cfg(preset, fmt, **train):
    cfg = preset("cora")
    cfg.data.graph_format, cfg.model.impl = fmt, {"bcsr": "flash"}.get(fmt, fmt)
    cfg.data.tile_bm = cfg.data.tile_bn = 128
    cfg.model.n_heads = (4, 2)
    cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


@pytest.mark.parametrize("fmt", ["dense", "csr", "bcsr"])
def test_gat_train_steps_match_jax(tiny_ds, tmp_path, fmt):
    """Five Adam steps of the cora preset's GAT (graph 0 of the dataset)
    from the same flax weights, dropout off: train loss and accuracy to
    rtol 1e-4 (as the HAN steps in test_torch_trainer.py), zero semantic
    alphas, the parameters after the steps to atol 1e-4."""
    jt = jtrainer.Trainer(tiny_ds, gat_cfg(jpreset, fmt, checkpoint_dir=str(tmp_path)),
                          logger=jtrainer.MetricLogger(echo=False))
    params = jt.init_params()
    opt_state = jt.tx.init(params)
    rng = jax.random.PRNGKey(0)
    tt = ttrainer.Trainer(tiny_ds, gat_cfg(tpreset, fmt), device="cpu",
                          logger=ttrainer.MetricLogger(echo=False))
    assert isinstance(tt.model, TGAT)
    tt.model.load_state_dict(params_from_flax(params))
    for step in range(5):
        params, opt_state, rng, jloss, jacc, jalphas = jt.train_step(params, opt_state, rng)
        tloss, tacc, talphas = tt.train_step()
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tacc), float(jacc), rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_array_equal(talphas.numpy(), np.asarray(jalphas))
    final = params_from_flax(params)
    for k, v in tt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=1e-4, err_msg=k)




@pytest.mark.parametrize("name", ["cora", "citeseer", "pubmed"])
def test_run_trains_the_gat_presets(name, tmp_path):
    """run(preset(name), ds) on Planetoid shards written here, on the CPU:
    pubmed through flash (the plain versions here), cora and citeseer dense;
    finite losses, zero alphas in the log, no KNN/KMeans keys (GAT)."""
    import json

    from han_tpu_torch.datasets.registry import load_dataset

    write_planetoid(tmp_path, name, n_nodes=150, n_feats=20, n_edges=400, n_train=30,
                    n_test=40, gaps=(1, 6) if name == "citeseer" else ())
    ds = load_dataset(name, root=tmp_path)
    cfg = tpreset(name)
    assert cfg.model.arch == "gat" and cfg.model.impl == ("flash" if name == "pubmed" else "auto")
    cfg.train.epochs, cfg.train.log_file = 2, str(tmp_path / "log.jsonl")
    result = ttrainer.run(cfg, ds, device="cpu")
    assert len(result["epoch_train_loss"]) == 2 and np.isfinite(result["epoch_train_loss"]).all()
    assert np.isfinite(result["test_loss"]) and 0.0 <= result["test_acc"] <= 1.0 + 1e-6
    assert json.loads(open(cfg.train.log_file).readline())["semantic_alphas"] == [0.0]
    assert not any(k.startswith(("macro_f1", "nmi")) for k in result)


def test_build_model_archs(tiny_ds):
    cfg = tpreset("cora")
    cfg.model.dtype = "bfloat16"
    model = ttrainer.build_model(tiny_ds, cfg)
    assert isinstance(model, TGAT) and all(layer.dtype == torch.bfloat16
                                           for layer in model.layers)
    assert model.layers[-1].concat_heads is False and len(model.layers) == 2
    cfg.model.arch = "han_shared"  # HANShared: HAN's towers, one shared input
    model = ttrainer.build_model(tiny_ds, cfg)
    assert isinstance(model, THANShared) and len(model.towers) == 2
    cfg.model.arch = "mlp"
    with pytest.raises(ValueError, match="mlp"):
        ttrainer.build_model(tiny_ds, cfg)
