"""han_tpu_torch's HAN and GATConv against han_tpu's flax modules: flax
initial parameters go through params_from_flax, then outputs and
gradients of the loss agree at deterministic=True; the losses agree; the
port's own initializers draw from flax's distributions."""

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from han_tpu.graph import build as jbuild  # noqa: E402
from han_tpu.nn import layers as jlayers  # noqa: E402
from han_tpu.nn import losses as jlosses  # noqa: E402
from han_tpu.nn.models import HAN as JHAN  # noqa: E402
from han_tpu_torch.graph import build as tbuild  # noqa: E402
from han_tpu_torch.nn import layers as tlayers  # noqa: E402
from han_tpu_torch.nn import losses as tlosses  # noqa: E402
from han_tpu_torch.nn.convert import flax_from_params, params_from_flax  # noqa: E402
from han_tpu_torch.nn.models import HAN as THAN  # noqa: E402


def _loss_jax(logits, labels, mask, params, coef):
    return (jlosses.masked_softmax_cross_entropy(logits, labels, mask)
            + jlosses.l2_regularizer(params, coef))


@pytest.mark.parametrize("impl", ["dense", "csr"])
def test_han_matches_flax(tiny_ds, impl):
    ds = tiny_ds
    jfmt = jbuild.metapath_to_dense if impl == "dense" else jbuild.metapath_to_csr
    tfmt = tbuild.metapath_to_dense if impl == "dense" else tbuild.metapath_to_csr
    jgraphs = [jfmt(a) for a in ds.metapath_adjs]
    tgraphs = [tfmt(a) for a in ds.metapath_adjs]
    x = jnp.asarray(ds.features)
    jmodel = JHAN(n_classes=ds.n_classes, hid_units=(8,), n_heads=(4, 2), impl=impl)
    params = jmodel.init(jax.random.PRNGKey(0), jgraphs, [x, x])
    labels, mask = jnp.asarray(ds.labels), jnp.asarray(ds.train_mask)

    def loss_fn(p):
        logits, embed, alphas = jmodel.apply(p, jgraphs, [x, x])
        return _loss_jax(logits, labels, mask, p, 1e-3), (logits, embed, alphas)

    (jloss, jouts), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    tmodel = THAN(ds.features.shape[1], ds.n_classes, 2, hid_units=(8,),
                  n_heads=(4, 2), impl=impl)
    tmodel.load_state_dict(params_from_flax(params))
    tx = torch.from_numpy(ds.features)
    touts = tmodel(tgraphs, [tx, tx])
    tloss = (tlosses.masked_softmax_cross_entropy(
        touts[0], torch.from_numpy(ds.labels), torch.from_numpy(ds.train_mask))
        + tlosses.l2_regularizer(tmodel.parameters(), 1e-3))
    tloss.backward()

    for name, t, j in zip(("logits", "embedding", "alphas"), touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-6)
    tgrads = {k: v.grad for k, v in tmodel.named_parameters()}
    jflat = params_from_flax(jgrads)
    assert set(tgrads) == set(jflat)
    for k in jflat:
        np.testing.assert_allclose(tgrads[k].numpy(), jflat[k].numpy(), atol=1e-5, err_msg=k)
    # the reverse map restores the flax tree
    back = flax_from_params(tmodel.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, dict(params)))


@pytest.mark.parametrize("route", ["plain", "chunks"])
def test_han_flash_at_a_wide_head_matches_flax(tiny_ds, route, monkeypatch):
    """HAN with hid_units=(64,) through impl="flash" (the first layer's
    heads are 64 wide: two chunks of the kernels' instantiations) against
    han_tpu's HAN through its Pallas flash kernels in interpret mode, flax
    weights carried over by params_from_flax, dropout 0: logits, embedding,
    alphas and every gradient of the masked loss + L2 at atol 1e-5. The
    port's flash runs its full-head plain versions, or ("chunks") the
    chunk decomposition its CUDA wrappers launch (ops/flash_gat.py)."""
    from han_tpu_torch.ops import flash_gat as fg

    if route == "chunks":
        monkeypatch.setattr(fg, "flash_fwd", fg.flash_fwd_chunked_plain)
        monkeypatch.setattr(fg, "flash_bwd", fg.flash_bwd_chunked_plain)
    ds = tiny_ds
    kw = dict(hid_units=(64,), n_heads=(2, 1))
    jgraphs = [jbuild.metapath_to_bcsr(a, bm=128, bn=128) for a in ds.metapath_adjs]
    tgraphs = [tbuild.metapath_to_bcsr(a, bm=128, bn=128) for a in ds.metapath_adjs]
    x = jnp.asarray(ds.features)
    jmodel = JHAN(n_classes=ds.n_classes, impl="flash", **kw)
    params = jmodel.init(jax.random.PRNGKey(1), jgraphs, [x, x])
    labels, mask = jnp.asarray(ds.labels), jnp.asarray(ds.train_mask)

    def loss_fn(p):
        logits, embed, alphas = jmodel.apply(p, jgraphs, [x, x])
        return _loss_jax(logits, labels, mask, p, 1e-3), (logits, embed, alphas)

    (_, jouts), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tmodel = THAN(ds.features.shape[1], ds.n_classes, 2, impl="flash", **kw)
    tmodel.load_state_dict(params_from_flax(params))
    tx = torch.from_numpy(ds.features)
    touts = tmodel(tgraphs, [tx, tx])
    (tlosses.masked_softmax_cross_entropy(
        touts[0], torch.from_numpy(ds.labels), torch.from_numpy(ds.train_mask))
     + tlosses.l2_regularizer(tmodel.parameters(), 1e-3)).backward()
    assert touts[1].shape[-1] == 2 * 64
    for name, t, j in zip(("logits", "embedding", "alphas"), touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5, err_msg=name)
    jflat = params_from_flax(jgrads)
    for k, prm in tmodel.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), jflat[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("residual,concat,out_dim", [
    (True, False, 8),    # residual through res_kernel (F != D), head mean
    (True, True, 24),    # identity residual (F == D)
])
def test_gatconv_variants_match_flax(tiny_ds, residual, concat, out_dim):
    a = sp.csr_matrix(tiny_ds.metapath_adjs[0])
    x = tiny_ds.features  # F = 24
    jconv = jlayers.GATConv(out_dim=out_dim, num_heads=3, residual=residual,
                            concat_heads=concat, impl="csr")
    jg = jbuild.metapath_to_csr(a)
    params = jconv.init(jax.random.PRNGKey(1), jg, jnp.asarray(x))
    want = jconv.apply(params, jg, jnp.asarray(x))
    tconv = tlayers.GATConv(x.shape[1], out_dim, 3, residual=residual,
                            concat_heads=concat, impl="csr")
    tconv.load_state_dict(params_from_flax(params))
    got = tconv(tbuild.metapath_to_csr(a), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((50, 4)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 50)]
    mask = rng.random(50) < 0.4
    params = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (4,), (2, 3, 5))]
    t = lambda v: torch.from_numpy(v)
    j = lambda v: jnp.asarray(v)
    for tfn, jfn in ((tlosses.masked_softmax_cross_entropy, jlosses.masked_softmax_cross_entropy),
                     (tlosses.masked_accuracy, jlosses.masked_accuracy)):
        for m in (mask, np.zeros_like(mask)):  # an empty mask gives 0, not NaN
            np.testing.assert_allclose(float(tfn(t(logits), t(labels), t(m))),
                                       float(jfn(j(logits), j(labels), j(m))), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.l2_regularizer(map(t, params), 1e-3)),
                               float(jlosses.l2_regularizer([j(p) for p in params], 1e-3)),
                               rtol=1e-6)


def test_initializers_follow_flax(tiny_ds):
    """Same parameter names and shapes as flax; each glorot/normal draw has
    flax's bound and spread (fan_in = K·F, fan_out = D·F on the rank-3
    kernel)."""
    x = jnp.asarray(np.zeros((40, 300), np.float32))
    g = jbuild.metapath_to_dense(sp.eye(40, format="csr"))
    params = JHAN(n_classes=4, hid_units=(8,), n_heads=(8, 1), impl="dense").init(
        jax.random.PRNGKey(0), [g], [x])
    want = params_from_flax(params)
    got = THAN(300, 4, 1, generator=torch.Generator().manual_seed(0)).state_dict()
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in want:
        w, t = want[k].numpy(), got[k].numpy()
        if not w.any():  # zero-initialized biases
            assert not t.any(), k
            continue
        if not k.startswith("semantic."):  # glorot: uniform within the bound
            assert np.abs(t).max() <= np.abs(w).max() * 1.05, k
        np.testing.assert_allclose(t.std(), w.std(), rtol=0.15 if w.size > 500 else 0.5,
                                   err_msg=k)
