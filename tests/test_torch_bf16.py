"""bf16 features through the port against han_tpu: the flash path's plain
versions with bf16 features against han_tpu's flash_gat_attention in
interpret mode (output and the three gradients), ell_fused's plain version
against han_tpu's ell_fused_attention in interpret mode, HAN(dtype=bf16) against
flax's HAN(dtype=bfloat16) with converted weights, the dense, csr and ell
backends' bf16 aggregates, and the trainer on model.dtype=bfloat16."""

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from han_tpu.graph import build as jbuild  # noqa: E402
from han_tpu.graph.bcsr import bcsr_from_dense as j_bcsr  # noqa: E402
from han_tpu.graph.containers import ell_from_csr as j_ell  # noqa: E402
from han_tpu.nn.models import HAN as JHAN  # noqa: E402
from han_tpu.ops import attention as jatt  # noqa: E402
from han_tpu.ops.pallas.ell_fused import ell_fused_attention as j_ell_fused  # noqa: E402
from han_tpu.ops.pallas.flash_gat import flash_gat_attention as j_flash  # noqa: E402
from han_tpu_torch.graph import build as tbuild  # noqa: E402
from han_tpu_torch.graph.bcsr import bcsr_from_dense as t_bcsr  # noqa: E402
from han_tpu_torch.graph.containers import csr_from_scipy as t_csr  # noqa: E402
from han_tpu_torch.graph.containers import dense_from_numpy as t_dense  # noqa: E402
from han_tpu_torch.graph.containers import ell_from_csr as t_ell  # noqa: E402
from han_tpu_torch.nn.convert import params_from_flax  # noqa: E402
from han_tpu_torch.nn.models import HAN as THAN  # noqa: E402
from han_tpu_torch.ops import attention as tatt  # noqa: E402
from han_tpu_torch.ops import ell_fused as tef  # noqa: E402
from han_tpu_torch.ops import flash_gat as tfg  # noqa: E402
from han_tpu_torch.train import trainer as ttrainer  # noqa: E402
from han_tpu_torch.train.config import preset as tpreset  # noqa: E402

# one bf16 rounding step is 2**-8 of a value; two steps cover a value that
# both sides round from f32 sums taken in different orders
BF16_RTOL = 2.0 ** -7


def make_case(n=300, k=4, d=8, seed=1):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.1).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    a[5] = 0.0  # an edgeless row
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return a, f32(n, k, d), f32(n, k), f32(n, k), f32(n, k, d)


def run_jax(fn, fts, ld, ls, w):
    """out and d(sum(out·w))/d(fts, ld, ls), fts in bf16; as float32."""
    args = (jnp.asarray(fts).astype(jnp.bfloat16), jnp.asarray(ld), jnp.asarray(ls))
    grads = jax.grad(lambda *x: jnp.sum(fn(*x) * w), argnums=(0, 1, 2))(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (fn(*args), *grads)]


def run_torch(fn, fts, ld, ls, w):
    args = [torch.tensor(fts).bfloat16().requires_grad_(), torch.tensor(ld, requires_grad=True),
            torch.tensor(ls, requires_grad=True)]
    out = fn(*args)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), args)
    assert out.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    return [x.detach().float().numpy() for x in (out, *grads)]


def assert_bf16_close(got, want):
    """out and d_fts are bf16 on both sides: two rounding steps; d_ld and
    d_ls are f32 sums over the same bf16 values: summation order only."""
    for name, g, w, rtol, atol in zip(("out", "d_fts", "d_logit_dst", "d_logit_src"), got, want,
                                      (BF16_RTOL, BF16_RTOL, 1e-5, 1e-5),
                                      (1e-4, 1e-4, 1e-5, 1e-5)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


def test_flash_bf16_matches_jax_interpreted():
    """bf16 features stream to the flash path as bf16 (the plain versions on
    the CPU) and the output comes back in bf16, as han_tpu's kernels in
    interpret mode."""
    a, fts, ld, ls, w = make_case()
    jg, tg = j_bcsr(a, bm=128, bn=128), t_bcsr(a, bm=128, bn=128)
    got = run_torch(lambda *x: tfg.flash_gat_attention(tg, *x), fts, ld, ls, w)
    want = run_jax(lambda *x: j_flash(jg, *x, interpret=True), fts, ld, ls, w)
    np.testing.assert_array_equal(got[0][5], 0.0)
    assert_bf16_close(got, want)


@pytest.mark.parametrize("impl", ["dense", "csr", "ell"])
def test_dense_csr_ell_bf16_match_jax(impl):
    """The dense, csr and ell backends sum in f32 and return bf16, as
    han_tpu's (attention.py:106-108, 156-159, 217)."""
    a, fts, ld, ls, w = make_case(n=64, k=3)
    if impl == "dense":
        jg, tg, jfn, tfn = (jbuild.metapath_to_dense(a, add_self_loops=False),
                            t_dense(a, add_self_loops=False), jatt.dense_attention,
                            tatt.dense_attention)
    else:
        jg = jbuild.metapath_to_csr(sp.csr_matrix(a), add_self_loops=False)
        tg = t_csr(sp.csr_matrix(a))
        jfn, tfn = jatt.csr_attention, tatt.csr_attention
        if impl == "ell":
            jg, tg = j_ell(jg), t_ell(tg)
            jfn, tfn = jatt.ell_attention, tatt.ell_attention
    assert_bf16_close(run_torch(lambda *x: tfn(tg, *x), fts, ld, ls, w),
                      run_jax(lambda *x: jfn(jg, *x), fts, ld, ls, w))


def test_ell_fused_bf16_matches_jax_interpreted():
    """ell_fused with bf16 features (the plain version the CPU runs, f32
    inside, the output rounded once to bf16) against han_tpu's
    ell_fused_attention (its Pallas kernel interpreted, f32 inside, cast
    back), dropout 0: out and d_fts within two bf16 steps, as above. The
    logits' gradients within 2^-7 of the largest one: han_tpu's backward
    takes g·v as an einsum of two bf16 arrays, rounded to bf16
    (ell_fused.py:141), where the port sums it in f32, and the row sums of
    dz cancel down to well below the terms that carry that rounding."""
    a, fts, ld, ls, w = make_case(n=64, k=3)
    jg = j_ell(jbuild.metapath_to_csr(sp.csr_matrix(a), add_self_loops=False))
    tg = t_ell(t_csr(sp.csr_matrix(a)))
    assert tef.kernel_takes(torch.bfloat16)
    got = run_torch(lambda *x: tef.ell_fused_attention(tg, *x), fts, ld, ls, w)
    want = run_jax(lambda *x: j_ell_fused(jg, *x, interpret=True), fts, ld, ls, w)
    np.testing.assert_array_equal(got[0][5], 0.0)
    for name, g, wt in zip(("out", "d_fts"), got, want):
        np.testing.assert_allclose(g, wt, rtol=BF16_RTOL, atol=1e-4, err_msg=name)
    for name, g, wt in zip(("d_logit_dst", "d_logit_src"), got[2:], want[2:]):
        np.testing.assert_allclose(g, wt, atol=2.0 ** -7 * np.abs(wt).max(), err_msg=name)


def test_han_bf16_matches_flax(tiny_ds):
    """HAN(dtype=bf16) on the flash path against flax's
    HAN(dtype=bfloat16) (interpret mode) from the same initial weights,
    dropout off: logits and embedding within 2e-2 relative, alphas within
    1e-2 absolute (x, the kernel and the features round to bf16 on both
    sides; XLA may keep some bf16 intermediates in f32)."""
    ds = tiny_ds
    jgraphs = [jbuild.metapath_to_bcsr(a) for a in ds.metapath_adjs]
    tgraphs = [tbuild.metapath_to_bcsr(a) for a in ds.metapath_adjs]
    x = jnp.asarray(ds.features)
    jmodel = JHAN(n_classes=ds.n_classes, hid_units=(8,), n_heads=(4, 1), impl="flash",
                  dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(0), jgraphs, [x, x])
    jouts = jmodel.apply(params, jgraphs, [x, x])
    tmodel = THAN(ds.features.shape[1], ds.n_classes, 2, hid_units=(8,), n_heads=(4, 1),
                  impl="flash", dtype=torch.bfloat16)
    tmodel.load_state_dict(params_from_flax(params))
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    tx = torch.from_numpy(ds.features)
    with torch.no_grad():
        touts = tmodel(tgraphs, [tx, tx])
    for name, t, j, tol in zip(("logits", "embedding", "alphas"), touts, jouts,
                               (dict(rtol=2e-2, atol=2e-2), dict(rtol=2e-2, atol=2e-2),
                                dict(atol=1e-2))):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **tol)


def test_trainer_trains_in_bf16(tiny_ds, monkeypatch):
    """The dblp preset with model.dtype=bfloat16 (dropouts 0.6) trains on
    the CPU through the flash path: every GATConv hands bf16 features and
    f32 logits to attention_aggregate, the flash forward gets bf16 v;
    finite losses, f32 parameters."""
    from han_tpu_torch.nn import layers as tlayers

    seen = {"agg": set(), "v": set()}
    agg, fwd = tlayers.attention_aggregate, tfg.flash_fwd

    def spy_agg(graph, fts, ld, ls, **kw):
        seen["agg"].add((fts.dtype, ld.dtype, ls.dtype))
        return agg(graph, fts, ld, ls, **kw)

    monkeypatch.setattr(tlayers, "attention_aggregate", spy_agg)
    monkeypatch.setattr(tfg, "flash_fwd", lambda g, ld, ls, v, meta: (
        seen["v"].add(v.dtype), fwd(g, ld, ls, v, meta))[1])
    cfg = tpreset("dblp")
    cfg.model.dtype = "bfloat16"
    cfg.train.epochs = 3
    t = ttrainer.Trainer(tiny_ds, cfg, device="cpu", logger=ttrainer.MetricLogger(echo=False))
    assert t.model.towers[0].layers[0].dtype == torch.bfloat16
    result = t.fit()
    assert seen == {"agg": {(torch.bfloat16, torch.float32, torch.float32)},
                    "v": {torch.bfloat16}}
    assert len(result["epoch_train_loss"]) == 3
    assert np.isfinite(result["epoch_train_loss"]).all() and np.isfinite(result["test_loss"])
    assert all(p.dtype == torch.float32 for p in t.model.parameters())
    cfg.model.dtype = "float16"
    with pytest.raises(ValueError, match="float16"):
        ttrainer.build_model(tiny_ds, cfg)
