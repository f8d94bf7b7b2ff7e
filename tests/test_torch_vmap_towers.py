"""HAN(vmap_towers=True) — the meta-path towers stacked — against han_tpu.

- The port's HAN(vmap_towers) with flax weights converted by nn/convert.py
  against han_tpu's HAN(vmap_towers) on dense, csr and bcsr stacks (bcsr
  through flash: the Pallas kernel in interpret mode, the port's plain
  batched version), dropout 0: logits, embedding, alphas and the gradients
  of the masked loss plus L2 at atol 1e-5.
- Against the port's sequential HAN: one generator draws the same weights
  in both layouts, and stack_towers / unstack_towers map one state_dict
  onto the other; the outputs are equal.
- At dropout > 0 each tower draws its own masks (the counterpart of
  han_tpu's test_vmap_towers_dropout_fires): towers with the same graph,
  features and weights give different embeddings, and training mode
  differs from eval mode.
- The trainer: vmap_towers stacks the graphs and features, trains, and
  resumes from a checkpoint of its stacked parameters on the
  uninterrupted run's trajectory.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from han_tpu.graph import build as jbuild  # noqa: E402
from han_tpu.graph.stack import stack_graphs as j_stack  # noqa: E402
from han_tpu.nn import losses as jlosses  # noqa: E402
from han_tpu.nn.models import HAN as JHAN  # noqa: E402
from han_tpu_torch.graph import build as tbuild  # noqa: E402
from han_tpu_torch.graph.stack import stack_graphs as t_stack  # noqa: E402
from han_tpu_torch.graph.synthetic import planted_hetero  # noqa: E402
from han_tpu_torch.nn import losses as tlosses  # noqa: E402
from han_tpu_torch.nn.convert import (flax_from_params, params_from_flax,  # noqa: E402
                                      stack_towers, unstack_towers)
from han_tpu_torch.nn.layers import DropoutGenerators  # noqa: E402
from han_tpu_torch.nn.models import HAN as THAN  # noqa: E402
from han_tpu_torch.train.preempt import PreemptionGuard  # noqa: E402
from han_tpu_torch.train.trainer import Trainer  # noqa: E402

from test_torch_resume import Capture, flash_cfg  # noqa: E402

BUILD = {"dense": (jbuild.metapath_to_dense, tbuild.metapath_to_dense, "dense"),
         "csr": (jbuild.metapath_to_csr, tbuild.metapath_to_csr, "csr"),
         "bcsr": (lambda a: jbuild.metapath_to_bcsr(a, bm=128, bn=128),
                  lambda a: tbuild.metapath_to_bcsr(a, bm=128, bn=128), "flash")}


@pytest.fixture(scope="module")
def ds():
    # three meta-paths of different sizes, so that the stacks pad
    return planted_hetero(n_nodes=150, n_feats=20, n_classes=3, n_metapaths=3,
                          avg_degree=7.0, train_per_class=12, n_val=20, seed=13)


@pytest.mark.parametrize("fmt", list(BUILD))
def test_vmap_towers_matches_jax(ds, fmt):
    """Logits, embedding, alphas and every parameter's gradient of the
    masked loss + L2 1e-3, dropout 0: atol 1e-5."""
    jb, tb, impl = BUILD[fmt]
    p = len(ds.metapath_adjs)
    jg = j_stack([jb(a) for a in ds.metapath_adjs])
    x = jnp.asarray(ds.features)
    xs = jnp.stack([x] * p)
    jmodel = JHAN(n_classes=ds.n_classes, hid_units=(8,), n_heads=(4, 2), impl=impl,
                  vmap_towers=True)
    params = jmodel.init(jax.random.PRNGKey(0), jg, xs)
    labels, mask = jnp.asarray(ds.labels), jnp.asarray(ds.train_mask)

    def loss_fn(q):
        logits, embed, alphas = jmodel.apply(q, jg, xs)
        loss = (jlosses.masked_softmax_cross_entropy(logits, labels, mask)
                + jlosses.l2_regularizer(q, 1e-3))
        return loss, (logits, embed, alphas)

    (_, jouts), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert np.asarray(params["params"]["towers"]["GATConv_0"]["kernel"]).shape[0] == p

    tmodel = THAN(ds.features.shape[1], ds.n_classes, p, hid_units=(8,), n_heads=(4, 2),
                  impl=impl, vmap_towers=True)
    tmodel.load_state_dict(params_from_flax(params))
    tx = torch.from_numpy(ds.features)
    touts = tmodel(t_stack([tb(a) for a in ds.metapath_adjs]), torch.stack([tx] * p))
    loss = (tlosses.masked_softmax_cross_entropy(
        touts[0], torch.from_numpy(ds.labels), torch.from_numpy(ds.train_mask))
        + tlosses.l2_regularizer(tmodel.parameters(), 1e-3))
    loss.backward()
    for name, t, j in zip(("logits", "embedding", "alphas"), touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5, err_msg=name)
    want = params_from_flax(jgrads)
    for name, prm in tmodel.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)
    back = flax_from_params(tmodel.state_dict())["params"]
    np.testing.assert_array_equal(back["towers"]["GATConv_0"]["attn_src_bias"],
                                  np.asarray(params["params"]["towers"]["GATConv_0"]
                                             ["attn_src_bias"]))


@pytest.mark.parametrize("fmt", list(BUILD))
def test_vmap_towers_equals_sequential(ds, fmt):
    """One generator seed gives the stacked layout the sequential towers'
    weights (stack_towers of the sequential state_dict, and back), and the
    two layouts' outputs are equal at dropout 0."""
    _, tb, impl = BUILD[fmt]
    p = len(ds.metapath_adjs)
    graphs = [tb(a) for a in ds.metapath_adjs]
    kw = dict(hid_units=(8,), n_heads=(4, 2), impl=impl)
    seq = THAN(ds.features.shape[1], ds.n_classes, p,
               generator=torch.Generator().manual_seed(3), **kw)
    vm = THAN(ds.features.shape[1], ds.n_classes, p, vmap_towers=True,
              generator=torch.Generator().manual_seed(3), **kw)
    stacked = stack_towers(seq.state_dict())
    for name, t in vm.state_dict().items():
        assert torch.equal(t, stacked[name]), name
    for name, t in unstack_towers(vm.state_dict()).items():
        assert torch.equal(t, seq.state_dict()[name]), name
    tx = torch.from_numpy(ds.features)
    with torch.no_grad():
        a = seq(graphs, [tx] * p)
        b = vm(t_stack(graphs), torch.stack([tx] * p))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fmt", ["csr", "bcsr"])
def test_vmap_towers_dropout_differs_per_tower(ds, fmt):
    """Dropout 0.5 (input and coefficients): three towers with one graph,
    one feature tensor and one set of weights give three different
    embeddings (each its own masks and flash seed); eval mode gives three
    equal ones."""
    _, tb, impl = BUILD[fmt]
    g = tb(ds.metapath_adjs[0])
    model = THAN(ds.features.shape[1], ds.n_classes, 3, hid_units=(8,), n_heads=(2, 1),
                 impl=impl, vmap_towers=True, attn_drop=0.5, ffd_drop=0.5)
    with torch.no_grad():
        for t in model.towers.parameters():
            t.copy_(t[:1].expand_as(t))
    tx = torch.from_numpy(ds.features)
    stack, xs = t_stack([g] * 3), torch.stack([tx] * 3)
    rngs = DropoutGenerators(device=torch.Generator().manual_seed(7))
    with torch.no_grad():
        train = model._stacked_towers(stack, xs, False, rngs)  # (N, P, K·hid)
        evals = model._stacked_towers(stack, xs, True, None)
    assert torch.equal(evals[:, 0], evals[:, 1]) and torch.equal(evals[:, 1], evals[:, 2])
    for i, j in ((0, 1), (0, 2), (1, 2)):
        assert float((train[:, i] - train[:, j]).abs().max()) > 1e-3, (i, j)
    assert float((train - evals).abs().max()) > 1e-3


def test_trainer_vmap_towers_trains_and_resumes(tmp_path):
    """Trainer with vmap_towers (the dblp preset through flash, dropout
    0.6): the graphs are one stack, the features (P, N, F); the checkpoint
    holds the stacked parameters; a run preempted after epoch 2 and resumed
    in a fresh trainer emits the uninterrupted run's losses (equal)."""
    ds = planted_hetero(n_nodes=120, n_feats=32, n_classes=3, n_metapaths=2,
                        avg_degree=8.0, train_per_class=15, n_val=20, seed=5)

    def trainer(root, logger, guard=None):
        cfg = flash_cfg(root, epochs=5, checkpoint_every=1)
        cfg.model.vmap_towers = True
        return Trainer(ds, cfg, device="cpu", logger=logger, guard=guard)

    full_log = Capture()
    full = trainer(tmp_path / "a", full_log)
    assert full.graphs.n_paths == 2 and tuple(full.xs.shape) == (2, 120, 32)
    full.fit()
    guard = PreemptionGuard()
    first = trainer(tmp_path / "b", Capture(guard, trip_at=2), guard)
    assert first.fit()["preempted"]
    state = first.restore_latest()
    assert tuple(state["model"]["towers.layers.0.kernel"].shape)[0] == 2
    resumed_log = Capture()
    trainer(tmp_path / "b", resumed_log).fit(resume=True)
    want = full_log.column("train_loss")
    got = resumed_log.column("train_loss")
    assert sorted(got) == [3, 4] and all(got[e] == want[e] for e in got)
