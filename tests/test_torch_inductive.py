"""han_tpu_torch's inductive trainer (train/inductive.py) against han_tpu's
InductiveTrainer on a small ppi_synthetic: the same batches, the same
evaluation and the same 3-epoch trajectory from converted weights; and
run()/scripts/train_torch.py on the ppi preset on the CPU."""

import runpy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from han_tpu.datasets.ppi import ppi_synthetic as jppi_synthetic  # noqa: E402
from han_tpu.train.inductive import InductiveTrainer as JInductive  # noqa: E402
from han_tpu_torch.datasets.ppi import ppi_synthetic  # noqa: E402
from han_tpu_torch.nn.convert import params_from_flax  # noqa: E402
from han_tpu_torch.train import trainer as ttrainer  # noqa: E402
from han_tpu_torch.train.config import preset  # noqa: E402
from han_tpu_torch.train.inductive import InductiveTrainer  # noqa: E402

DS = dict(n_graphs=11, nodes_per_graph=20, n_feats=6, n_labels=5, avg_degree=3.0, seed=2)
MODEL = dict(hid_units=(8, 8), n_heads=(2, 2, 3), residual=True, lr=0.01)


def pair(batch_size):
    """han_tpu's and the port's trainers on the same dataset, the port's
    holding han_tpu's initial weights."""
    jt = JInductive(jppi_synthetic(**DS), batch_size=batch_size, seed=4, **MODEL)
    tt = InductiveTrainer(ppi_synthetic(**DS), batch_size=batch_size, seed=4, device="cpu",
                          **MODEL)
    tt.model.load_state_dict(params_from_flax(jt.params))
    return jt, tt


@pytest.mark.parametrize("batch_size", [2, 3])
def test_batches_match_jax(batch_size):
    """Shuffled from default_rng(seed·1_000_003 + epoch); the last batch
    padded with zero-node graphs (7 train graphs: padded at both sizes)."""
    jt, tt = pair(batch_size)
    for which, epoch in (("train", 0), ("train", 5), ("val", None)):
        rng = lambda: None if epoch is None else np.random.default_rng(4 * 1_000_003 + epoch)
        got, want = list(tt.batches(which, rng())), list(jt._batches(which, rng()))
        assert len(got) == len(want)
        for gb, wb in zip(got, want):
            for g, w in zip(gb, wb):
                assert g.shape == w.shape and g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("batch_size", [2, 3])
def test_inductive_trainer_matches_jax(batch_size):
    """Same weights: eval loss and micro-F1 to rtol 1e-5; 3 epochs of train
    loss (Adam, shuffled batches) to rtol 1e-4; the restored best epoch and
    the test scores agree."""
    jt, tt = pair(batch_size)
    for which in ("val", "test"):
        got, want = tt.evaluate(which), jt.evaluate(which)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["micro_f1"], want["micro_f1"], rtol=1e-5)
    got = tt.fit(epochs=3, log=lambda rec: None)
    want = jt.fit(epochs=3, log=lambda rec: None)
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]],
                               [h["train_loss"] for h in want["history"]], rtol=1e-4)
    np.testing.assert_allclose([h["val_micro_f1"] for h in got["history"]],
                               [h["val_micro_f1"] for h in want["history"]], rtol=1e-4)
    assert got["best_epoch"] == want["best_epoch"]
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["test_micro_f1"], want["test_micro_f1"], rtol=1e-4)


def test_run_trains_the_ppi_preset_by_name(tmp_path, monkeypatch):
    """run(preset("ppi")) with no dataset loads "ppi": no GraphSAGE files
    under data_cache/ppi (relative to the working directory, as in han_tpu),
    so ppi_synthetic, trained inductively at the preset's widths."""
    monkeypatch.chdir(tmp_path)
    cfg = preset("ppi")
    cfg.train.epochs = 1
    result = ttrainer.run(cfg, device="cpu")
    assert "history" not in result and len(result["epoch_train_loss"]) == 1
    assert np.isfinite(result["epoch_train_loss"]).all() and np.isfinite(result["test_loss"])
    assert 0.0 <= result["test_micro_f1"] <= 1.0


def test_entry_script_trains_ppi(capsys, tmp_path, monkeypatch):
    main = runpy.run_path("scripts/train_torch.py", run_name="not_main")["main"]
    monkeypatch.chdir(tmp_path)
    result = main(["--device", "cpu", "--dataset", "ppi", "--set", "train.epochs=1",
                   "--set", "model.hid_units=16,16"])
    assert len(result["epoch_train_loss"]) == 1
    assert "test_micro_f1" in capsys.readouterr().out


def test_graph_axis_and_impl(monkeypatch):
    """mesh.graph_axis = S > 1 routes run() to data-parallel batches, as
    han_tpu's run() does: the mesh's graph axis and a global batch of
    max(2, S) graphs (here a stand-in for the mesh of S ranks, recorded
    instead of trained); a batch that does not split over the axis raises
    ValueError; impl="csr" takes the sparse path on the csr format (its
    layers on csr, no dense adjacency in a batch), and an impl the trainer
    does not take raises ValueError."""
    from torch_parallel_ranks import stand_in_mesh

    built = []
    monkeypatch.setattr(ttrainer, "make_mesh", stand_in_mesh)
    monkeypatch.setattr(InductiveTrainer, "fit",
                        lambda self, epochs: built.append(self) or {"history": []})
    ds = ppi_synthetic(**DS)
    cfg = preset("ppi")
    for s_n in (2, 3):
        cfg.mesh.graph_axis = s_n
        assert ttrainer.run(cfg, ds, device="cpu") == {}
        t = built[-1]
        assert t.mesh.graph.size == s_n and t.batch_size == max(2, s_n)
        assert t.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible by the graph axis"):
        InductiveTrainer(ds, batch_size=3, mesh=stand_in_mesh(2), **MODEL)
    t = InductiveTrainer(ds, impl="csr", device="cpu", **MODEL)
    assert t.graph_format == "csr" and t.route == "csr"
    assert all(layer.impl == "csr" for layer in t.model.layers)
    batch = next(t.batches("train"))
    assert not any(b.dim() == 3 and b.shape[1] == b.shape[2] for b in batch)
    assert batch[3].shape == (2, 128, ds.features.shape[-1])
    with pytest.raises(ValueError, match="takes impl in"):
        InductiveTrainer(ds, impl="ell_fused", device="cpu", **MODEL)


def test_no_cpu_fallback_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        InductiveTrainer(ppi_synthetic(**DS), **MODEL)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttrainer.run(preset("ppi"), ppi_synthetic(**DS))
