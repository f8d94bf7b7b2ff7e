"""The port's resilience contract (han_tpu's tests/test_trainer.py resume
tests, on the CPU, eager, with the kernels' plain versions): a run that is
preempted and resumed in a fresh trainer emits exactly the uninterrupted
run's trajectory (the CPU generators are deterministic, so the losses are
held equal, not close), for the full-graph trainer at dropout 0.6 through
bcsr/flash, the sampled trainer with both samplers (steps_per_call 1 and 2,
a cursor off a chunk boundary included) and the inductive trainer; resume
restores the best epoch's parameters, not the latest save's; every
checkpoint loads under ``torch.load(weights_only=True)``."""

import pathlib

import numpy as np
import pytest
import torch

from han_tpu_torch.datasets.ppi import ppi_synthetic
from han_tpu_torch.graph.synthetic import planted_hetero
from han_tpu_torch.train.config import preset
from han_tpu_torch.train.inductive import InductiveTrainer
from han_tpu_torch.train.preempt import PreemptionGuard
from han_tpu_torch.train.sampled import _EPOCH_STRIDE, SampledTrainer
from han_tpu_torch.train.trainer import (CheckpointStore, MetricLogger, Trainer,
                                         load_training_state)


@pytest.fixture(scope="module")
def small_ds():
    return planted_hetero(n_nodes=120, n_feats=32, n_classes=3, n_metapaths=2,
                          avg_degree=8.0, train_per_class=15, n_val=20, seed=5)


class Capture(MetricLogger):
    """Keeps the records; trips ``guard`` on the epoch record of ``trip_at``."""

    def __init__(self, guard=None, trip_at=None):
        super().__init__("", echo=False)
        self.rows, self.guard, self.trip_at = [], guard, trip_at

    def log(self, rec):
        self.rows.append(rec)
        if self.guard is not None and rec.get("epoch") == self.trip_at:
            self.guard.trip()

    def column(self, key):
        return {r["epoch"]: r[key] for r in self.rows if key in r}


class TripAfter:
    """A guard that reads as tripped from its ``n``-th poll on."""

    def __init__(self, n):
        self.left = n

    @property
    def triggered(self):
        self.left -= 1
        return self.left <= 0


def flash_cfg(ckpt, epochs=6, **train):
    cfg = preset("dblp")  # bcsr graphs, impl flash, dropouts 0.6
    cfg.data.tile_bm = cfg.data.tile_bn = 128
    cfg.model.hid_units, cfg.model.n_heads = (8,), (2, 1)
    cfg.train.epochs, cfg.train.patience = epochs, 100
    cfg.train.checkpoint_dir = str(ckpt)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def assert_weights_only(root):
    files = sorted(pathlib.Path(root).rglob("*.pt"))
    assert files, f"no checkpoint under {root}"
    for f in files:
        state = torch.load(f, weights_only=True)
        assert {"model", "opt", "rng"} <= set(state), f
    assert not list(pathlib.Path(root).rglob("*.tmp"))


def test_trainer_preempt_resume_is_bitwise(small_ds, tmp_path):
    """Dropout 0.6 through bcsr/flash: preempted after epoch 2 by a tripped
    guard, resumed in a fresh Trainer: epochs 3-5 emit the uninterrupted
    run's train and val losses, and the final metrics, exactly."""
    cap_a = Capture()
    res_a = Trainer(small_ds, flash_cfg(tmp_path / "a"), device="cpu", logger=cap_a).fit()

    guard = PreemptionGuard(install=False)
    cap_b = Capture(guard, trip_at=2)
    res_b = Trainer(small_ds, flash_cfg(tmp_path / "b", checkpoint_every=1), device="cpu",
                    logger=cap_b, guard=guard).fit()
    assert res_b["preempted"] is True and len(res_b["epoch_train_loss"]) == 3
    assert {"preempted_at": 2} in cap_b.rows

    cap_c = Capture()
    t = Trainer(small_ds, flash_cfg(tmp_path / "b", checkpoint_every=1), device="cpu",
                logger=cap_c)
    res_c = t.fit(resume=True)
    assert sorted(cap_c.column("train_loss")) == [3, 4, 5]
    for key in ("train_loss", "val_loss", "val_acc"):
        a, c = cap_a.column(key), cap_c.column(key)
        np.testing.assert_array_equal([c[e] for e in (3, 4, 5)], [a[e] for e in (3, 4, 5)],
                                      err_msg=key)
    np.testing.assert_array_equal(res_b["epoch_train_loss"], res_a["epoch_train_loss"][:3])
    for key in ("test_loss", "test_acc", "best_epoch", "nmi", "ari", "micro_f1@0.2"):
        assert res_c[key] == res_a[key], key
    assert_weights_only(tmp_path / "b")


def test_resume_restores_best_not_latest(small_ds, tmp_path):
    """When the latest checkpoint is a periodic save made after the best
    epoch, a resume with no epochs left evaluates the best epoch's
    parameters (ex_acm3025.py:247)."""
    cfg = flash_cfg(tmp_path, epochs=8, checkpoint_every=1, lr=1.0)  # diverges
    res_a = Trainer(small_ds, cfg, device="cpu", logger=Capture()).fit()
    assert res_a["best_epoch"] < cfg.train.epochs - 1, res_a["best_epoch"]
    store = CheckpointStore(cfg.train.checkpoint_dir, small_ds.name)
    assert store.latest_step() == cfg.train.epochs - 1

    cfg2 = flash_cfg(tmp_path, epochs=8, checkpoint_every=1, lr=1.0)
    res_b = Trainer(small_ds, cfg2, device="cpu", logger=Capture()).fit(resume=True)
    assert res_b["best_epoch"] == res_a["best_epoch"]
    assert res_b["test_loss"] == res_a["test_loss"]
    assert res_b["test_acc"] == res_a["test_acc"]


def test_checkpoint_resume_roundtrip(small_ds, tmp_path):
    """restore_latest gives the last best save's state: its parameters
    evaluate as the trainer's final (best) ones do."""
    cfg = flash_cfg(tmp_path)
    t = Trainer(small_ds, cfg, device="cpu", logger=Capture())
    t.fit()
    restored = t.restore_latest()
    assert restored is not None and restored["epoch"] == restored["best_step"] >= 0
    assert np.isfinite(restored["best_val_loss"])
    live = [float(v) for v in t.eval_step(t.masks["val"])[:2]]
    t.model.load_state_dict(restored["model"])
    again = [float(v) for v in t.eval_step(t.masks["val"])[:2]]
    assert again == live
    for k, v in t.final_params.items():
        torch.testing.assert_close(restored["model"][k], v, rtol=0, atol=0)
    assert t.restore_latest(step=restored["epoch"])["epoch"] == restored["epoch"]
    with pytest.raises(FileNotFoundError):
        t.restore_latest(step=10_000)


def test_resume_without_checkpoint_starts_fresh(small_ds, tmp_path):
    """fit(resume=True) over an empty checkpoint directory is a fresh run."""
    a = Trainer(small_ds, flash_cfg(tmp_path / "a", epochs=3), device="cpu",
                logger=Capture()).fit()
    b = Trainer(small_ds, flash_cfg(tmp_path / "b", epochs=3), device="cpu",
                logger=Capture()).fit(resume=True)
    np.testing.assert_array_equal(b["epoch_train_loss"], a["epoch_train_loss"])


def test_state_load_into_a_captured_step_raises(small_ds, tmp_path):
    """A trainer whose train step is already captured refuses a state load
    (the optimizer's load makes new tensors the graph would not read)."""
    Trainer(small_ds, flash_cfg(tmp_path, epochs=2), device="cpu", logger=Capture()).fit()
    t = Trainer(small_ds, flash_cfg(tmp_path, epochs=4), device="cpu", logger=Capture())
    t._train.graph = object()  # as after a capture
    with pytest.raises(RuntimeError, match="captured"):
        t.fit(resume=True)


def test_optimizer_keeps_its_capturable_setting(small_ds, tmp_path):
    """A checkpoint of an eager run loads into a capturable Adam (a captured
    run on the card) and keeps it capturable, its step counts float32 as
    capturable Adam keeps them; Adam's moments and the generator load."""
    t = Trainer(small_ds, flash_cfg(tmp_path, epochs=2), device="cpu", logger=Capture())
    t.fit()
    state = t.restore_latest()
    assert state["opt"]["param_groups"][0]["capturable"] is False
    u = Trainer(small_ds, flash_cfg(tmp_path, epochs=2), device="cpu", logger=Capture())
    u.opt = torch.optim.Adam(u.model.parameters(), lr=0.005, capturable=True)
    load_training_state(state, u.model, u.opt, u.rngs.device, (u._train,))
    assert all(g["capturable"] for g in u.opt.param_groups)
    for i, q in enumerate(u.model.parameters()):
        got, saved = u.opt.state[q], state["opt"]["state"][i]
        assert got["step"].dtype == torch.float32 and int(got["step"]) == state["epoch"] + 1
        torch.testing.assert_close(got["exp_avg"], saved["exp_avg"], rtol=0, atol=0)
    torch.testing.assert_close(u.rngs.device.get_state(), state["rng"], rtol=0, atol=0)


def sampled_cfg(ckpt, epochs=3, **train):
    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.model.hid_units, cfg.model.n_heads = (8,), (2, 1)
    cfg.model.attn_drop = cfg.model.ffd_drop = 0.3
    cfg.train.epochs, cfg.train.patience = epochs, 100
    cfg.train.checkpoint_dir = str(ckpt)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


@pytest.mark.parametrize("sampler,spc,resume_spc,trip", [
    # 3 batches an epoch; the guard trips at the trip-th dispatch
    ("host", 1, 1, 5),      # epoch 1, cursor 2
    ("device", 1, 1, 4),    # epoch 1, cursor 1
    ("device", 2, 2, 3),    # a 2-step chunk and the tail a single step: epoch 1, cursor 2
    ("device", 1, 2, 4),    # epoch 1, cursor 1, resumed at steps_per_call 2: the
                            # chunks start at the cursor, off a fresh run's boundaries
])
def test_sampled_preempt_resume_is_bitwise(small_ds, tmp_path, sampler, spc, resume_spc,
                                           trip):
    """The sampled trainer preempted mid-epoch (the guard polled once a
    dispatch) and resumed from its batch cursor: the resumed steps' losses,
    the epochs' means and the final metrics equal the uninterrupted run's."""
    kw = dict(batch_size=16, fanout=6, sampler=sampler, device="cpu")
    a = SampledTrainer(small_ds, sampled_cfg(tmp_path / "a"), steps_per_call=spc,
                       logger=Capture(), **kw).fit()

    cap_b = Capture()
    b = SampledTrainer(small_ds, sampled_cfg(tmp_path / "b"), steps_per_call=spc,
                       logger=cap_b, guard=TripAfter(trip), **kw).fit()
    assert b["preempted"] is True
    (epoch, cursor), = [r["preempted_at"] for r in cap_b.rows if "preempted_at" in r]
    store = CheckpointStore(str(tmp_path / "b"), f"{small_ds.name}_sampled")
    assert store.latest_step() == epoch * _EPOCH_STRIDE + cursor
    assert store.load()["cursor"] == cursor > 0

    cap_c = Capture()
    c = SampledTrainer(small_ds, sampled_cfg(tmp_path / "b"), steps_per_call=resume_spc,
                       logger=cap_c, **kw).fit(resume=True)
    done = len(b["step_train_loss"])
    np.testing.assert_array_equal(b["step_train_loss"], a["step_train_loss"][:done])
    np.testing.assert_array_equal(c["step_train_loss"], a["step_train_loss"][done:])
    np.testing.assert_array_equal(c["epoch_train_loss"], a["epoch_train_loss"][epoch:])
    for key in ("test_loss", "test_acc", "best_epoch"):
        assert c[key] == a[key], key
    assert min(cap_c.column("train_loss")) == epoch
    assert_weights_only(tmp_path / "b")


def test_inductive_preempt_resume_is_bitwise(tmp_path):
    """The inductive trainer with dropout, preempted after epoch 2 and
    resumed in a fresh trainer: epochs 3-5 and the test metrics equal the
    uninterrupted run's."""
    ds = ppi_synthetic(n_graphs=8, nodes_per_graph=24, n_feats=10, n_labels=5, seed=5)
    kw = dict(hid_units=(8,), n_heads=(2, 2), lr=0.02, batch_size=2, seed=0, patience=100,
              attn_drop=0.2, ffd_drop=0.2, device="cpu")
    rows = lambda res: [(h["epoch"], h["train_loss"], h["val_loss"], h["val_micro_f1"])
                        for h in res["history"]]
    a = InductiveTrainer(ds, checkpoint_dir=str(tmp_path / "a"), **kw).fit(
        epochs=6, log=lambda r: None)
    ck = str(tmp_path / "ck")
    guard = PreemptionGuard(install=False)
    b = InductiveTrainer(ds, checkpoint_dir=ck, checkpoint_every=2, guard=guard, **kw).fit(
        epochs=6, log=lambda r: r.get("epoch") == 2 and guard.trip())
    assert b["preempted"] is True and len(b["history"]) == 3
    c = InductiveTrainer(ds, checkpoint_dir=ck, **kw).fit(epochs=6, log=lambda r: None,
                                                          resume=True)
    assert rows(c) == rows(a)[3:]
    assert rows(b) == rows(a)[:3]
    for key in ("best_epoch", "test_loss", "test_micro_f1"):
        assert c[key] == a[key], key
    assert_weights_only(ck)
    state = CheckpointStore(ck, f"{ds.name}_inductive").load()
    # seed 0: epoch 3's batch order is default_rng(0 * 1_000_003 + 3)
    assert state["epoch"] == 2
    assert state["order_rng"] == np.random.default_rng(3).bit_generator.state


def test_run_threads_checkpoints_to_the_inductive_trainer(tmp_path, monkeypatch):
    """run() passes checkpoint_dir and checkpoint_every to the inductive
    trainer (han_tpu/train/trainer.py:489-500)."""
    from han_tpu_torch.train import trainer as ttrainer

    ds = ppi_synthetic(n_graphs=6, nodes_per_graph=16, n_feats=8, n_labels=3, seed=1)
    cfg = preset("ppi")
    cfg.model.hid_units, cfg.model.n_heads = (4,), (2, 2)
    cfg.train.epochs, cfg.train.checkpoint_every = 2, 1
    cfg.train.checkpoint_dir = str(tmp_path)
    ttrainer.run(cfg, ds, device="cpu")
    assert CheckpointStore(str(tmp_path), f"{ds.name}_inductive").latest_step() == 1
