"""Data-parallel sampled training (train/sampled.py:DPSampledTrainer) in a
spawned gloo world of 2 CPU ranks, against han_tpu's DPSampledTrainer under
make_mesh(graph=2, heads=1) and against the port's one-device
SampledTrainer. The rank body is tests/torch_parallel_ranks.py:
dp_sampled_checks.

- Three train steps from han_tpu's initial weights on the same seed
  batches, dropout off, L2 on, at a fanout above every degree: loss and
  accuracy within rtol 1e-5, parameters within rtol 2e-4, atol 1e-6
  (han_tpu's bounds, tests/test_sampled_trainer.py:196-236), equal on
  both ranks.
- run() with mesh.graph_axis = 2 trains through DPSampledTrainer: its
  losses and test metrics against the one-device run at full
  neighbourhoods (rtol 1e-5, atol 1e-6); the device sampler raises
  NotImplementedError through run().
- Resume at dropout 0.6: 2 epochs saved every epoch, then a fresh trainer
  resumed to 3, equals 3 uninterrupted epochs bit for bit (each rank's
  dropout generator state is in rank 0's checkpoint).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from han_tpu.graph import synthetic as jsyn  # noqa: E402
from han_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from han_tpu.train import sampled as jsampled  # noqa: E402
from han_tpu.train.config import preset as jpreset  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from han_tpu_torch.graph import synthetic as tsyn  # noqa: E402
from han_tpu_torch.nn.convert import params_from_flax  # noqa: E402
from han_tpu_torch.parallel import launch  # noqa: E402
from han_tpu_torch.train import sampled as tsampled  # noqa: E402
from han_tpu_torch.train.trainer import MetricLogger  # noqa: E402

DS = dict(n_nodes=128, n_feats=24, n_classes=3, n_metapaths=2, avg_degree=6.0,
          train_per_class=16, n_val=24, seed=3)
STEPS = 3


def fanout(ds):
    # +1: the trainers add self-loops
    return 1 + max(int(np.diff(a.indptr).max()) for a in ds.metapath_adjs)


def batches(ds):
    seeds = np.where(ds.train_mask)[0].astype(np.int32)
    return [(seeds[16 * i:16 * (i + 1)], np.ones(16, bool), i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """han_tpu's DPSampledTrainer: initial weights from its one-device
    trainer (as its own test takes them), then STEPS train steps."""
    ds = jsyn.planted_hetero(**DS)
    f = fanout(ds)
    cfg = ranks.sampled_cfg(f, 1)
    jcfg = jpreset("acm")
    for sec in ("model", "train"):
        for key, val in vars(getattr(cfg, sec)).items():
            setattr(getattr(jcfg, sec), key, val)
    jcfg.train.checkpoint_dir = str(tmp_path_factory.mktemp("jax_checkpoints"))
    single = jsampled.SampledTrainer(ds, jcfg, batch_size=16, fanout=f,
                                     block_size=16 * (f + 1))
    dp = jsampled.DPSampledTrainer(ds, jcfg, mesh=j_make_mesh(graph=2, heads=1),
                                   batch_size=16, fanout=f, block_size=8 * (f + 1))
    b1 = single._make_batch(*batches(ds)[0])
    params = single._init_params_from(jax.random.PRNGKey(0), b1[0], b1[1])
    state = {k: v.numpy() for k, v in params_from_flax(params).items()}
    opt, rng, steps = dp.tx.init(params), jax.random.PRNGKey(7), []
    for seeds, valid, sample_seed in batches(ds):
        params, opt, rng, loss, acc = dp._train_step(
            params, opt, rng, *dp._make_batch(seeds, valid, sample_seed))
        steps.append((float(loss), float(acc)))
    return {"init": state, "steps": steps,
            "state": {k: v.numpy() for k, v in params_from_flax(params).items()}}


@pytest.fixture(scope="module")
def world(jax_run, tmp_path_factory):
    ds = tsyn.planted_hetero(**DS)
    return launch.spawn(ranks.dp_sampled_checks, 2, "gloo",
                        args=(ds, jax_run["init"], batches(ds), fanout(ds),
                              str(tmp_path_factory.mktemp("dp_sampled"))))


def test_dp_step_matches_jax(world, jax_run):
    for rank in world:
        for (loss, acc), (jloss, jacc) in zip(rank["steps"], jax_run["steps"]):
            np.testing.assert_allclose(loss, jloss, rtol=1e-5)
            np.testing.assert_allclose(acc, jacc, rtol=1e-5)
        for k, v in jax_run["state"].items():
            np.testing.assert_allclose(rank["state"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)
    for k, v in world[0]["state"].items():
        np.testing.assert_array_equal(world[1]["state"][k], v, err_msg=k)


def test_run_trains_data_parallel_as_one_device(world):
    ds = tsyn.planted_hetero(**DS)
    cfg = ranks.sampled_cfg(fanout(ds), 2)
    one = tsampled.SampledTrainer(ds, cfg, batch_size=16, fanout=fanout(ds), device="cpu",
                                  logger=MetricLogger(echo=False)).fit()
    for rank in world:
        np.testing.assert_allclose(rank["run"]["losses"], one["epoch_train_loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rank["run"]["test"], (one["test_loss"], one["test_acc"]),
                                   rtol=1e-5, atol=1e-6)
        assert "device sampler" in rank["device_sampler"]


def test_resume_continues_every_ranks_dropout(world):
    for rank in world:
        runs = rank["resume"]
        assert len(runs["first"]["losses"]) == 2 and len(runs["resumed"]["losses"]) == 1
        assert runs["first"]["losses"] + runs["resumed"]["losses"] == \
            runs["uninterrupted"]["losses"]
        for k, v in runs["uninterrupted"]["state"].items():
            np.testing.assert_array_equal(runs["resumed"]["state"][k], v, err_msg=k)
    assert world[0]["resume"]["uninterrupted"]["losses"] == \
        world[1]["resume"]["uninterrupted"]["losses"]
