"""The mp mesh axis: HAN's meta-path towers split over ranks (nn/models.py,
train/trainer.py), in spawned gloo worlds.

- mp = 2 (world of 2) on stacked bcsr graphs with P = 2 and P = 4
  meta-paths, and mp = 2 × graph = 2 (world of 4) on the stacked
  partitioned_bcsr, P = 4: the trainer (the dblp preset, dropouts 0.6)
  against one device with vmap_towers: losses and test loss within rtol
  2e-4 (each rank draws all P towers' masks and keeps its own, so the
  dropout is the one-device run's); the parameters equal on every rank
  after training (the towers' gradients summed over the mp axis).
- The one-device run with vmap_towers against the sequential towers at
  dropout 0: the same losses (rtol 2e-4).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch_parallel_ranks as ranks  # noqa: E402
from han_tpu_torch.parallel import launch  # noqa: E402

EPOCHS = 3
# (graph_format, graph axis, mp axis, meta-paths)
MP2 = [("bcsr", 1, 2, 2), ("bcsr", 1, 2, 4)]
MP2_GRAPH2 = [("partitioned_bcsr", 2, 2, 4)]


@pytest.fixture(scope="module")
def world2():
    return launch.spawn(ranks.mp_checks, 2, "gloo", args=(MP2, EPOCHS))


@pytest.fixture(scope="module")
def world4():
    return launch.spawn(ranks.mp_checks, 4, "gloo", args=(MP2_GRAPH2, EPOCHS))


@pytest.fixture(scope="module")
def single():
    """One device, vmap_towers on stacked bcsr, for P = 2 and 4."""
    return {p: ranks.train("bcsr", 1, EPOCHS, n_metapaths=p, vmap_towers=True)
            for p in (2, 4)}


@pytest.mark.parametrize("run", MP2 + MP2_GRAPH2, ids=lambda r: f"{r[0]}-g{r[1]}-mp{r[2]}-P{r[3]}")
def test_mp_trainer_matches_one_device(request, single, run):
    world = request.getfixturevalue("world2" if run in MP2 else "world4")
    runs = [rank[run] for rank in world]
    want = single[run[3]]
    np.testing.assert_allclose(runs[0]["losses"], want["losses"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(runs[0]["test_loss"], want["test_loss"], rtol=2e-4, atol=2e-5)
    for other in runs[1:]:
        assert other["losses"] == runs[0]["losses"]
        for k, v in runs[0]["state"].items():
            np.testing.assert_array_equal(other["state"][k], v, err_msg=k)
    assert runs[0]["state"]["towers.layers.0.kernel"].shape[0] == run[3]


def test_vmap_towers_trainer_matches_sequential_at_dropout_0(monkeypatch):
    """At dropout 0 the stacked towers train as the sequential ones (the
    same initial weights from one generator)."""
    from han_tpu_torch.train import config

    orig = config.preset

    def no_dropout(name):
        cfg = orig(name)
        cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
        return cfg

    monkeypatch.setattr(ranks, "preset", no_dropout)
    vm = ranks.train("bcsr", 1, EPOCHS, vmap_towers=True)
    seq = ranks.train("bcsr", 1, EPOCHS, vmap_towers=False)
    np.testing.assert_allclose(vm["losses"], seq["losses"], rtol=2e-4, atol=2e-5)
