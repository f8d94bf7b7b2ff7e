"""Data-parallel inductive training (train/inductive.py with a mesh) in a
spawned gloo world of 2 CPU ranks, against the port's one-device trainer
and han_tpu's InductiveTrainer under make_mesh(graph=2). The rank body is
tests/torch_parallel_ranks.py:dp_inductive_checks.

- 3 epochs of batches of 4 graphs (2 a rank) from han_tpu's initial
  weights, dropout off, L2 on: the loss trajectory within rtol 2e-5, atol
  1e-6 of the one-device run and of han_tpu's (tests/test_trainer.py:
  183-199); the test micro-F1 alike; the parameters equal on both ranks.
- run() on the ppi preset with mesh.graph_axis = 2 trains data-parallel
  (a global batch of max(2, 2) graphs).
- Resume at dropouts 0.3: 2 epochs saved every epoch, then a fresh trainer
  resumed to 3, equals 3 uninterrupted epochs bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from han_tpu.datasets.ppi import ppi_synthetic as jppi_synthetic  # noqa: E402
from han_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from han_tpu.train.inductive import InductiveTrainer as JInductive  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from han_tpu_torch.datasets.ppi import ppi_synthetic  # noqa: E402
from han_tpu_torch.nn.convert import params_from_flax  # noqa: E402
from han_tpu_torch.parallel import launch  # noqa: E402
from han_tpu_torch.train.inductive import InductiveTrainer  # noqa: E402

DS = dict(n_graphs=8, nodes_per_graph=24, n_feats=10, n_labels=5, seed=4)
TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_run():
    t = JInductive(jppi_synthetic(**DS), batch_size=4, mesh=j_make_mesh(graph=2),
                   **ranks.INDUCTIVE)
    state = {k: v.numpy() for k, v in params_from_flax(t.params).items()}
    r = t.fit(epochs=3, log=lambda rec: None)
    return {"init": state, "losses": [h["train_loss"] for h in r["history"]],
            "test_f1": r["test_micro_f1"]}


@pytest.fixture(scope="module")
def world(jax_run, tmp_path_factory):
    return launch.spawn(ranks.dp_inductive_checks, 2, "gloo",
                        args=(ppi_synthetic(**DS), jax_run["init"],
                              str(tmp_path_factory.mktemp("dp_inductive"))))


def test_dp_trajectory_matches_one_device_and_jax(world, jax_run):
    import torch

    one = InductiveTrainer(ppi_synthetic(**DS), batch_size=4, device="cpu", **ranks.INDUCTIVE)
    one.model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_run["init"].items()})
    r = one.fit(epochs=3, log=lambda rec: None)
    for rank in world:
        for want in (r["epoch_train_loss"], jax_run["losses"]):
            np.testing.assert_allclose(rank["losses"], want, **TOL)
        for want in (r["test_micro_f1"], jax_run["test_f1"]):
            np.testing.assert_allclose(rank["test_f1"], want, **TOL)
    for k, v in world[0]["state"].items():
        np.testing.assert_array_equal(world[1]["state"][k], v, err_msg=k)


def test_run_trains_ppi_data_parallel(world):
    for rank in world:
        assert len(rank["run"]["losses"]) == 1 and np.isfinite(rank["run"]["losses"]).all()
        assert 0.0 <= rank["run"]["test_f1"] <= 1.0
    assert world[0]["run"] == world[1]["run"]


def test_resume_continues_every_ranks_dropout(world):
    for rank in world:
        runs = rank["resume"]
        assert runs["first"]["losses"] + runs["resumed"]["losses"] == \
            runs["uninterrupted"]["losses"]
        for k, v in runs["uninterrupted"]["state"].items():
            np.testing.assert_array_equal(runs["resumed"]["state"][k], v, err_msg=k)
