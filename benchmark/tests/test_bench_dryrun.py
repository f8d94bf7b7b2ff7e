"""Each cell's loop at a tiny size on the CPU through the program's plain
paths, end to end: set-up, window, the reference, the comparison and the
result line, in a fresh interpreter as a real run is."""

import json

import pytest

from conftest import CELLS


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_cell_runs_and_is_correct(tiny_checkout, harness_runner, workload):
    rc, res, err = harness_runner(tiny_checkout, workload, seed=2 ** 31 + 77)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-2000:]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and "peak_mem_gib" not in res["metrics"]  # no card
    step = "train_step_ms" if workload.endswith(".full") else "train_step_ms.sampled"
    assert res["metrics"][step]["value"] > 0
    assert list(res)[-1] == "checks"
    limits = json.loads((tiny_checkout / "benchmark" / "limits" / f"{workload}.json")
                        .read_text())
    assert set(res["checks"]) == set(limits) | {"failed_steps"}
    # the compared numbers are the last lines on standard error too
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_traced_run_reads_per_layer_metrics(tiny_checkout, harness_runner, workload):
    rc, res, err = harness_runner(tiny_checkout, workload, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the device metrics find nothing to read
    assert "device_idle_share" not in res["metrics"]


def test_same_seed_same_inputs_and_weights():
    import numpy as np
    import torch

    from benchmark import data, weights

    cfg = dict(generator="scale_dataset", n_nodes=640, avg_degree=9, n_metapaths=2,
               n_feats=4, n_classes=3, n_train=32, n_val=8, n_test=8)
    a, b = data.make_inputs(cfg, 2 ** 31 + 5), data.make_inputs(cfg, 2 ** 31 + 5)
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.raw_cols[1], b.raw_cols[1])
    c = data.make_inputs(cfg, 2 ** 31 + 6)
    assert not np.array_equal(a.features, c.features)
    shapes = {"towers.0.layers.0.kernel": (4, 8, 8), "semantic.w_omega": (64, 128),
              "classifiers.0.bias": (3,)}
    w1, w2 = (weights.make_weights(shapes, 2 ** 31 + 5, "cpu") for _ in range(2))
    for k in shapes:
        assert torch.equal(w1[k], w2[k])
    assert not w1["classifiers.0.bias"].any()


def test_no_card_no_result(tiny_checkout):
    import os
    import subprocess
    import sys

    from conftest import REPO

    env = {**os.environ, "PYTHONPATH": f"{tiny_checkout}{os.pathsep}{REPO}",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "tiny_dblp.full", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tiny_checkout, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    # a directory with only BENCHMARK.json and the benchmark's files
    import os
    import shutil
    import subprocess
    import sys

    from conftest import BENCH, REPO

    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "han_dblp.full",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
