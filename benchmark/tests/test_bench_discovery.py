"""A configuration, an input generator, a traffic mix, a per-layer metric
and a kernel group are each added as a new file, with no edit to a file
that is there but BENCHMARK.json, and the harness picks them up by name;
every key of a configuration's program settings reaches the program."""

import json

import pytest

from benchmark import harness, trace

# a generator of the benchmark's own kind: a ring with chords, three classes
RING = '''
import numpy as np
import scipy.sparse as sp

from benchmark.data import Inputs


def make_inputs(args, seed):
    rng = np.random.default_rng(seed)
    n, f, c = args["n_nodes"], args["n_feats"], args["n_classes"]
    adjs = []
    for hop in args["hops"]:
        i = np.arange(n)
        j = (i + hop) % n
        a = sp.coo_matrix((np.ones(2 * n, np.float32),
                           (np.concatenate([i, j]), np.concatenate([j, i]))), shape=(n, n))
        adjs.append(a.tocsr())
    y = rng.integers(0, c, n)
    labels = np.eye(c, dtype=np.float32)[y]
    train = np.zeros(n, bool)
    train[: n // 2] = True
    val = np.zeros(n, bool)
    val[n // 2: 3 * n // 4] = True
    return Inputs(adjs, rng.random((n, f)).astype(np.float32), labels, train, val,
                  ~(train | val))
'''


def test_new_files_are_found_by_name(tiny_checkout, harness_runner):
    bench = tiny_checkout / "benchmark"
    (bench / "generators" / "ring.py").write_text(RING)
    conf = json.loads((bench / "configs" / "tiny_dblp.json").read_text())
    conf["name"] = "tiny_ring"
    conf["inputs"] = {"generator": "ring", "n_nodes": 90, "n_feats": 7, "n_classes": 3,
                      "hops": [1, 5]}
    # another attention path than the dblp configuration's flash on BCSR tiles
    conf["program"]["model"].update(impl="dense", attn_drop=0.0)
    conf["program"]["data"]["graph_format"] = "dense"
    conf["program"]["train"]["lr"] = 0.01
    (bench / "configs" / "tiny_ring.json").write_text(json.dumps(conf))
    (bench / "traffic" / "tiny_ring.full.json").write_text(json.dumps(
        {"config": "tiny_ring", "loop": "epochs", "warm_steps": 3, "trace_seconds": 1}))
    (bench / "limits" / "tiny_ring.full.json").write_text(
        (bench / "limits" / "tiny_dblp.full.json").read_text())
    (bench / "metrics" / "steps_and_gemm.py").write_text(
        "def read(run):\n"
        "    return run['train_steps'] + run['trace']['group_s']['gemm']\n")
    (bench / "kernels" / "gemm.json").write_text(json.dumps(
        {"layer": "dense ops", "patterns": ["gemm"]}))
    spec = json.loads((tiny_checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_ring", "source": "a test", "reduced": ["n_nodes"],
                            "file": "benchmark/configs/tiny_ring.json", "why": "a test"})
    spec["workloads"].append({"name": "tiny_ring.full", "config": "tiny_ring",
                              "traffic": "full", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_and_gemm", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "dense ops",
                              "moves": "train_step_ms", "workloads": ["tiny_ring.full"]})
    (tiny_checkout / "BENCHMARK.json").write_text(json.dumps(spec))

    assert "gemm" in trace.load_groups(bench)
    rc, res, err = harness_runner(tiny_checkout, "tiny_ring.full", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    # the traced part of the window: its steps, and no gemm on the CPU
    assert 0 < res["metrics"]["steps_and_gemm"]["value"] <= res["attempted"]
    rc, res, err = harness_runner(tiny_checkout, "tiny_ring.full", trace=0)
    assert rc == 0 and "steps_and_gemm" not in res["metrics"]
    assert res["correct"] is True, res["checks"]


def test_every_setting_reaches_the_programs_config():
    from han_tpu_torch.train.config import Config

    settings = harness.merged_settings(
        {"program": {"model": {"vmap_towers": True, "residual": True, "hid_units": [4, 4]},
                     "mesh": {"head_axis": 2}}},
        {"program": {"model": {"residual": False}, "train": {"sampler": "device"}}})
    cfg = harness.apply_settings(Config(), settings)
    assert cfg.model.vmap_towers is True and cfg.model.residual is False
    assert cfg.model.hid_units == (4, 4) and cfg.mesh.head_axis == 2
    assert cfg.train.sampler == "device"


@pytest.mark.parametrize("settings", [{"model": {"no_such_key": 1}},
                                      {"no_such_section": {"lr": 1.0}}])
def test_an_unknown_setting_is_refused(settings):
    from han_tpu_torch.train.config import Config

    with pytest.raises(ValueError):
        harness.apply_settings(Config(), settings)
