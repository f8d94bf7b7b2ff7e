"""The GAT cell's own files: a tiny copy of ``gat_ppi.inductive`` end to
end on the CPU, ``counts/gat.py`` against a hand count, and the plain
reference's control and faults against its float32 run."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import compare, data
from benchmark.counts import gat as counts
from benchmark.reference import gat as ref
from conftest import REPO

# the tiny cell: 10 graphs of 40-150 nodes (6 train: 3 batches of 2), the
# published depth and residual at hid 40 (D > 32), heads (2, 2, 3), 5 labels
TINY_PROGRAM = {"hid_units": [40, 40], "n_heads": [2, 2, 3]}
TINY_INPUTS = {"split_graphs": [6, 2, 2], "split_nodes": [600, 200, 200], "min_nodes": 40,
               "max_nodes": 150, "sizes_seed": 1, "undirected_edges": 1600, "n_feats": 12,
               "n_labels": 5}
# limits as the real cell's are set (benchmark/control.py --cpu-dry-run, 6
# seeds on the CPU through the flash kernels' plain versions): largest
# sound reading loss 1.7e-7, gradient 5.2e-7, update 3.7e-7, evaluation
# 1.7e-7; TF32 in the reference at least 7.0e-7, 2.0e-4, 1.8e-4 and
# 1.1e-6; the faults at least 6.5e-4, 9.4e-4, 9.9e-3 and 7.6e-4
TINY_LIMITS = {"loss_gap": 6e-7, "grad_gap": 5e-6, "update_gap": 3e-5, "eval_gap": 6e-7}


def add_tiny_gat(checkout):
    """The cell ``tiny_gat.inductive`` in a tiny checkout (conftest.py)."""
    bench = checkout / "benchmark"
    conf = json.loads((bench / "configs" / "gat_ppi.json").read_text())
    conf["name"] = "tiny_gat"
    conf["program"]["model"].update(TINY_PROGRAM)
    conf["inputs"].update(TINY_INPUTS)
    (bench / "configs" / "tiny_gat.json").write_text(json.dumps(conf))
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_gat", "source": "a test", "reduced": ["split_nodes"],
                            "file": "benchmark/configs/tiny_gat.json", "why": "a test"})
    spec["workloads"].append({"name": "tiny_gat.inductive", "config": "tiny_gat",
                              "traffic": "inductive", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "gat_ppi.inductive" in m.get("workloads", ()):
            m["workloads"].append("tiny_gat.inductive")
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    mix = json.loads((bench / "traffic" / "gat_ppi.inductive.json").read_text())
    mix.update(config="tiny_gat", trace_seconds=1)
    (bench / "traffic" / "tiny_gat.inductive.json").write_text(json.dumps(mix))
    (bench / "limits" / "tiny_gat.inductive.json").write_text(json.dumps(TINY_LIMITS))
    return checkout


def test_tiny_cell_runs_and_is_correct(tiny_checkout, harness_runner):
    ck = add_tiny_gat(tiny_checkout)
    rc, res, err = harness_runner(ck, "tiny_gat.inductive", seed=2 ** 31 + 77)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-2000:]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["train_step_ms"]["value"] > 0 and "setup_s" in res["metrics"]
    assert set(res["checks"]) == set(TINY_LIMITS) | {"failed_steps"}
    rc, res, err = harness_runner(ck, "tiny_gat.inductive", trace=1, seed=2 ** 31 + 78)
    assert rc == 0 and res["correct"] is True, err[-3000:]
    # the program's counters: about every tile of these graphs is occupied
    per_edge = res["metrics"]["tile_elems_per_edge.ppi"]["value"]
    assert 20.0 < per_edge < 200.0


def test_witness_reads_the_tiny_cell(tiny_checkout, tmp_path):
    """witness_gat.py on the tiny cell: the program, the float32 reference
    and a nudged one against each other and the float64 reference, every
    validation pass read; round-off alone, so all within the limits."""
    ck = add_tiny_gat(tiny_checkout)
    out = tmp_path / "w.jsonl"
    env = {**os.environ, "PYTHONPATH": f"{ck}{os.pathsep}{REPO}", "OMP_NUM_THREADS": "2"}
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, str(ck / "benchmark" / "witness_gat.py"),
                           "--workload", "tiny_gat.inductive", "--seed-list", str(2 ** 31 + 79),
                           "--nudges", "1", "--cpu-dry-run", "--out", str(out)],
                          cwd=ck, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = json.loads(out.read_text().splitlines()[0])
    assert len(row["prog_evals"]) == len(row["ref64_evals"]) == 3
    for nums in (row["prog_vs_ref"], row["prog_vs_f64"], row["ref_vs_f64"],
                 row["nudged"][0]["vs_ref"]):
        assert compare.verdict(nums, TINY_LIMITS), nums


def test_flops_match_a_hand_count():
    """Two layers (one hidden of 2 heads x 3, the output of 2 heads at 4
    labels) on 10 nodes and 30 edges, input width 5."""
    settings = {"model": {"n_heads": [2, 2], "hid_units": [3], "residual": True}}
    shape = {"n_rows": 10, "edges": 30, "eval_rows": 4, "eval_edges": 7, "in_dim": 5,
             "n_classes": 4}
    # layer 0: projection 2·10·5·2·3 = 600, logits 4·10·2·3 = 240, aggregation
    # 2·30·2·3 = 360; layer 1 (input 6, no residual: the output layer):
    # 2·10·6·2·4 = 960, 4·10·2·4 = 320, 2·30·2·4 = 480; the average 10·2·4 = 80
    train = 600 + 240 + 360 + 960 + 320 + 480 + 80
    # the evaluation: 4 nodes, 7 edges
    ev = (2 * 4 * 5 * 6 + 4 * 4 * 6 + 2 * 7 * 6) + (2 * 4 * 6 * 8 + 4 * 4 * 8 + 2 * 7 * 8) \
        + 4 * 8
    assert counts.model_flops(settings, shape, 3, 2) == 3 * 3 * train + 2 * ev
    # a middle layer whose input width differs from its head dim adds its
    # residual projection: hid (3, 3) → layer 1 takes 6 inputs into 2 x 3
    deep = {"model": {"n_heads": [2, 2, 2], "hid_units": [3, 3], "residual": True}}
    assert counts.layers(deep, shape)[1] == (6, 2, 3, True)
    assert counts.layers({"model": {**deep["model"], "residual": False}}, shape)[1][3] is False


def _tiny_reference_run(products="f32", fault=None):
    inputs = data.make_inputs({"generator": "ppi_graphs", "label_density": 0.3,
                               **TINY_INPUTS}, 2 ** 31 + 5)
    torch.manual_seed(0)
    dims = [(12, 2, 40), (80, 2, 40), (80, 3, 5)]
    params = {}
    for i, (f, k, d) in enumerate(dims):
        params[f"layers.{i}.kernel"] = torch.randn(f, k, d) / f ** 0.5
        params[f"layers.{i}.attn_dst_kernel"] = torch.randn(k, d) / d ** 0.5
        params[f"layers.{i}.attn_src_kernel"] = torch.randn(k, d) / d ** 0.5
        for b in ("attn_dst_bias", "attn_src_bias"):
            params[f"layers.{i}.{b}"] = torch.zeros(k)
        params[f"layers.{i}.bias"] = torch.zeros(k, d)
    params["layers.1.res_kernel"] = torch.randn(80, 2, 40) / 80 ** 0.5

    def graph(g):
        n = int(inputs.sizes[g])
        adj = torch.zeros((n, n), dtype=torch.bool)
        adj[tuple(torch.from_numpy(a.astype(np.int64)) for a in inputs.edges[g])] = True
        return ref.Graph(torch.from_numpy(inputs.features[g, :n]),
                         torch.from_numpy(inputs.labels[g, :n]), adj)

    train = inputs.graph_ids(0)
    batches = [ref.Batch([graph(train[i]), graph(train[i + 1])], 2) for i in (0, 2, 4)]
    evals = [ref.Batch([graph(g) for g in inputs.graph_ids(1)], 2)]
    settings = {"model": {"n_heads": [2, 2, 3], "residual": True, "attn_drop": 0.0,
                          "ffd_drop": 0.0}, "train": {"lr": 0.005, "l2_coef": 0.0}}
    return params, ref.follow(settings, params, batches, evals={1: evals, 2: evals, 3: evals},
                              gen_seed=0, device="cpu", products=products, fault=fault)


@pytest.mark.parametrize("kw", [{"products": "tf32"}, {"fault": "half_batch"},
                                {"fault": "altered"}])
def test_control_and_faults_depart(kw):
    """The reference in TF32 products and with each fault departs from its
    float32 run beyond the tiny cell's limits, by one number at least."""
    params, base = _tiny_reference_run()
    _, other = _tiny_reference_run(**kw)
    nums = compare.numbers(other, base, params)
    assert not compare.verdict(nums, TINY_LIMITS), nums
    # and the float32 run repeats itself exactly
    _, again = _tiny_reference_run()
    assert compare.verdict(compare.numbers(again, base, params), {k: 0.0 for k in TINY_LIMITS})
