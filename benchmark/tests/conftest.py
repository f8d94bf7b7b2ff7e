"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``;
the repository's ``pytest tests/`` does not collect them).

``card`` marks a test that needs a CUDA card; such a test decides inside
itself whether there is one and skips with a reason where there is not.
``tiny_checkout`` is a temporary copy of the benchmark with two tiny
cells of the configurations' shapes and traffic mixes (``tiny_dblp.full``,
``tiny_sampled.device``), and ``run_harness`` runs
a cell of such a copy on the CPU in a fresh interpreter (no JAX loaded, as
in a real run), optionally with Python code run first, which may plant a
fault in the program.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
TINY = {
    "tiny_dblp": ("han_dblp", {},
                  {"n_nodes": 300, "n_feats": 20, "edges_with_self_loops": [340, 4300, 30000],
                   "train_per_class": 20, "n_val": 40}),
    "tiny_sampled": ("han_sampled_100m", {"train": {"batch_size": 32, "fanout": 4}},
                     {"n_nodes": 2000, "avg_degree": 10, "n_train": 96, "n_val": 48,
                      "n_test": 64}),
}
CELLS = {"tiny_dblp.full": "han_dblp.full", "tiny_sampled.device": "han_sampled_100m.device"}
# the tiny cells' limits, set as the real cells' are (benchmark/control.py
# --cpu-dry-run, 6 seeds on the CPU through the plain paths), over the
# numbers that each real cell compares: largest sound reading, dblp /
# sampled: loss 1.9e-6, first loss 0, grad 1.6e-6 / 1.7e-7, update 3.1e-4,
# median update 5.7e-8, eval 7.8e-7 / 1.1e-7; least of TF32 (where 3x
# above) and the faults: loss 5.4e-3, first loss 5.3e-7, grad 4.8e-4 /
# 2.1e-4, update 2.8e-2, median update 1.6e-5, eval 1.0e-2 / 2.7e-6. A
# sampled CPU run now and then reads first loss 1.3e-6, grad 5.3e-6 and
# median update 1.2e-6 where another run of its seed reads 0, 7.6e-8 and
# 2.1e-8, so the sampled limits stay above those readings; TF32 is caught
# there by the gradient
TINY_LIMITS = {
    "tiny_dblp.full": {"loss_gap": 1e-4, "grad_gap": 3e-5, "update_gap": 3e-3,
                       "eval_gap": 1e-4},
    "tiny_sampled.device": {"first_loss_gap": 2e-6, "grad_gap": 6e-6,
                            "median_update_gap": 1.2e-5, "eval_gap": 6e-7},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


def make_tiny_checkout(dest: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark under ``dest`` whose BENCHMARK.json also
    holds the tiny cells; returns ``dest``."""
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (base, program, inputs) in TINY.items():
        conf = json.loads((BENCH / "configs" / f"{base}.json").read_text())
        conf["name"] = name
        for sec, keys in program.items():
            conf["program"][sec].update(keys)
        conf["inputs"].update(inputs)
        (dest / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(conf))
        spec["configs"].append({"name": name, "source": "a test", "reduced": ["n_nodes"],
                                "file": f"benchmark/configs/{name}.json", "why": "a test"})
    for name, base in CELLS.items():
        config, traffic = name.split(".")
        spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "a test"})
        mix = json.loads((BENCH / "traffic" / f"{base}.json").read_text())
        mix.update(config=config, trace_seconds=1)
        (dest / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        (dest / "benchmark" / "limits" / f"{name}.json").write_text(
            json.dumps(TINY_LIMITS[name]))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if base in m.get("workloads", ()):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture
def tiny_checkout(tmp_path):
    return make_tiny_checkout(tmp_path)


def run_harness(checkout: pathlib.Path, workload: str, *, seconds=1.0, trace=0, seed=7,
                before: str = "", timeout=600):
    """(returncode, parsed last stdout line or None, stderr) of one CPU run
    of ``workload`` in ``checkout``."""
    code = (f"{before}\nimport sys\nfrom benchmark import harness\n"
            f"sys.exit(harness.main(['--workload', {workload!r}, '--seed', '{seed}', "
            f"'--seconds', '{seconds}', '--trace', '{trace}', '--cpu-dry-run']))")
    env = {**os.environ, "PYTHONPATH": f"{checkout}{os.pathsep}{REPO}",
           "OMP_NUM_THREADS": "2", "PYTHONWARNINGS": "ignore"}
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return proc.returncode, last, proc.stderr


@pytest.fixture
def harness_runner():
    return run_harness
