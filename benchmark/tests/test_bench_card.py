"""On the card: one short run of each cell of BENCHMARK.json through the command the driver
runs, which has to print a correct result. Skips without a card."""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["han_dblp.full", "han_sampled_100m.device"])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", "2147483911", "--seconds", "2", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
