"""The comparison fails what it must: runs with the timed path broken
underneath (a fault planted in the program before the run) come out not
correct, and so does the control, the reference in TF32 put in the
program's place. The look for a card is skipped (``--cpu-dry-run``); the
rest of a run is a real run at a tiny size."""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO

# a step that leaves the state unchanged: Adam's update does nothing
FROZEN = """
import torch
torch.optim.Adam.step = lambda self, closure=None: None
"""

# half of the batch left out, the mean taken over the rest: the full-graph
# loss over half of the train nodes, the sampled step's mask halved
HALF = """
import torch
from han_tpu_torch.train import trainer, sampled
_ce = trainer.masked_softmax_cross_entropy
def _half(logits, labels, mask):
    rows = torch.nonzero(mask).flatten()
    mask = mask.clone()
    mask[rows[rows.shape[0] // 2:]] = False
    return _ce(logits, labels, mask)
trainer.masked_softmax_cross_entropy = _half
_mat = sampled.SampledTrainer._materialize
def _mat_half(self, *a):
    graphs, xs, labels, mask, n = _mat(self, *a)
    b = self.batch_size
    mask = torch.cat([mask[:b // 2], torch.zeros_like(mask[b // 2:])])
    return graphs, xs, labels, mask, n
sampled.SampledTrainer._materialize = _mat_half
"""

# an answer altered where it is produced: one logit of the first row the
# loss reads raised by 1
ALTERED = """
import torch
from han_tpu_torch.nn import models
from han_tpu_torch.train import trainer
_fuse = models.HAN._fuse
def _bumped(logits, row):
    bump = torch.zeros_like(logits)
    bump[row, 0] = 1.0
    return logits + bump
def _fuse_altered(self, multi):
    logits, final, alphas = _fuse(self, multi)
    return (_bumped(logits, 0) if self.training_block else logits), final, alphas
models.HAN.training_block = False
models.HAN._fuse = _fuse_altered
_ce = trainer.masked_softmax_cross_entropy
def _ce_altered(logits, labels, mask):
    return _ce(_bumped(logits, torch.nonzero(mask).flatten()[0]), labels, mask)
trainer.masked_softmax_cross_entropy = _ce_altered
from han_tpu_torch.train import sampled
_step = sampled.SampledTrainer._train_step
def _step_altered(self, *a):
    models.HAN.training_block = True
    try:
        return _step(self, *a)
    finally:
        models.HAN.training_block = False
sampled.SampledTrainer._train_step = _step_altered
"""


# an answer altered where it is produced, in the evaluations alone (which
# run without autograd): every logit of class 0 raised by 1
EVAL_ALTERED = """
import torch
from han_tpu_torch.nn import models
_fuse = models.HAN._fuse
def _fuse_altered(self, multi):
    logits, final, alphas = _fuse(self, multi)
    if not torch.is_grad_enabled():
        logits = logits + torch.nn.functional.one_hot(
            torch.zeros(logits.shape[0], dtype=torch.long), logits.shape[1]).to(logits)
    return logits, final, alphas
models.HAN._fuse = _fuse_altered
"""


@pytest.mark.parametrize("fault", ["frozen", "half", "altered", "eval_altered"])
@pytest.mark.parametrize("workload", ["tiny_dblp.full", "tiny_sampled.device"])
def test_a_broken_step_is_not_correct(tiny_checkout, harness_runner, fault, workload):
    before = {"frozen": FROZEN, "half": HALF, "altered": ALTERED,
              "eval_altered": EVAL_ALTERED}[fault]
    rc, res, err = harness_runner(tiny_checkout, workload, before=before)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]
    if fault == "eval_altered":  # the steps are sound: only the evaluation is caught
        assert all(v["value"] <= v["limit"] for k, v in res["checks"].items()
                   if k != "eval_gap"), res["checks"]
        assert res["checks"]["eval_gap"]["value"] > res["checks"]["eval_gap"]["limit"]


@pytest.mark.parametrize("workload", ["tiny_dblp.full", "tiny_sampled.device"])
def test_the_control_is_not_correct(tiny_checkout, workload):
    out = tiny_checkout / "control.jsonl"
    env = {**os.environ, "PYTHONPATH": f"{tiny_checkout}{os.pathsep}{REPO}",
           "OMP_NUM_THREADS": "2", "PYTHONWARNINGS": "ignore"}
    proc = subprocess.run([sys.executable, "benchmark/control.py", "--workload", workload,
                           "--seeds", "1", "--control-seeds", "1", "--out", str(out),
                           "--cpu-dry-run"], cwd=tiny_checkout, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = json.loads(out.read_text().splitlines()[0])
    limits = json.loads((tiny_checkout / "benchmark" / "limits" / f"{workload}.json")
                        .read_text())
    assert all(row["sound"][k] <= limits[k] for k in limits), row["sound"]
    for fault in ("tf32", "half_batch", "altered"):
        assert any(row[fault][k] > limits[k] for k in limits), (fault, row[fault])
