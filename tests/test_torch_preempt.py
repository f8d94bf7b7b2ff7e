"""Preemption with a real signal (the port's tests/test_preempt.py): a child
process trains han_tpu_torch's SampledTrainer on the CPU under a
PreemptionGuard, the parent SIGTERMs it mid-run, the child saves a resume
checkpoint and exits cleanly, and a fresh trainer in this process resumes
from it."""

import os
import signal
import subprocess
import sys
import time

import numpy as np

from han_tpu_torch.train.sampled import _EPOCH_STRIDE, SampledTrainer
from han_tpu_torch.train.trainer import MetricLogger

_SETUP = r"""
from han_tpu_torch.graph.synthetic import planted_hetero
from han_tpu_torch.train.config import preset

def setup(ckpt_dir):
    ds = planted_hetero(n_nodes=128, n_feats=24, n_classes=3, n_metapaths=2,
                        avg_degree=6.0, train_per_class=16, n_val=24, seed=3)
    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.model.hid_units = (8,)
    cfg.model.n_heads = (4, 1)
    cfg.train.epochs = 500
    cfg.train.patience = 500
    cfg.train.checkpoint_dir = ckpt_dir
    return ds, cfg
"""

_CHILD = _SETUP + r"""
import signal, sys

import torch

from han_tpu_torch.train.preempt import PreemptionGuard
from han_tpu_torch.train.sampled import SampledTrainer
from han_tpu_torch.train.trainer import MetricLogger

torch.set_num_threads(1)


class Echo(MetricLogger):
    def __init__(self):
        super().__init__("", echo=False)

    def log(self, rec):
        print("EPOCH" if "epoch" in rec else "LOG", rec, flush=True)


ds, cfg = setup(sys.argv[1])
guard = PreemptionGuard(signals=(signal.SIGTERM,))
res = SampledTrainer(ds, cfg, batch_size=16, fanout=6, logger=Echo(), guard=guard,
                     device="cpu").fit()
print("RESULT", res, flush=True)
assert res.get("preempted") is True
print("PREEMPTED_OK", flush=True)
"""


def test_sigterm_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ck")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, ckpt], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env, cwd=root)
    try:
        # wait until training is demonstrably in progress (2 epochs logged)
        lines, epochs_seen = [], 0
        deadline = time.time() + 300
        while time.time() < deadline and epochs_seen < 2:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            epochs_seen += line.startswith("EPOCH")
        assert epochs_seen >= 2, f"child never trained: {lines[-5:]}"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "PREEMPTED_OK" in out, out[-2000:]
    assert proc.returncode == 0

    # resume in this process from the child's checkpoint, a few epochs on
    namespace = {}
    exec(_SETUP, namespace)
    ds, cfg = namespace["setup"](ckpt)
    rows = []

    class Cap(MetricLogger):
        def __init__(self):
            super().__init__("", echo=False)

        def log(self, rec):
            rows.append(rec)

    t = SampledTrainer(ds, cfg, batch_size=16, fanout=6, logger=Cap(), device="cpu")
    restored = t.restore_latest()
    assert restored is not None
    assert t.checkpoints().latest_step() == (restored["epoch"] * _EPOCH_STRIDE
                                             + restored["cursor"])
    first_new = restored["epoch"] + (restored["cursor"] == 0)
    cfg.train.epochs = first_new + 3
    res = t.fit(resume=True)
    assert np.isfinite(res["test_loss"])
    epochs = [r["epoch"] for r in rows if "train_loss" in r]
    assert epochs == list(range(first_new, first_new + 3))
