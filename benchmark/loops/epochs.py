"""The full-graph training loop through ``Trainer``'s public steps: each
epoch is one ``train_step()`` (dropout on) and one ``eval_step`` over the
validation nodes, both losses read on the host (``Trainer.fit``'s epoch
body without its save-on-best and early stop).

Set-up builds the program's dataset and trainer, gives it the benchmark's
weights and runs the first three epochs (the train step eager, captured,
replayed; the evaluation likewise), whose steps and evaluations the
reference follows. The window then runs whole epochs until ``seconds``
have passed on the host clock.
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np
import torch


def start(ctx) -> dict:
    """Builds the trainer, gives it the benchmark's weights and runs the
    traffic's ``warm_steps`` epochs: the trainer, its epoch, and the
    program's record of its first three steps and evaluations."""
    from han_tpu_torch.train.trainer import MetricLogger, Trainer

    from benchmark.data import hetero_dataset

    tr = Trainer(hetero_dataset(ctx.inputs, ctx.config["name"]), ctx.program_config(),
                 device=ctx.device, logger=MetricLogger("", echo=False), capture=ctx.capture)
    ctx.mark("program")
    params0 = ctx.load_weights(tr.model)
    val = tr.masks["val"]

    def epoch() -> tuple:
        loss = float(tr.train_step()[0])
        return loss, float(tr.eval_step(val)[0])

    losses, evals, grads, params3 = [], [], None, None
    for i in range(ctx.traffic["warm_steps"]):
        loss, ev = epoch()
        losses.append(loss)
        evals.append(ev)
        if i == 0:
            grads = ctx.adam_grads(tr.opt, tr.model)
        if i == 2:
            params3 = ctx.snapshot(tr.model)
    ctx.mark("first steps")
    return {"trainer": tr, "epoch": epoch, "params0": params0,
            "program": ctx.record(losses[:3], grads, params3, evals[:3])}


def run(ctx) -> dict:
    st = start(ctx)
    epoch = st.pop("epoch")
    reads, failed = [], 0
    with ctx.window() as win:
        while True:
            try:
                loss, _ = epoch()
            except Exception:  # a step that raised is a failed step; the window ends
                traceback.print_exc()
                loss = math.nan
            t = time.perf_counter()
            reads.append(t)
            failed += not math.isfinite(loss)
            if win.tick(t) or failed:
                break
        win.close(t)
    ctx.read_peak()
    del st["trainer"]  # the program is freed before the reference runs
    # an evaluation follows every train step
    return {**st, "reads": reads, "train_steps": len(reads), "failed": failed,
            "eval_steps": lambda since: sum(1 for r in reads if r > since)}


def shape(ctx) -> dict:
    """A step's rows, real edges a meta-path (self-loops included), input
    width and classes."""
    inp = ctx.inputs
    n = inp.n_nodes
    return {"n_rows": n, "edges": [int(a.nnz) + n for a in inp.adjs],
            "in_dim": int(inp.features.shape[1]), "n_classes": int(inp.labels.shape[1])}


def reference_plan(ctx):
    """The three steps' inputs (the whole graph, each meta-path's adjacency
    with self-loops as a dense mask, the train nodes' mask) and the
    evaluation of the validation nodes after each."""
    from benchmark.reference.han import Batch

    inp, dev = ctx.inputs, ctx.device
    eye = np.eye(inp.n_nodes, dtype=bool)
    adj = [torch.from_numpy(a.toarray() != 0).to(dev) | torch.from_numpy(eye).to(dev)
           for a in inp.adjs]
    x, labels = [torch.from_numpy(inp.features).to(dev)], torch.from_numpy(inp.labels).to(dev)
    mask = {k: torch.from_numpy(m.astype(np.float32)).to(dev)
            for k, m in (("train", inp.train_mask), ("val", inp.val_mask))}
    batch = Batch(x=x, labels=labels, mask=mask["train"], adj=adj)
    val = Batch(x=x, labels=labels, mask=mask["val"], adj=adj)
    return [batch] * 3, {1: [val], 2: [val], 3: [val]}
