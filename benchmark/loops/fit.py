"""The sampled training loop through ``SampledTrainer.fit()``, the public
entry: epochs of seed-node batches with the one-ahead prefetch, an
evaluation of the validation nodes after each epoch and a save on every
best epoch.

fit polls its preemption guard after every train call; the benchmark's
guard is a clock. Set-up builds the program's dataset and trainer, gives
it the benchmark's weights and runs one short ``fit`` (``warm_epochs``
epochs, their evaluations and the final test evaluation), so that the
train and evaluation steps are captured; at the first poll the guard reads
Adam's first moment, at the third the parameters, and the logger keeps the
first epoch's validation loss. The reference follows that epoch's steps
and its evaluation. The window is a second ``fit`` with epochs and
patience out of reach: it opens when fit is called, and closes at the
first poll past ``seconds``, where the guard answers true; fit then saves
its preemption checkpoint and returns, outside the window.
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np
import torch

# the sample seed of epoch e's evaluation batches (SampledTrainer.evaluate)
EVAL_SAMPLE_SEED = 10_000_019


class ClockGuard:
    """A preemption guard whose ``triggered`` records the time of every
    poll, calls ``on_poll(count, t)`` and turns true at the deadline."""

    def __init__(self):
        self.polls: list[float] = []
        self.on_poll = None
        self.deadline = None

    @property
    def triggered(self) -> bool:
        t = time.perf_counter()
        self.polls.append(t)
        if self.on_poll is not None:
            self.on_poll(len(self.polls), t)
        return self.deadline is not None and t >= self.deadline


def _kept_logger():
    """A logger that keeps its records (fit's per-epoch lines)."""
    from han_tpu_torch.train.trainer import MetricLogger

    class Kept(MetricLogger):
        def __init__(self):
            super().__init__("", echo=False)
            self.records = []

        def log(self, record):
            self.records.append(record)

    return Kept()


def start(ctx) -> dict:
    """Builds the trainer, gives it the benchmark's weights and runs the
    warm-up fit: the trainer, its guard, and the program's record of its
    first three steps and first evaluation."""
    from han_tpu_torch.train.sampled import SampledTrainer

    from benchmark.data import hetero_dataset

    guard, logger = ClockGuard(), _kept_logger()
    cfg = ctx.program_config()
    tr = SampledTrainer(hetero_dataset(ctx.inputs, ctx.config["name"]), cfg,
                        batch_size=cfg.train.batch_size, fanout=cfg.train.fanout,
                        sampler=ctx.traffic["sampler"],
                        steps_per_call=ctx.traffic.get("steps_per_call", 1),
                        logger=logger, guard=guard, capture=ctx.capture, device=ctx.device)
    ctx.mark("program")
    params0 = ctx.load_weights(tr.model)
    seen = {}

    def on_poll(count, _t):
        if count == 1:
            seen["grads"] = ctx.adam_grads(tr.opt, tr.model)
        elif count == 3:
            seen["params"] = ctx.snapshot(tr.model)

    guard.on_poll = on_poll
    tr.cfg.train.epochs = ctx.traffic["warm_epochs"]
    res = tr.fit()
    guard.on_poll = None
    evals = [r["val_loss"] for r in logger.records if "val_loss" in r][:1]
    ctx.mark("first steps")
    return {"trainer": tr, "guard": guard, "params0": params0,
            "program": ctx.record(res["step_train_loss"][:3], seen["grads"], seen["params"],
                                  evals)}


def run(ctx) -> dict:
    st = start(ctx)
    tr, guard = st.pop("trainer"), st.pop("guard")
    tr.cfg.train.epochs = tr.cfg.train.patience = 10 ** 9
    guard.polls = []
    with ctx.window() as win:
        guard.deadline = win.t0 + win.seconds
        guard.on_poll = lambda _count, t: win.close(t) if win.tick(t) else None
        try:
            losses = tr.fit()["step_train_loss"]
        except Exception:  # a step that raised is a failed step; the window ends
            traceback.print_exc()
            guard.polls.append(time.perf_counter())
            losses = [math.nan]
    polls, per_epoch = guard.polls, _batches_per_epoch(ctx)

    def evals(since: float) -> int:
        # fit evaluates after an epoch's last step, between its poll and the
        # next: the evaluations after poll indices first - 1 .. n - 2
        done = [i for i, t in enumerate(polls) if t > since]
        if not done:
            return 0
        return (len(polls) - 1) // per_epoch - (max(done[0], 1) - 1) // per_epoch
    out = {**st, "reads": polls, "train_steps": len(polls), "eval_steps": evals,
           "failed": sum(not math.isfinite(x) for x in losses)}
    ctx.read_peak()
    return out


def _batches_per_epoch(ctx) -> int:
    b = ctx.settings["train"]["batch_size"]
    return -(-int(ctx.inputs.train_mask.sum()) // b)


def _block_size(ctx) -> int:
    s = ctx.settings
    return s["train"]["batch_size"] * (s["train"]["fanout"] + 1) ** len(s["model"]["hid_units"])


def shape(ctx) -> dict:
    """A step's rows, real edges a meta-path, input width and classes: the
    block, and the real sampled edges of the reference's first block
    (every seed of these graphs has more neighbours than the fanout, so
    every block has as many)."""
    inp = ctx.inputs
    return {"n_rows": _block_size(ctx), "edges": ctx.block_edges,
            "in_dim": int(inp.features.shape[1]), "n_classes": int(inp.labels.shape[1])}


def _block_batch(ctx, rule, seeds, valid, sample_seed, feats, labels):
    """The reference's batch of one block: sampled again by the sampler's
    frozen rule in each meta-path, with its features, labels and seed
    mask."""
    from benchmark.reference.han import Batch

    inp, dev, t = ctx.inputs, ctx.device, ctx.settings["train"]
    b, block = t["batch_size"], _block_size(ctx)
    xs, nbrs = [], []
    for p in range(len(inp.adjs)):
        nodes, nbr = rule.block(inp, p, seeds, valid, t["fanout"], block, sample_seed, dev)
        nd = torch.from_numpy(nodes).to(dev)
        xs.append(torch.where((nd >= 0)[:, None], feats[nd.clamp_min(0)], 0.0))
        nbrs.append(torch.from_numpy(nbr).to(dev))
        if p == 0:
            lbl = torch.where((nd >= 0)[:, None], labels[nd.clamp_min(0)], 0.0)
    mask = torch.zeros(block, device=dev)
    mask[:b] = torch.from_numpy(valid.astype(np.float32)).to(dev)
    return Batch(x=xs, labels=lbl, mask=mask, nbr=nbrs)


def reference_plan(ctx):
    """The first epoch's steps and the validation evaluation after its last
    step, each block sampled again by the frozen rule of the cell's
    sampler (``reference/samplers/<sampler>.py``)."""
    import importlib

    from benchmark.reference import sampling

    rule = importlib.import_module(f"benchmark.reference.samplers.{ctx.traffic['sampler']}")
    inp, dev, b = ctx.inputs, ctx.device, ctx.settings["train"]["batch_size"]
    feats = torch.from_numpy(inp.features).to(dev)
    labels = torch.from_numpy(inp.labels).to(dev)
    train = [_block_batch(ctx, rule, seeds, valid, sample_seed, feats, labels)
             for seeds, valid, sample_seed in sampling.epoch_batches(
                 np.where(inp.train_mask)[0], b, ctx.train_seed, 0)]
    val = [_block_batch(ctx, rule, seeds, valid, EVAL_SAMPLE_SEED, feats, labels)
           for seeds, valid in sampling.ordered_batches(np.where(inp.val_mask)[0], b)]
    ctx.block_edges = [int((nb < nb.shape[0]).sum()) for nb in train[0].nbr]
    return train, {len(train): val}
