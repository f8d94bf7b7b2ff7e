"""The inductive training loop through ``InductiveTrainer``'s public steps:
each epoch is the train split's batches in the trainer's own shuffled
order, one ``train_step`` a batch with its loss read on the host, then one
``evaluate("val")`` (``InductiveTrainer.fit``'s epoch body without its
save-on-best and early stop, as ``loops/epochs.py`` is ``Trainer.fit``'s).

Set-up builds the program's dataset from the inputs and the trainer
through ``InductiveTrainer.from_config``, gives it the benchmark's weights
and runs the first ``warm_steps`` batches of epoch 0's order, each
followed by ``evaluate("val")`` (the train step eager, captured, replayed;
the evaluation likewise), whose steps and evaluations the reference
follows (the evaluations after the first two: ``COMPARED_EVALS``). The
window then runs epochs 1, 2, … until ``seconds`` have passed
on the host clock, and closes at a train step's read.

The trainer's counters (the tile elements of its unions and their real
edges) are read where the traced part of the window starts and where it
ends, for ``tile_elems_per_edge``.
"""

from __future__ import annotations

import itertools
import math
import time
import traceback

import numpy as np
import torch

VAL = 1  # the generator's split index of the validation graphs
# the warm steps after which the validation pass is compared. Not the
# third: Adam moves every element by about lr from its first step on,
# whatever the size of its gradient, so the elements whose gradient is
# round-off (a whole a_dst of a layer, whose term shifts a row's logits
# alike) move by round-off's sign, and where the third step overshoots
# (the validation loss 0.61 → 1.0-1.3) that reads up to 3.8e-4 on a sound
# run, above TF32's 7e-5 (PERF.md §6); after steps 1 and 2 it reads
# 1.5e-6 at most
COMPARED_EVALS = (1, 2)


def dataset(ctx):
    """The program's MultiGraphDataset of the inputs: the padded arrays and
    each graph's edges, no dense adjacency."""
    from han_tpu_torch.datasets.ppi import MultiGraphDataset

    i = ctx.inputs
    return MultiGraphDataset(adj=None, features=i.features, labels=i.labels,
                             node_mask=i.node_mask, graph_split=i.split,
                             name=ctx.config["name"], edges=i.edges)


def start(ctx) -> dict:
    """Builds the trainer, gives it the benchmark's weights and runs the
    warm steps: the trainer, and the program's record of its first three
    steps and evaluations."""
    from han_tpu_torch.train.inductive import InductiveTrainer

    tr = InductiveTrainer.from_config(dataset(ctx), ctx.program_config(), device=ctx.device,
                                      capture=ctx.capture)
    ctx.mark("program")
    params0 = ctx.load_weights(tr.model)
    losses, evals, grads, params3 = [], [], None, None
    warm = ctx.traffic["warm_steps"]
    for i, batch in enumerate(itertools.islice(tr.batches("train", tr.order_rng(0)), warm)):
        losses.append(float(tr.train_step(*batch)))
        evals.append(tr.evaluate("val")["loss"])
        if i == 0:
            grads = ctx.adam_grads(tr.opt, tr.model)
        if i == 2:
            params3 = ctx.snapshot(tr.model)
    if len(losses) < 3:
        raise ValueError(f"{len(losses)} warm steps: epoch 0 needs 3 batches to compare")
    # epoch 0's order, as the trainer draws it (InductiveTrainer.batches)
    order = np.arange(int((ctx.inputs.split == 0).sum()))
    tr.order_rng(0).shuffle(order)
    ctx.warm_order = order[:warm * tr.batch_size]
    ctx.mark("first steps")
    return {"trainer": tr, "params0": params0,
            "program": ctx.record(losses[:3], grads, params3, evals[:3])}


def run(ctx) -> dict:
    st = start(ctx)
    tr = st.pop("trainer")
    reads, eval_reads, failed, counters = [], [], 0, {}
    epoch, t = 1, time.perf_counter()
    with ctx.window() as win:
        done = False
        while not done:
            try:
                for batch in tr.batches("train", tr.order_rng(epoch)):
                    loss = float(tr.train_step(*batch))
                    t = time.perf_counter()
                    reads.append(t)
                    failed += not math.isfinite(loss)
                    done = win.tick(t) or bool(failed)
                    if win.t_trace is not None and "start" not in counters:
                        counters["start"] = dict(tr.counters)
                    if done:
                        break
                if not done:
                    tr.evaluate("val")
                    eval_reads.append(time.perf_counter())
            except Exception:  # a step that raised is a failed step; the window ends
                traceback.print_exc()
                t = time.perf_counter()
                reads.append(t)
                failed, done = failed + 1, True
            epoch += 1
        win.close(t)
    counters["end"] = dict(tr.counters)
    ctx.read_peak()
    ctx.counters = counters
    per_pass = -(-int((ctx.inputs.split == VAL).sum()) // tr.batch_size)
    del tr  # the program is freed before the reference runs
    return {**st, "reads": reads, "train_steps": len(reads), "failed": failed,
            "eval_steps": lambda since: per_pass * sum(1 for r in eval_reads if r > since)}


def _split_mean(ctx, split: int, batch: int) -> tuple[float, float]:
    """(real nodes, real edges with self-loops) of a mean batch of the split."""
    inp = ctx.inputs
    ids = inp.graph_ids(split)
    batches = -(-len(ids) // batch)
    nodes = float(inp.sizes[ids].sum())
    edges = float(sum(inp.edges[g][0].shape[0] for g in ids))
    return nodes / batches, edges / batches


def shape(ctx) -> dict:
    """A train step's real nodes and edges (a mean batch: an epoch takes
    every train graph once), an evaluation batch's, the input width, the
    labels, and the trainer's counters over the traced window (None
    without one)."""
    b = ctx.settings["train"]["batch_size"]
    n, e = _split_mean(ctx, 0, b)
    en, ee = _split_mean(ctx, VAL, b)
    c = getattr(ctx, "counters", {})
    window = ({k: c["end"][k] - c["start"][k] for k in c["end"]} if "start" in c else None)
    return {"n_rows": n, "edges": e, "eval_rows": en, "eval_edges": ee,
            "in_dim": int(ctx.inputs.features.shape[-1]),
            "n_classes": int(ctx.inputs.labels.shape[-1]), "counters": window}


def _graph(ctx, g: int):
    from benchmark.reference.gat import Graph

    inp, dev = ctx.inputs, ctx.device
    n = int(inp.sizes[g])
    adj = torch.zeros((n, n), dtype=torch.bool, device=dev)
    rows, cols = (torch.from_numpy(a.astype(np.int64)).to(dev) for a in inp.edges[g])
    adj[rows, cols] = True
    adj[torch.arange(n, device=dev), torch.arange(n, device=dev)] = True
    return Graph(x=torch.from_numpy(inp.features[g, :n]).to(dev),
                 labels=torch.from_numpy(inp.labels[g, :n]).to(dev), adj=adj)


def reference_plan(ctx):
    """The warm steps' batches (epoch 0's first graphs of the train split,
    in the trainer's order) and the validation pass after each of
    ``COMPARED_EVALS``."""
    from benchmark.reference.gat import Batch

    b = ctx.settings["train"]["batch_size"]
    train, val = ctx.inputs.graph_ids(0), ctx.inputs.graph_ids(VAL)
    order = ctx.warm_order
    steps = [Batch([_graph(ctx, int(train[i])) for i in order[s:s + b]], b)
             for s in range(0, len(order), b)]
    evals = [Batch([_graph(ctx, int(g)) for g in val[s:s + b]], b)
             for s in range(0, len(val), b)]
    return steps, {t: evals for t in COMPARED_EVALS}
