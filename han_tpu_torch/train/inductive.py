"""Inductive multi-graph trainer, PPI-style (port of
han_tpu/train/inductive.py:29-281): GAT over padded graph batches with the
multi-label sigmoid loss and micro-F1 (reference base_gattn.py:50-59,71-94;
batching semantics from utils/process_ppi.py).

The B graphs of a batch run as a loop over ``DenseGraph``s (han_tpu vmaps
them); the logits are stacked and the per-graph losses averaged. On a CUDA
device the train step and each evaluation batch are captured as CUDA
graphs over the static (B, N_max, N_max) batch (train/graphed.py; han_tpu
jits them, inductive.py:114-121): the first train step runs eagerly (it
creates Adam's state, ``capturable``), the second captures, and each
evaluation step captures at its second call; one step a batch shape. The
batch is copied into the step's static buffers, and the graph replays the
per-graph loop without its launches. A run whose graph axis holds a
process group runs eagerly (NCCL collectives inside a captured graph are
not ported), and so does the CPU.

Data parallelism (``mesh``, one process a rank; han_tpu shards the batch
axis over the mesh's graph axis): every rank draws the same shuffled order
and takes its contiguous share of each batch of B graphs (B a multiple of
the axis size); its per-graph losses summed over B are its share of the
batch mean, the gradients are summed over the axis and the L2 term added
once after the sum, so the parameters stay equal on every rank and a step
equals the one-device step on the whole batch. Evaluation gathers the
batch's logits, labels and masks and scores them as one device does. Each
rank draws its dropout from a generator of its own (``seed + 1 +
rank·1,000,003``; rank 0 draws the one-device stream), where han_tpu
splits one key into a stream a graph of the batch. Rank 0 saves, with every
rank's generator state; every rank loads.

The resilience contract is the other trainers' (train/trainer.py): with a
``checkpoint_dir``, a save on every best epoch and every
``checkpoint_every`` epochs under ``<checkpoint_dir>/<dataset>_inductive``,
each holding the parameters, Adam's state, the dropout generator's state,
the next epoch's batch-order generator state, the epoch and the early-stop
trackers; ``fit(resume=True)`` continues the uninterrupted trajectory, and
a tripped ``guard`` saves and stops at the end of the epoch.
"""

from __future__ import annotations

import statistics
import time
import warnings
from typing import Any

import numpy as np
import torch

from han_tpu_torch.datasets.ppi import MultiGraphDataset
from han_tpu_torch.graph.containers import DenseGraph
from han_tpu_torch.nn.layers import DropoutGenerators
from han_tpu_torch.nn.losses import l2_regularizer, masked_sigmoid_cross_entropy, micro_f1
from han_tpu_torch.nn.models import GAT
from han_tpu_torch.parallel.mesh import (Axis, Mesh, all_gather_rows, all_reduce_grads,
                                         all_sum, gather_rows)
from han_tpu_torch.train.graphed import GraphedStep, want_capture
from han_tpu_torch.train.trainer import CheckpointStore, load_training_state, training_state
from han_tpu_torch.utils.device import resolve_device


class InductiveTrainer:
    """GAT training on whole graphs of a MultiGraphDataset: Adam over
    batches of ``batch_size`` train graphs, early stopping on validation
    micro-F1 and loss, restore-best-then-test; data-parallel over
    ``mesh``'s graph axis when given (the module docstring; the device is
    the mesh's). ``capture``: None captures the steps on a CUDA device
    whose graph axis holds no process group and runs them eagerly
    elsewhere; True on the CPU raises ValueError, with a process group
    NotImplementedError; False runs them eagerly on the card."""

    def __init__(self, ds: MultiGraphDataset, *, hid_units=(256, 256),
                 n_heads=(4, 4, 6), lr=0.005, l2_coef=0.0, residual=True,
                 attn_drop: float = 0.0, ffd_drop: float = 0.0,
                 patience: int | None = None, impl: str = "auto",
                 batch_size: int = 2, mesh: Mesh | None = None, seed: int = 0,
                 device: torch.device | str | None = None,
                 checkpoint_dir: str = "", checkpoint_every: int = 0,
                 logger=None, guard=None, capture: bool | None = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ds = ds
        self.mesh = mesh
        # one device: an axis of one rank, whose collectives are the identity
        self.axis = mesh.graph if mesh is not None else Axis(None, (0,), 0, 1)
        if batch_size % self.axis.size:
            raise ValueError(f"batch_size {batch_size} not divisible by the graph axis "
                             f"({self.axis.size} ranks)")
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.capture = want_capture(capture, self.device, (self.axis,))
        self.batch_size = batch_size
        self.l2_coef = l2_coef
        self.patience = patience
        self.logger = logger
        self.guard = guard
        self.seed = seed
        self.checkpoint_every = checkpoint_every
        self.store = (CheckpointStore(checkpoint_dir, f"{ds.name}_inductive")
                      if checkpoint_dir else None)
        if impl not in ("auto", "dense"):
            # the padded multi-graph batch (G, N_max, N_max) holds one dense
            # adjacency per component (reference process_ppi.py pads dense
            # adjs)
            warnings.warn(f"InductiveTrainer ignores impl={impl!r}: padded "
                          "multi-graph batching is dense by design")
        self.use_dropout = attn_drop > 0.0 or ffd_drop > 0.0
        self.rngs = DropoutGenerators(device=torch.Generator(self.device).manual_seed(
            seed + 1 + self.axis.rank * 1_000_003))
        self.model = GAT(ds.features.shape[-1], ds.labels.shape[-1], hid_units=hid_units,
                         n_heads=n_heads, residual=residual, impl="dense",
                         attn_drop=attn_drop, ffd_drop=ffd_drop,
                         generator=torch.Generator().manual_seed(seed)).to(self.device)
        # capturable: the step counts and the bias correction stay on the
        # card, so the update can be replayed
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr, capturable=self.capture)
        self._splits: dict[str, tuple[torch.Tensor, ...]] = {}
        # one train and one evaluation step a batch shape (graphs once
        # captured)
        self._train_steps: dict[tuple, GraphedStep] = {}
        self._eval_steps: dict[tuple, GraphedStep] = {}

    def _snapshot(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def _split(self, which: str) -> tuple[torch.Tensor, ...]:
        """(adj, features, labels, node_mask) of a split, on the device."""
        if which not in self._splits:
            self._splits[which] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                                        for a in self.ds.split(which))
        return self._splits[which]

    def _batches(self, which: str, rng: np.random.Generator | None = None):
        """Batches of batch_size graphs, shuffled by rng when given; the
        last batch is padded with zero-node graphs, which the node masks
        leave out of the loss. On a mesh, this rank's contiguous share of
        each batch."""
        arrays = self._split(which)
        idx = np.arange(arrays[0].shape[0])
        if rng is not None:
            rng.shuffle(idx)
        b = self.batch_size
        share = b // self.axis.size
        lo = self.axis.rank * share
        for s in range(0, len(idx), b):
            sel = torch.from_numpy(idx[s:s + b][lo:lo + share]).to(self.device)
            pad = share - sel.numel()
            yield tuple(torch.cat([a[sel], a.new_zeros((pad,) + a.shape[1:])]) if pad else a[sel]
                        for a in arrays)

    def _apply(self, adj_b, x_b, *, train: bool) -> torch.Tensor:
        """(B, N_max, C) logits, one DenseGraph a graph."""
        n_max = adj_b.shape[1]
        drop = train and self.use_dropout
        return torch.stack([
            self.model(DenseGraph(adj=adj, n_nodes=n_max), x, deterministic=not drop,
                       rngs=self.rngs if drop else None)
            for adj, x in zip(adj_b, x_b)])

    def _loss(self, logits, y_b, m_b) -> torch.Tensor:
        """The graphs' losses summed over the batch size B: the batch mean,
        or on a mesh this rank's share of it."""
        per_graph = torch.stack([masked_sigmoid_cross_entropy(lg, y, m)
                                 for lg, y, m in zip(logits, y_b, m_b)])
        return per_graph.sum() / self.batch_size

    def _step(self, steps: dict, body, batch, **kw) -> GraphedStep:
        """The step of ``batch``'s shapes in ``steps``, made at its first use."""
        key = tuple(tuple(t.shape) for t in batch)
        if key not in steps:
            steps[key] = GraphedStep(body, capture=self.capture, device=self.device, **kw)
        return steps[key]

    def train_step(self, adj_b, x_b, y_b, m_b) -> torch.Tensor:
        """One Adam step on a batch (this rank's share of it on a mesh);
        returns the batch loss (device tensor). Captured: the first call
        runs eagerly, the second captures and every later call replays,
        rewriting the returned tensor: read it before the next call."""
        batch = (adj_b, x_b, y_b, m_b)
        step = self._step(self._train_steps, self._train_body, batch,
                          generators=(self.rngs.device,),
                          warmup=0 if self._train_steps else 1)
        return step(*batch)

    def _train_body(self, adj_b, x_b, y_b, m_b) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        loss = self._loss(self._apply(adj_b, x_b, train=True), y_b, m_b)
        loss.backward()
        all_reduce_grads(self.model.parameters(), self.axis)
        l2 = l2_regularizer(self.model.parameters(), self.l2_coef)
        l2.backward()  # once, after the sum
        self.opt.step()
        return (all_sum(loss, self.axis) + l2).detach()

    @torch.no_grad()
    def _eval_body(self, adj_b, x_b, y_b, m_b) -> torch.Tensor:
        """(loss, micro-F1) of a batch as one (2,) tensor (on a mesh, of
        the whole batch, gathered)."""
        logits = self._apply(adj_b, x_b, train=False)
        logits, y_b, m_b = (gather_rows(t.float(), self.axis) for t in (logits, y_b, m_b))
        c = logits.shape[-1]
        return torch.stack([self._loss(logits, y_b, m_b),
                            micro_f1(logits.reshape(-1, c), y_b.reshape(-1, c),
                                     m_b.reshape(-1))])

    def evaluate(self, which: str) -> dict[str, float]:
        """Mean over the split's batches of the loss and the micro-F1 (on a
        mesh, of the whole batches, gathered)."""
        losses, f1s = [], []
        for batch in self._batches(which):
            loss, f1 = self._step(self._eval_steps, self._eval_body, batch)(*batch).tolist()
            losses.append(loss)
            f1s.append(f1)
        return {"loss": float(np.mean(losses)), "micro_f1": float(np.mean(f1s))}

    def _order_rng(self, epoch: int) -> np.random.Generator:
        """The batch-order generator of an epoch."""
        return np.random.default_rng(self.seed * 1_000_003 + epoch)

    def restore_latest(self, step: int | None = None) -> dict[str, Any] | None:
        """The saved resume state of ``step`` (None: the latest save), or
        None when nothing was saved; loads nothing into the trainer."""
        return self.store.load(step)

    def _save(self, epoch: int, best: dict, bad_epochs: int, best_step: int) -> None:
        rank_rngs = all_gather_rows(self.rngs.device.get_state(), self.axis, self.device)
        if self.axis.rank == 0:  # rank 0 saves, with every rank's generator state
            self.store.save(epoch, training_state(
                self.model, self.opt, self.rngs.device,
                order_rng=self._order_rng(epoch + 1).bit_generator.state, epoch=epoch,
                best_f1=best["f1"], best_loss=best["loss"], bad_epochs=bad_epochs,
                best_step=best_step, rank_rngs=rank_rngs))

    def fit(self, epochs: int = 20, *, log=None, resume: bool = False) -> dict[str, Any]:
        """Train with early stopping, restore the best parameters and
        evaluate on the test graphs. ``resume`` (with a checkpoint_dir):
        continue from the latest checkpoint (a fresh start when there is
        none)."""
        emit = log if log is not None else (
            self.logger.log if self.logger is not None else print)
        history, step_times = [], []
        best = {"f1": -1.0, "loss": np.inf, "state": None, "epoch": -1}
        bad_epochs = 0
        start_epoch, best_step = 0, -1
        order_rng = None
        if resume and self.store is not None:
            restored = self.store.load()
            if restored is not None:
                # the per-epoch batch order and the dropout stream continue
                # as in the uninterrupted run
                load_training_state(restored, self.model, self.opt, self.rngs.device,
                                    self._train_steps.values())
                self.rngs.device.set_state(restored["rank_rngs"][self.axis.rank].clone())
                order_rng = np.random.default_rng()
                order_rng.bit_generator.state = restored["order_rng"]
                best.update(f1=restored["best_f1"], loss=restored["best_loss"])
                bad_epochs = restored["bad_epochs"]
                start_epoch = restored["epoch"] + 1
                best_step = restored["best_step"]
                if best_step == restored["epoch"]:
                    best.update(state=self._snapshot(), epoch=best_step)
                elif best_step >= 0:
                    best.update(state=self.store.load(best_step)["model"], epoch=best_step)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            losses = []
            rng = order_rng if epoch == start_epoch and order_rng else self._order_rng(epoch)
            for batch in self._batches("train", rng):
                t1 = time.perf_counter()
                losses.append(float(self.train_step(*batch)))  # waits for the step
                step_times.append(time.perf_counter() - t1)
            val = self.evaluate("val")
            history.append({"epoch": epoch, "train_loss": float(np.mean(losses)),
                            **{f"val_{k}": v for k, v in val.items()},
                            "time_s": round(time.perf_counter() - t0, 3)})
            emit(history[-1])
            # reference-style early stop (ex_acm3025.py:225-240 adapted to
            # micro-F1): keep the parameters on strict best; patience on
            # either metric matching its best
            is_best = val["micro_f1"] >= best["f1"] and val["loss"] <= best["loss"]
            improved_any = val["micro_f1"] >= best["f1"] or val["loss"] <= best["loss"]
            if is_best:
                best.update(f1=val["micro_f1"], loss=val["loss"], epoch=epoch,
                            state=self._snapshot())
                best_step = epoch
            bad_epochs = 0 if improved_any else bad_epochs + 1
            saved = self.store is not None and (is_best or (
                self.checkpoint_every and (epoch + 1) % self.checkpoint_every == 0))
            if saved:
                self._save(epoch, best, bad_epochs, best_step)
            if self.patience is not None and bad_epochs > self.patience:
                break
            if self.guard is not None and self.guard.triggered:
                # preemption: save the whole resume state and stop
                if self.store is not None and not saved:
                    self._save(epoch, best, bad_epochs, best_step)
                emit({"preempted_at": epoch})
                return {"preempted": True, "history": history}
        if best["state"] is not None:
            # restore-best-then-test (reference ex_acm3025.py:247)
            self.model.load_state_dict(best["state"])
        test = self.evaluate("test")
        result = {"history": history, "best_epoch": best["epoch"],
                  **{f"test_{k}": v for k, v in test.items()},
                  "epoch_train_loss": [h["train_loss"] for h in history],
                  "median_step_time_s": statistics.median(step_times) if step_times else None,
                  "captured": self.capture}
        if self.device.type == "cuda":
            result["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        return result
