"""Inductive multi-graph trainer, PPI-style (port of
han_tpu/train/inductive.py:29-281): GAT over graph batches with the
multi-label sigmoid loss and micro-F1 (reference base_gattn.py:50-59,71-94;
batching semantics from utils/process_ppi.py).

Two attention paths, by ``impl``:

- ``dense`` (han_tpu's, the default): the B graphs of a batch run as a
  loop over ``DenseGraph``s of the padded (B, N_max, N_max) batch (han_tpu
  vmaps them); the logits are stacked and the per-graph losses averaged.
- ``flash``, ``csr`` or ``auto``: the batch is ONE block-diagonal graph of
  B slots of S rows (S = N_max rounded up to a tile; graph/union.py) and
  goes through the model once, on the flash kernels (a union of BCSR
  tiles) or the csr backend (its edge list). Each graph of a split is
  built once into a piece on the device, and a batch's union is assembled
  there from the pieces, padded to the split's static budget, so every
  batch of a split has one shape. ``auto`` takes flash or csr once for the
  dataset, by ``attention_aggregate``'s rule applied to all of its graphs:
  the tile elements they occupy over their real edges against
  ``flash_csr_threshold``. The losses are the dense path's: each graph's
  masked mean over its own slot, summed over B and divided by B.

On a CUDA device the train step and each evaluation batch are captured as
CUDA graphs over the static batch (train/graphed.py; han_tpu jits them,
inductive.py:114-121): the first train step runs eagerly (it creates
Adam's state, ``capturable``), the second captures, and each evaluation
step captures at its second call; one step a batch shape, so one train
step and one evaluation step a split. The batch is copied into the step's
static buffers, and the graph replays the step without its launches. A run
whose graph axis holds a process group runs eagerly (NCCL collectives
inside a captured graph are not ported), and so does the CPU.

Spans (utils/prof.span) and counters: ``han.next_batch`` around a batch's
selection, union and upload, ``han.train_step`` and ``han.eval_step``
around each step's dispatch; ``counters`` sums, over the sparse batches
made, the tile elements of their unions' BCSR (``tile_elems``: what the
flash kernels sweep) and their real edges (``edges``), for the tile
elements an edge that node order decides.

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
splits one key into a stream a graph of the batch. On a sparse path each
rank's share of the batch is a union of its own. Rank 0 saves, with every
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
from typing import Any

import numpy as np
import torch

from han_tpu_torch.datasets.ppi import MultiGraphDataset
from han_tpu_torch.graph.bcsr import DEF_BM, DEF_BN
from han_tpu_torch.graph.containers import DenseGraph
from han_tpu_torch.graph.union import GraphUnion, slot_rows, tile_count, union_graph
from han_tpu_torch.nn.layers import DropoutGenerators
from han_tpu_torch.nn.losses import l2_regularizer, masked_sigmoid_cross_entropy, micro_f1
from han_tpu_torch.nn.models import GAT
from han_tpu_torch.ops.attention import flash_csr_threshold
from han_tpu_torch.parallel.mesh import (Axis, Mesh, all_gather_rows, all_reduce_grads,
                                         all_sum, gather_rows)
from han_tpu_torch.train.graphed import GraphedStep, want_capture
from han_tpu_torch.train.trainer import CheckpointStore, load_training_state, training_state
from han_tpu_torch.utils.device import resolve_device
from han_tpu_torch.utils.prof import span

IMPLS = ("dense", "csr", "flash", "auto")
# the graph format of each route
ROUTE_FORMATS = {"dense": "dense", "csr": "csr", "flash": "bcsr"}


class InductiveTrainer:
    """GAT training on whole graphs of a MultiGraphDataset: Adam over
    batches of ``batch_size`` train graphs, early stopping on validation
    micro-F1 and loss, restore-best-then-test; data-parallel over
    ``mesh``'s graph axis when given (the module docstring; the device is
    the mesh's). ``impl`` (dense | csr | flash | auto) picks the attention
    path (the module docstring). ``capture``: None captures
    the steps on a CUDA device whose graph axis holds no process group and
    runs them eagerly elsewhere; True on the CPU raises ValueError, with a
    process group NotImplementedError; False runs them eagerly on the
    card."""

    def __init__(self, ds: MultiGraphDataset, *, hid_units=(256, 256),
                 n_heads=(4, 4, 6), lr=0.005, l2_coef=0.0, residual=True,
                 attn_drop: float = 0.0, ffd_drop: float = 0.0,
                 patience: int | None = None, impl: str = "dense",
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
        if impl not in IMPLS:
            raise ValueError(f"the inductive trainer takes impl in {IMPLS}; got {impl!r}")
        self.share = batch_size // self.axis.size  # a rank's graphs of a batch
        # the graphs' tile counts: the unions' budgets, the counters and
        # auto's rule
        self._graph_tiles = None if impl == "dense" else np.array(
            [tile_count(*ds.graph_edges(g)) for g in range(ds.n_graphs)])
        self.route = self._route(impl)
        self.graph_format = ROUTE_FORMATS[self.route]
        self.counters = {"tile_elems": 0, "edges": 0}
        self.use_dropout = attn_drop > 0.0 or ffd_drop > 0.0
        self.rngs = DropoutGenerators(device=torch.Generator(self.device).manual_seed(
            seed + 1 + self.axis.rank * 1_000_003))
        self.model = GAT(ds.features.shape[-1], ds.labels.shape[-1], hid_units=hid_units,
                         n_heads=n_heads, residual=residual, impl=self.route,
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

    @classmethod
    def from_config(cls, ds: MultiGraphDataset, cfg, *, batch_size: int | None = None,
                    mesh: Mesh | None = None, device: torch.device | str | None = None,
                    logger=None, guard=None, capture: bool | None = None):
        """The trainer of a ``train/config.Config``: its model (``impl``
        picks the path) and train settings (``batch_size``: in place of
        ``cfg.train.batch_size``)."""
        m, t = cfg.model, cfg.train
        return cls(ds, hid_units=tuple(m.hid_units), n_heads=tuple(m.n_heads), lr=t.lr,
                   l2_coef=t.l2_coef, residual=m.residual, attn_drop=m.attn_drop,
                   ffd_drop=m.ffd_drop, patience=t.patience, impl=m.impl,
                   batch_size=t.batch_size if batch_size is None else batch_size, mesh=mesh,
                   seed=t.seed, device=device, checkpoint_dir=t.checkpoint_dir,
                   checkpoint_every=t.checkpoint_every, logger=logger, guard=guard,
                   capture=capture)

    def _route(self, impl: str) -> str:
        """The attention path of the run: dense, flash or csr (auto: by
        the tile elements the dataset's graphs occupy an edge)."""
        if impl != "auto":
            return impl
        edges = sum(self.ds.graph_edges(g)[0].shape[0] for g in range(self.ds.n_graphs))
        per_edge = self._graph_tiles.sum() * DEF_BM * DEF_BN / max(edges, 1)
        return "csr" if per_edge > flash_csr_threshold(DEF_BM, DEF_BN) else "flash"

    def _snapshot(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def _split(self, which: str) -> tuple[torch.Tensor, ...]:
        """(adj, features, labels, node_mask) of a split, on the device."""
        if which not in self._splits:
            self._splits[which] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                                        for a in self.ds.split(which))
        return self._splits[which]

    def _sparse_split(self, which: str) -> tuple:
        """(union, features, labels, node_mask) of a split on a sparse path:
        its graphs' pieces (graph/union.py) and its arrays padded to the
        slot's S rows, on the device."""
        if which not in self._splits:
            ids = self.ds.graph_ids(which)
            rows = slot_rows(self.ds.node_mask.shape[1])
            union = GraphUnion([self.ds.graph_edges(g) for g in ids], slots=self.share,
                               rows=rows, fmt=self.graph_format, device=self.device,
                               n_tiles=self._graph_tiles[ids])
            pad = rows - self.ds.node_mask.shape[1]
            arrays = tuple(
                torch.from_numpy(np.ascontiguousarray(np.pad(
                    a[ids], [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)))).to(self.device)
                for a in (self.ds.features, self.ds.labels, self.ds.node_mask))
            self._splits[which] = (union, *arrays)
        return self._splits[which]

    def batches(self, which: str, rng: np.random.Generator | None = None):
        """Batches of batch_size graphs, shuffled by rng when given; the
        last batch is padded with zero-node graphs, which the node masks
        leave out of the loss. On a mesh, this rank's contiguous share of
        each batch. A batch is the step's inputs: (adj, features, labels,
        node_mask) on the dense path, the union's tensors and then
        (features, labels, node_mask) on a sparse one; each is made inside
        the span ``han.next_batch``."""
        n = len(self.ds.graph_ids(which))
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        lo = self.axis.rank * self.share
        for s in range(0, n, self.batch_size):
            with span("han.next_batch"):
                batch = self._batch(which, idx[s:s + self.batch_size][lo:lo + self.share])
            yield batch

    def _batch(self, which: str, chosen: np.ndarray) -> tuple[torch.Tensor, ...]:
        """The inputs of a step over the split's graphs ``chosen``, padded
        to the rank's share with zero-node graphs."""
        pad = self.share - len(chosen)
        if self.route == "dense":
            arrays, graph = self._split(which), ()
        else:
            union, *arrays = self._sparse_split(which)
            sel = [*chosen.tolist(), *[-1] * pad]
            tiles, edges = union.counts(sel)
            self.counters["tile_elems"] += tiles
            self.counters["edges"] += edges
            graph = union.union(sel)
        idx = torch.from_numpy(chosen).to(self.device)
        return (*graph, *(torch.cat([a[idx], a.new_zeros((pad,) + a.shape[1:])]) if pad
                          else a[idx] for a in arrays))

    def _apply(self, inputs, *, train: bool) -> torch.Tensor:
        """(B, S, C) logits of a batch's graph inputs and features: one
        DenseGraph a graph (S = N_max), or the union once."""
        *graph, x_b = inputs
        drop = train and self.use_dropout
        kw = dict(deterministic=not drop, rngs=self.rngs if drop else None)
        if self.route == "dense":
            (adj_b,) = graph
            n_max = adj_b.shape[1]
            return torch.stack([self.model(DenseGraph(adj=adj, n_nodes=n_max), x, **kw)
                                for adj, x in zip(adj_b, x_b)])
        b, rows = x_b.shape[:2]
        union = union_graph(graph, self.graph_format)
        return self.model(union, x_b.reshape(b * rows, -1), **kw).view(b, rows, -1)

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

    def train_step(self, *batch: torch.Tensor) -> torch.Tensor:
        """One Adam step on a batch (this rank's share of it on a mesh; one
        of :meth:`batches`); returns the batch loss (device tensor).
        Captured: the first call runs eagerly, the second captures and
        every later call replays, rewriting the returned tensor: read it
        before the next call. The call is the span ``han.train_step``."""
        with span("han.train_step"):
            step = self._step(self._train_steps, self._train_body, batch,
                              generators=(self.rngs.device,),
                              warmup=0 if self._train_steps else 1)
            return step(*batch)

    def _train_body(self, *batch: torch.Tensor) -> torch.Tensor:
        *inputs, y_b, m_b = batch
        self.opt.zero_grad(set_to_none=True)
        loss = self._loss(self._apply(inputs, train=True), y_b, m_b)
        loss.backward()
        all_reduce_grads(self.model.parameters(), self.axis)
        l2 = l2_regularizer(self.model.parameters(), self.l2_coef)
        l2.backward()  # once, after the sum
        self.opt.step()
        return (all_sum(loss, self.axis) + l2).detach()

    @torch.no_grad()
    def _eval_body(self, *batch: torch.Tensor) -> torch.Tensor:
        """(loss, micro-F1) of a batch as one (2,) tensor (on a mesh, of
        the whole batch, gathered)."""
        *inputs, y_b, m_b = batch
        logits = self._apply(inputs, train=False)
        logits, y_b, m_b = (gather_rows(t.float(), self.axis) for t in (logits, y_b, m_b))
        c = logits.shape[-1]
        return torch.stack([self._loss(logits, y_b, m_b),
                            micro_f1(logits.reshape(-1, c), y_b.reshape(-1, c),
                                     m_b.reshape(-1))])

    def evaluate(self, which: str) -> dict[str, float]:
        """Mean over the split's batches of the loss and the micro-F1 (on a
        mesh, of the whole batches, gathered); each step's dispatch is the
        span ``han.eval_step``."""
        losses, f1s = [], []
        for batch in self.batches(which):
            with span("han.eval_step"):
                out = self._step(self._eval_steps, self._eval_body, batch)(*batch)
            loss, f1 = out.tolist()
            losses.append(loss)
            f1s.append(f1)
        return {"loss": float(np.mean(losses)), "micro_f1": float(np.mean(f1s))}

    def order_rng(self, epoch: int) -> np.random.Generator:
        """The batch-order generator of an epoch (``fit`` shuffles epoch
        ``epoch``'s train batches with it)."""
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
                order_rng=self.order_rng(epoch + 1).bit_generator.state, epoch=epoch,
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
            rng = order_rng if epoch == start_epoch and order_rng else self.order_rng(epoch)
            for batch in self.batches("train", rng):
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
                  "captured": self.capture, "route": self.route}
        if self.device.type == "cuda":
            result["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        return result
