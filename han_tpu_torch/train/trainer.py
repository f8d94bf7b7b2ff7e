"""Semi-supervised node-classification trainer (port of
han_tpu/train/trainer.py:41-134,157-521).

Reproduces the reference training dynamics (ex_acm3025.py:121-293):
full-graph steps, Adam + an explicit global L2 term over all parameters
(base_gattn.py:12-24), dropout in training and none in eval, and the
reference early-stopping policy (ex_acm3025.py:225-240):

- keep the parameters as best when val_acc >= best_acc AND
  val_loss <= best_loss;
- the patience counter resets when val_acc >= best_acc OR
  val_loss <= best_loss;
- stop after ``patience`` epochs without either, restore the best
  parameters and evaluate on the test nodes.

``run()`` routes ``cfg.train.sampled`` to the sampled mini-batch trainer
(train/sampled.py) and a MultiGraphDataset (``ppi``) to the inductive
trainer (train/inductive.py). ``model.arch`` is ``han``, ``han_shared``
(one feature tensor shared by the towers) or ``gat`` (one graph, the first
meta-path's). After the test evaluation a HAN run scores the test nodes'
embedding with KNN and KMeans (train/eval_embed.py).

Checkpoints (han_tpu's orbax manager, :class:`CheckpointStore`): a save on
every best epoch and every ``checkpoint_every`` epochs, each holding the
whole resume state (parameters, Adam's state, the dropout generator's
state, the epoch and the early-stop trackers), so ``fit(resume=True)`` in a
fresh trainer continues the uninterrupted run's trajectory; it restores
the best parameters from the last best save, not from the latest save. A
tripped ``guard`` (train/preempt.PreemptionGuard) saves and stops at the
end of the epoch.

Multi-device training on the (mp, graph, heads) mesh (``cfg.mesh``, whose
product is the world size of the process group, one process per device;
parallel/mesh.py): on a graph or heads axis the graphs are partitioned
(``partitioned_bcsr`` or ``bcsr`` → parallel/flash_shard.py,
``ring_bcsr`` → parallel/ring_bcsr.py, ``partitioned`` or ``csr`` →
parallel/edge_partition.py and shard_attn.py, ``ring`` →
parallel/ring_attn.py) and attention runs sharded, rows over the graph
axis and heads over the heads axis; an mp axis splits HAN's meta-path
towers (``vmap_towers``, which it forces, as han_tpu does; with a graph
axis too only on a stacked ``partitioned_bcsr``). Every rank builds the
same model from ``cfg.train.seed``, draws the same dropout streams and
runs the model outside attention replicated, so the collectives leave
every rank with the same gradients and parameters. Only rank 0 logs,
saves and scores the embedding; every rank loads the checkpoint rank 0
saved. The partitioned formats are also accepted on one device (a 1-shard
partition, with or without a process group). ``run()`` sends a sampled run
with a graph axis to the data-parallel sampled trainer
(train/sampled.DPSampledTrainer) and a MultiGraphDataset with one to the
inductive trainer's data-parallel batches.

``vmap_towers`` (``arch="han"`` only) stacks the meta-paths' graphs
(graph/stack.py) and features, and the towers run together: one launch of
each flash kernel a step for all meta-paths.

On one CUDA device the train step and the evaluation are each captured as
a CUDA graph and replayed every epoch (train/graphed.py), han_tpu's one
jitted program a step: epoch 0 runs them eagerly (a real step), epoch 1
captures them, and Adam is ``capturable`` (its step counts on the card).
So is a mesh whose axes all have one rank (each collective the identity),
on every partitioned format. A mesh with a process group on an axis runs
eagerly (NCCL collectives inside a captured step are not ported), and so
does the CPU. A resume loads its state before the first
step, which runs eagerly, and the capture follows as in a fresh run: the
optimizer's load makes new state tensors, which a graph captured earlier
would not read (the train step's GraphedStep raises on such a load).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import statistics
import tempfile
import time
from typing import Any, Iterable

import numpy as np
import torch
from torch import nn

from han_tpu_torch.datasets.ppi import MultiGraphDataset
from han_tpu_torch.datasets.registry import load_dataset
from han_tpu_torch.graph.bcsr import DEF_BM, DEF_BN
from han_tpu_torch.graph.build import (metapath_to_bcsr, metapath_to_csr,
                                       metapath_to_dense, with_self_loops)
from han_tpu_torch.graph.stack import stack_graphs
from han_tpu_torch.graph.synthetic import HeteroDataset
from han_tpu_torch.nn.layers import DropoutGenerators
from han_tpu_torch.nn.losses import (l2_regularizer, masked_accuracy,
                                     masked_softmax_cross_entropy)
from han_tpu_torch.nn.models import GAT, HAN, HANShared
from han_tpu_torch.parallel.edge_partition import partition_csr
from han_tpu_torch.parallel.flash_shard import partition_bcsr
from han_tpu_torch.parallel.mesh import Mesh, make_mesh
from han_tpu_torch.parallel.ring_attn import partition_csr_2d
from han_tpu_torch.parallel.ring_bcsr import ring_partition_bcsr
from han_tpu_torch.train.config import Config
from han_tpu_torch.train.eval_embed import kmeans_eval, knn_eval
from han_tpu_torch.train.graphed import GraphedStep, want_capture
from han_tpu_torch.utils.device import resolve_device
from han_tpu_torch.utils.prof import span

PARTITIONED_FORMATS = ("partitioned_bcsr", "ring_bcsr", "partitioned", "ring")


def on_mesh(cfg: Config) -> bool:
    """Whether the run has a mesh: an axis above 1 or a partitioned format."""
    m = cfg.mesh
    return (m.graph_axis * m.head_axis * m.mp_axis > 1
            or cfg.data.graph_format in PARTITIONED_FORMATS)


def partitioned(cfg: Config) -> bool:
    """Whether the graphs are partitioned (a graph or heads axis, or a
    partitioned format); an mp axis alone stacks whole graphs."""
    return (cfg.mesh.graph_axis > 1 or cfg.mesh.head_axis > 1
            or cfg.data.graph_format in PARTITIONED_FORMATS)


def build_graphs(ds: HeteroDataset, cfg: Config, device: torch.device | str = "cpu",
                 mesh: Mesh | None = None):
    """One graph container per meta-path, with self-loops, on ``device``; on
    a graph or heads axis, a partition of it into ``cfg.mesh.graph_axis``
    shards that carries ``mesh`` to attention (han_tpu/train/trainer.py:
    41-98)."""
    fmt = cfg.data.graph_format
    if partitioned(cfg):
        shards = cfg.mesh.graph_axis
        bm, bn = cfg.data.tile_bm or DEF_BM, cfg.data.tile_bn or DEF_BN
        pad = cfg.data.edge_pad_to
        if fmt in ("bcsr", "partitioned_bcsr"):
            part = lambda a: partition_bcsr(with_self_loops(a), shards, bm=bm, bn=bn)
        elif fmt == "ring_bcsr":
            part = lambda a: ring_partition_bcsr(with_self_loops(a), shards, bm=bm, bn=bn)
        elif fmt in ("csr", "partitioned"):
            part = lambda a: partition_csr(metapath_to_csr(a, edge_pad_to=pad), shards,
                                           edge_pad_to=pad)
        elif fmt == "ring":
            part = lambda a: partition_csr_2d(metapath_to_csr(a, edge_pad_to=pad), shards,
                                              pad_to=pad)
        else:
            raise ValueError(f"graph_format {fmt!r} has no partitioned variant "
                             "(partitioned_bcsr | ring_bcsr | partitioned | ring)")
        graphs = [dataclasses.replace(part(a), mesh=mesh) for a in ds.metapath_adjs]
    elif fmt == "dense":
        graphs = [metapath_to_dense(a) for a in ds.metapath_adjs]
    elif fmt == "csr":
        graphs = [metapath_to_csr(a, edge_pad_to=cfg.data.edge_pad_to)
                  for a in ds.metapath_adjs]
    elif fmt == "bcsr":
        graphs = [metapath_to_bcsr(a, bm=cfg.data.tile_bm or None,
                                   bn=cfg.data.tile_bn or None)
                  for a in ds.metapath_adjs]
    else:
        raise ValueError(f"graph_format {fmt!r} is not ported (dense | csr | bcsr | "
                         "partitioned_bcsr | ring_bcsr | partitioned | ring)")
    return [g.to(device) for g in graphs]


def build_model(ds: HeteroDataset, cfg: Config, generator: torch.Generator | None = None,
                mesh: Mesh | None = None) -> nn.Module:
    m = cfg.model
    if m.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"model.dtype {m.dtype!r} is not float32 or bfloat16")
    in_dim = ds.n_nodes if cfg.data.featype == "adj" else ds.features.shape[1]
    common = dict(hid_units=tuple(m.hid_units), n_heads=tuple(m.n_heads),
                  residual=m.residual, attn_drop=m.attn_drop, ffd_drop=m.ffd_drop,
                  impl=m.impl, dtype=getattr(torch, m.dtype), generator=generator)
    if m.arch == "han":
        return HAN(in_dim, ds.n_classes, len(ds.metapath_adjs),
                   semantic_dim=m.semantic_dim, vmap_towers=m.vmap_towers, mesh=mesh,
                   **common)
    if m.arch == "gat":
        return GAT(in_dim, ds.n_classes, **common)
    if m.arch == "han_shared":
        return HANShared(in_dim, ds.n_classes, len(ds.metapath_adjs),
                         semantic_dim=m.semantic_dim, **common)
    raise ValueError(f"unknown arch {m.arch!r}")


@dataclasses.dataclass
class EarlyStopState:
    """Mirrors vlss_mn / vacc_mx / curr_step (ex_acm3025.py:159-161)."""

    best_val_loss: float = float("inf")
    best_val_acc: float = 0.0
    bad_epochs: int = 0

    def update(self, val_loss: float, val_acc: float) -> tuple[bool, bool]:
        """Returns (keep_as_best, no_improvement)."""
        improved_any = (val_acc >= self.best_val_acc) or (val_loss <= self.best_val_loss)
        improved_both = (val_acc >= self.best_val_acc) and (val_loss <= self.best_val_loss)
        if improved_any:
            self.best_val_acc = max(self.best_val_acc, val_acc)
            self.best_val_loss = min(self.best_val_loss, val_loss)
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return improved_both, not improved_any


class CheckpointStore:
    """Resume checkpoints of one run, one file a step:
    ``<root>/<name>/<step>.pt`` (han_tpu's orbax ``CheckpointManager``).
    A save writes a temporary file in the directory and renames it over the
    step's name, so a reader never sees half a file; nothing is pruned.
    Files hold tensors, numbers, strings, lists and dicts only and load
    with ``torch.load(weights_only=True)``; tensors load on the CPU."""

    def __init__(self, root: str, name: str):
        self.path = pathlib.Path(root).absolute() / name

    def save(self, step: int, state: dict[str, Any]) -> None:
        self.path.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path, prefix=f".{step}.", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(state, f)
            os.replace(tmp, self.path / f"{step}.pt")
        except BaseException:
            os.unlink(tmp)
            raise

    def latest_step(self) -> int | None:
        steps = [int(p.stem) for p in self.path.glob("*.pt") if p.stem.isdigit()]
        return max(steps, default=None)

    def load(self, step: int | None = None) -> dict[str, Any] | None:
        """The state saved at ``step`` (None: the latest step; None when the
        directory holds no checkpoint). A named step that is missing or
        does not load raises."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        return torch.load(self.path / f"{step}.pt", map_location="cpu", weights_only=True)


def training_state(model: nn.Module, opt: torch.optim.Optimizer,
                   generator: torch.Generator, **scalars) -> dict[str, Any]:
    """The state a resume needs: the parameters, the optimizer's state
    (capturable Adam's step counts included), the dropout generator's state
    and the trainer's counters."""
    return {"model": model.state_dict(), "opt": opt.state_dict(),
            "rng": generator.get_state(), **scalars}


def load_training_state(state: dict[str, Any], model: nn.Module,
                        opt: torch.optim.Optimizer, generator: torch.Generator,
                        train_steps: Iterable[GraphedStep] = ()) -> None:
    """Loads :func:`training_state`'s tensors. The parameters are copied in
    place; the optimizer's state tensors are new ones, so a train step
    already captured (one of ``train_steps``) would go on reading the old
    ones: that raises. The optimizer keeps its own ``capturable`` setting
    (a checkpoint of an eager run resumes captured, and the reverse)."""
    for step in train_steps:
        step.expect_uncaptured("loading a training state")
    model.load_state_dict(state["model"])
    saved = state["opt"]
    for group, live in zip(saved["param_groups"], opt.param_groups, strict=True):
        group["capturable"] = live["capturable"]
    opt.load_state_dict(saved)
    generator.set_state(state["rng"])


class MetricLogger:
    """Structured jsonl metric logging."""

    def __init__(self, path: str = "", echo: bool = True):
        self.path = pathlib.Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: dict[str, Any]) -> None:
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.echo:
            parts = " ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items())
            print(parts, flush=True)


class Trainer:
    """Full-graph HAN or GAT training on one device (CUDA unless
    ``device="cpu"``), or on this rank's device of a graph-axis mesh. A GAT
    runs on graph 0 and features 0, as han_tpu's ``_apply`` does: its
    logits are its embedding, and it logs zero semantic alphas.

    ``capture``: None captures the train and eval steps as CUDA graphs on
    a CUDA device, alone or on a mesh whose axes hold no process group
    (every axis one rank), and runs them eagerly on the CPU and where an
    axis holds a group; True on the CPU raises ValueError, with a process
    group NotImplementedError; False runs them eagerly on the card."""

    def __init__(self, ds: HeteroDataset, cfg: Config, *,
                 device: torch.device | str | None = None,
                 logger: MetricLogger | None = None,
                 capture: bool | None = None, guard=None):
        # float32 stays full float32 on the card (TF32 off for matmuls and
        # cuDNN convolutions alike)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ds = ds
        self.cfg = cfg
        # preemption flag polled at epoch boundaries (train/preempt.py)
        self.guard = guard
        self.device = resolve_device(device)
        # han_tpu's rules (han_tpu/train/trainer.py:181-193): an mp axis runs
        # the towers stacked, with a graph axis only over stacked
        # PartitionedBCSR
        if cfg.mesh.mp_axis > 1:
            if cfg.mesh.graph_axis > 1 and cfg.data.graph_format not in (
                    "bcsr", "partitioned_bcsr"):
                raise ValueError("mp_axis x graph_axis composition requires "
                                 "graph_format='bcsr' (stacked PartitionedBCSR)")
            cfg.model.vmap_towers = True
        self._stacked = cfg.model.vmap_towers
        if self._stacked and cfg.model.arch != "han":
            raise ValueError("vmap_towers requires arch='han'")
        self.mesh = None
        if on_mesh(cfg):
            # raises unless the axes' product is the world size and the
            # device matches the backend
            self.mesh = make_mesh(graph=cfg.mesh.graph_axis, heads=cfg.mesh.head_axis,
                                  mp=cfg.mesh.mp_axis, device=self.device)
            self.device = self.mesh.device
        self.capture = want_capture(capture, self.device, () if self.mesh is None else (
            self.mesh.mp, self.mesh.graph, self.mesh.heads))
        self.coordinator = self.mesh is None or self.mesh.rank == 0
        self.logger = logger or MetricLogger(
            cfg.train.log_file if self.coordinator else "", echo=self.coordinator)
        self.graphs = build_graphs(ds, cfg, self.device, mesh=self.mesh)
        self.model = build_model(
            ds, cfg, generator=torch.Generator().manual_seed(cfg.train.seed), mesh=self.mesh
        ).to(self.device)
        if cfg.data.featype == "adj":
            # ablation: each tower's input features are its meta-path's
            # dense adjacency rows (ex_acm3025.py:92-93)
            self.xs = [torch.from_numpy(a.toarray().astype(np.float32)).to(self.device)
                       for a in ds.metapath_adjs]
        else:
            x = torch.from_numpy(ds.features).to(self.device)
            self.xs = [x for _ in ds.metapath_adjs]
        if self._stacked:
            self.graphs = stack_graphs(self.graphs)
            self.xs = torch.stack(self.xs)
        self.labels = torch.from_numpy(ds.labels).to(self.device)
        self.masks = {k: torch.from_numpy(m).to(self.device) for k, m in
                      (("train", ds.train_mask), ("val", ds.val_mask),
                       ("test", ds.test_mask))}
        self._total_edges = int(sum(a.nnz for a in ds.metapath_adjs))
        self._is_han = cfg.model.arch.startswith("han")
        self._shared = cfg.model.arch == "han_shared"
        # capturable: the step counts and the bias correction stay on the
        # card, so the update can be replayed
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg.train.lr,
                                    capturable=self.capture)
        self.rngs = DropoutGenerators(
            device=torch.Generator(self.device).manual_seed(cfg.train.seed + 1))
        self._train = GraphedStep(self._train_body, capture=self.capture, device=self.device,
                                  generators=(self.rngs.device,))
        self._eval = GraphedStep(self._eval_body, capture=self.capture, device=self.device)

    def _apply(self, *, deterministic: bool, rngs: DropoutGenerators | None = None):
        """(logits, embedding, alphas (N, P) or None)."""
        if self._shared:  # one feature tensor for every tower
            return self.model(self.graphs, self.xs[0], deterministic=deterministic, rngs=rngs)
        if self._is_han:
            return self.model(self.graphs, self.xs, deterministic=deterministic, rngs=rngs)
        logits = self.model(self.graphs[0], self.xs[0], deterministic=deterministic, rngs=rngs)
        return logits, logits, None

    def train_step(self):
        """One Adam step on the train nodes; returns (loss, acc, mean
        semantic alphas, zeros for a GAT) as device tensors, from the
        pre-update forward. Captured: the first call runs eagerly, the
        second captures the step and every later call replays it, which
        rewrites the returned tensors: read or clone them before the next
        call. The call is the span ``han.train_step``."""
        with span("han.train_step"):
            return self._train()

    def eval_step(self, mask: torch.Tensor):
        """(loss, acc, logits, embedding) at the current parameters over the
        nodes of ``mask`` (bool (N,)). Captured as :meth:`train_step` is,
        with ``mask`` copied into the graph's static mask buffer. The call is
        the span ``han.eval_step``."""
        with span("han.eval_step"):
            return self._eval(mask)

    def _train_body(self):
        self.opt.zero_grad(set_to_none=True)
        logits, _, alphas = self._apply(deterministic=False, rngs=self.rngs)
        loss = (masked_softmax_cross_entropy(logits, self.labels, self.masks["train"])
                + l2_regularizer(self.model.parameters(), self.cfg.train.l2_coef))
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            acc = masked_accuracy(logits, self.labels, self.masks["train"])
            mean_alphas = (alphas.mean(dim=0) if alphas is not None
                           else logits.new_zeros(len(self.ds.metapath_adjs)))
            return loss.detach(), acc, mean_alphas

    @torch.no_grad()
    def _eval_body(self, mask: torch.Tensor):
        logits, embed, _ = self._apply(deterministic=True)
        loss = masked_softmax_cross_entropy(logits, self.labels, mask)
        return loss, masked_accuracy(logits, self.labels, mask), logits, embed

    def checkpoints(self) -> CheckpointStore:
        return CheckpointStore(self.cfg.train.checkpoint_dir, self.ds.name)

    def restore_latest(self, step: int | None = None) -> dict[str, Any] | None:
        """The saved resume state (:func:`training_state` plus ``epoch``,
        the early-stop trackers and ``best_step``) of ``step``, or of the
        latest save when None; None when nothing was saved. Loads nothing
        into the trainer."""
        return self.checkpoints().load(step)

    def _save(self, store: CheckpointStore, epoch: int, es: EarlyStopState,
              best_step: int) -> None:
        if self.coordinator:  # every rank holds the same state
            store.save(epoch, training_state(
                self.model, self.opt, self.rngs.device, epoch=epoch,
                best_val_loss=es.best_val_loss, best_val_acc=es.best_val_acc,
                bad_epochs=es.bad_epochs, best_step=best_step))

    def fit(self, *, resume: bool = False) -> dict[str, Any]:
        """Train with early stopping, restore the best parameters and
        evaluate on the test nodes. ``resume``: continue from the latest
        checkpoint (a fresh start when there is none)."""
        cfg = self.cfg.train
        es = EarlyStopState()
        best = {"state": self._snapshot(), "epoch": -1}
        store = self.checkpoints()
        start_epoch = 0
        best_step = -1  # epoch of the last best (not periodic) save
        if resume:
            restored = store.load()
            if restored is not None:
                # the checkpoint holds the whole post-epoch state, so the
                # continued run emits the uninterrupted run's trajectory
                load_training_state(restored, self.model, self.opt, self.rngs.device,
                                    (self._train,))
                es = EarlyStopState(restored["best_val_loss"], restored["best_val_acc"],
                                    restored["bad_epochs"])
                start_epoch = restored["epoch"] + 1
                # the best parameters come from the last best save, not
                # from the latest (maybe periodic) one (ex_acm3025.py:247)
                best_step = restored["best_step"]
                if best_step == restored["epoch"]:
                    best = {"state": self._snapshot(), "epoch": best_step}
                elif best_step >= 0:
                    best = {"state": store.load(best_step)["model"], "epoch": best_step}
        train_losses, step_times = [], []
        t_start = time.perf_counter()
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            tr_loss, tr_acc, alphas = self.train_step()
            tr_loss, tr_acc = float(tr_loss), float(tr_acc)  # waits for the step
            t_train = time.perf_counter() - t0
            t1 = time.perf_counter()
            vl_loss, vl_acc, _, _ = self.eval_step(self.masks["val"])
            vl_loss, vl_acc = float(vl_loss), float(vl_acc)
            t_eval = time.perf_counter() - t1
            train_losses.append(tr_loss)
            step_times.append(t_train)
            self.logger.log({
                "epoch": epoch, "train_loss": tr_loss, "train_acc": tr_acc,
                "val_loss": vl_loss, "val_acc": vl_acc,
                "semantic_alphas": [round(float(a), 4) for a in alphas.cpu()],
                "step_time_s": round(t_train, 4),
                "eval_time_s": round(t_eval, 4),
                # real meta-path edges × heads processed per second
                "edges_per_s": round(self._total_edges *
                                     self.cfg.model.n_heads[0] / t_train, 1),
            })
            keep, _ = es.update(vl_loss, vl_acc)
            if keep or (cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0):
                # save-on-best keeps the reference dynamics (ex_acm3025.py:
                # 226-229); the periodic save is the preemption recovery point
                with span("han.save"):
                    if keep:
                        best = {"state": self._snapshot(), "epoch": epoch}
                        best_step = epoch
                    self._save(store, epoch, es, best_step)
            if es.bad_epochs >= cfg.patience:
                self.logger.log({"early_stop": epoch,
                                 "best_val_loss": es.best_val_loss,
                                 "best_val_acc": es.best_val_acc})
                break
            if self.guard is not None and self.guard.triggered:
                # preemption: save the whole resume state and stop;
                # fit(resume=True) continues the trajectory
                with span("han.save"):
                    self._save(store, epoch, es, best_step)
                self.logger.log({"preempted_at": epoch})
                self.final_params = self._snapshot()
                return {"preempted": True, "train_time_s": time.perf_counter() - t_start,
                        "epoch_train_loss": train_losses}

        # restore best & final evaluation (ex_acm3025.py:247-291); the
        # parameters are copied in place, so a captured eval step reads them
        self.model.load_state_dict(best["state"])
        self.final_params = self._snapshot()
        ts_loss, ts_acc, _, embed = self.eval_step(self.masks["test"])
        result = {
            "test_loss": float(ts_loss), "test_acc": float(ts_acc),
            "best_epoch": best["epoch"],
            "train_time_s": time.perf_counter() - t_start,
            "median_step_time_s": statistics.median(step_times) if step_times else None,
            "captured": self.capture,
        }
        if self.device.type == "cuda":
            result["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        if self._is_han and self.coordinator:  # every rank holds the same embedding
            test = self.masks["test"]
            result.update(knn_eval(embed[test], self.labels[test], seed=cfg.seed))
            result.update(kmeans_eval(embed[test], self.labels[test], seed=cfg.seed))
        self.logger.log(result)
        result["epoch_train_loss"] = train_losses
        result["epoch_step_time_s"] = step_times
        return result

    def _snapshot(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}


def run(cfg: Config, ds: HeteroDataset | MultiGraphDataset | None = None, *,
        device: torch.device | str | None = None) -> dict[str, Any]:
    """One-call train+eval entry point (the ex_acm3025.py equivalent), on
    the card unless ``device="cpu"``. A MultiGraphDataset (the ``ppi``
    name) trains inductively (train/inductive.py), data-parallel over
    ``mesh.graph_axis``; ``cfg.train.sampled`` selects mini-batch
    neighbor-sampled training over ELL blocks, sampled on the host or
    (``train.sampler=device``) on the device, data-parallel over
    ``mesh.graph_axis`` (host sampler only). With a graph axis every rank
    of the process group calls ``run()``."""
    device = resolve_device(device)
    if ds is None:
        ds = load_dataset(cfg.data.dataset)
    if isinstance(ds, MultiGraphDataset):
        from han_tpu_torch.train.inductive import InductiveTrainer

        # data-parallel graph batches over the graph axis (han_tpu/train/
        # trainer.py:479-500): a global batch of max(2, S) graphs
        mesh = (make_mesh(graph=cfg.mesh.graph_axis, device=device)
                if cfg.mesh.graph_axis > 1 else None)
        coordinator = mesh is None or mesh.rank == 0
        # the inductive trainer shares the other trainers' resilience
        # contract (checkpoint_dir, checkpoint_every)
        trainer = InductiveTrainer.from_config(
            ds, cfg, batch_size=max(2, cfg.mesh.graph_axis), mesh=mesh, device=device,
            logger=MetricLogger(cfg.train.log_file if coordinator else "", echo=coordinator))
        result = trainer.fit(epochs=cfg.train.epochs)
        return {k: v for k, v in result.items() if k != "history"}
    if cfg.train.sampled:
        from han_tpu_torch.train.sampled import DPSampledTrainer, SampledTrainer

        if cfg.model.impl not in ("auto", "ell", "ell_fused"):
            cfg.model.impl = "auto"
        m = cfg.mesh
        if m.head_axis * m.mp_axis > 1 or cfg.data.graph_format in PARTITIONED_FORMATS:
            raise NotImplementedError(
                "sampled training runs on one device or data-parallel over mesh.graph_axis; "
                "han_tpu has no sampled path on a heads or mp axis or a partitioned format")
        # the sampler passes through, so DPSampledTrainer refuses the device
        # sampler (han_tpu's run() drops it: trainer.py:510-513)
        kw = dict(batch_size=cfg.train.batch_size, fanout=cfg.train.fanout,
                  sampler=cfg.train.sampler)
        if m.graph_axis > 1:
            return DPSampledTrainer(ds, cfg, mesh=make_mesh(graph=m.graph_axis, device=device),
                                    **kw).fit()
        return SampledTrainer(ds, cfg, device=device, **kw).fit()
    return Trainer(ds, cfg, device=device).fit()
