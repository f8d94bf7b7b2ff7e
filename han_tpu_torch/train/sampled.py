"""Mini-batch HAN training via L-hop neighbor-sampled blocks (port of
han_tpu/train/sampled.py:49-944): :class:`SampledTrainer` on one device,
:class:`DPSampledTrainer` data-parallel over a mesh's graph axis.

The full-graph trainer needs every meta-path adjacency and the whole
feature matrix resident per step; this trainer is the sampled GNN recipe
for graphs far larger than that (BASELINE.json's synthetic 100M-edge
configuration):

- each step trains on a fixed-size seed-node batch;
- per meta-path, an L-hop bounded-fanout block is sampled around the seeds,
  on the host by the C++ sampler (graph/sampling.sample_subgraph; L = #GAT
  layers, so seed outputs are exact message passing over the sampled
  fanout), or on the device (``sampler="device"``, ``_device_sample_block``)
  from CSRs resident in device memory;
- blocks have static shapes (block_size × fanout) and seed rows come first,
  so the per-node semantic attention fuses aligned rows across meta-path
  towers; loss and metrics mask to the seed rows;
- the next batch's block is sampled on a worker thread while the device
  runs the current step; the worker returns CPU (pinned) tensors and the
  main thread issues the host-to-device copies.

Differences from han_tpu:

- ``impl="auto"`` trains on ``ell_fused`` (the CUDA forward kernel) where
  the kernel takes the model's feature dtype
  (``ops/ell_fused.kernel_takes``: float32 and bfloat16, any heads and
  head dim), and on ``ell`` otherwise; han_tpu always takes ``ell``, only
  because Mosaic could not compile the fused kernel's gathers on the TPU.
  The choice depends on the model only, so the CPU and the card pick the
  same backend;
- the device sampler clamps its sampled offset to ``deg - 1``
  (:func:`sample_offsets`); han_tpu relies on float32 rounding to keep
  ``floor(u·deg)`` below ``deg`` and drops the slot if it does not;
- the device sampler draws its offsets from a counter hash of (sample
  seed, meta-path, level, row, slot) in plain tensor ops
  (:func:`sample_uniform`), keyed by the sample seed that the descriptor
  carries (its last element, as han_tpu's ``packed[-1]``), where han_tpu
  folds the seed into a ``jax.random`` key: a sample seed gives the same
  block whatever the call order, and a captured step samples anew at every
  replay;
- the device sampler's train and evaluation bodies add their real
  sampled edges to two device accumulators (so a replay counts in its
  graph), read in one sync, where han_tpu keeps a pending list of counts;
- :class:`DPSampledTrainer` runs one process a rank, each sampling only
  its own shard's block, and draws each rank's dropout from a generator
  of its own (seeded from the run's seed and the rank), where han_tpu
  splits one key into a stream a shard.

Checkpoints (train/trainer.CheckpointStore, under
``<checkpoint_dir>/<dataset>_sampled``) hold the whole resume state,
including a mid-epoch batch cursor: the step id is ``epoch *
_EPOCH_STRIDE + cursor`` (an end-of-epoch save is ``(epoch + 1) *
_EPOCH_STRIDE``, cursor 0). The batch order and every batch's sample seed
are functions of (seed, epoch, batch index), so a run preempted after batch
b resumes by replaying the epoch's permutation from batch b: the host
sampler samples again the block its prefetch thread held when the guard
tripped, and the device sampler's counter hash rebuilds the same blocks.
The guard is polled once a dispatch, so with ``steps_per_call`` C the
cursor lands at the end of a chunk; the resumed epoch groups its remaining
batches into chunks from the cursor on, as han_tpu's ``_chunked`` does.

On a CUDA device, with no process group on the trainer's axis, every
train dispatch and every evaluation batch is a CUDA graph
(train/graphed.py), han_tpu's jitted steps: the trainer's first train
dispatch runs eagerly (it creates Adam's state, which is ``capturable``),
each shape of dispatch is captured at its next use, and each evaluation
step at its second call.

- The device sampler (han_tpu's ``dev_train_step``, ``dev_train_chunk``
  and ``dev_eval_step``): ``steps_per_call`` = C > 1 groups C descriptors
  into one dispatch (:meth:`SampledTrainer._chunked`), one graph of C
  steps over a (C, 2B+1) descriptor buffer; the tail of an epoch runs as
  single steps.
- The host sampler (han_tpu's train and eval steps over blocks of
  "globally static shapes", sampled.py:12-15,276-279): one train graph a
  (block_size, fanout, resident) key and one evaluation graph a key, so an
  exact evaluation's block shape (:meth:`SampledTrainer.exact_eval_plan`)
  is captured once too. The step takes the batch as flat tensors
  (:meth:`_HostBatch.flat`) and builds its EllGraphs from them, so
  each replay reads the batch that was copied into its static buffers:
  the pinned host tensors go straight into those buffers (the replay's
  input copy is the host-to-device copy; there is no second copy on the
  device).

A data-parallel run with a process group on its axis, and the CPU, run
every step eagerly.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from han_tpu_torch.graph.build import with_self_loops
from han_tpu_torch.graph.containers import EllGraph, TreeEllGraph
from han_tpu_torch.graph.sampling import sample_subgraph
from han_tpu_torch.graph.synthetic import HeteroDataset
from han_tpu_torch.nn.layers import DropoutGenerators
from han_tpu_torch.nn.losses import l2_regularizer
from han_tpu_torch.ops.ell_fused import kernel_takes
from han_tpu_torch.ops.flash_gat import fmix32, mul32
from han_tpu_torch.ops.tree_ell import tree_parent_maps
from han_tpu_torch.parallel.mesh import Axis, Mesh, all_gather_rows, all_reduce_grads, all_sum
from han_tpu_torch.train.config import Config
from han_tpu_torch.train.graphed import GraphedStep, want_capture
from han_tpu_torch.train.trainer import (CheckpointStore, EarlyStopState, MetricLogger,
                                         build_model, load_training_state, training_state)
from han_tpu_torch.utils.device import resolve_device
from han_tpu_torch.utils.prof import span

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
# checkpoint step id = epoch * stride + batch_cursor (0 = end of epoch,
# stored as (epoch+1)*stride); far above any realistic batches/epoch
_EPOCH_STRIDE = 1_000_000


def _resident_gather(tab: torch.Tensor, nd: torch.Tensor) -> torch.Tensor:
    """Rows ``nd`` of the device-resident table; pad slots (nd < 0) → zero."""
    out = tab[nd.clamp_min(0).long()]
    return torch.where((nd >= 0)[..., None], out, 0.0)


def sample_offsets(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Uniform offsets ``floor(u·deg)`` in [0, deg) for u in [0, 1).

    The product is float32, which holds integers past 2**24 only
    approximately; the clamp keeps the offset below ``deg`` by construction
    rather than by the rounding (han_tpu's sampler drops a slot that
    reaches ``deg``)."""
    return torch.minimum(torch.floor(u * deg).long(), deg - 1)


def sample_key(sample_seed, p: int):
    """The device sampler's key of meta-path ``p`` for a sample seed (an
    int, or an integer tensor holding one value: the descriptor's last
    element), as a uint32 in int64."""
    if isinstance(sample_seed, torch.Tensor):
        sample_seed = sample_seed.reshape(()).to(torch.int64)
    return fmix32((sample_seed & _M32) ^ fmix32((p + _GOLDEN) & _M32))


def sample_uniform(key, level: int, rows: int, slots: int, device) -> torch.Tensor:
    """float32 (rows, slots) in [0, 1): a counter hash (the flash dropout
    hash, ops/flash_gat.fmix32) of (key, level, row, slot), its top 24 bits
    over 2**24. Plain tensor ops, so a captured step draws from the key in
    its descriptor buffer."""
    level_key = fmix32(key ^ fmix32((level + _GOLDEN) & _M32))
    row_key = fmix32(level_key ^ torch.arange(rows, device=device))
    bits = fmix32(row_key[:, None]
                  ^ mul32(torch.arange(slots, device=device), _GOLDEN)[None, :])
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _device_sample_block(row_ptr, col_idx, seeds, valid, key, *,
                         fanout: int, hops: int, block_size: int):
    """L-hop neighbor sampling on the device, from the CSR resident there.

    Block layout (no dedup, static shapes): level 0 = the S seed rows;
    level l+1 = the F sampled in-neighbor slots of every level-l row, in
    slot order, so every ELL neighbor list is a static iota into the next
    level (a tree: graph/containers.TreeEllGraph). Nodes with degree <= F
    take their full neighbor list (exact when F >= max degree, like the
    host sampler); larger degrees sample F uniformly with replacement
    (GraphSAGE-style; the host sampler samples without replacement).
    ``key`` (:func:`sample_key`) keys the offsets (:func:`sample_uniform`),
    so a key gives one block whatever was sampled before.

    Returns (nbr (B, F) int32 sentinel=B, deg (B,) int32, nodes (B,) int32
    global ids pad=-1, n_real_edges 0-d int64 tensor).
    """
    dev = seeds.device
    s, f = seeds.shape[0], fanout
    e_max = col_idx.shape[0] - 1
    level = torch.where(valid, seeds.long(), -1)  # (S,)
    nodes_parts, nbr_parts = [level], []
    n_edges = torch.zeros((), dtype=torch.int64, device=dev)
    idx_seq = torch.arange(f, device=dev)[None, :]
    base_next = s
    for hop in range(hops):
        lsz = level.shape[0]
        base_next += lsz * f
        sv = level.clamp_min(0)
        start = row_ptr[sv]
        deg = (row_ptr[sv + 1] - start)[:, None]               # (L, 1)
        u = sample_uniform(key, hop, lsz, f, dev)
        off = torch.where(deg <= f, idx_seq, sample_offsets(u, deg))
        child_valid = (level >= 0)[:, None] & (off < deg)
        addr = (start[:, None] + off).clamp_max(e_max)
        child = torch.where(child_valid, col_idx[addr].long(), -1)
        # this level's ELL rows: slot f of row r holds the next level's row
        # base + r*F + f — a static iota, masked to the sentinel
        slots = (base_next - lsz * f
                 + torch.arange(lsz, device=dev)[:, None] * f + idx_seq)
        nbr_parts.append(torch.where(child_valid, slots, block_size))
        n_edges += child_valid.sum()
        level = child.reshape(-1)
        nodes_parts.append(level)
    # deepest level + padding rows aggregate nothing
    nbr = torch.cat(nbr_parts + [torch.full(
        (block_size - (base_next - level.shape[0]), f), block_size,
        dtype=torch.int64, device=dev)])
    nodes = torch.cat(nodes_parts + [torch.full(
        (block_size - base_next,), -1, dtype=torch.int64, device=dev)])
    deg_out = (nbr < block_size).sum(dim=1)
    return nbr.int(), deg_out.int(), nodes.int(), n_edges


@dataclasses.dataclass
class _HostBatch:
    """Host-sampled blocks as CPU tensors (pinned when training on CUDA)."""

    nbrs: list        # per meta-path (block, fanout) int16/int32, pad = block
    degs: list        # per meta-path (block,)
    xs: list          # per meta-path global node ids (resident) or features
    labels: Any       # (block, C) float32, or None in resident mode
    mask: torch.Tensor  # (block,) float32, 1 on valid seed rows
    block_size: int
    fanout: int
    n_edges: int      # real sampled edges, all meta-paths

    def flat(self) -> list[torch.Tensor]:
        """The step's inputs: per meta-path nbr, deg and xs, then labels
        (absent in resident mode) and mask."""
        per_path = [t for ts in zip(self.nbrs, self.degs, self.xs) for t in ts]
        return per_path + ([] if self.labels is None else [self.labels]) + [self.mask]


@dataclasses.dataclass
class _Descriptor:
    """A device-sampler batch: seed ids | valid mask | sample seed, one
    int32 (2B+1,) tensor (han_tpu's packed descriptor), or C of them
    stacked (C, 2B+1) for one dispatch of C steps."""

    packed: torch.Tensor


class SampledTrainer:
    """HAN training over seed-node batches of a huge heterogeneous graph.

    ``steps_per_call`` > 1 needs ``sampler="device"`` (ValueError
    otherwise, as in han_tpu). ``capture``: None captures the train and
    evaluation steps of both samplers as CUDA graphs on a CUDA device
    (the module docstring) and runs them eagerly on the CPU and where
    ``axis`` holds a process group; True on the CPU raises ValueError,
    with a process group NotImplementedError; False runs eagerly on the
    card. ``axis``: the mesh axis the batch is data-parallel over
    (:class:`DPSampledTrainer`); None: one device."""

    def __init__(self, ds: HeteroDataset, cfg: Config, *,
                 batch_size: int = 512, fanout: int = 16,
                 hops: int | None = None, block_size: int | None = None,
                 eval_batches: int | None = None,
                 logger: MetricLogger | None = None,
                 guard=None, resident_features: bool | None = None,
                 sampler: str = "host", steps_per_call: int = 1,
                 capture: bool | None = None,
                 device: torch.device | str | None = None, axis: Axis | None = None):
        if sampler not in ("host", "device"):
            raise ValueError("sampler must be 'host' or 'device'")
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        if steps_per_call > 1 and sampler != "device":
            raise ValueError("steps_per_call > 1 needs sampler='device'")
        if cfg.model.impl not in ("auto", "ell", "ell_fused"):
            raise ValueError(
                "sampled training runs on the ell or ell_fused backends")
        if cfg.model.impl == "auto":
            fused = kernel_takes(getattr(torch, cfg.model.dtype))
            cfg.model.impl = "ell_fused" if fused else "ell"
        # float32 stays full float32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.ds = ds
        self.cfg = cfg
        # preemption flag polled after every train dispatch (train/preempt.py)
        self.guard = guard
        self.device = resolve_device(device)
        # one device: an axis of one rank, whose collectives are the identity
        self.axis = axis if axis is not None else Axis(None, (0,), 0, 1)
        self.capture = want_capture(capture, self.device, (self.axis,))
        self.sampler = sampler
        self.steps_per_call = int(steps_per_call)
        self.batch_size = batch_size
        self.fanout = fanout
        self.hops = hops if hops is not None else len(cfg.model.hid_units)
        # default block capacity: seeds + fanout neighbors per hop
        self.block_size = block_size or int(
            batch_size * (fanout + 1) ** self.hops)
        self.eval_batches = eval_batches
        self.logger = logger or MetricLogger(cfg.train.log_file)

        self.model = build_model(
            ds, cfg, generator=torch.Generator().manual_seed(cfg.train.seed)
        ).to(self.device)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg.train.lr,
                                    capturable=self.capture)
        # each rank draws its own dropout stream; rank 0 (one device) the
        # run's seed + 1
        self.rngs = DropoutGenerators(device=torch.Generator(self.device).manual_seed(
            cfg.train.seed + 1 + self.axis.rank * 1_000_003))
        # the train steps (graphs once captured): the device sampler's one a
        # number of descriptors C, the host sampler's one a (block_size,
        # fanout, resident) key; the evaluation steps: the device sampler's
        # one (key "device"), the host sampler's one a key
        self._train_steps: dict[Any, GraphedStep] = {}
        self._eval_steps: dict[Any, GraphedStep] = {}
        # self-loops match the full-graph path; one host CSR view per
        # meta-path, index dtypes converted once
        self.csrs = [_ScipyCSRView(with_self_loops(a)) for a in ds.metapath_adjs]
        self.features = np.ascontiguousarray(ds.features, dtype=np.float32)
        self.labels = np.asarray(ds.labels, dtype=np.float32)
        # real sampled edges of the uploaded batches: host blocks counted at
        # upload, the device sampler's folded in by flush_sampled_edges
        self.sampled_edge_count = 0
        # the device sampler's real sampled edges, train and evaluation, which
        # its bodies add to on the device (a replay adds in its graph), and
        # their values at the last flush
        self._edge_sums: torch.Tensor | None = None
        self._edge_sums_read = (0, 0)
        self.host_block_s: list[float] = []
        # resident mode (default when the tables fit): features and labels
        # live on the device and batches carry node ids only
        if resident_features is None:
            resident_features = (self.features.nbytes
                                 + self.labels.nbytes) <= (2 << 30)
        if sampler == "device" and not resident_features:
            raise ValueError("sampler='device' needs resident features")
        self.resident = bool(resident_features)
        if self.resident:
            self._fts_dev = torch.from_numpy(self.features).to(self.device)
            self._lbl_dev = torch.from_numpy(self.labels).to(self.device)
        if sampler == "device":
            # no-dedup block layout: levels S, S·F, …, S·F^hops must fit
            need = sum(batch_size * fanout ** h for h in range(self.hops + 1))
            if need > self.block_size:
                raise ValueError(f"device sampler needs block_size >= {need}")
            self._csr_dev = [(torch.from_numpy(c.row_ptr).to(self.device),
                              torch.from_numpy(c.col_idx).to(self.device))
                             for c in self.csrs]
            pr, ps = tree_parent_maps(batch_size, fanout, self.hops, self.block_size)
            self._parent_row = torch.from_numpy(pr).to(self.device)
            self._parent_slot = torch.from_numpy(ps).to(self.device)
            self._edge_sums = torch.zeros(2, dtype=torch.int64, device=self.device)

    # -- batch assembly ----------------------------------------------------
    def _pinned(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _prepare(self, seeds: np.ndarray, valid: np.ndarray, sample_seed: int,
                 *, fanout: int | None = None, block_size: int | None = None):
        """The host half of a batch (runs on the prefetch thread): a device
        sampler descriptor, or host-sampled blocks. Custom fanout/block_size
        requests (exact eval) always sample on the host."""
        if (self.sampler == "device" and fanout is None
                and block_size is None):
            b = seeds.shape[0]
            packed = np.empty(2 * b + 1, np.int32)
            packed[:b] = seeds
            packed[b:2 * b] = valid
            packed[-1:] = np.array([int(sample_seed) & _M32], np.uint32).view(np.int32)
            return _Descriptor(self._pinned(packed))
        return self._sample_host(seeds, valid, sample_seed, fanout=fanout,
                                 block_size=block_size)

    def _sample_host(self, seeds, valid, sample_seed, *, fanout=None,
                     block_size=None) -> _HostBatch:
        """Host-sampled blocks (C++ sampler) as CPU tensors. ``valid`` masks
        padded seed slots (eval tail batches); every batch of one
        (fanout, block_size) has the same shapes."""
        fanout = fanout if fanout is not None else self.fanout
        block_size = block_size if block_size is not None else self.block_size
        # block-local ids fit int16 at typical block sizes: half the bytes
        # to copy; widened to int32 on the device
        idx_dt = np.int16 if block_size + 1 < 2 ** 15 else np.int32
        nbrs, degs, xs, n_edges = [], [], [], 0
        lbl = (None if self.resident
               else np.zeros((block_size, self.labels.shape[1]), np.float32))
        mask = np.zeros(block_size, np.float32)
        for p, csr in enumerate(self.csrs):
            sb = sample_subgraph(
                csr, seeds, fanout=fanout, hops=self.hops,
                block_size=block_size, seed=sample_seed * 7919 + p)
            real = sb.nbr < block_size
            n_edges += int(real.sum())
            nbrs.append(self._pinned(sb.nbr.astype(idx_dt)))
            degs.append(self._pinned(real.sum(axis=1).astype(idx_dt)))
            if self.resident:
                xs.append(self._pinned(sb.nodes.astype(np.int32)))
            else:
                xs.append(self._pinned(sb.gather_features(self.features)))
            if p == 0:
                mask[: seeds.shape[0]] = valid.astype(np.float32)
                if not self.resident:
                    r = sb.nodes >= 0
                    lbl[r] = self.labels[sb.nodes[r]]
        return _HostBatch(nbrs, degs, xs,
                          None if lbl is None else self._pinned(lbl),
                          self._pinned(mask), block_size, fanout, n_edges)

    def _upload(self, batch):
        """Host half → the step's batch, ``(batch, None, None, None)``: a
        descriptor copied to the device (non-blocking, from pinned memory),
        or host-sampled blocks left in pinned memory, which the step copies
        to the device (into its static buffers once captured). Runs on the
        main thread, which also counts the host blocks' sampled edges."""
        if isinstance(batch, _Descriptor):
            batch = dataclasses.replace(
                batch, packed=batch.packed.to(self.device, non_blocking=True))
        else:
            self.sampled_edge_count += batch.n_edges
        return batch, None, None, None

    def _make_batch(self, seeds: np.ndarray, valid: np.ndarray,
                    sample_seed: int, *, fanout: int | None = None,
                    block_size: int | None = None):
        """One seed batch → the step's batch arguments (:meth:`_upload`)."""
        return self._upload(self._prepare(seeds, valid, sample_seed,
                                          fanout=fanout, block_size=block_size))

    def _device_blocks(self, packed: torch.Tensor):
        """Tree blocks sampled on the device around a (2B+1,) descriptor's
        seeds, keyed by its sample seed; returns (graphs, global node ids,
        mask, real sampled edges as a 0-d device tensor)."""
        b = (packed.shape[0] - 1) // 2
        seeds, valid = packed[:b], packed[b:2 * b] != 0
        graphs, xs, n_edges = [], [], 0
        for p, (rp, ci) in enumerate(self._csr_dev):
            nbr, deg, nodes, ne = _device_sample_block(
                rp, ci, seeds, valid, sample_key(packed[-1], p), fanout=self.fanout,
                hops=self.hops, block_size=self.block_size)
            graphs.append(TreeEllGraph(
                nbr=nbr, deg=deg, n_nodes=self.block_size,
                n_edges=self.block_size * self.fanout,
                parent_row=self._parent_row, parent_slot=self._parent_slot))
            xs.append(nodes)
            n_edges = n_edges + ne
        mask = torch.zeros(self.block_size, device=self.device)
        mask[:b] = valid.float()
        return graphs, xs, mask, n_edges

    def _host_blocks(self, flat):
        """A host-sampled batch's step inputs (:meth:`_HostBatch.flat`) →
        (graphs, xs, labels, mask) on the device. In a captured step the
        inputs are its static buffers; eagerly they are the pinned tensors,
        copied here. The int16 indices widen to int32 here, and every
        EllGraph has the block's static capacity (block_size nodes,
        block_size·fanout edges), as han_tpu pins them."""
        flat = [t.to(self.device, non_blocking=True) for t in flat]
        p = len(self.csrs)
        graphs = [EllGraph(nbr=nb.int(), deg=dg.int(), n_nodes=nb.shape[0],
                           n_edges=nb.numel())
                  for nb, dg in zip(flat[0:3 * p:3], flat[1:3 * p:3])]
        return graphs, flat[2:3 * p:3], None if self.resident else flat[3 * p], flat[-1]

    def _materialize(self, graphs, xs, labels, mask):
        """Batch → (graphs, feature rows, labels, mask, real sampled edges)
        on the device: a single descriptor gets its blocks sampled (the
        edge count a 0-d device tensor; None for host blocks, counted at
        upload), host blocks (a _HostBatch) are built from their tensors;
        resident mode gathers the block's rows from the device tables (xs
        carries global node ids, pad = -1)."""
        n_edges = None
        if isinstance(graphs, _Descriptor):
            graphs, xs, mask, n_edges = self._device_blocks(graphs.packed)
        elif isinstance(graphs, _HostBatch):
            graphs, xs, labels, mask = self._host_blocks(graphs.flat())
        if self.resident:
            labels = _resident_gather(self._lbl_dev, xs[0])
            xs = [_resident_gather(self._fts_dev, nd) for nd in xs]
        return graphs, xs, labels, mask, n_edges

    # -- steps -------------------------------------------------------------
    def _train_step(self, graphs, xs, labels, mask):
        """One Adam step on one uploaded batch (host-sampled blocks or a
        single descriptor); returns (loss, acc) as device tensors, from the
        pre-update forward, and the real sampled edges (a 0-d device tensor
        for a descriptor, None for host blocks). The loss and accuracy are
        masked means over the batch's seeds on every rank of ``self.axis``:
        the mask count is summed first, each rank backpropagates its share
        of the mean, the gradients are summed, and the L2 term is added
        once, after the sum."""
        graphs, xs, labels, mask, n_edges = self._materialize(graphs, xs, labels, mask)
        self.opt.zero_grad(set_to_none=True)
        logits, _, _ = self.model(graphs, xs, deterministic=False, rngs=self.rngs)
        loss_i = -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
        correct = (logits.argmax(-1) == labels.argmax(-1)).float()
        local = (loss_i * mask).sum()
        sums = all_sum(torch.stack([local.detach().float(), (correct * mask).sum(), mask.sum()]),
                       self.axis)
        n = sums[2].clamp_min(1.0)
        (local / n).backward()
        all_reduce_grads(self.model.parameters(), self.axis)
        l2 = l2_regularizer(self.model.parameters(), self.cfg.train.l2_coef)
        l2.backward()
        self.opt.step()
        return sums[0] / n + l2.detach(), sums[1] / n, n_edges

    def _dev_train_body(self, packs: torch.Tensor):
        """C sequential device-sampler steps over the (C, 2B+1) descriptors
        (han_tpu's ``dev_train_chunk``): (losses (C,), accs (C,)); their real
        sampled edges go to the train accumulator. The body of a captured
        dispatch."""
        losses, accs, n_edges = zip(*(self._train_step(_Descriptor(packed), None, None, None)
                                      for packed in packs))
        self._edge_sums[0].add_(sum(n_edges))
        return torch.stack(losses), torch.stack(accs)

    def _host_train_body(self, *flat):
        """One step on a host-sampled batch given as its flat tensors
        (han_tpu's jitted train step at the block's static shapes): (loss
        (1,), acc (1,)). The body of a captured step, which reads the batch
        through its arguments only."""
        loss, acc, _ = self._train_step(*self._host_blocks(flat))
        return loss[None], acc[None]

    def _train_graph(self, key, body) -> GraphedStep:
        """The train step of ``key`` (a device-sampler dispatch's C, or a
        host block's (block_size, fanout, resident)), made at its first
        use: eager on the CPU; on the card the trainer's first dispatch
        runs eagerly, and each step is captured at its next call."""
        step = self._train_steps.get(key)
        if step is None:
            step = self._train_steps[key] = GraphedStep(
                body, capture=self.capture, device=self.device,
                generators=(self.rngs.device,), warmup=0 if self._train_steps else 1)
        return step

    def _train_call(self, batch):
        """One train dispatch: host-sampled blocks, a descriptor, or C
        stacked descriptors (:meth:`_chunked`); returns (losses, accs) as
        (steps,) device tensors (a captured step's outputs, rewritten by
        its next replay). The call is the span ``han.train_step``."""
        head = batch[0]
        with span("han.train_step"):
            if isinstance(head, _HostBatch):
                key = (head.block_size, head.fanout, self.resident)
                return self._train_graph(key, self._host_train_body)(*head.flat())
            packs = head.packed if head.packed.dim() == 2 else head.packed[None]
            return self._train_graph(packs.shape[0], self._dev_train_body)(packs)

    @torch.no_grad()
    def _eval_step(self, graphs, xs, labels, mask):
        """(sum of masked loss, sum of masked correct, sum of mask) as one
        (3,) tensor, and the real sampled edges (as in :meth:`_train_step`)."""
        graphs, xs, labels, mask, n_edges = self._materialize(graphs, xs, labels, mask)
        logits, _, _ = self.model(graphs, xs, deterministic=True)
        loss_i = -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
        correct = (logits.argmax(-1) == labels.argmax(-1)).float()
        return torch.stack([(loss_i * mask).sum(), (correct * mask).sum(), mask.sum()]), n_edges

    def _dev_eval_body(self, packed: torch.Tensor) -> torch.Tensor:
        """One descriptor's evaluation batch (han_tpu's ``dev_eval_step``),
        its real sampled edges added to the evaluation accumulator: the
        body of the captured evaluation."""
        sums, n_edges = self._eval_step(_Descriptor(packed), None, None, None)
        self._edge_sums[1].add_(n_edges)
        return sums

    def _host_eval_body(self, *flat) -> torch.Tensor:
        """A host-sampled evaluation batch given as its flat tensors: the
        body of a captured evaluation step."""
        return self._eval_step(*self._host_blocks(flat))[0]

    def _eval_graph(self, key, body) -> GraphedStep:
        """The evaluation step of ``key``, made at its first use (captured
        on the card from its second call)."""
        if key not in self._eval_steps:
            self._eval_steps[key] = GraphedStep(body, capture=self.capture, device=self.device)
        return self._eval_steps[key]

    def _eval_call(self, batch) -> torch.Tensor:
        """One evaluation batch → (loss sum, correct sum, mask sum) on the
        device, summed over ``self.axis``: a descriptor through the device
        sampler's evaluation step, host blocks through their (block_size,
        fanout, resident) key's. The call is the span ``han.eval_step``."""
        head = batch[0]
        with span("han.eval_step"):
            if isinstance(head, _HostBatch):
                key = (head.block_size, head.fanout, self.resident)
                return all_sum(self._eval_graph(key, self._host_eval_body)(*head.flat()),
                               self.axis)
            return self._eval_graph("device", self._dev_eval_body)(head.packed)

    def flush_sampled_edges(self) -> int:
        """Fold what the device sampler's accumulators gained since the last
        flush into ``sampled_edge_count`` (one device sync) and return it."""
        if self._edge_sums is not None:
            sums = tuple(self._edge_sums.tolist())
            self.sampled_edge_count += sum(sums) - sum(self._edge_sums_read)
            self._edge_sums_read = sums
        return self.sampled_edge_count

    def _train_edges(self) -> int:
        """The real sampled edges of the train batches so far: the device
        sampler's train accumulator (one device sync), or, with host
        blocks, ``sampled_edge_count``, which an epoch's evaluation raises
        only after its train batches."""
        if self._edge_sums is not None:
            return int(self._edge_sums[0])
        return self.sampled_edge_count

    def _timed_prepare(self, *args):
        t0 = time.perf_counter()
        out = self._prepare(*args)
        self.host_block_s.append(time.perf_counter() - t0)
        return out

    def _prefetched_indexed(self, indexed_iter, sample_seed_fn):
        """One-ahead pipelined batch assembly: the next batch's host half is
        built on a worker thread while the device runs the current step;
        the main thread uploads it. ``indexed_iter`` yields (batch_index,
        (seeds, valid)); the index keys the deterministic sample seed. The
        wait on the worker and the upload are the span ``han.next_batch``,
        closed before the batch is yielded."""
        def ready(fut):
            with span("han.next_batch"):
                return fut[0], self._upload(fut[1].result())

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = None
            for bi, (seeds, valid) in indexed_iter:
                nxt = (bi, pool.submit(self._timed_prepare, seeds, valid,
                                       sample_seed_fn(bi)))
                if fut is not None:
                    yield ready(fut)
                fut = nxt
            if fut is not None:
                yield ready(fut)

    def _chunked(self, indexed_iter):
        """Group uploaded device-sampler descriptors into stacks of
        ``steps_per_call`` (han_tpu/train/sampled.py:482-498); yields
        (last_batch_index, (stacked descriptor, None, None, None)). The tail
        (< steps_per_call batches) is yielded as single descriptors, which
        reuse the one-step dispatch instead of capturing a shorter chunk."""
        buf, bis = [], []
        for bi, batch in indexed_iter:
            buf.append(batch[0].packed)
            bis.append(bi)
            if len(buf) == self.steps_per_call:
                yield bi, (_Descriptor(torch.stack(buf)), None, None, None)
                buf, bis = [], []
        for bi, packed in zip(bis, buf):
            yield bi, (_Descriptor(packed), None, None, None)

    # -- batch iteration ---------------------------------------------------
    def _seed_batches(self, idx: np.ndarray, *, shuffle: bool, epoch: int):
        rng = np.random.default_rng(self.cfg.train.seed * 1_000_003 + epoch)
        order = rng.permutation(idx) if shuffle else idx
        b = self.batch_size
        for i in range(0, order.shape[0], b):
            chunk = order[i : i + b]
            valid = np.ones(chunk.shape[0], bool)
            if chunk.shape[0] < b:  # pad tail batch, mask the padding out
                # repeat an in-batch seed (not node 0): with duplicate seeds
                # the sampler attaches neighbors to the first occurrence, so
                # the real (mask=1) row keeps its edges and only the masked
                # pad rows are edgeless
                pad = np.full(b - chunk.shape[0], chunk[0], chunk.dtype)
                valid = np.concatenate([valid, np.zeros(pad.shape[0], bool)])
                chunk = np.concatenate([chunk, pad])
            yield chunk.astype(np.int32), valid

    def exact_eval_plan(self, idx: np.ndarray | None = None,
                        max_block: int = 4_000_000):
        """(fanout, block_size) for exact evaluation of the nodes in
        ``idx``: block_size = the largest true L-hop reachable set of any
        eval batch (computed on the host from the CSRs), fanout = the max
        in-degree among nodes whose neighborhoods get expanded (BFS depth
        < L). Returns None when any batch's true block exceeds
        ``max_block``. ``idx=None`` gives the conservative global
        worst-case bound (no batch structure to measure)."""
        if idx is None:
            deg_max = max(
                int(np.diff(c.row_ptr).max()) if c.n_edges else 1
                for c in self.csrs)
            block = self.batch_size
            width = self.batch_size
            for _ in range(self.hops):
                width = width * deg_max  # worst-case frontier growth
                block = block + min(width, max_block)
                if block > max_block:
                    return None
            return deg_max, int(block)

        fanout_need = 1
        block_need = self.batch_size
        for seeds, _valid in self._seed_batches(np.asarray(idx),
                                                shuffle=False, epoch=0):
            for csr in self.csrs:
                u_seeds = np.unique(seeds.astype(np.int64))
                reached = u_seeds
                frontier = reached
                # the block keeps one row per seed slot (duplicate/padded
                # seeds occupy slots without adding reachable nodes), plus
                # one row per non-seed reached node
                slack = self.batch_size - u_seeds.size
                for _hop in range(self.hops):
                    # expanded nodes need their full in-neighbor list to fit
                    # the ELL width
                    degs = np.diff(csr.row_ptr)[frontier]
                    if degs.size:
                        fanout_need = max(fanout_need, int(degs.max()))
                    cols = _gather_neighbors(csr, frontier)
                    frontier = np.setdiff1d(np.unique(cols), reached,
                                            assume_unique=True)
                    reached = np.union1d(reached, frontier)
                    if reached.size + slack > max_block:
                        return None
                block_need = max(block_need, int(reached.size) + slack)
        if block_need > max_block:
            return None
        return fanout_need, int(block_need)

    def evaluate(self, idx: np.ndarray, *, epoch: int = 0,
                 exact: bool = False):
        """Masked loss/accuracy over ``idx`` at the current parameters.
        Default: sampled blocks — every node in ``idx`` is scored once, but
        its logits see only the bounded-fanout sampled neighborhood
        (deterministic in ``epoch``). ``exact=True``: full-neighborhood
        blocks (fanout = max degree), so the metric equals full-graph
        evaluation; falls back to sampled with an
        ``exact_eval_unavailable`` log line when they exceed capacity. The
        call is the span ``han.evaluate``, around its batches' ``han.eval_step``
        spans and the read-back."""
        with span("han.evaluate"):
            fanout = block = None
            if exact:
                plan = self.exact_eval_plan(np.asarray(idx))
                if plan is None:
                    self.logger.log({"exact_eval_unavailable":
                                     "full-neighborhood blocks exceed capacity",
                                     "fallback": "sampled"})
                else:
                    fanout, block = plan
            tot = torch.zeros(3, device=self.device)
            for bi, (seeds, valid) in enumerate(
                    self._seed_batches(idx, shuffle=False, epoch=0)):
                if self.eval_batches is not None and bi >= self.eval_batches:
                    break
                batch = self._make_batch(seeds, valid, sample_seed=10_000_019 + epoch,
                                         fanout=fanout, block_size=block)
                tot += self._eval_call(batch)
            tot_l, tot_c, tot_n = tot.tolist()
            tot_n = max(tot_n, 1.0)
            return tot_l / tot_n, tot_c / tot_n

    # -- checkpointing --------------------------------------------------------
    def checkpoints(self) -> CheckpointStore:
        return CheckpointStore(self.cfg.train.checkpoint_dir, f"{self.ds.name}_sampled")

    def restore_latest(self, step: int | None = None) -> dict[str, Any] | None:
        """The saved resume state of ``step`` (None: the latest save), or
        None when nothing was saved; loads nothing into the trainer."""
        return self.checkpoints().load(step)

    def _save(self, store: CheckpointStore, step: int, **scalars) -> None:
        """Rank 0 saves, with every rank's dropout generator state."""
        rank_rngs = all_gather_rows(self.rngs.device.get_state(), self.axis, self.device)
        if self.axis.rank == 0:
            store.save(step, training_state(self.model, self.opt, self.rngs.device,
                                            rank_rngs=rank_rngs, **scalars))

    def _load(self, state: dict[str, Any]) -> None:
        load_training_state(state, self.model, self.opt, self.rngs.device,
                            self._train_steps.values())
        self.rngs.device.set_state(state["rank_rngs"][self.axis.rank].clone())

    def fit(self, *, resume: bool = False) -> dict[str, Any]:
        """Train with early stopping, restore the best parameters and
        evaluate on the test nodes. ``resume``: continue from the latest
        checkpoint, mid-epoch if it was preempted there (a fresh start
        when there is none)."""
        cfg = self.cfg.train
        es = EarlyStopState()
        best = {"state": self._snapshot(), "epoch": -1}
        best_step = -1
        store = self.checkpoints()
        start_epoch, start_cursor = 0, 0
        carry_sums = (0.0, 0.0, 0)
        if resume:
            restored = store.load()
            if restored is not None:
                self._load(restored)
                es = EarlyStopState(restored["best_val_loss"], restored["best_val_acc"],
                                    restored["bad_epochs"])
                start_cursor = restored["cursor"]
                start_epoch = restored["epoch"] + (start_cursor == 0)
                carry_sums = (restored["loss_sum"], restored["acc_sum"], restored["n_batches"])
                best_step = restored["best_step"]
                if best_step >= 0:
                    best = {"state": store.load(best_step)["model"],
                            "epoch": best_step // _EPOCH_STRIDE - 1}
        train_idx = np.where(self.ds.train_mask)[0]
        val_idx = np.where(self.ds.val_mask)[0]
        train_losses, step_losses, step_times, train_edges = [], [], [], 0
        self.host_block_s = []
        t_start = time.perf_counter()
        preempted = False
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            edges0 = self._train_edges()
            resumed = epoch == start_epoch and start_cursor
            loss_sum, acc_sum, n_done = carry_sums if resumed else (0.0, 0.0, 0)
            skip = start_cursor if epoch == start_epoch else 0
            batches = ((bi, b) for bi, b in enumerate(
                self._seed_batches(train_idx, shuffle=True, epoch=epoch)) if bi >= skip)
            step_iter = self._prefetched_indexed(batches, lambda bi: epoch * 65_537 + bi)
            if self.steps_per_call > 1:
                step_iter = self._chunked(step_iter)
            t_step = time.perf_counter()
            for bi, batch in step_iter:
                losses, accs = self._train_call(batch)
                # waits for the dispatch; summed in step order, as single steps
                losses, accs = torch.stack([losses, accs]).tolist()
                for loss, acc in zip(losses, accs):
                    loss_sum += loss
                    acc_sum += acc
                step_losses.extend(losses)
                n_done += len(losses)
                now = time.perf_counter()
                # a dispatch of C steps counts as C steps of its mean time
                step_times.extend([(now - t_step) / len(losses)] * len(losses))
                t_step = now
                if self.guard is not None and self.guard.triggered:
                    # preemption: the whole resume state, with the batch
                    # cursor; the batch the prefetch thread holds is dropped
                    # and sampled again on resume from its seed
                    with span("han.save"):
                        self._save(store, epoch * _EPOCH_STRIDE + bi + 1, epoch=epoch,
                                   cursor=bi + 1, loss_sum=loss_sum, acc_sum=acc_sum,
                                   n_batches=n_done, best_val_loss=es.best_val_loss,
                                   best_val_acc=es.best_val_acc, bad_epochs=es.bad_epochs,
                                   best_step=best_step)
                    self.logger.log({"preempted_at": [epoch, bi + 1]})
                    preempted = True
                    break
            if preempted:
                break
            train_edges += self._train_edges() - edges0
            train_losses.append(loss_sum / max(n_done, 1))
            vl_loss, vl_acc = self.evaluate(val_idx, epoch=epoch)
            self.logger.log({
                "epoch": epoch, "train_loss": train_losses[-1],
                "train_acc": acc_sum / max(n_done, 1), "val_loss": vl_loss,
                "val_acc": vl_acc, "epoch_time_s": round(time.perf_counter() - t0, 4),
            })
            keep, _ = es.update(vl_loss, vl_acc)
            if keep or (cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0):
                with span("han.save"):
                    if keep:
                        best = {"state": self._snapshot(), "epoch": epoch}
                        best_step = (epoch + 1) * _EPOCH_STRIDE
                    self._save(store, (epoch + 1) * _EPOCH_STRIDE, epoch=epoch, cursor=0,
                               loss_sum=0.0, acc_sum=0.0, n_batches=0,
                               best_val_loss=es.best_val_loss,
                               best_val_acc=es.best_val_acc, bad_epochs=es.bad_epochs,
                               best_step=best_step)
            if es.bad_epochs >= cfg.patience:
                break
        if preempted:
            self.flush_sampled_edges()
            self.final_params = self._snapshot()
            return {"preempted": True, "train_time_s": time.perf_counter() - t_start,
                    "epoch_train_loss": train_losses, "step_train_loss": step_losses}

        self.model.load_state_dict(best["state"])
        self.final_params = self._snapshot()
        ts_loss, ts_acc = self.evaluate(np.where(self.ds.test_mask)[0], epoch=0)
        self.flush_sampled_edges()
        heads = self.cfg.model.n_heads[0]
        result = {
            "test_loss": ts_loss, "test_acc": ts_acc,
            "best_epoch": best["epoch"],
            "train_time_s": time.perf_counter() - t_start,
            "median_step_time_s": statistics.median(step_times) if step_times else None,
            "median_host_block_ms": (statistics.median(self.host_block_s) * 1e3
                                     if self.host_block_s else None),
            # real sampled edges × heads of the train blocks per second of
            # train step
            "edges_heads_per_s": (train_edges * heads / sum(step_times)
                                  if step_times else None),
            "captured": self.capture,
        }
        if self.device.type == "cuda":
            result["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        self.logger.log(result)
        result["epoch_train_loss"] = train_losses
        result["step_train_loss"] = step_losses
        result["step_time_s"] = step_times
        return result

    def _snapshot(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}


class DPSampledTrainer(SampledTrainer):
    """Sampled training data-parallel over the mesh's graph axis (port of
    han_tpu/train/sampled.py:820-944), one process a rank.

    The seed batch splits into S shards of ``batch_size / S`` seeds; rank r
    samples shard r's block on the host, with sample seed ``sample_seed·S +
    r`` and block size ``per_shard·(fanout+1)**hops``, and runs the step on
    it. Every rank builds the same parameters from ``cfg.train.seed``. Loss
    and accuracy are exact global masked means (:meth:`SampledTrainer.
    _train_step` over the axis), so an S-way step equals the one-device
    step on the same seeds. Each rank draws its dropout from a generator of
    its own (``cfg.train.seed + 1 + rank·1,000,003``: rank 0 draws the
    one-device trainer's stream). Evaluation sums over the axis. Rank 0
    logs and saves (with every rank's generator state), every rank loads.
    ``sampled_edge_count`` counts this rank's blocks.

    Refused as in han_tpu: the device sampler (NotImplementedError) and a
    batch that does not split into S shards (ValueError). At S = 1 the axis
    holds no process group and the steps are captured as
    :class:`SampledTrainer`'s; with a group (S > 1) they run eagerly, and
    ``capture=True`` raises NotImplementedError (NCCL collectives inside a
    captured graph are not ported)."""

    def __init__(self, ds: HeteroDataset, cfg: Config, *, mesh: Mesh,
                 batch_size: int = 512, fanout: int = 16,
                 hops: int | None = None, block_size: int | None = None, **kw):
        if kw.get("sampler", "host") == "device":
            raise NotImplementedError(
                "DPSampledTrainer shards host-built blocks; the device sampler is "
                "single-device (han_tpu has no data-parallel device sampler)")
        self.mesh = mesh
        self.n_shards = mesh.graph.size
        if batch_size % self.n_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by {self.n_shards} shards")
        per_shard = batch_size // self.n_shards
        h = hops if hops is not None else len(cfg.model.hid_units)
        block_size = block_size or int(per_shard * (fanout + 1) ** h)
        coordinator = mesh.rank == 0
        kw.setdefault("logger", MetricLogger(cfg.train.log_file if coordinator else "",
                                             echo=coordinator))
        kw.pop("device", None)
        super().__init__(ds, cfg, batch_size=batch_size, fanout=fanout, hops=hops,
                         block_size=block_size, device=mesh.device, axis=mesh.graph, **kw)

    def _prepare(self, seeds, valid, sample_seed, *, fanout=None, block_size=None):
        """This rank's shard of the batch, sampled on the host."""
        s, r = self.n_shards, self.axis.rank
        return super()._prepare(seeds.reshape(s, -1)[r], valid.reshape(s, -1)[r],
                                sample_seed * s + r, fanout=fanout, block_size=block_size)


def step_breakdown(trainer: SampledTrainer, idx: np.ndarray, *,
                   n_steps: int = 8, epoch: int = 7) -> dict[str, Any]:
    """Where one sampled train step's time goes, on the card.

    host_block_ms: median time to build one batch's host half (the C++
    sampler, index conversion, pinning) — the prefetch thread's work per
    step. device_ms: device time per train step (uploads included), the
    sum of the CUDA kernel and copy times ``torch.profiler`` records over
    ``n_steps`` steps dispatched as ``fit()`` dispatches them (in stacks of
    ``steps_per_call``, captured where the trainer captures), or None when
    the profiler records no device events; launches: kernel launches
    (``cudaLaunchKernel``) and graph launches (``cudaGraphLaunch``) per
    step. Host-sampled batches go through the host sampler's step,
    captured where the trainer captures. The steps run twice before the
    profiled pass (so that every dispatch is captured by then) and train
    the model further."""
    from torch.profiler import ProfilerActivity, profile

    from han_tpu_torch.utils.prof import device_events

    batches, host_s = [], []
    for i, (seeds, valid) in zip(range(n_steps), trainer._seed_batches(
            np.asarray(idx), shuffle=True, epoch=epoch)):
        t0 = time.perf_counter()
        batches.append(trainer._prepare(seeds, valid, 900 + i))
        host_s.append(time.perf_counter() - t0)
    calls = list(enumerate(trainer._upload(b) for b in batches))
    if trainer.steps_per_call > 1:
        calls = list(trainer._chunked(calls))
    for _ in range(2):  # warm: the first dispatch eager, then the captures
        for _, b in calls:
            trainer._train_call(b)
    torch.cuda.synchronize(trainer.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, b in calls:
            trainer._train_call(b)
        torch.cuda.synchronize(trainer.device)
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in device_events(events))
    count = lambda key: sum(e.count for e in events if e.key == key) / len(batches)
    trainer.flush_sampled_edges()
    return {"host_block_ms": statistics.median(host_s) * 1e3,
            "device_ms": dev_us / 1e3 / len(batches) if dev_us else None,
            "kernel_launches": count("cudaLaunchKernel"),
            "graph_launches": count("cudaGraphLaunch")}


def _gather_neighbors(csr, nodes: np.ndarray) -> np.ndarray:
    """All in-neighbors of ``nodes`` (concatenated, with duplicates) from a
    CSR view — vectorized range-gather, O(total neighbor count)."""
    starts = csr.row_ptr[nodes]
    counts = csr.row_ptr[nodes + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=csr.col_idx.dtype)
    cum = np.concatenate([[0], np.cumsum(counts)])
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(cum[:-1], counts) + np.repeat(starts, counts))
    return csr.col_idx[pos]


class _ScipyCSRView:
    """Duck-typed CSRGraph view over a scipy matrix (host arrays; index
    dtypes normalized once at construction)."""

    def __init__(self, m):
        m = m.tocsr()
        self.row_ptr = np.ascontiguousarray(m.indptr, np.int64)
        self.col_idx = np.ascontiguousarray(m.indices, np.int32)
        self.n_nodes = m.shape[0]
        self.n_edges = int(m.nnz)
