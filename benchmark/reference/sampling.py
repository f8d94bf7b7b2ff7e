"""The sampled cells' batches, worked out again from the inputs: which seed
nodes a batch holds. Plain numpy; nothing here imports the program.

Frozen copies of the program's rules (``train/sampled.py``), written from
their definitions:

- :func:`epoch_batches`: the batch order of a training epoch, a
  permutation of the train nodes drawn from ``default_rng(seed ·
  1,000,003 + epoch)``, cut into batches of B (``_seed_batches``), and the
  sample seed ``epoch · 65,537 + batch`` of each (``SampledTrainer.fit``);
- :func:`ordered_batches`: an evaluation's batches, the nodes in their
  order (``_seed_batches`` without shuffling);
- a tail batch is padded with its first seed, the padding masked out.

Each sampler's rule for the block around a batch's seeds is
``samplers/<sampler>.py``.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def _cut(order: np.ndarray, batch_size: int) -> list:
    out = []
    for i in range(0, order.shape[0], batch_size):
        chunk = order[i:i + batch_size]
        valid = np.ones(chunk.shape[0], bool)
        if chunk.shape[0] < batch_size:
            pad = np.full(batch_size - chunk.shape[0], chunk[0], chunk.dtype)
            valid = np.concatenate([valid, np.zeros(pad.shape[0], bool)])
            chunk = np.concatenate([chunk, pad])
        out.append((chunk.astype(np.int32), valid))
    return out


def epoch_batches(train_idx: np.ndarray, batch_size: int, train_seed: int, epoch: int):
    """[(seeds int32 (B,), valid bool (B,), sample seed)] of one epoch."""
    rng = np.random.default_rng(train_seed * 1_000_003 + epoch)
    return [(s, v, epoch * 65_537 + bi)
            for bi, (s, v) in enumerate(_cut(rng.permutation(train_idx), batch_size))]


def ordered_batches(idx: np.ndarray, batch_size: int):
    """[(seeds int32 (B,), valid bool (B,))] of an evaluation of ``idx``."""
    return _cut(np.asarray(idx), batch_size)


def fmix32(h):
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mul32(x, c: int):
    """(x · c) mod 2³² for 0 ≤ x < 2³², without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32
