"""The device sampler's rule (``train/sampled.py:_device_sample_block``),
a frozen copy written from its definition: F slots a seed, offsets from a
murmur3-finalizer counter hash of (sample seed, meta-path, level, row,
slot), with replacement above degree F, the whole list at or below it; the
block a tree, level 1 at row B + r·F + f."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.sampling import GOLDEN, M32, fmix32, mul32


def block(inputs, p: int, seeds: np.ndarray, valid: np.ndarray, fanout: int,
          block_size: int, sample_seed: int, device):
    """One hop around ``seeds`` in meta-path ``p``: (nodes int64 (block,)
    global ids, −1 pad; nbr int64 (block, F) local rows, pad = block)."""
    b = seeds.shape[0]
    # the descriptor carries the sample seed as int32 bits
    key = fmix32((sample_seed & M32) ^ fmix32((p + GOLDEN) & M32))
    level_key = fmix32(key ^ fmix32((0 + GOLDEN) & M32))
    row_key = fmix32(level_key ^ torch.arange(b, device=device))
    bits = fmix32(row_key[:, None] ^ mul32(torch.arange(fanout, device=device), GOLDEN)[None, :])
    u = ((bits >> 8).to(torch.float32) * 2.0 ** -24).cpu()
    nodes = np.full(block_size, -1, np.int64)
    nodes[:b] = np.where(valid, seeds, -1)
    nbr = np.full((block_size, fanout), block_size, np.int64)
    for r in range(b):
        if not valid[r]:
            continue
        row = inputs.neighbours(p, int(seeds[r]))
        deg = row.shape[0]
        if deg <= fanout:
            off = np.arange(fanout)
        else:
            off = torch.floor(u[r] * deg).long().clamp_max(deg - 1).numpy()
        for f in range(fanout):
            if off[f] < deg:
                nodes[b + r * fanout + f] = row[off[f]]
                nbr[r, f] = b + r * fanout + f
    return nodes, nbr
