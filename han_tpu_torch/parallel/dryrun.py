"""Multi-process dry run: one full HAN training step per distributed
backend on tiny shapes (port of han_tpu/parallel/dryrun.py).

In a running process group, :func:`dryrun_step` lays the ranks out as
han_tpu does (a heads axis of 2 when the world is even and at least 4, the
graph axis the rest; K = max(2 · heads, 4) heads) and exercises the three
distributed backends with the complete training step: partitioned
containers (partition_bcsr for the sharded flash kernels, ring_partition_bcsr
for the ring of them, partition_csr for the sharded segment ops),
coefficient dropout, heads sharded over the heads axis, replicated
parameters whose gradients the collectives inside attention make whole,
the masked loss and an Adam update. With dropout off the backends compute
the same masked softmax aggregate, so their losses at one set of weights
must agree.

    python3 -m han_tpu_torch.parallel.dryrun 4     # 4 CPU ranks (gloo)
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from han_tpu_torch.graph.build import metapath_to_csr, with_self_loops
from han_tpu_torch.graph.synthetic import planted_hetero
from han_tpu_torch.nn.layers import DropoutGenerators
from han_tpu_torch.nn.losses import l2_regularizer, masked_softmax_cross_entropy
from han_tpu_torch.nn.models import HAN
from han_tpu_torch.parallel.edge_partition import partition_csr
from han_tpu_torch.parallel.flash_shard import partition_bcsr
from han_tpu_torch.parallel.launch import spawn
from han_tpu_torch.parallel.mesh import make_mesh
from han_tpu_torch.parallel.ring_bcsr import ring_partition_bcsr


def dryrun_step() -> dict:
    """One train step and one deterministic loss per backend (flash,
    ring_bcsr, csr) on every rank of the default process group; raises if
    the deterministic losses differ by 1e-4 or more."""
    world = make_mesh(graph=0).size
    heads = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(graph=world // heads, heads=heads)
    s_n, dev = mesh.graph.size, mesh.device
    n_heads = max(2 * heads, 4)  # K divisible by the heads axis
    # n large enough that every shard owns at least one bm=128 row block
    ds = planted_hetero(n_nodes=128 * max(s_n, 2), n_feats=16, n_classes=3,
                        n_metapaths=2, avg_degree=5.0, train_per_class=8,
                        n_val=8, seed=3)
    backends = {
        "flash": [partition_bcsr(with_self_loops(a), s_n, bm=128, bn=128)
                  for a in ds.metapath_adjs],
        "ring_bcsr": [ring_partition_bcsr(with_self_loops(a), s_n, bm=128, bn=128)
                      for a in ds.metapath_adjs],
        "csr": [partition_csr(metapath_to_csr(a, edge_pad_to=32), s_n, edge_pad_to=32)
                for a in ds.metapath_adjs],
    }
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    losses, det_losses = {}, {}
    for name, graphs in backends.items():
        graphs = [dataclasses.replace(g.to(dev), mesh=mesh) for g in graphs]
        # one initialization (same seed) for every backend and rank
        model = HAN(x.shape[1], ds.n_classes, len(graphs), hid_units=(8,),
                    n_heads=(n_heads, 1), semantic_dim=16, attn_drop=0.3,
                    ffd_drop=0.3, generator=torch.Generator().manual_seed(0)).to(dev)
        with torch.no_grad():
            logits, _, _ = model(graphs, [x] * len(graphs))
            det_losses[name] = float(masked_softmax_cross_entropy(logits, labels, mask))
        opt = torch.optim.Adam(model.parameters(), lr=5e-3)
        rngs = DropoutGenerators(device=torch.Generator(dev).manual_seed(1))
        logits, _, _ = model(graphs, [x] * len(graphs), deterministic=False, rngs=rngs)
        loss = (masked_softmax_cross_entropy(logits, labels, mask)
                + l2_regularizer(model.parameters(), 1e-3))
        loss.backward()
        opt.step()
        losses[name] = float(loss.detach())
        if not np.isfinite(losses[name]):
            raise AssertionError(f"non-finite {name} loss")
    vals = list(det_losses.values())
    max_dev = max(abs(v - vals[0]) for v in vals)
    if not max_dev < 1e-4:
        raise AssertionError(f"deterministic losses disagree across backends: "
                             f"{det_losses} (max deviation {max_dev:.2e})")
    return {"graph": s_n, "heads": heads, "losses": losses, "det_losses": det_losses,
            "det_max_dev": max_dev}


def run_dryrun(n_devices: int, backend: str = "gloo") -> dict:
    """:func:`dryrun_step` in a spawned world of ``n_devices`` ranks; prints
    and returns rank 0's summary."""
    res = spawn(dryrun_step, n_devices, backend)[0]
    print(f"dryrun_multichip ok: mesh={{'graph': {res['graph']}, 'heads': {res['heads']}}} "
          + " ".join(f"{k}_loss={v:.4f}" for k, v in res["losses"].items())
          + f" det_max_dev={res['det_max_dev']:.2e}", flush=True)
    return res


if __name__ == "__main__":
    run_dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
