"""Flash-GAT at N = 65,536 on the card, and where the csr backend overtakes
it (the PyTorch + CUDA counterpart of scripts/flash_scale_demo.py).

Default: a community-structured power-law graph (:func:`community_powerlaw`,
2 M edges over 128 communities that each mix with 4 partners, plus
self-loops) in the port's 128x128 tiles. It prints the memory of the BCSR
tiles (what the flash kernels read) and of the edge view beside them
against a dense int8 adjacency and the dense (K, N, N) f32 coefficients of
the reference path, then times one flash forward and one forward +
backward (K = D = 8) on the card and prints one JSON line.

``--sweep``: flash forward + backward against csr forward + backward (the
edge view through ``BCSRGraph.as_csr``, as ``impl="auto"`` runs it) at
dropout 0 and 0.6, K = D = 8, on graphs whose tile elements an edge run
from DBLP's meta-paths through the benchmark graph and Pubmed to randomly
relabelled graphs, where nearly every edge sits in a tile of its own:
one JSON line a point, then one with the crossing, the elements an edge
where csr starts to win (log-log interpolation between the last point
flash wins and the next). ``ops/attention.FLASH_MAX_ELEMS_PER_EDGE_BY_TILE``
holds the measured figure.

Times are device times: calls queued behind a spin kernel, CUDA events
around them (``chip_smoke.timed``). Every line carries the card's name and
power limit.

    python3 scripts/flash_scale_demo_torch.py [--n 65536] [--edges 2000000]
    python3 scripts/flash_scale_demo_torch.py --sweep

Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

DROPOUTS = (0.0, 0.6)


def community_powerlaw(n: int, e: int, *, n_comm: int = 128,
                       partners: int = 4, seed: int = 0) -> sp.csr_matrix:
    """n nodes in n_comm communities; e edges whose destination is uniform
    and whose source lies in the destination's community or one of its
    ``partners`` partner communities (drawn once), at a zipf-like position
    in it (a power-law in-degree); duplicates summed (numpy copy of
    scripts/flash_scale_demo.py:community_powerlaw)."""
    rng = np.random.default_rng(seed)
    csize = n // n_comm
    partner_tbl = np.concatenate(
        [np.arange(n_comm)[:, None],
         rng.integers(0, n_comm, (n_comm, partners))], axis=1)
    dst = rng.integers(0, n, e)
    dc = dst // csize
    pick = partner_tbl[dc, rng.integers(0, partners + 1, e)]
    pos = (csize * rng.random(e) ** 3).astype(np.int64)
    src = pick * csize + pos
    a = sp.coo_matrix((np.ones(e, np.float32), (dst, src)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def relabelled(a: sp.csr_matrix, seed: int = 1) -> sp.csr_matrix:
    """``a`` under a random permutation of its node ids: the same degrees,
    no tile locality."""
    perm = np.random.default_rng(seed).permutation(a.shape[0])
    return a[perm][:, perm].tocsr()


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sweep_graphs():
    """(label, scipy adjacency without self-loops) of every sweep point."""
    from bench_torch import build_workload
    from han_tpu_torch.datasets.planetoid import load_planetoid, write_planetoid
    from han_tpu_torch.datasets.registry import dblp_synthetic

    dblp = dblp_synthetic(seed=0)
    for name, a in zip(dblp.metapath_names, dblp.metapath_adjs):
        yield f"dblp {name}", a
    yield "bench (planted_hetero, N 8192, degree 128, bfs)", \
        build_workload(8192, 2, 128, "bfs")[0].metapath_adjs[0]
    with tempfile.TemporaryDirectory() as root:
        write_planetoid(root)
        yield "pubmed fixture", load_planetoid(root, "pubmed").metapath_adjs[0]
    for n_comm, partners in ((512, 4), (128, 0), (128, 4), (128, 16), (32, 4), (32, 16)):
        yield (f"community_powerlaw N 65536, E 2M, {n_comm} communities, {partners} partners",
               community_powerlaw(65536, 2_000_000, n_comm=n_comm, partners=partners))
    for e in (1_000_000, 250_000, 60_000):
        yield (f"community_powerlaw N 32768, E {e}, relabelled",
               relabelled(community_powerlaw(32768, e)))


def inputs(n: int, k: int, d: int, dev, seed: int = 0):
    """fts (n, K, D), logit_dst, logit_src (n, K) and the output weight w,
    f32 on the card, from a seeded generator."""
    import torch

    gen = torch.Generator(dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return rnd(n, k, d), rnd(n, k), rnd(n, k), rnd(n, k, d)


def fwd_bwd(attn, graph, x, p: float, dev):
    """A call of attn(graph, fts, ld, ls) forward and backward (gradients of
    sum(out · w) with respect to fts, ld and ls) at coefficient dropout p."""
    import torch

    fts, ld, ls, w = x
    leaves = [t.clone().requires_grad_() for t in (fts, ld, ls)]
    gen = torch.Generator(dev).manual_seed(7)

    def call():
        out = attn(graph, *leaves, coef_dropout=p, generator=gen)
        return torch.autograd.grad((out * w).sum(), leaves)
    return call


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--edges", type=int, default=2_000_000)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--sweep", action="store_true", help="flash against csr over occupancies")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_scale_demo_torch: no CUDA card (torch.cuda.is_available() is false)")
    from chip_smoke import timed
    from han_tpu_torch.graph.build import metapath_to_bcsr
    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.ops.attention import csr_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    device = card()
    k, d = args.heads, args.dim
    flash = fg.flash_gat_attention
    csr = lambda g, *a, **kw: csr_attention(g.as_csr(), *a, **kw)

    if not args.sweep:
        adj = community_powerlaw(args.n, args.edges)
        g = metapath_to_bcsr(adj)
        tile_b = g.tiles.numel() + 4 * sum(t.numel() for t in (
            g.fwd_count, g.fwd_col, g.fwd_tile, g.bwd_count, g.bwd_row, g.bwd_tile))
        view_b = 4 * sum(t.numel() for t in (g.edge_row_ptr, g.edge_col, g.edge_row))
        g = g.to(dev)
        x = inputs(args.n, k, d, dev)
        with torch.no_grad():
            fwd_ms = timed(lambda: flash(g, *x[:3]), reps=5)
        fb_ms = timed(fwd_bwd(flash, g, x, 0.0, dev), reps=5)
        print(json.dumps({
            "n": args.n, "edges": g.n_edges, "tiles": g.n_tiles, "bm": g.bm, "bn": g.bn,
            "occupancy": g.occupancy(), "elems_per_edge": g.elems_per_edge(),
            "bcsr_bytes": tile_b, "edge_view_bytes": view_b, "dense_int8_bytes": args.n ** 2,
            "dense_coef_bytes": 4 * k * args.n ** 2, "heads": k, "dim": d,
            "fwd_ms": fwd_ms, "fwdbwd_ms": fb_ms, "fwd_edges_heads_per_s": g.n_edges * k / fwd_ms * 1e3,
            "device": device}), flush=True)
        return

    points = []
    for label, adj in sweep_graphs():
        g = metapath_to_bcsr(adj).to(dev)
        x = inputs(g.n_nodes, k, d, dev)
        point = {"point": label, "n": g.n_nodes, "edges": g.n_edges, "tiles": g.n_tiles,
                 "elems_per_edge": g.elems_per_edge(), "flash_ms": {}, "csr_ms": {}}
        for drop in DROPOUTS:
            point["flash_ms"][str(drop)] = timed(fwd_bwd(flash, g, x, drop, dev), reps=5)
            point["csr_ms"][str(drop)] = timed(fwd_bwd(csr, g, x, drop, dev), reps=5)
        points.append(point)
        print(json.dumps({**point, "device": device}), flush=True)
        del g, x
        torch.cuda.empty_cache()
    print(json.dumps({"crossing_elems_per_edge": {str(drop): crossing(points, str(drop))
                                                  for drop in DROPOUTS},
                      "bm": 128, "bn": 128, "heads": k, "dim": d, "device": device}), flush=True)


def crossing(points: list[dict], drop: str) -> float | None:
    """Elements an edge where csr starts to win at dropout ``drop``: between
    the largest elems_per_edge at which flash is faster and the smallest
    larger one (csr faster there and at every point beyond), log-log
    interpolated where their flash/csr time ratio passes 1. None when one
    backend wins at every point."""
    pts = sorted((q["elems_per_edge"], q["flash_ms"][drop] / q["csr_ms"][drop]) for q in points)
    wins = [i for i, (_, r) in enumerate(pts) if r < 1.0]
    if not wins or wins[-1] == len(pts) - 1:
        return None
    (x0, r0), (x1, r1) = pts[wins[-1]], pts[wins[-1] + 1]
    t = -math.log(r0) / (math.log(r1) - math.log(r0))
    return math.exp(math.log(x0) + t * (math.log(x1) - math.log(x0)))


if __name__ == "__main__":
    main()
