"""The width of a head-dim chunk of the split backward, measured on the card.

The split backward (the row and column sweeps, the deterministic path)
runs a head wider than the kernels' largest instantiation (32) as chunks
of ``ops/flash_gat.py:HEAD_CHUNK`` columns on the kernels' grid; the
forward and the fused backward take such a head through their wide
bodies on these tiles. This script holds the row and column sweeps at
D = 64 on DBLP's largest meta-path (dblp_synthetic's APTPA, K = 8, f32
v) in chunks of 16 (four a head) and of 32 (two) to their full-D plain
versions (atol 1e-4, rtol 1e-3), then times each sweep at both widths in
turns (16, 32, 32, 16) at dropout 0 and 0.6. The width is set by
rebinding the module's constant for the run, which the wrappers read
through ``head_plan``. Device times as ``chip_smoke.timed`` takes them.
Prints one JSON line: ms per sweep, dropout and width, the ratio
t16 / t32, and the card's name and power limit.

    python3 scripts/flash_chunk_width_torch.py

Exits non-zero without a card.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

DROPOUTS = (0.0, 0.6)
WIDTHS = (16, 32)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_chunk_width_torch: torch.cuda.is_available() is false")
    from chip_smoke import check, dblp_inputs, timed
    from han_tpu_torch.datasets.registry import dblp_synthetic
    from han_tpu_torch.graph.build import metapath_to_bcsr
    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.utils.prof import card

    dev = torch.device("cuda")
    ds = dblp_synthetic(seed=0)
    big = max(range(len(ds.metapath_adjs)), key=lambda p: ds.metapath_adjs[p].nnz)
    graph = metapath_to_bcsr(ds.metapath_adjs[big]).to(dev)
    k, d = 8, 64
    ld, ls, v, g = dblp_inputs(torch.Generator(dev).manual_seed(0), graph.n_pad, ds.n_nodes,
                               k, d)
    in_use = fg.HEAD_CHUNK
    ms = {key: {} for key in ("row", "col")}
    try:
        for p in DROPOUTS:
            meta = fg.FlashMeta(slope=0.2, dropout_p=p, seed=fg.seed_tensor(7654321, dev))
            out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
            fns = {}
            for w in WIDTHS:
                fg.HEAD_CHUNK = w
                tag = f"chunks of {w}, dropout {p}"
                args = (graph, ld, ls, v, g, lse_p, fg.head_delta(g, out_p, k), meta)
                for key, got, want in (
                        ("row", (fg.flash_bwd_row_cuda(*args),), (fg.flash_bwd_row_plain(*args),)),
                        ("col", fg.flash_bwd_col_cuda(*args), fg.flash_bwd_col_plain(*args))):
                    for a, b in zip(got, want):
                        check(f"{tag}: {key}", a, b, 1e-4, 1e-3)
                fns[w] = {"row": lambda a=args: fg.flash_bwd_row_cuda(*a),
                          "col": lambda a=args: fg.flash_bwd_col_cuda(*a)}
            for key in ms:
                t = {w: [] for w in WIDTHS}
                for w in (16, 32, 32, 16):
                    fg.HEAD_CHUNK = w
                    t[w].append(timed(fns[w][key]))
                ms[key][str(p)] = {str(w): x for w, x in t.items()}
                ms[key][str(p)]["ratio_16_32"] = statistics.mean(t[16]) / statistics.mean(t[32])
                print(f"D = 64 {key}, dropout {p}: chunks of 16 {t[16][0]:.4f} / "
                      f"{t[16][1]:.4f} ms, of 32 {t[32][0]:.4f} / {t[32][1]:.4f} ms; 16 / 32 "
                      f"{ms[key][str(p)]['ratio_16_32']:.3f}", flush=True)
            del out_p, lse_p, fns
            torch.cuda.empty_cache()
    finally:
        fg.HEAD_CHUNK = in_use
    print(json.dumps({"d": d, "k": k, "graph": ds.metapath_names[big],
                      "head_chunk_in_use": in_use, "ms": ms, "card": card()}), flush=True)


if __name__ == "__main__":
    main()
