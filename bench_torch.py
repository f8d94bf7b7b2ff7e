"""Benchmark of han_tpu_torch on the card: the fused graph-attention aggregate
(SDDMM + masked softmax + SpMM), forward and backward — the PyTorch + CUDA
counterpart of bench.py, on the same workload.

Prints ONE JSON line: {"metric": ..., "value": ..., "unit": ...,
"vs_baseline": ..., "detail": {...}}.

- value: real edges × heads per second of the chosen backend (default the
  hand-written CUDA flash kernels) on the HAN workload (P meta-paths × K
  heads; ``planted_hetero`` with N = 8192, P = 2, K = 8, D = 8, average
  degree 128, nodes in bfs order), one forward + backward with respect to
  the features and both logit terms per iteration;
- vs_baseline: speed-up over the port's dense masked-softmax path (the
  reference's dense attention math) on the same card, also fwd+bwd;
- detail.roofline (flash only): the achieved share of two speed-of-light
  models, as in bench.py: tile-domain (compute or device-memory time over
  the occupied tiles the kernels sweep) and edge-domain (work on the real
  edges only). The compute side is the calibration kernels' strip time
  (han_tpu_torch/ops/calibrate.py), measured in this process on this card
  (two calls may land on two cards) and held to the fold checks of
  scripts/cal_vpu_torch.py; device memory is 3.35e12 B/s, the published
  H100 SXM figure, stated at the card's power limit. The strips run the
  flash kernels' own tile bodies (the code of ``fwd_kernel``'s sweep, with
  f32 v or, on the bf16 arm, bf16 v, and of the fused ``bwd_col_kernel``'s,
  csrc/tile_mma.cuh, on one tile held on chip: nothing staged, no map
  walked), so on both arms ``tile_sol_frac`` is a bound: the share of
  t_main that sweeping the occupied tiles takes with the kernels' body and
  no overhead. It rests on each strip taking no longer a tile-head than
  its kernel, which chip_smoke.py (``compare_strips``) checks on every
  run. ``edge_sol_frac`` takes the same per-element strip time over the
  real edges only.
- detail.device: the card's name and power limit; detail.device_count.
- detail.t_main_device_ms and detail.device_share: the card's own time
  per iteration of the timed backend (the self device time of every CUDA
  event, kernels, copies and fills, in a torch.profiler window of
  PROFILED iterations; null where the profiler records none), and its
  share of t_main_ms. A share well below 1 means the host bounds t_main.

Times are CUDA events around ``--iters`` back-to-back iterations after a
warm-up, the best of 5 runs, divided by ``--iters``.

    python3 bench_torch.py
    python3 bench_torch.py --dtype bfloat16
    python3 bench_torch.py --impl csr --fwd-only --no-dense

Exits non-zero without a card; it never times the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

HBM_BW = 3.35e12  # bytes/s: the H100 SXM's published device-memory rate (700 W)
CAL_STRIP_REPS = 256  # in-process calibration: passes R of the R -> 2R timing
PROFILED = 5  # iterations in the profiler window of t_main_device_ms


def build_workload(n: int, n_metapaths: int, avg_degree: float, reorder: str):
    """bench.py's dataset (planted_hetero, seed 0) in ``reorder`` order and
    its CSR graphs with self-loops; returns (ds, csr_graphs, total_edges)."""
    from han_tpu_torch.graph.build import metapath_to_csr
    from han_tpu_torch.graph.synthetic import planted_hetero

    ds = planted_hetero(n_nodes=n, n_feats=64, n_classes=3, n_metapaths=n_metapaths,
                        avg_degree=avg_degree, train_per_class=100, n_val=100, seed=0)
    if reorder != "none":
        from han_tpu_torch.graph.reorder import reorder as apply_reorder

        ds = apply_reorder(ds, reorder)
    csr_graphs = [metapath_to_csr(a) for a in ds.metapath_adjs]
    return ds, csr_graphs, sum(g.n_edges for g in csr_graphs)


def roofline(tiles: list[tuple[int, int, int, float]], *, total_edges: int, n: int,
             k: int, d: int, t_main: float, fwd_only: bool, t_fwd_strip: float,
             t_bwd_strip: float, elems_per_strip: int, feat_bytes: int = 4,
             hbm_bw: float = HBM_BW) -> dict:
    """bench.py's two speed-of-light models (bench.py:229-259). ``tiles``
    holds (n_tiles, bm, bn, occupancy) per flash graph; ``t_*_strip`` are
    seconds per calibrated strip of ``elems_per_strip`` elements and one
    head; ``feat_bytes`` is the width of a streamed feature."""
    tile_area = sum(t * bm * bn for t, bm, bn, _ in tiles)
    n_strips = tile_area / elems_per_strip
    t_strip = t_fwd_strip if fwd_only else t_fwd_strip + t_bwd_strip
    t_tile_compute = n_strips * k * t_strip
    passes = 1 if fwd_only else 2  # the forward sweep; the fused backward sweep
    hbm_bytes = passes * (tile_area  # int8 adjacency tiles
                          + sum(t * bn * k * d * feat_bytes for t, _, bn, _ in tiles))  # v
    t_tile_hbm = hbm_bytes / hbm_bw
    t_tile_sol = max(t_tile_compute, t_tile_hbm)
    t_edge_sol = max(total_edges / elems_per_strip * k * t_strip,
                     passes * (total_edges * (1 + k * 4) + n * k * d * feat_bytes) / hbm_bw)
    return {
        "occupancy": sum(o for *_, o in tiles) / len(tiles),
        "tile_sol_ms": t_tile_sol * 1e3,
        "tile_sol_frac": t_tile_sol / t_main,
        "edge_sol_ms": t_edge_sol * 1e3,
        "edge_sol_frac": t_edge_sol / t_main,
        "tile_compute_bound": bool(t_tile_compute >= t_tile_hbm),
        "calibrated": True,
    }


def calibrate_here(info: dict) -> dict:
    """Strip times for the roofline, measured now, in this process, on 8
    strips an SM; raises on a rate above its ceiling or a time ratio that
    shows a folded chain (ops/calibrate.py:check_ceilings)."""
    from han_tpu_torch.ops.calibrate import calibrate_strips, ceilings, check_ceilings

    cal = {**calibrate_strips(info["sms"] * 8, CAL_STRIP_REPS),
           "ceilings_eps": ceilings(info["sms"], info["max_sm_clock_hz"])}
    bad = check_ceilings(cal)
    if bad:
        raise RuntimeError("strip calibration folded (no roofline from it):\n" + "\n".join(bad))
    return cal


def time_per_iter(fn, iters: int, outer: int = 5) -> float:
    """Seconds per call of fn: CUDA events around ``iters`` back-to-back
    calls, after two warm-up calls; the best of ``outer`` runs."""
    import torch

    for _ in range(2):
        fn()
    best = float("inf")
    for _ in range(outer):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / iters)
    return best


def device_ms_per_iter(fn, iters: int = PROFILED) -> float | None:
    """Device ms per call of fn: the self device time of every CUDA event in
    a torch.profiler window of ``iters`` calls (utils/prof.device_events:
    no annotation range); None where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from han_tpu_torch.utils.prof import device_events

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in device_events(prof.key_averages()))
    return us / iters / 1e3 if us else None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--avg-degree", type=float, default=128.0)
    p.add_argument("--metapaths", type=int, default=2)
    p.add_argument("--impl", default="flash", choices=["flash", "dense", "csr", "ell"])
    p.add_argument("--bm", type=int, default=0, help="BCSR row tile (0 = default)")
    p.add_argument("--bn", type=int, default=0, help="BCSR column tile (0 = default)")
    p.add_argument("--reorder", default="bfs",
                   help="node ordering for tile locality: bfs|labels|degree|none")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--fwd-only", action="store_true")
    p.add_argument("--no-dense", action="store_true",
                   help="skip the dense baseline (N² memory); vs_baseline is null")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="feature dtype fed to the backends (accumulators stay f32)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch: CUDA is not available; the benchmark times the card and "
                 "never the CPU")
    from han_tpu_torch.graph.build import metapath_to_bcsr, metapath_to_dense
    from han_tpu_torch.graph.containers import ell_from_csr
    from han_tpu_torch.ops.attention import attention_aggregate
    from han_tpu_torch.ops.calibrate import card_info
    from han_tpu_torch.utils.prof import edges_per_sec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    info = card_info()
    dev_card = {"name": info["name"], "power_limit": info["power_limit"]}
    ds, csr_graphs, total_edges = build_workload(args.n, args.metapaths, args.avg_degree,
                                                 args.reorder)
    k, d = args.heads, args.dim
    rng = np.random.default_rng(0)
    fdt = getattr(torch, args.dtype)
    fts = torch.from_numpy(rng.standard_normal((args.n, k, d)).astype(np.float32)).to(dev, fdt)
    ld = torch.from_numpy(rng.standard_normal((args.n, k)).astype(np.float32)).to(dev)
    ls = torch.from_numpy(rng.standard_normal((args.n, k)).astype(np.float32)).to(dev)
    leaves = [t.requires_grad_() for t in (fts, ld, ls)]

    built = {}

    def graphs_for(impl):
        if impl not in built:
            if impl == "flash":
                built[impl] = [metapath_to_bcsr(a, bm=args.bm or None, bn=args.bn or None)
                               for a in ds.metapath_adjs]
                occ = [round(g.occupancy(), 3) for g in built[impl]]
                print(f"# bcsr tiles bm={built[impl][0].bm} bn={built[impl][0].bn} "
                      f"occupancy={occ}", file=sys.stderr, flush=True)
            elif impl == "dense":
                built[impl] = [metapath_to_dense(a) for a in ds.metapath_adjs]
            elif impl == "ell":
                built[impl] = [ell_from_csr(g) for g in csr_graphs]
            else:
                built[impl] = csr_graphs
            built[impl] = [g.to(dev) for g in built[impl]]
        return built[impl]

    def make(impl, fwd_only):
        graphs = graphs_for(impl)

        def loss():
            return sum(attention_aggregate(g, *leaves, impl=impl).float().sum() for g in graphs)

        if fwd_only:
            def fwd():
                with torch.no_grad():
                    return loss()
            return fwd
        return lambda: torch.autograd.grad(loss(), leaves)

    phase = "fwd" if args.fwd_only else "fwd+bwd"
    print(f"# timing impl={args.impl} ({phase})", file=sys.stderr, flush=True)
    main_fn = make(args.impl, args.fwd_only)
    t_main = time_per_iter(main_fn, args.iters)
    t_main_device_ms = device_ms_per_iter(main_fn)
    t_base = None if args.no_dense else time_per_iter(make("dense", args.fwd_only), args.iters)
    if "dense" in built:
        del built["dense"]
        torch.cuda.empty_cache()
    t_fwd = t_main if args.fwd_only else time_per_iter(make(args.impl, True), args.iters)

    detail = {
        "t_main_ms": t_main * 1e3,
        "t_main_device_ms": t_main_device_ms,
        "device_share": t_main_device_ms / (t_main * 1e3) if t_main_device_ms else None,
        "t_dense_ms": t_base * 1e3 if t_base else None,
        "t_fwd_ms": t_fwd * 1e3,
        "total_edges": int(total_edges),
        "backend": "cuda",
        "dtype": args.dtype,
        "device": {**dev_card, "kind": torch.cuda.get_device_name(0)},
        "device_count": torch.cuda.device_count(),
    }
    if args.impl == "flash":
        cal = calibrate_here(info)
        bf16 = args.dtype == "bfloat16"
        detail["roofline"] = {
            **roofline([(g.n_tiles, g.bm, g.bn, g.occupancy()) for g in graphs_for("flash")],
                       total_edges=total_edges, n=args.n, k=k, d=d, t_main=t_main,
                       fwd_only=args.fwd_only,
                       t_fwd_strip=cal["fwd_strip_s_bf16_mxu" if bf16 else "fwd_strip_s_mxu"],
                       t_bwd_strip=cal["bwd_strip_s_mxu"],
                       elems_per_strip=cal["elems_per_strip"], feat_bytes=2 if bf16 else 4),
            "hbm_bytes_per_s": HBM_BW,
            "calibration": "measured in this run",
            "strip_scaling": cal["scaling"],
        }

    dt_tag = "" if args.dtype == "float32" else f", {args.dtype}"
    result = {
        "metric": f"edges*heads/s/card ({args.impl} attention aggregate {phase}, "
                  f"N={args.n}, P={args.metapaths}, K={k}, D={d}{dt_tag})",
        "value": edges_per_sec(total_edges, k, t_main),
        "unit": "edges*heads/s/card",
        "vs_baseline": t_base / t_main if t_base else None,
        "detail": detail,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
