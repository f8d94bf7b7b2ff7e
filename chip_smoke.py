"""Smoke test of han_tpu_torch on CUDA cards. Builds the kernels (the
flash-GAT kernels and the fused ELL forward, one nvcc per source, started
together, and the C++ sampler), then drives the ported paths:

- full-graph: holds the flash kernels (forward, fused backward, and the
  split backward's row and column sweeps) against their plain PyTorch
  versions at the DBLP shape, and on the strips of a 4-way partition of
  DBLP's largest meta-path (every shard of partition_bcsr, and ring cells
  with a non-zero column offset); checks a small HAN against the dense
  path; trains the dblp preset for 10 epochs on the DBLP-shaped dataset;
- multi-device: in a world of torch.cuda.device_count() NCCL ranks (one
  process per card, spawned), trains the dblp preset 10 epochs with
  graph_format partitioned_bcsr, then ring_bcsr under
  torch.use_deterministic_algorithms(True) (the split backward), and holds
  both loss trajectories against the one-device run;
- sampled: holds the ell_fused kernel against its plain version at the
  sampled block's shape (and at a large odd fanout), trains the 100M-edge
  sampled configuration (500,000 nodes, 2 meta-paths of degree 100, acm
  preset widths, batch 512, fanout 16, the host sampler, impl ell_fused)
  for 2 epochs through run(), and runs 10 steps of the device sampler.

The launch counters, set to 0 before each path and read after it, show
that every step went through the kernels.

    python3 chip_smoke.py

Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. The last line is ``{"ok": true, "device": {...}}``; the line before
it holds the per-kernel measurements as one JSON object.
"""

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, reps=20):
    """Median CUDA-event time of fn() in ms, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(name, got, want, atol, rtol):
    import torch

    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    print(f"  {name}: max_abs_err {max_err:.3e} (atol {atol}, rtol {rtol})", flush=True)
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: {int(bad.sum())} elements outside tolerance, max err {max_err}")
    return max_err


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import numpy as np

    from han_tpu_torch import native
    from han_tpu_torch.datasets.registry import dblp_synthetic
    from han_tpu_torch.graph.build import metapath_to_bcsr
    from han_tpu_torch.ops import _build
    from han_tpu_torch.ops import flash_gat as fg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- phase 2: build (nvcc per kernel source and g++ for the sampler, all
    # at once) ----------------------------------------------------------------
    names = ("flash_gat", "ell_fused")
    cached = [n for n in names if _build.library_path(n).exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        sampler_built = pool.submit(native.available)
        libs = _build.build_all(names)
        if not sampler_built.result():
            fail("the C++ sampler (han_tpu_torch/native/graphcore.cpp) did not build")
    for name in names:
        _build.load(name)
    root = pathlib.Path(__file__).resolve().parent
    print(f"build: {', '.join(str(so.relative_to(root)) for so in libs)} and "
          f"{native.library_path().relative_to(root)} "
          f"{f'(already built: {cached}) ' if cached else ''}"
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- phase 3: kernels vs plain at the DBLP shape -------------------------
    t0 = time.perf_counter()
    ds = dblp_synthetic(seed=0)
    print(f"dataset: {ds.n_nodes} nodes, edges with self-loops per meta-path "
          f"{[int(a.nnz + ds.n_nodes - a.diagonal().astype(bool).sum()) for a in ds.metapath_adjs]}, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    big = max(range(len(ds.metapath_adjs)), key=lambda p: ds.metapath_adjs[p].nnz)
    graph = metapath_to_bcsr(ds.metapath_adjs[big]).to(dev)
    print(f"largest meta-path {ds.metapath_names[big]}: {graph.n_edges} edges, "
          f"tiles {graph.bm}x{graph.bn}, {graph.n_tiles} occupied of "
          f"{graph.nb_r * graph.nb_c}, n_pad {graph.n_pad}", flush=True)
    k, d, n = 8, 8, graph.n_pad
    gen = torch.Generator(dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    pad_rows = torch.arange(n, device=dev) >= ds.n_nodes
    ld, ls = rnd(k, n), rnd(k, n)
    ld[:, pad_rows] = 0.0
    ls[:, pad_rows] = 0.0
    v = rnd(n, k * d)
    v[pad_rows] = 0.0
    g = rnd(n, k * d)
    g[pad_rows] = 0.0

    stats = {name: {"err": 0.0} for name in ("fwd", "bwd", "row", "col")}
    for p in (0.0, 0.6):
        meta = fg.FlashMeta(slope=0.2, dropout_p=p, seed=1234567)
        print(f"dropout {p}:", flush=True)
        out_k, lse_k = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
        out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
        torch.cuda.synchronize()
        e = max(check("out", out_k, out_p, 1e-5, 1e-4),
                check("lse", lse_k, lse_p, 1e-5, 1e-4))
        delta = (g * out_k).view(n, k, d).sum(-1).T.contiguous()
        bk = fg.flash_bwd_cuda(graph, ld, ls, v, g, lse_k, delta, meta)
        bp = fg.flash_bwd_plain(graph, ld, ls, v, g, lse_k, delta, meta)
        torch.cuda.synchronize()
        # wider: dld is summed with atomicAdd in a varying order
        eb = max(check(name, a, b, 1e-4, 1e-3)
                 for name, a, b in zip(("dld", "dls", "dv"), bk, bp))
        t = {"fwd_ms": timed(lambda: fg.flash_fwd_cuda(graph, ld, ls, v, meta)),
             "fwd_plain_ms": timed(lambda: fg.flash_fwd_plain(graph, ld, ls, v, meta)),
             "bwd_ms": timed(lambda: fg.flash_bwd_cuda(graph, ld, ls, v, g, lse_k, delta, meta)),
             "bwd_plain_ms": timed(lambda: fg.flash_bwd_plain(graph, ld, ls, v, g, lse_k, delta, meta))}
        print("  median ms: " + ", ".join(f"{a} {b:.4f}" for a, b in t.items()), flush=True)
        # the split backward: each sweep against its plain version
        args = (graph, ld, ls, v, g, lse_k, delta, meta)
        er = check("dld (row sweep)", fg.flash_bwd_row_cuda(*args), fg.flash_bwd_row_plain(*args),
                   1e-4, 1e-3)
        ec = max(check(f"{name} (column sweep)", a, b, 1e-4, 1e-3) for name, a, b in zip(
            ("dls", "dv"), fg.flash_bwd_col_cuda(*args), fg.flash_bwd_col_plain(*args)))
        ts = {"row_ms": timed(lambda: fg.flash_bwd_row_cuda(*args)),
              "row_plain_ms": timed(lambda: fg.flash_bwd_row_plain(*args)),
              "col_ms": timed(lambda: fg.flash_bwd_col_cuda(*args)),
              "col_plain_ms": timed(lambda: fg.flash_bwd_col_plain(*args)),
              "split_ms": timed(lambda: (fg.flash_bwd_row_cuda(*args),
                                         fg.flash_bwd_col_cuda(*args))),
              "fused_ms": timed(lambda: fg.flash_bwd_cuda(*args))}
        print("  split backward median ms: " + ", ".join(f"{a} {b:.4f}" for a, b in ts.items())
              + f"; split / fused {ts['split_ms'] / ts['fused_ms']:.3f}", flush=True)
        stats["fwd"] = {"err": max(stats["fwd"]["err"], e), "ms": t["fwd_ms"],
                        "plain_ms": t["fwd_plain_ms"]}
        stats["bwd"] = {"err": max(stats["bwd"]["err"], eb), "ms": t["bwd_ms"],
                        "plain_ms": t["bwd_plain_ms"]}
        stats["row"] = {"err": max(stats["row"]["err"], er), "ms": ts["row_ms"],
                        "plain_ms": ts["row_plain_ms"]}
        stats["col"] = {"err": max(stats["col"]["err"], ec), "ms": ts["col_ms"],
                        "plain_ms": ts["col_plain_ms"]}
    del out_p, lse_p, bp
    torch.cuda.empty_cache()

    # -- phase 3c: the kernels on the strips of a 4-way partition ------------
    for name, err in check_strips(dev, ds.metapath_adjs[big]).items():
        stats[name]["err"] = max(stats[name]["err"], err)

    # -- phase 3b: a small HAN through the kernels vs the dense path ---------
    check_small_han(dev)

    # -- phase 4: the dblp preset's training, through the kernels ------------
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import run

    cfg = preset("dblp")
    cfg.train.epochs = 10
    torch.cuda.reset_peak_memory_stats(dev)
    fg.flash_fwd_launches = 0
    fg.flash_bwd_launches = 0
    result = run(cfg, ds, device=dev)
    torch.cuda.synchronize()
    fwd_n, bwd_n = fg.flash_fwd_launches, fg.flash_bwd_launches
    losses = result["epoch_train_loss"]
    if len(losses) != cfg.train.epochs or not all(np.isfinite(losses)):
        fail(f"train losses not finite or short: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train loss did not fall: {losses[0]} -> {losses[-1]}")
    if not np.isfinite(result["test_loss"]):
        fail(f"test loss {result['test_loss']}")
    n_mp = len(ds.metapath_adjs)
    # per epoch: a train step (forward + backward) and a val eval; then a
    # test eval
    want_fwd = n_mp * (2 * cfg.train.epochs + 1)
    if fwd_n != want_fwd or bwd_n != n_mp * cfg.train.epochs:
        fail(f"launch counts fwd {fwd_n} (want {want_fwd}), bwd {bwd_n} "
             f"(want {n_mp * cfg.train.epochs})")
    print(f"train: losses {losses[0]:.5f} -> {losses[-1]:.5f}, test_acc "
          f"{result['test_acc']:.4f}; launches fwd {fwd_n} bwd {bwd_n} = "
          f"{n_mp} fwd + {n_mp} bwd per train step", flush=True)
    print(f"train: median step time epochs 2-10 "
          f"{statistics.median(result['epoch_step_time_s'][1:]) * 1e3:.3f} ms, "
          f"max_memory_allocated {result['max_memory_allocated']} B", flush=True)

    del ds, graph
    torch.cuda.empty_cache()

    # -- phase 4b: multi-device training through the partitioned backends ----
    mesh = train_multi_device(losses, cfg.train.epochs, n_mp)

    # -- phases 5-7: the sampled path ------------------------------------------
    ell = check_ell_fused(dev)
    ell_n = train_sampled(dev, native)

    # launches: the dblp run (phase 4) and the multi-device runs (phase 4b)
    part, ring = mesh["partitioned_bcsr"]["launches"], mesh["ring_bcsr"]["launches"]
    launches = {"fwd": fwd_n + part["fwd"] + ring["fwd"], "bwd": bwd_n + part["bwd"],
                "row": ring["row"], "col": ring["col"]}
    src = "han_tpu_torch/csrc/flash_gat.cu"
    tpu = "han_tpu/ops/pallas/flash_gat.py"
    kernels = [
        {"name": f"flash_gat_{name}", "route": "cuda", "source": src,
         "replaces": f"{tpu}:{line}", "launches": launches[key],
         "max_abs_err": stats[key]["err"], "ms": stats[key]["ms"],
         "plain_ms": stats[key]["plain_ms"]}
        for name, key, line in (("fwd", "fwd", "97,187"), ("bwd", "bwd", 395),
                                ("bwd_row", "row", 354), ("bwd_col", "col", 395))] + [
        {"name": "ell_fused_fwd", "route": "cuda", "source": "han_tpu_torch/csrc/ell_fused.cu",
         "replaces": "han_tpu/ops/pallas/ell_fused.py:54", "launches": ell_n,
         "max_abs_err": ell["err"], "ms": ell["ms"], "plain_ms": ell["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def check_strips(dev, adj) -> dict:
    """Phase 3c: the flash kernels on rectangles, at dropout 0 and 0.6.
    DBLP's largest meta-path (with self-loops) cut four ways with 128x128
    tiles: every shard of partition_bcsr (1,024 local rows x 4,096 global
    columns, a non-zero row-block offset) and the ring cells (s, 1 + s mod
    3) of ring_partition_bcsr (t >= 1, so the column-block offset is not
    0). On each: forward vs plain (out and lse, atol 1e-5, rtol 1e-4); row
    and column sweeps vs plain, and the split vs the fused backward (atol
    1e-4, rtol 1e-3); the split run twice, bitwise equal (torch.equal).
    Returns the largest errors per kernel."""
    import torch

    from han_tpu_torch.graph.build import with_self_loops
    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.parallel.flash_shard import partition_bcsr
    from han_tpu_torch.parallel.ring_bcsr import ring_partition_bcsr

    a = with_self_loops(adj)
    pg = partition_bcsr(a, 4, bm=128, bn=128).to(dev)
    rg = ring_partition_bcsr(a, 4, bm=128, bn=128).to(dev)
    strips = [(f"shard {s}", pg.strip(s), dict(row_block_offset=pg.row_block_off[s]))
              for s in range(4)]
    strips += [(f"ring cell ({s},{t})", rg.cell(s, t),
                dict(row_block_offset=s * rg.nb_r_loc,
                     col_block_offset=rg.cs_of_step[s][t] * rg.nb_c_loc))
               for s in range(4) for t in (1 + s % 3,)]
    gen = torch.Generator(dev).manual_seed(2)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    k, d = 8, 8
    errs = {"fwd": 0.0, "row": 0.0, "col": 0.0, "bwd": 0.0}
    for label, graph, off in strips:
        n_rows, n_cols = graph.nb_r * graph.bm, graph.nb_c * graph.bn
        ld, ls, v, g = rnd(k, n_rows), rnd(k, n_cols), rnd(n_cols, k * d), rnd(n_rows, k * d)
        print(f"{label}: {n_rows} x {n_cols}, {int(graph.fwd_count.sum())} tiles, "
              f"offsets {off}", flush=True)
        for p in (0.0, 0.6):
            meta = fg.FlashMeta(dropout_p=p, seed=7654321, **off)
            out, lse = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
            out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
            errs["fwd"] = max(errs["fwd"], check(f"p={p} out", out, out_p, 1e-5, 1e-4),
                              check(f"p={p} lse", lse, lse_p, 1e-5, 1e-4))
            delta = (g * out).view(n_rows, k, d).sum(-1).T.contiguous()
            args = (graph, ld, ls, v, g, lse, delta, meta)
            split = (fg.flash_bwd_row_cuda(*args), *fg.flash_bwd_col_cuda(*args))
            plain = (fg.flash_bwd_row_plain(*args), *fg.flash_bwd_col_plain(*args))
            fused = fg.flash_bwd_cuda(*args)
            again = (fg.flash_bwd_row_cuda(*args), *fg.flash_bwd_col_cuda(*args))
            torch.cuda.synchronize()
            for i, name in enumerate(("dld", "dls", "dv")):
                key = "row" if i == 0 else "col"
                errs[key] = max(errs[key], check(f"p={p} {name}", split[i], plain[i], 1e-4, 1e-3))
                errs["bwd"] = max(errs["bwd"], check(f"p={p} {name} split vs fused", split[i],
                                                     fused[i], 1e-4, 1e-3))
                if not torch.equal(split[i], again[i]):
                    fail(f"{label}: the split backward's {name} differs between two runs")
        print(f"  {label}: split backward bitwise equal over two runs", flush=True)
    return errs


def mesh_train_rank(epochs: int) -> dict:
    """One rank of phase 4b: the dblp preset through run() with
    graph_format partitioned_bcsr, then ring_bcsr under deterministic mode;
    each run's losses, step time, memory and launch counts."""
    import torch
    import torch.distributed as dist

    from han_tpu_torch.datasets.registry import dblp_synthetic
    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import run

    counters = {"fwd": "flash_fwd_launches", "bwd": "flash_bwd_launches",
                "row": "flash_bwd_row_launches", "col": "flash_bwd_col_launches"}
    ds = dblp_synthetic(seed=0)
    out = {}
    for fmt, deterministic in (("partitioned_bcsr", False), ("ring_bcsr", True)):
        cfg = preset("dblp")
        cfg.train.epochs = epochs
        cfg.data.graph_format = fmt
        cfg.mesh.graph_axis = dist.get_world_size()
        torch.cuda.reset_peak_memory_stats()
        for attr in counters.values():
            setattr(fg, attr, 0)
        torch.use_deterministic_algorithms(deterministic)
        try:
            result = run(cfg, ds)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        out[fmt] = {"losses": result["epoch_train_loss"], "test_loss": result["test_loss"],
                    "median_step_ms": statistics.median(result["epoch_step_time_s"][1:]) * 1e3,
                    "max_memory_allocated": result["max_memory_allocated"],
                    "launches": {k: getattr(fg, v) for k, v in counters.items()}}
    return out


def train_multi_device(want_losses, epochs: int, n_mp: int) -> dict:
    """Phase 4b: mesh_train_rank in a world of one NCCL rank per card. Each
    run's losses must match the one-device run's (rtol 2e-4, atol 2e-5:
    the dropout keys are global, so the masks replay); the launch counts
    are exact: per rank and epoch, the forward on every train and eval
    pass (S steps a pass on the ring), the fused backward on the partitioned
    run, the split pair and no fused backward on the deterministic ring
    run. CUBLAS_WORKSPACE_CONFIG, which deterministic mode needs, is set in
    the ranks only, so the phases in this process keep their numbers."""
    import numpy as np
    import torch

    from han_tpu_torch.parallel.launch import spawn

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    res = spawn(mesh_train_rank, world, "nccl", args=(epochs,),
                env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})[0]
    print(f"multi-device: {world} NCCL rank(s), two runs in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    passes = n_mp * (2 * epochs + 1)
    want = {"partitioned_bcsr": {"fwd": passes, "bwd": n_mp * epochs, "row": 0, "col": 0},
            "ring_bcsr": {"fwd": world * passes, "bwd": 0, "row": world * n_mp * epochs,
                          "col": world * n_mp * epochs}}
    for fmt, run in res.items():
        got = run["losses"]
        if not np.allclose(got, want_losses, rtol=2e-4, atol=2e-5):
            fail(f"{fmt}: losses {got} do not match the one-device run {want_losses}")
        if run["launches"] != want[fmt]:
            fail(f"{fmt}: launches {run['launches']}, want {want[fmt]}")
        dev = max(abs(a - b) / abs(b) for a, b in zip(got, want_losses))
        print(f"{fmt} (graph axis {world}{', deterministic' if fmt == 'ring_bcsr' else ''}): "
              f"losses {got[0]:.5f} -> {got[-1]:.5f}, largest relative difference from the "
              f"one-device run {dev:.3e}; launches {run['launches']}; median step "
              f"{run['median_step_ms']:.3f} ms, max_memory_allocated "
              f"{run['max_memory_allocated']} B", flush=True)
    return res


def check_small_han(dev) -> None:
    """Logits and gradients of a small HAN: flash kernels vs the dense
    path, same weights, dropout off."""
    import torch

    from han_tpu_torch.graph.build import metapath_to_bcsr, metapath_to_dense
    from han_tpu_torch.graph.synthetic import planted_hetero
    from han_tpu_torch.nn.losses import masked_softmax_cross_entropy
    from han_tpu_torch.nn.models import HAN

    ds = planted_hetero(n_nodes=300, n_feats=40, n_classes=3, n_metapaths=2,
                        avg_degree=12.0, train_per_class=20, n_val=30, seed=3)
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    outs = {}
    for impl, build in (("dense", metapath_to_dense), ("flash", metapath_to_bcsr)):
        model = HAN(x.shape[1], 3, 2, impl=impl,
                    generator=torch.Generator().manual_seed(0)).to(dev)
        graphs = [build(a).to(dev) for a in ds.metapath_adjs]
        logits, embed, alphas = model(graphs, [x, x])
        loss = masked_softmax_cross_entropy(logits, labels, mask)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        outs[impl] = [logits, embed, alphas, *grads]
    err = max(float((a - b).detach().abs().max())
              for a, b in zip(outs["flash"], outs["dense"]))
    print(f"small HAN (n=300): flash vs dense max_abs_err {err:.3e} over "
          f"logits, embedding, alphas and {len(outs['flash']) - 3} gradients", flush=True)
    if not err < 1e-4:
        fail(f"small HAN flash vs dense: {err}")


def check_ell_fused(dev) -> dict:
    """Phases 5-6: the ell_fused kernel against its plain version, one keep
    mask for both, at the sampled block's shape (8,704 rows: 512 seed rows
    with up to 16 valid slots, the rest edgeless, as in a one-hop block;
    K = 8, D = 8) with dropout 0 and 0.6, and at a large odd fanout (F =
    101, as in exact eval); median CUDA-event times at the block shape. The
    plain-torch backward is held on the card against the same backward on
    the CPU (the card's index_add_ sums with atomics in a varying order)."""
    import torch

    from han_tpu_torch.ops import ell_fused as ef

    gen = torch.Generator(dev).manual_seed(1)
    k, d = 8, 8

    def block(n, f, n_seed):
        nbr = torch.full((n, f), n, dtype=torch.int32, device=dev)
        real = torch.randint(0, n, (n_seed, f), generator=gen, device=dev,
                             dtype=torch.int32)
        empty = torch.rand((n_seed, f), generator=gen, device=dev) < 0.1
        nbr[:n_seed] = torch.where(empty, n, real)
        nbr[3] = n  # a seed row with no valid slot
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
        return nbr, rnd(n, k), rnd(n, k), rnd(n, k * d)

    out = {"err": 0.0}
    for n, f, n_seed in ((8704, 16, 512), (16384, 101, 2048)):
        nbr, ld, ls, fts = block(n, f, n_seed)
        for p in (0.0, 0.6):
            keep = ef.draw_keep(n, f, k, p, gen, dev) if p else None
            print(f"ell_fused {n} x F={f}, {n_seed} rows with slots, dropout {p}:", flush=True)
            got = ef.ell_fused_fwd_cuda(nbr, ld, ls, fts, keep, 0.2, p)
            want = ef.ell_fused_fwd_plain(nbr, ld, ls, fts, keep, 0.2, p)
            torch.cuda.synchronize()
            out["err"] = max(out["err"], check("out", got, want, 1e-5, 1e-4))
            if not bool((got[n_seed:] == 0).all() and (got[3] == 0).all()):
                fail("ell_fused: an edgeless row is not exactly 0")
            if f == 16:
                ms = timed(lambda: ef.ell_fused_fwd_cuda(nbr, ld, ls, fts, keep, 0.2, p))
                plain_ms = timed(lambda: ef.ell_fused_fwd_plain(nbr, ld, ls, fts, keep, 0.2, p))
                print(f"  median ms: kernel {ms:.4f}, plain {plain_ms:.4f}", flush=True)
                out.update(ms=ms, plain_ms=plain_ms)  # the train shape (p = 0.6) last
                g = torch.randn(n, k * d, generator=gen, device=dev)
                bwd = ef.ell_fused_bwd(nbr, ld, ls, fts, keep, g, 0.2, p)
                cpu = lambda t: None if t is None else t.cpu()
                ref = ef.ell_fused_bwd(*map(cpu, (nbr, ld, ls, fts, keep, g)), 0.2, p)
                for name, a, b in zip(("d_fts", "d_ld", "d_ls"), bwd, ref):
                    check(f"backward {name} (card vs cpu)", a.cpu(), b, 1e-4, 1e-3)
    return out


def train_sampled(dev, native) -> int:
    """Phase 7: the 100M-edge sampled configuration through run() for 2
    epochs with the host sampler and impl ell_fused; then the host/device
    split of its step; then 10 steps of the device sampler. Returns the
    ell_fused launches of the 2-epoch run."""
    import numpy as np
    import torch

    from han_tpu_torch.graph.synthetic import scale_dataset
    from han_tpu_torch.ops import ell_fused as ef
    from han_tpu_torch.ops import tree_ell
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.sampled import SampledTrainer, step_breakdown
    from han_tpu_torch.train.trainer import run

    if not native.available():
        fail("the C++ sampler is not in use (han_tpu_torch.native.available() is false)")
    t0 = time.perf_counter()
    ds = scale_dataset(500_000, 100, n_train=15_360, n_val=512, n_test=2_048, seed=0)
    edges = sum(int(a.nnz) for a in ds.metapath_adjs)
    print(f"scale dataset: {ds.n_nodes} nodes, {edges} edges in "
          f"{len(ds.metapath_adjs)} meta-paths, built in {time.perf_counter() - t0:.2f} s",
          flush=True)

    def cfg_for(sampler, epochs):
        cfg = preset("acm")  # hid 8, heads (8, 1), semantic 128, dropouts 0.6
        cfg.model.impl = "ell_fused"
        cfg.train.sampled, cfg.train.sampler, cfg.train.epochs = True, sampler, epochs
        cfg.train.batch_size, cfg.train.fanout = 512, 16
        return cfg

    n_mp = len(ds.metapath_adjs)
    cfg = cfg_for("host", 2)
    torch.cuda.reset_peak_memory_stats(dev)
    ef.ell_fused_launches = 0
    result = run(cfg, ds, device=dev)
    torch.cuda.synchronize()
    launches = ef.ell_fused_launches
    losses = result["epoch_train_loss"]
    if len(losses) != 2 or not all(np.isfinite(losses)) or not np.isfinite(result["test_loss"]):
        fail(f"sampled train losses not finite or short: {losses}, test {result['test_loss']}")
    if not losses[-1] < losses[0]:
        fail(f"sampled train loss did not fall: {losses[0]} -> {losses[-1]}")
    steps = 2 * (15_360 // 512)
    eval_batches = 2 * 1 + 2_048 // 512  # a val batch each epoch, the test batches
    if launches != n_mp * (steps + eval_batches):
        fail(f"ell_fused launches {launches}, want {n_mp} per train step and per "
             f"eval batch = {n_mp * (steps + eval_batches)}")
    step_ms = result["median_step_time_s"] * 1e3
    print(f"sampled train: losses {losses[0]:.5f} -> {losses[-1]:.5f}, test_acc "
          f"{result['test_acc']:.4f}; ell_fused launches {launches} = {n_mp} per "
          f"train step ({steps}) and eval batch ({eval_batches})", flush=True)
    print(f"sampled train: median step {step_ms:.3f} ms, host block (prefetch thread) "
          f"{result['median_host_block_ms']:.3f} ms, sampled edges·heads/s "
          f"{result['edges_heads_per_s']:.1f}, max_memory_allocated "
          f"{result.get('max_memory_allocated')} B", flush=True)

    split = step_breakdown(SampledTrainer(ds, cfg_for("host", 1), device=dev),
                           np.where(ds.train_mask)[0])
    dev_ms = split["device_ms"]
    print(f"sampled step split: host block {split['host_block_ms']:.3f} ms, device "
          + (f"{dev_ms:.3f} ms (share {dev_ms / step_ms:.3f} of the median step)"
             if dev_ms else "not measured (the profiler recorded no device events)"),
          flush=True)

    # device sampler: 10 train steps, one val and four test batches
    ds10 = dataclasses.replace(ds, train_mask=np.arange(ds.n_nodes) < 10 * 512)
    tree_ell.tree_ell_calls = 0
    ef.ell_fused_launches = 0
    res = run(cfg_for("device", 1), ds10, device=dev)
    torch.cuda.synchronize()
    want_calls = n_mp * (10 + 1 + 2_048 // 512)
    if not np.isfinite(res["epoch_train_loss"]).all() or not np.isfinite(res["test_loss"]):
        fail(f"device-sampler losses not finite: {res['epoch_train_loss']}")
    if tree_ell.tree_ell_calls != want_calls or ef.ell_fused_launches:
        fail(f"device sampler: {tree_ell.tree_ell_calls} tree attention calls (want "
             f"{want_calls}), {ef.ell_fused_launches} ell_fused launches (want 0)")
    print(f"device sampler: train loss {res['epoch_train_loss'][0]:.5f}, test_acc "
          f"{res['test_acc']:.4f}, median step {res['median_step_time_s'] * 1e3:.3f} ms, "
          f"sampled edges·heads/s {res['edges_heads_per_s']:.1f}; every block through "
          f"tree attention ({tree_ell.tree_ell_calls} calls)", flush=True)
    return launches


if __name__ == "__main__":
    main()
