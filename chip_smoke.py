"""Smoke test of han_tpu_torch on one CUDA card: builds the flash-GAT
kernels, holds each against its plain PyTorch version at the DBLP shape,
checks a small HAN against the dense path, then trains the dblp preset for
10 epochs on the DBLP-shaped dataset and shows, by the launch counters,
that every step went through the kernels.

    python3 chip_smoke.py

Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. The last line is ``{"ok": true, "device": {...}}``; the line before
it holds the per-kernel measurements as one JSON object.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import numpy as np

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

    # -- phase 2: build ------------------------------------------------------
    cached = _build.library_path("flash_gat").exists()
    t0 = time.perf_counter()
    so = _build.build("flash_gat")
    _build.load("flash_gat")
    print(f"build: {so.relative_to(pathlib.Path(__file__).resolve().parent)} "
          f"{'(already built) ' if cached else ''}in {time.perf_counter() - t0:.2f} s",
          flush=True)

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

    def timed(fn, reps=20):
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
        err = (got - want).abs()
        bad = err > atol + rtol * want.abs()
        max_err = float(err.max())
        print(f"  {name}: max_abs_err {max_err:.3e} (atol {atol}, rtol {rtol})", flush=True)
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            fail(f"{name}: {int(bad.sum())} elements outside tolerance, max err {max_err}")
        return max_err

    stats = {"fwd": {"err": 0.0}, "bwd": {"err": 0.0}}
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
        stats["fwd"] = {"err": max(stats["fwd"]["err"], e), "ms": t["fwd_ms"],
                        "plain_ms": t["fwd_plain_ms"]}
        stats["bwd"] = {"err": max(stats["bwd"]["err"], eb), "ms": t["bwd_ms"],
                        "plain_ms": t["bwd_plain_ms"]}
    del out_p, lse_p, bp
    torch.cuda.empty_cache()

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

    src = "han_tpu_torch/csrc/flash_gat.cu"
    kernels = [
        {"name": "flash_gat_fwd", "route": "cuda", "source": src,
         "replaces": "han_tpu/ops/pallas/flash_gat.py:187", "launches": fwd_n,
         "max_abs_err": stats["fwd"]["err"], "ms": stats["fwd"]["ms"],
         "plain_ms": stats["fwd"]["plain_ms"]},
        {"name": "flash_gat_bwd", "route": "cuda", "source": src,
         "replaces": "han_tpu/ops/pallas/flash_gat.py:395", "launches": bwd_n,
         "max_abs_err": stats["bwd"]["err"], "ms": stats["bwd"]["ms"],
         "plain_ms": stats["bwd"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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


if __name__ == "__main__":
    main()
