"""Smoke test of han_tpu_torch on CUDA cards. Builds the kernels (the
flash-GAT kernels and the fused ELL forward, one nvcc per source, started
together, and the C++ sampler; fails where ptxas reports that it
serialized a kernel's wgmma products), then drives the ported paths:

- full-graph: holds the flash kernels (forward, fused backward, and the
  split backward's row and column sweeps) against their plain PyTorch
  versions at the DBLP shape (times at dropout 0 and 0.6; a control shows
  that their products, the row sweep's included, are more accurate than one
  TF32 product; the split backward twice, bitwise), at D = 32 there
  (times), at D = 64, 128 and 256 there (and 64 with bf16 v: the forward
  and the fused backward through their wide bodies, the split backward in
  chunks of 32 columns on the kernels' grid; times beside their bounds
  and, for the forward, SDPA's), the wide bodies at PPI's union (K = 4,
  D = 256; K = 6, D = 121) and DBLP's three meta-paths in one launch
  (K = 8, D = 64, dropout 0.6) beside the chunked route's times (phase
  3x), at D = 3, 4, 16, 32, 33, 40, 64 and 121 on a small
  graph with a single-edge tile and rows without edges (D = 3 zero-padded
  to 4 by the wrappers), and on the strips of a 4-way partition of DBLP's
  largest meta-path (every shard of partition_bcsr, and ring cells with a
  non-zero column offset; v f32 and bf16; D = 8 and 64); holds the batched
  kernels (D = 8 and 64; one launch for
  DBLP's three meta-paths stacked, graph/stack.py) to their plain versions
  and, path by path, to single-path launches with the path's seed
  (forward and sweeps bitwise), with one batched launch timed against
  three single ones; holds the per-rank body of the heads axis (heads 4-7
  of 8 at head_offset 4, on the strips and ring cells of a 2-way
  partition, dropout 0.6, v f32 and bf16) to heads 4-7 of the 8-head
  launch (forward bitwise; D = 8 and 64); checks a small HAN against the
  dense path; trains the dblp preset for 10 epochs on the DBLP-shaped
  dataset with its train and eval steps captured as CUDA graphs
  (train/graphed.py: epoch 0 eager, then replays), and again at
  hid_units=(64,) (phase 4l: heads in chunks; captured against eager at
  dropout 0, its step profiled), checks that the flash kernels' seed buffers hold a
  new seed at every replay, profiles the step captured and eager, and
  holds 10 captured epochs at dropout 0 to 10 eager ones (CAPTURE_TOL);
  runs the dblp preset (dropout 0.6, captured) 10 epochs with a checkpoint
  every epoch, then again preempted after epoch 4 (the guard tripped from
  the logger) and resumed in a fresh Trainer, which must draw the
  uninterrupted run's flash seeds from the same generator states (equal)
  and agree on the losses (CAPTURE_TOL), the best epoch and the test
  metrics; holds HAN(vmap_towers=True) to the sequential HAN fed the same
  weights at dropout 0 (logits and first-step gradients, rtol 1e-5) and
  trains the dblp preset with vmap_towers 10 epochs, captured, one
  forward and one fused backward launch a train step for the three
  meta-paths, its step profiled beside the sequential one's; scores the
  resumed run's test embedding with KMeans and the
  silhouette; trains the dblp preset 3 epochs with arch="han_shared"
  through flash and holds HANShared through flash against csr (dropout 0),
  and its csr coefficients (rows summing to 1) against
  edge_attention_coefs; calls han_tpu_torch.entry.entry() (logits
  (3025, 3)); trains the dblp preset with model.impl=auto (phase 4k: the
  flash kernels launched as the preset's, DBLP's graphs sweeping fewer
  tile elements an edge than ops/attention.flash_csr_threshold) and again
  without the graphs' edge views (the views' peak memory); then the acm
  preset for 2 epochs on the dataset run() loads by the name "acm"
  (acm_synthetic where ACM3025.mat is absent);
- GAT family: writes a Pubmed-shaped Planetoid fixture
  (datasets/planetoid.write_planetoid: 19,717 nodes, 500
  features, 44,324 edges; about 23,000 occupied 128x128 tiles) to a
  temporary directory and loads it by the name "pubmed"; holds the
  preset's GAT through flash against csr, and the flash kernels against
  their plain versions at its two layer shapes (K = D = 8; K = 1, D = 3)
  at dropout 0 and 0.6, times both kernels there, trains the pubmed preset 10 epochs
  through flash, through csr and with model.impl=auto (phase 4k: csr on
  the BCSR graph's edge view, no flash launch; at dropout 0 its losses
  against csr's), captured, and profiles the flash and csr steps captured
  and eager; then trains the ppi preset (the inductive trainer, captured;
  each batch one block-diagonal graph on the flash kernels) 3 epochs at
  full width on 24 synthetic graphs of PPI's size, held to an eager run
  and to the dense path (CAPTURE_TOL, phase 4e''), and one epoch of its
  data-parallel batches on a one-rank NCCL world (captured) against the
  one-device trainer (phase 4e', DP_TOL);
- multi-device: in a world of torch.cuda.device_count() NCCL ranks (one
  process per card, spawned), trains the dblp preset 10 epochs with
  graph_format partitioned_bcsr, then ring_bcsr under
  torch.use_deterministic_algorithms(True) (the split backward), csr
  (PartitionedCSR, shard_attn.py) and ring (PartitionedCSR2D,
  ring_attn.py) at dropout 0, partitioned_bcsr with vmap_towers (the
  stacked PartitionedBCSR, batched split backward), and partitioned_bcsr
  and ring_bcsr at hid_units=(64,), and holds each loss
  trajectory against its one-device run (on one card every mesh axis has
  one rank and no process group, so every run is captured, each median
  step printed beside its eager one before capture; the heads and mp grids are
  held on gloo worlds by the CPU tests); then, on one card under
  deterministic mode at dropout 0, the captured split-backward step twice
  (is it bitwise repeatable?) and eagerly, and the dblp resume above
  under deterministic mode (losses within rtol 1e-6,
  DETERMINISTIC_RESUME_TOL);
- sampled: holds the ell_fused kernel against its plain version at the
  sampled block's shape (and at a large odd fanout, at D = 3 and at K·D =
  256), trains the 100M-edge
  sampled configuration (500,000 nodes, 2 meta-paths of degree 100, acm
  preset widths, batch 512, fanout 16, the host sampler, impl ell_fused)
  for 2 epochs through run(), captured (one graph launch a step), holds
  its captured steps at dropout 0 to eager ones over 16 batches
  (SAMPLED_CHUNK_TOL, with both peaks of memory), runs 10 steps of the
  device sampler (captured), and holds the device sampler with
  steps_per_call 4 (one graph of 4 steps) against 1 at dropout 0 over 2
  epochs of 16 steps (SAMPLED_CHUNK_TOL), with both median steps; then
  preempts the configuration mid-epoch (2 epochs of 8 steps, dropouts
  0.6; the device sampler at steps_per_call 4, and the host sampler) and
  resumes it in a fresh trainer, every run captured, its per-step losses
  held to the uninterrupted run's (SAMPLED_CHUNK_TOL); holds ell_fused on
  bf16 features to its plain version at the same shapes (phase 3g,
  ELL_BF16_TOL); and runs DPSampledTrainer on a one-rank NCCL world at
  the configuration's widths (100,000 nodes, 10 steps, dropout 0) against
  SampledTrainer (DP_TOL), both captured, a bf16 run of it through
  ell_fused (captured) and its device-sampler refusal (phase 7d).

- bf16 features: the flash kernels with bf16 v against their plain
  versions at the DBLP shape (dropout 0 and 0.6; the forward timed at
  both), and 3 epochs of the dblp
  preset with model.dtype=bfloat16, captured, and its step profiled
  captured and eager;
- calibration: builds csrc/calibrate.cu with the other sources, holds each
  of its four kernels against its plain version (all 14 primitive (op,
  dtype) pairs and the three strip bodies, R = 64; the strips' error must
  be 10x below their plain versions' with one TF32 product), then runs
  scripts/cal_vpu_torch.py at its full R (every rate at most 105 % of its
  ceiling, every R -> 2R time ratio in [1.9, 2.1]), prints the JSON, each
  primitive's rate beside its ceiling and its bound, and each strip's
  time a tile-head beside the flash kernel it tracks (fwd_kernel with f32
  and with bf16 v, the fused bwd_col_kernel) at DBLP's largest meta-path,
  dropout 0, from this run;
- benchmark: the flash kernels against their plain versions at the
  benchmark's shapes (N = n_pad = 8192, both meta-paths, v f32 and bf16,
  dropout 0), then bench_torch.py's f32 and bf16 arms and its f32 arm at
  --dim 64 (its roofline calibrated in the same process), each printing
  its JSON line.

The launch counters, set to 0 before each path and read after it, show
that every step went through the kernels; a replayed graph adds the
launches its capture recorded. Every step time is printed beside the
card's name and power limit. Kernel times are device times:
launches queued back to back behind a spin kernel that is checked to
outlast the queueing (``timed``); the plain versions wait on the card
inside, so their times include the host's. Each kernel's ``bound_ms`` is
the larger of the bytes it must move (inputs read once, outputs written
once; of ell_fused's inputs only the rows its valid slots reach) over
3.35e12 B/s and its operations over the published peaks, each unit's
time apart and the slowest taken: 67e12 f32 FLOP/s outside the tensor
cores, 2 x that for bf16 elementwise work (packed bf16x2 on the same
lanes), 495e12 / 3 FLOP/s for the D-wide products the kernels take as
3xTF32 on the tensor cores (three TF32 products each), and 132 SMs x 16
SFU results a clock x 1.98 GHz = 4.18e12 exp/s; the work is counted on
the edges (or valid ELL slots) of this run's inputs, per edge and head:
forward and row sweep 2D product FLOPs, 9 more and one exp, fused
backward 4D and 10, column sweep 4D and 9 (lower bounds: dropout hashing
and the adjacency tests are not counted); the strip bodies likewise on
their edges, and the strips' log line adds the time their swept
elements (one ex2 each) take at 4.18e12/s. The primitive passes
count instructions, not FLOPs: one a lane-op, at the rates of
ops/calibrate.py:ceilings (128 FP32 lanes a clock per SM, twice that for
packed bf16, the SFU rate for exp).

    python3 chip_smoke.py
    python3 chip_smoke.py --only flash_gat   # the flash kernels at the DBLP shape
    python3 chip_smoke.py --only ell_fused   # the ell_fused kernel at the block shape
    python3 chip_smoke.py --only calibrate   # the calibration kernels, and the strips
                                             # against the flash kernels they track
    python3 chip_smoke.py --only inductive   # the ppi preset's inductive trainer

Exits non-zero, printing no result, when CUDA is unavailable or any phase
fails. The last line is ``{"ok": true, "device": {...}}``; the line before
it holds the per-kernel measurements as one JSON object (the flash rows
also carry ``ms_by_dropout``, their times at dropout 0 and 0.6; the
``_d64`` rows, the kernels at D = 64, also their times at D = 128 and
256).
"""

import argparse
import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


SPIN_CYCLES = 6_000_000  # about 3 ms of the card's clock


def timed(fn, reps=20, host_waits=False):
    """Device ms per call of fn(), after 3 warm-up calls: CUDA events
    around reps calls queued back to back behind a spin kernel
    (torch.cuda._sleep), the median of 3 such runs. The host's time between
    launches does not count as long as the spin outlasts the queueing: the
    event recorded after the spin must not have completed when the last
    call has been queued. Where it has, the run is repeated with a spin
    twice as long, up to 8 x SPIN_CYCLES, and then the check fails. (One
    call between two events on an idle card would count the wrapper's host
    time before the launch.) ``host_waits``: fn waits on the card inside
    (the plain versions: boolean-mask indexing synchronizes), so no spin
    covers its calls; it is timed without one, its host time included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, spin = [], SPIN_CYCLES
    while len(times) < 3:
        if not host_waits:
            torch.cuda._sleep(spin)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        drained = not host_waits and a.query()  # the spin ended before the last call
        b.record()
        b.synchronize()
        if not drained:
            times.append(a.elapsed_time(b) / reps)
        elif spin >= 8 * SPIN_CYCLES:
            fail(f"timed: a spin of {spin} cycles ended before {reps} calls were queued")
        else:
            spin *= 2
            print(f"  timed: the spin ended before {reps} calls were queued; again with "
                  f"{spin} cycles", flush=True)
    return statistics.median(times)


class OneRankNCCL:
    """A process group of this process alone, NCCL on ``dev`` (phases 7d and
    4e': the data-parallel trainers at S = 1; one card holds one NCCL
    rank, so their collectives over more ranks run on gloo worlds in the
    CPU tests)."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        import torch.distributed as dist

        from han_tpu_torch.parallel.launch import _free_port

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


def check(name, got, want, atol, rtol):
    import torch

    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    print(f"  {name}: max_abs_err {max_err:.3e} (atol {atol}, rtol {rtol})", flush=True)
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: {int(bad.sum())} elements outside tolerance, max err {max_err}")
    return max_err


HBM_BW = 3.35e12                # B/s, H100 SXM (published)
F32_PEAK = 67e12                # f32 FLOP/s outside the tensor cores (published)
BF16_EW_PEAK = 2 * F32_PEAK     # bf16 elementwise: packed bf16x2 on the same lanes
EXP_PEAK = 132 * 16 * 1.98e9    # 16 SFU results a clock per SM at the 1.98 GHz boost
TF32X3_PEAK = 495e12 / 3        # 3xTF32 products: three dense TF32 products (published)


def bound(bytes_, flops=0.0, exps=0.0, bf16_flops=0.0, mma_flops=0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM_BW and the
    operations over their peaks (the slowest unit); mma_flops are the
    products taken as 3xTF32 on the tensor cores."""
    t_bytes = bytes_ / HBM_BW
    t_ops = max(flops / F32_PEAK, bf16_flops / BF16_EW_PEAK, exps / EXP_PEAK,
                mma_flops / TF32X3_PEAK)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_bounds(graph, k, d, v_bytes=4) -> dict:
    """The flash kernels' bounds on this graph: its occupied tiles and maps,
    the (K, N) f32 vectors and the features each kernel reads and writes
    once, and the work of its edges (module docstring)."""
    e = graph.n_edges * k
    n_rows, n_cols = graph.nb_r * graph.bm, graph.nb_c * graph.bn
    tiles = graph.n_tiles * graph.bm * graph.bn
    fmap = 4 * sum(t.numel() for t in (graph.fwd_count, graph.fwd_col, graph.fwd_tile))
    bmap = 4 * sum(t.numel() for t in (graph.bwd_count, graph.bwd_row, graph.bwd_tile))
    vec, v, feat = 4 * k * n_rows, n_cols * k * d * v_bytes, n_rows * k * d * 4
    dv = n_cols * k * d * 4
    return {"fwd": bound(tiles + fmap + 3 * vec + v + feat, e * 9, e, mma_flops=e * 2 * d),
            "bwd": bound(tiles + bmap + 6 * vec + v + feat + dv, e * 10, e, mma_flops=e * 4 * d),
            "row": bound(tiles + fmap + 5 * vec + v + feat, e * 9, e, mma_flops=e * 2 * d),
            "col": bound(tiles + bmap + 5 * vec + v + feat + dv, e * 9, e, mma_flops=e * 4 * d)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", choices=("flash_gat", "ell_fused", "tree_ell", "calibrate", "inductive"),
        help="build only csrc/ONLY.cu, hold its kernels to their plain versions (the flash "
             "kernels at the DBLP shape, ell_fused at the sampled block's), print their "
             "device times at dropout 0 and 0.6 as one JSON line and stop; a copy of this "
             "file run so in another checkout times that checkout's kernels the same way. "
             "tree_ell builds ell_fused.cu and holds the tree attention's forward and "
             "backward kernels at the sampled block and a two-hop block (phase 6t); "
             "calibrate builds calibrate.cu and flash_gat.cu, runs phases 8a and 8b and "
             "prints each strip's time a tile-head beside its flash kernel's; inductive "
             "builds flash_gat.cu and trains the ppi preset (phases 4e, 4e'' and 4e')")
    args = parser.parse_args(argv)
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
    names = {None: ("flash_gat", "ell_fused", "calibrate"), "tree_ell": ("ell_fused",),
             "calibrate": ("flash_gat", "calibrate"),
             "inductive": ("flash_gat",)}.get(args.only, (args.only,))
    cached = [n for n in names if _build.library_path(n).exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        sampler_built = pool.submit(lambda: bool(args.only) or native.available())
        libs = _build.build_all(names)
        if not sampler_built.result():
            fail("the C++ sampler (han_tpu_torch/native/graphcore.cpp) did not build")
    for name in names:
        _build.load(name)
        # ptxas serializes a kernel's wgmma products ("Potential Performance
        # Loss: wgmma.mma_async instructions are serialized", C7511 and kin)
        # when, say, an accumulator is touched between them: the wide bodies
        # then run 1.5-2x slower and nothing else would say so. The
        # warpgroup arrives and waits it injects (C7517, C7519) are printed
        report = _build.ptxas_report(name).splitlines()
        serialized = [ln.strip() for ln in report
                      if re.search(r"wgmma\S* instructions are serialized", ln)]
        if serialized:
            fail(f"{name}: ptxas serialized wgmma products:\n" + "\n".join(serialized))
        injected = sum(bool(re.search(r"warpgroup\.(arrive|wait) is injected", ln))
                       for ln in report)
        if injected:
            print(f"{name}: ptxas injected {injected} warpgroup arrive or wait instructions "
                  "(C7517, C7519)", flush=True)
    root = pathlib.Path(__file__).resolve().parent
    print(f"build: {', '.join(str(so.relative_to(root)) for so in libs)}"
          f"{'' if args.only else f' and {native.library_path().relative_to(root)}'} "
          f"{f'(already built: {cached}) ' if cached else ''}"
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    if args.only == "inductive":
        torch.empty(0, device=dev)  # the context, before the peaks are reset
        train_ppi(dev, card)
        print(json.dumps({"ok": True, "card": card}), flush=True)
        return

    if args.only == "tree_ell":
        print(json.dumps({"card": card, **{
            f"tree_ell_{key}": {"ms_by_dropout": st["ms_by_dropout"], "plain_ms": st["plain_ms"],
                                "max_abs_err": st["err"], "bound_ms": st.get("bound", [None])[0]}
            for key, st in check_tree_ell(dev, card).items()}}), flush=True)
        return

    if args.only == "ell_fused":
        print(json.dumps({"card": card, **{
            f"ell_fused{tag}": {"ms_by_dropout": ell["ms_by_dropout"], "plain_ms": ell["plain_ms"],
                                "bound_ms": ell["bound"][0]}
            for tag, ell in (("", check_ell_fused(dev, ELL_SHAPES[:1])),
                             ("_bf16", check_ell_fused(dev, ELL_SHAPES[:1], "bfloat16")))}}),
              flush=True)
        return

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
    ld, ls, v, g = dblp_inputs(gen, n, ds.n_nodes, k, d)

    if args.only == "calibrate":
        stats = check_dblp(graph, ld, ls, v, g, ps=(0.0,))
        bf16 = check_dblp(graph, ld, ls, v.to(torch.bfloat16), g)  # bf16 v
        cal_stats = check_calibration(dev)
        _, cal_result = run_calibration(root)
        prims = report_prims(cal_result)
        strips = compare_strips(cal_result, stats, bf16, graph.n_tiles * k)
        print(json.dumps({"card": card, "prims": prims, "strips_vs_flash": strips, "calibration": {
            key: {"ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound"][0]}
            for key, st in cal_stats.items()}}), flush=True)
        return
    stats = check_dblp(graph, ld, ls, v, g)
    # -- phase 3e: the batched kernels, one launch for the meta-paths --------
    batched = check_batched(dev, ds, card)
    # -- phase 3w: head dims above 32 (the wide bodies, the split backward
    # in chunks of 32) ---------------------------------------------------------
    wide = check_wide_heads(graph, gen, ds.n_nodes, card)
    # -- phase 3x: the wide body at PPI's and APTPA's shapes, beside the
    # chunked route ------------------------------------------------------------
    wide_body = check_wide_body(dev, ds, card)
    if args.only == "flash_gat":
        print(json.dumps({"card": card, "flash": {
            key: {"ms_by_dropout": st["ms_by_dropout"], "plain_ms": st["plain_ms"]}
            for key, st in stats.items()}, "batched": batched,
            "wide": {tag: {key: {"ms_by_dropout": x["ms_by_dropout"], "plain_ms": x["plain_ms"],
                                 "bound_ms": x["bound"][0], "library_ms": x.get("library_ms")}
                           for key, x in st.items()} for tag, st in wide.items()},
            "wide_body": wide_body}), flush=True)
        return
    for p in (0.0, 0.6):
        tf32_control(f"DBLP, dropout {p}", graph, ld, ls, v, g,
                     fg.FlashMeta(slope=0.2, dropout_p=p, seed=fg.seed_tensor(1234567, dev)))
    torch.cuda.empty_cache()
    library_fwd_ms = sdpa_yardstick(graph, ld, ls, v, k, d)
    bf16 = check_dblp(graph, ld, ls, v.to(torch.bfloat16), g)  # bf16 v
    bounds = flash_bounds(graph, k, d)
    # D = 32: the dblp preset with model.hid_units=32
    for name, st in check_dblp(graph, *dblp_inputs(gen, n, ds.n_nodes, k, 32), ps=(0.6,)).items():
        stats[name]["err"] = max(stats[name]["err"], st["err"])

    # -- phase 3d: the other head dims on a small graph with edge cases -----
    for dims, into in ((HEAD_DIMS, stats), (WIDE_HEAD_DIMS, wide["64"])):
        for name, err in check_head_dims(dev, dims).items():
            into[name]["err"] = max(into[name]["err"], err)

    # -- phase 3e at D = 64: the batched kernels in chunks -------------------
    for name, st in check_batched(dev, ds, card, d=64, timing=False).items():
        wide["64"][name]["err"] = max(wide["64"][name]["err"], st["err"])

    # -- phase 3c: the kernels on the strips of a 4-way partition (D = 8, 64)
    # -- phase 3f: the kernels under the heads axis (head_offset 4; D = 8, 64)
    for d_strip, into in ((8, stats), (64, wide["64"])):
        for check_fn in (check_strips, check_head_offset):
            for name, err in check_fn(dev, ds.metapath_adjs[big], d_strip).items():
                into[name]["err"] = max(into[name]["err"], err)
    tile_heads = graph.n_tiles * k  # of the DBLP check, for the strips' comparison

    # -- phase 3b: a small HAN through the kernels vs the dense path ---------
    check_small_han(dev)

    # -- phase 4: the dblp preset's training, through the kernels ------------
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import run

    cfg = preset("dblp")
    cfg.train.epochs = 10
    n_mp = len(ds.metapath_adjs)
    torch.cuda.reset_peak_memory_stats(dev)
    fg.flash_fwd_launches = 0
    fg.flash_bwd_launches = 0
    result = run(cfg, ds, device=dev)
    torch.cuda.synchronize()
    fwd_n, bwd_n = fg.flash_fwd_launches, fg.flash_bwd_launches
    if not result["captured"]:
        fail("the dblp preset's steps were not captured as CUDA graphs")
    losses = result["epoch_train_loss"]
    if len(losses) != cfg.train.epochs or not all(np.isfinite(losses)):
        fail(f"train losses not finite or short: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train loss did not fall: {losses[0]} -> {losses[-1]}")
    if not np.isfinite(result["test_loss"]):
        fail(f"test loss {result['test_loss']}")
    # per epoch: a train step (forward + backward) and a val eval; then a
    # test eval
    want_fwd = n_mp * (2 * cfg.train.epochs + 1)
    if fwd_n != want_fwd or bwd_n != n_mp * cfg.train.epochs:
        fail(f"launch counts fwd {fwd_n} (want {want_fwd}), bwd {bwd_n} "
             f"(want {n_mp * cfg.train.epochs})")
    print(f"train (captured): losses {losses[0]:.5f} -> {losses[-1]:.5f}, test_acc "
          f"{result['test_acc']:.4f}; launches fwd {fwd_n} bwd {bwd_n} = "
          f"{n_mp} fwd + {n_mp} bwd per train step", flush=True)
    print(f"train (captured): median step time epochs 2-10 "
          f"{statistics.median(result['epoch_step_time_s'][1:]) * 1e3:.4f} ms, "
          f"max_memory_allocated {result['max_memory_allocated']} B; {card}", flush=True)

    # -- phase 4l: the dblp preset at hid_units=(64,), heads in chunks ------
    hid64 = train_dblp_hid64(ds, dev, card, n_mp)

    # -- phase 4f: the captured step against the eager one ------------------
    losses_dropout0 = check_dblp_capture(ds, dev, card)

    # -- phase 4j: the meta-path towers stacked (vmap_towers) ----------------
    vmap = train_vmap_towers(ds, dev, card)

    # -- phase 4g: preempted and resumed, captured, fused backward ----------
    resume = dblp_resume(ds, dev, score=True)
    check_dblp_resume(resume, CAPTURE_TOL, "dblp resume (fused backward)", n_mp)
    km = resume["kmeans"]
    if not -1.0 <= km["silhouette"] <= 1.0:
        fail(f"silhouette {km['silhouette']} outside [-1, 1]")
    print(f"silhouette: kmeans_eval(with_silhouette=True) on the resumed run's test "
          f"embedding ({km['n']} nodes): nmi {km['nmi']:.4f}, ari {km['ari']:.4f}, "
          f"silhouette {km['silhouette']:.4f}; {km['s']:.3f} s; {card}", flush=True)

    # -- phases 4h, 4i: HANShared through flash and csr; entry() -------------
    shared = train_han_shared(ds, dev, n_mp, card)
    check_entry(dev, card)

    bf16_train = train_bf16(ds, dev, n_mp, card)
    # -- phase 4k: impl=auto on DBLP's graphs (flash), and the edge views' memory
    dispatch = check_dispatch_dblp(ds, dev, card)
    del ds, graph
    torch.cuda.empty_cache()
    train_acm(dev)

    # -- phase 4d: the pubmed preset's GAT through the flash kernels ---------
    pubmed = train_pubmed(dev, card)
    torch.cuda.empty_cache()

    # -- phase 4e: the ppi preset at full width (dense attention) -----------
    train_ppi(dev, card)
    torch.cuda.empty_cache()

    # -- phase 4b: multi-device training through the partitioned backends ----
    mesh = train_multi_device(losses, losses_dropout0, vmap["losses"], hid64["losses"],
                              cfg.train.epochs, n_mp)

    # -- phases 5-7: the sampled path ------------------------------------------
    ell = check_ell_fused(dev)
    # -- phase 3g: the ell_fused kernel on bf16 features
    ell16 = check_ell_fused(dev, ELL_SHAPES, "bfloat16")
    # -- phase 6t: the tree attention's kernels on device-sampler blocks
    tree = check_tree_ell(dev, card)
    ell_n, tree_n = train_sampled(dev, native, card)
    # -- phase 7d: DPSampledTrainer on a one-rank NCCL world
    dp_ell = train_dp_sampled(dev, card)

    # -- phase 8: the calibration kernels, then the calibration run ---------
    cal_stats = check_calibration(dev)
    cal_n, cal_result = run_calibration(root)
    report_prims(cal_result)
    compare_strips(cal_result, stats, bf16, tile_heads)

    # -- phase 9: the benchmark's kernels vs plain, then its f32 and bf16 arms
    for name, err in check_bench_shape(root, dev).items():
        stats[name]["err"] = max(stats[name]["err"], err)
    for key, err in pubmed["err"].items():
        stats[key]["err"] = max(stats[key]["err"], err)
    bench = run_bench(root)

    # launches: the dblp runs (phases 4, 4a, 4g, 4h, 4k), the pubmed run
    # (phase 4d), the multi-device runs (phase 4b, with the deterministic
    # resume) and the benchmark (phase 9); at D = 64 the hid-64 runs
    # (phases 4l and 4b) and the benchmark's D = 64 arm
    part, ring = mesh["partitioned_bcsr"]["launches"], mesh["ring_bcsr"]["launches"]
    stacked = mesh["partitioned_bcsr stacked"]["launches"]
    det = mesh["resume deterministic"]
    launches = {"fwd": (fwd_n + bf16_train["fwd"] + resume["launches"]["fwd"] + shared["fwd"]
                        + dispatch["fwd"] + pubmed["launches"]["fwd"] + part["fwd"]
                        + ring["fwd"] + det["fwd"] + bench["d8"]["fwd"]),
                "bwd": (bwd_n + bf16_train["bwd"] + resume["launches"]["bwd"] + shared["bwd"]
                        + dispatch["bwd"] + pubmed["launches"]["bwd"] + part["bwd"]
                        + bench["d8"]["bwd"]),
                "row": ring["row"] + det["row"], "col": ring["col"] + det["col"]}
    part64, ring64 = mesh["partitioned_bcsr hid 64"]["launches"], mesh["ring_bcsr hid 64"]["launches"]
    launches64 = {"fwd": hid64["launches"]["fwd"] + part64["fwd"] + ring64["fwd"]
                  + bench["d64"]["fwd"],
                  "bwd": hid64["launches"]["bwd"] + part64["bwd"] + bench["d64"]["bwd"],
                  "row": ring64["row"], "col": ring64["col"]}
    src = "han_tpu_torch/csrc/flash_gat.cu"
    tpu = "han_tpu/ops/pallas/flash_gat.py"
    kernels = [
        {"name": f"flash_gat_{name}", "route": "cuda", "source": src,
         "replaces": f"{tpu}:{line}", "launches": launches[key],
         "max_abs_err": max(stats[key]["err"], bf16[key]["err"]), "ms": stats[key]["ms"],
         "plain_ms": stats[key]["plain_ms"], "bound_ms": bounds[key][0],
         "bound_by": bounds[key][1], "library_ms": library_fwd_ms if key == "fwd" else None,
         "ms_by_dropout": stats[key]["ms_by_dropout"],
         **({"pubmed": pubmed["kernels"][key]} if key in pubmed["kernels"] else {})}
        for name, key, line in (("fwd", "fwd", "97,187"), ("bwd", "bwd", 395),
                                ("bwd_row", "row", 354), ("bwd_col", "col", 395))] + [
        {"name": "ell_fused_fwd", "route": "cuda", "source": "han_tpu_torch/csrc/ell_fused.cu",
         "replaces": "han_tpu/ops/pallas/ell_fused.py:54", "launches": ell_n + dp_ell["f32"],
         "max_abs_err": ell["err"], "ms": ell["ms"], "plain_ms": ell["plain_ms"],
         "bound_ms": ell["bound"][0], "bound_by": ell["bound"][1], "library_ms": None,
         "tree_max_abs_err": tree["fwd"]["err"], "tree_ms_by_dropout": tree["fwd"]["ms_by_dropout"]},
        # the tree attention's backward (phase 6t); launches: the device
        # sampler's train steps (phases 7, 7b, 7c)
        {"name": "tree_ell_bwd", "route": "cuda", "source": "han_tpu_torch/csrc/ell_fused.cu",
         "replaces": "none (han_tpu/ops/tree_ell.py:_tree_core is XLA gathers)",
         "launches": tree_n, "max_abs_err": tree["bwd"]["err"], "ms": tree["bwd"]["ms"],
         "plain_ms": tree["bwd"]["plain_ms"], "bound_ms": tree["bwd"]["bound"][0],
         "bound_by": tree["bwd"]["bound"][1], "library_ms": None,
         "ms_by_dropout": tree["bwd"]["ms_by_dropout"]},
        # the same kernel on bf16 features (phase 3g); launches: phase 7d's bf16 run
        {"name": "ell_fused_fwd_bf16", "route": "cuda", "source": "han_tpu_torch/csrc/ell_fused.cu",
         "replaces": "han_tpu/ops/pallas/ell_fused.py:54 (bf16 features)",
         "launches": dp_ell["bf16"], "max_abs_err": ell16["err"], "ms": ell16["ms"],
         "plain_ms": ell16["plain_ms"], "bound_ms": ell16["bound"][0],
         "bound_by": ell16["bound"][1], "library_ms": None},
    ] + [
        {"name": f"cal_{key}", "route": "cuda", "source": "han_tpu_torch/csrc/calibrate.cu",
         "replaces": f"scripts/cal_vpu.py:{line}", "launches": cal_n[key],
         "max_abs_err": cal_stats[key]["err"], "ms": cal_stats[key]["ms"],
         "plain_ms": cal_stats[key]["plain_ms"], "bound_ms": cal_stats[key]["bound"][0],
         "bound_by": cal_stats[key]["bound"][1], "library_ms": None}
        for key, line in (("prim", 63), ("fwd_strip", 74), ("fwd_strip_bf16", 112),
                          ("bwd_strip", 144))] + [
        # the same kernels, one launch for DBLP's three meta-paths (phase 3e);
        # launches: the vmap_towers run (phase 4j) and the stacked partition
        # (phase 4b, deterministic: the split pair)
        {"name": f"flash_gat_{name}_batched", "route": "cuda", "source": src,
         "replaces": f"{tpu}:{line} (vmapped)",
         "launches": {"fwd": vmap["launches"]["fwd"] + stacked["fwd"],
                      "bwd": vmap["launches"]["bwd"] + stacked["bwd"],
                      "row": stacked["row"], "col": stacked["col"]}[key],
         "max_abs_err": batched[key]["err"], "ms": batched[key]["ms"],
         "plain_ms": batched[key]["plain_ms"], "bound_ms": batched[key]["bound_ms"],
         "bound_by": batched[key]["bound_by"], "library_ms": batched[key].get("library_ms"),
         "single_launches_ms": batched[key]["single_sum_ms"]}
        for name, key, line in (("fwd", "fwd", 187), ("bwd", "bwd", 395),
                                ("bwd_row", "row", 354), ("bwd_col", "col", 395))] + [
        # the same kernels at D = 64, two chunks a head (phase 3w at APTPA;
        # errors also of phases 3c, 3e and 3f at D = 64 and 3d at D > 32);
        # launches: the hid-64 runs and the benchmark's D = 64 arm
        {"name": f"flash_gat_{name}_d64", "route": "cuda", "source": src,
         "replaces": f"{tpu}:{line} (D = 64)", "launches": launches64[key],
         "max_abs_err": max(wide["64"][key]["err"], wide["64 bf16"][key]["err"]),
         "ms": wide["64"][key]["ms"], "plain_ms": wide["64"][key]["plain_ms"],
         "bound_ms": wide["64"][key]["bound"][0], "bound_by": wide["64"][key]["bound"][1],
         "library_ms": wide["64"][key].get("library_ms"),
         "ms_by_dropout": wide["64"][key]["ms_by_dropout"],
         **{f"d{d}": {"ms": wide[str(d)][key]["ms"], "bound_ms": wide[str(d)][key]["bound"][0],
                      "library_ms": wide[str(d)][key].get("library_ms")} for d in WIDE_DIMS[1:]}}
        for name, key, line in (("fwd", "fwd", "97,187"), ("bwd", "bwd", 395),
                                ("bwd_row", "row", 354), ("bwd_col", "col", 395))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def dblp_inputs(gen, n: int, n_nodes: int, k: int, d: int):
    """ld, ls (K, n) and v, g (n, K·d) drawn from gen, zero on the padding
    rows (n_nodes and on)."""
    import torch

    rnd = lambda *s: torch.randn(*s, generator=gen, device=gen.device)
    ld, ls, v, g = rnd(k, n), rnd(k, n), rnd(n, k * d), rnd(n, k * d)
    for t in (ld, ls):
        t[:, n_nodes:] = 0.0
    for t in (v, g):
        t[n_nodes:] = 0.0
    return ld, ls, v, g


def check_dblp(graph, ld, ls, v, g, ps=(0.0, 0.6)) -> dict:
    """Phase 3: the flash kernels at the DBLP shape (K from ld, D from v;
    above 32 the forward and the fused backward through their wide bodies,
    the split backward in chunks of ops/flash_gat.py:HEAD_CHUNK columns on
    the kernels' grid), at each dropout of ``ps``: the forward (atol 1e-5,
    rtol 1e-4), the fused backward and the split backward's row and column
    sweeps (atol 1e-4, rtol 1e-3: dld is summed with atomicAdd in a varying
    order) against their full-D plain versions, delta from head_delta; the
    split backward run twice, bitwise equal; the device time of each kernel
    at each dropout, and of each plain version at the last. Returns, per
    kernel, the largest error, ``ms`` and ``plain_ms`` at the last dropout
    (0.6, the training shape) and ``ms_by_dropout``, so that the hash's
    share shows."""
    import torch

    from han_tpu_torch.ops import flash_gat as fg

    k = ld.shape[0]
    d = v.shape[1] // k
    tag = f"D = {d}{' (bf16 v)' if v.dtype == torch.bfloat16 else ''}"
    stats = {name: {"err": 0.0, "ms_by_dropout": {}} for name in ("fwd", "bwd", "row", "col")}
    for p in ps:
        meta = fg.FlashMeta(slope=0.2, dropout_p=p, seed=fg.seed_tensor(1234567, ld.device))
        wide = fg.takes_wide(graph)
        print(f"{tag}, dropout {p} ((width, chunks) forward "
              f"{fg.head_plan(d, fg.WIDE_HEAD_DIMS if wide else ())}, fused backward "
              f"{fg.head_plan(d, fg.BWD_WIDE_DIMS if wide else ())}, sweeps {fg.head_plan(d)}):",
              flush=True)
        out_k, lse_k = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
        out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
        torch.cuda.synchronize()
        errs = {"fwd": max(check("out", out_k, out_p, 1e-5, 1e-4),
                           check("lse", lse_k, lse_p, 1e-5, 1e-4))}
        del out_p, lse_p
        args = (graph, ld, ls, v, g, lse_k, fg.head_delta(g, out_k, k), meta)
        errs["bwd"] = max(check(name, a, b, 1e-4, 1e-3) for name, a, b in
                          zip(("dld", "dls", "dv"), fg.flash_bwd_cuda(*args),
                              fg.flash_bwd_plain(*args)))
        # the split backward: each sweep against its plain version, and twice
        split = (fg.flash_bwd_row_cuda(*args), *fg.flash_bwd_col_cuda(*args))
        again = (fg.flash_bwd_row_cuda(*args), *fg.flash_bwd_col_cuda(*args))
        errs["row"] = check("dld (row sweep)", split[0], fg.flash_bwd_row_plain(*args),
                            1e-4, 1e-3)
        errs["col"] = max(check(f"{name} (column sweep)", a, b, 1e-4, 1e-3) for name, a, b
                          in zip(("dls", "dv"), split[1:], fg.flash_bwd_col_plain(*args)))
        if not all(torch.equal(a, b) for a, b in zip(split, again)):
            fail(f"{tag}, dropout {p}: the split backward differs between two runs")
        del split, again
        t = {"fwd": timed(lambda: fg.flash_fwd_cuda(graph, ld, ls, v, meta)),
             "bwd": timed(lambda: fg.flash_bwd_cuda(*args)),
             "row": timed(lambda: fg.flash_bwd_row_cuda(*args)),
             "col": timed(lambda: fg.flash_bwd_col_cuda(*args)),
             "split": timed(lambda: (fg.flash_bwd_row_cuda(*args), fg.flash_bwd_col_cuda(*args)))}
        print("  device ms: " + ", ".join(f"{a} {b:.4f}" for a, b in t.items())
              + f"; split / fused {t['split'] / t['bwd']:.3f}", flush=True)
        for key, st in stats.items():
            st.update(err=max(st["err"], errs[key]), ms=t[key])
            st["ms_by_dropout"][str(p)] = t[key]
        torch.cuda.empty_cache()
    plain = {"fwd": lambda: fg.flash_fwd_plain(graph, ld, ls, v, meta),
             "bwd": lambda: fg.flash_bwd_plain(*args),
             "row": lambda: fg.flash_bwd_row_plain(*args),
             "col": lambda: fg.flash_bwd_col_plain(*args)}
    for key, fn in plain.items():
        stats[key]["plain_ms"] = timed(fn, reps=3, host_waits=True)
    print("  plain versions' ms (host time included): "
          + ", ".join(f"{key} {st['plain_ms']:.4f}" for key, st in stats.items()), flush=True)
    torch.cuda.empty_cache()
    return stats


WIDE_DIMS = (64, 128, 256)  # phase 3w's head dims above the largest instantiation


def check_wide_heads(graph, gen, n_nodes: int, card: str) -> dict:
    """Phase 3w: phase 3 (check_dblp) at head dims above the largest
    instantiation, on DBLP's largest meta-path with K = 8: D = 64, 128 and
    256 with f32 v and D = 64 with bf16 v, dropout 0 and 0.6. Adds each
    kernel's bound (flash_bounds) and, for the f32 forward, sdpa_yardstick
    at the same D. Returns check_dblp's stats with ``bound`` (and the
    forward's ``library_ms``) per tag ("64", "128", "256", "64 bf16")."""
    import torch

    k, res = 8, {}
    for d, bf16 in [(d, False) for d in WIDE_DIMS] + [(64, True)]:
        tag = f"{d}{' bf16' if bf16 else ''}"
        ld, ls, v, g = dblp_inputs(gen, graph.n_pad, n_nodes, k, d)
        if bf16:
            v = v.to(torch.bfloat16)
        st = check_dblp(graph, ld, ls, v, g)
        bounds = flash_bounds(graph, k, d, v_bytes=v.element_size())
        for key, s in st.items():
            s["bound"] = bounds[key]
        st["fwd"]["library_ms"] = None if bf16 else sdpa_yardstick(graph, ld, ls, v, k, d)
        for key, s in st.items():
            print(f"  D = {tag} {key}: device ms {s['ms_by_dropout']['0.0']:.4f} / "
                  f"{s['ms_by_dropout']['0.6']:.4f} (dropout 0 / 0.6), bound "
                  f"{s['bound'][0]:.4f} ms ({s['bound'][1]}), {s['ms'] / s['bound'][0]:.1f}x; "
                  f"plain {s['plain_ms']:.4f} ms"
                  + (f"; SDPA {s['library_ms']:.4f} ms" if s.get("library_ms") else "")
                  + f"; {card}", flush=True)
        res[tag] = st
        del ld, ls, v, g
        torch.cuda.empty_cache()
    return res


def ppi_union(dev, n_graph: int = 2300, slot: int = 3584, undirected: int = 34000,
              seed: int = 1):
    """A PPI-shaped batch on the card: two graphs of ``n_graph`` nodes (PPI's
    mean is 2,372) in slots of ``slot`` rows, each with ``undirected``
    uniform pairs taken both ways and a self-loop a node (PPI: 818,716
    undirected edges over 24 graphs), as InductiveTrainer's block-diagonal
    union lays them out (128 x 128 tiles, about 650 occupied)."""
    import numpy as np

    from han_tpu_torch.graph.bcsr import bcsr_from_coo

    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for base in (0, slot):
        e = rng.integers(0, n_graph, (undirected, 2))
        loops = base + np.arange(n_graph)
        rows += [base + e[:, 0], base + e[:, 1], loops]
        cols += [base + e[:, 1], base + e[:, 0], loops]
    pairs = np.unique(np.stack([np.concatenate(rows), np.concatenate(cols)], 1), axis=0)
    return bcsr_from_coo(pairs[:, 0], pairs[:, 1], 2 * slot).to(dev)


def check_wide_body(dev, ds, card: str) -> dict:
    """Phase 3x: the wide bodies (head dims above 32 on wgmma: the forward
    sweeps each tile once a head, or a half of a head above 128; the fused
    backward once a chunk of 64) at the shapes that run them: PPI's union
    (ppi_union) at K = 4, D = 256 and K = 6, D = 121, dropout 0 (the ppi
    preset's), and DBLP's three meta-paths stacked (one launch) at K = 8,
    D = 64, dropout 0.6 (HAN at hid 64). Per shape: the wide forward and
    fused backward against their plain versions (phase 3's tolerances),
    both launched as the chunked route (chunks of 32, through the
    wrappers' own helpers fg.fwd_chunked / fg.bwd_chunked with
    ``wide=False``) against them too; the device times of both routes beside the bounds;
    the wide bodies' launches counted. Returns per shape the errors, times
    and bounds."""
    import torch

    from han_tpu_torch.graph.build import metapath_to_bcsr
    from han_tpu_torch.graph.stack import stack_graphs
    from han_tpu_torch.ops import flash_gat as fg

    union = ppi_union(dev)
    paths = [metapath_to_bcsr(a).to(dev) for a in ds.metapath_adjs]
    stack = stack_graphs(paths)
    gen = torch.Generator(dev).manual_seed(21)
    res = {}
    for tag, graph, parts, k, d, p in (("ppi_k4_d256", union, [union], 4, 256, 0.0),
                                       ("ppi_k6_d121", union, [union], 6, 121, 0.0),
                                       ("aptpa_k8_d64_3paths", stack, paths, 8, 64, 0.6)):
        n_p = graph.n_paths
        per = [dblp_inputs(gen, graph.n_pad, graph.n_pad if n_p is None else ds.n_nodes, k, d)
               for _ in range(n_p or 1)]
        ld, ls, v, g = (torch.stack([x[i] for x in per]) if n_p else per[0][i] for i in range(4))
        seeds = torch.tensor([1234567, 7654321, 2468013][:n_p or 1], dtype=torch.int32,
                             device=dev)
        meta = fg.FlashMeta(slope=0.2, dropout_p=p, seed=seeds)
        print(f"wide body, {tag} ({graph.n_tiles} tiles{f', {n_p} paths' if n_p else ''}, "
              f"(width, chunks) forward {fg.head_plan(d, fg.WIDE_HEAD_DIMS)}, fused backward "
              f"{fg.head_plan(d, fg.BWD_WIDE_DIMS)}, chunked {fg.head_plan(d)}), dropout {p}:",
              flush=True)
        launches = fg.flash_fwd_wide_launches
        out, lse = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
        if fg.flash_fwd_wide_launches == launches:
            fail(f"wide body, {tag}: the forward did not launch the wide body")
        fwd_chunked = lambda: fg.fwd_chunked(fg._fwd_launch, graph, ld, ls, v, meta, wide=False)
        out_c, lse_c = fwd_chunked()
        out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
        torch.cuda.synchronize()
        err = {"fwd": max(check("out", out, out_p, 1e-5, 1e-4), check("lse", lse, lse_p, 1e-5, 1e-4)),
               "fwd_chunked": max(check("out (chunked)", out_c, out_p, 1e-5, 1e-4),
                                  check("lse (chunked)", lse_c, lse_p, 1e-5, 1e-4))}
        del out_p, lse_p, out_c, lse_c
        args = (graph, ld, ls, v, g, lse, fg.head_delta(g, out, k), meta)
        bwd_chunked = lambda: fg.bwd_chunked(fg._bwd_launch, *args, wide=False)
        launches = fg.flash_bwd_wide_launches
        got = fg.flash_bwd_cuda(*args)
        if fg.flash_bwd_wide_launches == launches:
            fail(f"wide body, {tag}: the fused backward did not launch the wide body")
        want = fg.flash_bwd_plain(*args)
        err["bwd"] = max(check(name, a, b, 1e-4, 1e-3)
                         for name, a, b in zip(("dld", "dls", "dv"), got, want))
        err["bwd_chunked"] = max(
            check(f"{name} (chunked)", a, b, 1e-4, 1e-3)
            for name, a, b in zip(("dld", "dls", "dv"), bwd_chunked(), want))
        del got, want
        torch.cuda.synchronize()
        t = {"fwd": timed(lambda: fg.flash_fwd_cuda(graph, ld, ls, v, meta)),
             "fwd_chunked": timed(fwd_chunked),
             "bwd": timed(lambda: fg.flash_bwd_cuda(*args)),
             "bwd_chunked": timed(bwd_chunked)}
        bounds = [flash_bounds(gp, k, d) for gp in parts]
        bnd = {key: sum(b[key][0] for b in bounds) for key in ("fwd", "bwd")}
        print(f"  {tag}: device ms forward {t['fwd']:.4f} (chunked route {t['fwd_chunked']:.4f}, "
              f"{t['fwd_chunked'] / t['fwd']:.2f}x), bound {bnd['fwd']:.4f}; fused backward "
              f"{t['bwd']:.4f} (chunked route {t['bwd_chunked']:.4f}, "
              f"{t['bwd_chunked'] / t['bwd']:.2f}x), bound {bnd['bwd']:.4f}; {card}", flush=True)
        res[tag] = {"err": err, "ms": t, "bound_ms": bnd}
        del ld, ls, v, g, out, lse, args
        torch.cuda.empty_cache()
    return res


TF32_MARGIN = 10  # the kernels' errors stay this far below a single TF32 product's


def tf32_control(tag, graph, ld, ls, v, g, meta) -> None:
    """Control of the 3xTF32 products: the forward's out, the fused
    backward's dld, dls and dv, and the row sweep's dld, as the kernels give
    them and as the plain versions give them with their products taken by
    fg.mm_3xtf32 (the kernels' split) and by fg.mm_1xtf32 (one TF32
    product), each against the f32 plain version on the same inputs. The
    kernels' largest error must be TF32_MARGIN times below the 1xTF32 one,
    so that a pass of the tolerances stands for products at f32 accuracy."""
    import torch

    from han_tpu_torch.ops import flash_gat as fg

    k = ld.shape[0]
    out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
    args = (graph, ld, ls, v, g, lse_p, fg.head_delta(g, out_p, k), meta)
    want = (out_p, fg.flash_bwd_plain(*args), fg.flash_bwd_row_plain(*args))
    got = {"kernel": (fg.flash_fwd_cuda(graph, ld, ls, v, meta)[0], fg.flash_bwd_cuda(*args),
                      fg.flash_bwd_row_cuda(*args))}
    for name, mm in (("3xTF32", fg.mm_3xtf32), ("1xTF32", fg.mm_1xtf32)):
        got[name] = (fg.flash_fwd_plain(graph, ld, ls, v, meta, mm=mm)[0],
                     fg.flash_bwd_plain(*args, mm=mm), fg.flash_bwd_row_plain(*args, mm=mm))
    torch.cuda.synchronize()
    err = {name: (float((o[0] - want[0]).abs().max()),
                  max(float((a - b).abs().max()) for a, b in zip(o[1], want[1])),
                  float((o[2] - want[2]).abs().max()))
           for name, o in got.items()}
    print(f"{tag}, products: max_abs_err forward / backward / row sweep: kernel "
          + " / ".join(f"{x:.3e}" for x in err["kernel"]) + ", 3xTF32 mirror "
          + " / ".join(f"{x:.3e}" for x in err["3xTF32"]) + ", 1xTF32 "
          + " / ".join(f"{x:.3e}" for x in err["1xTF32"]), flush=True)
    for i, what in enumerate(("forward", "backward", "row sweep")):
        for name in ("kernel", "3xTF32"):
            if not err[name][i] * TF32_MARGIN <= err["1xTF32"][i]:
                fail(f"{tag}: the {what} {name} error {err[name][i]:.3e} is not "
                     f"{TF32_MARGIN}x below one TF32 product's ({err['1xTF32'][i]:.3e})")


def check_strips(dev, adj, d: int = 8) -> dict:
    """Phase 3c: the flash kernels on rectangles, at dropout 0 and 0.6, K =
    8 heads of ``d`` (64: two chunks a head, delta per chunk).
    DBLP's largest meta-path (with self-loops) cut four ways with 128x128
    tiles: every shard of partition_bcsr (1,024 local rows x 4,096 global
    columns, a non-zero row-block offset) and the ring cells (s, 1 + s mod
    3) of ring_partition_bcsr (t >= 1, so the column-block offset is not
    0). On each, with v in f32 and in bf16 (the plain versions widen the
    same bf16 values, so the f32 tolerances hold): forward vs plain (out
    and lse, atol 1e-5, rtol 1e-4); row and column sweeps vs plain, and the
    split vs the fused backward (atol 1e-4, rtol 1e-3); the split run
    twice, bitwise equal (torch.equal). Returns the largest errors per
    kernel."""
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
    k = 8
    errs = {"fwd": 0.0, "row": 0.0, "col": 0.0, "bwd": 0.0}
    for label, graph, off in strips:
        label = f"{label}, D = {d}"
        n_rows, n_cols = graph.nb_r * graph.bm, graph.nb_c * graph.bn
        ld, ls, v32, g = rnd(k, n_rows), rnd(k, n_cols), rnd(n_cols, k * d), rnd(n_rows, k * d)
        print(f"{label}: {n_rows} x {n_cols}, {int(graph.fwd_count.sum())} tiles, "
              f"offsets {off}", flush=True)
        for v, p in ((v, p) for v in (v32, v32.to(torch.bfloat16)) for p in (0.0, 0.6)):
            p_tag = f"p={p}{' bf16 v' if v.dtype == torch.bfloat16 else ''}"
            meta = fg.FlashMeta(dropout_p=p, seed=fg.seed_tensor(7654321, dev), **off)
            out, lse = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
            out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
            errs["fwd"] = max(errs["fwd"], check(f"{p_tag} out", out, out_p, 1e-5, 1e-4),
                              check(f"{p_tag} lse", lse, lse_p, 1e-5, 1e-4))
            args = (graph, ld, ls, v, g, lse, fg.head_delta(g, out, k), meta)
            split = (fg.flash_bwd_row_cuda(*args), *fg.flash_bwd_col_cuda(*args))
            plain = (fg.flash_bwd_row_plain(*args), *fg.flash_bwd_col_plain(*args))
            fused = fg.flash_bwd_cuda(*args)
            again = (fg.flash_bwd_row_cuda(*args), *fg.flash_bwd_col_cuda(*args))
            torch.cuda.synchronize()
            for i, name in enumerate(("dld", "dls", "dv")):
                key = "row" if i == 0 else "col"
                errs[key] = max(errs[key], check(f"{p_tag} {name}", split[i], plain[i],
                                                 1e-4, 1e-3))
                errs["bwd"] = max(errs["bwd"], check(f"{p_tag} {name} split vs fused", split[i],
                                                     fused[i], 1e-4, 1e-3))
                if not torch.equal(split[i], again[i]):
                    fail(f"{label}: the split backward's {name} differs between two runs")
        print(f"  {label}: split backward bitwise equal over two runs", flush=True)
    return errs


def check_batched(dev, ds, card: str, d: int = 8, timing: bool = True) -> dict:
    """Phase 3e: the batched flash kernels, one launch for HAN's meta-paths.
    DBLP's meta-paths (with self-loops, 128x128 tiles, n_pad 4096) stacked
    (graph/stack.py: tiles and maps padded to the largest), K = 8 heads of
    ``d`` (8; 64: two chunks a head, delta per chunk), at
    dropout 0 and 0.6 (one seed a path): the batched forward, fused
    backward and both sweeps against their plain versions (the phase 3
    tolerances), and path p against a launch of graph p alone with seed p:
    forward and sweeps bitwise (torch.equal), fused backward within atol
    1e-4, rtol 1e-3 (dld's atomics). Then, with ``timing``, the device
    time of one batched
    launch of each kernel against the sum of the single-path launches, the
    batched plain versions' (a loop over the paths; host time included),
    one scaled_dot_product_attention call over the three paths as the
    forward's yardstick (sdpa_yardstick, batched), and the bound of the
    stack (the sum of the per-path bounds). Returns the errors, times and
    bounds per kernel."""
    import torch

    from han_tpu_torch.graph.build import metapath_to_bcsr
    from han_tpu_torch.graph.stack import stack_graphs
    from han_tpu_torch.ops import flash_gat as fg

    graphs = [metapath_to_bcsr(a).to(dev) for a in ds.metapath_adjs]
    st = stack_graphs(graphs)
    n_p, n, k = len(graphs), st.n_pad, 8
    print(f"batched, D = {d}: {n_p} meta-paths stacked, tiles {tuple(st.tiles.shape)} "
          f"(occupied {[g.n_tiles for g in graphs]}), map widths "
          f"{st.c_max} / {st.r_max}", flush=True)
    gen = torch.Generator(dev).manual_seed(3)
    per = [dblp_inputs(gen, n, ds.n_nodes, k, d) for _ in graphs]
    ld, ls, v, g = (torch.stack([x[i] for x in per]) for i in range(4))
    stats = {key: {"err": 0.0} for key in ("fwd", "bwd", "row", "col")}
    for p in (0.0, 0.6):
        seeds = torch.tensor([1234567, 7654321, 2468013], dtype=torch.int32, device=dev)
        meta = fg.FlashMeta(dropout_p=p, seed=seeds)
        print(f"batched, dropout {p}:", flush=True)
        out, lse = fg.flash_fwd_cuda(st, ld, ls, v, meta)
        out_p, lse_p = fg.flash_fwd_plain(st, ld, ls, v, meta)
        torch.cuda.synchronize()
        e = max(check("out", out, out_p, 1e-5, 1e-4), check("lse", lse, lse_p, 1e-5, 1e-4))
        stats["fwd"]["err"] = max(stats["fwd"]["err"], e)
        delta = fg.head_delta(g, out, k)  # (P, 1, K, n)
        args = (st, ld, ls, v, g, lse, delta, meta)
        fused = fg.flash_bwd_cuda(*args)
        row = fg.flash_bwd_row_cuda(*args)
        col = fg.flash_bwd_col_cuda(*args)
        for key, got, want in (("bwd", fused, fg.flash_bwd_plain(*args)),
                               ("row", (row,), (fg.flash_bwd_row_plain(*args),)),
                               ("col", col, fg.flash_bwd_col_plain(*args))):
            for name, a, b in zip(("dld", "dls", "dv") if key == "bwd" else
                                  ("dld",) if key == "row" else ("dls", "dv"), got, want):
                stats[key]["err"] = max(stats[key]["err"],
                                        check(f"{name} ({key})", a, b, 1e-4, 1e-3))
        singles = []
        for i, gp in enumerate(graphs):
            mp = fg.FlashMeta(dropout_p=p, seed=seeds[i:i + 1])
            o1, l1 = fg.flash_fwd_cuda(gp, ld[i], ls[i], v[i], mp)
            a1 = (gp, ld[i], ls[i], v[i], g[i], lse[i], delta[i], mp)
            if not (torch.equal(out[i], o1) and torch.equal(lse[i], l1)):
                fail(f"batched forward path {i} differs from its single-path launch")
            if not (torch.equal(row[i], fg.flash_bwd_row_cuda(*a1))
                    and all(torch.equal(x[i], y) for x, y in zip(col, fg.flash_bwd_col_cuda(*a1)))):
                fail(f"batched sweeps path {i} differ from their single-path launches")
            for name, x, y in zip(("dld", "dls", "dv"), fused, fg.flash_bwd_cuda(*a1)):
                check(f"path {i} {name} (fused) vs single", x[i], y, 1e-4, 1e-3)
            singles.append(a1)
        print(f"  batched forward and sweeps bitwise equal to the {n_p} single-path "
              f"launches", flush=True)
    if not timing:
        return stats
    t = {"fwd": (timed(lambda: fg.flash_fwd_cuda(st, ld, ls, v, meta)),
                 timed(lambda: [fg.flash_fwd_cuda(*a[:4], a[-1]) for a in singles])),
         "bwd": (timed(lambda: fg.flash_bwd_cuda(*args)),
                 timed(lambda: [fg.flash_bwd_cuda(*a) for a in singles])),
         "row": (timed(lambda: fg.flash_bwd_row_cuda(*args)),
                 timed(lambda: [fg.flash_bwd_row_cuda(*a) for a in singles])),
         "col": (timed(lambda: fg.flash_bwd_col_cuda(*args)),
                 timed(lambda: [fg.flash_bwd_col_cuda(*a) for a in singles]))}
    plain = {"fwd": lambda: fg.flash_fwd_plain(st, ld, ls, v, meta),
             "bwd": lambda: fg.flash_bwd_plain(*args),
             "row": lambda: fg.flash_bwd_row_plain(*args),
             "col": lambda: fg.flash_bwd_col_plain(*args)}
    for key, fn in plain.items():
        stats[key]["plain_ms"] = timed(fn, reps=3, host_waits=True)
    torch.cuda.empty_cache()
    stats["fwd"]["library_ms"] = sdpa_yardstick(st, ld, ls, v, k, d)
    per_bounds = [flash_bounds(gp, k, d) for gp in graphs]
    for key, (ms, ms_single) in t.items():
        b = [pb[key] for pb in per_bounds]
        by = "bytes" if sum(x[0] for x in b if x[1] == "bytes") >= sum(
            x[0] for x in b if x[1] != "bytes") else "operations"
        stats[key].update(ms=ms, single_sum_ms=ms_single, bound_ms=sum(x[0] for x in b),
                          bound_by=by)
        print(f"  {key}: batched {ms:.4f} ms, {n_p} single launches {ms_single:.4f} ms, "
              f"bound {stats[key]['bound_ms']:.4f} ms ({by}); dropout 0.6; {card}", flush=True)
    return stats


def check_head_offset(dev, adj, d: int = 8) -> dict:
    """Phase 3f: the kernels under the heads axis, heads of ``d`` (64: two
    chunks a head, delta per chunk). DBLP's largest meta-path
    (with self-loops) cut two ways with 128x128 tiles: on each strip of
    partition_bcsr and each ring cell (s, (s - 1) mod 2) of
    ring_partition_bcsr (its column-block offset not 0), at dropout 0.6,
    the per-rank body of sharded_flash_attention and of the ring on heads
    4-7 of 8 (head_offset = 4, han_tpu's h_off) against heads 4-7 of the
    launch on all 8 heads: forward (out, lse) bitwise (torch.equal), the
    fused backward and both sweeps within atol 1e-4, rtol 1e-3; with v in
    f32 and in bf16 (the backends' bf16 features), where the bf16 launches
    are also held to their plain versions (the f32 tolerances: the plain
    versions widen the same bf16 values). Returns the largest errors per
    kernel."""
    import torch

    from han_tpu_torch.graph.build import with_self_loops
    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.parallel.flash_shard import partition_bcsr
    from han_tpu_torch.parallel.ring_bcsr import ring_partition_bcsr

    a = with_self_loops(adj)
    pg = partition_bcsr(a, 2, bm=128, bn=128).to(dev)
    rg = ring_partition_bcsr(a, 2, bm=128, bn=128).to(dev)
    cells = [(f"shard {s}", pg.strip(s), dict(row_block_offset=pg.row_block_off[s]))
             for s in range(2)]
    cells += [(f"ring cell ({s},{(s - 1) % 2})", rg.cell(s, 1),
               dict(row_block_offset=s * rg.nb_r_loc,
                    col_block_offset=rg.cs_of_step[s][1] * rg.nb_c_loc)) for s in range(2)]
    gen = torch.Generator(dev).manual_seed(4)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    k, h0 = 8, 4
    hi = lambda x: x.view(x.shape[0], k, d)[:, h0:].reshape(x.shape[0], -1).contiguous()
    errs = {"fwd": 0.0, "bwd": 0.0, "row": 0.0, "col": 0.0}
    seed = fg.seed_tensor(97531, dev)
    for (label, graph, off), bf16 in ((c, b) for c in cells for b in (False, True)):
        n_rows, n_cols = graph.nb_r * graph.bm, graph.nb_c * graph.bn
        ld, ls, v, g = rnd(k, n_rows), rnd(k, n_cols), rnd(n_cols, k * d), rnd(n_rows, k * d)
        label = f"{label}, D = {d}"
        if bf16:
            v, label = v.to(torch.bfloat16), f"{label}, bf16 v"
        full = fg.FlashMeta(dropout_p=0.6, seed=seed, **off)
        part = fg.FlashMeta(dropout_p=0.6, seed=seed, head_offset=h0, **off)
        out, lse = fg.flash_fwd_cuda(graph, ld, ls, v, full)
        out4, lse4 = fg.flash_fwd_cuda(graph, ld[h0:].contiguous(), ls[h0:].contiguous(),
                                       hi(v), part)
        torch.cuda.synchronize()
        if not (torch.equal(out4, hi(out)) and torch.equal(lse4, lse[h0:])):
            fail(f"{label}: heads 4-7 at head_offset 4 differ from the 8-head launch's")
        if bf16:
            out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, full)
            errs["fwd"] = max(errs["fwd"], check(f"{label} out vs plain", out, out_p, 1e-5, 1e-4),
                              check(f"{label} lse vs plain", lse, lse_p, 1e-5, 1e-4))
        delta = fg.head_delta(g, out, k)  # (1, K, n)
        args = (graph, ld, ls, v, g, lse, delta, full)
        args4 = (graph, ld[h0:].contiguous(), ls[h0:].contiguous(), hi(v), hi(g),
                 lse[h0:].contiguous(), delta[..., h0:, :].contiguous(), part)
        for key, f in (("bwd", fg.flash_bwd_cuda), ("row", fg.flash_bwd_row_cuda),
                       ("col", fg.flash_bwd_col_cuda)):
            got, want = f(*args4), f(*args)
            if bf16:
                plain = {"bwd": fg.flash_bwd_plain, "row": fg.flash_bwd_row_plain,
                         "col": fg.flash_bwd_col_plain}[key](*args)
                for x, y in zip(*((t if isinstance(t, tuple) else (t,)) for t in (want, plain))):
                    errs[key] = max(errs[key], check(f"{label} {key} vs plain", x, y, 1e-4, 1e-3))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for x, y in zip(got, want):
                y = hi(y) if y.shape[1] == k * d else y[h0:]
                errs[key] = max(errs[key], check(f"{label} {key} heads 4-7", x, y, 1e-4, 1e-3))
        print(f"  {label}: forward at head_offset 4 bitwise equal to heads 4-7 of the 8-head "
              f"launch (dropout 0.6)", flush=True)
    return errs


def head_dim_graph(n: int = 600, seed: int = 4):
    """A small graph for the head-dim checks (128x128 tiles, n_pad 640):
    a dense corner (density 0.3 over rows and columns 0-255), scattered
    edges, rows 300-329 and the whole row block 3 (rows 384-511) without an
    edge, column block 3 (columns 384-511) without a tile, the tile (row
    block 4, column block 0) holding the single edge (520, 5), and the
    padding rows 600-639. Returns (graph, bool mask of the rows that have
    an edge)."""
    import numpy as np

    from han_tpu_torch.graph.bcsr import bcsr_from_coo

    rng = np.random.default_rng(seed)
    corner = np.argwhere(rng.random((256, 256)) < 0.3)
    rows = np.concatenate([corner[:, 0], rng.integers(0, n, 3000)])
    cols = np.concatenate([corner[:, 1], rng.integers(0, n, 3000)])
    drop = (((rows >= 300) & (rows < 330)) | ((rows >= 384) & (rows < 512))
            | ((cols >= 384) & (cols < 512)) | ((rows >= 512) & (cols < 128)))
    rows = np.append(rows[~drop], 520)
    cols = np.append(cols[~drop], 5)
    pairs = np.unique(np.stack([rows, cols], 1), axis=0)
    graph = bcsr_from_coo(pairs[:, 0], pairs[:, 1], n)
    has_edge = np.zeros(graph.n_pad, bool)
    has_edge[pairs[:, 0]] = True
    return graph, has_edge


HEAD_DIMS = (3, 4, 16, 32)  # phase 3d's head dims of one chunk
WIDE_HEAD_DIMS = (33, 40, 64, 121)  # and of several (121: ppi's output width)


def check_head_dims(dev, dims=HEAD_DIMS) -> dict:
    """Phase 3d: the forward, the fused backward and the row and column
    sweeps at each D of ``dims`` (HEAD_DIMS; WIDE_HEAD_DIMS, in chunks of
    an instantiation) (K = 2, head offset 3; D = 3 goes through the
    wrappers' zero padding to 4, D = 33, 40 and 121 pad each head to whole
    chunks) on head_dim_graph, v f32 and bf16,
    dropout 0 and 0.6, against their plain versions with the DBLP check's
    tolerances (forward atol 1e-5, rtol 1e-4; backward atol 1e-4, rtol
    1e-3); rows without an edge must give out = 0 and lse = -1e9 exactly,
    and the split backward (row and column sweeps) must repeat bitwise.
    Returns the largest errors per kernel."""
    import torch

    from han_tpu_torch.ops import flash_gat as fg

    graph, has_edge = head_dim_graph()
    graph = graph.to(dev)
    n, k = graph.n_pad, 2
    edgeless = torch.from_numpy(~has_edge).to(dev)
    print(f"head dims: {graph.n_edges} edges, {graph.n_tiles} tiles of "
          f"{graph.nb_r * graph.nb_c}, {int(edgeless.sum())} rows without an edge", flush=True)
    gen = torch.Generator(dev).manual_seed(5)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    errs = {"fwd": 0.0, "bwd": 0.0, "row": 0.0, "col": 0.0}
    for d in dims:
        ld, ls, v32, g = rnd(k, n), rnd(k, n), rnd(n, k * d), rnd(n, k * d)
        for v in (v32, v32.to(torch.bfloat16)):
            for p in (0.0, 0.6):
                meta = fg.FlashMeta(dropout_p=p, seed=fg.seed_tensor(99, dev), head_offset=3)
                tag = f"D={d} v {str(v.dtype).split('.')[-1]} p={p}"
                out, lse = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
                out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
                torch.cuda.synchronize()
                errs["fwd"] = max(errs["fwd"], check(f"{tag} out", out, out_p, 1e-5, 1e-4),
                                  check(f"{tag} lse", lse, lse_p, 1e-5, 1e-4))
                if not (bool((out[edgeless] == 0).all())
                        and bool((lse[:, edgeless] == -1e9).all())):
                    fail(f"{tag}: a row without an edge does not give out = 0, lse = -1e9")
                args = (graph, ld, ls, v, g, lse, fg.head_delta(g, out, k), meta)
                errs["bwd"] = max(errs["bwd"], *(
                    check(f"{tag} {name}", a, b, 1e-4, 1e-3) for name, a, b in
                    zip(("dld", "dls", "dv"), fg.flash_bwd_cuda(*args), fg.flash_bwd_plain(*args))))
                split = (fg.flash_bwd_row_cuda(*args), *fg.flash_bwd_col_cuda(*args))
                again = (fg.flash_bwd_row_cuda(*args), *fg.flash_bwd_col_cuda(*args))
                errs["row"] = max(errs["row"], check(f"{tag} dld (row sweep)", split[0],
                                                     fg.flash_bwd_row_plain(*args), 1e-4, 1e-3))
                errs["col"] = max(errs["col"], *(
                    check(f"{tag} {name} (column sweep)", a, b, 1e-4, 1e-3) for name, a, b in
                    zip(("dls", "dv"), split[1:], fg.flash_bwd_col_plain(*args))))
                if not all(torch.equal(a, b) for a, b in zip(split, again)):
                    fail(f"{tag}: the split backward differs between two runs")
    return errs


# eager against captured at dropout 0: the fused backward sums dld with
# atomics in a varying order, and the captured step's Adam forms its bias
# correction on the card in float32 (capturable) where the eager one takes it
# on the host in float64, so the trajectories differ in the last bits and
# drift apart as Adam amplifies them (3.7e-6 relative after 10 epochs, NVIDIA
# H100 80GB HBM3, 700.00 W)
CAPTURE_TOL = dict(rtol=1e-4, atol=1e-5)


def profile_trainer(label: str, make, card: str) -> dict:
    """utils/prof.profile_steps of the trainer ``make()`` builds (3 warm-up
    steps: a captured trainer runs the first eagerly and captures on the
    second, so the 9 timed steps and the profiled 5 are replays): median
    step, device time and share, launches a step (kernel launches plus
    graph launches), peak memory since the trainer was built; one line
    with the card."""
    import torch

    from han_tpu_torch.utils.prof import profile_steps

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = make()
    st = profile_steps(lambda: t.train_step()[0], steps=9)
    st["captured"] = t.capture
    print(f"{label}, {'captured' if t.capture else 'eager'}: median step "
          f"{st['median_step_ms']:.4f} ms, device {st['device_ms']:.4f} ms (share "
          f"{st['device_share']:.3f}), launches a step {st['launches']:g} "
          f"({st['kernel_launches']:g} kernels, {st['graph_launches']:g} graphs), "
          f"max_memory_allocated {st['max_memory_allocated']} B; {card}", flush=True)
    del t
    return st


def train_dblp_hid64(ds, dev, card: str, n_mp: int, epochs: int = 10) -> dict:
    """Phase 4l: the dblp preset with model.hid_units=(64,) on
    dblp_synthetic: K = 8 heads of D = 64 (a 512-wide hidden layer), so
    every flash launch runs each head as chunks of an instantiation. run()
    for ``epochs`` epochs, captured: losses finite and falling, launch
    counts exact (as phase 4's). Then ``epochs`` epochs at dropout 0 eager
    and captured, whose losses agree within CAPTURE_TOL, and the step at
    the preset's dropouts profiled captured (median step, device share).
    Returns the run's losses (phase 4b's one-device reference) and
    launches."""
    import numpy as np
    import torch

    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer, run

    def config(dropout=None):
        cfg = preset("dblp")
        cfg.train.epochs, cfg.train.log_file = epochs, ""
        cfg.model.hid_units = (64,)
        if dropout is not None:
            cfg.model.attn_drop = cfg.model.ffd_drop = dropout
        return cfg

    fg.flash_fwd_launches = fg.flash_bwd_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    result = run(config(), ds, device=dev)
    torch.cuda.synchronize()
    n = {"fwd": fg.flash_fwd_launches, "bwd": fg.flash_bwd_launches}
    losses = result["epoch_train_loss"]
    if not result["captured"] or len(losses) != epochs or not all(np.isfinite(losses)):
        fail(f"dblp hid 64: captured {result['captured']}, losses {losses}")
    if not (losses[-1] < losses[0] and np.isfinite(result["test_loss"])):
        fail(f"dblp hid 64: losses {losses[0]} -> {losses[-1]}, test {result['test_loss']}")
    want = {"fwd": n_mp * (2 * epochs + 1), "bwd": n_mp * epochs}
    if n != want:
        fail(f"dblp hid 64: launches {n}, want {want}")
    print(f"dblp hid 64 (captured): losses {losses[0]:.5f} -> {losses[-1]:.5f}, test_acc "
          f"{result['test_acc']:.4f}; launches {n}; median step epochs 2-{epochs} "
          f"{statistics.median(result['epoch_step_time_s'][1:]) * 1e3:.4f} ms, "
          f"max_memory_allocated {result['max_memory_allocated']} B; {card}", flush=True)
    fits = {name: Trainer(ds, config(0.0), device=dev, logger=MetricLogger(echo=False),
                          capture=capture).fit()
            for name, capture in (("eager", False), ("captured", None))}
    eager, cap = (fits[k]["epoch_train_loss"] for k in ("eager", "captured"))
    if not fits["captured"]["captured"] or not np.allclose(cap, eager, **CAPTURE_TOL):
        fail(f"dblp hid 64 at dropout 0: captured {cap}, eager {eager}")
    print(f"dblp hid 64 at dropout 0, {epochs} epochs: captured losses within {CAPTURE_TOL} "
          f"of eager (largest relative difference "
          f"{max(abs(a - b) / abs(b) for a, b in zip(cap, eager)):.3e})", flush=True)
    st = profile_trainer("dblp hid 64 step (dropout 0.6)", lambda: Trainer(
        ds, config(), device=dev, logger=MetricLogger(echo=False)), card)
    flash = [op for op in st["top_device_ops"] if FLASH_KERNEL.search(op[0])]
    flash_ms = sum(ms for _, ms, _ in flash)
    print(f"dblp hid 64 step: the flash kernels {flash_ms:.4f} ms of {st['device_ms']:.4f} ms "
          f"of device time a step (share {flash_ms / st['device_ms']:.3f}); top device ops "
          f"(ms, calls a step): " + "; ".join(f"{key} {ms:.4f} x{calls:g}" for key, ms, calls
                                              in st["top_device_ops"]) + f"; {card}", flush=True)
    if not flash:
        fail("dblp hid 64 step: no flash kernel among the profile's top device ops")
    return {"losses": losses, "launches": n}


# a flash kernel's name in a profile (not ell_fused_fwd_kernel)
FLASH_KERNEL = re.compile(r"(?<![A-Za-z_])(fwd|bwd_col|bwd_row)_kernel")

VMAP_TOL = dict(rtol=1e-5)  # stacked against sequential towers at dropout 0


def train_vmap_towers(ds, dev, card: str, epochs: int = 10) -> dict:
    """Phase 4j: HAN(vmap_towers=True), the meta-path towers stacked. At
    dropout 0, the logits and the first step's gradients of the stacked
    model against the sequential HAN fed the same weights
    (nn/convert.py:stack_towers), through the batched and the single-path
    flash kernels: rtol 1e-5 (VMAP_TOL; atol 1e-5 of each tensor's largest
    value: the fused backward's atomics). Then the dblp preset with
    vmap_towers through run(), captured, for ``epochs`` epochs: the loss
    falls, and a train step takes one forward and one fused backward
    launch for the three meta-paths (one forward an eval). The step
    profiled captured beside the sequential one's. Returns the losses and
    launches."""
    import numpy as np
    import torch

    from han_tpu_torch.graph.build import metapath_to_bcsr
    from han_tpu_torch.graph.stack import stack_graphs
    from han_tpu_torch.nn.convert import stack_towers
    from han_tpu_torch.nn.losses import l2_regularizer, masked_softmax_cross_entropy
    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer, build_model, run

    cfg = preset("dblp")
    cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
    seq = build_model(ds, cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    cfg.model.vmap_towers = True
    vm = build_model(ds, cfg, generator=torch.Generator().manual_seed(1)).to(dev)
    vm.load_state_dict(stack_towers(seq.state_dict()))
    graphs = [metapath_to_bcsr(a).to(dev) for a in ds.metapath_adjs]
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    outs = {}
    for name, model, g, xs in (("sequential", seq, graphs, [x] * len(graphs)),
                               ("stacked", vm, stack_graphs(graphs), torch.stack([x] * len(graphs)))):
        logits = model(g, xs)[0]
        loss = (masked_softmax_cross_entropy(logits, labels, mask)
                + l2_regularizer(model.parameters(), cfg.train.l2_coef))
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        outs[name] = (logits.detach(), stack_towers(grads) if name == "sequential" else grads)
    torch.cuda.synchronize()
    check("vmap_towers logits vs sequential", outs["stacked"][0], outs["sequential"][0],
          1e-5 * float(outs["sequential"][0].abs().max()), **VMAP_TOL)
    err = max(check(f"vmap_towers grad {k}", outs["stacked"][1][k], want,
                    1e-5 * float(want.abs().max()), **VMAP_TOL)
              for k, want in outs["sequential"][1].items())
    print(f"vmap_towers at dropout 0: logits and first-step gradients of all "
          f"{len(outs['stacked'][1])} parameters within rtol 1e-5 of the sequential HAN "
          f"(largest gradient error {err:.3e})", flush=True)
    del seq, vm, outs

    cfg = preset("dblp")
    cfg.train.epochs = epochs
    cfg.model.vmap_towers = True
    fg.flash_fwd_launches = fg.flash_bwd_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    result = run(cfg, ds, device=dev)
    torch.cuda.synchronize()
    fwd_n, bwd_n = fg.flash_fwd_launches, fg.flash_bwd_launches
    losses = result["epoch_train_loss"]
    if not result["captured"] or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"vmap_towers dblp: captured {result['captured']}, losses {losses}")
    if fwd_n != 2 * epochs + 1 or bwd_n != epochs:
        fail(f"vmap_towers dblp: launches fwd {fwd_n} (want {2 * epochs + 1}), bwd {bwd_n} "
             f"(want {epochs})")
    print(f"vmap_towers dblp (captured): losses {losses[0]:.5f} -> {losses[-1]:.5f}, test_acc "
          f"{result['test_acc']:.4f}; launches fwd {fwd_n} bwd {bwd_n} = 1 fwd + 1 bwd per "
          f"train step for {len(ds.metapath_adjs)} meta-paths; median step epochs 2-{epochs} "
          f"{statistics.median(result['epoch_step_time_s'][1:]) * 1e3:.4f} ms, "
          f"max_memory_allocated {result['max_memory_allocated']} B; {card}", flush=True)

    def trainer(vmap):
        c = preset("dblp")
        c.train.log_file, c.model.vmap_towers = "", vmap
        return Trainer(ds, c, device=dev, logger=MetricLogger(echo=False))

    prof = {name: profile_trainer(f"dblp step, {name} towers (dropout 0.6)",
                                  lambda v=vmap: trainer(v), card)
            for name, vmap in (("stacked", True), ("sequential", False))}
    return {"losses": losses, "launches": {"fwd": fwd_n, "bwd": bwd_n}, "profile": prof,
            "err": err}


def check_dblp_capture(ds, dev, card: str) -> list:
    """Phase 4f: the dblp preset's captured step against its eager one.
    The flash kernels' seed buffers (the tensors draw_seed returned during
    the capture, read after each replay) hold new seeds at every replay;
    each step profiled captured and eager at the preset's dropouts 0.6;
    then, at dropout 0, 10 epochs of fit() eager, captured, and captured
    with Adam(fused=True), whose loss trajectories agree within
    CAPTURE_TOL, their medians of epochs 2-10 and device time a step.
    Returns the eager dropout-0 losses (phase 4b's one-device reference
    for the csr backends)."""
    import numpy as np
    import torch

    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer
    from han_tpu_torch.utils.prof import profile_steps

    def trainer(capture, dropout=None, epochs=10):
        cfg = preset("dblp")
        cfg.train.epochs, cfg.train.log_file = epochs, ""
        if dropout is not None:
            cfg.model.attn_drop = cfg.model.ffd_drop = dropout
        return Trainer(ds, cfg, device=dev, logger=MetricLogger(echo=False), capture=capture)

    drawn = []
    draw = fg.draw_seed

    def recording(p, gen):
        seed = draw(p, gen)
        if isinstance(seed, torch.Tensor):
            drawn.append(seed)
        return seed

    t = trainer(None)
    fg.draw_seed = recording
    try:
        reads = []
        for call in range(4):  # eager, capture + replay, replay, replay
            float(t.train_step()[0])
            if call:
                reads.append([int(x) for x in drawn[3:6]])
    finally:
        fg.draw_seed = draw
    if len(drawn) != 6 or t._train.replays != 3:
        fail(f"flash seeds: {len(drawn)} drawn, {t._train.replays} replays (want 6, 3)")
    for a, b in zip(reads, reads[1:]):
        if any(x == y for x, y in zip(a, b)):
            fail(f"a flash seed buffer holds the same seed over two replays: {reads}")
    print(f"dblp captured: the flash seed buffers after replays 1-3: {reads} (each new)",
          flush=True)
    del t
    for capture in (None, False):
        profile_trainer("dblp step (dropout 0.6)", lambda: trainer(capture), card)

    # eager, captured, and captured with Adam's fused kernel (a lever the
    # trainer does not take: timed here, its numerics held to the others)
    fits = {}
    for name, capture in (("eager", False), ("captured", None), ("captured, fused Adam", None)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = trainer(capture, dropout=0.0)
        if name.endswith("fused Adam"):
            t.opt = torch.optim.Adam(t.model.parameters(), lr=t.cfg.train.lr, capturable=True,
                                     fused=True)
        fits[name] = t.fit()
        fits[name]["device_ms"] = profile_steps(lambda: t.train_step()[0], steps=3)["device_ms"]
        del t
    eager = fits["eager"]["epoch_train_loss"]
    for name in ("captured", "captured, fused Adam"):
        got = fits[name]["epoch_train_loss"]
        if not fits[name]["captured"] or not np.allclose(got, eager, **CAPTURE_TOL):
            fail(f"dblp at dropout 0: {name} losses {got} against eager {eager}")
        print(f"dblp at dropout 0, 10 epochs, {name}: losses within {CAPTURE_TOL} of eager "
              f"(largest relative difference "
              f"{max(abs(a - b) / abs(a) for a, b in zip(eager, got)):.3e})", flush=True)
    for name, r in fits.items():
        print(f"dblp at dropout 0, {name}: median step epochs 2-10 "
              f"{statistics.median(r['epoch_step_time_s'][1:]) * 1e3:.4f} ms, device "
              f"{r['device_ms']:.4f} ms a step (profiled after the fit), max_memory_allocated "
              f"{r['max_memory_allocated']} B; {card}", flush=True)
    return eager


class TripAt:
    """A preemption guard that reads as tripped from its ``n``-th poll on
    (the sampled trainer polls once a dispatch)."""

    def __init__(self, n: int):
        self.left = n

    @property
    def triggered(self) -> bool:
        self.left -= 1
        return self.left <= 0


def dblp_resume(ds, dev, epochs: int = 10, preempt_after: int = 4, score: bool = False) -> dict:
    """Phase 4g's runs: the dblp preset (dropout 0.6, captured) for
    ``epochs`` epochs with checkpoint_every=1, uninterrupted; again,
    preempted after epoch ``preempt_after`` (guard.trip() from the logger);
    then resumed in a fresh Trainer. Per run and epoch: the train loss, the
    flash seeds (the values of the seed tensors draw_seed returned, read
    after the epoch's train step: a replay rewrites the captured ones) and
    the dropout generator's state; then the best epoch, the test metrics,
    the time, the peak memory and the flash launches of all three runs.
    ``score``: KMeans with the silhouette on the resumed run's test
    embedding (after the launches are read)."""
    import tempfile

    import torch

    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.eval_embed import kmeans_eval
    from han_tpu_torch.train.preempt import PreemptionGuard
    from han_tpu_torch.train.trainer import MetricLogger, Trainer, training_state

    n_mp = len(ds.metapath_adjs)
    counters = {"fwd": "flash_fwd_launches", "bwd": "flash_bwd_launches",
                "row": "flash_bwd_row_launches", "col": "flash_bwd_col_launches"}
    drawn = []
    draw = fg.draw_seed

    def recording(p, gen):
        seed = draw(p, gen)
        if isinstance(seed, torch.Tensor):
            drawn.append(seed)
        return seed

    class Recorder(MetricLogger):
        def __init__(self, guard=None):
            super().__init__("", echo=False)
            self.guard, self.gen = guard, None
            self.seeds, self.states, self.losses = {}, {}, {}

        def log(self, rec):
            if "train_loss" in rec:
                e = rec["epoch"]
                self.seeds[e] = [int(x) for x in drawn[-n_mp:]]
                self.states[e] = self.gen.get_state().tolist()
                self.losses[e] = rec["train_loss"]
                if self.guard is not None and e == preempt_after:
                    self.guard.trip()

    out = {}
    for attr in counters.values():
        setattr(fg, attr, 0)
    fg.draw_seed = recording
    try:
        with tempfile.TemporaryDirectory() as root:
            for name, tag, resume in (("uninterrupted", "a", False), ("preempted", "b", False),
                                      ("resumed", "b", True)):
                cfg = preset("dblp")
                cfg.train.epochs, cfg.train.log_file = epochs, ""
                cfg.train.checkpoint_every, cfg.train.checkpoint_dir = 1, f"{root}/{tag}"
                guard = PreemptionGuard(install=False) if name == "preempted" else None
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                log = Recorder(guard)
                t = Trainer(ds, cfg, device=dev, logger=log, guard=guard)
                log.gen = t.rngs.device
                r = t.fit(resume=resume)
                torch.cuda.synchronize()
                out[name] = {
                    "seeds": log.seeds, "states": log.states, "losses": log.losses,
                    "s": time.perf_counter() - t0, "captured": t.capture,
                    "preempted": r.get("preempted", False),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    **{k: r[k] for k in ("best_epoch", "test_loss", "test_acc") if k in r}}
                if name == "preempted":
                    out[name]["saved_state"] = t.restore_latest()["rng"].tolist()
                if name == "uninterrupted":  # one save's cost: state to file, renamed
                    store, times = t.checkpoints(), []
                    for i in range(5):
                        t0 = time.perf_counter()
                        store.save(1000 + i, training_state(t.model, t.opt, t.rngs.device))
                        times.append(time.perf_counter() - t0)
                    out["save_ms"] = statistics.median(times) * 1e3
                    out["save_bytes"] = (store.path / "1000.pt").stat().st_size
    finally:
        fg.draw_seed = draw
    out["launches"] = {k: getattr(fg, v) for k, v in counters.items()}
    if score:
        _, _, _, embed = t.eval_step(t.masks["test"])
        test = t.masks["test"]
        t0 = time.perf_counter()
        out["kmeans"] = kmeans_eval(embed[test], t.labels[test], seed=cfg.train.seed,
                                    with_silhouette=True)
        out["kmeans"]["s"] = time.perf_counter() - t0
        out["kmeans"]["n"] = int(test.sum())
    return out


def check_dblp_resume(res: dict, tol: dict, label: str, n_mp: int, epochs: int = 10,
                      preempt_after: int = 4) -> None:
    """Phase 4g's checks: the resumed epochs draw the uninterrupted run's
    flash seeds (equal) from the same generator states (equal: the state
    read after replay k is the one the eager epoch k + 1 continues from),
    and their losses agree within ``tol``; the same best epoch and test
    metrics; the launch counts exact."""
    import numpy as np

    a, b, c = res["uninterrupted"], res["preempted"], res["resumed"]
    rest = list(range(preempt_after + 1, epochs))
    if not (a["captured"] and c["captured"] and b["preempted"]) or sorted(c["losses"]) != rest:
        fail(f"{label}: captured {a['captured']}/{c['captured']}, preempted {b['preempted']}, "
             f"resumed epochs {sorted(c['losses'])} (want {rest})")
    if b["saved_state"] != b["states"][preempt_after]:
        fail(f"{label}: the checkpoint's generator state is not the one read after epoch "
             f"{preempt_after}")
    for e in rest:
        if c["seeds"][e] != a["seeds"][e] or c["states"][e] != a["states"][e]:
            fail(f"{label}: epoch {e} drew seeds {c['seeds'][e]} (state {c['states'][e]}), "
                 f"the uninterrupted run {a['seeds'][e]} (state {a['states'][e]})")
    for e in range(preempt_after + 1):
        if b["seeds"][e] != a["seeds"][e]:
            fail(f"{label}: the preempted run's epoch {e} drew other seeds than the first run")
    la, lc = [a["losses"][e] for e in rest], [c["losses"][e] for e in rest]
    if not np.allclose(lc, la, **tol):
        fail(f"{label}: resumed losses {lc} against uninterrupted {la} (tolerance {tol})")
    if (c["best_epoch"] != a["best_epoch"]
            or not np.allclose([c["test_loss"], c["test_acc"]], [a["test_loss"], a["test_acc"]],
                               **tol)):
        fail(f"{label}: resumed best_epoch {c['best_epoch']}, test {c['test_loss']} / "
             f"{c['test_acc']}; uninterrupted {a['best_epoch']}, {a['test_loss']} / "
             f"{a['test_acc']}")
    steps = 2 * epochs  # train steps of the three runs; the preempted run skips its test
    want = {"fwd": n_mp * (2 * steps + 2), "bwd": n_mp * steps, "row": 0, "col": 0}
    if "deterministic" in label:
        want.update(bwd=0, row=n_mp * steps, col=n_mp * steps)
    if res["launches"] != want:
        fail(f"{label}: launches {res['launches']}, want {want}")
    print(f"{label}: preempted after epoch {preempt_after}, resumed in a fresh Trainer "
          f"(captured): the flash seeds and generator states of epochs {rest[0]}-{rest[-1]} "
          f"equal the uninterrupted run's (seeds epoch {rest[0]}: {c['seeds'][rest[0]]}); "
          f"losses {'bitwise equal' if la == lc else 'NOT bitwise equal'} (largest relative "
          f"difference {max(abs(x - y) / abs(x) for x, y in zip(la, lc)):.3e}, tolerance "
          f"{tol}); best_epoch {c['best_epoch']}, test_acc {c['test_acc']:.4f}; launches "
          f"{res['launches']}", flush=True)
    print(f"{label}: wall time uninterrupted {a['s']:.3f} s, preempted {b['s']:.3f} s, "
          f"resumed {c['s']:.3f} s (trainer build and test scoring included); one checkpoint "
          f"save {res['save_ms']:.3f} ms (median of 5, {res['save_bytes']} B); "
          f"max_memory_allocated {a['max_memory_allocated']} / {b['max_memory_allocated']} / "
          f"{c['max_memory_allocated']} B", flush=True)


def train_han_shared(ds, dev, n_mp: int, card: str) -> dict:
    """Phase 4h: the dblp preset with arch="han_shared" (one feature tensor
    for every tower) for 3 epochs through run(), captured, through flash:
    launch counts exact; its step profiled captured (profile_trainer). Then
    at dropout 0 and the same weights, HANShared
    through flash against HANShared through csr (rtol 1e-4, atol 1e-5: the
    f32 accumulation order); with return_coefs through csr, each APTPA
    row's coefficients sum to 1 (1e-5) and edge_attention_coefs, head by
    head, agrees with them (1e-6). Returns the run's flash launches."""
    import numpy as np
    import torch

    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.ops.attention import edge_attention_coefs
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer, build_graphs, build_model, run

    cfg = preset("dblp")
    cfg.model.arch = "han_shared"
    cfg.train.epochs = 3
    fg.flash_fwd_launches = fg.flash_bwd_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = run(cfg, ds, device=dev)
    torch.cuda.synchronize()
    n = {"fwd": fg.flash_fwd_launches, "bwd": fg.flash_bwd_launches}
    losses = result["epoch_train_loss"]
    want = {"fwd": n_mp * (2 * 3 + 1), "bwd": n_mp * 3}
    if (len(losses) != 3 or not all(np.isfinite(losses)) or not np.isfinite(result["test_loss"])
            or n != want or not result["captured"]):
        fail(f"han_shared: losses {losses}, test {result['test_loss']}, launches {n} (want "
             f"{want}), captured {result['captured']}")
    print(f"han_shared (dblp preset, 3 epochs, captured, flash): losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}, test_acc {result['test_acc']:.4f}; "
          f"launches {n}; max_memory_allocated {result['max_memory_allocated']} B; {card}",
          flush=True)
    profile_trainer("dblp han_shared step (dropout 0.6)", lambda: Trainer(
        ds, cfg, device=dev, logger=MetricLogger(echo=False)), card)

    cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
    flash = build_model(ds, cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    flash_graphs = build_graphs(ds, cfg, dev)
    cfg.data.graph_format, cfg.model.impl = "csr", "csr"
    csr = build_model(ds, cfg).to(dev)
    csr.load_state_dict(flash.state_dict())
    csr_graphs = build_graphs(ds, cfg, dev)
    x = torch.from_numpy(ds.features).to(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        got = flash(flash_graphs, x)[0]
        csr.return_coefs = True
        want_logits, _, _, coefs = csr(csr_graphs, x)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    err = float((got - want_logits).abs().max())
    if not torch.allclose(got, want_logits, rtol=1e-4, atol=1e-5):
        fail(f"han_shared: flash logits against csr, largest difference {err}")
    p = ds.metapath_names.index("APTPA")
    g = csr_graphs[p]
    rows = g.row_idx[: g.n_edges]
    sums = torch.zeros(ds.n_nodes, device=dev).index_add_(0, rows, coefs[p][: g.n_edges])
    sum_err = float((sums - 1).abs().max())
    layer = csr.towers[p].layers[0]
    with torch.no_grad():
        fts = torch.einsum("nf,fkd->nkd", x, layer.kernel)
        ld = torch.einsum("nkd,kd->nk", fts, layer.attn_dst_kernel) + layer.attn_dst_bias
        ls = torch.einsum("nkd,kd->nk", fts, layer.attn_src_kernel) + layer.attn_src_bias
        by_head = edge_attention_coefs(g, ld, ls, slope=layer.slope).mean(dim=-1)
    coef_err = float((by_head - coefs[p]).abs().max())
    if sum_err > 1e-5 or coef_err > 1e-6:
        fail(f"han_shared APTPA coefficients: row sums off 1 by {sum_err}, "
             f"edge_attention_coefs off by {coef_err}")
    print(f"han_shared at dropout 0: flash logits against csr within rtol 1e-4 (largest "
          f"difference {err:.3e}); APTPA ({g.n_edges} edges) coefficients through csr: rows "
          f"sum to 1 within {sum_err:.3e}, edge_attention_coefs within {coef_err:.3e}; both "
          f"forwards and coefficients {t_fwd:.3f} s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; {card}", flush=True)
    return n


def check_entry(dev, card: str) -> None:
    """Phase 4i: han_tpu_torch.entry.entry() gives finite logits of shape
    (3025, 3) on the card."""
    import torch

    from han_tpu_torch.entry import entry

    t0 = time.perf_counter()
    forward, args = entry(dev)
    logits = forward(*args)
    torch.cuda.synchronize()
    if tuple(logits.shape) != (3025, 3) or logits.device.type != "cuda" or not bool(
            torch.isfinite(logits).all()):
        fail(f"entry(): logits {tuple(logits.shape)} on {logits.device}")
    print(f"entry(): logits {tuple(logits.shape)} {logits.dtype} on {logits.device}, "
          f"{time.perf_counter() - t0:.3f} s (dataset and graphs built); {card}", flush=True)


# phase 4b's runs: (label, graph_format, deterministic mode, dropout (None:
# the preset's 0.6), vmap_towers, hid_units)
MESH_RUNS = (("partitioned_bcsr", "partitioned_bcsr", False, None, False, (8,)),
             ("ring_bcsr", "ring_bcsr", True, None, False, (8,)),
             ("csr", "partitioned", False, 0.0, False, (8,)),
             ("ring", "ring", False, 0.0, False, (8,)),
             ("partitioned_bcsr stacked", "partitioned_bcsr", True, None, True, (8,)),
             ("partitioned_bcsr hid 64", "partitioned_bcsr", False, None, False, (64,)),
             ("ring_bcsr hid 64", "ring_bcsr", True, None, False, (64,)))


def mesh_train_rank(epochs: int) -> dict:
    """One rank of phase 4b: the dblp preset through run() with
    graph_format partitioned_bcsr, ring_bcsr under deterministic mode, csr
    (PartitionedCSR) and ring (PartitionedCSR2D) at dropout 0,
    partitioned_bcsr with vmap_towers under deterministic mode (the stacked
    PartitionedBCSR: its strips in one batched launch of the forward and of
    each sweep; mp axis 1), and partitioned_bcsr and ring_bcsr
    (deterministic) again at hid_units=(64,) (heads in chunks); each run's
    losses, whether it was captured
    (it is where the mesh's axes hold no process group: one rank), step
    time, memory and launch counts (MESH_RUNS). Then, on this
    rank's card alone (bcsr), deterministic mode at dropout 0: the split
    backward captured twice and run eagerly once, for whether the captured
    step repeats bitwise; and dblp_resume (phase 4g) in deterministic
    mode."""
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
    for label, fmt, deterministic, dropout, vmap, hid in MESH_RUNS:
        cfg = preset("dblp")
        cfg.train.epochs = epochs
        cfg.data.graph_format = fmt
        cfg.mesh.graph_axis = dist.get_world_size()
        cfg.model.vmap_towers = vmap
        cfg.model.hid_units = hid
        if dropout is not None:
            cfg.model.attn_drop = cfg.model.ffd_drop = dropout
        torch.cuda.reset_peak_memory_stats()
        for attr in counters.values():
            setattr(fg, attr, 0)
        torch.use_deterministic_algorithms(deterministic)
        try:
            result = run(cfg, ds)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        out[label] = {"losses": result["epoch_train_loss"], "test_loss": result["test_loss"],
                      "captured": result["captured"],
                      "median_step_ms": statistics.median(result["epoch_step_time_s"][1:]) * 1e3,
                      "max_memory_allocated": result["max_memory_allocated"],
                      "launches": {k: getattr(fg, v) for k, v in counters.items()}}
    from han_tpu_torch.train.trainer import MetricLogger, Trainer

    for name, capture in (("captured", None), ("captured again", None), ("eager", False)):
        cfg = preset("dblp")
        cfg.train.epochs, cfg.train.log_file = epochs, ""
        cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
        for attr in counters.values():
            setattr(fg, attr, 0)
        torch.use_deterministic_algorithms(True)
        try:
            result = Trainer(ds, cfg, logger=MetricLogger(echo=False), capture=capture).fit()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        out[f"deterministic {name}"] = {
            "losses": result["epoch_train_loss"], "captured": result["captured"],
            "median_step_ms": statistics.median(result["epoch_step_time_s"][1:]) * 1e3,
            "launches": {k: getattr(fg, v) for k, v in counters.items()}}
    # phase 4g in deterministic mode (the split backward)
    torch.use_deterministic_algorithms(True)
    try:
        out["resume deterministic"] = dblp_resume(
            ds, torch.device("cuda", torch.cuda.current_device()))
    finally:
        torch.use_deterministic_algorithms(False)
    return out


# phase 4b's median eager steps on one NCCL rank, measured by this script
# before the mesh steps were captured (NVIDIA H100 80GB HBM3, 700.00 W)
MESH_EAGER_MS = {"partitioned_bcsr": 13.210, "ring_bcsr": 14.653, "csr": 52.826,
                 "ring": 78.774, "partitioned_bcsr stacked": 7.752}


def train_multi_device(want_losses, want_dropout0, want_stacked, want_hid64, epochs: int,
                       n_mp: int) -> dict:
    """Phase 4b: mesh_train_rank in a world of one NCCL rank per card. Each
    run's losses must match its one-device run's (rtol 2e-4, atol 2e-5):
    the flash runs the dblp preset's (dropout 0.6: the dropout keys are
    global, so the masks replay), the hid-64 ones phase 4l's, the stacked
    one the vmap_towers run's
    (phase 4j), the csr and ring runs the eager dropout-0 run's (phase 4f:
    their dropout streams are their own). The launch counts are exact: per
    rank and epoch, the forward on every train and eval pass (S steps a
    pass on the ring; one batched launch a pass when stacked), the fused
    backward on the partitioned run, the split pair and no fused backward
    on the deterministic runs, no flash kernel on the csr runs (a replay
    adds its capture's launches). On one card the world has one rank, its
    axes no process group, and every run must be captured; each captured
    median step is printed beside its eager one before capture
    (MESH_EAGER_MS).
    CUBLAS_WORKSPACE_CONFIG, which deterministic mode needs, is set in the
    ranks only, so the phases in this process keep their numbers."""
    import numpy as np
    import torch

    from han_tpu_torch.parallel.launch import spawn

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    res = spawn(mesh_train_rank, world, "nccl", args=(epochs,),
                env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})[0]
    print(f"multi-device: {world} NCCL rank(s), {len(MESH_RUNS)} runs in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    passes = n_mp * (2 * epochs + 1)
    none = {"fwd": 0, "bwd": 0, "row": 0, "col": 0}
    want = {"partitioned_bcsr": {"fwd": passes, "bwd": n_mp * epochs, "row": 0, "col": 0},
            "ring_bcsr": {"fwd": world * passes, "bwd": 0, "row": world * n_mp * epochs,
                          "col": world * n_mp * epochs},
            "csr": none, "ring": none,
            "partitioned_bcsr stacked": {"fwd": 2 * epochs + 1, "bwd": 0, "row": epochs,
                                         "col": epochs}}
    want["partitioned_bcsr hid 64"] = want["partitioned_bcsr"]
    want["ring_bcsr hid 64"] = want["ring_bcsr"]
    reference = {"partitioned_bcsr": want_losses, "ring_bcsr": want_losses,
                 "csr": want_dropout0, "ring": want_dropout0,
                 "partitioned_bcsr stacked": want_stacked,
                 "partitioned_bcsr hid 64": want_hid64, "ring_bcsr hid 64": want_hid64}
    det = {name: res.pop(f"deterministic {name}")
           for name in ("captured", "captured again", "eager")}
    det_resume = res.pop("resume deterministic")
    for fmt, run in res.items():
        got, ref = run["losses"], reference[fmt]
        if not np.allclose(got, ref, rtol=2e-4, atol=2e-5):
            fail(f"{fmt}: losses {got} do not match the one-device run {ref}")
        if run["launches"] != want[fmt]:
            fail(f"{fmt}: launches {run['launches']}, want {want[fmt]}")
        if run["captured"] != (world == 1):
            fail(f"{fmt}: captured {run['captured']} on a world of {world} rank(s) (a mesh "
                 "captures where its axes hold no process group)")
        dev = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
        det_mode = any(r[0] == fmt and r[2] for r in MESH_RUNS)
        print(f"{fmt} (graph axis {world}{', deterministic' if det_mode else ''}): "
              f"losses {got[0]:.5f} -> {got[-1]:.5f}, largest relative difference from the "
              f"one-device run {dev:.3e}; launches {run['launches']}; median step "
              f"{run['median_step_ms']:.3f} ms {'captured' if run['captured'] else 'eager'} "
              f"(eager {MESH_EAGER_MS.get(fmt, 'not measured')} ms before capture), "
              f"max_memory_allocated {run['max_memory_allocated']} B", flush=True)
    split = {"fwd": passes, "bwd": 0, "row": n_mp * epochs, "col": n_mp * epochs}
    for name, run in det.items():
        if run["captured"] != (name != "eager") or run["launches"] != split:
            fail(f"deterministic {name}: captured {run['captured']}, launches "
                 f"{run['launches']} (want {split})")
    cap, again, eager = (det[k]["losses"] for k in ("captured", "captured again", "eager"))
    if not np.allclose(cap, eager, **CAPTURE_TOL):
        fail(f"deterministic dblp at dropout 0: captured {cap}, eager {eager}")
    print(f"deterministic dblp at dropout 0 (split backward, one card): two captured runs "
          f"{'bitwise equal' if cap == again else 'NOT bitwise equal'} (largest difference "
          f"{max(abs(a - b) for a, b in zip(cap, again)):.3e}); captured against eager: "
          f"largest relative difference {max(abs(a - b) / abs(b) for a, b in zip(cap, eager)):.3e} "
          f"(capturable Adam); median step captured {det['captured']['median_step_ms']:.4f} ms, "
          f"eager {det['eager']['median_step_ms']:.4f} ms; launches {split}", flush=True)
    check_dblp_resume(det_resume, DETERMINISTIC_RESUME_TOL,
                      "dblp resume (deterministic, split backward, one card)", n_mp)
    res["resume deterministic"] = det_resume["launches"]
    return res


# deterministic mode: the resumed run's first epoch runs eagerly where the
# uninterrupted run replays its graph, on the same kernels in the same order
DETERMINISTIC_RESUME_TOL = dict(rtol=1e-6, atol=0.0)


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


# (rows, fanout F, seed rows with slots, heads K, head dim D) of the ell_fused
# checks: the sampled block, a large odd fanout, D = 3, and K·D = 256
ELL_SHAPES = ((8704, 16, 512, 8, 8), (16384, 101, 2048, 8, 8), (4096, 16, 512, 8, 3),
              (4096, 16, 512, 8, 32))


# bf16 features: the kernel and its plain version sum the same f32 products
# in different orders (1e-6 apart) and round the sum to bf16 once, so an
# output may land one bf16 step (2^-8 of the value, at most 2^-7 relative)
# apart; the f32 tolerance below it
ELL_BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)


def check_ell_fused(dev, shapes=ELL_SHAPES, dtype: str = "float32") -> dict:
    """Phases 5-6 (float32) and 3g (bfloat16 features): the ell_fused
    kernel against its plain version (f32 atol 1e-5, rtol 1e-4; bf16
    ELL_BF16_TOL), one keep mask for both, with dropout 0 and 0.6, at
    ``shapes``: the sampled block's shape (8,704 rows: 512 seed rows with up
    to 16 valid slots, the rest edgeless, as in a one-hop block; K = 8, D =
    8), a large odd fanout (F = 101, as in exact eval), D = 3 and K·D = 256;
    rows without a valid slot must give exactly 0 and the output comes in
    the features' dtype. First (float32), a fanout whose per-warp buffers
    outgrow a block must raise NotImplementedError. Device times
    (``timed``) at the block shape, and the bound there (the features at
    their dtype's bytes). There the plain-torch backward is held on the
    card against the same backward on the CPU (the card's index_add_ sums
    with atomics in a varying order; bf16 d_fts within ELL_BF16_TOL)."""
    import torch

    from han_tpu_torch.ops import ell_fused as ef

    gen = torch.Generator(dev).manual_seed(1)
    dt = getattr(torch, dtype)
    tol = ELL_BF16_TOL if dt == torch.bfloat16 else dict(atol=1e-5, rtol=1e-4)

    def block(n, f, n_seed, k, d):
        nbr = torch.full((n, f), n, dtype=torch.int32, device=dev)
        real = torch.randint(0, n, (n_seed, f), generator=gen, device=dev,
                             dtype=torch.int32)
        empty = torch.rand((n_seed, f), generator=gen, device=dev) < 0.1
        nbr[:n_seed] = torch.where(empty, n, real)
        nbr[3] = n  # a seed row with no valid slot
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
        return nbr, rnd(n, k), rnd(n, k), rnd(n, k * d).to(dt)

    if dt == torch.float32:
        # fanout x heads past a block's shared memory: NotImplementedError,
        # and no error left behind for the launches below
        z = torch.zeros((4, 8), device=dev)
        try:
            ef.ell_fused_fwd_cuda(torch.zeros((4, 2000), dtype=torch.int32, device=dev), z, z,
                                  z, None, 0.2, 0.0)
            fail("ell_fused took fanout 2000 x 8 heads, past a block's shared memory")
        except NotImplementedError as e:
            print(f"ell_fused, fanout 2000 x 8 heads: {e}", flush=True)
    out = {"err": 0.0, "ms_by_dropout": {}}
    for i, (n, f, n_seed, k, d) in enumerate(shapes):
        nbr, ld, ls, fts = block(n, f, n_seed, k, d)
        for p in (0.0, 0.6):
            keep = ef.draw_keep(n, f, k, p, gen, dev) if p else None
            print(f"ell_fused {n} x F={f}, K={k}, D={d}, {n_seed} rows with slots, "
                  f"{dtype} features, dropout {p}:", flush=True)
            got = ef.ell_fused_fwd_cuda(nbr, ld, ls, fts, keep, 0.2, p)
            want = ef.ell_fused_fwd_plain(nbr, ld, ls, fts, keep, 0.2, p)
            torch.cuda.synchronize()
            if got.dtype != dt or want.dtype != dt:
                fail(f"ell_fused: {dtype} features gave {got.dtype} (plain {want.dtype})")
            out["err"] = max(out["err"], check("out", got.float(), want.float(), **tol))
            if not bool((got[n_seed:] == 0).all() and (got[3] == 0).all()):
                fail("ell_fused: an edgeless row is not exactly 0")
            if i == 0:
                ms = timed(lambda: ef.ell_fused_fwd_cuda(nbr, ld, ls, fts, keep, 0.2, p))
                plain_ms = timed(lambda: ef.ell_fused_fwd_plain(nbr, ld, ls, fts, keep, 0.2, p),
                                 host_waits=True)
                print(f"  device ms: kernel {ms:.4f}, plain {plain_ms:.4f}", flush=True)
                out.update(ms=ms, plain_ms=plain_ms)  # the train shape (p = 0.6) last
                out["ms_by_dropout"][str(p)] = ms
                # what the function must move: nbr read and out written in
                # full; ld of the rows with a valid slot, keep of the valid
                # slots, ls and fts of the distinct rows those slots gather
                slot = nbr < n
                valid = int(slot.sum())
                active = int(slot.any(1).sum())
                gathered = int(torch.unique(nbr[slot]).numel())
                fb = fts.element_size()
                out["bound"] = bound(
                    4 * nbr.numel() + fb * n * k * d + 4 * active * k
                    + gathered * k * (4 + fb * d) + (valid * k if keep is not None else 0),
                    valid * k * (2 * d + 9), valid * k)
                g = torch.randn(n, k * d, generator=gen, device=dev).to(dt)
                bwd = ef.ell_fused_bwd(nbr, ld, ls, fts, keep, g, 0.2, p)
                cpu = lambda t: None if t is None else t.cpu()
                ref = ef.ell_fused_bwd(*map(cpu, (nbr, ld, ls, fts, keep, g)), 0.2, p)
                for name, a, b in zip(("d_fts", "d_ld", "d_ls"), bwd, ref):
                    btol = tol if name == "d_fts" and dt == torch.bfloat16 else dict(
                        atol=1e-4, rtol=1e-3)
                    check(f"backward {name} (card vs cpu)", a.cpu().float(), b.float(), **btol)
    return out


# (seeds, fanout F, hops, heads K, head dim D) of the tree attention checks:
# the sampled block of the 100M-edge configuration (512 x 17 = 8,704 rows,
# one hop) and a two-hop block (64 + 512 + 4,096 = 4,672 rows)
TREE_SHAPES = ((512, 16, 1, 8, 8), (64, 8, 2, 8, 8))


def check_tree_ell(dev, card: str, shapes=TREE_SHAPES) -> dict:
    """Phase 6t: the tree attention's two kernels on device-sampler blocks
    (train/sampled._device_sample_block over a random CSR of 100,000 nodes
    whose degrees run from 0 to 2F, one seed in eight invalid): the forward
    (``ell_fused_fwd_kernel``) and ``tree_ell_bwd_kernel`` against their
    plain versions (f32 atol 1e-5, rtol 1e-4; bf16 d_fts ELL_BF16_TOL),
    one keep mask for both, at dropout 0 and 0.6, f32 features and, at the
    first shape, bf16. dv and dls must be exactly 0 on every row no valid
    slot holds, dld on every row without a valid slot, and two runs of the
    backward bitwise equal (no atomics). Device times (``timed``) at every
    shape, the plain versions' (their host time included) and the
    backward's bound. Returns per kernel the largest error and, at the
    first shape, the times at dropout 0.6 (the train shape) and by
    dropout."""
    import torch

    from han_tpu_torch.ops import ell_fused as ef
    from han_tpu_torch.ops import tree_ell as te
    from han_tpu_torch.train.sampled import _device_sample_block, sample_key

    gen = torch.Generator(dev).manual_seed(2)
    n_nodes = 100_000
    deg = torch.randint(0, 33, (n_nodes,), generator=gen, device=dev)
    row_ptr = torch.cat([deg.new_zeros(1), deg.cumsum(0)])
    col_idx = torch.randint(0, n_nodes, (int(row_ptr[-1]) + 1,), generator=gen, device=dev,
                            dtype=torch.int32)
    out = {"fwd": {"err": 0.0, "ms_by_dropout": {}}, "bwd": {"err": 0.0, "ms_by_dropout": {}}}
    for i, (b, f, hops, k, d) in enumerate(shapes):
        n = sum(b * f ** h for h in range(hops + 1))
        seeds = torch.randint(0, n_nodes, (b,), generator=gen, device=dev, dtype=torch.int32)
        valid = torch.arange(b, device=dev) % 8 != 3
        nbr, _, _, _ = _device_sample_block(row_ptr, col_idx, seeds, valid,
                                            sample_key(1234 + i, 0), fanout=f, hops=hops,
                                            block_size=n)
        pr, ps = (torch.from_numpy(x).to(dev) for x in te.tree_parent_maps(b, f, hops, n))
        slot = nbr < n
        held = torch.zeros(n, dtype=torch.bool, device=dev)
        held[nbr[slot].long()] = True
        active = slot.any(1)
        for dtype in (("float32", "bfloat16") if i == 0 else ("float32",)):
            dt = getattr(torch, dtype)
            tol = dict(atol=1e-5, rtol=1e-4)
            rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
            ld, ls, fts, g = rnd(n, k), rnd(n, k), rnd(n, k * d).to(dt), rnd(n, k * d).to(dt)
            for p in (0.0, 0.6):
                keep = ef.draw_keep(n, f, k, p, gen, dev) if p else None
                print(f"tree_ell {n} x F={f}, {hops} hop(s), K={k}, D={d}, {int(active.sum())} "
                      f"rows with slots, {int(slot.sum())} valid slots, {dtype} features, "
                      f"dropout {p}:", flush=True)
                fwd = ef.ell_fused_fwd_cuda(nbr, ld, ls, fts, keep, 0.2, p)
                want = ef.ell_fused_fwd_plain(nbr, ld, ls, fts, keep, 0.2, p)
                bwd = te.tree_ell_bwd_cuda(nbr, pr, ps, ld, ls, fts, keep, g, 0.2, p)
                again = te.tree_ell_bwd_cuda(nbr, pr, ps, ld, ls, fts, keep, g, 0.2, p)
                ref = te.tree_ell_bwd_plain(nbr, ld, ls, fts, keep, g, 0.2, p)
                torch.cuda.synchronize()
                out["fwd"]["err"] = max(out["fwd"]["err"], check(
                    "forward out", fwd.float(), want.float(),
                    **(ELL_BF16_TOL if dt == torch.bfloat16 else tol)))
                for name, a, r in zip(("d_fts", "d_ld", "d_ls"), bwd, ref):
                    if a.dtype != r.dtype:
                        fail(f"tree_ell backward {name}: {a.dtype}, plain {r.dtype}")
                    out["bwd"]["err"] = max(out["bwd"]["err"], check(
                        f"backward {name}", a.float(), r.float(),
                        **(ELL_BF16_TOL if name == "d_fts" and dt == torch.bfloat16 else tol)))
                if not all(torch.equal(a, c) for a, c in zip(bwd, again)):
                    fail("tree_ell backward: two runs differ")
                dv, dld, dls = bwd
                if not bool((dv[~held] == 0).all() and (dls[~held] == 0).all()
                            and (dld[~active] == 0).all()):
                    fail("tree_ell backward: a row no valid slot holds (or without a valid "
                         "slot) is not exactly 0")
                if dt != torch.float32:
                    continue
                ms_f = timed(lambda: ef.ell_fused_fwd_cuda(nbr, ld, ls, fts, keep, 0.2, p))
                ms_b = timed(lambda: te.tree_ell_bwd_cuda(nbr, pr, ps, ld, ls, fts, keep, g,
                                                          0.2, p))
                plain_f = timed(lambda: ef.ell_fused_fwd_plain(nbr, ld, ls, fts, keep, 0.2, p),
                                host_waits=True)
                plain_b = timed(lambda: te.tree_ell_bwd_plain(nbr, ld, ls, fts, keep, g, 0.2,
                                                              p), host_waits=True)
                print(f"  device ms: forward kernel {ms_f:.4f}, plain {plain_f:.4f}; backward "
                      f"kernel {ms_b:.4f}, plain {plain_b:.4f}; {card}", flush=True)
                if i:
                    continue
                # the backward must move: nbr and the parent maps read, dv,
                # dld and dls written in full; ld and g of the rows with a
                # valid slot, keep of the valid slots, ls and fts of the
                # rows those slots hold (each once: a tree)
                valid_n, act = int(slot.sum()), int(active.sum())
                fb = fts.element_size()
                bnd = bound(4 * nbr.numel() + 8 * n + n * k * (fb * d + 8)
                            + act * k * (4 + fb * d) + valid_n * k * (4 + fb * d)
                            + (valid_n * k if keep is not None else 0),
                            valid_n * k * (3 * d + 12), valid_n * k)
                for key, ms, plain in (("fwd", ms_f, plain_f), ("bwd", ms_b, plain_b)):
                    out[key].update(ms=ms, plain_ms=plain)
                    out[key]["ms_by_dropout"][str(p)] = ms
                out["bwd"]["bound"] = bnd
                print(f"  backward bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return out


def train_sampled(dev, native, card: str) -> tuple[int, int]:
    """Phase 7: the 100M-edge sampled configuration through run() for 2
    epochs with the host sampler and impl ell_fused, its train and eval
    steps captured; then the host/device split of its step (one graph
    launch a step); then its captured and eager (capture=False) runs at
    dropout 0 over the same 16 batches, whose per-step losses agree within
    SAMPLED_CHUNK_TOL, with their peak memory; then 10 steps of the device
    sampler through run() (captured). Phase 7b: the device sampler with steps_per_call 4
    against 1 at dropout 0, 2 epochs of 16 steps each (cut from the
    configuration's 30), whose per-step losses agree within
    SAMPLED_CHUNK_TOL; both median steps, their device split and launches.
    Every device-sampler block runs the tree attention's kernels: one
    forward (``ell_fused_launches``) a block, one backward
    (``tree_ell_bwd_launches``) a train block. Returns the ell_fused
    launches of every run here and in phase 7c (the host sampler's, and
    the device sampler's forwards) and the tree backward's launches."""
    import numpy as np
    import torch

    from han_tpu_torch.graph.synthetic import scale_dataset
    from han_tpu_torch.ops import ell_fused as ef
    from han_tpu_torch.ops import tree_ell
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.sampled import SampledTrainer, step_breakdown
    from han_tpu_torch.train.trainer import MetricLogger, run

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
    if not result["captured"]:
        fail("the host sampler's steps were not captured")
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
    print(f"sampled train (captured): median step {step_ms:.3f} ms (eager 13.827 ms before "
          f"capture), host block (prefetch thread) {result['median_host_block_ms']:.3f} ms, "
          f"sampled edges·heads/s {result['edges_heads_per_s']:.1f}, max_memory_allocated "
          f"{result.get('max_memory_allocated')} B; {card}", flush=True)

    split = step_breakdown(SampledTrainer(ds, cfg_for("host", 1), device=dev),
                           np.where(ds.train_mask)[0])
    dev_ms = split["device_ms"]
    if split["graph_launches"] != 1:
        fail(f"host sampler: {split['graph_launches']} graph launches a train step, want 1")
    print(f"sampled step split (captured): host block {split['host_block_ms']:.3f} ms, device "
          + (f"{dev_ms:.3f} ms (share {dev_ms / step_ms:.3f} of the median step)"
             if dev_ms else "not measured (the profiler recorded no device events)")
          + f", launches a step {split['kernel_launches']:g} kernels + "
          f"{split['graph_launches']:g} graphs; {card}", flush=True)

    # -- the captured host-sampler step against the eager one, dropout 0
    ds16 = dataclasses.replace(ds, train_mask=np.arange(ds.n_nodes) < 16 * 512)
    runs = {}
    for name, capture in (("captured", None), ("eager", False)):
        cfg = cfg_for("host", 1)
        cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ef.ell_fused_launches = 0
        r = SampledTrainer(ds16, cfg, batch_size=512, fanout=16, capture=capture, device=dev,
                           logger=MetricLogger(echo=False)).fit()
        torch.cuda.synchronize()
        runs[name] = dict(r, ell=ef.ell_fused_launches)
        launches += ef.ell_fused_launches
    cap, eager = runs["captured"], runs["eager"]
    want = n_mp * (16 + 1 + 2_048 // 512)
    if (not cap["captured"] or eager["captured"] or cap["ell"] != want or eager["ell"] != want
            or not np.allclose(cap["step_train_loss"], eager["step_train_loss"],
                               **SAMPLED_CHUNK_TOL)):
        fail(f"host sampler at dropout 0: captured {cap['captured']} / {eager['captured']}, "
             f"ell_fused launches {cap['ell']} / {eager['ell']} (want {want}), per-step losses "
             f"{cap['step_train_loss']} against {eager['step_train_loss']}")
    peak = cap["max_memory_allocated"] / eager["max_memory_allocated"]
    diff = max(abs(a - b) for a, b in zip(cap["step_train_loss"], eager["step_train_loss"]))
    print(f"host sampler at dropout 0, 16 steps: captured per-step losses within "
          f"{SAMPLED_CHUNK_TOL} of eager (largest difference {diff:.3e}); median step captured {cap['median_step_time_s'] * 1e3:.3f} ms, eager "
          f"{eager['median_step_time_s'] * 1e3:.3f} ms; host block "
          f"{cap['median_host_block_ms']:.3f} / {eager['median_host_block_ms']:.3f} ms; "
          f"max_memory_allocated {cap['max_memory_allocated']} / "
          f"{eager['max_memory_allocated']} B (captured / eager {peak:.3f}); {card}",
          flush=True)
    del ds16

    # device sampler: 10 train steps, one val and four test batches; every
    # block launches the tree forward (an ell_fused launch), every train
    # block the tree backward
    ds10 = dataclasses.replace(ds, train_mask=np.arange(ds.n_nodes) < 10 * 512)
    tree_ell.tree_ell_calls = tree_ell.tree_ell_bwd_launches = 0
    ef.ell_fused_launches = 0
    res = run(cfg_for("device", 1), ds10, device=dev)
    torch.cuda.synchronize()
    want_calls = n_mp * (10 + 1 + 2_048 // 512)
    if not np.isfinite(res["epoch_train_loss"]).all() or not np.isfinite(res["test_loss"]):
        fail(f"device-sampler losses not finite: {res['epoch_train_loss']}")
    if (tree_ell.tree_ell_calls != want_calls or ef.ell_fused_launches != want_calls
            or tree_ell.tree_ell_bwd_launches != n_mp * 10 or not res["captured"]):
        fail(f"device sampler: {tree_ell.tree_ell_calls} tree attention calls and "
             f"{ef.ell_fused_launches} forward (ell_fused) launches (want {want_calls} each), "
             f"{tree_ell.tree_ell_bwd_launches} tree backward launches (want {n_mp * 10}), "
             f"captured {res['captured']}")
    launches += ef.ell_fused_launches
    tree_n = tree_ell.tree_ell_bwd_launches
    print(f"device sampler (captured): train loss {res['epoch_train_loss'][0]:.5f}, test_acc "
          f"{res['test_acc']:.4f}, median step {res['median_step_time_s'] * 1e3:.3f} ms, "
          f"sampled edges·heads/s {res['edges_heads_per_s']:.1f}; every block through "
          f"tree attention ({tree_ell.tree_ell_calls} calls, {ef.ell_fused_launches} forward "
          f"and {tree_n} backward launches)", flush=True)

    # -- phase 7b: steps_per_call 4 against 1 -------------------------------
    steps, epochs = 16, 2
    ds16 = dataclasses.replace(ds, train_mask=np.arange(ds.n_nodes) < steps * 512)
    ds8 = dataclasses.replace(ds, train_mask=np.arange(ds.n_nodes) < 8 * 512)
    del ds, ds10
    runs = {}
    for spc in (1, 4):
        cfg = cfg_for("device", epochs)
        cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
        torch.cuda.reset_peak_memory_stats(dev)
        tree_ell.tree_ell_calls = tree_ell.tree_ell_bwd_launches = 0
        ef.ell_fused_launches = 0
        t0 = time.perf_counter()
        t = SampledTrainer(ds16, cfg, batch_size=512, fanout=16, sampler="device",
                           steps_per_call=spc, device=dev, logger=MetricLogger(echo=False))
        t_build = time.perf_counter() - t0
        r = t.fit()
        torch.cuda.synchronize()
        r["tree_calls"] = tree_ell.tree_ell_calls
        r["launches"] = (ef.ell_fused_launches, tree_ell.tree_ell_bwd_launches)
        r["replays"] = {c: step.replays for c, step in t._train_steps.items()}
        r["split"] = step_breakdown(t, np.where(ds16.train_mask)[0])
        r["build_s"] = t_build
        runs[spc] = r
        del t
        torch.cuda.empty_cache()
    want_calls = n_mp * (epochs * steps + epochs * 1 + 2_048 // 512)
    one, four = runs[1]["step_train_loss"], runs[4]["step_train_loss"]
    for spc, r in runs.items():
        if (r["tree_calls"] != want_calls or not r["captured"] or len(r["step_train_loss"])
                != epochs * steps or not np.isfinite(r["step_train_loss"]).all()
                or r["launches"] != (want_calls, n_mp * epochs * steps)):
            fail(f"steps_per_call {spc}: {r['tree_calls']} tree attention calls (want "
                 f"{want_calls}), forward and backward launches {r['launches']} (want "
                 f"{(want_calls, n_mp * epochs * steps)}), captured {r['captured']}, "
                 f"losses {r['step_train_loss']}")
        launches += r["launches"][0]
        tree_n += r["launches"][1]
    if sorted(runs[4]["replays"]) != [4] or not runs[4]["replays"][4]:
        fail(f"steps_per_call 4: dispatch replays {runs[4]['replays']} (want only 4-step graphs)")
    if not np.allclose(four, one, **SAMPLED_CHUNK_TOL):
        fail(f"steps_per_call 4 against 1: per-step losses {four} against {one}")
    print(f"device sampler, steps_per_call 4 against 1 (dropout 0, {epochs} epochs of {steps} "
          f"steps): per-step losses within {SAMPLED_CHUNK_TOL} (largest difference "
          f"{max(abs(a - b) for a, b in zip(one, four)):.3e}); {runs[4]['replays']} replays of "
          f"the 4-step graph; trainer built in {runs[1]['build_s']:.2f} / "
          f"{runs[4]['build_s']:.2f} s", flush=True)
    for spc, r in runs.items():
        sp = r["split"]
        print(f"device sampler, steps_per_call {spc}: median step "
              f"{r['median_step_time_s'] * 1e3:.4f} ms, device {sp['device_ms']:.4f} ms a step "
              f"(share {sp['device_ms'] / (r['median_step_time_s'] * 1e3):.3f}), launches a step "
              f"{sp['kernel_launches']:g} kernels + {sp['graph_launches']:g} graphs, "
              f"max_memory_allocated {r['max_memory_allocated']} B; {card}", flush=True)
    del ds16
    torch.cuda.empty_cache()
    resume_ell, resume_tree = sampled_resume(ds8, dev, cfg_for, card)
    return launches + resume_ell, tree_n + resume_tree


# the data-parallel trainers at S = 1 against their one-device trainers: the
# same blocks (or graphs), dropout streams and kernels; the data-parallel
# step backpropagates its share of the loss and the L2 term in two passes
# (two accumulations into each gradient) and forms the mean as a sum over
# the global count: float order only
DP_TOL = dict(rtol=1e-5, atol=1e-6)


def train_dp_sampled(dev, card: str, steps: int = 10) -> dict:
    """Phase 7d: DPSampledTrainer on a one-rank NCCL world at the sampled
    configuration's widths (acm preset: hid 8, heads (8, 1), semantic 128;
    batch 512, fanout 16, the host sampler, ell_fused) on the
    configuration's generator cut to 100,000 nodes (2 meta-paths of degree
    100, 20 M edges; time), one epoch of ``steps`` steps at dropout 0,
    both captured (the axis of one rank holds no process group): its
    per-step losses and test metrics against SampledTrainer's on the
    same seeds (DP_TOL, which is SAMPLED_CHUNK_TOL), ell_fused launches
    exact (2 a train step and an eval batch, one val and four test
    batches); a bf16 run (model.dtype=bfloat16, impl=auto: ell_fused takes
    bf16) of 3 steps, captured, launches exact; the device sampler refused
    (NotImplementedError).
    Returns the ell_fused launches of the f32 and bf16 DP runs."""
    import numpy as np
    import torch

    from han_tpu_torch.graph.synthetic import scale_dataset
    from han_tpu_torch.ops import ell_fused as ef
    from han_tpu_torch.parallel.mesh import make_mesh
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.sampled import DPSampledTrainer, SampledTrainer
    from han_tpu_torch.train.trainer import MetricLogger

    t0 = time.perf_counter()
    ds = scale_dataset(100_000, 100, n_train=steps * 512, n_val=512, n_test=2_048, seed=0)
    print(f"phase 7d dataset: {ds.n_nodes} nodes, "
          f"{sum(int(a.nnz) for a in ds.metapath_adjs)} edges, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    n_mp = len(ds.metapath_adjs)

    def cfg_for(sampler="host", impl="ell_fused", dtype="float32"):
        cfg = preset("acm")
        cfg.model.impl, cfg.model.dtype = impl, dtype
        cfg.model.attn_drop = cfg.model.ffd_drop = 0.0
        cfg.train.sampled, cfg.train.sampler, cfg.train.epochs = True, sampler, 1
        return cfg

    kw = dict(batch_size=512, fanout=16, logger=MetricLogger(echo=False))
    with OneRankNCCL(dev):
        mesh = make_mesh(graph=1, device=dev)
        runs = {}
        for label in ("SampledTrainer", "DPSampledTrainer"):
            ef.ell_fused_launches = 0
            t0 = time.perf_counter()
            t = (DPSampledTrainer(ds, cfg_for(), mesh=mesh, **kw) if label.startswith("DP")
                 else SampledTrainer(ds, cfg_for(), device=dev, **kw))
            build_s = time.perf_counter() - t0
            r = t.fit()
            torch.cuda.synchronize()
            runs[label] = dict(r, ell=ef.ell_fused_launches, build_s=build_s)
            del t
        one, dp = runs["SampledTrainer"], runs["DPSampledTrainer"]
        if not (one["captured"] and dp["captured"]):
            fail(f"phase 7d: captured {one['captured']} (SampledTrainer), {dp['captured']} "
                 "(DPSampledTrainer on one NCCL rank)")
        want = n_mp * (steps + 1 + 4)
        if dp["ell"] != want or one["ell"] != want:
            fail(f"phase 7d: ell_fused launches {dp['ell']} / {one['ell']}, want {want}")
        if not (np.allclose(dp["step_train_loss"], one["step_train_loss"], **DP_TOL)
                and np.allclose([dp["test_loss"], dp["test_acc"]],
                                [one["test_loss"], one["test_acc"]], **DP_TOL)):
            fail(f"phase 7d: DPSampledTrainer losses {dp['step_train_loss']} / test "
                 f"{dp['test_loss']} against {one['step_train_loss']} / {one['test_loss']}")
        print(f"DPSampledTrainer (one NCCL rank) against SampledTrainer, dropout 0, {steps} "
              f"steps: per-step losses within {DP_TOL} (largest difference "
              f"{max(abs(a - b) for a, b in zip(dp['step_train_loss'], one['step_train_loss'])):.3e}"
              f"), ell_fused launches {dp['ell']}; both captured, median step "
              f"{dp['median_step_time_s'] * 1e3:.3f} ms against "
              f"{one['median_step_time_s'] * 1e3:.3f} ms (eager 14.781 / 14.673 ms before "
              f"capture), host block {dp['median_host_block_ms']:.3f} / {one['median_host_block_ms']:.3f} ms; trainer "
              f"built in {dp['build_s']:.2f} / {one['build_s']:.2f} s; {card}", flush=True)

        ds3 = dataclasses.replace(ds, train_mask=np.arange(ds.n_nodes) < 3 * 512)
        cfg = cfg_for(impl="auto", dtype="bfloat16")
        ef.ell_fused_launches = 0
        t = DPSampledTrainer(ds3, cfg, mesh=mesh, **kw)
        r16 = t.fit()
        torch.cuda.synchronize()
        bf16_n = ef.ell_fused_launches
        if (cfg.model.impl != "ell_fused" or bf16_n != n_mp * (3 + 1 + 4)
                or not np.isfinite(r16["step_train_loss"]).all() or not r16["captured"]):
            fail(f"phase 7d bf16: impl {cfg.model.impl}, ell_fused launches {bf16_n} (want "
                 f"{n_mp * 8}), losses {r16['step_train_loss']}, captured {r16['captured']}")
        print(f"DPSampledTrainer, bf16 features (impl=auto -> ell_fused), 3 steps, captured: "
              f"losses "
              f"{', '.join(f'{x:.5f}' for x in r16['step_train_loss'])}, ell_fused launches "
              f"{bf16_n}; median step {r16['median_step_time_s'] * 1e3:.3f} ms; {card}",
              flush=True)
        try:
            DPSampledTrainer(ds, cfg_for("device"), mesh=mesh, sampler="device", **kw)
            fail("DPSampledTrainer took the device sampler")
        except NotImplementedError as e:
            print(f"DPSampledTrainer, device sampler: {e}", flush=True)
    return {"f32": dp["ell"], "bf16": bf16_n}


def sampled_resume(ds, dev, cfg_for, card: str, steps: int = 8,
                   epochs: int = 2) -> tuple[int, int]:
    """Phase 7c: the sampled configuration (dropouts 0.6) for ``epochs``
    epochs of ``steps`` steps, uninterrupted; again, preempted mid-epoch
    (the guard polled once a dispatch: with the device sampler at
    steps_per_call 4 after the third dispatch, epoch 1 cursor 4; with the
    host sampler after the eleventh, epoch 1 cursor 3, the batch its
    prefetch thread holds dropped); then resumed in a fresh trainer. Every
    run of both samplers is captured (the resumed run's first step eager,
    where the uninterrupted run replays). The
    per-step losses of the preempted and resumed runs agree with the
    uninterrupted run's within SAMPLED_CHUNK_TOL, and so do the test
    metrics; launch and call counts exact. Returns the ell_fused launches
    (the host sampler's blocks and the device sampler's tree forwards) and
    the tree backward's launches."""
    import tempfile

    import numpy as np
    import torch

    from han_tpu_torch.ops import ell_fused as ef
    from han_tpu_torch.ops import tree_ell
    from han_tpu_torch.train.sampled import _EPOCH_STRIDE, SampledTrainer
    from han_tpu_torch.train.trainer import MetricLogger

    n_mp = len(ds.metapath_adjs)
    ell_n = tree_n = 0
    for sampler, spc, trip in (("device", 4, 3), ("host", 1, 11)):
        runs = {}
        tree_ell.tree_ell_calls = tree_ell.tree_ell_bwd_launches = 0
        ef.ell_fused_launches = 0
        with tempfile.TemporaryDirectory() as root:
            for name, tag, guard in (("uninterrupted", "a", None), ("preempted", "b", TripAt(trip)),
                                     ("resumed", "b", None)):
                cfg = cfg_for(sampler, epochs)
                cfg.train.checkpoint_dir = f"{root}/{tag}"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                t = SampledTrainer(ds, cfg, batch_size=512, fanout=16, sampler=sampler,
                                   steps_per_call=spc, device=dev, guard=guard,
                                   logger=MetricLogger(echo=False))
                r = t.fit(resume=name == "resumed")
                torch.cuda.synchronize()
                r["s"] = time.perf_counter() - t0
                r["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
                if name == "preempted":
                    state = t.restore_latest()
                    r["at"] = (state["epoch"], state["cursor"], t.checkpoints().latest_step())
                runs[name] = r
                del t
                torch.cuda.empty_cache()
        a, b, c = runs["uninterrupted"], runs["preempted"], runs["resumed"]
        label = f"sampled resume ({sampler} sampler, steps_per_call {spc})"
        epoch, cursor, step_id = b["at"]
        done = len(b["step_train_loss"])
        if (not b.get("preempted") or epoch != 1 or step_id != epoch * _EPOCH_STRIDE + cursor
                or done != steps + cursor or not 0 < cursor < steps):
            fail(f"{label}: preempted {b.get('preempted')} at epoch {epoch}, cursor {cursor}, "
                 f"step id {step_id}, after {done} steps")
        got = b["step_train_loss"] + c["step_train_loss"]
        if len(got) != epochs * steps or not np.allclose(got, a["step_train_loss"],
                                                         **SAMPLED_CHUNK_TOL):
            fail(f"{label}: per-step losses {got} against {a['step_train_loss']}")
        if not np.allclose([c["test_loss"], c["test_acc"]], [a["test_loss"], a["test_acc"]],
                           **SAMPLED_CHUNK_TOL) or c["best_epoch"] != a["best_epoch"]:
            fail(f"{label}: test {c['test_loss']} / {c['test_acc']} (best epoch "
                 f"{c['best_epoch']}) against {a['test_loss']} / {a['test_acc']} "
                 f"({a['best_epoch']})")
        # train steps, val batches (one an epoch; the preempted run evaluates
        # epoch 0 only) and test batches (2,048 / 512, not in the preempted run)
        # (the device sampler's blocks launch the tree forward, an ell_fused
        # launch, and its train blocks the tree backward)
        blocks = n_mp * (2 * epochs * steps + 2 * epochs + 2 * 4)
        got_n = tree_ell.tree_ell_calls if sampler == "device" else ef.ell_fused_launches
        other = 0 if sampler == "device" else tree_ell.tree_ell_calls
        want_bwd = n_mp * 2 * epochs * steps if sampler == "device" else 0
        if (got_n != blocks or other or ef.ell_fused_launches != blocks
                or tree_ell.tree_ell_bwd_launches != want_bwd
                or not (a["captured"] and c["captured"])):
            fail(f"{label}: {got_n} blocks through its attention (want {blocks}), {other} "
                 f"through the other, {ef.ell_fused_launches} forward (ell_fused) launches "
                 f"(want {blocks}), {tree_ell.tree_ell_bwd_launches} tree backward launches "
                 f"(want {want_bwd}); captured {a['captured']} / {c['captured']}")
        ell_n += ef.ell_fused_launches
        tree_n += tree_ell.tree_ell_bwd_launches
        rest = c["step_train_loss"]
        print(f"{label}: preempted at epoch {epoch}, cursor {cursor} (step id {step_id}), "
              f"resumed in a fresh trainer: {len(rest)} resumed steps, per-step losses "
              f"within {SAMPLED_CHUNK_TOL} of the uninterrupted run ("
              f"{'bitwise equal' if got == a['step_train_loss'] else 'NOT bitwise equal'}, "
              f"largest difference {max(abs(x - y) for x, y in zip(got, a['step_train_loss'])):.3e}"
              f"); test_acc {c['test_acc']:.4f}; {got_n} blocks through "
              f"{'tree attention' if sampler == 'device' else 'ell_fused'}", flush=True)
        print(f"{label}: wall time uninterrupted {a['s']:.3f} s, preempted {b['s']:.3f} s, "
              f"resumed {c['s']:.3f} s (trainer build included); median step "
              f"{a['median_step_time_s'] * 1e3:.4f} / {c['median_step_time_s'] * 1e3:.4f} ms; "
              f"max_memory_allocated {a['max_memory_allocated']} / "
              f"{b['max_memory_allocated']} / {c['max_memory_allocated']} B; {card}", flush=True)
    return ell_n, tree_n


# steps_per_call 4 against 1: the same steps, kernels and order (the tree
# attention's backward kernel writes each row once, no atomics), one graph
# of 4 steps against 4 of one
SAMPLED_CHUNK_TOL = dict(rtol=1e-5, atol=1e-6)


def sdpa_yardstick(graph, ld, ls, v, k, d) -> float:
    """library_ms of the flash forward: one scaled_dot_product_attention
    call with q = k = 0 (so q·kᵀ = 0) and the additive mask z = lrelu(ld_i
    + ls_j) on edges, -1e9 off them, is softmax(z)·v: the flash forward at
    dropout 0 on the rows with edges, held so (atol 1e-4, rtol 1e-3:
    another kernel's exp and summation order); on a stack of P graphs one
    call with a batch of P. A yardstick only: the port never calls it.
    Returns its device ms (``timed``)."""
    import torch
    import torch.nn.functional as F

    from han_tpu_torch.ops import flash_gat as fg

    n = ld.shape[-1]
    if graph.n_paths is None:  # one graph: a batch of one
        lb, sb, vb = ld[None], ls[None], v[None]
        adj = fg.tile_adjacency(graph)[None]
    else:  # a stack of P graphs: a batch of P
        lb, sb, vb = ld, ls, v
        adj = torch.stack([fg.tile_adjacency(graph.path(p)) for p in range(graph.n_paths)])
    raw = lb[:, :, :, None] + sb[:, :, None, :]
    mask = torch.where(adj[:, None], torch.maximum(raw, 0.2 * raw), -1e9)  # (P, K, n, n)
    del raw
    q = torch.zeros((lb.shape[0], k, n, d), device=ld.device)
    vv = vb.view(-1, n, k, d).permute(0, 2, 1, 3).contiguous()
    out = F.scaled_dot_product_attention(q, q, vv, attn_mask=mask).permute(0, 2, 1, 3)
    want, _ = fg.flash_fwd_cuda(graph, ld, ls, v, fg.FlashMeta())
    real = adj.any(dim=-1)
    check("SDPA yardstick vs the forward kernel (rows with edges)",
          out.reshape(-1, n, k * d)[real], want.reshape(-1, n, k * d)[real], 1e-4, 1e-3)
    ms = timed(lambda: F.scaled_dot_product_attention(q, q, vv, attn_mask=mask))
    print(f"  SDPA yardstick device ms {ms:.4f}", flush=True)
    del mask, adj
    torch.cuda.empty_cache()
    return ms


def train_bf16(ds, dev, n_mp: int, card: str) -> dict:
    """Phase 4a: the dblp preset with model.dtype=bfloat16 for 3 epochs
    through run(), captured from epoch 1: losses finite and falling, launch
    counts exact; then its step profiled captured and eager."""
    import numpy as np
    import torch

    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer, run

    cfg = preset("dblp")
    cfg.model.dtype = "bfloat16"
    cfg.train.epochs = 3
    fg.flash_fwd_launches = 0
    fg.flash_bwd_launches = 0
    result = run(cfg, ds, device=dev)
    torch.cuda.synchronize()
    n = {"fwd": fg.flash_fwd_launches, "bwd": fg.flash_bwd_launches}
    losses = result["epoch_train_loss"]
    if len(losses) != 3 or not all(np.isfinite(losses)) or not np.isfinite(result["test_loss"]):
        fail(f"bf16 train losses not finite or short: {losses}, test {result['test_loss']}")
    if not losses[-1] < losses[0]:
        fail(f"bf16 train loss did not fall: {losses}")
    want = {"fwd": n_mp * (2 * 3 + 1), "bwd": n_mp * 3}
    if n != want or not result["captured"]:
        fail(f"bf16 train launches {n}, want {want}; captured {result['captured']}")
    print(f"bf16 train (model.dtype=bfloat16, 3 epochs, captured): losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}, test_acc {result['test_acc']:.4f}; "
          f"launches {n}; median step {result['median_step_time_s'] * 1e3:.3f} ms, "
          f"max_memory_allocated {result['max_memory_allocated']} B", flush=True)
    for capture in (None, False):
        profile_trainer("dblp bf16 step (dropout 0.6)", lambda: Trainer(
            ds, cfg, device=dev, logger=MetricLogger(echo=False), capture=capture), card)
    return n


def check_dispatch_dblp(ds, dev, card: str, epochs: int = 6) -> dict:
    """Phase 4k (DBLP): the dblp preset with model.impl=auto, captured, for
    ``epochs`` epochs: DBLP's meta-paths sweep 1.8-2.5 tile elements an
    edge, below ops/attention.flash_csr_threshold, so auto launches the
    flash kernels exactly as the preset does (3 forward + 3 backward a
    train step, 3 forward an eval); then the preset itself with the graphs'
    edge views dropped once the trainer is built. Each run's peak device
    memory above what was allocated before its trainer was built (so the
    difference is the views' 8 bytes an edge) and its median replayed
    step (epochs 3 on: epoch 0 runs eagerly, epoch 1 captures). Returns the
    launches."""
    import dataclasses as dc
    import gc

    import numpy as np
    import torch

    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer

    out = {}
    for label in ("auto", "preset, no edge views"):
        cfg = preset("dblp")
        cfg.train.epochs = epochs
        if label == "auto":
            cfg.model.impl = "auto"
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        t = Trainer(ds, cfg, device=dev, logger=MetricLogger(echo=False))
        view = sum(4 * (g.edge_col.numel() + g.edge_row.numel() + g.edge_row_ptr.numel())
                   for g in t.graphs)
        if label != "auto":
            t.graphs = [dc.replace(g, edge_row_ptr=None, edge_col=None, edge_row=None)
                        for g in t.graphs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fg.flash_fwd_launches = fg.flash_bwd_launches = 0
        r = t.fit()
        torch.cuda.synchronize()
        n_mp = len(t.graphs)
        got = (fg.flash_fwd_launches, fg.flash_bwd_launches)
        want = (n_mp * (2 * epochs + 1), n_mp * epochs)
        if got != want or not r["captured"] or not np.isfinite(r["epoch_train_loss"]).all():
            fail(f"dblp {label}: flash launches {got} (want {want}), captured {r['captured']}, "
                 f"losses {r['epoch_train_loss']}")
        out[label] = {"launches": got, "peak": torch.cuda.max_memory_allocated(dev) - before,
                      "step_ms": statistics.median(r["epoch_step_time_s"][2:]) * 1e3}
        print(f"dblp, {label}: flash launches {got} = the preset's {n_mp} + {n_mp} a train "
              f"step; median replayed step {out[label]['step_ms']:.4f} ms; peak memory above "
              f"the run's start {out[label]['peak']} B; {card}", flush=True)
        del t, r
    a, b = out["auto"]["peak"], out["preset, no edge views"]["peak"]
    print(f"dblp edge views: {view} B ({view / 1e6:.3f} MB) for the three meta-paths; peak "
          f"with them {a} B, without {b} B (difference {a - b} B); {card}", flush=True)
    return {"fwd": sum(v["launches"][0] for v in out.values()),
            "bwd": sum(v["launches"][1] for v in out.values())}


def train_acm(dev) -> None:
    """Phase 4c: run(preset("acm")) for 2 epochs with no dataset given, so
    run() loads it by the name "acm": ACM3025.mat where present, else the
    ACM3025-shaped acm_synthetic (the dense path: no kernel of this
    script). Losses finite, the right count."""
    import numpy as np

    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import run

    cfg = preset("acm")
    cfg.train.epochs = 2
    t0 = time.perf_counter()
    result = run(cfg, device=dev)
    losses = result["epoch_train_loss"]
    if len(losses) != 2 or not all(np.isfinite(losses)) or not np.isfinite(result["test_loss"]):
        fail(f"acm preset: losses {losses}, test loss {result['test_loss']}")
    print(f"acm preset (run() loads \"acm\"): losses {losses[0]:.5f}, {losses[1]:.5f}, "
          f"test_acc {result['test_acc']:.4f}, {time.perf_counter() - t0:.2f} s", flush=True)


def train_pubmed(dev, card: str, epochs: int = 10) -> dict:
    """Phase 4d: the pubmed preset (GAT, hid 8, heads (8, 1), dropouts 0.6,
    BCSR graphs, flash) on a Pubmed-shaped Planetoid fixture written to a
    temporary directory and loaded by name. First the preset's GAT at
    random weights through flash and through csr, one deterministic forward
    and the loss gradients (csr is the oracle: atol 1e-5, rtol 1e-3). Then
    the forward and fused backward against their plain versions at both
    layer shapes, K = D = 8 and K = 1, D = 3 (zero-padded to 4 by the
    wrappers), dropout 0 and 0.6, with the DBLP check's tolerances, and
    both kernels timed at each shape at dropout 0.6 beside flash_bounds
    (each shape's error beside its time). Then run() for ``epochs`` epochs,
    captured: losses finite and falling, launches exact (2 layers: forward
    2·(2·epochs + 1), backward 2·epochs); and the same epochs with
    model.impl=csr, data.graph_format=csr for the step time beside flash's.
    Phase 4k: the same epochs with model.impl=auto, which takes csr on the
    BCSR graph's edge view (no flash launch), timed; at dropout 0 its
    losses against graph_format=csr's (CAPTURE_TOL). Last, the flash and
    csr steps profiled captured and eager."""
    import tempfile

    import numpy as np
    import torch

    from han_tpu_torch.datasets.planetoid import write_planetoid
    from han_tpu_torch.datasets.registry import load_dataset
    from han_tpu_torch.graph.build import metapath_to_bcsr, metapath_to_csr
    from han_tpu_torch.nn.losses import masked_softmax_cross_entropy
    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.ops.attention import flash_csr_threshold
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.trainer import MetricLogger, Trainer, build_model, run

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        write_planetoid(tmp)
        ds = load_dataset("pubmed", root=tmp)
    adj = ds.metapath_adjs[0]
    graph = metapath_to_bcsr(adj).to(dev)
    n = graph.n_pad
    print(f"pubmed fixture: {ds.n_nodes} nodes, {ds.features.shape[1]} features, "
          f"{adj.nnz // 2} undirected edges, split {int(ds.train_mask.sum())}/"
          f"{int(ds.val_mask.sum())}/{int(ds.test_mask.sum())}; {graph.n_edges} edges with "
          f"self-loops in {graph.n_tiles} occupied {graph.bm}x{graph.bn} tiles of "
          f"{graph.nb_r * graph.nb_c} (in-tile density "
          f"{graph.n_edges / (graph.n_tiles * graph.bm * graph.bn):.5f}), n_pad {n}; written "
          f"and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = preset("pubmed")
    err = {"fwd": 0.0, "bwd": 0.0}

    model = build_model(ds, cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.from_numpy(ds.features).to(dev)
    labels = torch.from_numpy(ds.labels).to(dev)
    mask = torch.from_numpy(ds.train_mask).to(dev)
    outs = {}
    for impl, g in (("flash", graph), ("csr", metapath_to_csr(adj).to(dev))):
        for layer in model.layers:
            layer.impl = impl
        logits = model(g, x)
        loss = masked_softmax_cross_entropy(logits, labels, mask)
        outs[impl] = [logits.detach(), *torch.autograd.grad(loss, list(model.parameters()))]
    names = ["logits", *(name for name, _ in model.named_parameters())]
    gat_err = max(check(f"pubmed GAT flash vs csr: {name}", a, b, 1e-5, 1e-3)
                  for name, a, b in zip(names, outs["flash"], outs["csr"]))
    del model, outs
    torch.cuda.empty_cache()

    gen = torch.Generator(dev).manual_seed(8)
    kernels = {"fwd": {"tiles": graph.n_tiles}, "bwd": {"tiles": graph.n_tiles}}
    for k, d in ((8, 8), (1, 3)):
        ld, ls, v, g = dblp_inputs(gen, n, ds.n_nodes, k, d)
        shape_err = {"fwd": 0.0, "bwd": 0.0}
        for p in (0.0, 0.6):
            meta = fg.FlashMeta(slope=0.2, dropout_p=p, seed=fg.seed_tensor(424242, dev))
            print(f"pubmed flash vs plain at K = {k}, D = {d}"
                  f"{' (padded to 4)' if d == 3 else ''}, dropout {p}:", flush=True)
            out_k, lse_k = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
            torch.cuda.synchronize()
            t_fwd = time.perf_counter() - t1
            shape_err["fwd"] = max(shape_err["fwd"], check("out", out_k, out_p, 1e-5, 1e-4),
                                   check("lse", lse_k, lse_p, 1e-5, 1e-4))
            delta = fg.head_delta(g, out_k, k)
            args = (graph, ld, ls, v, g, lse_k, delta, meta)
            got = fg.flash_bwd_cuda(*args)
            t1 = time.perf_counter()
            want = fg.flash_bwd_plain(*args)
            torch.cuda.synchronize()
            t_bwd = time.perf_counter() - t1
            shape_err["bwd"] = max(shape_err["bwd"], *(
                check(name, a, b, 1e-4, 1e-3) for name, a, b in zip(("dld", "dls", "dv"), got, want)))
            print(f"  plain versions, one call each: forward {t_fwd:.3f} s, fused backward "
                  f"{t_bwd:.3f} s", flush=True)
            del out_p, lse_p, got, want
            torch.cuda.empty_cache()
        # timed at dropout 0.6, the training shape: meta and args are the last p's
        ms = {"fwd": timed(lambda: fg.flash_fwd_cuda(graph, ld, ls, v, meta)),
              "bwd": timed(lambda: fg.flash_bwd_cuda(*args))}
        bnd = flash_bounds(graph, k, d)
        for key in ("fwd", "bwd"):
            err[key] = max(err[key], shape_err[key])
            kernels[key][f"K{k}_D{d}"] = {"ms": ms[key], "bound_ms": bnd[key][0],
                                          "bound_by": bnd[key][1],
                                          "max_abs_err": shape_err[key]}
        print(f"pubmed flash at K = {k}, D = {d}, dropout 0.6: forward {ms['fwd']:.4f} ms "
              f"(bound {bnd['fwd'][0]:.4f}, {bnd['fwd'][1]}), fused backward {ms['bwd']:.4f} ms "
              f"(bound {bnd['bwd'][0]:.4f}, {bnd['bwd'][1]}); max_abs_err vs plain (dropout 0 "
              f"and 0.6) forward {shape_err['fwd']:.3e}, fused backward {shape_err['bwd']:.3e}",
              flush=True)
        del ld, ls, v, g, out_k, lse_k, delta, args
        torch.cuda.empty_cache()

    cfg.train.epochs = epochs
    torch.cuda.reset_peak_memory_stats(dev)
    fg.flash_fwd_launches = 0
    fg.flash_bwd_launches = 0
    result = run(cfg, ds, device=dev)
    torch.cuda.synchronize()
    launches = {"fwd": fg.flash_fwd_launches, "bwd": fg.flash_bwd_launches}
    losses = result["epoch_train_loss"]
    if len(losses) != epochs or not all(np.isfinite(losses)) or not np.isfinite(result["test_loss"]):
        fail(f"pubmed: losses {losses}, test loss {result['test_loss']}")
    if not losses[-1] < losses[0]:
        fail(f"pubmed: train loss did not fall: {losses[0]} -> {losses[-1]}")
    want = {"fwd": 2 * (2 * epochs + 1), "bwd": 2 * epochs}
    if launches != want or not result["captured"]:
        fail(f"pubmed: launches {launches}, want {want}; captured {result['captured']}")
    flash_ms = statistics.median(result["epoch_step_time_s"][1:]) * 1e3

    csr = preset("pubmed")
    csr.model.impl, csr.data.graph_format, csr.train.epochs = "csr", "csr", epochs
    torch.cuda.reset_peak_memory_stats(dev)
    fg.flash_fwd_launches = 0
    res_csr = run(csr, ds, device=dev)
    torch.cuda.synchronize()
    if fg.flash_fwd_launches or not np.isfinite(res_csr["epoch_train_loss"]).all():
        fail(f"pubmed csr: {fg.flash_fwd_launches} flash launches, losses "
             f"{res_csr['epoch_train_loss']}")
    csr_ms = statistics.median(res_csr["epoch_step_time_s"][1:]) * 1e3

    # -- phase 4k (pubmed): model.impl=auto on the BCSR graph, which sweeps
    # more tile elements an edge than the crossover, trains through csr on
    # the graph's edge view: no flash launch; at dropout 0 its losses are
    # those of graph_format=csr (the same edges, padded there)
    auto = preset("pubmed")
    auto.model.impl, auto.train.epochs = "auto", epochs
    fg.flash_fwd_launches = fg.flash_bwd_launches = 0
    res_auto = run(auto, ds, device=dev)
    torch.cuda.synchronize()
    if (fg.flash_fwd_launches or fg.flash_bwd_launches or not res_auto["captured"]
            or not np.isfinite(res_auto["epoch_train_loss"]).all()):
        fail(f"pubmed auto: flash launches {fg.flash_fwd_launches} + {fg.flash_bwd_launches} "
             f"(want 0), captured {res_auto['captured']}, losses {res_auto['epoch_train_loss']}")
    auto_ms = statistics.median(res_auto["epoch_step_time_s"][1:]) * 1e3
    at0 = {}
    for label, fmt, impl in (("auto", "bcsr", "auto"), ("csr", "csr", "csr")):
        c = preset("pubmed")
        c.data.graph_format, c.model.impl, c.train.epochs = fmt, impl, 5
        c.model.attn_drop = c.model.ffd_drop = 0.0
        at0[label] = run(c, ds, device=dev)["epoch_train_loss"]
    if not np.allclose(at0["auto"], at0["csr"], **CAPTURE_TOL):
        fail(f"pubmed auto against csr at dropout 0: {at0['auto']} against {at0['csr']}")
    print(f"pubmed, model.impl=auto (phase 4k): {graph.elems_per_edge():.1f} tile elements an "
          f"edge > {flash_csr_threshold(graph.bm, graph.bn)}: no flash launch; median step "
          f"epochs 2-{epochs} {auto_ms:.3f} ms (flash {flash_ms:.3f}, csr {csr_ms:.3f}); "
          f"max_memory_allocated {res_auto['max_memory_allocated']} B; at dropout 0 its losses "
          f"within {CAPTURE_TOL} of graph_format=csr (largest difference "
          f"{max(abs(a - b) for a, b in zip(at0['auto'], at0['csr'])):.3e}); {card}", flush=True)
    print(f"pubmed preset: losses {losses[0]:.5f} -> {losses[-1]:.5f}, test_acc "
          f"{result['test_acc']:.4f}; launches {launches}; median step epochs 2-{epochs}: "
          f"flash {flash_ms:.3f} ms, csr {csr_ms:.3f} ms (csr / flash "
          f"{csr_ms / flash_ms:.3f}); max_memory_allocated {result['max_memory_allocated']} B "
          f"(csr {res_csr['max_memory_allocated']} B); GAT flash vs csr max_abs_err "
          f"{gat_err:.3e}; {card}", flush=True)
    for label, preset_cfg in (("pubmed flash step", cfg), ("pubmed csr step", csr)):
        for capture in (None, False):
            profile_trainer(label, lambda: Trainer(
                ds, preset_cfg, device=dev, logger=MetricLogger(echo=False), capture=capture),
                card)
    return {"launches": launches, "err": err, "kernels": kernels}


def train_ppi(dev, card: str, epochs: int = 3) -> None:
    """Phase 4e: the ppi preset (GAT, hid (256, 256), heads (4, 4, 6),
    residual, no dropout; batches of 2 graphs, each one block-diagonal
    graph on the route impl=auto takes, flash here) through run() at full
    width on ppi_synthetic with PPI's shape: 24 graphs of 1,600-3,200
    nodes (about 2,400 a graph), 50 features, 121 labels; its train step
    and evaluation batches captured as CUDA graphs. Losses finite, the
    train loss falling, micro-F1 in [0, 1]. Then in deterministic mode
    (the flash kernels' split backward) the preset captured against an
    eager run of the same trainer (capture=False, with capturable Adam as
    the captured run's; the preset has no dropout): losses within
    CAPTURE_TOL. Every flash forward and fused backward launch of the
    preset's run, the replays included, must be a wide body's (each head
    is wider than 32). Phase 4e'': that deterministic
    run against the dense path (impl dense, captured): losses
    within CAPTURE_TOL, median steps and peaks printed. Phase 4e' (in
    deterministic mode): the inductive trainer's data-parallel batches on
    a one-rank NCCL world
    (the preset's widths, batches of 2, one epoch; captured, its axis
    holding no process group) against the one-device trainer (captured):
    train loss, test loss and micro-F1 within DP_TOL."""
    import copy

    import numpy as np
    import torch

    from han_tpu_torch.datasets.ppi import ppi_synthetic
    from han_tpu_torch.ops import flash_gat as fg
    from han_tpu_torch.parallel.mesh import make_mesh
    from han_tpu_torch.train.config import preset
    from han_tpu_torch.train.inductive import InductiveTrainer
    from han_tpu_torch.train.trainer import run

    t0 = time.perf_counter()
    ds = ppi_synthetic(n_graphs=24, nodes_per_graph=3200, n_feats=50, n_labels=121,
                       avg_degree=28, seed=0)
    sizes = ds.node_mask.sum(1)
    print(f"ppi_synthetic: {ds.n_graphs} graphs of {sizes.min()}-{sizes.max()} nodes "
          f"(mean {sizes.mean():.0f}), {int(ds.adj.sum())} edges, split "
          f"{np.bincount(ds.graph_split).tolist()}, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    cfg = preset("ppi")
    cfg.train.epochs = epochs
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    names = ("flash_fwd_launches", "flash_fwd_wide_launches", "flash_bwd_launches",
             "flash_bwd_wide_launches")
    before = [getattr(fg, name) for name in names]
    result = run(cfg, ds, device=dev)
    if not result["captured"]:
        fail("ppi: the inductive trainer's steps were not captured")
    # every head is wider than 32 on 128 x 128 tiles: each forward and fused
    # backward launch, the captured steps' replays included, is a wide body's
    fwd, fwd_wide, bwd, bwd_wide = (getattr(fg, name) - n for name, n in zip(names, before))
    if not (fwd_wide == fwd > 0 and bwd_wide == bwd > 0):
        fail("ppi: the trainer's flash launches were not all the wide bodies' "
             f"(forward {fwd_wide} of {fwd}, fused backward {bwd_wide} of {bwd})")
    print(f"ppi: flash launches forward {fwd_wide} of {fwd} wide, fused backward "
          f"{bwd_wide} of {bwd} wide", flush=True)
    losses = result["epoch_train_loss"]
    if len(losses) != epochs or not all(np.isfinite(losses)) or not np.isfinite(result["test_loss"]):
        fail(f"ppi: losses {losses}, test loss {result['test_loss']}")
    if not losses[-1] < losses[0]:
        fail(f"ppi: train loss did not fall: {losses}")
    if not 0.0 <= result["test_micro_f1"] <= 1.0:
        fail(f"ppi: test micro-F1 {result['test_micro_f1']}")
    print(f"ppi preset ({epochs} epochs, batches of 2 graphs): losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}, test micro-F1 "
          f"{result['test_micro_f1']:.4f}; median step {result['median_step_time_s'] * 1e3:.3f} "
          f"ms, max_memory_allocated {result['max_memory_allocated']} B; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cfg.train.checkpoint_dir = ""

    def deterministic(capturable_adam: bool = False, **kw):
        # the flash kernels' split backward (no atomics): trajectories that
        # differ only in how the step is dispatched stay equal, where the
        # fused backward's atomic sums and Adam's first steps on gradients
        # of round-off make two runs of 30 steps part by 1e-4. An eager run
        # takes capturable Adam, as the captured one must: eager Adam's
        # bias correction on the host parts the two from step 3 on (4.5e-6
        # of the loss) and 30 steps grow that to 1e-4-7e-4 a step
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            trainer = InductiveTrainer.from_config(ds, cfg, **kw)
            if capturable_adam:
                trainer.opt = torch.optim.Adam(trainer.model.parameters(), lr=cfg.train.lr,
                                               capturable=True)
            return trainer.fit(epochs=epochs, log=lambda rec: None)
        finally:
            torch.use_deterministic_algorithms(False)

    def largest_gap(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    split = deterministic(device=dev)
    eager = deterministic(device=dev, capture=False, capturable_adam=True)
    if (not split["captured"] or eager["captured"]
            or not np.allclose(split["epoch_train_loss"], eager["epoch_train_loss"],
                               **CAPTURE_TOL)):
        fail(f"ppi: captured losses {split['epoch_train_loss']} against eager "
             f"{eager['epoch_train_loss']} (captured {split['captured']}, {eager['captured']})")
    print(f"ppi preset, deterministic mode (the split backward), captured against eager "
          f"({epochs} epochs): losses within {CAPTURE_TOL} (largest relative difference "
          f"{largest_gap(split['epoch_train_loss'], eager['epoch_train_loss']):.3e}); "
          f"median step {split['median_step_time_s'] * 1e3:.3f} ms captured, "
          f"{eager['median_step_time_s'] * 1e3:.3f} ms eager; {card}", flush=True)
    # -- phase 4e'': the sparse batches (the preset) against the dense path
    dense_cfg = copy.deepcopy(cfg)
    dense_cfg.model.impl = "dense"
    torch.cuda.reset_peak_memory_stats(dev)
    dense = InductiveTrainer.from_config(ds, dense_cfg, device=dev).fit(
        epochs=epochs, log=lambda rec: None)
    if not np.allclose(split["epoch_train_loss"], dense["epoch_train_loss"], **CAPTURE_TOL):
        fail(f"ppi: sparse losses {split['epoch_train_loss']} against dense "
             f"{dense['epoch_train_loss']}")
    print(f"ppi preset, sparse ({result['route']}, the split backward) against dense "
          f"({epochs} epochs, both captured): losses within {CAPTURE_TOL} (largest relative "
          f"difference {largest_gap(split['epoch_train_loss'], dense['epoch_train_loss']):.3e}); "
          f"median step {result['median_step_time_s'] * 1e3:.3f} (the fused backward) against "
          f"{dense['median_step_time_s'] * 1e3:.3f} ms, max_memory_allocated "
          f"{result['max_memory_allocated']} / {dense['max_memory_allocated']} B; {card}",
          flush=True)

    # -- phase 4e': the data-parallel batches on a one-rank NCCL world
    with OneRankNCCL(dev):
        runs = {}
        for label, extra in (("one device", dict(device=dev)),
                             ("data-parallel", dict(mesh=make_mesh(graph=1, device=dev)))):
            t0 = time.perf_counter()
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                r = InductiveTrainer.from_config(ds, cfg, **extra).fit(epochs=1,
                                                                       log=lambda rec: None)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            runs[label] = dict(r, s=time.perf_counter() - t0)
    one, dp = runs["one device"], runs["data-parallel"]
    if not (one["captured"] and dp["captured"]):
        fail(f"phase 4e': captured {one['captured']} (one device), {dp['captured']} "
             "(data-parallel, one NCCL rank)")
    if not np.allclose(dp["epoch_train_loss"] + [dp["test_loss"], dp["test_micro_f1"]],
                       one["epoch_train_loss"] + [one["test_loss"], one["test_micro_f1"]],
                       **DP_TOL):
        fail(f"phase 4e': the data-parallel inductive trainer {dp['epoch_train_loss']} / "
             f"{dp['test_loss']} against {one['epoch_train_loss']} / {one['test_loss']}")
    print(f"ppi, data-parallel batches on one NCCL rank (phase 4e'), 1 epoch, both "
          f"captured: train loss {dp['epoch_train_loss'][0]:.6f} against "
          f"{one['epoch_train_loss'][0]:.6f}, test micro-F1 {dp['test_micro_f1']:.4f} "
          f"({DP_TOL}); median step {dp['median_step_time_s'] * 1e3:.3f} / "
          f"{one['median_step_time_s'] * 1e3:.3f} ms; "
          f"{dp['s']:.2f} / {one['s']:.2f} s; {card}", flush=True)


CAL_COUNTERS = {"prim": "prim_launches", "fwd_strip": "fwd_strip_launches",
                "fwd_strip_bf16": "fwd_strip_bf16_launches", "bwd_strip": "bwd_strip_launches"}
# instructions an element of each primitive pass, one a lane-op (the bound
# of phase 8a and the share printed by report_prims): add, mul and exp one
# op, lrelu and select a multiply and a max or select, rowmax an add and a
# max, rowsum a multiply and two adds
PRIM_OPS = {"add": 1, "mul": 1, "lrelu": 2, "select": 2, "exp": 1, "rowmax": 2, "rowsum": 3}


def check_calibration(dev) -> dict:
    """Phase 8a: each calibration kernel against its plain version at R =
    64 on the card-wide strip (132 x 8 tiles of 128 x 128): all 14
    primitive (op, dtype) pairs, the f32 forward body with and without
    p·v, the forward body with bf16 v and the backward body. Tolerances:
    f32 primitives atol 1e-5, rtol 1e-4 (the same ops; the row sums in
    another order); bf16 primitives rtol 2e-2 (bf16 steps); strips rtol
    1e-4 and atol 1e-5 of the largest |value| (sums of exps in another
    order over 64 chained passes, ex2 on log2e-scaled logits; the
    backward's output adds dv, dls and dld terms whose sum may be near 0).
    The strips take their products (p·v; g·v and c·g) as 3xTF32 on the
    tensor cores (two products a k step with bf16 v, exact in TF32):
    strip_tf32_control holds them to f32 accuracy. Per kernel: the largest
    error, device ms of the kernel and of its plain version (summed over
    the launches of the check) and the bound; the log line of each strip,
    whose body runs one ex2 on every swept element, adds the time of those
    elements at the SFU rate."""
    import torch

    from han_tpu_torch.ops import calibrate as cal

    n_strips, reps = 132 * 8, 64
    inp = {key: torch.from_numpy(x).to(dev) for key, x in cal.make_inputs(n_strips).items()}
    a = [inp[key] for key in ("ld", "ls", "adj", "v")]
    v16, g = inp["v"].to(torch.bfloat16), inp["g"]
    elems, edges = inp["x"].numel(), int((inp["adj"] != 0).sum())
    strip_bytes = sum(t.numel() * t.element_size() for t in a)
    card = cal.card_info()
    ceil = cal.ceilings(card["sms"], card["max_sm_clock_hz"])
    swept = reps * elems / EXP_PEAK * 1e3  # ms of one launch's swept elements, one ex2 each
    swept_ms = {"fwd_strip": 0.0, "fwd_strip_bf16": 0.0, "bwd_strip": 0.0}
    out = {key: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound": (0.0, "operations")}
           for key in CAL_COUNTERS}

    def add(key, name, kernel, plain, atol, rtol, bnd):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        st = out[key]
        st["err"] = max(st["err"], check(f"cal {name}", got.float(), want.float(), atol, rtol))
        st["ms"] += timed(kernel, reps=5)
        st["plain_ms"] += timed(plain, reps=5, host_waits=True)
        st["bound"] = (st["bound"][0] + bnd[0], bnd[1])
        if key in swept_ms:
            swept_ms[key] += swept

    # a primitive pass is instructions, one a lane-op, at the card's rates
    # (ops/calibrate.py:ceilings): PRIM_OPS an element in f32 or bf16, and
    # exp's one ex2 on the SFUs
    for op in cal.OPS:
        for x, dt in ((inp["x"], "f32"), (inp["x"].to(torch.bfloat16), "bf16")):
            t_bytes = 2 * x.numel() * x.element_size() / HBM_BW
            t_ops = max(reps * elems * PRIM_OPS[op] / ceil[dt],
                        (reps * elems if op == "exp" else 0) / ceil["exp"])
            bnd = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
            add("prim", f"{op} {x.dtype}", lambda x=x, op=op: cal.prim_cuda(x, op, reps),
                lambda x=x, op=op: cal.prim_plain(x, op, reps),
                1e-5, 2e-2 if dt == "bf16" else 1e-4, bnd)
    scaled = lambda want, f: f * float(want.abs().max())
    out_bytes = n_strips * 128 * 64 * 4
    for mxu in (False, True):
        want = cal.fwd_strip_plain(*a, reps, mxu)
        add("fwd_strip", f"fwd strip f32 mxu={mxu}", lambda mxu=mxu: cal.fwd_strip_cuda(*a, reps, mxu),
            lambda mxu=mxu: cal.fwd_strip_plain(*a, reps, mxu), scaled(want, 1e-5), 1e-4,
            bound(strip_bytes + out_bytes, reps * edges * 9, reps * edges,
                  mma_flops=reps * edges * 2 * 8 if mxu else 0))
    want = cal.fwd_strip_bf16_plain(*a[:3], v16, reps)
    add("fwd_strip_bf16", "fwd strip bf16 v", lambda: cal.fwd_strip_bf16_cuda(*a[:3], v16, reps),
        lambda: cal.fwd_strip_bf16_plain(*a[:3], v16, reps), scaled(want, 1e-5), 1e-4,
        bound(strip_bytes - a[3].numel() * 2 + out_bytes, reps * edges * 9, reps * edges,
              mma_flops=reps * edges * 2 * 8))
    want = cal.bwd_strip_plain(*a, g, reps)
    add("bwd_strip", "bwd strip", lambda: cal.bwd_strip_cuda(*a, g, reps),
        lambda: cal.bwd_strip_plain(*a, g, reps), scaled(want, 1e-5), 1e-4,
        bound(strip_bytes + g.numel() * 4 + out_bytes, reps * edges * 10,
              reps * edges, mma_flops=reps * edges * 4 * 8))
    strip_tf32_control("fwd strip f32 mxu=True", lambda: cal.fwd_strip_cuda(*a, reps, True),
                       lambda mm: cal.fwd_strip_plain(*a, reps, True, mm=mm))
    strip_tf32_control("fwd strip bf16 v", lambda: cal.fwd_strip_bf16_cuda(*a[:3], v16, reps),
                       lambda mm: cal.fwd_strip_bf16_plain(*a[:3], v16, reps, mm=mm))
    strip_tf32_control("bwd strip", lambda: cal.bwd_strip_cuda(*a, g, reps),
                       lambda mm: cal.bwd_strip_plain(*a, g, reps, mm=mm))
    for key, st in out.items():
        floor = (f", swept elements at the SFU rate {swept_ms[key]:.4f} ms"
                 if key in swept_ms else "")
        print(f"cal {key}: max_abs_err {st['err']:.3e}, kernel {st['ms']:.4f} ms, plain "
              f"{st['plain_ms']:.4f} ms, bound {st['bound'][0]:.4f} ms ({st['bound'][1]})"
              f"{floor} at R = {reps}", flush=True)
    del inp, a, v16, g
    torch.cuda.empty_cache()
    return out


def strip_tf32_control(name, kernel, plain) -> None:
    """Control of a strip's 3xTF32 products, as tf32_control for the
    flash kernels: the kernel's output and the plain version's with its
    products taken by fg.mm_3xtf32 (the kernels' split) each against the
    plain version with f32 products must be TF32_MARGIN times closer than
    the plain version with one TF32 product (fg.mm_1xtf32)."""
    import torch

    from han_tpu_torch.ops import flash_gat as fg

    want = plain(torch.matmul)
    got = {"kernel": kernel(), "3xTF32": plain(fg.mm_3xtf32), "1xTF32": plain(fg.mm_1xtf32)}
    torch.cuda.synchronize()
    err = {key: float((x - want).abs().max()) for key, x in got.items()}
    print(f"cal {name}, products: max_abs_err kernel {err['kernel']:.3e}, 3xTF32 mirror "
          f"{err['3xTF32']:.3e}, 1xTF32 {err['1xTF32']:.3e}", flush=True)
    for key in ("kernel", "3xTF32"):
        if not err[key] * TF32_MARGIN <= err["1xTF32"]:
            fail(f"cal {name}: the {key} error {err[key]:.3e} is not {TF32_MARGIN}x below one "
                 f"TF32 product's ({err['1xTF32']:.3e})")


def compare_strips(cal_result: dict, stats: dict, bf16: dict, tile_heads: int) -> dict:
    """Each strip's time a tile-head (the calibration run's ``tile_s``: one
    128x128 tile and one head on a full card) beside the flash kernel it
    tracks at DBLP's largest meta-path, dropout 0, from this run:
    fwd_strip_s_mxu against fwd_kernel, fwd_strip_s_bf16_mxu against
    fwd_kernel with bf16 v (``bf16``: check_dblp on bf16 v), bwd_strip_s_mxu
    against the fused bwd_col_kernel, each kernel's device ms over its
    tiles x heads. The strips stage nothing and walk no map, so each must
    take no longer than its kernel: bench_torch.py reads their times as a
    bound on the kernels' (tile_sol_frac)."""
    out = {}
    for key, flash, st in (("fwd_strip_s", "fwd", stats["fwd"]),
                           ("fwd_strip_s_mxu", "fwd", stats["fwd"]),
                           ("fwd_strip_s_bf16_mxu", "fwd bf16 v", bf16["fwd"]),
                           ("bwd_strip_s_mxu", "bwd", stats["bwd"])):
        strip_ns = cal_result["tile_s"][key] * 1e9
        flash_ns = st["ms_by_dropout"]["0.0"] * 1e6 / tile_heads
        out[key] = {"strip_ns": strip_ns, "flash": flash, "flash_ns": flash_ns,
                    "ratio": strip_ns / flash_ns}
        print(f"{key}: {strip_ns:.3f} ns a tile-head; flash {flash} at DBLP's largest meta-path, "
              f"dropout 0: {flash_ns:.3f} ns ({tile_heads} tile-heads); strip / flash "
              f"{strip_ns / flash_ns:.3f}", flush=True)
        if key != "fwd_strip_s" and strip_ns > flash_ns:
            fail(f"{key}: {strip_ns:.3f} ns a tile-head is above its flash kernel's "
                 f"{flash_ns:.3f} ns, so tile_sol_frac is no bound")
    return out


def report_prims(cal_result: dict) -> dict:
    """Each (op, dtype) primitive's rate from the calibration run, its share
    of its ceiling (ops/calibrate.py:ceilings) and of its bound rate: the
    PRIM_OPS instructions an element at the lane rate of its type (exp: at
    most the SFU rate), so that the passes still short of their bound
    show."""
    from han_tpu_torch.ops import calibrate as cal

    ceil, out = cal_result["ceilings_eps"], {}
    for key, rate in cal_result["prim_rates_eps"].items():
        op, dt = key.rsplit("_", 1)
        bound_eps = min(ceil[dt] / PRIM_OPS[op], ceil["exp"] if op == "exp" else math.inf)
        out[key] = {"eps": rate, "of_ceiling": rate / cal.prim_ceiling(op, dt, ceil),
                    "of_bound": rate / bound_eps}
        print(f"prim {key:11s}: {rate:.4e} elements/s, {out[key]['of_ceiling']:.3f} of its "
              f"ceiling, {out[key]['of_bound']:.3f} of its bound ({PRIM_OPS[op]} op(s) an "
              f"element: {bound_eps:.4e}/s)", flush=True)
    return out


def run_calibration(root) -> tuple[dict, dict]:
    """Phase 8b: scripts/cal_vpu_torch.py at its full R (16,384 primitive
    passes, 2,048 strip passes) on the card-wide strip; prints its JSON and
    returns the launches (each timing: ops/calibrate.py's
    LAUNCHES_PER_TIMING, two warm-up launches and seven timed pairs; the
    strip bodies: f32 with and without p·v, bf16, backward) and the
    calibration."""
    import runpy

    import torch

    from han_tpu_torch.ops import calibrate as cal

    for attr in CAL_COUNTERS.values():
        setattr(cal, attr, 0)
    cal.relaunches.clear()
    t0 = time.perf_counter()
    main = runpy.run_path(str(root / "scripts" / "cal_vpu_torch.py"), run_name="not_main")["main"]
    result = main(["--out", str(root / "build" / "CALIBRATION_H100.json")])
    torch.cuda.synchronize()
    n = {key: getattr(cal, attr) for key, attr in CAL_COUNTERS.items()}
    per = cal.LAUNCHES_PER_TIMING
    want = {"prim": 14 * per, "fwd_strip": 2 * per, "fwd_strip_bf16": per, "bwd_strip": per}
    want = {k: v + cal.relaunches.get(k, 0) for k, v in want.items()}
    if n != want:
        fail(f"calibration launches {n}, want {want}")
    print(f"calibration: {time.perf_counter() - t0:.2f} s, launches {n} (repeated behind a "
          f"longer spin: {dict(cal.relaunches)})", flush=True)
    print(json.dumps(result), flush=True)
    return n, result


def check_bench_shape(root, dev) -> dict:
    """Phase 9a: the flash kernels at the benchmark's shapes: its graphs
    (bench_torch.build_workload: N = n_pad = 8192, no padding rows, 2
    meta-paths in bfs order), K = D = 8, dropout 0, v in f32 and in bf16;
    forward, fused backward and both sweeps of each meta-path against their
    plain versions with the DBLP check's f32 tolerances (forward atol 1e-5,
    rtol 1e-4; backward atol 1e-4, rtol 1e-3), and tf32_control with f32 v.
    Returns the largest errors per kernel."""
    import runpy

    import torch

    from han_tpu_torch.graph.build import metapath_to_bcsr
    from han_tpu_torch.ops import flash_gat as fg

    build_workload = runpy.run_path(str(root / "bench_torch.py"),
                                    run_name="not_main")["build_workload"]
    ds, _, _ = build_workload(8192, 2, 128.0, "bfs")
    gen = torch.Generator(dev).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    k, d = 8, 8
    meta = fg.FlashMeta(slope=0.2)
    errs = {"fwd": 0.0, "bwd": 0.0, "row": 0.0, "col": 0.0}
    for name, adj in zip(ds.metapath_names, ds.metapath_adjs):
        graph = metapath_to_bcsr(adj).to(dev)
        n = graph.n_pad
        if n != ds.n_nodes:
            fail(f"bench graph {name}: n_pad {n}, want N = {ds.n_nodes} (no padding rows)")
        ld, ls, v32, g = rnd(k, n), rnd(k, n), rnd(n, k * d), rnd(n, k * d)
        for v in (v32, v32.to(torch.bfloat16)):
            print(f"bench shape, {name}: {graph.n_tiles} tiles, n_pad {n}, v {v.dtype}",
                  flush=True)
            out_k, lse_k = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
            out_p, lse_p = fg.flash_fwd_plain(graph, ld, ls, v, meta)
            torch.cuda.synchronize()
            errs["fwd"] = max(errs["fwd"], check("out", out_k, out_p, 1e-5, 1e-4),
                              check("lse", lse_k, lse_p, 1e-5, 1e-4))
            del out_p, lse_p
            delta = fg.head_delta(g, out_k, k)
            args = (graph, ld, ls, v, g, lse_k, delta, meta)
            errs["bwd"] = max(errs["bwd"], *(check(f"{t}", a, b, 1e-4, 1e-3) for t, a, b in zip(
                ("dld", "dls", "dv"), fg.flash_bwd_cuda(*args), fg.flash_bwd_plain(*args))))
            errs["row"] = max(errs["row"], check("dld (row sweep)", fg.flash_bwd_row_cuda(*args),
                                                 fg.flash_bwd_row_plain(*args), 1e-4, 1e-3))
            errs["col"] = max(errs["col"], *(check(f"{t} (column sweep)", a, b, 1e-4, 1e-3)
                                             for t, a, b in zip(("dls", "dv"),
                                                                fg.flash_bwd_col_cuda(*args),
                                                                fg.flash_bwd_col_plain(*args))))
            if v.dtype == torch.float32:
                tf32_control(f"bench shape, {name}", graph, ld, ls, v, g, meta)
            torch.cuda.empty_cache()
    return errs


def run_bench(root) -> dict:
    """Phase 9: bench_torch.py's f32 and bf16 arms (defaults: N = 8192, P =
    2, K = D = 8, degree 128, bfs order, 20 iterations; fwd+bwd and its
    profiled window, the dense baseline, then fwd alone) and its f32 arm at
    --dim 64 (han_tpu's DIM_SWEEP configuration: heads in chunks; its
    roofline still prices the D = 8 strips, a loose bound there), each
    printing its JSON line; the flash and in-process calibration launches
    are exact. Returns the flash launches at D = 8 ("d8") and 64 ("d64")."""
    import runpy

    import torch

    from han_tpu_torch.ops import calibrate as cal
    from han_tpu_torch.ops import flash_gat as fg

    bench = runpy.run_path(str(root / "bench_torch.py"), run_name="not_main")
    main = bench["main"]
    calls, n_mp = 2 + 5 * 20, 2  # warm-up + best of 5 x 20 iterations
    main_calls = calls + bench["PROFILED"]  # fwd+bwd: and the profiled window
    total = {"d8": {"fwd": 0, "bwd": 0}, "d64": {"fwd": 0, "bwd": 0}}
    for arm, argv in (("f32", []), ("bf16", ["--dtype", "bfloat16"]),
                      ("f32 D = 64", ["--dim", "64"])):
        fg.flash_fwd_launches = fg.flash_bwd_launches = 0
        for attr in CAL_COUNTERS.values():
            setattr(cal, attr, 0)
        cal.relaunches.clear()
        t0 = time.perf_counter()
        res = main(argv)
        torch.cuda.synchronize()
        n = {"fwd": fg.flash_fwd_launches, "bwd": fg.flash_bwd_launches,
             **{key: getattr(cal, attr) for key, attr in CAL_COUNTERS.items()}}
        per = cal.LAUNCHES_PER_TIMING
        want = {"fwd": n_mp * (main_calls + calls), "bwd": n_mp * main_calls, "prim": 0,
                "fwd_strip": 2 * per, "fwd_strip_bf16": per, "bwd_strip": per}
        # a timed launch repeated behind a longer spin (ops/calibrate.py)
        want = {k: v + cal.relaunches.get(k, 0) for k, v in want.items()}
        if n != want:
            fail(f"bench {arm}: launches {n}, want {want}")
        if not (res["value"] > 0 and res["vs_baseline"] and "roofline" in res["detail"]):
            fail(f"bench {arm}: {res}")
        print(f"bench {arm}: {time.perf_counter() - t0:.2f} s, launches {n} (repeated behind a "
              f"longer spin: {dict(cal.relaunches)})", flush=True)
        into = total["d64" if "--dim" in argv else "d8"]
        into["fwd"] += n["fwd"]
        into["bwd"] += n["bwd"]
    return total


if __name__ == "__main__":
    main()
