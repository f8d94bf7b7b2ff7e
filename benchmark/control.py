"""Readings that set a cell's limits (``limits/<cell>.json``), in one process
on the card; the benchmark's own runs never run this.

For each seed: the cell's inputs and weights, the program's first steps
and evaluations through the cell's own loop (its set-up), and the plain
reference's; the compared numbers of that sound run. For the first
``--control-seeds`` seeds also the control and the faults, each put in the
program's place and read against the reference as the program is:

- ``tf32``: the reference with every product taken in TF32, the nearest
  precision below the configuration's float32;
- ``half_batch``: the loss the mean over half of the batch's rows;
- ``altered``: one row's logit raised by 1 where it is produced (in the
  steps and in the evaluations).

A state left unchanged reads 1 on ``update_gap`` and ``median_update_gap``
by their measure and needs no run. Writes one JSON line a seed to
``--out`` and prints, for each number, the largest sound reading and the
smallest reading of each fault.

With ``--witness-seeds n`` the first n seeds also get the look at what
round-off does to the numbers: the program and the float32 reference
each against the reference in float64 (``witness``), the smallest leaky
ReLU input of each sampled attention call (``knees``), and the reference
from weights nudged by one ulp against the reference (``nudged``).

    python3 benchmark/control.py --workload han_dblp.full --seeds 12 --out chiprun_out/c.jsonl
    python3 benchmark/control.py --workload han_sampled_100m.device --seed-list 410569717 \
        --control-seeds 0 --witness-seeds 1 --out chiprun_out/w.jsonl
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import statistics
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ["OMP_NUM_THREADS"] = "1"  # as benchmark/run.py runs the program

from benchmark import compare, harness  # noqa: E402

FIRST_SEED = 3_000_000_001  # past 2**31, as the driver's seeds are
FAULTS = (("tf32", {"products": "tf32"}), ("half_batch", {"fault": "half_batch"}),
          ("altered", {"fault": "altered"}))


def follow64(ctx, loop, reference, params0: dict):
    """The reference's record in float64: the same steps, inputs and
    dropout masks (drawn as float32 uniforms, as in float32) with every
    tensor in float64, the witness of what float32 round-off does."""
    import dataclasses

    def cast(b):
        return dataclasses.replace(b, x=[x.double() for x in b.x], labels=b.labels.double(),
                                   mask=b.mask.double())

    batches, evals = loop.reference_plan(ctx)
    return reference.follow(ctx.settings, {k: v.double() for k, v in params0.items()},
                            [cast(b) for b in batches],
                            evals={t: [cast(b) for b in bs] for t, bs in evals.items()},
                            gen_seed=ctx.train_seed + 1, device=ctx.device)


def witness(prog, ref, ref64, params0: dict, top: int = 6) -> dict:
    """The program and the float32 reference each against the float64
    reference: the compared numbers, each step's loss gap, and for the
    leaf that reads most on ``update_gap`` the elements whose change
    differs most between program and reference."""
    import torch

    def steps(rec):
        return [abs(a - b) / abs(b) for a, b in zip(rec.losses, ref64.losses)]

    keep = compare.moving(ref.grads)
    worst = next(iter(leaves(prog, ref, params0, top=1)))
    p0 = params0[worst]
    dp = (prog.params[worst].to(p0.device) - p0).flatten()
    dr = (ref.params[worst] - p0).flatten()
    d64 = (ref64.params[worst] - p0.double()).flatten()
    order = torch.argsort((dp - dr).abs(), descending=True)[:top].tolist()
    rms = statistics.median(float(torch.linalg.vector_norm(g.double())) / g.numel() ** 0.5
                            for g in ref.grads.values())
    return {"prog_vs_f64": compare.numbers(prog, ref64, params0),
            "ref_vs_f64": compare.numbers(ref, ref64, params0),
            "steps_prog_vs_f64": steps(prog), "steps_ref_vs_f64": steps(ref),
            "leaf": worst, "median_rms_grad": rms,
            "elements": [{"i": i, "kept": bool(keep[worst].flatten()[i]),
                          "g_prog": float(prog.grads[worst].flatten()[i]),
                          "g_ref": float(ref.grads[worst].flatten()[i]),
                          "g_f64": float(ref64.grads[worst].flatten()[i]),
                          "d_prog": float(dp[i]), "d_ref": float(dr[i]), "d_f64": float(d64[i])}
                         for i in order]}


def knees(ctx, loop, reference, params0: dict) -> list:
    """The reference's steps again, reading in every sampled attention call
    (a tower of a step, then of the evaluation) the smallest |z| over the
    real edges of z = e_dst + e_src, the leaky ReLU's input: near 0 the
    round-off of e_dst and e_src decides its slope, 1 or 0.2, in the
    backward."""
    import torch

    seen = []
    inner = reference._ell_attention

    def spy(nbr, ld, ls, *args):
        n = ld.shape[0]
        valid = nbr < n
        raw = (ld[:, None, :] + ls[torch.where(valid, nbr, 0)]).abs()
        raw = torch.where(valid[:, :, None], raw, torch.inf)
        seen.append({"min_abs_z": float(raw.min()),
                     "under_1e-6": int((raw < 1e-6).sum()),
                     "scale": float(ld.abs().max() + ls.abs().max())})
        return inner(nbr, ld, ls, *args)

    reference._ell_attention = spy
    try:
        harness.follow(ctx, loop, reference, params0)
    finally:
        reference._ell_attention = inner
    return seen


def nudged(ctx, loop, reference, params0: dict, ref, n: int = 4) -> list:
    """The reference from ``params0`` moved by one float32 ulp in a random
    half of its elements, ``n`` times, each against the reference: what a
    round-off of the size of the program's does to the compared numbers."""
    import torch

    out = []
    for i in range(n):
        g = torch.Generator().manual_seed(i)
        moved = {}
        for k, v in params0.items():
            up = (torch.rand(v.shape, generator=g) < 0.5).to(v.device)
            moved[k] = torch.where(up, torch.nextafter(v, torch.full_like(v, torch.inf)), v)
        out.append(compare.numbers(harness.follow(ctx, loop, reference, moved), ref, params0))
    return out


def readings(root, c: dict, seed: int, device, control: bool, with_witness=False) -> dict:
    import torch

    loop = harness._load("loops", c["traffic"]["loop"])
    reference = harness._load("reference", c["config"]["family"])
    with tempfile.TemporaryDirectory(prefix="bench-ckpt-") as ckpt:
        ctx = harness.make_context(root, c, seed, device, checkpoint_dir=ckpt)
        st = loop.start(ctx)
        del st["trainer"]
        st.pop("guard", None)
        st.pop("epoch", None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def follow(**kw):
        return harness.follow(ctx, loop, reference, st["params0"], **kw)

    ref = follow()
    out = {"seed": seed, "sound": compare.numbers(st["program"], ref, st["params0"]),
           "losses": st["program"].losses, "ref_losses": ref.losses,
           "evals": st["program"].evals, "ref_evals": ref.evals,
           "still": compare.still(ref.grads),
           "leaves": leaves(st["program"], ref, st["params0"], top=len(ref.grads))}
    if with_witness:
        out["witness"] = witness(st["program"], ref,
                                 follow64(ctx, loop, reference, st["params0"]), st["params0"])
        out["knees"] = knees(ctx, loop, reference, st["params0"])
        out["nudged"] = nudged(ctx, loop, reference, st["params0"], ref)
    if control:
        for name, kw in FAULTS:
            rec = follow(**kw)
            out[name] = compare.numbers(rec, ref, st["params0"])
            out[name + "_losses"] = rec.losses
            out[name + "_leaves"] = leaves(rec, ref, st["params0"], top=len(ref.grads))
    return out


def leaves(prog, ref, params0: dict, top: int = 4) -> dict:
    """The ``top`` leaves that read most on ``update_gap``: leaf → its gap
    (``compare.leaf_gaps``)."""
    keep = compare.moving(ref.grads)
    names = sorted(keep)
    gaps = compare.leaf_gaps(
        {k: (prog.params[k].to(params0[k].device) - params0[k])[keep[k]] for k in names},
        {k: (ref.params[k].to(params0[k].device) - params0[k])[keep[k]] for k in names}, names)
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:top])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seed-list", default="",
                   help="comma-separated seeds to read in place of the default run of seeds")
    p.add_argument("--witness-seeds", type=int, default=0,
                   help="for the first n seeds also the float64 reference's witness")
    p.add_argument("--out", required=True)
    p.add_argument("--cpu-dry-run", action="store_true", help="for the CPU tests only")
    args = p.parse_args(argv)
    import torch

    root = harness.ROOT
    c = harness.load_cell(root, args.workload)
    device = torch.device("cpu" if args.cpu_dry_run else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        seeds = ([int(x) for x in args.seed_list.split(",")] if args.seed_list
                 else [FIRST_SEED + 7919 * i for i in range(args.seeds)])
        for i, seed in enumerate(seeds):
            row = readings(root, c, seed, device, i < args.control_seeds,
                           i < args.witness_seeds)
            rows.append(row)
            f.write(json.dumps({"workload": args.workload, **row}) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)
    summary = {k: {"sound_max": max(r["sound"][k] for r in rows)} for k in compare.NUMBERS}
    for name, _ in FAULTS:
        for k in compare.NUMBERS:
            vals = [r[name][k] for r in rows if name in r]
            if vals:
                summary[k][f"{name}_min"] = min(vals)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
