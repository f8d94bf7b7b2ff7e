"""The float64 witness of a GAT cell's compared numbers (``reference/gat.py``),
in one process on the card; the benchmark's own runs never run this.
``control.py --witness-seeds`` reads HAN's references; this is its GAT
counterpart.

For each seed: the program's first steps and the validation passes after
each of them through the cell's own loop (its set-up), and the plain
reference's record of the same steps with the validation pass after each
of ``EVALS``, in float32, in float64 (the same inputs and weights, every
tensor in float64) and in float32 from weights nudged by one ulp in a
random half of their elements (``--nudges`` times). Each is read against
the float32 reference, and the program and the float32 reference each
against the float64 one: ``compare.numbers``, and the gap of every
validation pass (``eval_gaps``). Where the program departs from the
float32 reference by what the float32 reference departs from float64, or a
nudged reference from it, the departure is round-off and not a fault.

    python3 benchmark/witness_gat.py --workload gat_ppi.inductive \
        --seed-list 4000000007 --out witness.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ["OMP_NUM_THREADS"] = "1"  # as benchmark/run.py runs the program

from benchmark import compare, harness  # noqa: E402

EVALS = (1, 2, 3)  # the validation passes read: after each warm step


def follow(ctx, loop, reference, params0: dict, dtype, **kw):
    """The reference's record of the warm steps from ``params0``, every
    tensor in ``dtype``, with the validation pass after each of EVALS."""
    def cast(b):
        return dataclasses.replace(b, graphs=[
            dataclasses.replace(g, x=g.x.to(dtype), labels=g.labels.to(dtype))
            for g in b.graphs])

    batches, evals = loop.reference_plan(ctx)
    val = [cast(b) for b in next(iter(evals.values()))]
    return reference.follow(ctx.settings, {k: v.to(dtype) for k, v in params0.items()},
                            [cast(b) for b in batches], evals={t: val for t in EVALS},
                            gen_seed=ctx.train_seed + 1, device=ctx.device,
                            **kw)


def eval_gaps(prog, ref) -> list:
    return [abs(p - r) / abs(r) for p, r in zip(prog.evals, ref.evals)]


def readings(root, c: dict, seed: int, device, nudges: int) -> dict:
    import torch

    loop = harness._load("loops", c["traffic"]["loop"])
    reference = harness._load("reference", c["config"]["family"])
    with tempfile.TemporaryDirectory(prefix="bench-ckpt-") as ckpt:
        ctx = harness.make_context(root, c, seed, device, checkpoint_dir=ckpt)
        st = loop.start(ctx)
        del st["trainer"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    p0, prog = st["params0"], st["program"]
    ref = follow(ctx, loop, reference, p0, torch.float32)
    ref64 = follow(ctx, loop, reference, p0, torch.float64)
    out = {"seed": seed, "prog_evals": prog.evals, "ref_evals": ref.evals,
           "ref64_evals": ref64.evals,
           "prog_vs_ref": compare.numbers(prog, ref, p0), "prog_eval_gaps": eval_gaps(prog, ref),
           "prog_vs_f64": compare.numbers(prog, ref64, p0),
           "prog_eval_gaps_f64": eval_gaps(prog, ref64),
           "ref_vs_f64": compare.numbers(ref, ref64, p0), "ref_eval_gaps_f64": eval_gaps(ref, ref64),
           "nudged": []}
    for i in range(nudges):
        g = torch.Generator().manual_seed(i)
        moved = {}
        for k, v in p0.items():
            up = (torch.rand(v.shape, generator=g) < 0.5).to(v.device)
            moved[k] = torch.where(up, torch.nextafter(v, torch.full_like(v, torch.inf)), v)
        rec = follow(ctx, loop, reference, moved, torch.float32)
        out["nudged"].append({"vs_ref": compare.numbers(rec, ref, p0),
                              "eval_gaps": eval_gaps(rec, ref)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed-list", required=True, help="comma-separated seeds")
    p.add_argument("--nudges", type=int, default=4)
    p.add_argument("--out", required=True)
    p.add_argument("--cpu-dry-run", action="store_true", help="for the CPU tests only")
    args = p.parse_args(argv)
    import torch

    c = harness.load_cell(harness.ROOT, args.workload)
    device = torch.device("cpu" if args.cpu_dry_run else "cuda")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for seed in (int(x) for x in args.seed_list.split(",")):
            row = readings(harness.ROOT, c, seed, device, args.nudges)
            f.write(json.dumps({"workload": args.workload, **row}) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
