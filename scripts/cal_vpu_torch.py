"""Calibrate the compute side of the flash kernels' roofline on the card —
the PyTorch + CUDA counterpart of scripts/cal_vpu.py:main.

Times the hand-written calibration kernels (han_tpu_torch/csrc/calibrate.cu)
as the marginal time between R and 2R in-kernel passes over data held on
chip (ops/calibrate.py:time_marginal: CUDA events behind a spin, a warm-up
call of each length, the median of 7 interleaved pairs):

- the primitive passes (add, mul, lrelu, select, exp, rowmax, rowsum) in
  float32 and bfloat16 → elements/s of one pass, ``prim_rates_eps``;
- the flash forward's per-(head, tile) body without and with p·v, with
  f32 v and with bf16 v (the bf16 flash forward's body), and the fused
  backward's → seconds per pass over the card-wide strip,
  ``fwd_strip_s``, ``fwd_strip_s_mxu``, ``fwd_strip_s_bf16_mxu``,
  ``bwd_strip_s_mxu``.

The card-wide strip is ``--bm`` × ``--sub`` elements cut into the port's
128×128 flash tiles, one thread block each; ``elems_per_strip`` is its
element count, so a key's seconds over ``elems_per_strip`` is the card's
time per element (bench_torch.py divides by it, as bench.py does), and
``tile_s`` holds the time of one 128×128 tile and one head on a full card.
Each rate is held to its ceiling from the card's SM count and maximum SM
clock (csrc/calibrate.cu's header): above 105 % of it the compiler folded
the chain, and the script fails. ``--out`` (default
results/CALIBRATION_H100.json) gets the JSON, with the card's name and
power limit under ``device``.

    python3 scripts/cal_vpu_torch.py
    python3 scripts/cal_vpu_torch.py --strips-only --strip-reps 512

Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--strips-only", action="store_true",
                   help="skip the primitive-rate sweep; merge strip times into the --out json")
    p.add_argument("--bm", type=int, default=16896, help="card-wide strip rows (132 x 128)")
    p.add_argument("--sub", type=int, default=1024, help="card-wide strip columns (8 x 128)")
    p.add_argument("--d", type=int, default=8)
    p.add_argument("--reps", type=int, default=16384)
    p.add_argument("--strip-reps", type=int, default=2048)
    p.add_argument("--out", default="results/CALIBRATION_H100.json")
    args = p.parse_args(argv)

    import torch

    from han_tpu_torch.ops.calibrate import calibrate, check_ceilings

    if not torch.cuda.is_available():
        sys.exit("cal_vpu_torch: CUDA is not available; the calibration times the card "
                 "and never the CPU")
    out = pathlib.Path(args.out)
    if not out.is_absolute():
        out = ROOT / out
    previous = None
    if args.strips_only and out.exists():
        previous = json.loads(out.read_text())
    result = calibrate(args.bm, args.sub, args.d, args.reps, args.strip_reps,
                       args.strips_only, previous)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1) + "\n")
    print(f"wrote {out.relative_to(ROOT) if out.is_relative_to(ROOT) else out}", flush=True)
    bad = check_ceilings(result)
    if bad:
        raise RuntimeError("calibrated rates above their ceilings (a folded chain):\n"
                           + "\n".join(bad))
    return result


if __name__ == "__main__":
    main()
