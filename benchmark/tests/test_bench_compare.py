"""The compared numbers: what each reads, and that a cell is judged by the
numbers its limits name and by no other."""

import json

import pytest
import torch

from benchmark import compare, harness
from benchmark.reference.han import Record

LEAVES = {f"leaf{i}": (8, 8) for i in range(5)}


def _records(*, third_loss=2.0, moved=1.0):
    """A reference and a program record three steps from ``params0``; the
    program's third loss is ``third_loss`` and its first leaf moves
    ``moved`` times as far as the reference's."""
    g = torch.Generator().manual_seed(3)
    params0 = {k: torch.randn(s, generator=g) for k, s in LEAVES.items()}
    grads = {k: 1.0 + torch.rand(s, generator=g) for k, s in LEAVES.items()}
    step = {k: 0.01 * torch.sign(v) for k, v in grads.items()}
    ref = Record([2.2, 2.1, 2.0], grads, {k: params0[k] - step[k] for k in LEAVES}, [2.05])
    prog_params = {k: params0[k] - (moved if k == "leaf0" else 1.0) * step[k] for k in LEAVES}
    prog = Record([2.2, 2.1, third_loss], {k: v.clone() for k, v in grads.items()},
                  prog_params, [2.05])
    return prog, ref, params0


def test_sound_records_read_zero():
    prog, ref, params0 = _records()
    nums = compare.numbers(prog, ref, params0)
    assert set(nums) == set(compare.NUMBERS)
    assert all(v == pytest.approx(0.0, abs=1e-12) for v in nums.values()), nums


def test_the_first_loss_gap_reads_the_first_step_alone():
    prog, ref, params0 = _records(third_loss=2.0 * (1 + 1e-5))
    nums = compare.numbers(prog, ref, params0)
    assert nums["loss_gap"] == pytest.approx(1e-5, rel=1e-3)
    assert nums["first_loss_gap"] == 0.0


def test_the_median_update_gap_reads_past_one_leaf():
    prog, ref, params0 = _records(moved=1.5)
    nums = compare.numbers(prog, ref, params0)
    assert nums["update_gap"] == pytest.approx(0.5, rel=1e-5)  # float32 steps
    assert nums["median_update_gap"] == pytest.approx(0.0, abs=1e-12)
    # a state left unchanged reads 1 on both
    frozen = Record(prog.losses, prog.grads, params0, prog.evals)
    nums = compare.numbers(frozen, ref, params0)
    assert nums["update_gap"] == pytest.approx(1.0) == nums["median_update_gap"]


def test_a_cell_is_judged_by_the_numbers_its_limits_name():
    nums = {k: 1.0 for k in compare.NUMBERS}
    nums["first_loss_gap"] = 0.0
    assert compare.verdict(nums, {"first_loss_gap": 1e-7})
    assert not compare.verdict(nums, {"first_loss_gap": 1e-7, "loss_gap": 1e-7})


def test_limits_that_name_an_unknown_number_are_refused(tiny_checkout):
    path = tiny_checkout / "benchmark" / "limits" / "tiny_sampled.device.json"
    path.write_text(json.dumps({"loss_gap_typo": 1e-6}))
    with pytest.raises(ValueError, match="loss_gap_typo"):
        harness.load_cell(tiny_checkout / "benchmark", "tiny_sampled.device")
