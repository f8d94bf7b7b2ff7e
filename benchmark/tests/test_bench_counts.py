"""The operation, byte and exp counts against hand counts on a tiny graph,
and the metric readers' arithmetic on a made-up run."""

import json
import pathlib

import numpy as np
import pytest

from benchmark.counts import han
from benchmark.metrics import (device_idle_share, flash_roofline, launches_per_step,
                               peak_mem_gib, step_mfu, train_step_ms,
                               train_step_ms_p95)

BENCH = pathlib.Path(__file__).resolve().parents[1]
SETTINGS = {"model": {"n_heads": [2, 1], "hid_units": [3], "semantic_dim": 4}}
SHAPE = {"n_rows": 4, "edges": [6, 7], "in_dim": 5, "n_classes": 3}
PEAKS = {k: v["value"] for k, v in json.loads((BENCH / "peaks.json").read_text()).items()
         if isinstance(v, dict)}


def test_forward_flops_by_hand():
    # N = 4 rows, edges 6 and 7: per tower 2·4·5·2·3 + 4·4·2·3 + 2·E·2·3
    towers = (240 + 96 + 72) + (240 + 96 + 84)
    semantic = 2 * 4 * 2 * 6 * 4 + 2 * 4 * 2 * 4
    classifier = 2 * 4 * 6 * 3
    assert han.forward_flops(SETTINGS, SHAPE, [6, 7]) == towers + semantic + classifier


def test_model_flops_counts_train_as_three_forwards():
    f = han.forward_flops(SETTINGS, SHAPE, [6, 7])
    assert han.model_flops(SETTINGS, SHAPE, 10, 4) == 3 * 10 * f + 4 * f


def test_flash_pass_by_hand():
    peaks = {"sfu_exp_per_s": 1.0, "tf32x3_flops": 1e9, "hbm_bytes_per_s": 1e9}
    # E = 6 edges, K = 2 heads: 12 exps bound at 1/s
    assert han.flash_pass_s(SETTINGS, 4, 6, False, peaks) == 12.0
    peaks = {"sfu_exp_per_s": 1e12, "tf32x3_flops": 1.0, "hbm_bytes_per_s": 1e12}
    assert han.flash_pass_s(SETTINGS, 4, 6, False, peaks) == 2 * 6 * 2 * 3
    assert han.flash_pass_s(SETTINGS, 4, 6, True, peaks) == 4 * 6 * 2 * 3
    peaks = {"sfu_exp_per_s": 1e12, "tf32x3_flops": 1e12, "hbm_bytes_per_s": 1.0}
    # forward: ld, ls, lse (K·N f32 each), v and out (N·K·D f32 each)
    assert han.flash_pass_s(SETTINGS, 4, 6, False, peaks) == 3 * 4 * 2 * 4 + 2 * 4 * 4 * 6
    assert han.flash_pass_s(SETTINGS, 4, 6, True, peaks) == 6 * 4 * 2 * 4 + 3 * 4 * 4 * 6


def test_flash_least_counts_passes():
    fwd = sum(han.flash_pass_s(SETTINGS, 4, e, False, PEAKS) for e in (6, 7))
    bwd = sum(han.flash_pass_s(SETTINGS, 4, e, True, PEAKS) for e in (6, 7))
    assert han.flash_least_s(SETTINGS, SHAPE, 3, 2, PEAKS) == pytest.approx(3 * (fwd + bwd)
                                                                         + 2 * fwd)


def _run(trace=True):
    return {"setup_s": 9.0, "window_s": 2.0, "t0": 0.0, "reads": list(np.arange(1, 41) * 0.05),
            "train_steps": 40, "eval_steps": 40, "peak_bytes": 2 ** 29,
            "trace": {"busy_s": 0.5, "trace_window_s": 2.0, "launches": 80,
                      "group_s": {"flash": 0.01}} if trace else None,
            "settings": SETTINGS, "shape": SHAPE, "peaks": PEAKS, "counts": han}


def test_readers():
    run = _run()
    assert train_step_ms.read(run) == pytest.approx(50.0)
    assert train_step_ms_p95.read(run) == pytest.approx(50.0)
    assert peak_mem_gib.read(run) == 0.5
    assert device_idle_share.read(run) == pytest.approx(75.0)
    assert launches_per_step.read(run) == 2.0
    flops = han.model_flops(SETTINGS, run["shape"], 40, 40)
    assert step_mfu.read(run) == pytest.approx(flops / (2.0 * 495e12) * 100)
    least = han.flash_least_s(SETTINGS, run["shape"], 40, 40, PEAKS)
    assert flash_roofline.read(run) == pytest.approx(least / 0.01 * 100)


def test_readers_find_nothing_without_a_trace():
    run = _run(trace=False)
    for reader in (device_idle_share, launches_per_step, step_mfu, flash_roofline):
        assert reader.read(run) is None
