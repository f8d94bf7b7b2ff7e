"""The benchmark path's host code against han_tpu's: the node orderings of
graph/reorder.py, bench_torch.py's workload and roofline against bench.py's
(l.126-135, 229-259), the profiling utilities, and the two benchmark
scripts and chip_smoke.py refusing to run without a card."""

import json
import runpy

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from han_tpu.graph import reorder as jreorder  # noqa: E402
from han_tpu.graph import synthetic as jsyn  # noqa: E402
from han_tpu.graph.build import metapath_to_csr as j_csr  # noqa: E402
from han_tpu_torch.graph import reorder as treorder  # noqa: E402
from han_tpu_torch.graph import synthetic as tsyn  # noqa: E402
from han_tpu_torch.utils import prof  # noqa: E402

PLANTED = dict(n_nodes=300, n_feats=16, n_classes=3, n_metapaths=2, avg_degree=8.0,
               train_per_class=20, n_val=30, seed=4)


@pytest.fixture(scope="module")
def bench_torch():
    return runpy.run_path("bench_torch.py", run_name="not_main")


@pytest.mark.parametrize("method", ["bfs", "labels", "degree"])
def test_orderings_match_han_tpu(method):
    jds, tds = jsyn.planted_hetero(**PLANTED), tsyn.planted_hetero(**PLANTED)
    perm = treorder.ordering(tds, method)
    np.testing.assert_array_equal(perm, jreorder.ordering(jds, method))
    j, t = jreorder.reorder(jds, method), treorder.reorder(tds, method)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for a, b in zip(t.metapath_adjs, j.metapath_adjs):
        assert (a != b).nnz == 0
    assert treorder.block_density(t.metapath_adjs[0], 64) == jreorder.block_density(
        j.metapath_adjs[0], 64)


def test_bench_workload_matches_bench_py(bench_torch):
    """bench.py's graphs at N=512 (planted_hetero, bfs order, CSR with
    self-loops) and its total_edges."""
    ds, graphs, total = bench_torch["build_workload"](512, 2, 128.0, "bfs")
    jds = jreorder.reorder(jsyn.planted_hetero(
        n_nodes=512, n_feats=64, n_classes=3, n_metapaths=2, avg_degree=128.0,
        train_per_class=100, n_val=100, seed=0), "bfs")
    jgraphs = [j_csr(a) for a in jds.metapath_adjs]
    assert total == sum(g.n_edges for g in jgraphs)
    for t, j in zip(graphs, jgraphs):
        np.testing.assert_array_equal(t.col_idx.numpy(), np.asarray(j.col_idx))
        np.testing.assert_array_equal(t.row_ptr.numpy(), np.asarray(j.row_ptr))
    np.testing.assert_array_equal(ds.features, jds.features)


def test_roofline_is_bench_py_formula(bench_torch):
    """bench_torch.roofline with bench.py's constants (v5e HBM 819e9 B/s,
    its fallback strip times) gives bench.py:229-259's numbers."""
    tiles = [(40, 128, 128, 0.31), (25, 128, 128, 0.2)]
    k, d, n, total, t_main = 8, 8, 4096, 300_000, 2.5e-3
    cal = {"elems_per_strip": 512 * 2048, "fwd_strip_s_mxu": 4.72e-6, "bwd_strip_s_mxu": 7.30e-6}
    hbm = 819e9
    for fwd_only in (False, True):
        got = bench_torch["roofline"](
            tiles, total_edges=total, n=n, k=k, d=d, t_main=t_main, fwd_only=fwd_only,
            t_fwd_strip=cal["fwd_strip_s_mxu"], t_bwd_strip=cal["bwd_strip_s_mxu"],
            elems_per_strip=cal["elems_per_strip"], hbm_bw=hbm)
        # bench.py:231-257, written out
        tile_area = sum(t * bm * bn for t, bm, bn, _ in tiles)
        t_strip = cal["fwd_strip_s_mxu"] + (0 if fwd_only else cal["bwd_strip_s_mxu"])
        t_comp = tile_area / cal["elems_per_strip"] * k * t_strip
        passes = 1 if fwd_only else 2
        t_hbm = passes * (tile_area + sum(t * bn * k * d * 4 for t, _, bn, _ in tiles)) / hbm
        t_edge = max(total / cal["elems_per_strip"] * k * t_strip,
                     passes * (total * (1 + k * 4) + n * k * d * 4) / hbm)
        assert got["tile_sol_ms"] == pytest.approx(max(t_comp, t_hbm) * 1e3, rel=1e-12)
        assert got["tile_sol_frac"] == pytest.approx(max(t_comp, t_hbm) / t_main, rel=1e-12)
        assert got["edge_sol_ms"] == pytest.approx(t_edge * 1e3, rel=1e-12)
        assert got["tile_compute_bound"] == (t_comp >= t_hbm)
        assert got["occupancy"] == pytest.approx(np.mean([0.31, 0.2]))


@pytest.mark.parametrize("script", ["bench_torch.py", "scripts/cal_vpu_torch.py"])
def test_benchmarks_refuse_to_run_without_a_card(monkeypatch, script, tmp_path):
    """No card: exit non-zero with a message, print no result, write no
    calibration file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = runpy.run_path(script, run_name="not_main")["main"]
    out = tmp_path / "cal.json"
    with pytest.raises(SystemExit) as exc:
        main(["--out", str(out)] if "cal_vpu" in script else ["--n", "256"])
    assert exc.value.code not in (0, None) and "CUDA is not available" in str(exc.value.code)
    assert not out.exists()


@pytest.mark.parametrize("argv", [[], ["--only", "flash_gat"], ["--only", "ell_fused"]])
def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys, argv):
    """No card: chip_smoke.py exits non-zero, saying why, and prints no
    result, with and without --only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = runpy.run_path("chip_smoke.py", run_name="not_main")["main"]
    with pytest.raises(SystemExit) as exc:
        main(argv)
    out = capsys.readouterr()
    assert exc.value.code not in (0, None) and out.out == ""
    assert "torch.cuda.is_available() is false" in out.err


def test_prof_utilities(tmp_path):
    """checked raises on a non-finite output; trace writes a chrome trace
    that holds a span opened under it; the step timer and the edge
    counter."""
    f = prof.checked(lambda x: (x, {"y": x / x}))
    f(torch.ones(3))
    with pytest.raises(FloatingPointError):
        f(torch.zeros(3))
    with prof.trace(str(tmp_path), "t.json") as p, prof.span("han.matmul"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.key == "han.matmul" for e in p.key_averages())
    trace = json.loads((tmp_path / "t.json").read_text())
    assert any(e.get("name") == "han.matmul" for e in trace["traceEvents"])
    timer = prof.StepTimer()
    for _ in range(3):
        with timer.step():
            torch.ones(8).sum()
    assert len(timer.times) == 3 and timer.median >= 0
    assert prof.edges_per_sec(1000, 8, 0.5) == 16000.0
    assert len(prof.device_memory_stats()) == (torch.cuda.device_count()
                                                if torch.cuda.is_available() else 0)
