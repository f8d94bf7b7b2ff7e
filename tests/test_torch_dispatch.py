"""Occupancy-aware ``impl="auto"`` on BCSR graphs (graph/bcsr.py's edge
view, ops/attention.py's flash-vs-csr crossover) against han_tpu's
(han_tpu/graph/bcsr.py:90-97,131-140,249-287, han_tpu/ops/attention.py:
47-75,353-363): the edge view array by array and as_csr(), the refusal
without the view, which backend auto takes on either side of the
threshold (a spy on both), a stack staying on flash, and auto's output
against han_tpu's attention_aggregate at dropout 0. And the script that
measures the crossover on the card (scripts/flash_scale_demo_torch.py):
its graph generator against scripts/flash_scale_demo.py's, its crossing
rule, and its refusal without a card."""

import pathlib
import runpy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from han_tpu.graph import bcsr as jbcsr  # noqa: E402
from han_tpu.ops import attention as jatt  # noqa: E402
from han_tpu_torch.graph import bcsr as tbcsr  # noqa: E402
from han_tpu_torch.graph.stack import stack_graphs  # noqa: E402
from han_tpu_torch.ops import attention as tatt  # noqa: E402


def coo(n, per_row, seed, local=False):
    """Self-loops plus ``per_row`` out-edges a row, unsorted and with
    duplicates; ``local``: within 20 ids of the row (dense tiles), else
    anywhere (nearly an edge a tile)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n), np.repeat(np.arange(n), per_row)])
    off = rng.integers(-20, 21, n * per_row) if local else rng.integers(0, n, n * per_row)
    cols = np.concatenate([np.arange(n), (np.repeat(np.arange(n), per_row) + off) % n])
    perm = rng.permutation(rows.shape[0])
    return rows[perm], cols[perm]


SPARSE = dict(n=1000, per_row=1, seed=0)            # 64 tiles of 128 x 128, ~530 a edge
DENSE = dict(n=300, per_row=12, seed=1, local=True)  # 9 tiles, ~50 an edge


@pytest.mark.parametrize("case", [SPARSE, DENSE], ids=["sparse", "dense"])
def test_edge_view_and_as_csr_match_jax(case):
    rows, cols = coo(**case)
    n = case["n"]
    got = tbcsr.bcsr_from_coo(rows, cols, n)
    want = jbcsr.bcsr_from_coo(rows, cols, n)
    for name in ("edge_row_ptr", "edge_col", "edge_row"):
        t = getattr(got, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(want, name)), err_msg=name)
    gc, wc = got.as_csr(), want.as_csr()
    for name in ("row_ptr", "col_idx", "row_idx"):
        np.testing.assert_array_equal(getattr(gc, name).numpy(), np.asarray(getattr(wc, name)))
    assert (gc.n_nodes, gc.n_edges) == (wc.n_nodes, wc.n_edges) == (n, rows.shape[0])
    moved = got.to("cpu")
    assert torch.equal(moved.edge_col, got.edge_col)


def test_without_the_view_as_csr_raises_and_auto_stays_on_flash(monkeypatch):
    rows, cols = coo(**SPARSE)
    g = tbcsr.bcsr_from_coo(rows, cols, SPARSE["n"], keep_edges=False)
    assert g.edge_row_ptr is g.edge_col is g.edge_row is None
    with pytest.raises(ValueError, match="keep_edges=False"):
        g.as_csr()
    assert g.elems_per_edge() > tatt.flash_csr_threshold(g.bm, g.bn)
    assert dispatched(monkeypatch, g, SPARSE["n"]) == ["flash"]


def test_threshold_table():
    """The 128 x 128 figure measured on the H100 (no v5e figure carried
    over); an unmeasured geometry takes it."""
    assert set(tatt.FLASH_MAX_ELEMS_PER_EDGE_BY_TILE) == {(128, 128)}
    assert tatt.flash_csr_threshold(128, 128) == tatt.FLASH_MAX_ELEMS_PER_EDGE == 497.0
    assert tatt.flash_csr_threshold(64, 256) == tatt.FLASH_MAX_ELEMS_PER_EDGE


def inputs(n, k=2, d=4, seed=3, lead=()):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(lead + s).astype(np.float32)
    return f32(n, k, d), f32(n, k), f32(n, k)


def dispatched(monkeypatch, graph, n, lead=()):
    """The backends attention_aggregate(impl="auto") calls for ``graph``."""
    calls = []
    for name in ("flash_gat_attention", "csr_attention"):
        real = getattr(tatt, name)
        monkeypatch.setattr(tatt, name, lambda *a, _real=real, _name=name, **kw:
                            calls.append(_name.split("_")[0]) or _real(*a, **kw))
    tatt.attention_aggregate(graph, *(torch.from_numpy(x) for x in inputs(n, lead=lead)))
    return calls


@pytest.mark.parametrize("case,want", [(SPARSE, "csr"), (DENSE, "flash")],
                         ids=["sparse", "dense"])
def test_auto_dispatches_by_the_threshold(monkeypatch, case, want):
    """Above flash_csr_threshold auto runs the edge view through csr, below
    it flash; a stack (no edge view, as han_tpu's stack_graphs) always runs
    flash."""
    rows, cols = coo(**case)
    g = tbcsr.bcsr_from_coo(rows, cols, case["n"])
    above = g.elems_per_edge() > tatt.flash_csr_threshold(g.bm, g.bn)
    assert above == (want == "csr")
    assert dispatched(monkeypatch, g, case["n"]) == [want]
    monkeypatch.undo()
    stack = stack_graphs([g, g])
    assert stack.edge_col is None and stack.path(1).edge_col is None
    assert dispatched(monkeypatch, stack, case["n"], lead=(2,)) == ["flash"]


@pytest.mark.parametrize("case", [SPARSE, DENSE], ids=["sparse", "dense"])
def test_auto_matches_jax_auto(case):
    """auto's output on both sides of the threshold against han_tpu's
    attention_aggregate(impl="auto") on its own BCSR build of the same
    edges, dropout 0: atol 1e-5."""
    rows, cols = coo(**case)
    n = case["n"]
    x = inputs(n)
    got = tatt.attention_aggregate(tbcsr.bcsr_from_coo(rows, cols, n),
                                   *(torch.from_numpy(a) for a in x))
    want = jatt.attention_aggregate(jbcsr.bcsr_from_coo(rows, cols, n),
                                    *(jnp.asarray(a) for a in x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"


def test_community_powerlaw_is_a_copy():
    """scripts/flash_scale_demo.py imports jax only inside main(); its
    generator and the port script's give the same matrices."""
    want = runpy.run_path(str(SCRIPTS / "flash_scale_demo.py"), run_name="x")["community_powerlaw"]
    got = runpy.run_path(str(SCRIPTS / "flash_scale_demo_torch.py"),
                         run_name="x")["community_powerlaw"]
    for n, e, kw in ((4096, 20_000, {}), (2048, 9_000, dict(n_comm=32, partners=16, seed=3))):
        a, b = got(n, e, **kw), want(n, e, **kw)
        assert (a != b).nnz == 0 and a.shape == b.shape and a.nnz == b.nnz


def test_crossing_takes_the_last_flash_win():
    """The crossing lies between the largest elems_per_edge where flash
    wins and the next point, log-log interpolated where the time ratio
    passes 1; None when one backend wins everywhere."""
    crossing = runpy.run_path(str(SCRIPTS / "flash_scale_demo_torch.py"),
                              run_name="x")["crossing"]
    pt = lambda x, f, c: {"elems_per_edge": x, "flash_ms": {"0.6": f}, "csr_ms": {"0.6": c}}
    pts = [pt(2.0, 1.0, 10.0), pt(100.0, 1.0, 2.0), pt(1000.0, 4.0, 2.0), pt(10.0, 1.0, 5.0)]
    # between 100 (ratio 1/2) and 1000 (ratio 2): the geometric middle
    assert crossing(pts, "0.6") == pytest.approx(np.sqrt(100.0 * 1000.0))
    assert crossing(pts[:2], "0.6") is None and crossing(pts[2:3], "0.6") is None


def test_flash_scale_demo_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = runpy.run_path(str(SCRIPTS / "flash_scale_demo_torch.py"), run_name="x")["main"]
    for argv in ([], ["--sweep"]):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code not in (0, None)
