"""han_tpu_torch's copies of the numpy host code equal han_tpu's: the
planted generator array for array, the meta-path containers (ELL
included), and the BCSR tile lists and block maps at a tile geometry both
builders accept."""

import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from han_tpu.graph import bcsr as jbcsr  # noqa: E402
from han_tpu.graph import build as jbuild  # noqa: E402
from han_tpu.graph import containers as jcont  # noqa: E402
from han_tpu.graph import synthetic as jsyn  # noqa: E402
from han_tpu_torch.graph import bcsr as tbcsr  # noqa: E402
from han_tpu_torch.graph import build as tbuild  # noqa: E402
from han_tpu_torch.graph import containers as tcont  # noqa: E402
from han_tpu_torch.graph import synthetic as tsyn  # noqa: E402

PLANTED = [
    dict(n_nodes=96, n_feats=24, n_classes=3, n_metapaths=2, avg_degree=6.0,
         train_per_class=10, n_val=16, seed=7),
    dict(n_nodes=500, n_feats=40, n_classes=4, n_metapaths=3, avg_degree=30.0,
         train_per_class=20, n_val=40, seed=0, shuffle_nodes=True),
]


@pytest.mark.parametrize("kw", PLANTED)
def test_planted_hetero_matches(kw):
    a, b = jsyn.planted_hetero(**kw), tsyn.planted_hetero(**kw)
    for field in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
        assert getattr(b, field).dtype == getattr(a, field).dtype
    assert b.metapath_names == a.metapath_names and b.name == a.name
    assert len(b.metapath_adjs) == len(a.metapath_adjs)
    for x, y in zip(a.metapath_adjs, b.metapath_adjs):
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(y, attr), getattr(x, attr))


def test_metapath_containers_match():
    ds = jsyn.planted_hetero(**PLANTED[1])
    for adj in ds.metapath_adjs:
        np.testing.assert_array_equal(
            tbuild.with_self_loops(adj).toarray(), jbuild.with_self_loops(adj).toarray())
        jd, td = jbuild.metapath_to_dense(adj), tbuild.metapath_to_dense(adj)
        np.testing.assert_array_equal(td.adj.numpy(), np.asarray(jd.adj))
        np.testing.assert_array_equal(td.bias.numpy(), np.asarray(jd.bias))
        jc, tc = jbuild.metapath_to_csr(adj), tbuild.metapath_to_csr(adj)
        assert (tc.n_nodes, tc.n_edges, tc.e_pad) == (jc.n_nodes, jc.n_edges, jc.e_pad)
        for f in ("row_ptr", "col_idx", "row_idx"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
        np.testing.assert_array_equal(tc.edge_mask.numpy(), np.asarray(jc.edge_mask))
    sym = tbuild.symmetric_metapath(ds.metapath_adjs[0][:, :50])
    np.testing.assert_array_equal(
        sym.toarray(), jbuild.symmetric_metapath(ds.metapath_adjs[0][:, :50]).toarray())


@pytest.mark.parametrize("fanout", [None, 5])
def test_ell_from_csr_matches(fanout):
    """ELL lists from the same CSR, at full (max-degree) and truncated
    fanout; the port's containers move with .to()."""
    adj = jsyn.planted_hetero(**PLANTED[0]).metapath_adjs[0]
    je = jcont.ell_from_csr(jbuild.metapath_to_csr(adj), fanout=fanout)
    te = tcont.ell_from_csr(tbuild.metapath_to_csr(adj), fanout=fanout)
    assert (te.n_nodes, te.n_edges, te.fanout) == (je.n_nodes, je.n_edges, je.fanout)
    for f in ("nbr", "deg", "nbr_mask"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)))
    tree = tcont.TreeEllGraph(nbr=te.nbr, deg=te.deg, n_nodes=te.n_nodes, n_edges=te.n_edges,
                              parent_row=te.deg, parent_slot=te.deg)
    moved = tree.to("cpu")
    assert isinstance(moved, tcont.TreeEllGraph) and moved.n_edges == te.n_edges
    assert moved.parent_row is not None and moved.nbr.dtype == te.nbr.dtype


def _coo(n, seed, empty_rows=()):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < 0.05
    np.fill_diagonal(a, True)
    a[list(empty_rows)] = False
    return np.nonzero(a)


@pytest.mark.parametrize("n,empty_rows", [(300, ()), (520, range(128, 300))])
def test_bcsr_from_coo_matches(n, empty_rows):
    rows, cols = _coo(n, seed=n, empty_rows=empty_rows)
    jg = jbcsr.bcsr_from_coo(rows, cols, n, bm=128, bn=128)
    tg = tbcsr.bcsr_from_coo(rows, cols, n, bm=128, bn=128)
    assert tbcsr.pick_tiles(n, 128, 128) == jbcsr.pick_tiles(n, 128, 128)
    for f in ("n_nodes", "n_pad", "bm", "bn", "n_edges", "n_tiles"):
        assert getattr(tg, f) == getattr(jg, f), f
    for f in ("tiles", "fwd_count", "fwd_col", "fwd_tile", "bwd_count",
              "bwd_row", "bwd_tile"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    flat = tbcsr.flat_fwd_map(tg.fwd_count.numpy(), tg.fwd_col.numpy(), tg.fwd_tile.numpy())
    for a, b in zip(flat, jg.fwd_flat):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_pick_tiles_rules():
    assert tbcsr.pick_tiles(4057) == (128, 128, 4096)
    assert tbcsr.pick_tiles(96, 128, 128) == (96, 96, 96)
    assert tbcsr.pick_tiles(1000, 64, 256) == (64, 256, 1024)
    for bad in ((100, 128), (128, 512), (0, 128)):
        with pytest.raises(ValueError):
            tbcsr.pick_tiles(1000, *bad)


def test_port_imports_no_jax():
    """The port (every module, the sampled path's, the multi-device and
    the calibration ones, entry() and the preemption guard included), its
    entry scripts, the benchmark, the
    calibration script, the flash-vs-csr sweep and the chip smoke test
    load neither jax, han_tpu nor scikit-learn."""
    code = (
        "import importlib, pathlib, pkgutil, runpy, sys\n"
        "import han_tpu_torch\n"
        "for m in pkgutil.walk_packages(han_tpu_torch.__path__, 'han_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "runpy.run_path('scripts/train_torch.py', run_name='not_main')\n"
        "runpy.run_path('scripts/bench_scale_torch.py', run_name='not_main')\n"
        "runpy.run_path('scripts/prof_mesh_torch.py', run_name='not_main')\n"
        "runpy.run_path('scripts/prof_gat_torch.py', run_name='not_main')\n"
        "runpy.run_path('scripts/cal_vpu_torch.py', run_name='not_main')\n"
        "runpy.run_path('scripts/flash_scale_demo_torch.py', run_name='not_main')\n"
        "runpy.run_path('bench_torch.py', run_name='not_main')\n"
        "import han_tpu_torch.ops.calibrate, han_tpu_torch.graph.reorder\n"
        "import han_tpu_torch.utils.prof, han_tpu_torch.utils.device\n"
        "import han_tpu_torch.train.sampled, han_tpu_torch.native\n"
        "import han_tpu_torch.parallel.mesh, han_tpu_torch.parallel.launch\n"
        "import han_tpu_torch.parallel.flash_shard, han_tpu_torch.parallel.ring_bcsr\n"
        "import han_tpu_torch.parallel.dryrun\n"
        "import han_tpu_torch.entry, han_tpu_torch.train.preempt\n"
        "bad = [m for m in sys.modules if m in ('jax', 'han_tpu', 'sklearn')"
        " or m.startswith(('jax.', 'han_tpu.', 'sklearn.'))]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(
        __import__("pathlib").Path(__file__).resolve().parent.parent))


def test_port_sources_import_no_jax_han_tpu_or_sklearn():
    """No line of the port's modules, chip_smoke.py or the *_torch.py
    scripts imports jax, han_tpu or scikit-learn, inside a function
    included (the import check above sees only what importing loads)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parent.parent
    files = [*(root / "han_tpu_torch").rglob("*.py"), root / "chip_smoke.py",
             root / "bench_torch.py", *(root / "scripts").glob("*_torch.py")]
    pattern = re.compile(r"^\s*(from|import)\s+(jax|han_tpu|sklearn)(\.|\s|$)")
    bad = [f"{f.relative_to(root)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert len(files) > 30 and not bad, bad
