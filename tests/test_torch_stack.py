"""Stacked meta-path graphs and the batched flash kernels' plain versions.

- ``graph/stack.py:stack_graphs`` against han_tpu's, array by array, for
  the five container types it takes (dense, BCSR, PartitionedBCSR, CSR,
  ELL), on meta-paths of different sizes so that every padding rule acts;
  ``path``/``paths`` take graphs back out of a stack.
- The batched plain flash functions (a stack of P graphs, one seed a path)
  against the single-path plain functions on each path with its seed:
  forward, fused backward, row and column sweeps; and
  ``flash_gat_attention`` on a stack (outputs and gradients) against one
  call a path. The kernels' batched launches are held to the same rule on
  the card by chip_smoke.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from han_tpu.graph import build as jbuild  # noqa: E402
from han_tpu.graph import containers as jcont  # noqa: E402
from han_tpu.graph.stack import stack_graphs as j_stack  # noqa: E402
from han_tpu.parallel import flash_shard as jshard  # noqa: E402
from han_tpu_torch.graph import build as tbuild  # noqa: E402
from han_tpu_torch.graph import containers as tcont  # noqa: E402
from han_tpu_torch.graph import stack as tstack  # noqa: E402
from han_tpu_torch.ops import flash_gat as fg  # noqa: E402
from han_tpu_torch.parallel import flash_shard as tshard  # noqa: E402

N = 300


def adjs(n=N, seed=0):
    """Three meta-paths of different densities (so different tile counts,
    map widths and edge counts), one with an edgeless row."""
    rng = np.random.default_rng(seed)
    out = []
    for dens in (0.01, 0.04, 0.02):
        a = (rng.random((n, n)) < dens).astype(np.float32)
        a[7, :] = 0.0
        out.append(sp.csr_matrix(a))
    return out


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(tg, jg, arrays, scalars):
    for f in scalars:
        assert getattr(tg, f) == getattr(jg, f), f
    for f in arrays:
        np.testing.assert_array_equal(as_np(getattr(tg, f)), as_np(getattr(jg, f)), err_msg=f)


CONTAINERS = {
    "dense": (lambda a: tbuild.metapath_to_dense(a), lambda a: jbuild.metapath_to_dense(a),
              ["adj"], ["n_nodes"]),
    "bcsr": (lambda a: tbuild.metapath_to_bcsr(a, bm=128, bn=128),
             lambda a: jbuild.metapath_to_bcsr(a, bm=128, bn=128),
             ["tiles", "fwd_count", "fwd_col", "fwd_tile", "bwd_count", "bwd_row", "bwd_tile"],
             ["n_nodes", "n_pad", "bm", "bn", "n_edges", "n_tiles"]),
    "partitioned_bcsr": (
        lambda a: tshard.partition_bcsr(tbuild.with_self_loops(a), 3, bm=128, bn=128),
        lambda a: jshard.partition_bcsr(jbuild.with_self_loops(a), 3, bm=128, bn=128),
        ["tiles", "fwd_count", "fwd_col", "fwd_tile", "bwd_count", "bwd_row", "bwd_tile",
         "row_block_off", "perm"],
        ["n_nodes", "n_pad", "n_loc", "bm", "bn", "n_edges", "n_shards"]),
    "csr": (lambda a: tbuild.metapath_to_csr(a, edge_pad_to=32),
            lambda a: jbuild.metapath_to_csr(a, edge_pad_to=32),
            ["row_ptr", "col_idx", "row_idx"], ["n_nodes", "n_edges"]),
    "ell": (lambda a: tcont.ell_from_csr(tbuild.metapath_to_csr(a)),
            lambda a: jcont.ell_from_csr(jbuild.metapath_to_csr(a)),
            ["nbr", "deg"], ["n_nodes", "n_edges"]),
}


@pytest.mark.parametrize("kind", list(CONTAINERS))
def test_stack_graphs_matches_han_tpu(kind):
    """The stack of three meta-paths equals han_tpu's array by array, and
    path(p) gives back each graph's own arrays where no padding acted."""
    tb, jb, arrays, scalars = CONTAINERS[kind]
    graphs = [tb(a) for a in adjs()]
    ts = tstack.stack_graphs(graphs)
    assert_same(ts, j_stack([jb(a) for a in adjs()]), arrays, scalars)
    if kind == "partitioned_bcsr":
        # the strips widened, so only the unwidened fields round-trip
        assert ts.n_loc == max(g.n_loc for g in graphs)
        arrays = ["bwd_count"]
    elif kind == "bcsr":
        arrays = ["fwd_count", "bwd_count"]
    elif kind == "csr":
        arrays = ["row_ptr"]
    elif kind == "ell":
        arrays = ["deg"]
    for p, g in enumerate(graphs):
        one = tstack.path(ts, p)
        for f in arrays:
            np.testing.assert_array_equal(as_np(getattr(one, f)), as_np(getattr(g, f)),
                                          err_msg=f)
    two = tstack.paths(ts, 1, 3)
    assert as_np(getattr(two, arrays[0])).shape[0] == 2


def test_stack_refuses_mixed_types_and_node_sets():
    a = adjs()
    with pytest.raises(TypeError, match="mixed"):
        tstack.stack_graphs([tbuild.metapath_to_dense(a[0]), tbuild.metapath_to_csr(a[1])])
    with pytest.raises(ValueError, match="node set"):
        tstack.stack_graphs([tbuild.metapath_to_dense(a[0]),
                             tbuild.metapath_to_dense(adjs(n=200)[0])])


def stacked_inputs(graph, k=4, d=8, seed=1):
    """ld, ls (P, K, n), v, g (P, n, K·D) in float64 (the plain versions'
    first f32 exp in a threaded process can be off by ~1e-4)."""
    rng = np.random.default_rng(seed)
    p, n = graph.n_paths, graph.n_pad
    f = lambda *s: torch.from_numpy(rng.standard_normal(s))
    return f(p, k, n), f(p, k, n), f(p, n, k * d), f(p, n, k * d)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_batched_plain_flash_is_per_path(dropout):
    """Each kernel's plain version on a stack of three graphs (tile lists
    and maps padded to the largest) equals the single-path plain version
    on graph p with seed p, exactly, for the forward, the fused backward
    and the two sweeps; the paths differ (their own graphs and seeds)."""
    graphs = [tbuild.metapath_to_bcsr(a, bm=64, bn=64) for a in adjs()]
    st = tstack.stack_graphs(graphs)
    assert st.n_paths == 3 and st.tiles.shape[1] == max(g.tiles.shape[0] for g in graphs)
    ld, ls, v, g = stacked_inputs(st)
    seeds = torch.tensor([11, 22, 33], dtype=torch.int32)
    meta = fg.FlashMeta(dropout_p=dropout, seed=seeds)
    out, lse = fg.flash_fwd_plain(st, ld, ls, v, meta)
    k = ld.shape[1]
    delta = fg.head_delta(g, out, k)
    bwd = fg.flash_bwd_plain(st, ld, ls, v, g, lse, delta, meta)
    row = fg.flash_bwd_row_plain(st, ld, ls, v, g, lse, delta, meta)
    col = fg.flash_bwd_col_plain(st, ld, ls, v, g, lse, delta, meta)
    for p, gp in enumerate(graphs):
        mp = fg.FlashMeta(dropout_p=dropout, seed=int(seeds[p]))
        o1, l1 = fg.flash_fwd_plain(gp, ld[p], ls[p], v[p], mp)
        assert torch.equal(out[p], o1) and torch.equal(lse[p], l1)
        args = (gp, ld[p], ls[p], v[p], g[p], lse[p], delta[p], mp)
        for got, want in zip(bwd, fg.flash_bwd_plain(*args)):
            assert torch.equal(got[p], want)
        assert torch.equal(row[p], fg.flash_bwd_row_plain(*args))
        for got, want in zip(col, fg.flash_bwd_col_plain(*args)):
            assert torch.equal(got[p], want)
    assert not torch.equal(out[0], out[1])


def test_stacked_flash_attention_matches_one_call_a_path():
    """flash_gat_attention on a stack (P seeds drawn at once) against one
    call a path with the same seeds: outputs and gradients within 1e-6
    (float32; the first f32 exp of a threaded process may round apart);
    with towers=(1, 3, 3) the two paths get the last two of three seeds."""
    graphs = [tbuild.metapath_to_bcsr(a, bm=64, bn=64) for a in adjs()]
    st = tstack.stack_graphs(graphs)
    rng = np.random.default_rng(5)
    k, d = 2, 4
    f = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                requires_grad=True)
    fts, ld, ls = f(3, N, k, d), f(3, N, k), f(3, N, k)
    w = torch.from_numpy(rng.standard_normal((3, N, k, d)).astype(np.float32))
    out = fg.flash_gat_attention(st, fts, ld, ls, coef_dropout=0.3,
                                 generator=torch.Generator().manual_seed(4))
    grads = torch.autograd.grad((out * w).sum(), (fts, ld, ls))
    seeds = fg.draw_seed(0.3, torch.Generator().manual_seed(4), 3)
    for p, gp in enumerate(graphs):
        one = fg._FlashGAT.apply(
            torch.nn.functional.pad(ld[p].T, (0, gp.n_pad - N)),
            torch.nn.functional.pad(ls[p].T, (0, gp.n_pad - N)),
            torch.nn.functional.pad(fts[p].reshape(N, k * d), (0, 0, 0, gp.n_pad - N)),
            gp, fg.FlashMeta(dropout_p=0.3, seed=seeds[p:p + 1]))[:N].view(N, k, d)
        gp_grads = torch.autograd.grad((one * w[p]).sum(), (fts, ld, ls))
        torch.testing.assert_close(out[p], one, atol=1e-6, rtol=0)
        for a, b in zip(grads, gp_grads):
            torch.testing.assert_close(a[p], b[p], atol=1e-6, rtol=0)
    sub = fg.flash_gat_attention(tstack.paths(st, 1, 3), fts[1:], ld[1:], ls[1:],
                                 coef_dropout=0.3, generator=torch.Generator().manual_seed(4),
                                 towers=(1, 3, 3))
    torch.testing.assert_close(sub, out[1:], atol=1e-6, rtol=0)
