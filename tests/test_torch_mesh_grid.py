"""The (graph, heads) grid against han_tpu, and the csr partitioners.

- In one gloo world of 4 ranks (graph 2 × heads 2, parallel/mesh.py): the
  four partitioned backends (partitioned_bcsr, ring_bcsr, csr, ring) on
  one graph, dropout 0, against han_tpu's under ``make_mesh(graph=2,
  heads=2)`` (flash in interpret mode): outputs and the gradients of
  sum(out·w) at atol 1e-5; the flash backends at dropout 0.4 against the
  port's one-device flash (the same masks, head for head); the csr
  backends at dropout 0.4: the backward replays the forward's mask (the
  output is linear in the features, so sum(out·w) = <d fts, fts> holds only
  for the mask the forward used) and the ranks agree; the mesh's layout and
  the dry run at 4 ranks (heads 2, its csr arm).
- One process: ``partition_csr`` and ``partition_csr_2d`` against
  han_tpu's, field by field, at S ∈ {1, 3, 4}; the csr dropout stream's
  keep rate and its independence across shards.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from han_tpu.graph.build import metapath_to_csr as j_csr  # noqa: E402
from han_tpu.parallel import edge_partition as jep  # noqa: E402
from han_tpu.parallel import flash_shard as jshard  # noqa: E402
from han_tpu.parallel import ring_attn as jra  # noqa: E402
from han_tpu.parallel import ring_bcsr as jring  # noqa: E402
from han_tpu.parallel import shard_attn as jsa  # noqa: E402
from han_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from han_tpu_torch.graph.build import metapath_to_csr as t_csr  # noqa: E402
from han_tpu_torch.parallel import edge_partition as tep  # noqa: E402
from han_tpu_torch.parallel import launch  # noqa: E402
from han_tpu_torch.parallel import ring_attn as tra  # noqa: E402
from han_tpu_torch.parallel.shard_attn import shard_keep  # noqa: E402

from test_torch_parallel import EMPTY_ROW, make_case  # noqa: E402

BACKENDS = list(ranks.GRID_BACKENDS)
FLASH = ("partitioned_bcsr", "ring_bcsr")


@pytest.fixture(scope="module")
def case():
    return make_case()


@pytest.fixture(scope="module")
def grid(case):
    return launch.spawn(ranks.grid_checks, 4, "gloo", args=(case,))


def jax_backend(name, case, mesh):
    """han_tpu's backend ``name`` as a function of (fts, ld, ls)."""
    adj, bm, bn = case["adj"], case["bm"], case["bn"]
    if name == "partitioned_bcsr":
        g = jshard.partition_bcsr(adj, 2, bm=bm, bn=bn)
        return lambda *x: jshard.sharded_flash_attention(g, *x, mesh=mesh, interpret=True)
    if name == "ring_bcsr":
        g = jring.ring_partition_bcsr(adj, 2, bm=bm, bn=bn)
        return lambda *x: jring.ring_flash_attention(g, *x, mesh=mesh, interpret=True)
    csr = j_csr(adj, add_self_loops=False, edge_pad_to=32)
    if name == "csr":
        g = jep.partition_csr(csr, 2, edge_pad_to=32)
        return lambda *x: jsa.partitioned_attention(g, *x, mesh=mesh)
    g = jra.partition_csr_2d(csr, 2, pad_to=32)
    return lambda *x: jra.ring_attention(g, *x, mesh=mesh)


@pytest.fixture(scope="module")
def jax_grid(case):
    """han_tpu's four backends under make_mesh(graph=2, heads=2) on 4 of the
    virtual CPU devices: out and the gradients of sum(out·w)."""
    mesh = j_make_mesh(graph=2, heads=2, devices=np.asarray(jax.devices()[:4]))
    args = tuple(jnp.asarray(case[x]) for x in ("fts", "ld", "ls"))
    res = {}
    for name in BACKENDS:
        out, vjp = jax.vjp(jax_backend(name, case, mesh), *args)
        res[name] = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(case["w"]))]
    return res


def test_grid_axes_lay_ranks_out_as_han_tpu(grid):
    """Row-major over (mp, graph, heads): rank r is graph r // 2, heads
    r % 2; each axis lists its ranks in axis order."""
    for r, res in enumerate(grid):
        ax = res["axes"]
        assert ax["mp"][:2] == (0, 1)
        assert ax["graph"] == (r // 2, 2, (r % 2, r % 2 + 2))
        assert ax["heads"] == (r % 2, 2, (r - r % 2, r - r % 2 + 1))


@pytest.mark.parametrize("backend", BACKENDS)
def test_grid_matches_jax(grid, jax_grid, backend):
    """Every rank's output and gradients at dropout 0 against han_tpu's
    same backend on the same grid: atol 1e-5 (rtol 1e-5); the edgeless row
    is 0; the ranks agree bit for bit."""
    got, want = grid[0][backend, 0.0], jax_grid[backend]
    for name, g, w in zip(("out", "d_fts", "d_logit_dst", "d_logit_src"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[0][EMPTY_ROW], 0.0)
    for r in range(1, 4):
        for a, b in zip(grid[r][backend, 0.0], got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", FLASH)
def test_grid_flash_dropout_is_the_single_device_mask(grid, backend):
    """Dropout 0.4: the flash backends on the grid against the port's
    one-device flash with the same generator: forward atol 1e-6 (the same
    global masks, head for head, through head_offset), gradients atol
    1e-5."""
    got, want = grid[0][backend, 0.4], grid[0]["single", 0.4]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-5)
    assert not np.allclose(got[0], grid[0][backend, 0.0][0])


@pytest.mark.parametrize("backend", ["csr", "ring"])
def test_grid_csr_dropout_replays_its_mask(grid, case, backend):
    """Dropout 0.4 on the csr backends: out is linear in fts for a fixed
    mask, so sum(out·w) = <d fts, fts> (rtol 1e-5) only if the backward
    used the forward's mask; the masks differ from the undropped run; every
    rank holds the same result."""
    out, d_fts = grid[0][backend, 0.4][:2]
    lhs = float(np.sum(out.astype(np.float64) * case["w"]))
    rhs = float(np.sum(d_fts.astype(np.float64) * case["fts"]))
    assert lhs == pytest.approx(rhs, rel=1e-5)
    assert not np.allclose(out, grid[0][backend, 0.0][0])
    for r in range(1, 4):
        for a, b in zip(grid[r][backend, 0.4], grid[0][backend, 0.4]):
            np.testing.assert_array_equal(a, b)


def test_grid_dryrun(grid):
    """The dry run at 4 ranks splits the heads (graph 2 × heads 2), runs the
    csr arm beside flash and ring_bcsr, and its deterministic losses agree
    (< 1e-4) with a finite train step on every rank."""
    for rank in grid:
        res = rank["dryrun"]
        assert (res["graph"], res["heads"]) == (2, 2)
        assert set(res["losses"]) == {"flash", "ring_bcsr", "csr"}
        assert res["det_max_dev"] < 1e-4
        assert all(np.isfinite(v) for v in res["losses"].values())


@pytest.mark.parametrize("s_n", [1, 3, 4])
def test_csr_partitioners_match_han_tpu(s_n):
    """partition_csr and partition_csr_2d equal han_tpu's, field by field
    (balanced and equal-row boundaries for partition_csr)."""
    adj = make_case(n=500, seed=s_n)["adj"]
    tc, jc = t_csr(adj, edge_pad_to=64), j_csr(adj, edge_pad_to=64)
    for balance in (True, False):
        tg = tep.partition_csr(tc, s_n, balance_edges=balance, edge_pad_to=64)
        jg = jep.partition_csr(jc, s_n, balance_edges=balance, edge_pad_to=64)
        for f in ("n_nodes", "n_nodes_pad", "n_edges", "n_shards", "n_loc", "e_loc"):
            assert getattr(tg, f) == getattr(jg, f), f
        for f in ("row_ptr", "col_idx", "row_idx", "row_start", "perm"):
            np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                          err_msg=f)
    tg, jg = tra.partition_csr_2d(tc, s_n, pad_to=32), jra.partition_csr_2d(jc, s_n, pad_to=32)
    for f in ("n_nodes", "n_loc", "n_edges", "n_shards", "e_bucket"):
        assert getattr(tg, f) == getattr(jg, f), f
    for f in ("row_local", "col_local", "col_global"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                      err_msg=f)


def test_csr_dropout_stream_per_shard():
    """shard_keep: the keep rate is 1 − p (within 0.01 over 40,000 draws),
    the same key gives the same mask, and another shard's coordinates give
    an independent one (agreement near (1−p)² + p²)."""
    seed = torch.tensor([12345], dtype=torch.int32)
    a = shard_keep(seed, (0, 1), 10_000, 4, 0.4, "cpu")
    assert a.shape == (10_000, 4)
    assert float(a.float().mean()) == pytest.approx(0.6, abs=0.01)
    assert torch.equal(a, shard_keep(seed, (0, 1), 10_000, 4, 0.4, "cpu"))
    b = shard_keep(seed, (1, 1), 10_000, 4, 0.4, "cpu")
    assert float((a == b).float().mean()) == pytest.approx(0.6 ** 2 + 0.4 ** 2, abs=0.02)
