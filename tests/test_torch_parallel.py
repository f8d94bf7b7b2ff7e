"""han_tpu_torch's graph-axis multi-device backends against han_tpu.

- The strip kernels' plain versions against JAX's ``_flash_fwd`` (the
  ``_fwd_kernel`` grid) and ``_flash_bwd``'s split branch, called directly
  on one shard of ``partition_bcsr`` and one ring cell with non-zero meta
  offsets (dropout 0: the two packages' masks differ by design).
- Sharded and ring attention in gloo worlds of 2 and 4 ranks against JAX's
  one-device ``flash_gat_attention`` (forward, gradients), with dropout
  against the port's own one-device run; HAN logits with converted flax
  weights against JAX under ``make_mesh(graph=4)``; ``Trainer`` on both
  formats against the one-device loss trajectory, with the parameters
  equal across ranks; the dry run. One world is spawned per size and runs
  all its checks (tests/torch_parallel_ranks.py); the tests read its
  results.
- The deterministic dispatch of ``flash_bwd`` to the split backward, the
  1-shard partitions on one process, the mesh's refusals, and the numpy
  partitioners against han_tpu's.
"""

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from han_tpu.graph.bcsr import bcsr_from_scipy as j_bcsr  # noqa: E402
from han_tpu.graph.build import with_self_loops as j_self_loops  # noqa: E402
from han_tpu.graph.synthetic import planted_hetero as j_planted  # noqa: E402
from han_tpu.nn.models import HAN as JHAN  # noqa: E402
from han_tpu.ops.pallas import flash_gat as jfg  # noqa: E402
from han_tpu.parallel import flash_shard as jshard  # noqa: E402
from han_tpu.parallel import ring_bcsr as jring  # noqa: E402
from han_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from han_tpu_torch.graph.bcsr import bcsr_from_scipy as t_bcsr  # noqa: E402
from han_tpu_torch.nn.convert import params_from_flax  # noqa: E402
from han_tpu_torch.ops import flash_gat as tfg  # noqa: E402
from han_tpu_torch.parallel import flash_shard as tshard  # noqa: E402
from han_tpu_torch.parallel import launch  # noqa: E402
from han_tpu_torch.parallel import ring_bcsr as tring  # noqa: E402
from han_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from han_tpu_torch.train import trainer as ttrainer  # noqa: E402

EMPTY_ROW = 5
TRAIN_EPOCHS = 4


def make_case(n=400, k=4, d=8, seed=3, density=0.03, bm=128, bn=128):
    """tests/test_flash_shard.py's case (skewed rows, an edgeless row), in
    numpy, plus loss weights w."""
    rng = np.random.default_rng(seed)
    p_row = 0.5 * density + density * (np.arange(n) < n // 8) * 8
    a = (rng.random((n, n)) < p_row[:, None]).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    a[EMPTY_ROW, :] = 0.0
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(adj=sp.csr_matrix(a), fts=f32(n, k, d), ld=f32(n, k), ls=f32(n, k),
                w=f32(n, k, d), bm=bm, bn=bn)


def assert_all_close(got, want, atol, rtol=0.0):
    for name, g, w in zip(("out", "d_fts", "d_logit_dst", "d_logit_src"), got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)


@pytest.fixture(scope="module")
def case():
    return make_case()


@pytest.fixture(scope="module")
def jax_ref(case):
    """JAX's one-device flash (Pallas in interpret mode): out and the
    gradients of sum(out·w)."""
    g = j_bcsr(case["adj"], bm=case["bm"], bn=case["bn"])
    fn = lambda *x: jfg.flash_gat_attention(g, *x, interpret=True)
    args = tuple(jnp.asarray(case[x]) for x in ("fts", "ld", "ls"))
    grads = jax.grad(lambda *x: jnp.sum(fn(*x) * case["w"]), argnums=(0, 1, 2))(*args)
    return [np.asarray(fn(*args))] + [np.asarray(x) for x in grads]


@pytest.fixture(scope="module")
def han_case():
    """A small HAN, flax weights from init under make_mesh(graph=4), and
    JAX's logits on both partitioned formats (dropout off)."""
    ds = j_planted(n_nodes=256, n_feats=16, n_classes=3, n_metapaths=2,
                   avg_degree=6.0, train_per_class=10, n_val=20, seed=2)
    adjs = [j_self_loops(a) for a in ds.metapath_adjs]
    graphs = {"sharded": [jshard.partition_bcsr(a, 4, bm=64, bn=128) for a in adjs],
              "ring": [jring.ring_partition_bcsr(a, 4, bm=64, bn=128) for a in adjs]}
    model = JHAN(n_classes=3, hid_units=(8,), n_heads=(4, 1))
    x = jnp.asarray(ds.features)
    logits = {}
    with jax.set_mesh(j_make_mesh(graph=4, heads=1)):
        params = model.init(jax.random.PRNGKey(0), graphs["sharded"], [x, x])
        apply = jax.jit(lambda p, gs: model.apply(p, gs, [x, x], deterministic=True)[0])
        for name, gs in graphs.items():
            logits[name] = np.asarray(apply(params, gs))
    state = {k: v.numpy() for k, v in params_from_flax(params).items()}
    return {"logits": logits, "ranks": dict(features=ds.features, adjs=adjs, n_classes=3,
                                            bm=64, bn=128, state=state)}


@pytest.fixture(scope="module")
def world2(case):
    return launch.spawn(ranks.world_checks, 2, "gloo", args=(case, None, 0))


@pytest.fixture(scope="module")
def world4(case, han_case):
    return launch.spawn(ranks.world_checks, 4, "gloo",
                        args=(case, han_case["ranks"], TRAIN_EPOCHS))


# ---------------------------------------------------------------------------
# strip kernels (plain versions) against JAX's rectangular grid
# ---------------------------------------------------------------------------


def strip_setup(part, seed=0):
    """One strip of the 4-way partitions of make_case's graph, in both
    packages: (port BCSRGraph, JAX maps and tiles, meta offsets, n_rows,
    n_cols). 'shard' is partition_bcsr's shard 2, 'ring_cell' ring
    shard 1 at step 2 (column strip 3): both with non-zero offsets."""
    adj = make_case(seed=seed)["adj"]
    if part == "shard":
        tg, jg, s = tshard.partition_bcsr(adj, 4, bm=128, bn=128), jshard.partition_bcsr(
            adj, 4, bm=128, bn=128), 2
        graph = tg.strip(s)
        idx = (s,)
        off = dict(row_block_offset=tg.row_block_off[s], col_block_offset=0)
        n_rows, n_cols = tg.n_loc, tg.n_pad
    else:
        tg, jg, s, t = tring.ring_partition_bcsr(adj, 4, bm=128, bn=128), \
            jring.ring_partition_bcsr(adj, 4, bm=128, bn=128), 1, 2
        graph = tg.cell(s, t)
        idx = (s, t)
        off = dict(row_block_offset=s * tg.nb_r_loc,
                   col_block_offset=tg.cs_of_step[s][t] * tg.nb_c_loc)
        n_rows = n_cols = tg.n_loc
    assert off["row_block_offset"] > 0
    assert part == "shard" or off["col_block_offset"] > 0
    jmaps = [np.asarray(getattr(jg, f))[idx] for f in
             ("fwd_count", "fwd_col", "fwd_tile", "bwd_count", "bwd_row", "bwd_tile")]
    jtiles = np.asarray(jg.tiles)[idx[0]].reshape(-1, 128)
    return graph, jmaps, jtiles, off, n_rows, n_cols


def strip_inputs(n_rows, n_cols, k=4, d=8, seed=1):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f32(k, n_rows), f32(k, n_cols), f32(n_cols, k * d), f32(n_rows, k * d)


def jax_meta(off, head=3):
    return jnp.asarray([1234, off["row_block_offset"], head, off["col_block_offset"]],
                       jnp.int32)


def pad_heads(x, kp=8, value=0.0):
    return jnp.pad(jnp.asarray(x), ((0, kp - x.shape[0]), (0, 0)), constant_values=value)


@pytest.mark.parametrize("part", ["shard", "ring_cell"])
def test_strip_forward_matches_jax(part):
    """The forward's plain version on a strip (n_rows ≠ n_cols or a cell),
    with the strip's offsets, against JAX's _flash_fwd: atol 1e-5."""
    graph, jm, jtiles, off, n_rows, n_cols = strip_setup(part)
    ld, ls, v, _ = strip_inputs(n_rows, n_cols)
    k = ld.shape[0]
    meta = tfg.FlashMeta(seed=1234, head_offset=3, **off)
    out, lse = tfg.flash_fwd_plain(graph, *map(torch.from_numpy, (ld, ls, v)), meta)
    jout, jlse = jfg._flash_fwd(*map(jnp.asarray, jm[:3]), jax_meta(off), jnp.asarray(jtiles),
                                pad_heads(ld), pad_heads(ls), jnp.asarray(v).reshape(n_cols, k, -1),
                                slope=0.2, bm=128, bn=128, interpret=True)
    assert out.shape == (n_rows, v.shape[1]) and (out != 0).any()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).reshape(n_rows, -1), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:k], atol=1e-5)


@pytest.mark.parametrize("part", ["shard", "ring_cell"])
def test_split_backward_matches_jax(part, monkeypatch):
    """The row sweep's and the column sweep's plain versions on a strip
    against _flash_bwd's split branch (reached by setting
    _FUSED_DLD_BYTES to 0): dld, dls, dv at atol 1e-5; and the pair equals
    the fused plain backward."""
    monkeypatch.setattr(jfg, "_FUSED_DLD_BYTES", 0)
    graph, jm, jtiles, off, n_rows, n_cols = strip_setup(part)
    ld, ls, v, g = strip_inputs(n_rows, n_cols, seed=2)
    k = ld.shape[0]
    meta = tfg.FlashMeta(seed=1234, head_offset=3, **off)
    tt = [torch.from_numpy(x) for x in (ld, ls, v, g)]
    out, lse = tfg.flash_fwd_plain(graph, *tt[:3], meta)
    delta = tfg.head_delta(tt[3], out, k)
    dld = tfg.flash_bwd_row_plain(graph, *tt, lse, delta, meta)
    dls, dv = tfg.flash_bwd_col_plain(graph, *tt, lse, delta, meta)
    jd = jfg._flash_bwd(*map(jnp.asarray, jm), jax_meta(off), jnp.asarray(jtiles),
                        pad_heads(ld), pad_heads(ls), jnp.asarray(v).reshape(n_cols, k, -1),
                        jnp.asarray(g), pad_heads(lse.numpy(), value=-1e9),
                        pad_heads(delta[0].numpy()), slope=0.2, bm=128, bn=128, interpret=True)
    for name, got, want in (("dld", dld, np.asarray(jd[0])[:k]),
                            ("dls", dls, np.asarray(jd[1])[:k]),
                            ("dv", dv, np.asarray(jd[2]).reshape(n_cols, -1))):
        assert (got != 0).any(), name
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=name)
    fused = tfg.flash_bwd_plain(graph, *tt, lse, delta, meta)
    for got, want in zip((dld, dls, dv), fused):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("part", ["shard", "ring_cell"])
def test_row_sweep_3xtf32_matches_jax_split_backward(part, monkeypatch):
    """The row sweep's plain version with mm_3xtf32 (the redesigned
    kernel's g·v product) on a strip against _flash_bwd's split branch
    (_FUSED_DLD_BYTES set to 0): dld at atol 1e-5, and within f32 rounding
    of the row sweep on the same inputs in float64."""
    monkeypatch.setattr(jfg, "_FUSED_DLD_BYTES", 0)
    graph, jm, jtiles, off, n_rows, n_cols = strip_setup(part)
    ld, ls, v, g = strip_inputs(n_rows, n_cols, seed=3)
    k = ld.shape[0]
    meta = tfg.FlashMeta(seed=1234, head_offset=3, **off)
    tt = [torch.from_numpy(x) for x in (ld, ls, v, g)]
    out, lse = tfg.flash_fwd_plain(graph, *tt[:3], meta)
    delta = tfg.head_delta(tt[3], out, k)
    dld = tfg.flash_bwd_row_plain(graph, *tt, lse, delta, meta, mm=tfg.mm_3xtf32)
    jd = jfg._flash_bwd(*map(jnp.asarray, jm), jax_meta(off), jnp.asarray(jtiles),
                        pad_heads(ld), pad_heads(ls), jnp.asarray(v).reshape(n_cols, k, -1),
                        jnp.asarray(g), pad_heads(lse.numpy(), value=-1e9),
                        pad_heads(delta[0].numpy()), slope=0.2, bm=128, bn=128, interpret=True)
    assert (dld != 0).any()
    np.testing.assert_allclose(dld.numpy(), np.asarray(jd[0])[:k], atol=1e-5)
    f64 = [t.double() for t in (*tt, lse, delta)]
    want = tfg.flash_bwd_row_plain(graph, *f64, meta)
    np.testing.assert_allclose(dld.double().numpy(), want.numpy(), atol=2e-6)


@pytest.mark.parametrize("s_n", [2, 4])
def test_strips_and_cells_tile_the_graph(s_n):
    """tile_adjacency of the shards' strips (through perm) and of every ring
    cell reassemble the one-device tile mask."""
    adj = make_case(n=300, seed=4)["adj"]
    want = tfg.tile_adjacency(t_bcsr(adj, bm=64, bn=64))[:300, :300]
    pg = tshard.partition_bcsr(adj, s_n, bm=64, bn=64)
    rows = torch.cat([tfg.tile_adjacency(pg.strip(s)) for s in range(s_n)])
    assert torch.equal(rows[pg.perm][:, :300], want)
    rg = tring.ring_partition_bcsr(adj, s_n, bm=64, bn=64)
    n_loc = rg.n_loc
    full = torch.zeros((rg.n_pad, rg.n_pad), dtype=torch.bool)
    for s in range(s_n):
        for t in range(s_n):
            cs = rg.cs_of_step[s][t]
            full[s * n_loc:(s + 1) * n_loc, cs * n_loc:(cs + 1) * n_loc] = \
                tfg.tile_adjacency(rg.cell(s, t))
    assert torch.equal(full[:300, :300], want)


# ---------------------------------------------------------------------------
# the distributed backends in spawned gloo worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_n", [2, 4])
@pytest.mark.parametrize("backend", ["sharded", "ring"])
def test_attention_matches_jax_single_device(request, jax_ref, backend, s_n):
    """Every rank's output and gradients, dropout off, against JAX's
    one-device flash: forward atol 2e-5 (the edgeless row exactly 0),
    gradients atol 5e-4; the ranks agree bit for bit."""
    world = request.getfixturevalue(f"world{s_n}")
    got = world[0]["attention"][backend]
    np.testing.assert_allclose(got[0], jax_ref[0], atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(got[0][EMPTY_ROW], 0.0)
    for name, g, w in zip(("d_fts", "d_logit_dst", "d_logit_src"), got[1:], jax_ref[1:]):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4, err_msg=name)
    for r in range(1, s_n):
        for a, b in zip(world[r]["attention"][backend], got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("s_n", [2, 4])
@pytest.mark.parametrize("backend", ["sharded", "ring"])
def test_dropout_replays_single_device_masks(request, backend, s_n):
    """Dropout 0.4: the distributed run against the port's one-device run
    with the same seed generator: forward atol 1e-6 (the same global
    masks), gradients atol 1e-5."""
    res = request.getfixturevalue(f"world{s_n}")[0]["dropout"]
    got, want = res[backend], res["single"]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-5)
    assert not np.allclose(got[0], request.getfixturevalue(f"world{s_n}")[0]
                           ["attention"][backend][0])


@pytest.fixture(scope="module")
def jax_ref_bf16(case):
    """JAX's one-device flash on bf16 features (Pallas in interpret mode,
    f32 inside, the output cast back): out and the gradients of
    sum(out·w), as float32."""
    g = j_bcsr(case["adj"], bm=case["bm"], bn=case["bn"])
    fn = lambda *x: jfg.flash_gat_attention(g, *x, interpret=True)
    args = (jnp.asarray(case["fts"]).astype(jnp.bfloat16), jnp.asarray(case["ld"]),
            jnp.asarray(case["ls"]))
    loss = lambda *x: jnp.sum(fn(*x).astype(jnp.float32) * case["w"])
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(fn(*args).astype(jnp.float32))] + [
        np.asarray(x.astype(jnp.float32)) for x in grads]


# bf16 features: both sides round f32 sums that agree to about 1e-6 to bf16
# once, so an output lands at most one bf16 step (2^-7 relative) apart. The
# features' gradient of S strips is S partial sums, each rounded to bf16 at
# its kernel's autograd boundary, summed and rounded again: (S + 1) roundings
# of at most half a step each, bounded by (S + 1)·2^-8 of the largest
# gradient. The logits' gradients stay f32 (the f32 tolerance).
BF16_OUT_TOL = dict(atol=1e-5, rtol=2.0 ** -7)


@pytest.mark.parametrize("s_n", [2, 4])
@pytest.mark.parametrize("backend", ["sharded", "ring"])
def test_bf16_features_match_one_device(request, jax_ref_bf16, backend, s_n):
    """bf16 features on both partitioned backends, dropout off and 0.4: the
    output and the features' gradient come in bf16; against the port's
    one-device flash on the same features and generator and, dropout off,
    against JAX's (BF16_OUT_TOL); the ranks agree bit for bit."""
    world = request.getfixturevalue(f"world{s_n}")
    for key in ("bf16", "bf16_dropout"):
        res = world[0][key]
        assert set(res["dtypes"]) == {("torch.bfloat16", "torch.bfloat16")}
        got = res[backend]
        np.testing.assert_array_equal(got[0][EMPTY_ROW], 0.0)
        for want in [res["single"]] + ([jax_ref_bf16] if key == "bf16" else []):
            np.testing.assert_allclose(got[0], want[0], **BF16_OUT_TOL)
            scale = float(np.abs(want[1]).max())
            np.testing.assert_allclose(got[1], want[1], atol=(s_n + 1) * 2.0 ** -8 * scale,
                                       err_msg="d_fts")
            for name, g, w in zip(("d_logit_dst", "d_logit_src"), got[2:], want[2:]):
                np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4, err_msg=name)
        for r in range(1, s_n):
            for a, b in zip(world[r][key][backend], got):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["sharded", "ring"])
def test_han_logits_match_jax_mesh(world4, han_case, backend):
    """HAN with flax weights converted by nn/convert.py: the port in 4 gloo
    ranks against JAX under make_mesh(graph=4), dropout off: atol 1e-5."""
    for rank in world4:
        np.testing.assert_allclose(rank["han"][backend], han_case["logits"][backend],
                                   atol=1e-5)


@pytest.fixture(scope="module")
def single_device_run():
    return ranks.train("bcsr", 1, TRAIN_EPOCHS)


@pytest.mark.parametrize("fmt", ["partitioned_bcsr", "ring_bcsr"])
def test_trainer_on_mesh_matches_single_device(world4, single_device_run, fmt):
    """Trainer with graph_axis=4 (the dblp preset, dropouts 0.6) matches
    the one-device loss trajectory (rtol 2e-4, atol 2e-5); the parameters
    are equal on every rank after training."""
    runs = [rank["train"][fmt] for rank in world4]
    np.testing.assert_allclose(runs[0]["losses"], single_device_run["losses"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(runs[0]["test_loss"], single_device_run["test_loss"],
                               rtol=2e-4, atol=2e-5)
    for run in runs[1:]:
        assert run["losses"] == runs[0]["losses"]
        for k, v in runs[0]["state"].items():
            np.testing.assert_array_equal(run["state"][k], v, err_msg=k)


@pytest.mark.parametrize("s_n", [2, 4])
def test_dryrun(request, s_n):
    """The dry run lays the ranks out as han_tpu does (a heads axis of 2 at
    4 ranks, none at 2), its deterministic losses agree across backends
    (< 1e-4) and its train step is finite on every rank."""
    heads = 2 if s_n >= 4 else 1
    for rank in request.getfixturevalue(f"world{s_n}"):
        res = rank["dryrun"]
        assert (res["graph"], res["heads"]) == (s_n // heads, heads)
        assert res["det_max_dev"] < 1e-4
        assert all(np.isfinite(v) for v in res["losses"].values())


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["partitioned_bcsr", "ring_bcsr"])
def test_one_shard_partition_matches_bcsr(single_device_run, fmt):
    """graph_axis = 1 with a partitioned format: a 1-shard partition on one
    process (no process group) trains as the one-device bcsr run."""
    got = ranks.train(fmt, 1, TRAIN_EPOCHS)
    np.testing.assert_allclose(got["losses"], single_device_run["losses"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("fmt", ["partitioned_bcsr", "ring_bcsr"])
def test_trainer_graphs_carry_its_mesh(monkeypatch, fmt):
    """The trainer's partitioned graphs carry its mesh to attention, so a
    train step builds no mesh of its own."""
    t = ttrainer.Trainer(ranks.trainer_ds(), ranks.trainer_cfg(fmt, 1, 1), device="cpu",
                         logger=ttrainer.MetricLogger(echo=False))
    assert t.mesh is not None and all(g.mesh is t.mesh for g in t.graphs)

    def no_mesh(*args, **kwargs):
        raise AssertionError("attention built a mesh of its own")

    monkeypatch.setattr(tshard, "make_mesh", no_mesh)
    monkeypatch.setattr(tring, "make_mesh", no_mesh)
    assert np.isfinite(float(t.train_step()[0]))


def test_deterministic_mode_takes_the_split_backward(monkeypatch):
    """Under torch.use_deterministic_algorithms(True) flash_bwd runs the
    row sweep and the column sweep (a spy on the plain functions), not the
    fused backward; the gradients equal the fused ones, and two runs are
    bitwise equal."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    calls = []
    for name in ("flash_bwd_plain", "flash_bwd_row_plain", "flash_bwd_col_plain"):
        orig = getattr(tfg, name)
        monkeypatch.setattr(tfg, name, lambda *a, _f=orig, _n=name: (calls.append(_n), _f(*a))[1])
    c = make_case(n=200, seed=6)
    graph = t_bcsr(c["adj"], bm=64, bn=64)

    def grads():
        args = [torch.tensor(c[x], requires_grad=True) for x in ("fts", "ld", "ls")]
        out = tfg.flash_gat_attention(graph, *args, coef_dropout=0.3,
                                      generator=torch.Generator().manual_seed(2))
        return torch.autograd.grad((out * torch.from_numpy(c["w"])).sum(), args)

    fused = grads()
    assert calls == ["flash_bwd_plain"]
    torch.use_deterministic_algorithms(True)
    try:
        calls.clear()
        split = grads()
        assert calls == ["flash_bwd_row_plain", "flash_bwd_col_plain"]
        again = grads()
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b, f in zip(split, again, fused):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), f.numpy(), atol=1e-6)


def _refusal_mesh():
    """make_mesh raises where han_tpu does (a mesh larger than the world,
    a world not divisible by heads · mp) and on a mesh smaller than it."""
    assert make_mesh(graph=1, device="cpu").size == 1 and make_mesh(device="cpu").rank == 0
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        make_mesh(graph=2)
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        make_mesh(graph=1, heads=2)
    with pytest.raises(ValueError, match="not divisible by heads\\*mp=2"):
        make_mesh(mp=2)
    mesh = make_mesh(graph=0, heads=1, mp=1, device="cpu")
    assert (mesh.graph.size, mesh.heads.size, mesh.mp.size) == (1, 1, 1)


def _refusal_heads_axis():
    """A heads axis partitions the graphs (1-shard partitions at graph 1);
    the trainer's mesh then exceeds a world of one process."""
    ds = ranks.trainer_ds()
    cfg = ranks.trainer_cfg("bcsr", 1, 1)
    cfg.mesh.head_axis = 2
    graphs = ttrainer.build_graphs(ds, cfg)
    assert all(isinstance(g, tshard.PartitionedBCSR) and g.n_shards == 1 for g in graphs)
    with pytest.raises(ValueError, match="exceeds"):
        ttrainer.Trainer(ds, cfg, device="cpu")


def _refusal_csr_formats():
    """csr and ring on a graph axis build PartitionedCSR and
    PartitionedCSR2D (they were refused before edge_partition.py,
    shard_attn.py and ring_attn.py were ported); a format without a
    partitioned variant raises."""
    from han_tpu_torch.parallel.edge_partition import PartitionedCSR
    from han_tpu_torch.parallel.ring_attn import PartitionedCSR2D

    ds = ranks.trainer_ds()
    for fmt, kind in (("csr", PartitionedCSR), ("partitioned", PartitionedCSR),
                      ("ring", PartitionedCSR2D)):
        graphs = ttrainer.build_graphs(ds, ranks.trainer_cfg(fmt, 2, 1))
        assert all(isinstance(g, kind) and g.n_shards == 2 for g in graphs), fmt
    with pytest.raises(ValueError, match="no partitioned variant"):
        ttrainer.build_graphs(ds, ranks.trainer_cfg("dense", 2, 1))


def _refusal_trainer():
    """The trainer's mesh needs the world (ValueError). DPSampledTrainer
    refuses what han_tpu's refuses: the device sampler
    (NotImplementedError) and a batch that does not split over the graph
    axis (ValueError), checked before any collective (a stand-in mesh of 2
    ranks); a sampled run on a partitioned format, which han_tpu has no
    path for, stays refused."""
    from han_tpu_torch.train.sampled import DPSampledTrainer

    ds = ranks.trainer_ds()
    cfg = ranks.trainer_cfg("bcsr", 2, 1)
    with pytest.raises(ValueError, match="exceeds"):
        ttrainer.Trainer(ds, cfg, device="cpu")
    mesh, scfg = ranks.stand_in_mesh(2), ranks.sampled_cfg(4, 1)
    with pytest.raises(NotImplementedError, match="device sampler"):
        DPSampledTrainer(ds, scfg, mesh=mesh, batch_size=16, sampler="device")
    with pytest.raises(ValueError, match="batch_size 15 not divisible by 2 shards"):
        DPSampledTrainer(ds, scfg, mesh=mesh, batch_size=15)
    cfg = ranks.trainer_cfg("ring_bcsr", 1, 1)
    cfg.train.sampled = True
    with pytest.raises(NotImplementedError, match="partitioned format"):
        ttrainer.run(cfg, ds, device="cpu")


def _refusal_vmap_towers():
    """han_tpu's rules: an mp axis forces vmap_towers (set before the mesh
    is made), mp × graph needs bcsr / partitioned_bcsr, vmap_towers needs
    arch='han'; a HAN's towers must split evenly over the mp axis."""
    ds = ranks.trainer_ds()
    cfg = ranks.trainer_cfg("bcsr", 1, 1)
    cfg.mesh.mp_axis = 2
    cfg.model.vmap_towers = False
    with pytest.raises(ValueError, match="exceeds"):
        ttrainer.Trainer(ds, cfg, device="cpu")
    assert cfg.model.vmap_towers
    cfg = ranks.trainer_cfg("ring_bcsr", 2, 1, mp_axis=2)
    with pytest.raises(ValueError, match="composition requires"):
        ttrainer.Trainer(ds, cfg, device="cpu")
    cfg = ranks.trainer_cfg("bcsr", 1, 1)
    cfg.model.arch, cfg.model.vmap_towers = "gat", True
    with pytest.raises(ValueError, match="requires arch='han'"):
        ttrainer.Trainer(ds, cfg, device="cpu")


@pytest.mark.parametrize("case", [_refusal_mesh, _refusal_heads_axis, _refusal_csr_formats,
                                  _refusal_trainer, _refusal_vmap_towers],
                         ids=lambda f: f.__name__.removeprefix("_refusal_"))
def test_mesh_and_trainer_refusals(case):
    """What the mesh and the trainer refuse, and what they took over from
    refusals since the heads and mp axes and the csr partitions were
    ported: one case each."""
    case()


@pytest.mark.parametrize("kind", ["partitioned_bcsr", "ring_bcsr", "csr", "ring"])
def test_return_coefs_raises_on_partitioned_containers(kind):
    """return_coefs stays NotImplementedError on every partitioned
    container, as in han_tpu (han_tpu/ops/attention.py:309-341)."""
    from han_tpu_torch.ops.attention import attention_aggregate

    c = make_case(n=200, seed=2)
    part, _ = ranks.GRID_BACKENDS[kind]
    graph = part(c["adj"], 1, 64, 64)
    args = [torch.from_numpy(c[x]) for x in ("fts", "ld", "ls")]
    with pytest.raises(NotImplementedError, match="return_coefs"):
        attention_aggregate(graph, *args, return_coefs=True)


def test_init_distributed_is_a_noop_without_torchrun(monkeypatch):
    """Without torchrun's environment the entry script's start-up joins no
    process group and this process is the one that logs."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    launch.init_distributed()
    assert not torch.distributed.is_initialized()
    assert launch.is_coordinator()
    launch.shutdown()


def test_spawn_fails_instead_of_hanging_when_a_rank_cannot_start():
    """A rank that dies while loading its arguments (more than a pipe's
    64 KiB of them) makes spawn raise; it does not leave the parent blocked
    writing the rank's start data. Run in a child process under a time
    limit, so that a hang fails this test instead of the suite."""
    import pathlib
    import subprocess
    import sys

    tests = pathlib.Path(__file__).resolve().parent
    code = ("import torch_parallel_ranks as r\n"
            "from han_tpu_torch.parallel import launch\n"
            "launch.spawn(r.count_args, 2, 'gloo', args=(r.Unloadable(), bytes(200_000)))\n")
    env = dict(__import__("os").environ, PYTHONPATH=f"{tests}:{tests.parent}")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=tests.parent, env=env)
    assert proc.returncode != 0
    assert "fails to load on purpose" in proc.stderr, proc.stderr[-2000:]
    ok = subprocess.run([sys.executable, "-c", code.replace("r.Unloadable(), ", "")],
                        capture_output=True, text=True, timeout=120, cwd=tests.parent, env=env)
    assert ok.returncode == 0, ok.stderr[-2000:]


@pytest.mark.parametrize("s_n", [1, 3, 4])
def test_partitioners_match_han_tpu(s_n):
    """partition_bcsr and ring_partition_bcsr equal han_tpu's, field by
    field, at a tile geometry both packages accept."""
    adj = make_case(n=900, seed=s_n)["adj"]
    for tfn, jfn in ((tshard.partition_bcsr, jshard.partition_bcsr),
                     (tring.ring_partition_bcsr, jring.ring_partition_bcsr)):
        tg, jg = tfn(adj, s_n, bm=128, bn=128), jfn(adj, s_n, bm=128, bn=128)
        for f in ("n_nodes", "n_pad", "n_loc", "bm", "bn", "n_edges", "n_shards"):
            assert getattr(tg, f) == getattr(jg, f), f
        arrays = ["tiles", "fwd_count", "fwd_col", "fwd_tile", "bwd_count", "bwd_row",
                  "bwd_tile"] + (["row_block_off", "perm"] if hasattr(jg, "perm")
                                 else ["cs_of_step"])
        for f in arrays:
            got = getattr(tg, f)
            got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
            np.testing.assert_array_equal(got, np.asarray(getattr(jg, f)), err_msg=f)
