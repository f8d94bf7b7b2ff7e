"""Head dims the flash kernels are not instantiated at. Up to the largest of
``KERNEL_HEAD_DIMS`` the CUDA wrappers zero-pad v's and g's head dim to the
next instantiation and slice out and dv back; a wider head runs in the
backward kernels as chunks of 32 columns on the kernels' grid
(``head_plan``, ``fwd_chunked``, ``bwd_chunked``), delta the head's whole
g·out, ([P,] 1, K, n), for every backward (``head_delta``), which each
launch splits over its chunks (``split_delta``: chunk 0 takes it); on
128 x 128 tiles (``takes_wide``) the forward runs it through its wide body
(one chunk of 64 or 128, or chunks of 128: ``head_plan(d,
WIDE_HEAD_DIMS)``) and the fused backward through its own (chunks of 64,
``BWD_WIDE_DIMS``), while the split backward keeps the chunks of 32. The CPU holds
those decompositions, run over the kernels' plain versions
(``flash_*_chunked_plain``), to the full-D plain versions (float64), to each
other, to the unchunked call at one chunk (bitwise) and to han_tpu's flash
attention (interpret mode), which takes any D."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from han_tpu.graph.bcsr import bcsr_from_dense as j_bcsr  # noqa: E402
from han_tpu.ops.pallas.flash_gat import flash_gat_attention as j_flash  # noqa: E402
from han_tpu_torch.graph.bcsr import bcsr_from_dense as t_bcsr  # noqa: E402
from han_tpu_torch.graph.stack import stack_graphs  # noqa: E402
from han_tpu_torch.ops import flash_gat as fg  # noqa: E402

# (plain version, its chunk decomposition) of each backward kernel
BACKWARDS = ((fg.flash_bwd_plain, fg.flash_bwd_chunked_plain),
             (fg.flash_bwd_row_plain, fg.flash_bwd_row_chunked_plain),
             (fg.flash_bwd_col_plain, fg.flash_bwd_col_chunked_plain))


@pytest.mark.parametrize("d,dp", [
    (1, 4), (3, 4), (4, 4), (5, 8), (8, 8), (9, 16), (17, 32), (32, 32), (33, 64), (40, 64),
    (64, 64), (65, 96), (96, 96), (97, 128), (121, 128), (128, 128), (256, 256), (300, 320)])
def test_padded_head_dim(d, dp):
    assert fg.padded_head_dim(d) == dp


def test_head_chunk_plan():
    """Above the largest instantiation (32) a head runs as ⌈D / 32⌉ chunks
    of 32: D = 33, 64, 121, 128 and 300 give their chunk counts and padded
    widths, and nothing raises; delta is the head's g · out in one chunk,
    which a launch splits into that many (chunk 0 takes it, the others are
    zero). Up to 32 a head is one chunk, and delta keeps its chunk axis
    (one layout for every backward)."""
    assert fg.KERNEL_HEAD_DIMS[-1] == fg.HEAD_CHUNK == 32
    for d, nc in ((33, 2), (64, 2), (121, 4), (128, 4), (300, 10)):
        assert fg.head_plan(d) == (32, nc)
        g, out = torch.ones(5, 2 * d), torch.ones(5, 2 * d)
        delta = fg.head_delta(g, out, 2)
        assert delta.shape == (1, 2, 5) and delta.is_contiguous()
        assert delta.tolist() == [[[float(d)] * 5] * 2]
        split = fg.split_delta(delta, nc)
        assert split.shape == (nc, 2, 5) and split.is_contiguous()
        assert torch.equal(split[0], delta[0]) and not split[1:].any()
    for d, dc in ((3, 4), (8, 8), (32, 32)):
        assert fg.head_plan(d) == (dc, 1)
        delta = fg.head_delta(torch.ones(5, 2 * d), torch.ones(5, 2 * d), 2)
        assert delta.shape == (1, 2, 5) and delta.tolist() == [[[float(d)] * 5] * 2]


def test_pad_heads_pads_each_head_and_is_contiguous():
    x = torch.arange(2 * 6, dtype=torch.float32).view(2, 6)  # K = 2 heads of D = 3
    p = fg.pad_heads(x, 2, 4)
    assert p.is_contiguous() and p.shape == (2, 8)
    assert p.tolist() == [[0, 1, 2, 0, 3, 4, 5, 0], [6, 7, 8, 0, 9, 10, 11, 0]]
    assert torch.equal(fg.unpad_heads(p, 2, 3), x) and fg.unpad_heads(p, 2, 3).is_contiguous()
    same = fg.pad_heads(x.view(2, 2, 3)[:, :, :].reshape(2, 6), 2, 3)  # pads nothing
    assert same.is_contiguous() and torch.equal(same, x)


def test_chunks_are_laid_out_as_heads():
    """Chunk c of head h sits at columns (h·nc + c)·dc of the padded rows,
    as the kernels address it; a chunk's columns and the join invert each
    other."""
    x = torch.arange(3 * 2 * 6, dtype=torch.float32).view(3, 12)  # K = 2 heads of 6
    parts = [fg._head_chunk(x, 2, 3, c) for c in range(3)]
    assert parts[1].tolist()[0] == [2, 3, 8, 9]
    assert torch.equal(fg._join_chunks(parts, 2), x)


def small_graph(n=200, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    a[7] = 0.0  # a row without an edge
    return a


def _case(d, k=2, seed=None, n_paths=None):
    """A small graph (or a stack of n_paths), float64 inputs and their
    delta; 64x64 tiles."""
    if n_paths is None:
        graph = t_bcsr(small_graph(), bm=64, bn=64)
        lead = ()
    else:
        graph = stack_graphs([t_bcsr(small_graph(seed=s), bm=64, bn=64)
                              for s in range(n_paths)])
        lead = (n_paths,)
    n = graph.n_pad
    gen = torch.Generator().manual_seed(d if seed is None else seed)
    rnd = lambda *s: torch.randn(*lead, *s, generator=gen, dtype=torch.float64)
    return graph, rnd(k, n), rnd(k, n), rnd(n, k * d), rnd(n, k * d)


@pytest.mark.parametrize("d", [3, 32])
@pytest.mark.parametrize("p", [0.0, 0.6])
def test_head_padding_gives_the_plain_versions(d, p, monkeypatch):
    """At D = 3 (padded to 4) and D = 32 (instantiated): out, lse, the fused
    backward's dld, dls and dv, the row sweep's dld and the column sweep's
    dls and dv through the padding (the chunk decomposition at one chunk)
    equal the plain versions on the unpadded tensors (float64 inputs)."""
    graph, ld, ls, v, g = _case(d)
    k = 2
    meta = fg.FlashMeta(dropout_p=p, seed=17, head_offset=1)
    seen = []

    def spy(fn):
        def call(graph, ld, ls, v, *rest):
            seen.append(v.shape[1] // k)
            return fn(graph, ld, ls, v, *rest)
        return call

    out, lse = fg.flash_fwd_plain(graph, ld, ls, v, meta)
    monkeypatch.setattr(fg, "flash_fwd_plain", spy(fg.flash_fwd_plain))
    pout, plse = fg.flash_fwd_chunked_plain(graph, ld, ls, v, meta)
    assert pout.shape == out.shape and pout.is_contiguous()
    np.testing.assert_allclose(pout.numpy(), out.numpy(), atol=1e-12)
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), atol=1e-12)
    delta = fg.head_delta(g, out, k)
    args = (graph, ld, ls, v, g, lse, delta, meta)
    for plain, chunked in BACKWARDS:
        want = plain(*args)
        monkeypatch.setattr(fg, plain.__name__, spy(plain))
        got = chunked(*args)
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and (b != 0).any()
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    assert seen == [fg.padded_head_dim(d)] * 4


@pytest.mark.parametrize("d", [3, 8, 32])
def test_one_chunk_is_the_unchunked_call(d):
    """At D ≤ 32 the chunk decomposition is the unchunked call, bitwise:
    the plain versions on v and g padded to the instantiation, out and dv
    sliced back (dropout 0.6)."""
    graph, ld, ls, v, g = _case(d)
    k, dp = 2, fg.padded_head_dim(d)
    meta = fg.FlashMeta(dropout_p=0.6, seed=5)
    out, lse = fg.flash_fwd_plain(graph, ld, ls, fg.pad_heads(v, k, dp), meta)
    cout, clse = fg.flash_fwd_chunked_plain(graph, ld, ls, v, meta)
    assert torch.equal(cout, fg.unpad_heads(out, k, d)) and torch.equal(clse, lse)
    delta = fg.head_delta(g, cout, k)
    padded = (graph, ld, ls, fg.pad_heads(v, k, dp), fg.pad_heads(g, k, dp), lse, delta, meta)
    for plain, chunked in BACKWARDS:
        want, got = plain(*padded), chunked(graph, ld, ls, v, g, lse, delta, meta)
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        want = (*want[:-1], fg.unpad_heads(want[-1], k, d)) if len(want) > 1 else want
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d", [40, 64, 100, 128])
@pytest.mark.parametrize("p", [0.0, 0.6])
def test_chunks_give_the_full_head_plain_versions(d, p):
    """D = 40 and 64 (two chunks of 32 a head) and 100 and 128 (four)
    against the full-D plain versions (float64 inputs, atol 1e-12): out and
    lse, and each backward, given the head's delta (split over the
    chunks by each launch)."""
    graph, ld, ls, v, g = _case(d)
    k = 2
    meta = fg.FlashMeta(dropout_p=p, seed=23, head_offset=1)
    out, lse = fg.flash_fwd_plain(graph, ld, ls, v, meta)
    cout, clse = fg.flash_fwd_chunked_plain(graph, ld, ls, v, meta)
    np.testing.assert_allclose(cout.numpy(), out.numpy(), atol=1e-12)
    assert torch.equal(clse, lse)
    delta = fg.head_delta(g, out, k)
    assert delta.shape == (1, k, graph.n_pad)
    args = (graph, ld, ls, v, g, lse, delta, meta)
    for plain, chunked in BACKWARDS:
        want, got = plain(*args), chunked(*args)
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.is_contiguous()
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


def test_chunks_of_a_stack_are_per_path():
    """A stack of 2 graphs at D = 64, dropout 0.6 (a seed a path): the chunk
    decomposition against the full-D plain versions (atol 1e-12), delta
    the head's ([P,] 1, K, n)."""
    graph, ld, ls, v, g = _case(64, n_paths=2, seed=8)
    meta = fg.FlashMeta(dropout_p=0.6, seed=torch.tensor([11, 12], dtype=torch.int32))
    out, lse = fg.flash_fwd_plain(graph, ld, ls, v, meta)
    cout, clse = fg.flash_fwd_chunked_plain(graph, ld, ls, v, meta)
    np.testing.assert_allclose(cout.numpy(), out.numpy(), atol=1e-12)
    assert torch.equal(clse, lse)
    delta = fg.head_delta(g, out, 2)
    assert delta.shape == (2, 1, 2, graph.n_pad)
    for plain, chunked in BACKWARDS:
        want, got = plain(graph, ld, ls, v, g, lse, delta, meta), chunked(
            graph, ld, ls, v, g, lse, delta, meta)
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


def test_split_chunks_repeat_bitwise():
    """The split backward's chunk decomposition (row, then column sweep) at
    D = 64, dropout 0.6, run twice: bitwise equal (the partial sums added
    in chunk order)."""
    graph, ld, ls, v, g = _case(64, seed=9)
    meta = fg.FlashMeta(dropout_p=0.6, seed=31)
    out, lse = fg.flash_fwd_chunked_plain(graph, ld, ls, v, meta)
    args = (graph, ld, ls, v, g, lse, fg.head_delta(g, out, 2), meta)
    runs = [(fg.flash_bwd_row_chunked_plain(*args), *fg.flash_bwd_col_chunked_plain(*args))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _through_chunks(monkeypatch):
    """Route the autograd function through the chunk decomposition."""
    monkeypatch.setattr(fg, "flash_fwd", fg.flash_fwd_chunked_plain)
    monkeypatch.setattr(fg, "flash_bwd", fg.flash_bwd_chunked_plain)


def test_head_padding_matches_jax_interpreted(monkeypatch):
    """D = 3 through the padding wrappers (around the plain versions, as the
    CUDA wrappers wrap the kernels), forward and gradients of
    sum(out · w), against han_tpu's flash attention in interpret mode."""
    n, k, d = 200, 2, 3
    a = small_graph(n, seed=3)
    rng = np.random.default_rng(4)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    fts, ld, ls, w = f32(n, k, d), f32(n, k), f32(n, k), f32(n, k, d)
    seen = []
    fwd = fg.flash_fwd_chunked_plain
    _through_chunks(monkeypatch)
    monkeypatch.setattr(fg, "flash_fwd", lambda graph, ld, ls, v, meta: (
        seen.append(v.shape), fwd(graph, ld, ls, v, meta))[1])
    tg = t_bcsr(a, bm=64, bn=64)
    args = [torch.tensor(x, requires_grad=True) for x in (fts, ld, ls)]
    out = fg.flash_gat_attention(tg, *args)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), args)
    got = [out.detach().numpy()] + [x.numpy() for x in grads]
    assert seen == [(tg.n_pad, k * d)]

    jg = j_bcsr(a, bm=64, bn=64)
    jfn = lambda *x: j_flash(jg, *x, interpret=True)
    jargs = tuple(jnp.asarray(x) for x in (fts, ld, ls))
    jgrads = jax.grad(lambda *x: jnp.sum(jfn(*x) * w), argnums=(0, 1, 2))(*jargs)
    want = [np.asarray(jfn(*jargs))] + [np.asarray(x) for x in jgrads]
    np.testing.assert_array_equal(got[0][7], 0.0)
    for name, x, y in zip(("out", "d_fts", "d_logit_dst", "d_logit_src"), got, want):
        np.testing.assert_allclose(x, y, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("d", [40, 64])
def test_head_chunks_match_jax_interpreted(d, monkeypatch):
    """D = 40 and 64, two chunks a head, through the chunk decomposition at
    dropout 0: out and the gradients of sum(out · w) in fts, logit_dst and
    logit_src against han_tpu's flash attention in interpret mode. The
    port's side runs on float64 inputs (the first f32 exp of a process may
    be off on the CPU), han_tpu's in float32: atol 1e-5, its f32 error."""
    n, k = 256, 2  # n = n_pad: no padding rows
    a = small_graph(n, seed=6)
    rng = np.random.default_rng(d)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    fts, ld, ls, w = f32(n, k, d), f32(n, k), f32(n, k), f32(n, k, d)
    _through_chunks(monkeypatch)
    tg = t_bcsr(a, bm=64, bn=64)
    assert tg.n_pad == n and fg.head_plan(d)[1] == 2
    f64 = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (fts, ld, ls)]
    out = fg._FlashGAT.apply(f64[1].T.contiguous(), f64[2].T.contiguous(),
                             f64[0].reshape(n, k * d), tg, fg.FlashMeta())
    grads = torch.autograd.grad((out.view(n, k, d) * torch.from_numpy(w)).sum(), f64)
    got = [out.detach().view(n, k, d).numpy()] + [x.numpy() for x in grads]

    jg = j_bcsr(a, bm=64, bn=64)
    jfn = lambda *x: j_flash(jg, *x, interpret=True)
    jargs = tuple(jnp.asarray(x) for x in (fts, ld, ls))
    jgrads = jax.grad(lambda *x: jnp.sum(jfn(*x) * w), argnums=(0, 1, 2))(*jargs)
    want = [np.asarray(jfn(*jargs))] + [np.asarray(x) for x in jgrads]
    np.testing.assert_array_equal(got[0][7], 0.0)
    for name, x, y in zip(("out", "d_fts", "d_logit_dst", "d_logit_src"), got, want):
        assert np.abs(y).max() > 0, name
        np.testing.assert_allclose(x, y, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("d,wide,bwd,chunks", [
    (3, (4, 1), (4, 1), (4, 1)), (32, (32, 1), (32, 1), (32, 1)),
    (33, (64, 1), (64, 1), (32, 2)), (64, (64, 1), (64, 1), (32, 2)),
    (65, (128, 1), (64, 2), (32, 3)), (121, (128, 1), (64, 2), (32, 4)),
    (128, (128, 1), (64, 2), (32, 4)), (256, (128, 2), (64, 4), (32, 8)),
    (300, (128, 3), (64, 5), (32, 10))])
def test_wide_head_plan(d, wide, bwd, chunks):
    """The forward's wide body takes a padded head of 64 or 128 in one
    chunk, and a wider one in chunks of 128 (half a head of 256 a block);
    the fused backward's takes chunks of 64; up to 32 the plan is today's;
    the split backward keeps its chunks of 32. One delta, the head's,
    serves both backwards: each launch splits it over its own chunks."""
    assert fg.head_plan(d, fg.WIDE_HEAD_DIMS) == wide
    assert fg.head_plan(d, fg.BWD_WIDE_DIMS) == bwd
    assert fg.head_plan(d) == chunks
    delta = fg.head_delta(torch.ones(5, 2 * d), torch.ones(5, 2 * d), 2)
    assert delta.shape == (1, 2, 5)
    for nc in (bwd[1], chunks[1]):
        split = fg.split_delta(delta, nc)
        assert split.shape == (nc, 2, 5) and split.is_contiguous()
        assert fg.sum_chunks(split).tolist() == [[float(d)] * 5] * 2


def _wide_graph(n_paths=None, seed=0):
    """A graph of 300 nodes (or a stack of n_paths) on 128 x 128 tiles, the
    wide body's: rows and columns past the nodes, a row without an edge."""
    graphs = [t_bcsr(small_graph(300, 0.08, seed + s)) for s in range(n_paths or 1)]
    assert all(gr.bm == gr.bn == 128 for gr in graphs)
    return graphs[0] if n_paths is None else stack_graphs(graphs)


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("d", [8, 64, 121, 256])
def test_launchers_pick_the_body(bm, d, monkeypatch):
    """Through the CUDA wrappers (their launches replaced by the plain
    versions' chunk loops): on 128 x 128 tiles the forward and the fused
    backward launch a head above 32 as their wide plans' chunks, on other
    tiles as chunks of 32; the split backward always as chunks of 32."""
    graph = t_bcsr(small_graph(300, 0.08, 1), bm=bm, bn=bm)
    k, n = 2, graph.n_pad
    gen = torch.Generator().manual_seed(d)
    ld, ls, v, g = (torch.randn(*s, generator=gen, dtype=torch.float64)
                    for s in ((k, n), (k, n), (n, k * d), (n, k * d)))
    meta = fg.FlashMeta(dropout_p=0.6, seed=7)
    seen = []

    def spy(name, launch):
        def call(graph, ld, ls, v, *rest):
            seen.append((name, v.shape[-1] // (k * rest[-1]), rest[-1]))
            return launch(graph, ld, ls, v, *rest)
        return call

    monkeypatch.setattr(fg, "_fwd_launch", spy("fwd", fg._fwd_chunks_plain))
    for name, plain in (("bwd", fg.flash_bwd_plain), ("row", fg.flash_bwd_row_plain),
                        ("col", fg.flash_bwd_col_plain)):
        monkeypatch.setattr(fg, f"_{name}_launch" if name == "bwd" else f"_bwd_{name}_launch",
                            spy(name, fg._bwd_chunks_plain(plain)))
    out, lse = fg.flash_fwd_cuda(graph, ld, ls, v, meta)
    args = (graph, ld, ls, v, g, lse, fg.head_delta(g, out, k), meta)
    fg.flash_bwd_cuda(*args)
    fg.flash_bwd_row_cuda(*args)
    fg.flash_bwd_col_cuda(*args)
    fwd_plan = fg.head_plan(d, fg.WIDE_HEAD_DIMS if bm == 128 else ())
    bwd_plan = fg.head_plan(d, fg.BWD_WIDE_DIMS if bm == 128 else ())
    assert seen == ([("fwd", *fwd_plan), ("bwd", *bwd_plan)]
                    + [(name, *fg.head_plan(d)) for name in ("row", "col")])
    assert (fwd_plan[0] in fg.WIDE_HEAD_DIMS) == (bm == 128 and d > 32)
    assert (bwd_plan[0] in fg.BWD_WIDE_DIMS) == (bm == 128 and d > 32)


@pytest.mark.parametrize("d", [64, 121, 256])
@pytest.mark.parametrize("p", [0.0, 0.6])
@pytest.mark.parametrize("n_paths", [None, 2])
def test_wide_plan_gives_the_chunked_route(d, p, n_paths):
    """The forward through the wide body's plan (one chunk of 64 or 128, two
    of 128 at D = 256) and the fused backward through its own (chunks of
    64), as the wrappers take them on these tiles, against the chunked
    route (chunks of 32, the wrappers' helpers with wide=False) and the
    full-D plain versions, on 128 x 128 tiles, with and without dropout
    0.6, one graph or a stack of two (a seed a path; float64 inputs, atol
    1e-12: they differ by round-off alone)."""
    graph = _wide_graph(n_paths, seed=d)
    lead = () if n_paths is None else (n_paths,)
    k, n = 2, graph.n_pad
    gen = torch.Generator().manual_seed(d + 1)
    rnd = lambda *s: torch.randn(*lead, *s, generator=gen, dtype=torch.float64)
    ld, ls, v, g = rnd(k, n), rnd(k, n), rnd(n, k * d), rnd(n, k * d)
    seed = 41 if n_paths is None else torch.tensor([41, 42], dtype=torch.int32)
    meta = fg.FlashMeta(dropout_p=p, seed=seed, head_offset=1)
    assert fg.takes_wide(graph)
    out, lse = fg.flash_fwd_chunked_plain(graph, ld, ls, v, meta)
    cout, clse = fg.fwd_chunked(fg._fwd_chunks_plain, graph, ld, ls, v, meta, wide=False)
    fout, flse = fg.flash_fwd_plain(graph, ld, ls, v, meta)
    assert out.shape == fout.shape and out.is_contiguous() and (out != 0).any()
    for a, b in ((out, cout), (out, fout)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    assert torch.equal(lse, clse) and torch.equal(lse, flse)
    args = (graph, ld, ls, v, g, lse, fg.head_delta(g, out, k), meta)
    wide = fg.flash_bwd_chunked_plain(*args)
    chunked = fg.bwd_chunked(fg._bwd_chunks_plain(fg.flash_bwd_plain), *args, wide=False)
    for want in (chunked, fg.flash_bwd_plain(*args)):
        for a, b in zip(wide, want):
            assert a.shape == b.shape and a.is_contiguous() and (b != 0).any()
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
