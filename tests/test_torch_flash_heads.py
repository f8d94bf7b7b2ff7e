"""Head dims the flash kernels are not instantiated at: the CUDA wrappers
zero-pad v's and g's head dim to the next of ``KERNEL_HEAD_DIMS`` and
slice out and dv back (``fwd_head_padded``, ``bwd_head_padded``). The
CPU holds that wrapping, around the kernels' plain versions, to the
unpadded plain versions and to han_tpu's flash attention (interpret mode),
which takes any D."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from han_tpu.graph.bcsr import bcsr_from_dense as j_bcsr  # noqa: E402
from han_tpu.ops.pallas.flash_gat import flash_gat_attention as j_flash  # noqa: E402
from han_tpu_torch.graph.bcsr import bcsr_from_dense as t_bcsr  # noqa: E402
from han_tpu_torch.ops import flash_gat as fg  # noqa: E402


@pytest.mark.parametrize("d,dp", [(1, 4), (3, 4), (4, 4), (5, 8), (8, 8), (9, 16), (17, 32),
                                  (32, 32)])
def test_padded_head_dim(d, dp):
    assert fg.padded_head_dim(d) == dp


def test_head_dim_above_the_largest_instantiation_raises():
    assert fg.KERNEL_HEAD_DIMS[-1] == 32
    with pytest.raises(NotImplementedError, match="D <= 32"):
        fg.padded_head_dim(33)
    x = torch.zeros(4, 2 * 33)
    with pytest.raises(NotImplementedError, match="D <= 32"):
        fg.bwd_head_padded(fg.flash_bwd_plain, None, torch.zeros(2, 4), None, x, x, None, None,
                           fg.FlashMeta())


def test_pad_heads_pads_each_head_and_is_contiguous():
    x = torch.arange(2 * 6, dtype=torch.float32).view(2, 6)  # K = 2 heads of D = 3
    p = fg.pad_heads(x, 2, 4)
    assert p.is_contiguous() and p.shape == (2, 8)
    assert p.tolist() == [[0, 1, 2, 0, 3, 4, 5, 0], [6, 7, 8, 0, 9, 10, 11, 0]]
    assert torch.equal(fg.unpad_heads(p, 2, 3), x) and fg.unpad_heads(p, 2, 3).is_contiguous()
    same = fg.pad_heads(x.view(2, 2, 3)[:, :, :].reshape(2, 6), 2, 3)  # pads nothing
    assert same.is_contiguous() and torch.equal(same, x)


def small_graph(n=200, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    a[7] = 0.0  # a row without an edge
    return a


@pytest.mark.parametrize("d", [3, 32])
@pytest.mark.parametrize("p", [0.0, 0.6])
def test_head_padding_gives_the_plain_versions(d, p):
    """At D = 3 (padded to 4) and D = 32 (instantiated): out, lse, the fused
    backward's dld, dls and dv, the row sweep's dld and the column sweep's
    dls and dv through the padding wrappers equal the plain versions on the
    unpadded tensors (float64 inputs)."""
    graph = t_bcsr(small_graph(), bm=64, bn=64)
    n, k = graph.n_pad, 2
    gen = torch.Generator().manual_seed(d)
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    ld, ls, v, g = rnd(k, n), rnd(k, n), rnd(n, k * d), rnd(n, k * d)
    meta = fg.FlashMeta(dropout_p=p, seed=17, head_offset=1)
    seen = []

    def spy(fn):
        def call(graph, ld, ls, v, *rest):
            seen.append(v.shape[1] // k)
            return fn(graph, ld, ls, v, *rest)
        return call

    out, lse = fg.flash_fwd_plain(graph, ld, ls, v, meta)
    pout, plse = fg.fwd_head_padded(spy(fg.flash_fwd_plain), graph, ld, ls, v, meta)
    assert pout.shape == out.shape and pout.is_contiguous()
    np.testing.assert_allclose(pout.numpy(), out.numpy(), atol=1e-12)
    np.testing.assert_allclose(plse.numpy(), lse.numpy(), atol=1e-12)
    delta = (g * out).view(n, k, d).sum(-1).T.contiguous()
    args = (graph, ld, ls, v, g, lse, delta, meta)
    for plain in (fg.flash_bwd_plain, fg.flash_bwd_row_plain, fg.flash_bwd_col_plain):
        want = plain(*args)
        got = fg.bwd_head_padded(spy(plain), *args)
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and (b != 0).any()
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    assert seen == [fg.padded_head_dim(d)] * 4


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
    fwd, bwd = fg.flash_fwd_plain, fg.flash_bwd_plain
    monkeypatch.setattr(fg, "flash_fwd", lambda graph, ld, ls, v, meta: (
        seen.append(v.shape), fg.fwd_head_padded(fwd, graph, ld, ls, v, meta))[1])
    monkeypatch.setattr(fg, "flash_bwd", lambda *args: fg.bwd_head_padded(bwd, *args))
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
