"""han_tpu_torch attention ops against han_tpu's: dense and csr (outputs and
gradients, with an edgeless row and padded edges), the plain flash path
against JAX's interpreted Pallas kernels, and the fused coefficient
dropout inside the port (mask replay, keep rate, finite differences)."""

import math

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from han_tpu.graph.bcsr import bcsr_from_dense as j_bcsr  # noqa: E402
from han_tpu.graph.containers import csr_from_scipy as j_csr  # noqa: E402
from han_tpu.graph.containers import dense_from_numpy as j_dense  # noqa: E402
from han_tpu.ops import attention as jatt  # noqa: E402
from han_tpu.ops.pallas.flash_gat import flash_gat_attention as j_flash  # noqa: E402
from han_tpu_torch.graph.bcsr import BCSRGraph, bcsr_from_dense as t_bcsr  # noqa: E402
from han_tpu_torch.graph.containers import csr_from_scipy as t_csr  # noqa: E402
from han_tpu_torch.graph.containers import dense_from_numpy as t_dense  # noqa: E402
from han_tpu_torch.ops import attention as tatt  # noqa: E402
from han_tpu_torch.ops import flash_gat as tfg  # noqa: E402

EMPTY_ROW = 5


def make_case(n, k, d, seed, density=0.1):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    a[EMPTY_ROW] = 0.0
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return a, f32(n, k, d), f32(n, k), f32(n, k), f32(n, k, d)


def run_jax(fn, fts, ld, ls, w):
    """out and d(sum(out·w))/d(fts, ld, ls)."""
    loss = lambda *x: jnp.sum(fn(*x) * w)
    args = tuple(jnp.asarray(x) for x in (fts, ld, ls))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(fn(*args))] + [np.asarray(g) for g in grads]


def run_torch(fn, fts, ld, ls, w):
    args = [torch.tensor(x, requires_grad=True) for x in (fts, ld, ls)]
    out = fn(*args)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), args)
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def assert_all_close(got, want, atol, rtol=0.0):
    for name, g, w in zip(("out", "d_fts", "d_logit_dst", "d_logit_src"), got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("impl", ["dense", "csr"])
def test_dense_and_csr_match_jax(impl):
    a, fts, ld, ls, w = make_case(64, 3, 8, seed=1)
    if impl == "dense":
        jg, tg = j_dense(a, add_self_loops=False), t_dense(a, add_self_loops=False)
        jfn, tfn = jatt.dense_attention, tatt.dense_attention
    else:
        jg, tg = j_csr(sp.csr_matrix(a)), t_csr(sp.csr_matrix(a))
        assert tg.e_pad > tg.n_edges  # padded edges are exercised
        jfn, tfn = jatt.csr_attention, tatt.csr_attention
    got = run_torch(lambda *x: tfn(tg, *x), fts, ld, ls, w)
    want = run_jax(lambda *x: jfn(jg, *x), fts, ld, ls, w)
    assert_all_close(got, want, atol=1e-5)
    _, c_t = tfn(tg, *(torch.from_numpy(x) for x in (fts, ld, ls)), return_coefs=True)
    _, c_j = jfn(jg, *(jnp.asarray(x) for x in (fts, ld, ls)), return_coefs=True)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)


@pytest.mark.parametrize("k", [1, 8])
def test_flash_plain_matches_jax_interpreted(k):
    """Dropout off: the port's flash path on the CPU (the kernels' plain
    versions) against han_tpu's Pallas kernels in interpret mode."""
    a, fts, ld, ls, w = make_case(300, k, 8, seed=k)
    jg, tg = j_bcsr(a, bm=128, bn=128), t_bcsr(a, bm=128, bn=128)
    got = run_torch(lambda *x: tfg.flash_gat_attention(tg, *x), fts, ld, ls, w)
    want = run_jax(lambda *x: j_flash(jg, *x, interpret=True), fts, ld, ls, w)
    np.testing.assert_array_equal(got[0][EMPTY_ROW], 0.0)
    assert_all_close(got, want, atol=1e-5)


def dense_dropout_reference(a, fts, ld, ls, seed, p, slope=0.2):
    """Masked softmax attention with the port's dropout mask made explicit,
    differentiated by autograd; edgeless rows give 0."""
    n, k, _ = fts.shape
    adj = torch.from_numpy(a != 0)
    idx = torch.arange(n)
    scale = torch.stack([torch.where(tfg.dropout_keep(seed, idx, idx, h, p),
                                     1.0 / (1.0 - p), 0.0) for h in range(k)])
    raw = ld.T[:, :, None] + ls.T[:, None, :]
    z = torch.where(adj, torch.where(raw >= 0, raw, slope * raw), -1e9)
    coefs = torch.softmax(z, dim=-1) * adj.any(dim=1)[None, :, None]
    return torch.einsum("knm,mkd->nkd", coefs * scale, fts)


@pytest.mark.parametrize("bm,bn", [(32, 32), (64, 128)])
def test_flash_dropout_backward_replays_forward_mask(bm, bn):
    """With dropout on, the fused forward/backward equal autograd through
    the dense math with the same explicit mask, at two tile geometries (the
    mask is keyed on global coordinates, not on tiles)."""
    p = 0.6
    a, fts, ld, ls, w = make_case(150, 4, 8, seed=11, density=0.2)
    graph = t_bcsr(a, bm=bm, bn=bn)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=torch.Generator().manual_seed(5)))
    got = run_torch(lambda *x: tfg.flash_gat_attention(
        graph, *x, coef_dropout=p, generator=torch.Generator().manual_seed(5)),
        fts, ld, ls, w)
    want = run_torch(lambda *x: dense_dropout_reference(a, *x, seed=seed, p=p),
                     fts, ld, ls, w)
    assert_all_close(got, want, atol=1e-5)
    no_drop = tfg.flash_gat_attention(graph, *(torch.from_numpy(x) for x in (fts, ld, ls)))
    assert not np.allclose(got[0], no_drop.numpy())


def _drop_bits_reference(seed, row, col, head):
    """csrc/flash_gat.cu's drop_bits on Python ints with explicit uint32
    wrap-around."""
    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)
    head_key = fmix(seed ^ fmix((head + 0x9E3779B9) & 0xFFFFFFFF))
    return fmix(fmix(head_key ^ row) ^ ((col * 0x9E3779B9) & 0xFFFFFFFF))


@pytest.mark.parametrize("p", [0.3, 0.6])
def test_dropout_keep_rate_and_hash(p):
    rows, cols = torch.arange(512), torch.arange(1000, 1512)
    masks = [tfg.dropout_keep(987654321, rows, cols, h, p) for h in range(3)]
    sigma = math.sqrt(p * (1 - p) / masks[0].numel())
    for m in masks:
        assert abs(m.float().mean().item() - (1 - p)) < 4 * sigma
    assert (masks[0] != masks[1]).any() and (masks[1] != masks[2]).any()
    thresh = tfg.keep_threshold(p)
    rng = np.random.default_rng(0)
    for r, c in rng.integers(0, 512, size=(20, 2)):
        want = _drop_bits_reference(987654321, int(r), 1000 + int(c), 2) < thresh
        assert bool(masks[2][r, c]) == want


def test_flash_dropout_gradcheck():
    """Finite differences (float64) of the fused op with dropout on: the
    backward's replayed mask is the forward's."""
    a, *_ = make_case(40, 2, 4, seed=3, density=0.3)
    graph = t_bcsr(a, bm=32, bn=32)
    meta = tfg.FlashMeta(slope=0.2, dropout_p=0.35, seed=77)
    rng = np.random.default_rng(4)
    n_pad = graph.n_pad
    args = [torch.tensor(rng.standard_normal(s), dtype=torch.float64, requires_grad=True)
            for s in ((2, n_pad), (2, n_pad), (n_pad, 8))]
    assert torch.autograd.gradcheck(
        lambda ld, ls, v: tfg._FlashGAT.apply(ld, ls, v, graph, meta), args,
        eps=1e-6, atol=1e-6, rtol=1e-4, fast_mode=True)


def test_flash_wrapper_rejects_and_never_falls_back():
    """A non-CPU tensor goes to the kernel wrapper, which raises on what it
    cannot launch; it never runs the plain version."""
    a, fts, ld, ls, _ = make_case(64, 2, 8, seed=2)
    graph = t_bcsr(a, bm=64, bn=64)
    meta_dev = lambda *s: torch.empty(*s, device="meta")
    n = graph.n_pad
    with pytest.raises(ValueError, match="CUDA"):
        tfg.flash_fwd(graph, meta_dev(2, n), meta_dev(2, n), meta_dev(n, 16), tfg.FlashMeta())
    with pytest.raises(ValueError, match="CUDA"):
        tfg.flash_bwd(graph, meta_dev(2, n), meta_dev(2, n), meta_dev(n, 16),
                      meta_dev(n, 16), meta_dev(2, n), meta_dev(2, n), tfg.FlashMeta())
    fts_t, ld_t, ls_t = (torch.from_numpy(x) for x in (fts, ld, ls))
    with pytest.raises(NotImplementedError, match="float32"):
        tfg.flash_gat_attention(graph, fts_t.bfloat16(), ld_t, ls_t)
    with pytest.raises(ValueError, match="generator"):
        tfg.flash_gat_attention(graph, fts_t, ld_t, ls_t, coef_dropout=0.5)
    assert isinstance(graph, BCSRGraph)
    out = tatt.attention_aggregate(graph, fts_t, ld_t, ls_t)  # auto → flash
    np.testing.assert_array_equal(out.numpy(), tfg.flash_gat_attention(graph, fts_t, ld_t, ls_t).numpy())
    with pytest.raises(NotImplementedError):
        tatt.attention_aggregate(graph, fts_t, ld_t, ls_t, return_coefs=True)
