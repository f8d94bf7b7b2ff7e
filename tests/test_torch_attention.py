"""han_tpu_torch attention ops against han_tpu's: dense and csr (outputs and
gradients, with an edgeless row and padded edges), the plain flash path
against JAX's interpreted Pallas kernels, the fused coefficient dropout
inside the port (mask replay, keep rate, finite differences), and the ELL
ops of the sampled path: ell_fused's plain version against JAX's
interpreted Pallas kernel and its segment-op VJP with one keep mask, ell
against han_tpu's and against ell_fused with dropout on, and tree_ell
against han_tpu's ``_tree_core``."""

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
from han_tpu.graph.containers import EllGraph as JEll  # noqa: E402
from han_tpu.ops import attention as jatt  # noqa: E402
from han_tpu.ops import tree_ell as jtree  # noqa: E402
from han_tpu.ops.pallas import ell_fused as jef  # noqa: E402
from han_tpu.ops.pallas.flash_gat import flash_gat_attention as j_flash  # noqa: E402
from han_tpu_torch.graph.bcsr import BCSRGraph, bcsr_from_dense as t_bcsr  # noqa: E402
from han_tpu_torch.graph.containers import EllGraph as TEll  # noqa: E402
from han_tpu_torch.graph.containers import TreeEllGraph as TTree  # noqa: E402
from han_tpu_torch.graph.containers import csr_from_scipy as t_csr  # noqa: E402
from han_tpu_torch.graph.containers import dense_from_numpy as t_dense  # noqa: E402
from han_tpu_torch.ops import attention as tatt  # noqa: E402
from han_tpu_torch.ops import ell_fused as tef  # noqa: E402
from han_tpu_torch.ops import flash_gat as tfg  # noqa: E402
from han_tpu_torch.ops import tree_ell as ttree  # noqa: E402

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
    bwd_args = (meta_dev(2, n), meta_dev(2, n), meta_dev(n, 16), meta_dev(n, 16),
                meta_dev(2, n), meta_dev(2, n), tfg.FlashMeta())
    for bwd in (tfg.flash_bwd, tfg.flash_bwd_row, tfg.flash_bwd_col):
        with pytest.raises(ValueError, match="CUDA"):
            bwd(graph, *bwd_args)
    fts_t, ld_t, ls_t = (torch.from_numpy(x) for x in (fts, ld, ls))
    with pytest.raises(NotImplementedError, match="float32 or torch.bfloat16"):
        tfg.flash_gat_attention(graph, fts_t.half(), ld_t, ls_t)
    with pytest.raises(ValueError, match="generator"):
        tfg.flash_gat_attention(graph, fts_t, ld_t, ls_t, coef_dropout=0.5)
    assert isinstance(graph, BCSRGraph)
    out = tatt.attention_aggregate(graph, fts_t, ld_t, ls_t)  # auto → flash
    np.testing.assert_array_equal(out.numpy(), tfg.flash_gat_attention(graph, fts_t, ld_t, ls_t).numpy())
    with pytest.raises(NotImplementedError):
        tatt.attention_aggregate(graph, fts_t, ld_t, ls_t, return_coefs=True)


def test_flash_passes_contiguous_inputs_without_padding(monkeypatch):
    """At N = n_pad (no padding rows) flash_gat_attention still hands the
    kernels contiguous (K, N) logits and (N, K·D) features: the CUDA
    wrappers refuse the transposed views F.pad returns when it pads
    nothing (bench_torch.py at N = 8192 met this on the card)."""
    a, fts, ld, ls, w = make_case(128, 2, 8, seed=4)
    graph = t_bcsr(a, bm=64, bn=64)
    assert graph.n_pad == 128
    seen, orig = [], tfg.flash_fwd
    monkeypatch.setattr(tfg, "flash_fwd", lambda g, *t: (
        seen.append([x.is_contiguous() for x in t[:3]]), orig(g, *t))[1])
    got = run_torch(lambda *x: tfg.flash_gat_attention(graph, *x), fts, ld, ls, w)
    assert seen == [[True, True, True]] and np.isfinite(got[0]).all()


# ---------------------------------------------------------------------------
# ELL ops of the sampled path
# ---------------------------------------------------------------------------


def ell_case(n, f, k, d, seed):
    """Random ELL lists (sentinel n) with about a quarter of the slots empty,
    one edgeless row, and float inputs; F need not be a multiple of 8."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (n, f)).astype(np.int32)
    nbr[rng.random((n, f)) < 0.25] = n
    nbr[EMPTY_ROW] = n
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return nbr, f32(n, k, d), f32(n, k), f32(n, k), f32(n, k, d)


def keep_mask(n, f, k, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, f, k)) < 1 - p).astype(np.uint8)


@pytest.mark.parametrize("f,p", [(5, 0.0), (5, 0.4), (16, 0.4)])
def test_ell_fused_plain_matches_jax_interpreted(f, p):
    """The kernel's plain version and the plain-torch backward against
    han_tpu's _ell_fused_core (Pallas forward in interpret mode, segment-op
    VJP), fed one numpy keep mask: atol 1e-5 on outputs and gradients (the
    same math in another summation order)."""
    n, k, d = 40, 3, 8
    nbr, fts, ld, ls, w = ell_case(n, f, k, d, seed=f)
    keep = keep_mask(n, f, k, p, seed=1) if p else None
    jkeep = jnp.asarray(keep if p else np.zeros((1, 1, 1), np.uint8))
    want = run_jax(lambda *x: jef._ell_fused_core(jnp.asarray(nbr), jkeep, *x, 0.2, 128, True, p),
                   fts, ld, ls, w)
    tkeep = torch.from_numpy(keep) if p else None
    got = run_torch(lambda fts_, ld_, ls_: tef._EllFused.apply(
        fts_.reshape(n, k * d), ld_, ls_, torch.from_numpy(nbr), tkeep, 0.2, p).view(n, k, d),
        fts, ld, ls, w)
    np.testing.assert_array_equal(got[0][EMPTY_ROW], 0.0)
    assert_all_close(got, want, atol=1e-5)


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_ell_attention_matches_jax_and_ell_fused(p):
    """ell against han_tpu's ell_attention (dropout off; outputs and
    gradients, atol 1e-5), and, inside the port, ell against ell_fused with
    dropout on: both draw their keep mask from the same generator state, so
    outputs and gradients agree to float rounding (atol 1e-5)."""
    n, f, k, d = 40, 6, 2, 8
    nbr, fts, ld, ls, w = ell_case(n, f, k, d, seed=3)
    tg = TEll(nbr=torch.from_numpy(nbr), deg=torch.from_numpy((nbr < n).sum(1).astype(np.int32)),
              n_nodes=n, n_edges=int((nbr < n).sum()))
    if p == 0.0:
        jg = JEll(nbr=jnp.asarray(nbr), deg=jnp.asarray(tg.deg.numpy()), n_nodes=n,
                  n_edges=tg.n_edges)
        want = run_jax(lambda *x: jatt.ell_attention(jg, *x), fts, ld, ls, w)
        got = run_torch(lambda *x: tatt.attention_aggregate(tg, *x), fts, ld, ls, w)  # auto → ell
        assert_all_close(got, want, atol=1e-5)
        return
    outs = {}
    for impl in ("ell", "ell_fused"):
        gen = torch.Generator().manual_seed(9)
        outs[impl] = run_torch(lambda *x: tatt.attention_aggregate(
            tg, *x, impl=impl, coef_dropout=p, generator=gen), fts, ld, ls, w)
    assert_all_close(outs["ell_fused"], outs["ell"], atol=1e-5)
    undropped = tatt.ell_attention(tg, *(torch.from_numpy(x) for x in (fts, ld, ls)))
    assert not np.allclose(outs["ell"][0], undropped.numpy())


def make_tree_block(batch=6, fanout=3, hops=2, seed=0):
    """A random tree block in the device-sampler layout (as
    tests/test_tree_ell.py builds it): some child slots empty, pad rows at
    the tail."""
    rng = np.random.default_rng(seed)
    total = sum(batch * fanout ** h for h in range(hops + 1))
    block = total + 5
    nbr = np.full((block, fanout), block, np.int32)
    base, size = 0, batch
    for _ in range(hops):
        child = base + size
        for r in range(size):
            for f in range(fanout):
                if rng.random() < 0.8:
                    nbr[base + r, f] = child + r * fanout + f
        base, size = child, size * fanout
    return nbr, block


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_tree_ell_matches_jax(p):
    """tree_ell (gather-only backward through the parent maps) against
    han_tpu's _tree_core with the same keep mask: outputs and gradients at
    atol 1e-5; the parent maps are equal to han_tpu's."""
    nbr, block = make_tree_block()
    pr, ps = ttree.tree_parent_maps(6, 3, 2, block)
    jpr, jps = jtree.tree_parent_maps(6, 3, 2, block)
    np.testing.assert_array_equal(pr, jpr)
    np.testing.assert_array_equal(ps, jps)
    k, d = 2, 4
    rng = np.random.default_rng(5)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    fts, ld, ls, w = f32(block, k, d), f32(block, k), f32(block, k), f32(block, k, d)
    keep = keep_mask(block, 3, k, p, seed=2) if p else None
    jkeep = jnp.asarray(keep if p else np.zeros((1, 1, 1), np.uint8))
    want = run_jax(lambda *x: jtree._tree_core(
        jnp.asarray(nbr), jnp.asarray(pr), jnp.asarray(ps), jkeep, *x, 0.2, p), fts, ld, ls, w)
    tkeep = torch.from_numpy(keep) if p else None
    got = run_torch(lambda f_, a, b: ttree._TreeEll.apply(
        f_.reshape(block, k * d), a, b, torch.from_numpy(nbr), torch.from_numpy(pr),
        torch.from_numpy(ps), tkeep, 0.2, p).view(block, k, d), fts, ld, ls, w)
    assert_all_close(got, want, atol=1e-5)
    if p:
        return
    # dispatch: a TreeEllGraph goes to tree attention whatever impl says
    tg = TTree(nbr=torch.from_numpy(nbr), deg=torch.from_numpy((nbr < block).sum(1).astype(np.int32)),
               n_nodes=block, n_edges=block * 3, parent_row=torch.from_numpy(pr),
               parent_slot=torch.from_numpy(ps))
    out = tatt.attention_aggregate(tg, *(torch.from_numpy(x) for x in (fts, ld, ls)), impl="ell_fused")
    np.testing.assert_allclose(out.numpy(), want[0], atol=1e-5)


def test_ell_fused_wrapper_rejects_and_never_falls_back():
    """A non-CPU tensor goes to the kernel wrapper, which raises on what it
    cannot launch; it never runs the plain version."""
    n, f, k, d = 16, 4, 2, 8
    meta_dev = lambda *s, dt=torch.float32: torch.empty(*s, device="meta", dtype=dt)
    with pytest.raises(ValueError, match="CUDA"):
        tef.ell_fused_fwd(meta_dev(n, f, dt=torch.int32), meta_dev(n, k), meta_dev(n, k),
                          meta_dev(n, k * d), None, 0.2, 0.0)
    nbr, fts, ld, ls, _ = ell_case(n, f, k, d, seed=0)
    g = TEll(nbr=torch.from_numpy(nbr), deg=torch.zeros(n, dtype=torch.int32), n_nodes=n,
             n_edges=0)
    fts_t, ld_t, ls_t = (torch.from_numpy(x) for x in (fts, ld, ls))
    with pytest.raises(NotImplementedError, match="float32"):
        tef.ell_fused_attention(g, fts_t.double(), ld_t, ls_t)
    with pytest.raises(ValueError, match="generator"):
        tef.ell_fused_attention(g, fts_t, ld_t, ls_t, coef_dropout=0.5)
    with pytest.raises(NotImplementedError):
        tatt.attention_aggregate(g, fts_t, ld_t, ls_t, impl="ell_fused", return_coefs=True)
