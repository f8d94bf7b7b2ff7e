"""The tree attention's backward (ops/tree_ell.py) on device-sampler blocks:
``tree_ell_bwd_plain``, the parent-by-parent math that the card holds
``tree_ell_bwd_kernel`` to, against the backward through the parent maps
(gathers, as han_tpu's ``_tree_core`` takes it) and against autograd
through the plain forward; hops 1 and 2, dropout 0 and 0.6, invalid seeds,
rows with fewer valid slots than F, pad rows, f32 and bf16 features. The
CUDA wrappers raise off the card and never fall back."""

import contextlib

import numpy as np
import pytest
import torch

from han_tpu_torch.graph.containers import EllGraph, TreeEllGraph
from han_tpu_torch.ops import attention as tatt
from han_tpu_torch.ops import ell_fused as tef
from han_tpu_torch.ops import tree_ell as ttree
from han_tpu_torch.train import graphed
from han_tpu_torch.train.sampled import _device_sample_block, sample_key

BATCH, FANOUT, K, D, SLOPE = 6, 4, 2, 4, 0.2


def sampled_block(hops: int, seed: int = 0):
    """A device-sampler block (train/sampled._device_sample_block) over a
    random CSR of 40 nodes whose degrees run from 0 to 2F: seeds 1 and 4
    invalid, slots past a low degree empty, 5 pad rows at the tail. Returns
    (nbr int32 (N, F), parent_row, parent_slot int32 (N,))."""
    rng = np.random.default_rng(seed)
    n_nodes = 40
    deg = rng.integers(0, 2 * FANOUT + 1, n_nodes)
    deg[:3] = (0, 1, FANOUT - 1)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    col_idx = rng.integers(0, n_nodes, int(row_ptr[-1]) + 1).astype(np.int32)
    seeds = torch.tensor([0, 5, 1, 2, 7, 9], dtype=torch.int32)
    valid = torch.tensor([True, False, True, True, False, True])
    block = sum(BATCH * FANOUT ** h for h in range(hops + 1)) + 5
    nbr, _, _, _ = _device_sample_block(
        torch.from_numpy(row_ptr), torch.from_numpy(col_idx), seeds, valid,
        sample_key(seed + 11, 0), fanout=FANOUT, hops=hops, block_size=block)
    pr, ps = ttree.tree_parent_maps(BATCH, FANOUT, hops, block)
    return nbr, torch.from_numpy(pr), torch.from_numpy(ps)


def inputs(n: int, p: float, dtype, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen)
    fts, ld, ls, g = rnd(n, K * D).to(dtype), rnd(n, K), rnd(n, K), rnd(n, K * D).to(dtype)
    keep = tef.draw_keep(n, FANOUT, K, p, gen, "cpu") if p else None
    return fts, ld, ls, g, keep


def bwd_through_parent_maps(nbr, pr, ps, ld, ls, fts, keep, g, slope, p):
    """The backward as han_tpu's ``_tree_core`` takes it: each row gathers
    its dls and dv from its parent's slot through the parent maps."""
    n, k = ld.shape
    dz, c_agg, _ = tef.ell_dz(nbr, ld, ls, fts, keep, g, slope, p)
    has = (pr < n)[:, None]
    prl = torch.where(has[:, 0], pr, 0).long()
    psl = ps.long()
    dls = torch.where(has, dz[prl, psl], 0.0)
    c_sel = torch.where(has, c_agg[prl, psl], 0.0)
    dv = (c_sel[:, :, None] * g.view(n, k, -1)[prl]).reshape(n, -1)
    return dv.to(fts.dtype), dz.sum(dim=1), dls


def held_rows(nbr) -> torch.Tensor:
    """bool (N,): rows a valid slot holds."""
    n = nbr.shape[0]
    held = torch.zeros(n, dtype=torch.bool)
    held[nbr[nbr < n].long()] = True
    return held


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [0.0, 0.6])
@pytest.mark.parametrize("hops", [1, 2])
def test_tree_ell_bwd_plain(hops, p, dtype):
    """The parent-by-parent backward equals the gathers through the parent
    maps exactly and autograd through the plain forward within round-off;
    dv, dls are exactly 0 on rows no valid slot holds, dld on rows with no
    valid slot."""
    nbr, pr, ps = sampled_block(hops)
    n = nbr.shape[0]
    valid = nbr < n
    # the block covers the cases: invalid seeds, short rows, pads, 2-hop parents
    assert not valid[1].any() and not valid[4].any()
    assert (valid.sum(1)[:BATCH] < FANOUT).any() and valid.all(1).any()
    assert not valid[-5:].any()
    assert (valid[BATCH:].any(1)).any() == (hops == 2)
    rows, slots = valid.nonzero(as_tuple=True)
    child = nbr[rows, slots].long()
    assert torch.equal(pr[child].long(), rows) and torch.equal(ps[child].long(), slots)

    fts, ld, ls, g, keep = inputs(n, p, dtype)
    dv, dld, dls = ttree.tree_ell_bwd_plain(nbr, ld, ls, fts, keep, g, SLOPE, p)
    assert dv.dtype == dtype and dld.dtype == dls.dtype == torch.float32
    want = bwd_through_parent_maps(nbr, pr, ps, ld, ls, fts, keep, g, SLOPE, p)
    for got, ref in zip((dv, dld, dls), want):
        assert torch.equal(got, ref)

    held = held_rows(nbr)
    assert (dv[~held] == 0).all() and (dls[~held] == 0).all()
    assert (dld[~valid.any(1)] == 0).all()
    assert (dv[held] != 0).any() and (dls[held] != 0).any()

    # autograd through the plain forward (features as the forward reads them)
    fa = fts.clone().requires_grad_()
    la, sa = ld.clone().requires_grad_(), ls.clone().requires_grad_()
    out = tef.ell_fused_fwd_plain(nbr, la, sa, fa, keep, SLOPE, p)
    torch.autograd.backward(out, g)
    tol = dict(atol=1e-5, rtol=1e-4)
    dv_tol = dict(atol=1e-5, rtol=2.0 ** -7) if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(dv.float(), fa.grad.float(), **dv_tol)
    torch.testing.assert_close(dld, la.grad, **tol)
    torch.testing.assert_close(dls, sa.grad, **tol)


@pytest.mark.parametrize("p", [0.0, 0.6])
def test_tree_attention_cpu_path(p):
    """attention_aggregate on a TreeEllGraph runs the plain forward and the
    plain backward on the CPU: the same output and gradients as ell_fused
    on the same block and keep mask, and no kernel launch counted."""
    nbr, pr, ps = sampled_block(2, seed=1)
    n = nbr.shape[0]
    tg = TreeEllGraph(nbr=nbr, deg=(nbr < n).sum(1).int(), n_nodes=n, n_edges=n * FANOUT,
                      parent_row=pr, parent_slot=ps)
    fts, ld, ls, g, _ = inputs(n, 0.0, torch.float32, seed=4)
    launches = tef.ell_fused_launches, ttree.tree_ell_bwd_launches
    calls = ttree.tree_ell_calls
    grads = {}
    ell = EllGraph(nbr=nbr, deg=tg.deg, n_nodes=n, n_edges=tg.n_edges)
    for impl, graph in (("tree", tg), ("ell_fused", ell)):
        args = [t.clone().requires_grad_() for t in (fts.view(n, K, D), ld, ls)]
        gen = torch.Generator().manual_seed(7) if p else None
        out = tatt.attention_aggregate(graph, *args, impl="ell_fused", coef_dropout=p,
                                       generator=gen)
        torch.autograd.backward(out, g.view(n, K, D))
        grads[impl] = [out.detach()] + [a.grad for a in args]
    for a, b in zip(grads["tree"], grads["ell_fused"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    assert ttree.tree_ell_calls == calls + 1
    assert (tef.ell_fused_launches, ttree.tree_ell_bwd_launches) == launches


def test_tree_ell_bwd_wrapper_rejects_and_never_falls_back():
    """A tensor off the CPU goes to the kernel wrapper, which raises on what
    it cannot launch; it never runs the plain version."""
    n, f, k, d = 8, 2, 2, 4
    meta = lambda *s, dt=torch.float32: torch.empty(*s, device="meta", dtype=dt)
    i32 = lambda *s: meta(*s, dt=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ttree.tree_ell_bwd(i32(n, f), i32(n), i32(n), meta(n, k), meta(n, k), meta(n, k * d),
                           None, meta(n, k * d), 0.2, 0.0)


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph (a replay launches nothing)."""

    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


def test_tree_kernel_counters_replay(monkeypatch):
    """A captured step of P tree attention calls with their backward: the
    capture counts nothing, and every replay adds P forward launches
    (counted as ell_fused's), P backward launches and P calls, as the
    kernels ran. The CUDA wrappers' counting is stood in for on the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, capture_error_mode: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    for mod, name in ((tef, "ell_fused_launches"), (ttree, "tree_ell_calls"),
                      (ttree, "tree_ell_bwd_launches")):
        monkeypatch.setattr(mod, name, 0)

    def counted(fn, mod, name):
        def run(*a):
            setattr(mod, name, getattr(mod, name) + 1)
            return fn(*a)
        return run

    monkeypatch.setattr(ttree, "ell_fused_fwd",
                        counted(tef.ell_fused_fwd_plain, tef, "ell_fused_launches"))
    monkeypatch.setattr(ttree, "tree_ell_bwd", counted(
        lambda nbr, pr, ps, *a: ttree.tree_ell_bwd_plain(nbr, *a), ttree,
        "tree_ell_bwd_launches"))
    nbr, pr, ps = sampled_block(1)
    n = nbr.shape[0]
    tg = TreeEllGraph(nbr=nbr, deg=(nbr < n).sum(1).int(), n_nodes=n, n_edges=n * FANOUT,
                      parent_row=pr, parent_slot=ps)
    paths = 2

    def body(x):
        fts, ld, ls, _, _ = inputs(n, 0.0, torch.float32)
        w = x.clone().requires_grad_()
        loss = sum(tatt.attention_aggregate(tg, fts.view(n, K, D) * w, ld, ls).sum()
                   for _ in range(paths))
        loss.backward()
        return w.grad

    step = graphed.GraphedStep(body, capture=True, device=torch.device("cpu"))
    count = lambda: (tef.ell_fused_launches, ttree.tree_ell_bwd_launches, ttree.tree_ell_calls)
    step(torch.ones(()))  # eager
    assert count() == (paths, paths, paths)
    step(torch.ones(()))  # capture (counted once, then put back) and replay
    step(torch.ones(()))  # replay
    assert count() == (3 * paths, 3 * paths, 3 * paths)
