"""Host-side pieces of the redesigned flash kernels (csrc/flash_gat.cu) that
the CPU can check: the tile geometry and alignment the wrappers demand
(``graph/bcsr.py:tile_error``, ``check_layout``), the plain mirror of the
kernels' 3xTF32 split (``tf32_round``, ``split_tf32``, ``mm_3xtf32``) held
to f32 accuracy against float64 at the value ranges of the DBLP check and,
through the plain versions, far from one TF32 product (``mm_1xtf32``), and
the split of the dropout hash into a row half, a column half and a tail
that the kernels use, bit for bit the hash of ``dropout_keep``."""

import numpy as np
import pytest
import torch

from han_tpu_torch.graph.bcsr import bcsr_from_dense, pick_tiles, tile_error
from han_tpu_torch.ops import flash_gat as fg

M32 = 0xFFFFFFFF


@pytest.mark.parametrize("bm,bn", [(32, 32), (128, 128), (64, 256), (256, 96)])
def test_geometry_error_accepts_warp_multiples(bm, bn):
    assert tile_error(bm, bn) is None
    assert pick_tiles(1024, bm, bn)[:2] == (bm, bn)


@pytest.mark.parametrize("bm,bn,name", [(16, 128, "bm"), (128, 48, "bn"), (288, 128, "bm"),
                                        (128, 0, "bn")])
def test_geometry_error_names_the_constraint(bm, bn, name):
    err = tile_error(bm, bn)
    assert err is not None and err.startswith(name) and "multiple of 32" in err
    with pytest.raises(ValueError, match=f"^{name} = "):
        pick_tiles(1024, bm, bn)


def test_check_layout_wants_16_byte_aligned_data():
    """The kernels stage with 16-byte cp.async copies: a tensor whose data
    starts 4 bytes into an allocation is refused by name, fresh ones pass."""
    rng = np.random.default_rng(0)
    graph = bcsr_from_dense((rng.random((64, 64)) < 0.2).astype(np.float32), bm=32, bn=32)
    ld = torch.zeros(2, graph.n_pad)
    shifted = torch.zeros(2 * graph.n_pad + 1)[1:].view(2, graph.n_pad)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    fg.check_layout(graph, {"ld": ld, "ls": ld.clone()})
    with pytest.raises(ValueError, match="ls: the flash kernels need 16-byte aligned"):
        fg.check_layout(graph, {"ld": ld, "ls": shifted})


def test_tf32_round_is_cvt_rna():
    """Round to nearest, ties away from zero, to 10 mantissa bits."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 0.0, 2.0 ** -20])
    want = [1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 0.0, 2.0 ** -20]
    assert fg.tf32_round(x).tolist() == want


def dblp_operands(kind: str, n: int, seed: int) -> torch.Tensor:
    """float32 values as the kernels' products meet them in the DBLP check:
    softmax numerators p = exp2(z - m) in (0, 1], dropped coefficients
    c' = c / (1 - 0.6) up to 2.5, and features and gradients ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    if kind == "p":
        x = np.exp2(-np.abs(rng.standard_normal(n)) * 4)
    elif kind == "c'":
        x = rng.random(n) * 2.5
    else:
        x = rng.standard_normal(n)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["p", "c'", "v"])
def test_split_tf32_parts(kind):
    x = dblp_operands(kind, 100_000, seed=1)
    hi, lo = fg.split_tf32(x)
    low13 = lambda t: (t.view(torch.int32) & 0x1FFF)
    assert bool((low13(hi) == 0).all()) and bool((low13(lo) == 0).all())  # both TF32
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


@pytest.mark.parametrize("a_kind,b_kind", [("p", "v"), ("c'", "g"), ("v", "g")])
def test_3xtf32_products_keep_f32_accuracy(a_kind, b_kind):
    """hi·hi + hi·lo + lo·hi of the split, summed in float64, against the
    exact float64 product: within 2^-20 of each product, and over a tile's
    128-term sums within 2^-20 of the sum of magnitudes (f32 rounding of
    the same sum is 2^-24 a step). A bf16 operand has lo = 0."""
    a = dblp_operands(a_kind, 128 * 512, seed=2).view(512, 128)
    b = dblp_operands(b_kind, 128 * 512, seed=3).view(512, 128)
    (ah, al), (bh, bl) = fg.split_tf32(a), fg.split_tf32(b)
    d = lambda t: t.double()
    three = d(ah) * d(bh) + d(ah) * d(bl) + d(al) * d(bh)
    exact = d(a) * d(b)
    assert bool(((three - exact).abs() <= 2.0 ** -20 * exact.abs()).all())
    mag = exact.abs().sum(1)
    assert bool(((three.sum(1) - exact.sum(1)).abs() <= 2.0 ** -20 * mag).all())
    b16 = b.to(torch.bfloat16).float()
    assert bool((fg.split_tf32(b16)[1] == 0).all())


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _drop_half(h):
    return h ^ (h >> 16)


def _drop_tail(h):
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def test_split_dropout_hash_is_drop_bits():
    """The kernels hash a row half and a column half once each and only the
    tail per element: drop_tail(drop_half(row_key) ^ drop_half(col·golden))
    equals drop_bits(row_key, col) = fmix32(row_key ^ col·golden), so the
    masks stay those of dropout_keep."""
    rng = np.random.default_rng(7)
    seed, head, p = 123456789, 5, 0.6
    rows = rng.integers(0, 2 ** 20, 64)
    cols = rng.integers(0, 2 ** 20, 64)
    head_key = _fmix32(seed ^ _fmix32((head + 0x9E3779B9) & M32))
    keep = fg.dropout_keep(seed, torch.from_numpy(rows), torch.from_numpy(cols), head, p)
    thresh = fg.keep_threshold(p)
    for i, r in enumerate(rows.tolist()):
        row_key = _fmix32(head_key ^ r)
        for j, c in enumerate(cols.tolist()):
            col_mul = (c * 0x9E3779B9) & M32
            split = _drop_tail(_drop_half(row_key) ^ _drop_half(col_mul))
            assert split == _fmix32(row_key ^ col_mul)
            assert (split < thresh) == bool(keep[i, j])


@pytest.mark.parametrize("p", [0.0, 0.6])
def test_plain_products_3xtf32_against_1xtf32(p):
    """The plain forward and fused backward on float64 inputs, with their
    products taken by mm_3xtf32 (float32 results), stay within f32 rounding
    of the float64 plain versions, and at least chip_smoke.TF32_MARGIN = 10
    times closer than with mm_1xtf32 (the control chip_smoke.py runs
    against the kernels on the card)."""
    rng = np.random.default_rng(11)
    n, k, d = 256, 2, 8
    graph = bcsr_from_dense((rng.random((n, n)) < 0.4).astype(np.float32), bm=128, bn=128)
    gen = torch.Generator().manual_seed(12)
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    ld, ls, v, g = rnd(k, n), rnd(k, n), rnd(n, k * d), rnd(n, k * d)
    meta = fg.FlashMeta(dropout_p=p, seed=5)
    out, lse = fg.flash_fwd_plain(graph, ld, ls, v, meta)
    delta = fg.head_delta(g, out, k)
    args = (graph, ld, ls, v, g, lse, delta, meta)
    want = (out, *fg.flash_bwd_plain(*args))
    err = {}
    for name, mm in (("3x", fg.mm_3xtf32), ("1x", fg.mm_1xtf32)):
        got = (fg.flash_fwd_plain(graph, ld, ls, v, meta, mm=mm)[0], *fg.flash_bwd_plain(*args, mm=mm))
        err[name] = [float((a - b).abs().max()) for a, b in zip(got, want)]
    for e3, e1, w in zip(err["3x"], err["1x"], want):
        assert e3 <= 1e-6 * max(1.0, float(w.abs().max()))
        assert 10 * e3 <= e1


@pytest.mark.parametrize("p", [0.0, 0.6])
def test_plain_row_sweep_3xtf32_against_float64(p):
    """The row sweep's plain version with its g·v product taken by mm_3xtf32
    (the redesigned kernel's product), on float64 inputs, stays within f32
    rounding of the float64 row sweep and at least chip_smoke.TF32_MARGIN =
    10 times closer than with mm_1xtf32; the row sweep equals the fused
    backward's dld."""
    rng = np.random.default_rng(13)
    n, k, d = 256, 2, 16
    graph = bcsr_from_dense((rng.random((n, n)) < 0.4).astype(np.float32), bm=128, bn=128)
    gen = torch.Generator().manual_seed(14)
    rnd = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    ld, ls, v, g = rnd(k, n), rnd(k, n), rnd(n, k * d), rnd(n, k * d)
    meta = fg.FlashMeta(dropout_p=p, seed=6)
    out, lse = fg.flash_fwd_plain(graph, ld, ls, v, meta)
    delta = fg.head_delta(g, out, k)
    args = (graph, ld, ls, v, g, lse, delta, meta)
    want = fg.flash_bwd_row_plain(*args)
    np.testing.assert_allclose(want.numpy(), fg.flash_bwd_plain(*args)[0].numpy(), atol=1e-12)
    e3 = float((fg.flash_bwd_row_plain(*args, mm=fg.mm_3xtf32) - want).abs().max())
    e1 = float((fg.flash_bwd_row_plain(*args, mm=fg.mm_1xtf32) - want).abs().max())
    assert e3 <= 1e-6 * max(1.0, float(want.abs().max()))
    assert 10 * e3 <= e1
