"""Block-sparse flash-GAT attention: CUDA kernels, their plain PyTorch
versions, and the autograd wrapper (port of han_tpu/ops/pallas/flash_gat.py
:620-784).

One pass over the *occupied* adjacency tiles of a BCSRGraph computes, per
head, the SDDMM ``z_ij = leaky_relu(ld_i + ls_j)``, the masked softmax over
each row's edges and the aggregation ``out_i = sum_j softmax_j(z_ij) v_j``
without materializing the N×N coefficients; the backward recomputes the
coefficients from the saved log-sum-exp.

The kernels (csrc/flash_gat.cu, whose header says what bounds them on the
H100 and what their design does about it) replace
``han_tpu/ops/pallas/flash_gat.py``:

- ``han_flash_fwd`` ← ``_fwd_kernel`` (l.97, the rectangular grid) and
  ``_fwd_kernel_flat`` (l.187, the flat step list), with
  ``_fwd_tile_compute`` and ``_fwd_finalize``: one thread block per row
  block walks that block's occupied tiles;
- ``han_flash_bwd`` and ``han_flash_bwd_col`` ← ``_bwd_col_kernel`` (with
  ``_head_dz``), one CUDA kernel templated, like it, on ``fuse_dld``: the
  fused backward sums dld across column blocks with atomicAdd, the column
  sweep writes dls and dv only;
- ``han_flash_bwd_row`` ← ``_bwd_row_kernel`` (dld): with the column sweep,
  the split backward, which has no atomics;
- the ``drop_bits`` device function ← ``_tile_drop_keep``.

The forward and the column sweep (fused or not) sweep each tile without a
branch on the adjacency, in the register layout of the tensor cores'
``mma.sync.m16n8k8``: each warp takes a 16-row (forward) or 32-column
(backward) strip, the masks are selects, the forward's online softmax
takes each 32-column chunk's row max by quad shuffles in one pass, and the
D-wide products (P·V; g·v and C'·g) run as 3xTF32 products, which
:func:`split_tf32` and :func:`mm_3xtf32` mirror in plain torch (the plain
versions take their products through ``mm``, so ``chip_smoke.py`` can show
that the tolerances reject a single TF32 product, :func:`mm_1xtf32`).
The wide bodies take their products on ``wgmma`` instead: the forward's
(a head of 64 or 128 columns) forms p the same way against v split into
TF32 hi and lo once for both warpgroups of a block, taking each row's max
over its whole walk first so that it never rescales; the fused backward's
(a chunk of 64) forms g·v against the block's v held as registers and
takes c'ᵀg against g split and transposed once a window of 16 rows. The
row sweep is the forward's sweep with g·vᵀ, a 3xTF32 product, in place
of P·V, and sums dld per row in registers. Tiles stage through shared
memory by ``cp.async``, double-buffered. :func:`check_layout` raises on a
tile geometry the kernels do not take (graph/bcsr.py:tile_error) and on
arrays that are not 16-byte aligned.

The kernels are instantiated at D ∈ ``KERNEL_HEAD_DIMS``, the forward
also at ``WIDE_HEAD_DIMS`` and the fused backward at ``BWD_WIDE_DIMS``,
their wide bodies; the CUDA wrappers take any D (:func:`head_plan`). Up to
the largest instantiation they zero-pad v's and g's head dim to the next
instantiated one and slice out and dv back: zero columns of v change
neither the logits nor the softmax, and zero columns of g add nothing to
g·v or to delta. A wider head runs, on 128 × 128 tiles
(:func:`takes_wide`), through the forward's wide body (one sweep of each
tile a head, or half a head above 128) and the fused backward's (one a
chunk of 64), and everywhere else (the split backward, other tiles) as nc
chunks of an instantiated dc (``HEAD_CHUNK``); each head is zero-padded
to nc·dc, chunk c of head h on the kernels' grid beside the heads
(:func:`fwd_chunked`, :func:`bwd_chunked`).
The softmax does not depend on v, so a chunk's forward is the dc-wide one
on its columns (lse written once); dz is linear in g·v and delta, so with
delta split over the chunks (the head's in chunk 0, zero in the others)
each chunk's backward is the dc-wide one on its columns, writing its
columns of dv and its partial dld and dls, which are summed in chunk order
(:func:`sum_chunks`). Every backward, kernel or plain version, takes delta
in one layout, ([P,] nc, K, n) partial sums that add up to the head's;
:func:`head_delta` gives the head's whole g·out as one, ([P,] 1, K, n),
the plain versions add them, and each launch splits it over its own
chunks (:func:`bwd_chunked`), so that :func:`head_plan` alone knows the
widths. The ``*_chunked_plain`` functions run the decomposition over
the plain versions, which the CPU tests hold to the full-D plain versions
and to han_tpu; the card holds each kernel to the full-D plain version.

The row domain (``ld.shape[1]``) and the column domain (``ls.shape[1]``)
come from the tensors and may differ: a graph-axis shard passes its strip
of local rows against the global columns, a ring step one cell
(parallel/flash_shard.py, parallel/ring_bcsr.py); the maps are checked
against them.

:func:`flash_bwd` takes the fused kernel, or, when
``torch.are_deterministic_algorithms_enabled()``, the row sweep then the
column sweep: each output element is summed by one thread block in a fixed
order, so the split backward is bitwise reproducible. It is han_tpu's
fallback pair; han_tpu picks it when its resident dld window passes 12 MB
of VMEM, a v5e limit that is not carried over.

Coefficient dropout is keyed per element on (seed, global row, global
column, global head) through a murmur3-finalizer hash that exists twice:
in the kernels and in :func:`dropout_keep` (plain torch on int64). So a
kernel and its plain version apply bit-identical masks, the backward
replays the forward's mask, and the mask does not depend on tile size.
It cannot reproduce the TPU's masks (drawn from the pltpu PRNG per
(row block, 512-wide strip, head)). The seed is a one-element int32 tensor
(:func:`draw_seed` draws it on the features' device with the run's
generator; :func:`seed_tensor` makes one from an int) that the kernels
read from device memory, so a step captured as a CUDA graph draws a new
seed, and so a new mask, at every replay (train/graphed.py).

``v`` may be bfloat16 (bf16 features, ``V_DTYPES``): the kernels widen it
to f32 after each load and compute everything else in f32, and the
backward's dv is cast back to v's type outside them, as han_tpu does
(flash_gat.py:749-758, 701).

Every wrapper uses the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; there is no fallback.
``flash_fwd_launches``, ``flash_bwd_launches``, ``flash_bwd_row_launches``
and ``flash_bwd_col_launches`` count kernel launches, and
``flash_fwd_wide_launches`` and ``flash_bwd_wide_launches`` those of the
wide bodies.

Every function also takes a stack of P graphs of one geometry
(graph/stack.py: a leading P axis on the graph's arrays and on ld, ls, v,
g, lse and delta; P seeds), HAN's meta-path towers: han_tpu vmaps the
towers, and a vmapped ``pallas_call`` is one call whose grid gains the P
axis. Here each kernel takes the path on its grid's third axis, so a stack
is ONE launch (counted once), and path p computes what a call on graph p
alone with seed p computes. The plain versions loop over the paths.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from han_tpu_torch.graph.bcsr import BCSRGraph, tile_error
from han_tpu_torch.graph.containers import MASK_VALUE

flash_fwd_launches = 0
flash_fwd_wide_launches = 0  # of flash_fwd_launches, those of the wide body
flash_bwd_launches = 0
flash_bwd_wide_launches = 0  # of flash_bwd_launches, those of the wide body
flash_bwd_row_launches = 0
flash_bwd_col_launches = 0

KERNEL_HEAD_DIMS = (4, 8, 16, 32)  # the D instantiated in csrc/flash_gat.cu
WIDE_HEAD_DIMS = (64, 128)  # the forward's wide body, on 128 x 128 tiles (takes_wide)
BWD_WIDE_DIMS = (64,)  # the fused backward's wide body, likewise
WIDE_TILE = 128  # the wide bodies' tile rows and columns: two warpgroups of 64
V_DTYPES = (torch.float32, torch.bfloat16)  # v's types; all else is float32

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


@dataclasses.dataclass(frozen=True)
class FlashMeta:
    """Scalar arguments of both kernels: the slope, the dropout rate, and
    han_tpu's int32 meta[4] (seed, row-block, head and column-block
    offsets). The offsets globalize the dropout keys for sharded runs and
    are 0 on one device. ``seed`` is an int32 tensor of one element a path
    (its uint32 bits are the key), which the kernels read from device
    memory; the plain versions also take an int. ``row_block_offset`` may
    also be an int32 tensor of one offset a path (the strips of a stacked
    partition), which the kernels read from device memory."""

    slope: float = 0.2
    dropout_p: float = 0.0
    seed: torch.Tensor | int = 0
    row_block_offset: int | torch.Tensor = 0
    head_offset: int = 0
    col_block_offset: int = 0


def path_meta(meta: FlashMeta, p: int) -> FlashMeta:
    """Path p's meta of a stack's: its seed and row-block offset."""
    seed = meta.seed[p:p + 1] if isinstance(meta.seed, torch.Tensor) else meta.seed
    off = meta.row_block_offset
    return dataclasses.replace(
        meta, seed=seed, row_block_offset=int(off[p]) if isinstance(off, torch.Tensor) else off)


# ---------------------------------------------------------------------------
# dropout hash (plain-torch copy of csrc/flash_gat.cu:fmix32 / drop_bits)
# ---------------------------------------------------------------------------


def mul32(x, c: int):
    """(x * c) mod 2**32 for 0 <= x < 2**32, with no int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def fmix32(h):
    """The murmur3 finalizer on uint32 values held in int64 (tensors or
    ints)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_threshold(p: float) -> int:
    """A coefficient is kept iff its 32 hash bits are below this."""
    return min(int((1.0 - p) * 2 ** 32), _M32)


def seed_tensor(seed: int, device) -> torch.Tensor:
    """A one-element int32 tensor on ``device`` whose uint32 bits are
    ``seed mod 2**32``: the kernels' dropout seed as an int gives it."""
    u = seed & _M32
    return torch.tensor([u - (1 << 32) if u >> 31 else u], dtype=torch.int32, device=device)


def _seed_bits(seed: torch.Tensor | int):
    """The seed's uint32 value in int64: a 0-d tensor on the seed's device
    (no sync), or an int."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(torch.int64) & _M32
    return seed & _M32


def dropout_keep(seed: torch.Tensor | int, rows: torch.Tensor, cols: torch.Tensor,
                 head: int, p: float) -> torch.Tensor:
    """bool[len(rows), len(cols)]: the kept coefficients of global head
    ``head`` at global rows × columns, bit-identical to the kernels'.
    ``seed`` is an int or a one-element int32 tensor on the rows' device."""
    head_key = fmix32(_seed_bits(seed) ^ fmix32((head + _GOLDEN) & _M32))
    row_key = fmix32(head_key ^ rows.to(torch.int64))
    bits = fmix32(row_key[:, None] ^ mul32(cols.to(torch.int64), _GOLDEN)[None, :])
    return bits < keep_threshold(p)


def _keep_scale(meta: FlashMeta, graph: BCSRGraph, n_rows: int, n_cols: int,
                h: int, device) -> torch.Tensor:
    """f32 (n_rows, n_cols): 1/(1-p) where kept, 0 where dropped."""
    rows = meta.row_block_offset * graph.bm + torch.arange(n_rows, device=device)
    cols = meta.col_block_offset * graph.bn + torch.arange(n_cols, device=device)
    keep = dropout_keep(meta.seed, rows, cols, meta.head_offset + h, meta.dropout_p)
    scale = torch.tensor(1.0 / (1.0 - meta.dropout_p), dtype=torch.float32)
    return torch.where(keep, scale.to(device), 0.0)


# ---------------------------------------------------------------------------
# 3xTF32 products (plain-torch copy of csrc/flash_gat.cu:split_tf32)
# ---------------------------------------------------------------------------

_TF32_MASK = -0x2000  # int32 0xffffe000: sign, exponent and 10 mantissa bits


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 truncated to TF32 (its low 13 bits cleared): what the tensor
    cores read of a float32 operand."""
    return (x.to(torch.float32).view(torch.int32) & _TF32_MASK).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """finite float32 rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: the low 13 bits are 0."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & _TF32_MASK).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as the kernels' 3xTF32 products see them: hi is x rounded to
    TF32, lo is x − hi (exact) as the tensor cores read it, truncated to
    TF32. x = hi + lo to within 2^-21 |x|, and hi·hi + hi·lo + lo·hi is
    within about 2^-20 |a·b| of a product a·b (a bf16 operand is TF32
    already and has lo = 0)."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x.to(torch.float32) - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take their products: hi·hi + (hi·lo + lo·hi)
    of :func:`split_tf32`, each partial product exact in float32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return ah @ bh + (ah @ bl + al @ bh)


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 (one TF32 product, as the
    tensor cores take it without a split): the control that shows the
    card's tolerances tell :func:`mm_3xtf32` from a plain TF32 product."""
    return tf32_round(a) @ tf32_round(b)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference the card checks against)
# ---------------------------------------------------------------------------


def tile_adjacency(graph: BCSRGraph) -> torch.Tensor:
    """bool (nb_r·bm, nb_c·bn): the occupied tiles expanded to a dense mask
    (nb_r and nb_c from the maps, so a strip or a ring cell gives its own
    rectangle)."""
    dev = graph.tiles.device
    valid = (torch.arange(graph.c_max, device=dev)[None, :]
             < graph.fwd_count.long()[:, None])
    rb = torch.arange(graph.nb_r, device=dev)[:, None].expand_as(valid)[valid]
    cb = graph.fwd_col.long()[valid]
    tid = graph.fwd_tile.long()[valid]
    blocks = torch.zeros((graph.nb_r, graph.nb_c, graph.bm, graph.bn),
                         dtype=torch.bool, device=dev)
    blocks[rb, cb] = graph.tiles[tid] != 0
    return blocks.permute(0, 2, 1, 3).reshape(graph.nb_r * graph.bm,
                                              graph.nb_c * graph.bn)


def _lrelu(raw: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(raw >= 0, raw, slope * raw)


def flash_fwd_plain(graph: BCSRGraph, ld: torch.Tensor, ls: torch.Tensor,
                    v: torch.Tensor, meta: FlashMeta, mm=torch.matmul):
    """ld (K, n_rows), ls (K, n_cols), v (n_cols, K·D) → out (n_rows, K·D),
    lse (K, n_rows). Differentiable by autograd; one head at a time so the
    dense (n_rows, n_cols) temporaries stay one head wide. ``mm`` takes the
    product P·V (:func:`mm_3xtf32`, :func:`mm_1xtf32`: how the kernels'
    products compare)."""
    if ld.dim() == 3:  # a stack: path by path
        res = [flash_fwd_plain(graph.path(p), ld[p], ls[p], v[p], path_meta(meta, p), mm)
               for p in range(ld.shape[0])]
        return torch.stack([o for o, _ in res]), torch.stack([x for _, x in res])
    k, n_rows = ld.shape
    n_cols = ls.shape[1]
    d = v.shape[1] // k
    v = v.to(ld.dtype)  # a bf16 v widened, as the kernels do after each load
    adj = tile_adjacency(graph)
    outs, lses = [], []
    for h in range(k):
        z = torch.where(adj, _lrelu(ld[h][:, None] + ls[h][None, :], meta.slope),
                        MASK_VALUE)
        m = z.amax(dim=1).detach()  # a shift: softmax is invariant to it
        has_edge = m > 0.5 * MASK_VALUE
        p = torch.where(adj, torch.exp(z - m[:, None]), 0.0)
        l = p.sum(dim=1).clamp_min(1e-30)
        if meta.dropout_p > 0.0:  # l keeps the undropped p (reference order)
            p = p * _keep_scale(meta, graph, n_rows, n_cols, h, ld.device)
        acc = mm(p, v[:, h * d:(h + 1) * d])
        outs.append(torch.where(has_edge[:, None], acc / l[:, None], 0.0))
        lses.append(torch.where(has_edge, m + torch.log(l), MASK_VALUE))
    return torch.cat(outs, dim=1), torch.stack(lses)


def _bwd_terms(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta, mm):
    """Per head h, the dense (n_rows, n_cols) terms of han_tpu's ``_head_dz``:
    with c = on_edge·exp(z − lse) and c' = c·keep, yields (h, dzs, c', g_h)
    where dzs = (c'·(g·v) − c·delta)·lrelu′, g·v taken by ``mm``; delta is
    :func:`head_delta`'s (nc, K, n), whose chunks add up to the head's."""
    k, n_rows = ld.shape
    n_cols = ls.shape[1]
    d = v.shape[1] // k
    v = v.to(ld.dtype)
    delta = sum_chunks(delta)
    adj = tile_adjacency(graph)
    for h in range(k):
        raw = ld[h][:, None] + ls[h][None, :]
        # off-edge exp may overflow to +inf (edgeless rows have lse = -1e9);
        # the select, not a multiply, zeroes it
        c = torch.where(adj, torch.exp(_lrelu(raw, meta.slope) - lse[h][:, None]), 0.0)
        c_agg = c
        if meta.dropout_p > 0.0:
            c_agg = c * _keep_scale(meta, graph, n_rows, n_cols, h, ld.device)
        g_h = g[:, h * d:(h + 1) * d]
        dz = c_agg * mm(g_h, v[:, h * d:(h + 1) * d].T) - c * delta[h][:, None]
        yield h, torch.where(raw >= 0, dz, meta.slope * dz), c_agg, g_h


def _per_path(fn, graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta, *extra):
    """A backward plain version on a stack, path by path; its outputs
    stacked."""
    res = [fn(graph.path(p), ld[p], ls[p], v[p], g[p], lse[p], delta[p], path_meta(meta, p),
              *extra) for p in range(ld.shape[0])]
    if isinstance(res[0], tuple):
        return tuple(torch.stack(x) for x in zip(*res))
    return torch.stack(res)


def flash_bwd_plain(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta,
                    mm=torch.matmul):
    """The fused backward on dense tensors: dld = Σ_j dz, dls = Σ_i dz,
    dv = c'ᵀ g (see :func:`_bwd_terms`; ``mm`` takes g·v and c'ᵀ g, as in
    :func:`flash_fwd_plain`). delta is :func:`head_delta`'s, (nc, K,
    n_rows), as every backward takes it. Returns dld (K, n_rows), dls (K,
    n_cols), dv (n_cols, K·D)."""
    if ld.dim() == 3:
        return _per_path(flash_bwd_plain, graph, ld, ls, v, g, lse, delta, meta, mm)
    dld, dls, dv = [], [], []
    for _, dzs, c_agg, g_h in _bwd_terms(graph, ld, ls, v, g, lse, delta, meta, mm):
        dld.append(dzs.sum(dim=1))
        dls.append(dzs.sum(dim=0))
        dv.append(mm(c_agg.T, g_h))
    return torch.stack(dld), torch.stack(dls), torch.cat(dv, dim=1)


def flash_bwd_row_plain(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta,
                        mm=torch.matmul):
    """The row sweep: dld (K, n_rows) only (``mm`` takes g·v, as in
    :func:`flash_bwd_plain`)."""
    if ld.dim() == 3:
        return _per_path(flash_bwd_row_plain, graph, ld, ls, v, g, lse, delta, meta, mm)
    return torch.stack([dzs.sum(dim=1) for _, dzs, _, _ in
                        _bwd_terms(graph, ld, ls, v, g, lse, delta, meta, mm)])


def flash_bwd_col_plain(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    """The column sweep: dls (K, n_cols) and dv (n_cols, K·D) only."""
    if ld.dim() == 3:
        return _per_path(flash_bwd_col_plain, graph, ld, ls, v, g, lse, delta, meta)
    dls, dv = [], []
    for _, dzs, c_agg, g_h in _bwd_terms(graph, ld, ls, v, g, lse, delta, meta, torch.matmul):
        dls.append(dzs.sum(dim=0))
        dv.append(c_agg.T @ g_h)
    return torch.stack(dls), torch.cat(dv, dim=1)


# ---------------------------------------------------------------------------
# head dims: D up to the largest instantiation by zero padding, a larger D
# as chunks of an instantiated one on the kernels' grid
# ---------------------------------------------------------------------------

# the instantiated head dim a chunk of a head wider than KERNEL_HEAD_DIMS[-1]
# runs at in the split backward, and in the forward and the fused backward
# where the wide bodies do not take the tiles. scripts/flash_chunk_width_torch.py
# times the split backward's sweeps in chunks of 16 against 32 at D = 64: on
# an NVIDIA H100 80GB HBM3 at a 700 W limit the row sweep ran 1.23-1.41x
# slower in chunks of 16, the column sweep 0.92-0.99x (PERF.md §6).
HEAD_CHUNK = 32


def head_plan(d: int, wide: tuple = ()) -> tuple[int, int]:
    """(dc, nc): the kernels run a head of D columns as nc chunks of an
    instantiated dc. D up to the largest of ``KERNEL_HEAD_DIMS`` is one
    chunk of the smallest dc that holds it. A wider D is, with ``wide`` the
    widths of a wide body (``WIDE_HEAD_DIMS``, the forward's;
    ``BWD_WIDE_DIMS``, the fused backward's; on tiles it takes,
    :func:`takes_wide`), one chunk of the smallest that holds it, or
    ⌈D / w⌉ chunks of the largest, w (the forward's 128: two accumulators
    of 64 rows × 256 would not fit a thread's registers, so a block owns
    half of a head of 256; the backward's 64: v as registers and dv's two
    accumulators); else ⌈D / 32⌉ chunks of ``HEAD_CHUNK``. The head is
    zero-padded to nc·dc either way."""
    if d <= KERNEL_HEAD_DIMS[-1]:
        return next(dp for dp in KERNEL_HEAD_DIMS if d <= dp), 1
    if wide and d <= wide[-1]:
        return next(dp for dp in wide if d <= dp), 1
    if wide:
        return wide[-1], -(-d // wide[-1])
    return HEAD_CHUNK, -(-d // HEAD_CHUNK)


def takes_wide(graph: BCSRGraph) -> bool:
    """Whether the wide bodies take this graph's tiles: 128 × 128
    (``WIDE_TILE``; two warpgroups of 64 rows or columns a block, eight
    windows of 16 a tile); a head wider than 32 on other tiles runs in
    chunks of 32."""
    return graph.bm == graph.bn == WIDE_TILE


def padded_head_dim(d: int) -> int:
    """The width nc·dc of :func:`head_plan` that a head of D is padded to."""
    dc, nc = head_plan(d)
    return dc * nc


def pad_heads(x: torch.Tensor, k: int, dp: int) -> torch.Tensor:
    """([P,] rows, K·D) → ([P,] rows, K·dp), each head's D columns
    zero-padded to dp; contiguous (F.pad that pads nothing returns a
    view)."""
    lead = x.shape[:-1]
    d = x.shape[-1] // k
    return F.pad(x.view(*lead, k, d), (0, dp - d)).reshape(*lead, k * dp).contiguous()


def unpad_heads(x: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """([P,] rows, K·dp) → ([P,] rows, K·D): the first D columns of each
    head."""
    lead = x.shape[:-1]
    return x.view(*lead, k, -1)[..., :d].reshape(*lead, k * d).contiguous()


def head_delta(g: torch.Tensor, out: torch.Tensor, k: int) -> torch.Tensor:
    """The backward's delta from g and out (([P,] n, K·D) each), formed in
    torch before the launch as han_tpu forms it (_flash_core_flat_bwd): g_i
    · out_i summed over each head's D columns, in the layout every backward
    takes, ([P,] 1, K, n); each launch splits it over its chunks
    (:func:`bwd_chunked`)."""
    lead, n = g.shape[:-2], g.shape[-2]
    delta = (g * out).view(*lead, n, k, -1).sum(-1)
    return delta.movedim(-1, -2).unsqueeze(-3).contiguous()


def sum_chunks(x: torch.Tensor) -> torch.Tensor:
    """([P,] nc, K, n) → ([P,] K, n): the chunks' partial sums added in
    chunk order, so that a sum repeats bitwise."""
    acc = x[..., 0, :, :]
    for c in range(1, x.shape[-3]):
        acc = acc + x[..., c, :, :]
    return acc


def fwd_chunked(launch, graph: BCSRGraph, ld, ls, v, meta: FlashMeta, wide: bool | None = None):
    """The forward as the kernel computes it: each head of v zero-padded to
    nc·dc (:func:`head_plan`; ``wide`` defaults to :func:`takes_wide`, and
    False runs a wide head in chunks of 32, as other tiles do),
    ``launch(graph, ld, ls, v_padded, meta, nc)`` (the kernel, or
    :func:`_fwd_chunks_plain`), out sliced back. Zero columns of v change
    neither the logits nor the softmax, and lse does not depend on v."""
    k = ld.shape[-2]
    d = v.shape[-1] // k
    wide = takes_wide(graph) if wide is None else wide
    dc, nc = head_plan(d, WIDE_HEAD_DIMS if wide else ())
    if dc * nc == d:
        return launch(graph, ld, ls, v, meta, nc)
    out, lse = launch(graph, ld, ls, pad_heads(v, k, dc * nc), meta, nc)
    return unpad_heads(out, k, d), lse


def split_delta(delta: torch.Tensor, nc: int) -> torch.Tensor:
    """:func:`head_delta`'s ([P,] 1, K, n) as the nc chunks a launch takes:
    the head's delta in chunk 0, zero in the others. dz is linear in
    delta, so the chunks' partial dld and dls still add up to the
    head's."""
    return F.pad(delta, (0, 0, 0, 0, 0, nc - 1)) if nc > 1 else delta


def bwd_chunked(launch, graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta,
                wide: bool = False):
    """A backward as the kernels compute it: v and g padded as in
    :func:`fwd_chunked` (with ``wide``, the fused backward's wide body:
    chunks of 64, ``BWD_WIDE_DIMS``), delta split over the chunks
    (:func:`split_delta`), ``launch(..., nc)`` (a kernel, or a chunk loop
    over a plain version) giving the chunks' partial dld and dls ([P,] nc,
    K, n) and dv at the padded width; the partials summed in chunk order
    (:func:`sum_chunks`), dv sliced back. Zero columns of g add nothing to
    g·v. Returns dld alone, or a tuple ending in dv, as the plain version
    does."""
    k = ld.shape[-2]
    d = v.shape[-1] // k
    dc, nc = head_plan(d, BWD_WIDE_DIMS if wide else ())
    delta = split_delta(delta, nc)
    if dc * nc != d:
        v, g = pad_heads(v, k, dc * nc), pad_heads(g, k, dc * nc)
    res = launch(graph, ld, ls, v, g, lse, delta, meta, nc)
    if not isinstance(res, tuple):
        return sum_chunks(res)
    *parts, dv = res
    return (*map(sum_chunks, parts), dv if dc * nc == d else unpad_heads(dv, k, d))


def _head_chunk(x: torch.Tensor, k: int, nc: int, c: int) -> torch.Tensor:
    """([P,] rows, K·nc·dc) → chunk c of every head, ([P,] rows, K·dc)."""
    return x.unflatten(-1, (k, nc, -1))[..., c, :].flatten(-2).contiguous()


def _join_chunks(xs, k: int) -> torch.Tensor:
    """The chunks' ([P,] rows, K·dc) → ([P,] rows, K·nc·dc), chunk c of head
    h at columns (h·nc + c)·dc."""
    return torch.stack([x.unflatten(-1, (k, -1)) for x in xs], dim=-2).flatten(-3)


def _fwd_chunks_plain(graph: BCSRGraph, ld, ls, v, meta: FlashMeta, nc: int):
    """What the forward kernel computes on chunked v: the plain forward on
    each chunk's columns, lse from chunk 0."""
    if nc == 1:
        return flash_fwd_plain(graph, ld, ls, v, meta)
    k = ld.shape[-2]
    res = [flash_fwd_plain(graph, ld, ls, _head_chunk(v, k, nc, c), meta) for c in range(nc)]
    return _join_chunks([o for o, _ in res], k), res[0][1]


def _bwd_chunks_plain(plain):
    """What a backward kernel computes on chunked v and g: ``plain`` (a
    backward plain version) on each chunk's columns with that chunk's share
    of delta (a delta of one chunk); the partial sums stacked on a chunk
    axis, dv joined."""
    def launch(graph: BCSRGraph, ld, ls, v, g, lse, deltas, meta: FlashMeta, nc: int):
        k = ld.shape[-2]
        res = [plain(graph, ld, ls, _head_chunk(v, k, nc, c), _head_chunk(g, k, nc, c), lse,
                     deltas[..., c:c + 1, :, :], meta) for c in range(nc)]
        if not isinstance(res[0], tuple):
            return torch.stack(res, dim=-3)
        *parts, dvs = zip(*res)
        return (*(torch.stack(p, dim=-3) for p in parts), _join_chunks(dvs, k))
    return launch


def flash_fwd_chunked_plain(graph: BCSRGraph, ld, ls, v, meta: FlashMeta):
    """The forward kernel's chunk decomposition on the plain version: the
    padding, the chunks and lse of :func:`fwd_chunked` (the CPU tests hold
    it to the full-D plain version and to han_tpu)."""
    return fwd_chunked(_fwd_chunks_plain, graph, ld, ls, v, meta)


def flash_bwd_chunked_plain(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    """The fused backward's chunk decomposition (:func:`bwd_chunked`: its
    wide body's chunks of 64 where :func:`takes_wide`) on
    :func:`flash_bwd_plain`."""
    return bwd_chunked(_bwd_chunks_plain(flash_bwd_plain), graph, ld, ls, v, g, lse, delta,
                       meta, takes_wide(graph))


def flash_bwd_row_chunked_plain(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    """The row sweep's chunk decomposition on :func:`flash_bwd_row_plain`."""
    return bwd_chunked(_bwd_chunks_plain(flash_bwd_row_plain), graph, ld, ls, v, g, lse, delta,
                       meta)


def flash_bwd_col_chunked_plain(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    """The column sweep's chunk decomposition on :func:`flash_bwd_col_plain`."""
    return bwd_chunked(_bwd_chunks_plain(flash_bwd_col_plain), graph, ld, ls, v, g, lse, delta,
                       meta)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SCALARS = [_I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _U, _F, _I, _I, _I, _I, _I, _P, _P]
_ARGTYPES = {
    "han_flash_fwd": [_P, _P, _P, _P, _I] + [_P] * 5 + _SCALARS,
    "han_flash_bwd": [_P, _P, _P, _P, _I] + [_P] * 9 + _SCALARS,
    "han_flash_bwd_row": [_P, _P, _P, _P, _I] + [_P] * 7 + _SCALARS,
    "han_flash_bwd_col": [_P, _P, _P, _P, _I] + [_P] * 8 + _SCALARS,
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry points' signatures declared."""
    from han_tpu_torch.ops import _build

    lib = _build.load("flash_gat")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.han_error_string.argtypes = [ctypes.c_int]
    lib.han_error_string.restype = ctypes.c_char_p
    return lib


def _check(graph: BCSRGraph, maps: str, floats: dict, nc: int,
           dims: tuple = KERNEL_HEAD_DIMS) -> tuple[int, int, int, int, int]:
    """Raise on anything the kernels do not take; returns (k, d, n_rows,
    n_cols, n_paths), d the instantiated head dim of each of a head's nc
    chunks. The row domain is ``ld.shape[-1]`` and the column domain
    ``ls.shape[-1]``; both maps' block counts must match them. ``maps`` is
    "fwd" or "bwd", the map the kernel walks; ``floats`` maps each float
    argument's name to (tensor, expected shape as letters: K heads, R rows,
    C columns, N = nc chunks, F = K·nc·d flat features), each with a
    leading P axis when the graph is a stack of P. Every float argument is
    float32, except ``v``, which may be bfloat16. ``dims``: the chunk
    widths the kernel takes."""
    dev = floats["ld"][0].device
    if dev.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got {dev}")
    lead = () if graph.n_paths is None else (graph.n_paths,)
    if floats["ld"][0].dim() != 2 + len(lead):
        raise ValueError(f"ld: need {2 + len(lead)} dims for a graph of "
                         f"{graph.n_paths or 1} path(s), got {tuple(floats['ld'][0].shape)}")
    k, n_rows = floats["ld"][0].shape[-2:]
    n_cols = floats["ls"][0].shape[-1]
    d = floats["v"][0].shape[-1] // (k * nc)
    if d not in dims or floats["v"][0].shape[-1] != k * nc * d:
        raise NotImplementedError(
            f"head dim {floats['v'][0].shape[-1] // k} is not {nc} chunk(s) of a kernel "
            f"instantiation {dims}")
    if (n_rows != graph.nb_r * graph.bm or n_cols != graph.nb_c * graph.bn):
        raise ValueError(f"the graph's maps cover {graph.nb_r * graph.bm} rows x "
                         f"{graph.nb_c * graph.bn} columns, the tensors "
                         f"{n_rows} x {n_cols}")
    sizes = {"K": k, "F": k * nc * d, "R": n_rows, "C": n_cols, "N": nc}
    for name, (t, shape) in floats.items():
        want = lead + tuple(sizes[s] for s in shape)
        dtypes = V_DTYPES if name == "v" else (torch.float32,)
        if (t.device != dev or t.dtype not in dtypes or not t.is_contiguous()
                or tuple(t.shape) != want):
            raise ValueError(f"{name}: need a contiguous {' or '.join(map(str, dtypes))} "
                             f"{want} tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    for name, dt in [("tiles", torch.int8)] + [
            (f"{maps}_{m}", torch.int32) for m in ("count", "col" if maps == "fwd" else "row", "tile")]:
        t = getattr(graph, name)
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"graph.{name}: need a contiguous {dt} tensor on "
                             f"{dev} (BCSRGraph.to(device))")
    check_layout(graph, {n: t for n, (t, _) in floats.items()})
    return k, d, n_rows, n_cols, (lead or (1,))[0]


def check_layout(graph: BCSRGraph, tensors: dict) -> None:
    """Raise ValueError on a tile geometry the kernels do not take
    (graph/bcsr.py:tile_error) or on data that is not 16-byte aligned (the
    kernels stage tiles and slices with 16-byte cp.async copies): the
    device-independent part of ``_check``."""
    if tuple(graph.tiles.shape[-2:]) != (graph.bm, graph.bn):
        raise ValueError("graph.tiles must be ([P,] T, bm, bn)")
    err = tile_error(graph.bm, graph.bn)
    if err:
        raise ValueError(err)
    bad = [name for name, t in {"graph.tiles": graph.tiles, **tensors}.items()
           if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{', '.join(bad)}: the flash kernels need 16-byte aligned data")


def _path_ints(name: str, t, n_paths: int, device) -> int:
    """The device address of an int32 tensor of one value a path; raises
    unless it is one, contiguous, on ``device``."""
    if (not isinstance(t, torch.Tensor) or t.device != device or t.dtype != torch.int32
            or t.numel() != n_paths or not t.is_contiguous()):
        raise ValueError(f"meta.{name}: the kernels read it from device memory: need a "
                         f"contiguous int32 tensor of {n_paths} element(s) on {device} "
                         f"(draw_seed, seed_tensor), got {t!r}")
    return t.data_ptr()


def _seed_ptr(meta: FlashMeta, device, n_paths: int = 1) -> int | None:
    """The device address of the dropout seeds (one a path); None (a null
    pointer) when dropout is off. Raises unless the seed is an int32 tensor
    of ``n_paths`` elements on ``device``."""
    if meta.dropout_p <= 0.0:
        return None
    return _path_ints("seed", meta.seed, n_paths, device)


def _scalars(graph: BCSRGraph, v, n_rows, n_cols, k, d, nc, n_paths, meta: FlashMeta):
    drop = meta.dropout_p > 0.0
    rbo = meta.row_block_offset
    per_path = isinstance(rbo, torch.Tensor)
    return (n_rows, n_cols, graph.bm, graph.bn, k, d, nc, int(v.dtype == torch.bfloat16),
            meta.slope, int(drop),
            _seed_ptr(meta, v.device, n_paths),
            keep_threshold(meta.dropout_p) if drop else 0,
            1.0 / (1.0 - meta.dropout_p), 0 if per_path else rbo,
            meta.head_offset, meta.col_block_offset, n_paths, int(graph.tiles.shape[-3]),
            _path_ints("row_block_offset", rbo, n_paths, v.device) if per_path else None,
            torch.cuda.current_stream(v.device).cuda_stream)


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.han_error_string(rc).decode()})")


def _fwd_launch(graph: BCSRGraph, ld, ls, v, meta: FlashMeta, nc: int):
    global flash_fwd_launches, flash_fwd_wide_launches
    k, d, n_rows, n_cols, n_paths = _check(
        graph, "fwd", {"ld": (ld, "KR"), "ls": (ls, "KC"), "v": (v, "CF")}, nc,
        KERNEL_HEAD_DIMS + (WIDE_HEAD_DIMS if takes_wide(graph) else ()))
    lead = ld.shape[:-2]
    out = torch.empty((*lead, n_rows, k * nc * d), dtype=torch.float32, device=ld.device)
    lse = torch.empty((*lead, k, n_rows), dtype=torch.float32, device=ld.device)
    lib = _lib()
    rc = lib.han_flash_fwd(
        graph.tiles.data_ptr(), graph.fwd_count.data_ptr(),
        graph.fwd_col.data_ptr(), graph.fwd_tile.data_ptr(), graph.c_max,
        ld.data_ptr(), ls.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_scalars(graph, v, n_rows, n_cols, k, d, nc, n_paths, meta))
    _raise_on(rc, lib, "han_flash_fwd")
    flash_fwd_launches += 1
    flash_fwd_wide_launches += d in WIDE_HEAD_DIMS
    return out, lse


def _bwd_col_sweep(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta, nc: int,
                   fuse_dld: bool):
    """Launch the column-sweep kernel: han_flash_bwd (with the atomic dld)
    or han_flash_bwd_col (dls and dv only). Returns (dld or None, dls, dv),
    dld and dls the chunks' partial sums ([P,] nc, K, n)."""
    k, d, n_rows, n_cols, n_paths = _check(graph, "bwd", {
        "ld": (ld, "KR"), "ls": (ls, "KC"), "v": (v, "CF"), "g": (g, "RF"),
        "lse": (lse, "KR"), "delta": (delta, "NKR")}, nc,
        KERNEL_HEAD_DIMS + (BWD_WIDE_DIMS if fuse_dld and takes_wide(graph) else ()))
    lead = ld.shape[:-2]
    dld = (torch.zeros((*lead, nc, k, n_rows), dtype=torch.float32, device=ld.device)
           if fuse_dld else None)
    dls = torch.empty((*lead, nc, k, n_cols), dtype=torch.float32, device=ld.device)
    dv = torch.empty((*lead, n_cols, k * nc * d), dtype=torch.float32, device=ld.device)
    lib = _lib()
    name = "han_flash_bwd" if fuse_dld else "han_flash_bwd_col"
    rc = getattr(lib, name)(
        graph.tiles.data_ptr(), graph.bwd_count.data_ptr(),
        graph.bwd_row.data_ptr(), graph.bwd_tile.data_ptr(), graph.r_max,
        ld.data_ptr(), ls.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        *([dld.data_ptr()] if fuse_dld else []), dls.data_ptr(), dv.data_ptr(),
        *_scalars(graph, v, n_rows, n_cols, k, d, nc, n_paths, meta))
    _raise_on(rc, lib, name)
    return dld, dls, dv


def _bwd_launch(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta, nc: int):
    global flash_bwd_launches, flash_bwd_wide_launches
    out = _bwd_col_sweep(graph, ld, ls, v, g, lse, delta, meta, nc, fuse_dld=True)
    flash_bwd_launches += 1
    flash_bwd_wide_launches += v.shape[-1] // (ld.shape[-2] * nc) in BWD_WIDE_DIMS
    return out


def _bwd_row_launch(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta, nc: int):
    global flash_bwd_row_launches
    k, d, n_rows, n_cols, n_paths = _check(graph, "fwd", {
        "ld": (ld, "KR"), "ls": (ls, "KC"), "v": (v, "CF"), "g": (g, "RF"),
        "lse": (lse, "KR"), "delta": (delta, "NKR")}, nc)
    dld = torch.empty((*ld.shape[:-2], nc, k, n_rows), dtype=torch.float32, device=ld.device)
    lib = _lib()
    rc = lib.han_flash_bwd_row(
        graph.tiles.data_ptr(), graph.fwd_count.data_ptr(),
        graph.fwd_col.data_ptr(), graph.fwd_tile.data_ptr(), graph.c_max,
        ld.data_ptr(), ls.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dld.data_ptr(),
        *_scalars(graph, v, n_rows, n_cols, k, d, nc, n_paths, meta))
    _raise_on(rc, lib, "han_flash_bwd_row")
    flash_bwd_row_launches += 1
    return dld


def _bwd_col_launch(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta, nc: int):
    global flash_bwd_col_launches
    _, dls, dv = _bwd_col_sweep(graph, ld, ls, v, g, lse, delta, meta, nc, fuse_dld=False)
    flash_bwd_col_launches += 1
    return dls, dv


def flash_fwd_cuda(graph: BCSRGraph, ld, ls, v, meta: FlashMeta):
    """The forward kernel; same contract as :func:`flash_fwd_plain`, any D
    (:func:`head_plan`: a head wider than 32 through the wide body where
    :func:`takes_wide`)."""
    return fwd_chunked(_fwd_launch, graph, ld, ls, v, meta)


def flash_bwd_cuda(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    """The fused backward kernel; same contract as :func:`flash_bwd_plain`
    (a head wider than 32 through the wide body where :func:`takes_wide`)."""
    return bwd_chunked(_bwd_launch, graph, ld, ls, v, g, lse, delta, meta, takes_wide(graph))


def flash_bwd_row_cuda(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    """The row-sweep kernel; same contract as :func:`flash_bwd_row_plain`."""
    return bwd_chunked(_bwd_row_launch, graph, ld, ls, v, g, lse, delta, meta)


def flash_bwd_col_cuda(graph: BCSRGraph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    """The column-sweep kernel; same contract as :func:`flash_bwd_col_plain`."""
    return bwd_chunked(_bwd_col_launch, graph, ld, ls, v, g, lse, delta, meta)


def flash_fwd(graph, ld, ls, v, meta: FlashMeta):
    if ld.device.type == "cpu":
        return flash_fwd_plain(graph, ld, ls, v, meta)
    return flash_fwd_cuda(graph, ld, ls, v, meta)


def flash_bwd_row(graph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    if ld.device.type == "cpu":
        return flash_bwd_row_plain(graph, ld, ls, v, g, lse, delta, meta)
    return flash_bwd_row_cuda(graph, ld, ls, v, g, lse, delta, meta)


def flash_bwd_col(graph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    if ld.device.type == "cpu":
        return flash_bwd_col_plain(graph, ld, ls, v, g, lse, delta, meta)
    return flash_bwd_col_cuda(graph, ld, ls, v, g, lse, delta, meta)


def flash_bwd(graph, ld, ls, v, g, lse, delta, meta: FlashMeta):
    """(dld, dls, dv): the fused backward, or under
    ``torch.use_deterministic_algorithms(True)`` the split backward (row
    sweep, then column sweep), which sums without atomics. The same rule
    holds for CPU tensors, with the plain versions."""
    if torch.are_deterministic_algorithms_enabled():
        dld = flash_bwd_row(graph, ld, ls, v, g, lse, delta, meta)
        return (dld, *flash_bwd_col(graph, ld, ls, v, g, lse, delta, meta))
    if ld.device.type == "cpu":
        return flash_bwd_plain(graph, ld, ls, v, g, lse, delta, meta)
    return flash_bwd_cuda(graph, ld, ls, v, g, lse, delta, meta)


class _FlashGAT(torch.autograd.Function):
    """(ld, ls, v) → out; the backward is :func:`flash_bwd` (fused, or split
    under deterministic mode; kernels or plain versions). ``ctx.meta``
    keeps the forward's seed tensor: the backward replays its mask and
    draws nothing. On a stack of P graphs every tensor carries the P axis
    and each kernel is one launch for the P paths (``torch.func.vmap`` has
    no rule for this function: stack explicitly)."""

    @staticmethod
    def forward(ctx, ld, ls, v, graph, meta):
        out, lse = flash_fwd(graph, ld, ls, v, meta)
        ctx.save_for_backward(ld, ls, v, out, lse)
        ctx.graph, ctx.meta = graph, meta
        return out

    @staticmethod
    def backward(ctx, g):
        ld, ls, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        # delta_i = g_i · out_i over each head (head_delta)
        delta = head_delta(g, out, ld.shape[-2])
        dld, dls, dv = flash_bwd(ctx.graph, ld, ls, v, g, lse, delta, ctx.meta)
        # dv is f32 from the kernels, cast to v's type outside them as in
        # han_tpu (flash_gat.py:701)
        return dld, dls, dv.to(v.dtype), None, None


def check_args(slope: float, coef_dropout: float,
               generator: torch.Generator | None, fts: torch.Tensor,
               dtypes: tuple = V_DTYPES) -> None:
    """The argument checks every flash entry point shares; ``dtypes`` are
    the feature types the entry point takes."""
    if not 0.0 <= coef_dropout < 1.0:
        raise ValueError(f"coef_dropout must be in [0, 1), got {coef_dropout}")
    if coef_dropout > 0.0 and generator is None:
        raise ValueError("coef_dropout > 0 requires a generator")
    if not 0.0 <= slope <= 1.0:
        # the kernels compute leaky_relu as max(x, slope*x)
        raise ValueError(f"slope must be in [0, 1], got {slope}")
    if fts.dtype not in dtypes:
        raise NotImplementedError(
            f"this flash entry point takes {' or '.join(map(str, dtypes))} "
            f"features, got {fts.dtype}")


def draw_seed(coef_dropout: float, generator: torch.Generator | None,
              n: int = 1) -> torch.Tensor | int:
    """The kernels' dropout seeds: an int32 tensor of ``n`` seeds (one a
    path of a stack) drawn on the generator's device (no host round trip;
    inside a captured CUDA graph a registered generator draws new ones at
    every replay); 0 when dropout is off. Every shard of a partitioned run
    draws the same seeds from the same generator state."""
    if coef_dropout <= 0.0:
        return 0
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def draw_path_seeds(coef_dropout: float, generator: torch.Generator | None,
                    n_paths: int, towers: tuple[int, int, int] | None = None):
    """The seeds of ``n_paths`` stacked paths; ``towers`` = (lo, hi, P):
    the paths are towers lo..hi−1 of P (a rank of an mp mesh axis), so all
    P seeds are drawn and the slice kept, and each tower's seed is the one
    a one-device run draws for it."""
    if towers is None:
        # one path draws as every single-path caller does
        return (draw_seed(coef_dropout, generator) if n_paths == 1
                else draw_seed(coef_dropout, generator, n_paths))
    lo, hi, total = towers
    if hi - lo != n_paths:
        raise ValueError(f"towers {towers} do not match the {n_paths} stacked paths")
    seeds = draw_seed(coef_dropout, generator, total)
    return seeds[lo:hi].contiguous() if isinstance(seeds, torch.Tensor) else seeds


def flash_gat_attention(
    graph: BCSRGraph,
    fts: torch.Tensor,        # ([P,] N, K, D)
    logit_dst: torch.Tensor,  # ([P,] N, K)
    logit_src: torch.Tensor,  # ([P,] N, K)
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
    row_block_offset: int = 0,
    head_offset: int = 0,
    towers: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Drop-in implementation for ops.attention.attention_aggregate.

    Coefficient dropout is fused: its seed is drawn from ``generator`` on
    the generator's device, which must be the features' (no device-to-host
    sync per call, and graph-safe), and the backward replays the forward's
    mask; no mask is materialized on the kernel path. bf16 features stream
    to the kernels as bf16 and are widened in registers; logits, softmax
    and accumulators are f32, and the result is cast to ``fts.dtype``
    (han_tpu/ops/pallas/flash_gat.py:749-784).
    A stack of P graphs (graph/stack.py) with P-stacked tensors runs as
    one launch of each kernel, one seed a path (``towers``: see
    :func:`draw_path_seeds`). Returns ([P,] N, K, D) in ``fts.dtype``.
    """
    check_args(slope, coef_dropout, generator, fts)
    if not isinstance(graph, BCSRGraph):
        raise TypeError("flash impl needs a BCSRGraph (graph/bcsr.py builders; "
                        "graph_format='bcsr' in the trainer)")
    lead = fts.shape[:-3]
    if lead != (() if graph.n_paths is None else (graph.n_paths,)):
        raise ValueError(f"features {tuple(fts.shape)} do not match a graph of "
                         f"{graph.n_paths or 1} path(s)")
    n, k, d = fts.shape[-3:]
    pad = graph.n_pad - n
    # contiguous: with no padding (n == n_pad) F.pad returns the transposed
    # view, which the kernels refuse
    v = F.pad(fts.reshape(*lead, n, k * d), (0, 0, 0, pad)).contiguous()
    ld = F.pad(logit_dst.to(torch.float32).transpose(-1, -2), (0, pad)).contiguous()
    ls = F.pad(logit_src.to(torch.float32).transpose(-1, -2), (0, pad)).contiguous()
    meta = FlashMeta(slope=float(slope), dropout_p=float(coef_dropout),
                     seed=draw_path_seeds(coef_dropout, generator, graph.n_paths or 1, towers),
                     row_block_offset=int(row_block_offset),
                     head_offset=int(head_offset))
    out = _FlashGAT.apply(ld, ls, v, graph, meta)
    return out[..., :n, :].view(*lead, n, k, d).to(fts.dtype)
