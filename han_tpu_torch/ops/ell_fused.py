"""Fused ELL (fixed-fanout) attention: the CUDA forward kernel, its plain
PyTorch version, the plain-torch backward and the autograd wrapper (port of
han_tpu/ops/pallas/ell_fused.py).

Edge-domain regime over sampled blocks: each row's neighbor list is padded
to fanout F (graph/containers.EllGraph). The forward gathers each row's
neighbors' logit_src and feature rows, takes the masked leaky-relu softmax
over the F slots per head, applies coefficient dropout and sums the
weighted features, without materializing the (N, F, K·D) gather that
``ops.attention.ell_attention`` builds.

The kernel (csrc/ell_fused.cu, whose header says what bounds it on the
H100 and what its design does about it), ``han_ell_fused_fwd``, replaces
``han_tpu/ops/pallas/ell_fused.py:_kernel``. On the TPU that kernel never
compiled at production shapes (Mosaic lowers gathers only in
take_along_axis form); gathers are native on the GPU.

Backward: plain torch on every device, mirroring han_tpu's
``_ell_fused_core_bwd`` (XLA segment ops there, not a Pallas kernel): a dz
recompute, dld as a row sum, dls and dv through ``index_add_``. On the card
``index_add_`` sums with atomics in a varying order.

Coefficient dropout: the keep mask is drawn once per call outside the
kernel, (N, F, K) uint8, as ``torch.rand((N, F, K), generator=...) < 1 - p``
— the same draw ``ell_attention`` makes from the same generator state — so
the kernel, its plain version and the backward apply one mask.

Features are f32 or bf16 (han_tpu computes in f32 and returns the input's
dtype, ell_fused.py:210-213,237): the kernel gathers bf16 rows as bf16 and
widens them in registers; the logits, the softmax and every sum stay f32,
in the kernel, its plain version and the backward; the output and d_fts
come back in the features' dtype.

Every wrapper uses the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; there is no fallback.
``ell_fused_launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from han_tpu_torch.graph.containers import MASK_VALUE, EllGraph

ell_fused_launches = 0


def kernel_takes(dtype: torch.dtype) -> bool:
    """Whether the kernel takes features of ``dtype``: float32 or bfloat16,
    at any heads K and head dim D. The sampled trainer's ``impl="auto"``
    asks this, so its choice depends on the model, never on the device."""
    return dtype in (torch.float32, torch.bfloat16)


def _ell_coefs(nbr: torch.Tensor, ld: torch.Tensor, ls: torch.Tensor,
               slope: float):
    """(N, F, K) softmax coefficients, raw logits and the (N, F) valid mask
    (shared forward/backward math, as han_tpu's ``_ell_coefs``)."""
    n, k = ld.shape
    valid = nbr < n
    safe = torch.where(valid, nbr, n).long()
    ls_pad = torch.cat([ls, ls.new_zeros((1, k))])
    raw = ld[:, None, :] + ls_pad[safe]                     # (N, F, K)
    z = torch.where(raw >= 0, raw, slope * raw)
    z = torch.where(valid[:, :, None], z, MASK_VALUE)
    m = z.amax(dim=1, keepdim=True)
    e = torch.where(valid[:, :, None], torch.exp(z - m), 0.0)
    denom = e.sum(dim=1, keepdim=True).clamp_min(1e-30)
    return e / denom, raw, valid, safe


def _keep_scale(keep: torch.Tensor | None, p: float):
    """f32 (N, F, K): 1/(1-p) where kept, 0 where dropped (None when off)."""
    if keep is None:
        return None
    return torch.where(keep != 0, 1.0 / (1.0 - p), 0.0)


def ell_fused_fwd_plain(nbr, ld, ls, fts, keep, slope: float, p: float):
    """nbr int32 (N, F) (sentinel N), ld/ls f32 (N, K), fts f32 or bf16 (N,
    K·D), keep uint8 (N, F, K) or None → out (N, K·D) in fts's dtype. The
    kernel's math in plain torch: f32 inside, one rounding at the end."""
    n, k = ld.shape
    f = nbr.shape[1]
    d = fts.shape[1] // k
    coefs, _, _, safe = _ell_coefs(nbr, ld, ls, slope)
    mk = _keep_scale(keep, p)
    if mk is not None:  # reference order: softmax first, then dropout
        coefs = coefs * mk
    fts_pad = torch.cat([fts, fts.new_zeros((1, k * d))])
    g = fts_pad[safe].view(n, f, k, d).float()
    return torch.einsum("nfk,nfkd->nkd", coefs, g).reshape(n, k * d).to(fts.dtype)


def ell_dz(nbr, ld, ls, fts, keep, g, slope: float, p: float):
    """The backward's recompute, shared with ops/tree_ell.py: with
    c̃ = c·mk (mk = keep/(1-p)), dz_f = c_f(mk_f·(g·v_f) −
    Σ_f' c̃_f'(g·v_f')) folded with leaky_relu′ and zero on empty slots,
    in f32 whatever the dtypes of fts and g. Returns dz (N, F, K), c̃ (N,
    F, K) and the sentinel-safe nbr (N, F)."""
    n, k = ld.shape
    f = nbr.shape[1]
    d = fts.shape[1] // k
    coefs, raw, valid, safe = _ell_coefs(nbr, ld, ls, slope)
    mk = _keep_scale(keep, p)
    c_agg = coefs * mk if mk is not None else coefs
    fts_pad = torch.cat([fts, fts.new_zeros((1, k * d))])
    gv = torch.einsum("nkd,nfkd->nfk", g.view(n, k, d).float(),
                      fts_pad[safe].view(n, f, k, d).float())   # g_i · v_j
    gv_agg = gv * mk if mk is not None else gv
    dz = coefs * (gv_agg - (c_agg * gv).sum(dim=1, keepdim=True))
    dz = torch.where(raw >= 0, dz, slope * dz)
    return torch.where(valid[:, :, None], dz, 0.0), c_agg, safe


def ell_fused_bwd(nbr, ld, ls, fts, keep, g, slope: float, p: float):
    """Gradients (d_fts (N, K·D), d_ld (N, K), d_ls (N, K)) of
    ``sum(out · g)``; han_tpu's ``_ell_fused_core_bwd`` in plain torch:
    dld is the row sum of dz, dls and dv = Σ c̃ᵀ g scatter over the slots,
    summed in f32; d_fts comes back in fts's dtype."""
    n, k = ld.shape
    f = nbr.shape[1]
    kd = fts.shape[1]
    dz, c_agg, safe = ell_dz(nbr, ld, ls, fts, keep, g, slope, p)
    flat = safe.reshape(-1)
    dls = ld.new_zeros((n + 1, k)).index_add_(0, flat, dz.reshape(n * f, k))[:n]
    cg = c_agg[..., None] * g.view(n, 1, k, kd // k).float()
    dv = ld.new_zeros((n + 1, kd)).index_add_(0, flat, cg.reshape(n * f, kd))[:n]
    return dv.to(fts.dtype), dz.sum(dim=1), dls


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry points' signatures declared."""
    from han_tpu_torch.ops import _build

    lib = _build.load("ell_fused")
    lib.han_ell_fused_fwd.argtypes = [_P] * 6 + [_I] * 5 + [_F, _F, _P]
    lib.han_ell_fused_fwd.restype = ctypes.c_int
    lib.han_tree_ell_bwd.argtypes = [_P] * 11 + [_I] * 5 + [_F, _F, _P]  # ops/tree_ell.py
    lib.han_tree_ell_bwd.restype = ctypes.c_int
    lib.han_error_string.argtypes = [ctypes.c_int]
    lib.han_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(kernel: str, dev: torch.device, fts_dtype: torch.dtype,
                 want: dict) -> None:
    """Raises unless ``dev`` is a CUDA device, the kernel takes features of
    ``fts_dtype`` and every ``name: (tensor, dtype, shape)`` of ``want`` is
    a contiguous tensor of that dtype and shape on ``dev``."""
    if dev.type != "cuda":
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, got {dev}")
    if not kernel_takes(fts_dtype):
        raise NotImplementedError(
            f"the {kernel} kernel takes float32 or bfloat16 features, got {fts_dtype}")
    for name, (t, dt, shape) in want.items():
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name}: need a contiguous {dt} {shape} tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_launch(rc: int, kernel: str, f: int, k: int) -> None:
    """Raises on an entry point's nonzero return code (a cudaError_t)."""
    if rc == 1:  # cudaErrorInvalidValue: the per-warp buffers of F x K outgrow a block
        raise NotImplementedError(
            f"the {kernel} kernel does not take fanout {f} x {k} heads: its per-warp "
            f"buffers exceed a block's shared memory ({_lib().han_error_string(rc).decode()})")
    if rc != 0:
        raise RuntimeError(f"the {kernel} kernel's launch failed: CUDA error {rc} "
                           f"({_lib().han_error_string(rc).decode()})")


def ell_fused_fwd_cuda(nbr, ld, ls, fts, keep, slope: float, p: float):
    """The forward kernel; same contract as :func:`ell_fused_fwd_plain`."""
    global ell_fused_launches
    dev = ld.device
    n, k = ld.shape
    f = nbr.shape[1]
    d = fts.shape[1] // k
    want = {"nbr": (nbr, torch.int32, (n, f)), "ld": (ld, torch.float32, (n, k)),
            "ls": (ls, torch.float32, (n, k)), "fts": (fts, fts.dtype, (n, k * d))}
    if keep is not None:
        want["keep"] = (keep, torch.uint8, (n, f, k))
    check_inputs("ell_fused", dev, fts.dtype, want)
    out = torch.empty((n, k * d), dtype=fts.dtype, device=dev)
    rc = _lib().han_ell_fused_fwd(
        nbr.data_ptr(), ld.data_ptr(), ls.data_ptr(), fts.data_ptr(),
        keep.data_ptr() if keep is not None else None, out.data_ptr(),
        n, f, k, d, int(fts.dtype == torch.bfloat16), float(slope),
        1.0 / (1.0 - p) if keep is not None else 1.0,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "ell_fused", f, k)
    ell_fused_launches += 1
    return out


def ell_fused_fwd(nbr, ld, ls, fts, keep, slope: float, p: float):
    if ld.device.type == "cpu":
        return ell_fused_fwd_plain(nbr, ld, ls, fts, keep, slope, p)
    return ell_fused_fwd_cuda(nbr, ld, ls, fts, keep, slope, p)


class _EllFused(torch.autograd.Function):
    """(fts (N, K·D), ld, ls) → out (N, K·D): the kernel (or its plain
    version) forward, the plain-torch backward."""

    @staticmethod
    def forward(ctx, fts, ld, ls, nbr, keep, slope, p):
        out = ell_fused_fwd(nbr, ld, ls, fts, keep, slope, p)
        ctx.save_for_backward(fts, ld, ls, nbr, keep)
        ctx.slope, ctx.p = slope, p
        return out

    @staticmethod
    def backward(ctx, g):
        fts, ld, ls, nbr, keep = ctx.saved_tensors
        dv, dld, dls = ell_fused_bwd(nbr, ld, ls, fts, keep, g.contiguous(),
                                     ctx.slope, ctx.p)
        return dv, dld, dls, None, None, None, None


def draw_keep(n: int, f: int, k: int, p: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """The (N, F, K) uint8 coefficient keep mask, drawn as ell_attention
    draws it: ``torch.rand((N, F, K), generator) < 1 - p``."""
    return (torch.rand((n, f, k), generator=generator, device=device)
            < 1.0 - p).to(torch.uint8)


def ell_fused_attention(
    graph: EllGraph,
    fts: torch.Tensor,        # (N, K, D)
    logit_dst: torch.Tensor,  # (N, K)
    logit_src: torch.Tensor,  # (N, K)
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Drop-in implementation for ops.attention.attention_aggregate on an
    EllGraph whose n_nodes equals the feature rows. ``generator`` (on the
    features' device) draws the keep mask. Features f32 or bf16; logits
    f32. Returns (N, K, D) in the features' dtype."""
    if not 0.0 <= coef_dropout < 1.0:
        raise ValueError(f"coef_dropout must be in [0, 1), got {coef_dropout}")
    if not 0.0 <= slope <= 1.0:
        # the kernel computes leaky_relu as max(x, slope*x)
        raise ValueError(f"slope must be in [0, 1], got {slope}")
    if not kernel_takes(fts.dtype):
        raise NotImplementedError(f"ell_fused takes float32 or bfloat16 features, got {fts.dtype}")
    n, k, d = fts.shape
    if graph.n_nodes != n:
        raise ValueError(f"graph has {graph.n_nodes} nodes, features {n} rows")
    keep = None
    if coef_dropout > 0.0:
        if generator is None:
            raise ValueError("coef_dropout > 0 requires a generator")
        keep = draw_keep(n, graph.fanout, k, coef_dropout, generator, fts.device)
    nbr = graph.nbr if graph.nbr.dtype == torch.int32 else graph.nbr.to(torch.int32)
    out = _EllFused.apply(fts.reshape(n, k * d).contiguous(),
                          logit_dst.contiguous(), logit_src.contiguous(),
                          nbr.contiguous(), keep, float(slope), float(coef_dropout))
    return out.view(n, k, d)
