"""Calibration kernels: CUDA wrappers, their plain PyTorch versions, launch
counters and the marginal-time helper (port of scripts/cal_vpu.py:35-201).

Each kernel (csrc/calibrate.cu, whose header names the TPU kernel it
replaces and the card ceiling that bounds it) runs R dependency-chained
passes over data it holds on chip, so that ``time_marginal`` — the time
between R and 2R in-kernel passes — is the card's compute rate for one
pass, free of device-memory traffic:

- ``prim_cuda`` ← ``_prim_kernel``: one primitive (``OPS``) over every
  element, in float32 or bfloat16 (packed pairs, two elements an
  instruction), with the row reductions in-thread trees;
- ``fwd_strip_cuda`` ← ``_fwd_strip_kernel``: the flash forward's
  per-(head, tile) body, with (``mxu``) or without p·v: ``fwd_kernel``'s
  tile body, its products 3xTF32 on the tensor cores;
- ``fwd_strip_bf16_cuda`` ← ``_fwd_strip_kernel_bf16``: the same body
  with p·v and v in bf16, as the bf16 flash forward
  (``fwd_kernel<8, bf16>``) takes it: v widened in registers, everything
  else in f32, the products 3xTF32 with v exact. cal_vpu.py's bf16 body
  rounds raw, z and p to bf16 besides, which no flash kernel does, so the
  port holds this strip to ``_fwd_strip_kernel`` on bf16-valued v;
- ``bwd_strip_cuda`` ← ``_bwd_strip_kernel``: the fused backward's body,
  ``bwd_col_kernel``'s.

Shapes. The plain versions take cal_vpu.py's arrays with any leading batch
dimensions: x (..., bm, sub); ld (..., 8, bm) and ls (..., 8, sub), of
which row 0 is used, as cal_vpu.py does; adj int8 (..., bm, sub); v (...,
sub, d); g (..., bm, d). The kernels take a batch of ``n_strips`` strips of
the port's 128×128 flash tile (bm = sub = 128, d = 8), one thread block
each: a launch covers the whole card. Every strip row holds at least one
edge (``make_inputs`` sets one): on an edgeless row cal_vpu.py's dense f32
forward sums exp(0) over the masked entries, which the port's kernels, like
its flash kernels, skip.

The plain versions (``*_plain``) compute the chain step by step as
cal_vpu.py's bodies do, with chain constants in the data's type, so a
bf16 pass rounds where the JAX body rounds; the CPU tests hold them to
cal_vpu.py and ``chip_smoke.py`` holds each kernel to them on the card.
The strips take their products through ``mm`` (default f32):
``ops/flash_gat.py:mm_3xtf32`` mirrors the kernels' products and
``mm_1xtf32`` is one TF32 product, the control that shows the card's
tolerances tell the two apart.
The calibration times the card only, so each wrapper launches its kernel
or raises (on CPU tensors too) and never falls back. ``prim_launches``,
``fwd_strip_launches``, ``fwd_strip_bf16_launches`` and
``bwd_strip_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import statistics
import subprocess

import numpy as np
import torch

OPS = ("add", "mul", "lrelu", "select", "exp", "rowmax", "rowsum")
TILE = 128   # strip side of the kernels: the port's flash tile
HEADS = 8    # head slots; the strip bodies unroll passes by 8
D = 8        # head dim of the kernels
SLOPE = 0.2

prim_launches = 0
fwd_strip_launches = 0
fwd_strip_bf16_launches = 0
bwd_strip_launches = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A chain constant in ``like``'s type (bf16 constants are exact: 1 ±
    2**-7, cal_vpu.py:37-41)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _prim_body(op: str, acc: torch.Tensor, aux: torch.Tensor):
    """One pass (cal_vpu.py:_prim_body); returns (acc, aux)."""
    c = lambda value: _const(value, acc)
    if op == "add":
        return acc + c(0.0078125), aux
    if op == "mul":
        return acc * c(0.9921875), aux
    if op == "lrelu":
        return torch.maximum(acc, c(0.2) * acc), aux
    if op == "select":
        return torch.where(acc >= 0, acc, acc * c(0.9921875)), aux
    if op == "exp":
        return torch.exp(acc * c(1e-9)), aux
    if op == "rowmax":
        return acc, aux * c(0.5) + (acc + aux[..., None] * c(1e-9)).amax(dim=-1)
    if op == "rowsum":
        return acc, aux * c(0.5) + (acc * c(1e-9) + aux[..., None] * c(1e-9)).sum(dim=-1)
    raise ValueError(f"unknown op {op!r} (one of {OPS})")


def prim_plain(x: torch.Tensor, op: str, reps: int) -> torch.Tensor:
    """``reps`` chained passes of ``op`` over x (..., bm, sub) in x's type;
    returns acc + aux, as _prim_kernel writes it."""
    acc, aux = x, torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    for _ in range(reps):
        acc, aux = _prim_body(op, acc, aux)
    return acc + aux[..., None]


def fwd_strip_plain(ld, ls, adj, v, reps: int, mxu: bool = True,
                    slope: float = SLOPE, mm=torch.matmul) -> torch.Tensor:
    """_fwd_strip_kernel: reps // 8 × 8 passes of the forward body; one (m,
    l) carry, the p·v of pass p (``mm(p, v)``) into head slot p % 8.
    Returns (..., bm, 8·d) = acc + m + l (every slot; cal_vpu.py outputs
    slot 0)."""
    on_edge = adj != 0
    ld0, ls0 = ld[..., 0, :], ls[..., 0, :]
    m = torch.full_like(ld0, -1e9)
    l = torch.zeros_like(ld0)
    acc = ld0.new_zeros((*ld0.shape, HEADS, v.shape[-1]))
    for p in range(reps // HEADS * HEADS):
        raw = (ld0 + m * 1e-9)[..., :, None] + ls0[..., None, :]
        z = torch.where(on_edge, torch.maximum(raw, slope * raw), -1e9)
        m_new = torch.maximum(m, z.amax(dim=-1))
        scale = torch.exp(m - m_new)
        pe = torch.exp(z - m_new[..., None])
        l = l * scale + pe.sum(dim=-1)
        if mxu:
            h = p % HEADS
            acc[..., h, :] = acc[..., h, :] * scale[..., None] + mm(pe, v)
        m = m_new
    return acc.flatten(-2) + (m + l)[..., None]


def fwd_strip_bf16_plain(ld, ls, adj, v, reps: int, slope: float = SLOPE,
                         mm=torch.matmul) -> torch.Tensor:
    """The bf16 flash forward's body: :func:`fwd_strip_plain` with p·v on
    the bf16 v's values widened to ld's type (everything else in that
    type, as ``fwd_kernel<8, bf16>``). Returns (..., bm, 8·d), every head
    slot."""
    return fwd_strip_plain(ld, ls, adj, v.to(ld.dtype), reps, True, slope, mm)


def bwd_strip_plain(ld, ls, adj, v, g, reps: int, slope: float = SLOPE,
                    mm=torch.matmul) -> torch.Tensor:
    """_bwd_strip_kernel: reps // 8 × 8 passes of the fused backward body
    with cal_vpu.py's carries (dls, dld and the pass's dv slot decay by
    0.5; ld + dld·1e-9 feeds the next pass), its two products g·v and c·g
    taken by ``mm``. Returns (..., sub, 8·d) = dv + dls + dld[:d] (every
    slot)."""
    on_edge = adj != 0
    ld0, ls0 = ld[..., 0, :], ls[..., 0, :]
    d = v.shape[-1]
    dls = ls0.new_zeros(ls0.shape)
    dld = ld0.new_zeros(ld0.shape)
    dv = ls0.new_zeros((*ls0.shape, HEADS, d))
    gv = mm(g, v.transpose(-1, -2))  # (..., bm, sub): the same every pass
    for p in range(reps // HEADS * HEADS):
        ldp = ld0 + dld * 1e-9
        lse, delta = ldp * 0.5, ldp * 0.25
        raw = ldp[..., :, None] + ls0[..., None, :]
        c = torch.where(on_edge, torch.exp(torch.maximum(raw, slope * raw) - lse[..., None]), 0.0)
        dz = c * gv - c * delta[..., None]
        dzs = torch.where(raw >= 0, dz, slope * dz)
        dls = dls * 0.5 + dzs.sum(dim=-2)
        h = p % HEADS
        dv[..., h, :] = dv[..., h, :] * 0.5 + mm(c.transpose(-1, -2), g)
        dld = dld * 0.5 + dzs.sum(dim=-1)
    return (dv + dls[..., None, None] + dld[..., None, None, :d]).flatten(-2)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "han_cal_prim": [_I, _I, _P, _P, _I, _I, _P],
    "han_cal_fwd_strip": [_I, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "han_cal_fwd_strip_bf16": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    "han_cal_bwd_strip": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry points' signatures declared."""
    from han_tpu_torch.ops import _build

    lib = _build.load("calibrate")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.han_cal_error_string.argtypes = [ctypes.c_int]
    lib.han_cal_error_string.restype = ctypes.c_char_p
    return lib


def _check(**tensors) -> int:
    """Raise on anything the kernels do not take; returns n_strips. Each
    keyword maps a name to (tensor, dtype, shape after the strip axis)."""
    first = next(iter(tensors.values()))[0]
    if first.device.type != "cuda":
        raise ValueError(f"the calibration kernels take CUDA tensors, got {first.device}")
    n_strips = first.shape[0]
    for name, (t, dt, shape) in tensors.items():
        want = (n_strips, *shape)
        if (t.device != first.device or t.dtype != dt or not t.is_contiguous()
                or tuple(t.shape) != want):
            raise ValueError(f"{name}: need a contiguous {dt} {want} tensor on "
                             f"{first.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return n_strips


def _strip_args(ld, ls, adj, v, v_dtype):
    return dict(ld=(ld, torch.float32, (HEADS, TILE)), ls=(ls, torch.float32, (HEADS, TILE)),
                adj=(adj, torch.int8, (TILE, TILE)), v=(v, v_dtype, (TILE, D)))


def _launch(name: str, *args) -> None:
    lib = _lib()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.han_cal_error_string(rc).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_reps(reps: int, multiple: int = 1) -> None:
    if reps < 0 or reps % multiple:
        raise ValueError(f"reps must be a non-negative multiple of {multiple}, got {reps}")


def prim_cuda(x: torch.Tensor, op: str, reps: int) -> torch.Tensor:
    """The primitive kernel on x (n_strips, 128, 128), f32 or bf16."""
    global prim_launches
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (one of {OPS})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x: need float32 or bfloat16, got {x.dtype}")
    _check_reps(reps)
    n_strips = _check(x=(x, x.dtype, (TILE, TILE)))
    out = torch.empty_like(x)
    _launch("han_cal_prim", OPS.index(op), int(x.dtype == torch.bfloat16), x.data_ptr(),
            out.data_ptr(), n_strips * TILE, reps, _stream(x))
    prim_launches += 1
    return out


def fwd_strip_cuda(ld, ls, adj, v, reps: int, mxu: bool = True,
                   slope: float = SLOPE) -> torch.Tensor:
    """The f32 forward strip kernel; same contract as
    :func:`fwd_strip_plain` at bm = sub = 128, d = 8, reps % 8 == 0."""
    global fwd_strip_launches
    _check_reps(reps, HEADS)
    n_strips = _check(**_strip_args(ld, ls, adj, v, torch.float32))
    out = torch.empty((n_strips, TILE, HEADS * D), dtype=torch.float32, device=ld.device)
    _launch("han_cal_fwd_strip", int(mxu), ld.data_ptr(), ls.data_ptr(), adj.data_ptr(),
            v.data_ptr(), out.data_ptr(), n_strips, reps, slope, _stream(ld))
    fwd_strip_launches += 1
    return out


def fwd_strip_bf16_cuda(ld, ls, adj, v, reps: int, slope: float = SLOPE) -> torch.Tensor:
    """The bf16 forward strip kernel; same contract as
    :func:`fwd_strip_bf16_plain` at bm = sub = 128, d = 8 (v bf16), reps %
    8 == 0."""
    global fwd_strip_bf16_launches
    _check_reps(reps, HEADS)
    n_strips = _check(**_strip_args(ld, ls, adj, v, torch.bfloat16))
    out = torch.empty((n_strips, TILE, HEADS * D), dtype=torch.float32, device=ld.device)
    _launch("han_cal_fwd_strip_bf16", ld.data_ptr(), ls.data_ptr(), adj.data_ptr(),
            v.data_ptr(), out.data_ptr(), n_strips, reps, slope, _stream(ld))
    fwd_strip_bf16_launches += 1
    return out


def bwd_strip_cuda(ld, ls, adj, v, g, reps: int, slope: float = SLOPE) -> torch.Tensor:
    """The backward strip kernel; same contract as :func:`bwd_strip_plain`
    at bm = sub = 128, d = 8, reps % 8 == 0."""
    global bwd_strip_launches
    _check_reps(reps, HEADS)
    n_strips = _check(**_strip_args(ld, ls, adj, v, torch.float32),
                      g=(g, torch.float32, (TILE, D)))
    out = torch.empty((n_strips, TILE, HEADS * D), dtype=torch.float32, device=ld.device)
    _launch("han_cal_bwd_strip", ld.data_ptr(), ls.data_ptr(), adj.data_ptr(), v.data_ptr(),
            g.data_ptr(), out.data_ptr(), n_strips, reps, slope, _stream(ld))
    bwd_strip_launches += 1
    return out


# ---------------------------------------------------------------------------
# inputs and timing
# ---------------------------------------------------------------------------


def make_inputs(n_strips: int, bm: int = TILE, sub: int = TILE, d: int = D,
                seed: int = 0, density: float = 0.03) -> dict[str, np.ndarray]:
    """cal_vpu.py's inputs for ``n_strips`` strips, from a seeded numpy
    generator: x (standard normal), ld (8, bm), ls (8, sub), adj at
    ``density`` plus one edge in every row (column i mod sub), v (sub, d)
    and g (bm, d). All float32 but adj (int8); the bf16 arms round x and
    v."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal((n_strips, *s)).astype(np.float32)
    adj = (rng.random((n_strips, bm, sub)) < density).astype(np.int8)
    adj[:, np.arange(bm), np.arange(bm) % sub] = 1
    return {"x": f32(bm, sub), "ld": f32(HEADS, bm), "ls": f32(HEADS, sub), "adj": adj,
            "v": f32(sub, d), "g": f32(bm, d)}


PAIRS = 7  # (r_lo, r_hi) run pairs of a marginal timing
LAUNCHES_PER_TIMING = 2 + 2 * PAIRS  # with one warm-up call of each length
SPIN_CYCLES = 8_000_000  # about 4 ms of the card's clock, queued before each timed launch
# launches that time_marginal repeated because the spin ended first, by kernel
# ("prim", "fwd_strip", "fwd_strip_bf16", "bwd_strip"): on top of
# LAUNCHES_PER_TIMING
relaunches: dict[str, int] = {}


def time_marginal(fn, r_lo: int, r_hi: int, kernel: str,
                  outer: int = PAIRS) -> tuple[float, float, float]:
    """Seconds per extra in-kernel pass between ``fn(r_lo)`` and
    ``fn(r_hi)`` (each one launch): CUDA events, one warm-up call each,
    then ``outer`` pairs, each an r_lo run right before an r_hi run, so a
    drift of the card's clock between the two lengths cancels within the
    pair. Each timed launch is queued behind a spin kernel
    (``torch.cuda._sleep``) that must still be running when the launch
    is queued, so the start event fires on the card after the launch is
    queued: the wrapper's host time before the launch (about 0.45 ms on an
    idle card, which made t(R) = a + b·R with a fixed a and pulled
    t(2R)/t(R) below 2 at short R) is not counted. Where the spin ended
    first, the run is repeated with a spin twice as long, up to 16 x
    SPIN_CYCLES, and then it raises; ``relaunches[kernel]`` counts the
    repeated launches. Returns (seconds per pass, t(r_lo),
    t(r_hi)): the median over the pairs of the marginal time, the median
    t(r_lo), and that times the pairs' median t(r_hi) / t(r_lo) ratio,
    which near r_hi / r_lo shows the passes were not folded."""
    def once(r):
        spin = SPIN_CYCLES
        while True:
            torch.cuda._sleep(spin)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(r)
            late = start.query()  # the spin ended before the launch was queued
            end.record()
            end.synchronize()
            if not late:
                return start.elapsed_time(end) * 1e-3
            if spin >= 16 * SPIN_CYCLES:
                raise RuntimeError(f"time_marginal: a spin of {spin} cycles ended before the "
                                   f"launch was queued")
            relaunches[kernel] = relaunches.get(kernel, 0) + 1
            spin *= 2

    for r in (r_lo, r_hi):
        once(r)
    pairs = [(once(r_lo), once(r_hi)) for _ in range(outer)]
    per_pass = statistics.median((hi - lo) / (r_hi - r_lo) for lo, hi in pairs)
    t_lo = statistics.median(lo for lo, _ in pairs)
    ratio = statistics.median(hi / lo for lo, hi in pairs)
    return max(per_pass, 1e-12), t_lo, t_lo * ratio


# ---------------------------------------------------------------------------
# the calibration run (scripts/cal_vpu_torch.py, bench_torch.py)
# ---------------------------------------------------------------------------

FOLD_LIMIT = 1.05  # a rate above this share of its ceiling is a folded chain
SCALING = (1.9, 2.1)  # t(2R)/t(R) of a chain that runs all its passes
STRIP_CEILING = {"fwd_strip_s": "fwd_strip", "fwd_strip_s_mxu": "fwd_strip",
                 "fwd_strip_s_bf16_mxu": "fwd_strip_bf16", "bwd_strip_s_mxu": "bwd_strip"}


def card_info() -> dict:
    """The card's name, power limit, count, SM count and maximum SM clock."""
    name, limit, clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0].split(", ")
    return {"name": name, "power_limit": limit, "count": torch.cuda.device_count(),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "max_sm_clock_hz": float(clock.split()[0]) * 1e6}


def ceilings(sms: int, clock_hz: float) -> dict:
    """Elements/s ceilings of csrc/calibrate.cu's header: 128 FP32 lanes
    (and thread-instructions) a clock per SM, twice that for the packed
    bf16 pairs the bf16 primitives run on, 16 MUFU.EX2 a clock per SM. The
    strip bodies, f32 and bf16 alike, issue one ex2 on every swept element,
    so their ceiling is the SFU rate."""
    lanes = sms * 128 * clock_hz
    exp = sms * 16 * clock_hz
    return {"f32": lanes, "bf16": 2 * lanes, "exp": exp, "fwd_strip": exp, "bwd_strip": exp,
            "fwd_strip_bf16": exp}


def prim_ceiling(op: str, dtype: str, ceil: dict) -> float:
    return ceil["exp"] if op == "exp" else ceil[dtype]


def _inputs(n_strips: int) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to("cuda") for k, v in make_inputs(n_strips).items()}


# Seconds a pass of each strip body on a card of 1,056 strips (132 SMs x 8),
# the last calibration (results/CALIBRATION_H100.json, NVIDIA H100 80GB
# HBM3, 700.00 W): what :func:`strip_reps` sizes R by.
STRIP_PASS_S = {"fwd_strip_s": 6.524481127024306e-06, "fwd_strip_s_mxu": 1.2725766748189926e-05,
                "fwd_strip_s_bf16_mxu": 1.1494922451674938e-05,
                "bwd_strip_s_mxu": 2.164293639361858e-05}
STRIP_PASS_STRIPS = 1056
STRIP_MIN_S = 0.02  # the shortest t(R) of a strip timing (see strip_reps)


def strip_reps(key: str, n_strips: int, base: int) -> int:
    """The R of strip body ``key``'s R → 2R timing: ``base`` (halved for
    the backward body, as cal_vpu.py:335 times it) or more, a multiple of
    the HEADS passes the bodies unroll, with t(R) at least STRIP_MIN_S at
    the last measured time a pass (scaled to ``n_strips``). A launch costs
    a fixed time besides its passes (t(R) less R passes: on the H100 about
    0.02 ms, measured with time_marginal's spin), which pulls t(2R)/t(R)
    below 2 by that time over t(R): at t(R) = 20 ms at most 2.5 %, inside
    SCALING. Timed at R = 256 (4.4 ms) and with the host's
    time before the launch counted, a scalar forward body once measured
    1.8939."""
    if key == "bwd_strip_s_mxu":
        base //= 2
    pass_s = STRIP_PASS_S[key] * n_strips / STRIP_PASS_STRIPS
    r = max(base, math.ceil(STRIP_MIN_S / pass_s))
    return -(-r // HEADS) * HEADS


def calibrate_strips(n_strips: int, base_reps: int) -> dict:
    """The four strip timings (seconds per card-wide pass), with
    ``elems_per_strip``, the time per 128×128 tile-head, elements/s, the
    R of each timing (:func:`strip_reps`) and its R → 2R time ratio."""
    inp = _inputs(n_strips)
    a = [inp[k] for k in ("ld", "ls", "adj", "v")]
    v16 = inp["v"].to(torch.bfloat16)
    bodies = {  # (the body, its kernel)
        "fwd_strip_s": (lambda r: fwd_strip_cuda(*a, r, mxu=False), "fwd_strip"),
        "fwd_strip_s_mxu": (lambda r: fwd_strip_cuda(*a, r, mxu=True), "fwd_strip"),
        "fwd_strip_s_bf16_mxu": (lambda r: fwd_strip_bf16_cuda(*a[:3], v16, r),
                                 "fwd_strip_bf16"),
        "bwd_strip_s_mxu": (lambda r: bwd_strip_cuda(*a, inp["g"], r), "bwd_strip"),
    }
    elems = n_strips * TILE * TILE
    out = {"elems_per_strip": elems, "n_strips": n_strips, "tile_s": {},
           "card_elems_per_s": {}, "scaling": {}, "strip_reps": {}}
    for key, (fn, kernel) in bodies.items():
        reps = strip_reps(key, n_strips, base_reps)
        tp, t_lo, t_hi = time_marginal(fn, reps, 2 * reps, kernel)
        out[key] = tp
        out["tile_s"][key] = tp / n_strips
        out["card_elems_per_s"][key] = elems / tp
        out["scaling"][key] = t_hi / t_lo
        out["strip_reps"][key] = reps
        print(f"{key:22s}: {tp * 1e6:9.3f} us/pass, {tp / n_strips * 1e9:8.3f} ns per "
              f"tile-head, {elems / tp:.4e} elements/s, R {reps}, t(R) {t_lo * 1e3:.3f} ms, "
              f"t(2R)/t(R) {t_hi / t_lo:.4f}", flush=True)
    return out


def calibrate_prims(n_strips: int, reps: int) -> dict:
    """Elements/s of each (op, dtype) primitive pass, and its R → 2R time
    ratio."""
    x32 = _inputs(n_strips)["x"]
    elems = x32.numel()
    rates, scaling = {}, {}
    for op in OPS:
        for name, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
            tp, t_lo, t_hi = time_marginal(lambda r, op=op, x=x: prim_cuda(x, op, r),
                                           reps, 2 * reps, "prim")
            rates[f"{op}_{name}"] = elems / tp
            scaling[f"{op}_{name}"] = t_hi / t_lo
            print(f"{op:7s} {name:4s}: {tp * 1e6:8.3f} us/pass -> {elems / tp / 1e12:7.3f} "
                  f"Te/s, t(2R)/t(R) {t_hi / t_lo:.3f}", flush=True)
    return {"prim_rates_eps": rates, "prim_scaling": scaling}


def check_ceilings(result: dict) -> list[str]:
    """Rates above FOLD_LIMIT × their ceiling, and R → 2R time ratios
    outside SCALING (each a folded or hoisted chain)."""
    ceil = result["ceilings_eps"]
    bad = []
    for key, rate in result.get("prim_rates_eps", {}).items():
        op, dtype = key.rsplit("_", 1)
        if rate > FOLD_LIMIT * prim_ceiling(op, dtype, ceil):
            bad.append(f"{key}: {rate:.4e} > {FOLD_LIMIT} x {prim_ceiling(op, dtype, ceil):.4e}")
    for key, rate in result.get("card_elems_per_s", {}).items():
        c = ceil[STRIP_CEILING[key]]
        if rate > FOLD_LIMIT * c:
            bad.append(f"{key}: {rate:.4e} elements/s > {FOLD_LIMIT} x {c:.4e}")
    lo, hi = SCALING
    for key, ratio in {**result.get("prim_scaling", {}), **result.get("scaling", {})}.items():
        if not lo <= ratio <= hi:
            bad.append(f"{key}: t(2R)/t(R) = {ratio:.4f}, outside [{lo}, {hi}]")
    return bad


def calibrate(bm: int, sub: int, d: int, reps: int, strip_reps: int,
              strips_only: bool = False, previous: dict | None = None) -> dict:
    """The whole calibration on the current card as one dict (``previous``
    keeps its primitive rates when ``strips_only``)."""
    if d != D or bm % TILE or sub % TILE:
        raise ValueError(f"the kernels take d = {D} and bm, sub multiples of {TILE}; "
                         f"got d={d}, bm={bm}, sub={sub}")
    n_strips = bm // TILE * (sub // TILE)
    card = card_info()
    result = dict(previous or {})
    result.update({"bm": bm, "sub": sub, "d": d, "tile": TILE,
                   "device": card, "ceilings_eps": ceilings(card["sms"], card["max_sm_clock_hz"])})
    if not strips_only:
        result.update(calibrate_prims(n_strips, reps))
    result.update(calibrate_strips(n_strips, strip_reps))
    result["frac_of_ceiling"] = {
        **{k: r / prim_ceiling(*k.rsplit("_", 1), result["ceilings_eps"])
           for k, r in result.get("prim_rates_eps", {}).items()},
        **{k: r / result["ceilings_eps"][STRIP_CEILING[k]]
           for k, r in result["card_elems_per_s"].items()}}
    return result
