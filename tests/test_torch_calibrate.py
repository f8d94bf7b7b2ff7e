"""han_tpu_torch's calibration bodies (ops/calibrate.py, the plain versions
of csrc/calibrate.cu's kernels) against the Pallas kernel bodies of
scripts/cal_vpu.py, loaded with importlib and run through
``pl.pallas_call(..., interpret=True)`` on the CPU at bm=8, sub=128, d=8,
R=16 (the bf16 strip, the bf16 flash forward's body, against
``_fwd_strip_kernel`` on bf16-valued v); the strips' products taken as the
kernels take them (3xTF32) against f32 and one TF32 product; the wrappers'
refusals; the fold check's ceilings and the strip timings' R."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from han_tpu_torch.ops import calibrate as cal  # noqa: E402
from han_tpu_torch.ops import flash_gat as fg  # noqa: E402

BM, SUB, D, R = 8, 128, 8, 16


@functools.cache
def cal_vpu():
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "cal_vpu.py"
    spec = importlib.util.spec_from_file_location("cal_vpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def inputs():
    return {k: v[0] for k, v in cal.make_inputs(1, BM, SUB, D, seed=3).items()}


def jax_strip(kernel, out_rows, *arrays, scratch=True, **kw):
    """cal_vpu.py's strip kernel in interpret mode; its first d columns."""
    call = pl.pallas_call(
        functools.partial(kernel, reps=R, d=D, **kw),
        out_shape=jax.ShapeDtypeStruct((out_rows, 8 * D), jnp.float32),
        scratch_shapes=[pltpu.VMEM((out_rows, 8 * D), jnp.float32)] if scratch else (),
        interpret=True)
    return np.asarray(call(*arrays))[:, :D]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", cal.OPS)
def test_prim_plain_matches_cal_vpu(op, dtype):
    """Every (op, dtype) pass chain: f32 rtol 1e-5 (the same f32 ops in the
    same order); bf16 rtol 2e-2 (XLA may keep bf16 intermediates in f32
    where the plain version rounds each op)."""
    x = inputs()["x"]
    call = pl.pallas_call(functools.partial(cal_vpu()._prim_kernel, op=op, reps=R, d=D),
                          out_shape=jax.ShapeDtypeStruct(x.shape, jnp.dtype(dtype)),
                          interpret=True)
    want = np.asarray(call(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got = cal.prim_plain(torch.from_numpy(x).to(getattr(torch, dtype)), op, R)
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("mxu", [False, True])
def test_fwd_strip_plain_matches_cal_vpu(mxu):
    """The f32 forward body, head slot 0 (cal_vpu.py's output): rtol 1e-5
    (summation order only)."""
    i = inputs()
    want = jax_strip(cal_vpu()._fwd_strip_kernel, BM,
                     *(jnp.asarray(i[k]) for k in ("ld", "ls", "adj", "v")), mxu=mxu)
    got = cal.fwd_strip_plain(*(torch.from_numpy(i[k]) for k in ("ld", "ls", "adj", "v")), R, mxu)
    assert got.shape == (BM, 8 * D)
    np.testing.assert_allclose(got[:, :D].numpy(), want, rtol=1e-5)


def test_fwd_strip_bf16_plain_matches_cal_vpu():
    """The bf16 strip is the bf16 flash forward's body (v bf16, widened;
    everything else f32), so it is held to the f32 body _fwd_strip_kernel
    on v rounded to bf16 and widened back, head slot 0: rtol 1e-5
    (summation order only)."""
    i = inputs()
    v16 = jnp.asarray(i["v"]).astype(jnp.bfloat16).astype(jnp.float32)
    want = jax_strip(cal_vpu()._fwd_strip_kernel, BM,
                     *(jnp.asarray(i[k]) for k in ("ld", "ls", "adj")), v16, mxu=True)
    got = cal.fwd_strip_bf16_plain(*(torch.from_numpy(i[k]) for k in ("ld", "ls", "adj")),
                                   torch.from_numpy(i["v"]).bfloat16(), R)
    assert got.shape == (BM, 8 * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, :D].numpy(), want, rtol=1e-5)


def test_bwd_strip_plain_matches_cal_vpu():
    """The fused backward body: rtol 1e-5, atol 1e-5 (summation order of
    the row and column sums)."""
    i = inputs()
    want = jax_strip(cal_vpu()._bwd_strip_kernel, SUB,
                     *(jnp.asarray(i[k]) for k in ("ld", "ls", "adj", "v", "g")))
    got = cal.bwd_strip_plain(*(torch.from_numpy(i[k]) for k in ("ld", "ls", "adj", "v", "g")), R)
    np.testing.assert_allclose(got[:, :D].numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("body", ["fwd_strip", "fwd_strip_bf16", "bwd_strip"])
def test_strip_products_in_3xtf32_keep_f32_accuracy(body):
    """The strips with their products taken as the kernels take them
    (fg.mm_3xtf32: hi·hi + hi·lo + lo·hi of a TF32 split; with bf16 v,
    widened, lo is 0) stay within 1e-6 of the largest |value| of the same
    strips with exact products, on float64 inputs (the plain versions in
    float64, so only the products differ) at the kernels' 128×128 tile, R =
    16; with one TF32 product (fg.mm_1xtf32) they fall outside that, as
    chip_smoke.py's TF32 control requires of the card's tolerances."""
    i = {k: torch.from_numpy(v.astype(np.float64) if v.dtype != np.int8 else v)
         for k, v in cal.make_inputs(2, seed=5).items()}
    a = [i[k] for k in ("ld", "ls", "adj", "v")]
    if body == "fwd_strip":
        strip = lambda mm: cal.fwd_strip_plain(*a, R, mxu=True, mm=mm)
    elif body == "fwd_strip_bf16":
        strip = lambda mm: cal.fwd_strip_bf16_plain(*a[:3], a[3].bfloat16(), R, mm=mm)
    else:
        strip = lambda mm: cal.bwd_strip_plain(*a, i["g"], R, mm=mm)
    want = strip(torch.matmul)
    assert want.dtype == torch.float64 and want.shape == (2, cal.TILE, cal.HEADS * D)
    bound = 1e-6 * float(want.abs().max())
    err3 = float((strip(fg.mm_3xtf32) - want).abs().max())
    err1 = float((strip(fg.mm_1xtf32) - want).abs().max())
    assert err3 <= bound, (err3, bound)
    assert err1 > 10 * bound, (err1, bound)


def test_wrappers_refuse_what_they_cannot_launch():
    """The calibration times the card only: each wrapper raises on CPU
    tensors, on a pass count its kernel cannot unroll (the strips, the bf16
    one too, unroll 8 head slots) and on an unknown op, and never runs the
    plain version; every strip row of make_inputs holds an edge."""
    i = {k: torch.from_numpy(v) for k, v in cal.make_inputs(2, seed=1).items()}
    assert bool((i["adj"] != 0).any(dim=-1).all())
    a = [i[k] for k in ("ld", "ls", "adj", "v")]
    for call in (lambda: cal.prim_cuda(i["x"], "add", 4),
                 lambda: cal.fwd_strip_cuda(*a, 8),
                 lambda: cal.fwd_strip_bf16_cuda(*a[:3], a[3].bfloat16(), 8),
                 lambda: cal.bwd_strip_cuda(*a, i["g"], 8)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="multiple of 8"):
        cal.bwd_strip_cuda(*a, i["g"], 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        cal.fwd_strip_bf16_cuda(*a[:3], a[3].bfloat16(), 12)
    with pytest.raises(ValueError, match="unknown op"):
        cal.prim_cuda(i["x"], "tanh", 4)
    assert (cal.prim_launches + cal.fwd_strip_launches + cal.fwd_strip_bf16_launches
            + cal.bwd_strip_launches == 0)


def test_fold_check_flags_rates_above_the_ceiling():
    """check_ceilings names every rate above 105 % of its ceiling and every
    R -> 2R time ratio outside [1.9, 2.1] (a hoisted chain takes about as
    long for 2R passes as for R). The strip bodies, the bf16 one too,
    issue one ex2 an element, so their ceiling is the SFU rate; the packed
    bf16 primitives have twice the f32 lanes' rate."""
    ceil = cal.ceilings(132, 1.98e9)
    assert ceil["f32"] == pytest.approx(3.345e13, rel=1e-3)
    assert ceil["bf16"] == 2 * ceil["f32"]
    assert ceil["exp"] == pytest.approx(4.18e12, rel=1e-3)
    assert ceil["fwd_strip"] == ceil["bwd_strip"] == ceil["exp"]
    assert ceil["fwd_strip_bf16"] == ceil["exp"]
    result = {"ceilings_eps": ceil,
              "prim_rates_eps": {"add_f32": 1.04 * ceil["f32"], "exp_bf16": 1.1 * ceil["exp"]},
              "card_elems_per_s": {"fwd_strip_s": 1.04 * ceil["fwd_strip"],
                                   "fwd_strip_s_bf16_mxu": 1.06 * ceil["fwd_strip_bf16"],
                                   "bwd_strip_s_mxu": 2 * ceil["bwd_strip"]},
              "prim_scaling": {"add_f32": 1.99, "mul_bf16": 2.2},
              "scaling": {"fwd_strip_s": 1.02, "bwd_strip_s_mxu": 1.95}}
    bad = cal.check_ceilings(result)
    assert len(bad) == 5 and bad[0].startswith("exp_bf16")
    assert bad[1].startswith("fwd_strip_s_bf16_mxu") and "bwd_strip" in bad[2]
    assert bad[3].startswith("mul_bf16: t(2R)/t(R)") and bad[4].startswith("fwd_strip_s: t(2R)")


@pytest.mark.parametrize("n_strips, base", [(1056, 256), (1056, 2048), (8, 16)])
def test_strip_reps_keep_each_timing_long(n_strips, base):
    """Each strip body's R (bench_torch.py: 1,056 strips, base 256; the
    calibration run: base 2,048) is a multiple of the 8 heads the bodies
    unroll, never below the base (halved for the backward body), and long
    enough that t(R) is at least STRIP_MIN_S at the last measured time a
    pass; at the bench's shape every body gets more than its base (a scalar
    forward body's R = 256 ran 4.4 ms and once measured t(2R)/t(R) =
    1.8939; the flash tile bodies take 6-22 us a pass on 1,056 strips)."""
    for key, pass_s in cal.STRIP_PASS_S.items():
        r = cal.strip_reps(key, n_strips, base)
        floor = base // 2 if key == "bwd_strip_s_mxu" else base
        assert r % cal.HEADS == 0 and r >= floor, key
        t_r = r * pass_s * n_strips / cal.STRIP_PASS_STRIPS
        assert t_r >= cal.STRIP_MIN_S, key
        # the least such R: one step of 8 passes fewer falls short
        assert r == floor or (r - cal.HEADS) * pass_s * n_strips / cal.STRIP_PASS_STRIPS \
            < cal.STRIP_MIN_S, key
    assert cal.strip_reps("fwd_strip_s", 1056, 256) > 256
    assert cal.strip_reps("fwd_strip_s_bf16_mxu", 1056, 256) > 256
    assert cal.strip_reps("bwd_strip_s_mxu", 1056, 256) > 128
