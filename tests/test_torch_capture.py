"""The captured step's parts that the CPU can hold: the flash dropout seed as
a device tensor (the masks it gives are the int seed's, bit for bit, and
the backward replays the forward's), who may ask for capture, and the
bookkeeping of train/graphed.GraphedStep (static inputs, the generators it
registers, launch counts added once per replay) around a stand-in for
``torch.cuda.CUDAGraph``. The capture itself runs on the card
(chip_smoke.py)."""

import contextlib
import gc
import hashlib
import weakref

import numpy as np
import pytest
import torch

from han_tpu_torch.graph.bcsr import bcsr_from_dense
from han_tpu_torch.ops import flash_gat as fg
from han_tpu_torch.train import graphed
from han_tpu_torch.train import sampled as tsampled
from han_tpu_torch.train import trainer as ttrainer
from han_tpu_torch.train.config import preset as tpreset

# dropout_keep(seed, rows 3 + 7i (200), columns 11 + 5j (300), head, p) as
# the int seed gave it before the seed became a tensor: (kept count,
# sha256 of the packed mask, first 16 hex digits)
MASK_PRINTS = {(1234567, 3, 0.35): (39064, "c51024d7aefe8730"),
               (2 ** 31 - 2, 0, 0.6): (24036, "2dc5531c95ce9eb1"),
               (5, 7, 0.1): (53933, "103efd09b869fec6")}


def _print(keep: torch.Tensor):
    k = keep.numpy()
    return int(k.sum()), hashlib.sha256(np.packbits(k).tobytes()).hexdigest()[:16]


def test_tensor_seed_gives_the_int_seeds_masks():
    """dropout_keep with the seed as a one-element int32 tensor gives the
    masks the int seed gave (fingerprints taken before the change), and
    seed_tensor keeps all 32 bits (a seed >= 2**31 is held as a negative
    int32)."""
    rows = torch.arange(200) * 7 + 3
    cols = torch.arange(300) * 5 + 11
    for (seed, head, p), want in MASK_PRINTS.items():
        assert _print(fg.dropout_keep(seed, rows, cols, head, p)) == want
        assert _print(fg.dropout_keep(fg.seed_tensor(seed, "cpu"), rows, cols, head, p)) == want
    big = fg.seed_tensor(2 ** 32 - 3, "cpu")
    assert big.dtype == torch.int32 and big.shape == (1,) and int(big) == -3
    assert torch.equal(fg.dropout_keep(big, rows, cols, 1, 0.5),
                       fg.dropout_keep(2 ** 32 - 3, rows, cols, 1, 0.5))


def _flash_case(seed=3):
    rng = np.random.default_rng(seed)
    a = (rng.random((70, 70)) < 0.2).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    graph = bcsr_from_dense(a, bm=32, bn=32)
    n, k, d = graph.n_pad, 2, 4
    f64 = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float64)
    return graph, f64(k, n), f64(k, n), f64(n, k * d), f64(n, k * d)


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_plain_flash_with_a_tensor_seed_matches_the_int_seed(p):
    """The plain forward, fused backward and both sweeps give bitwise the
    same outputs with the seed as a tensor as with the same seed as an int
    (float64 inputs)."""
    graph, ld, ls, v, g = _flash_case()
    outs = []
    for seed in (424242, fg.seed_tensor(424242, "cpu")):
        meta = fg.FlashMeta(dropout_p=p, seed=seed, head_offset=1)
        out, lse = fg.flash_fwd_plain(graph, ld, ls, v, meta)
        delta = (g * out).view(g.shape[0], 2, -1).sum(-1).T.contiguous()
        args = (graph, ld, ls, v, g, lse, delta, meta)
        outs.append([out, lse, *fg.flash_bwd_plain(*args), fg.flash_bwd_row_plain(*args),
                     *fg.flash_bwd_col_plain(*args)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_backward_replays_the_forward_seed(monkeypatch):
    """flash_gat_attention draws one seed tensor a call, from the device
    generator; the backward replays it and draws nothing: the gradients
    equal autograd through the plain forward with that tensor. Two draws
    from one generator differ; a generator seeded alike draws alike."""
    graph, ld, ls, v, _ = _flash_case(seed=5)
    n, k = 70, 2
    fts = v[:n].float().view(n, k, 4).requires_grad_()
    ldst = ld[:, :n].T.float().contiguous().requires_grad_()
    lsrc = ls[:, :n].T.float().contiguous().requires_grad_()
    drawn = []
    draw = fg.draw_seed
    monkeypatch.setattr(fg, "draw_seed", lambda p, gen: drawn.append(draw(p, gen)) or drawn[-1])
    gen = torch.Generator().manual_seed(9)
    out = fg.flash_gat_attention(graph, fts, ldst, lsrc, coef_dropout=0.5, generator=gen)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad((out * w).sum(), (fts, ldst, lsrc))
    assert len(drawn) == 1 and drawn[0].dtype == torch.int32 and drawn[0].shape == (1,)
    meta = fg.FlashMeta(dropout_p=0.5, seed=drawn[0])
    pad = graph.n_pad - n
    ref, _ = fg.flash_fwd_plain(
        graph, torch.nn.functional.pad(ldst.T, (0, pad)),
        torch.nn.functional.pad(lsrc.T, (0, pad)),
        torch.nn.functional.pad(fts.reshape(n, k * 4), (0, 0, 0, pad)), meta)
    want = torch.autograd.grad((ref[:n].view(n, k, 4) * w).sum(), (fts, ldst, lsrc))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    second = fg.draw_seed(0.5, gen)
    assert int(second) != int(drawn[0])
    again = torch.Generator().manual_seed(9)
    assert [int(fg.draw_seed(0.5, again)) for _ in range(2)] == [int(drawn[0]), int(second)]
    assert fg.draw_seed(0.0, gen) == 0


def test_kernel_path_reads_the_seed_from_device_memory():
    """The kernels take the seed's address: an int seed with dropout on is
    refused (no host-side seed reaches a launch), dropout off passes a null
    pointer."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="device memory"):
        fg._seed_ptr(fg.FlashMeta(dropout_p=0.5, seed=3), cpu)
    with pytest.raises(ValueError, match="int32"):
        fg._seed_ptr(fg.FlashMeta(dropout_p=0.5, seed=torch.zeros(1, dtype=torch.int64)), cpu)
    assert fg._seed_ptr(fg.FlashMeta(dropout_p=0.0, seed=3), cpu) is None
    t = fg.seed_tensor(3, cpu)
    assert fg._seed_ptr(fg.FlashMeta(dropout_p=0.5, seed=t), cpu) == t.data_ptr()


def test_who_may_ask_for_capture(tiny_ds):
    """capture=None is on for one CUDA device and off on the CPU or where
    the run is not ported to capture; True on the CPU raises ValueError,
    True on a mesh or with the host sampler NotImplementedError. The CPU
    trainers run eagerly with the default Adam."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graphed.want_capture(None, cuda) and not graphed.want_capture(None, cpu)
    assert not graphed.want_capture(None, cuda, "mesh") and not graphed.want_capture(False, cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        graphed.want_capture(True, cpu)
    with pytest.raises(NotImplementedError, match="mesh"):
        graphed.want_capture(True, cuda, "mesh")
    cfg = tpreset("dblp")
    with pytest.raises(ValueError, match="CUDA device"):
        ttrainer.Trainer(tiny_ds, cfg, device="cpu", capture=True)
    cfg.data.graph_format = "partitioned_bcsr"
    with pytest.raises(NotImplementedError, match="mesh runs eagerly"):
        ttrainer.Trainer(tiny_ds, cfg, device="cpu", capture=True)
    acm = tpreset("acm")
    with pytest.raises(NotImplementedError, match="host sampler"):
        tsampled.SampledTrainer(tiny_ds, acm, batch_size=8, fanout=3, device="cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tsampled.SampledTrainer(tiny_ds, acm, batch_size=8, fanout=3, sampler="device",
                                device="cpu", capture=True)
    t = ttrainer.Trainer(tiny_ds, tpreset("dblp"), device="cpu",
                         logger=ttrainer.MetricLogger(echo=False))
    assert t.capture is False and t.opt.defaults["capturable"] is False
    # the trainers' graphed steps hold them weakly: a dropped trainer (and
    # on the card its graphs' memory pools) goes at once, with no collector
    gc.disable()
    try:
        ref = weakref.ref(t)
        float(t.train_step()[0])
        del t
        assert ref() is None
        st = tsampled.SampledTrainer(tiny_ds, acm, batch_size=8, fanout=3, sampler="device",
                                     device="cpu", logger=ttrainer.MetricLogger(echo=False))
        ref = weakref.ref(st)
        del st
        assert ref() is None
    finally:
        gc.enable()


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: records registered generators
    and replays."""

    made = []

    def __init__(self):
        self.generators, self.replays = [], 0
        _FakeGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda_graph(monkeypatch):
    _FakeGraph.made = []
    modes = []

    @contextlib.contextmanager
    def capture(graph, capture_error_mode="global"):
        modes.append(capture_error_mode)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return modes


def test_graphed_step_counts_launches_once_per_replay(fake_cuda_graph, monkeypatch):
    """GraphedStep: the warm-up call runs the body eagerly; the next call
    captures (the body runs once, launching nothing: the counters it moved
    are put back) and replays; every replay adds the captured launches
    once, copies the new input into the static buffer and returns the
    capture's outputs. The generators are registered with the graph, the
    capture mode is thread_local, a changed input shape and a failing
    capture raise, and the counters stay as they were when it fails."""
    monkeypatch.setattr(fg, "flash_fwd_launches", 0)
    monkeypatch.setattr(fg, "flash_bwd_launches", 0)
    bodies = []

    def body(x):
        bodies.append(x)
        fg.flash_fwd_launches += 3
        fg.flash_bwd_launches += 1
        return x * 2

    gen = torch.Generator()
    step = graphed.GraphedStep(body, capture=True, device=torch.device("cpu"), generators=[gen])
    x0, x1, x2 = (torch.full((4,), float(i)) for i in range(3))
    assert torch.equal(step(x0), x0 * 2) and fg.flash_fwd_launches == 3  # eager
    out = step(x1)  # capture + replay
    (graph,) = _FakeGraph.made
    assert graph.generators == [gen] and graph.replays == 1 and fake_cuda_graph == ["thread_local"]
    assert (fg.flash_fwd_launches, fg.flash_bwd_launches) == (6, 2)
    assert bodies[-1] is step.inputs[0] and torch.equal(out, x1 * 2)
    assert step(x2) is out and torch.equal(step.inputs[0], x2)  # replay: static buffers
    assert (fg.flash_fwd_launches, fg.flash_bwd_launches, graph.replays, step.replays) == (9, 3, 2, 2)
    assert len(bodies) == 2
    with pytest.raises(ValueError, match="captured input"):
        step(torch.zeros(5))

    def broken(x):
        fg.flash_fwd_launches += 5
        raise RuntimeError("capture refused")

    failing = graphed.GraphedStep(broken, capture=True, device=torch.device("cpu"), warmup=0)
    with pytest.raises(RuntimeError, match="capture refused"):
        failing(x0)
    assert fg.flash_fwd_launches == 9
    eager = graphed.GraphedStep(body, capture=False, device=torch.device("cpu"))
    for _ in range(3):
        eager(x0)
    assert len(_FakeGraph.made) == 2 and fg.flash_fwd_launches == 18


def test_device_time_skips_annotation_ranges():
    """utils/prof.device_events keeps kernels, copies and fills and drops a
    record_function range shown on the device (Optimizer.step#Adam.step
    spans Adam's kernels: summing it counts them twice) and host events."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from han_tpu_torch.utils.prof import device_events

    ev = lambda key, dev, annot=False: SimpleNamespace(key=key, device_type=dev,
                                                       is_user_annotation=annot)
    events = [ev("fwd_kernel", DeviceType.CUDA), ev("Memcpy DtoH", DeviceType.CUDA),
              ev("Optimizer.step#Adam.step", DeviceType.CUDA, True),
              ev("aten::mm", DeviceType.CPU)]
    assert [e.key for e in device_events(events)] == ["fwd_kernel", "Memcpy DtoH"]
