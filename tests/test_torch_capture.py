"""The captured step's parts that the CPU can hold: the flash dropout seed as
a device tensor (the masks it gives are the int seed's, bit for bit, and
the backward replays the forward's), who may ask for capture, and the
bookkeeping of train/graphed.GraphedStep (static inputs, the generators it
registers, launch counts added once per replay) around a stand-in for
``torch.cuda.CUDAGraph``; the host sampler's and the inductive trainer's
steps around it (one step a block shape, each batch read only through
the step's static inputs); and that no step of a mesh format reads a
value back to the host or makes a tensor from host data. The capture
itself runs on the card (chip_smoke.py)."""

import contextlib
import gc
import hashlib
import weakref

import numpy as np
import pytest
import torch

from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from han_tpu_torch.datasets.ppi import ppi_synthetic
from han_tpu_torch.graph.bcsr import bcsr_from_dense
from han_tpu_torch.graph.containers import EllGraph
from han_tpu_torch.ops import flash_gat as fg
from han_tpu_torch.parallel.mesh import Axis, Mesh
from han_tpu_torch.train import graphed
from han_tpu_torch.train import inductive as tinductive
from han_tpu_torch.train import sampled as tsampled
from han_tpu_torch.train import trainer as ttrainer
from han_tpu_torch.train.config import preset as tpreset

# the inductive trainer's tests: a small ppi_synthetic and a narrow GAT
PPI = dict(n_graphs=7, nodes_per_graph=12, n_feats=6, n_labels=5, avg_degree=3.0, seed=2)
PPI_MODEL = dict(hid_units=(8, 8), n_heads=(2, 2, 3), residual=True, lr=0.01)

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
        delta = fg.head_delta(g, out, 2)
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


def _grouped_mesh(graph: int = 2) -> Mesh:
    """A mesh whose graph axis holds a process group (a stand-in object,
    no world): for the checks a trainer makes before its first
    collective."""
    one = Axis(None, (0,), 0, 1)
    return Mesh(graph=Axis(object(), tuple(range(graph)), 0, graph), heads=one, mp=one,
                rank=0, size=graph, device=torch.device("cpu"))


def test_who_may_ask_for_capture(tiny_ds, monkeypatch):
    """capture=None is on for a CUDA device whose mesh axes hold no process
    group (one device, or a mesh of one-rank axes) and off on the CPU or
    where an axis holds a group; True on the CPU raises ValueError, True
    where an axis holds a group NotImplementedError naming NCCL, from
    every trainer. The host sampler and a groupless mesh ask as one device
    does. The CPU trainers run eagerly with the default Adam."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    lone, grouped = Axis(None, (0,), 0, 1), _grouped_mesh().graph
    assert graphed.want_capture(None, cuda) and not graphed.want_capture(None, cpu)
    assert graphed.want_capture(None, cuda, (lone, lone, lone))
    assert graphed.want_capture(True, cuda, (lone,))
    assert not graphed.want_capture(None, cuda, (lone, grouped))
    assert not graphed.want_capture(False, cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        graphed.want_capture(True, cpu)
    with pytest.raises(NotImplementedError, match="NCCL"):
        graphed.want_capture(True, cuda, (lone, grouped))
    cfg = tpreset("dblp")
    with pytest.raises(ValueError, match="CUDA device"):
        ttrainer.Trainer(tiny_ds, cfg, device="cpu", capture=True)
    cfg.data.graph_format = "partitioned_bcsr"  # a mesh of one-rank axes
    with pytest.raises(ValueError, match="CUDA device"):
        ttrainer.Trainer(tiny_ds, cfg, device="cpu", capture=True)
    acm = tpreset("acm")
    for sampler in ("host", "device"):
        with pytest.raises(ValueError, match="CUDA device"):
            tsampled.SampledTrainer(tiny_ds, acm, batch_size=8, fanout=3, sampler=sampler,
                                    device="cpu", capture=True)
    # an axis with a process group
    monkeypatch.setattr(ttrainer, "make_mesh", lambda **kw: _grouped_mesh())
    with pytest.raises(NotImplementedError, match="NCCL"):
        ttrainer.Trainer(tiny_ds, cfg, device="cpu", capture=True)
    with pytest.raises(NotImplementedError, match="NCCL"):
        tsampled.DPSampledTrainer(tiny_ds, acm, mesh=_grouped_mesh(), batch_size=8, fanout=3,
                                  capture=True)
    with pytest.raises(NotImplementedError, match="NCCL"):
        tinductive.InductiveTrainer(ppi_synthetic(**PPI), mesh=_grouped_mesh(), capture=True,
                                    **PPI_MODEL)
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


@pytest.mark.parametrize("module", ["flash_gat", "ell_fused", "tree_ell"])
def test_counters_name_every_launch_count(module):
    """Every launch count a kernel module keeps (an int attribute ending in
    ``_launches``) is in graphed.COUNTERS, so that a capture puts it back
    and a replay adds its gain: one left out would count the capture's
    wrapper calls, which launch nothing, and miss every replay."""
    mod = getattr(graphed, module)
    counts = {name for name, x in vars(mod).items()
              if name.endswith("_launches") and isinstance(x, int)}
    assert counts and counts <= {name for m, name in graphed.COUNTERS if m is mod}


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


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Derived(TorchDispatchMode):
    """Follows the data of ``sources`` through every op run under it:
    ``storages`` holds the storage of each tensor computed from them (or
    from a tensor computed from them)."""

    def __init__(self, sources):
        super().__init__()
        self.storages = {_storage(t) for t in sources if t.numel()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.numel() and _storage(t) in self.storages
               for t in tree_leaves((args, kwargs))):
            self.storages.update(_storage(t) for t in tree_leaves(out)
                                 if isinstance(t, torch.Tensor) and t.numel())
        return out


def _sampled_cfg():
    cfg = tpreset("acm")
    cfg.model.impl = "ell_fused"
    cfg.model.hid_units, cfg.model.n_heads = (8,), (4, 1)
    return cfg


# (trainer keywords, whether the block indices are int16)
HOST_CASES = {"resident features, int16 indices": (dict(resident_features=True), True),
              "streamed features, int32 indices": (dict(resident_features=False,
                                                        block_size=2 ** 15), False)}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_sampler_step_reads_its_batch_through_its_static_inputs(
        fake_cuda_graph, monkeypatch, tiny_ds, case):
    """The host sampler's train and evaluation steps around the stand-in
    graph: one step a (block_size, fanout, resident) key; the first batch
    runs eagerly, the second is captured, and every batch's pinned tensors
    are copied into the step's static inputs, int16 indices included.
    Every tensor the captured body hands the model and the loss (the
    EllGraphs' nbr and deg, the feature rows, labels and mask) is computed
    from those static inputs, and shares their storage where no widening
    copies it: a body that read its batch any other way would train every
    replay on the captured batch. The replays run no Python."""
    kw, int16 = HOST_CASES[case]
    t = tsampled.SampledTrainer(tiny_ds, _sampled_cfg(), batch_size=8, fanout=3, device="cpu",
                                logger=ttrainer.MetricLogger(echo=False), **kw)
    t.capture = True  # the stand-in graph captures on the CPU
    seen = []
    materialize = t._materialize
    monkeypatch.setattr(t, "_materialize", lambda *a: seen.append(materialize(*a)) or seen[-1])
    idx = np.where(tiny_ds.train_mask)[0]
    batches = [t._make_batch(seeds, valid, 11 + i) for i, (seeds, valid) in
               zip(range(4), t._seed_batches(idx, shuffle=True, epoch=0))]
    key = (t.block_size, 3, t.resident)
    t._train_call(batches[0])  # eager
    (step,) = t._train_steps.values()
    assert list(t._train_steps) == [key] and step.generators == (t.rngs.device,)
    tracked = []

    @contextlib.contextmanager
    def capture(graph, capture_error_mode="global"):
        with _Derived(step.inputs) as derived:
            tracked.append(derived)
            yield

    monkeypatch.setattr(torch.cuda, "graph", capture)
    seen.clear()
    for b in batches[1:]:  # captured, then replayed
        t._train_call(b)
        flat = b[0].flat()
        assert [x.dtype for x in step.inputs] == [x.dtype for x in flat]
        assert all(torch.equal(buf, x) for buf, x in zip(step.inputs, flat))
    assert step.replays == 3 and len(seen) == 1 and len(tracked) == 1
    assert step.inputs[0].dtype == (torch.int16 if int16 else torch.int32)
    graphs, xs, labels, mask, _ = seen[0]
    derived = tracked[0].storages
    p = len(graphs)
    for t_ in [*(g.nbr for g in graphs), *(g.deg for g in graphs), *xs, labels, mask]:
        assert _storage(t_) in derived
    assert _storage(mask) == _storage(step.inputs[-1])
    if not int16:  # nothing widens: the graphs are the static buffers
        for i, g in enumerate(graphs):
            assert _storage(g.nbr) == _storage(step.inputs[3 * i])
            assert _storage(g.deg) == _storage(step.inputs[3 * i + 1])
            assert _storage(xs[i]) == _storage(step.inputs[3 * i + 2])
        assert _storage(labels) == _storage(step.inputs[3 * p])
    # evaluation: one step a key, captured at its second call
    for b in batches[:3]:
        t._eval_call(b)
    (ev,) = t._eval_steps.values()
    assert list(t._eval_steps) == [key] and ev.replays == 2
    assert all(torch.equal(buf, x) for buf, x in zip(ev.inputs, batches[2][0].flat()))


@pytest.mark.parametrize("resident", [True, False])
def test_host_sampler_eager_step_is_the_upload_path(tiny_ds, resident):
    """With capture=False the host sampler's step (flat tensors, the
    EllGraphs built inside the body) gives bitwise the losses of the eager
    path it replaces, which built each block's EllGraphs when it uploaded
    the batch: three batches, two trainers from the same seeds, dropout
    0.6."""
    kw = dict(batch_size=8, fanout=3, device="cpu", capture=False, resident_features=resident,
              logger=ttrainer.MetricLogger(echo=False))
    new = tsampled.SampledTrainer(tiny_ds, _sampled_cfg(), **kw)
    old = tsampled.SampledTrainer(tiny_ds, _sampled_cfg(), **kw)
    idx = np.where(tiny_ds.train_mask)[0]
    got, want = [], []
    for i, (seeds, valid) in zip(range(3), new._seed_batches(idx, shuffle=True, epoch=0)):
        got.append(new._train_call(new._make_batch(seeds, valid, 5 + i))[0].item())
        host = old._prepare(seeds, valid, 5 + i)
        graphs = [EllGraph(nbr=nb.int(), deg=dg.int(), n_nodes=host.block_size,
                           n_edges=host.block_size * host.fanout)
                  for nb, dg in zip(host.nbrs, host.degs)]
        want.append(old._train_step(graphs, host.xs, host.labels, host.mask)[0].item())
    assert got == want and len(set(got)) == 3
    assert list(new._train_steps) == [(new.block_size, 3, resident)]


def test_inductive_steps_go_through_graphed_steps(fake_cuda_graph, monkeypatch):
    """The inductive trainer's train step and evaluation batches run
    through GraphedSteps, one a batch shape, the train step registering the
    dropout generator: eagerly on the CPU, with the default Adam. Where it
    captures, Adam is capturable, and the stand-in graph captures an
    evaluation step at its second call and replays it."""
    ds = ppi_synthetic(**PPI)
    t = tinductive.InductiveTrainer(ds, batch_size=2, device="cpu", seed=4, attn_drop=0.2,
                                    **PPI_MODEL)
    assert t.capture is False and t.opt.defaults["capturable"] is False
    result = t.fit(epochs=2)
    n_train = -(-ds.split("train")[0].shape[0] // 2)
    (step,) = t._train_steps.values()
    assert step.generators == (t.rngs.device,) and step.calls == 2 * n_train
    assert step.replays == 0 and not result["captured"] and len(t._eval_steps) == 1
    monkeypatch.setattr(tinductive, "want_capture", lambda capture, device, axes: True)
    c = tinductive.InductiveTrainer(ds, batch_size=2, device="cpu", seed=4, **PPI_MODEL)
    assert c.capture and c.opt.defaults["capturable"]
    first = c.evaluate("val")
    assert c.evaluate("val") == first and c.evaluate("val") == first
    (ev,) = c._eval_steps.values()
    n_val = -(-ds.split("val")[0].shape[0] // 2)
    assert ev.graph is not None and ev.calls == 3 * n_val and ev.replays == 3 * n_val - 1


# the ways a step reads a device value back to the host, and makes a tensor
# from host data (a copy to the card, which a captured graph cannot hold)
HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")
HOST_DATA = ("tensor", "as_tensor", "from_numpy")
# the CPU stand-ins of the kernels, which the card does not run
PLAIN = ("flash_fwd_plain", "flash_bwd_plain", "flash_bwd_row_plain", "flash_bwd_col_plain")


def _record_host_traffic(monkeypatch, calls: list) -> None:
    """Every HOST_READS method of a tensor and every HOST_DATA constructor
    called outside the kernels' plain versions appends its name to
    ``calls``."""
    inside = [0]

    def recording(name, fn):
        def wrapped(*a, **kw):
            if not inside[0]:
                calls.append(name)
            return fn(*a, **kw)
        return wrapped

    def plain(fn):
        def wrapped(*a, **kw):
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return wrapped

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, recording(name, getattr(torch.Tensor, name)))
    for name in HOST_DATA:
        monkeypatch.setattr(torch, name, recording(f"torch.{name}", getattr(torch, name)))
    for name in PLAIN:
        monkeypatch.setattr(fg, name, plain(getattr(fg, name)))


MESH_FORMATS = {"partitioned_bcsr": ("partitioned_bcsr", False),
                "ring_bcsr": ("ring_bcsr", False), "csr partitioned": ("partitioned", False),
                "csr ring": ("ring", False),
                "partitioned_bcsr stacked": ("partitioned_bcsr", True)}


@pytest.mark.parametrize("case", [*MESH_FORMATS, "host sampler", "inductive",
                                  "inductive sparse"])
def test_steps_read_nothing_back_to_the_host(tiny_ds, monkeypatch, case):
    """A train step (Adam's update aside: PyTorch's capturable Adam) and an
    evaluation of every format a one-rank mesh runs (the dblp preset,
    dropout 0.6), of the host sampler and of the inductive trainer neither
    read a device value back to the host nor make a tensor from host data:
    either would fail or be frozen inside a captured graph. The kernels'
    plain versions, which stand in for them on the CPU, are left out. The
    inductive trainer's sparse step builds its union's container from the
    static inputs' shapes alone."""
    quiet = ttrainer.MetricLogger(echo=False)
    if case in MESH_FORMATS:
        cfg = tpreset("dblp")
        cfg.data.graph_format, cfg.model.vmap_towers = MESH_FORMATS[case]
        t = ttrainer.Trainer(tiny_ds, cfg, device="cpu", logger=quiet)
        assert t.mesh is not None and t.mesh.graph.group is None
        train, evaluate = t._train_body, lambda: t._eval_body(t.masks["val"])
    elif case == "host sampler":
        t = tsampled.SampledTrainer(tiny_ds, _sampled_cfg(), batch_size=8, fanout=3,
                                    device="cpu", logger=quiet)
        flat = t._make_batch(np.arange(8, dtype=np.int32), np.ones(8, bool), 3)[0].flat()
        train = lambda: t._host_train_body(*flat)
        evaluate = lambda: t._host_eval_body(*flat)
    else:
        # the sparse case through csr: the flash kernels' plain versions are
        # left out, and csr's segment ops are all torch
        fmt = dict(impl="csr") if case == "inductive sparse" else {}
        t = tinductive.InductiveTrainer(ppi_synthetic(**PPI), batch_size=2, device="cpu",
                                        attn_drop=0.2, ffd_drop=0.2, **fmt, **PPI_MODEL)
        batch = next(t.batches("train"))
        train, evaluate = lambda: t._train_body(*batch), lambda: t._eval_body(*batch)
    train()  # the first step makes Adam's state
    monkeypatch.setattr(t.opt, "step", lambda: None)
    calls = []
    _record_host_traffic(monkeypatch, calls)
    train()
    evaluate()
    monkeypatch.undo()
    assert calls == []
