"""Rank bodies of tests/test_torch_parallel.py, test_torch_mesh_grid.py,
test_torch_mp.py, test_torch_dp_sampled.py and test_torch_dp_inductive.py:
each runs inside one process of a spawned gloo world
(han_tpu_torch.parallel.launch.spawn) and returns numpy results for the
test process, which holds them against han_tpu. This module imports torch
and the port only, so the ranks never load jax."""

import torch

from han_tpu_torch.graph.bcsr import bcsr_from_scipy
from han_tpu_torch.graph.build import metapath_to_csr
from han_tpu_torch.graph.synthetic import planted_hetero
from han_tpu_torch.nn.models import HAN
from han_tpu_torch.ops import flash_gat as fg
from han_tpu_torch.parallel import dryrun
from han_tpu_torch.parallel.edge_partition import partition_csr
from han_tpu_torch.parallel.flash_shard import partition_bcsr, sharded_flash_attention
from han_tpu_torch.parallel.mesh import Axis, Mesh, make_mesh
from han_tpu_torch.parallel.ring_attn import partition_csr_2d, ring_attention
from han_tpu_torch.parallel.ring_bcsr import ring_flash_attention, ring_partition_bcsr
from han_tpu_torch.parallel.shard_attn import partitioned_attention
from han_tpu_torch.train import trainer as ttrainer
from han_tpu_torch.train.config import preset
from han_tpu_torch.train.inductive import InductiveTrainer
from han_tpu_torch.train.sampled import DPSampledTrainer

BACKENDS = {"sharded": (partition_bcsr, sharded_flash_attention),
            "ring": (ring_partition_bcsr, ring_flash_attention)}


def _csr(adj):
    return metapath_to_csr(adj, add_self_loops=False, edge_pad_to=32)


# the four partitioned backends: (partitioner of (adj, shards, bm, bn),
# attention); the csr ones on the adjacency as given (no added self-loops)
GRID_BACKENDS = {
    "partitioned_bcsr": (lambda a, s, bm, bn: partition_bcsr(a, s, bm=bm, bn=bn),
                         sharded_flash_attention),
    "ring_bcsr": (lambda a, s, bm, bn: ring_partition_bcsr(a, s, bm=bm, bn=bn),
                  ring_flash_attention),
    "csr": (lambda a, s, bm, bn: partition_csr(_csr(a), s, edge_pad_to=32),
            partitioned_attention),
    "ring": (lambda a, s, bm, bn: partition_csr_2d(_csr(a), s, pad_to=32), ring_attention),
}


def out_and_grads(fn, fts, ld, ls, w, dtype=torch.float32, dtypes=None):
    """fn's output and d(sum(out·w))/d(fts, ld, ls), as float32 numpy; the
    features in ``dtype``. ``dtypes`` (a list) gets the output's and the
    features' gradient's dtype names."""
    args = ([torch.tensor(fts, dtype=dtype, requires_grad=True)]
            + [torch.tensor(x, requires_grad=True) for x in (ld, ls)])
    out = fn(*args)
    grads = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), args)
    if dtypes is not None:
        dtypes.append((str(out.dtype), str(grads[0].dtype)))
    return [out.detach().float().numpy()] + [g.float().numpy() for g in grads]


def attention(case, p, dtype=torch.float32):
    """Both backends on case's inputs (the features in ``dtype``), at
    coefficient dropout p (seed drawn from a generator seeded 11); for p > 0
    or bf16 features also the port's one-device flash with the same
    generator; "dtypes" lists each run's output and feature-gradient
    dtypes."""
    adj, bm, bn = case["adj"], case["bm"], case["bn"]
    x = (case["fts"], case["ld"], case["ls"], case["w"])
    gen = lambda: torch.Generator().manual_seed(11)
    res = {"dtypes": []}
    s_n = make_mesh(graph=0).size
    for name, (part, attn) in BACKENDS.items():
        graph = part(adj, s_n, bm=bm, bn=bn)
        res[name] = out_and_grads(
            lambda *a: attn(graph, *a, coef_dropout=p, generator=gen()), *x, dtype=dtype,
            dtypes=res["dtypes"])
    if p or dtype != torch.float32:
        single = bcsr_from_scipy(adj, bm=bm, bn=bn)
        res["single"] = out_and_grads(lambda *a: fg.flash_gat_attention(
            single, *a, coef_dropout=p, generator=gen()), *x, dtype=dtype,
            dtypes=res["dtypes"])
    return res


def han_logits(han):
    """HAN logits with the converted flax weights, dropout off, on both
    partitioned formats."""
    s_n = make_mesh(graph=0).size
    x = torch.from_numpy(han["features"])
    out = {}
    for name, (part, _) in BACKENDS.items():
        graphs = [part(a, s_n, bm=han["bm"], bn=han["bn"]) for a in han["adjs"]]
        model = HAN(x.shape[1], han["n_classes"], len(graphs), hid_units=(8,),
                    n_heads=(4, 1))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in han["state"].items()})
        with torch.no_grad():
            out[name] = model(graphs, [x] * len(graphs))[0].numpy()
    return out


def trainer_cfg(fmt, graph_axis, epochs, mp_axis=1):
    """The dblp preset (full widths, dropouts 0.6) at 64×64 tiles; an mp
    axis runs the towers stacked (vmap_towers)."""
    cfg = preset("dblp")
    cfg.data.graph_format = fmt
    cfg.data.tile_bm = cfg.data.tile_bn = 64
    cfg.mesh.graph_axis = graph_axis
    cfg.mesh.mp_axis = mp_axis
    cfg.model.vmap_towers = mp_axis > 1
    cfg.train.epochs = epochs
    return cfg


def trainer_ds(n_metapaths=2):
    return planted_hetero(n_nodes=250, n_feats=24, n_classes=3, n_metapaths=n_metapaths,
                          avg_degree=10.0, train_per_class=20, n_val=30, seed=5)


def train(fmt, graph_axis, epochs, mp_axis=1, n_metapaths=2, vmap_towers=None):
    """Trainer.fit on the trainer dataset; the train losses, the test loss
    and the final parameters."""
    cfg = trainer_cfg(fmt, graph_axis, epochs, mp_axis)
    if vmap_towers is not None:
        cfg.model.vmap_towers = vmap_towers
    t = ttrainer.Trainer(trainer_ds(n_metapaths), cfg, device="cpu",
                         logger=ttrainer.MetricLogger(echo=False))
    result = t.fit()
    return {"losses": result["epoch_train_loss"], "test_loss": result["test_loss"],
            "state": {k: v.numpy().copy() for k, v in t.model.state_dict().items()}}


def grid_checks(case):
    """A graph 2 × heads 2 grid: the four partitioned backends on case's
    inputs at dropout 0 and 0.4 (seed from a generator seeded 11), the
    port's one-device flash at 0.4, the mesh's axes, and the dry run."""
    mesh = make_mesh(graph=2, heads=2)
    x = (case["fts"], case["ld"], case["ls"], case["w"])
    gen = lambda: torch.Generator().manual_seed(11)
    res = {"axes": {name: (ax.rank, ax.size, ax.ranks) for name, ax in
                    (("mp", mesh.mp), ("graph", mesh.graph), ("heads", mesh.heads))}}
    for p in (0.0, 0.4):
        for name, (part, attn) in GRID_BACKENDS.items():
            graph = part(case["adj"], 2, case["bm"], case["bn"])
            res[name, p] = out_and_grads(
                lambda *a: attn(graph, *a, mesh=mesh, coef_dropout=p, generator=gen()), *x)
    single = bcsr_from_scipy(case["adj"], bm=case["bm"], bn=case["bn"])
    res["single", 0.4] = out_and_grads(lambda *a: fg.flash_gat_attention(
        single, *a, coef_dropout=0.4, generator=gen()), *x)
    res["dryrun"] = dryrun.dryrun_step()
    return res


def mp_checks(runs, epochs):
    """Trainer.fit for each (format, graph axis, mp axis, meta-paths) of
    ``runs`` on the world's ranks."""
    return {run: train(run[0], run[1], epochs, mp_axis=run[2], n_metapaths=run[3])
            for run in runs}


def world_checks(case, han, epochs):
    """Everything one world checks; ``han`` and ``epochs`` are None in the
    worlds that skip the HAN and trainer checks."""
    res = {"attention": attention(case, 0.0), "dropout": attention(case, 0.4),
           "bf16": attention(case, 0.0, torch.bfloat16),
           "bf16_dropout": attention(case, 0.4, torch.bfloat16),
           "dryrun": dryrun.dryrun_step()}
    if han is not None:
        res["han"] = han_logits(han)
    if epochs:
        res["train"] = {fmt: train(fmt, make_mesh(graph=0).size, epochs)
                        for fmt in ("partitioned_bcsr", "ring_bcsr")}
    return res



def stand_in_mesh(graph: int, device="cpu") -> Mesh:
    """A mesh whose graph axis claims ``graph`` ranks with no process group
    (rank 0): for the checks a trainer makes before its first collective."""
    one = Axis(None, (0,), 0, 1)
    return Mesh(graph=Axis(None, tuple(range(graph)), 0, graph), heads=one, mp=one, rank=0,
                size=graph, device=torch.device(device))


def sampled_cfg(fanout, epochs, dropout=0.0):
    """The acm preset (L2 1e-3) at hid 8, heads (4, 1), through ell, seed
    batches of 16 sampled at ``fanout``."""
    cfg = preset("acm")
    cfg.model.impl = "ell"
    cfg.model.hid_units, cfg.model.n_heads = (8,), (4, 1)
    cfg.model.attn_drop = cfg.model.ffd_drop = dropout
    cfg.train.epochs, cfg.train.patience, cfg.train.log_file = epochs, 50, ""
    cfg.train.batch_size, cfg.train.fanout = 16, fanout
    return cfg


def _state(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def dp_sampled_checks(ds, state, batches, fanout, root):
    """DPSampledTrainer on this world's graph axis: train steps on
    ``batches`` ((seeds, valid, sample seed) each, block 8·(fanout+1) a
    shard) from the parameters ``state``, with their global loss and
    accuracy and the parameters after; run() with mesh.graph_axis = the
    world (2 epochs, dropout 0), with the device sampler (the message it
    raises), and a 3-epoch run at dropout 0.6 uninterrupted and again as 2
    epochs saved every epoch under ``root`` then resumed in a fresh
    trainer."""
    mesh = make_mesh(graph=0)
    quiet = ttrainer.MetricLogger(echo=False)
    t = DPSampledTrainer(ds, sampled_cfg(fanout, 1), mesh=mesh, batch_size=16, fanout=fanout,
                         block_size=8 * (fanout + 1), logger=quiet)
    t.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    steps = []
    for seeds, valid, sample_seed in batches:
        loss, acc, _ = t._train_step(*t._make_batch(seeds, valid, sample_seed))
        steps.append((float(loss), float(acc)))
    res = {"steps": steps, "state": _state(t.model)}
    cfg = sampled_cfg(fanout, 2)
    cfg.train.sampled, cfg.mesh.graph_axis = True, mesh.size
    cfg.train.checkpoint_dir = f"{root}/run"
    r = ttrainer.run(cfg, ds, device="cpu")
    res["run"] = {"losses": r["epoch_train_loss"], "test": (r["test_loss"], r["test_acc"])}
    cfg.train.sampler = "device"
    try:
        ttrainer.run(cfg, ds, device="cpu")
    except NotImplementedError as e:
        res["device_sampler"] = str(e)
    runs = {}
    for name, epochs, resume in (("uninterrupted", 3, False), ("first", 2, False),
                                 ("resumed", 3, True)):
        cfg = sampled_cfg(fanout, epochs, dropout=0.6)
        cfg.train.checkpoint_every = 1
        cfg.train.checkpoint_dir = f"{root}/{'a' if name == 'uninterrupted' else 'b'}"
        t = DPSampledTrainer(ds, cfg, mesh=mesh, batch_size=16, fanout=fanout, logger=quiet)
        r = t.fit(resume=resume)
        runs[name] = {"losses": r["epoch_train_loss"], "state": _state(t.model)}
    res["resume"] = runs
    return res


# the inductive checks' model: han_tpu's test_inductive_mesh_dp_matches_single_device
# widths, with L2 on
INDUCTIVE = dict(hid_units=(8,), n_heads=(2, 2), lr=0.02, l2_coef=1e-3, seed=0)


def dp_inductive_checks(ds, state, root):
    """The inductive trainer's data-parallel batches over this world's graph
    axis: 3 epochs of batches of 4 graphs from the parameters ``state``
    (their train losses, test micro-F1 and final parameters); run() on the
    ppi preset with mesh.graph_axis = the world (1 epoch); and a 3-epoch
    run at dropouts 0.3 uninterrupted and again as 2 epochs saved every
    epoch under ``root`` then resumed in a fresh trainer."""
    mesh = make_mesh(graph=0)
    t = InductiveTrainer(ds, batch_size=4, mesh=mesh, **INDUCTIVE)
    t.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    r = t.fit(epochs=3, log=lambda rec: None)
    res = {"losses": r["epoch_train_loss"], "test_f1": r["test_micro_f1"],
           "state": _state(t.model)}
    cfg = preset("ppi")
    cfg.mesh.graph_axis, cfg.train.epochs = mesh.size, 1
    cfg.train.checkpoint_dir = f"{root}/run"
    r = ttrainer.run(cfg, ds, device="cpu")
    res["run"] = {"losses": r["epoch_train_loss"], "test_f1": r["test_micro_f1"]}
    runs = {}
    for name, epochs, resume in (("uninterrupted", 3, False), ("first", 2, False),
                                 ("resumed", 3, True)):
        t = InductiveTrainer(ds, batch_size=2, mesh=mesh, attn_drop=0.3, ffd_drop=0.3,
                             checkpoint_dir=f"{root}/{'a' if name == 'uninterrupted' else 'b'}",
                             checkpoint_every=1, **INDUCTIVE)
        r = t.fit(epochs=epochs, log=lambda rec: None, resume=resume)
        runs[name] = {"losses": r["epoch_train_loss"], "state": _state(t.model)}
    res["resume"] = runs
    return res


def _fail_on_load():
    raise RuntimeError("this argument fails to load on purpose")


class Unloadable:
    """An argument that pickles but raises when a rank unpickles it."""

    def __reduce__(self):
        return (_fail_on_load, ())


def count_args(*args):
    return len(args)
