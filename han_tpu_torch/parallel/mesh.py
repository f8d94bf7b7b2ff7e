"""The device mesh as torch.distributed process groups, and the autograd
collectives of the partitioned backends (port of han_tpu/parallel/mesh.py).

han_tpu builds a ``jax.sharding.Mesh`` with ('graph', 'heads') axes, or
('mp', 'graph', 'heads') when mp > 1, and ``shard_map``'s AD writes the
collectives of the backward for it. Here one process drives one device,
and the ranks of the default process group lay out row-major over (mp,
graph, heads), as han_tpu reshapes its device list (rank = (m · graph + g)
· heads + h):

- ``graph``: destination-row strips of each meta-path's edges (and the
  ring over them);
- ``heads``: attention heads, K / heads a rank (heads are independent
  until the concat, reference gat.py:42-46);
- ``mp``: HAN's meta-path towers, P / mp a rank (nn/models.py).

Each axis is an :class:`Axis`: the process group of the ranks that differ
from this one on that axis only (NCCL for CUDA tensors, gloo for CPU
tensors; a CUDA rank never falls back to gloo), this rank's coordinate and
the axis size. An axis of size 1 has no group and its collectives are the
identity, and so is every collective without a process group (one
process). The collectives are autograd functions written out, each over
the axis it is given:

- :func:`gather_rows`: all_gather of blocks along a dim (the rows) in
  the forward, the local block of the gradient in the backward (the
  gradient downstream is the same on every rank of the axis, since the
  model outside attention runs replicated);
- :func:`local_rows`: its transpose: the local block in the forward, an
  all_gather of the gradient blocks in the backward;
- :func:`gather_heads` / :func:`local_heads`: the same along the head
  dimension of (n, K, D) blocks: the all-gather that han_tpu's
  ``out_specs=P(GRAPH, HEAD, None)`` implies, and the slice of a rank's
  heads;
- :func:`sum_grads`: the identity in the forward, an all_reduce of the
  gradient in the backward: the psum that ``shard_map`` gives a replicated
  input (han_tpu/parallel/flash_shard.py:14-16);
- :func:`ring_shift`: send each tensor to the axis' next rank and receive
  from its previous one with ``dist.batch_isend_irecv``; nothing to do on
  an axis of one rank (the ppermute skip of
  han_tpu/parallel/ring_bcsr.py:190-194).

The data-parallel trainers (train/sampled.py:DPSampledTrainer,
train/inductive.py) sum outside autograd: :func:`all_sum` for counts and
metrics, :func:`all_reduce_grads` for the gradients after the backward
(the psum that han_tpu's jit writes for a batch sharded over the axis),
and :func:`all_gather_rows` for generator states.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from han_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the process group of its ranks
    (None: one rank), their global ranks in axis order, this rank's
    coordinate and the axis size."""

    group: object | None
    ranks: tuple[int, ...]
    rank: int
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (mp, graph, heads) grid of ``size`` ranks, one device each;
    ``rank`` is this rank's place in it (its global rank)."""

    graph: Axis
    heads: Axis
    mp: Axis
    rank: int
    size: int
    device: torch.device


def _backend() -> str | None:
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def _axes(shape: tuple[int, int, int], rank: int, grouped: bool) -> list[Axis]:
    """The three axes (mp, graph, heads) of a row-major grid of ``shape``
    as global rank ``rank`` sees them. With ``grouped``, every rank makes
    every group of more than one rank, in one order (dist.new_group's
    rule), and keeps its own; an axis over the whole world takes the
    default group."""
    coord = [rank // (shape[1] * shape[2]), rank // shape[2] % shape[1], rank % shape[2]]
    strides = (shape[1] * shape[2], shape[2], 1)
    world = shape[0] * shape[1] * shape[2]
    axes = []
    for a in range(3):
        others = [range(shape[b]) for b in range(3) if b != a]
        mine = None
        for i in others[0]:
            for j in others[1]:
                base = [i, j]
                base.insert(a, 0)
                ranks = tuple(sum(c * s for c, s in zip(base, strides)) + x * strides[a]
                              for x in range(shape[a]))
                group = None
                if grouped and shape[a] > 1:
                    group = dist.group.WORLD if shape[a] == world else dist.new_group(list(ranks))
                if rank in ranks:
                    mine = Axis(group, ranks, coord[a], shape[a])
        axes.append(mine)
    return axes


def make_mesh(graph: int = 0, heads: int = 1, mp: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The (mp, graph, heads) mesh over the default process group;
    ``graph=0`` takes the ranks the other axes leave. Raises ValueError
    where han_tpu does (the world not divisible by heads · mp, a mesh
    larger than the world) and, since every process holds one device, when
    the mesh does not cover the world; also when the device does not match
    the backend (CUDA needs NCCL, the CPU gloo). ``device`` defaults to the
    CPU in a gloo group and to the current CUDA device otherwise (with no
    process group too; raising when CUDA is unavailable: pass
    ``device="cpu"``)."""
    backend = _backend()
    if backend is None:
        rank, world = 0, 1
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
    if min(heads, mp) < 1 or graph < 0:
        raise ValueError(f"mesh axes must be positive, got mp={mp} graph={graph} heads={heads}")
    if graph == 0:
        if world % (heads * mp):
            raise ValueError(f"{world} devices not divisible by heads*mp={heads * mp}")
        graph = world // (heads * mp)
    if mp * graph * heads > world:
        raise ValueError(f"mesh {mp}x{graph}x{heads} exceeds {world} devices")
    if mp * graph * heads != world:
        raise ValueError(
            f"mesh {mp}x{graph}x{heads} != world size {world}: one process per "
            f"device (torchrun --nproc-per-node {mp * graph * heads}, or parallel/launch.spawn)")
    device = resolve_device("cpu" if device is None and backend == "gloo" else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is not None and backend != ("nccl" if device.type == "cuda" else "gloo"):
        raise ValueError(f"{device.type} tensors need the "
                         f"{'nccl' if device.type == 'cuda' else 'gloo'} backend, "
                         f"the process group has {backend}")
    m_ax, g_ax, h_ax = _axes((mp, graph, heads), rank, backend is not None)
    return Mesh(graph=g_ax, heads=h_ax, mp=m_ax, rank=rank, size=world, device=device)


def _all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Blocks of ``x`` along ``dim``, one a rank of ``axis``, concatenated
    in rank order."""
    if axis.group is None:
        return x
    dim %= x.dim()
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=axis.group)
    return out.movedim(0, dim).contiguous() if dim else out


def _block(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, contiguous."""
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.axis, ctx.dim), None, None


class _Local(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block(x, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis.group is None:
            return g, None
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


def gather_rows(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """(n, ...) per rank → (S·n, ...), rank-major over ``axis`` (blocks
    along ``dim``); the backward keeps the local block of the (replicated)
    gradient."""
    return _Gather.apply(x, axis, dim)


def local_rows(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """(S·n, ...) replicated → this rank's (n, ...) block on ``axis``
    (along ``dim``); the backward all-gathers the blocks' gradients."""
    return _Local.apply(x, axis, dim)


def gather_heads(x: torch.Tensor, axis: Axis, dim: int = -2) -> torch.Tensor:
    """(..., k_loc, D) per rank → (..., S·k_loc, D) over ``axis`` (the
    heads axis; the heads along ``dim``); the backward keeps this rank's
    heads of the (replicated) gradient."""
    return _Gather.apply(x, axis, dim)


def local_heads(x: torch.Tensor, axis: Axis, dim: int = -2) -> torch.Tensor:
    """(..., K, D) replicated → this rank's (..., K/S, D) heads on ``axis``
    (the heads along ``dim``); the backward all-gathers the heads'
    gradients."""
    return _Local.apply(x, axis, dim)


def sum_grads(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The identity, whose backward sums the gradient over ``axis``."""
    return _SumGrads.apply(x, axis)


def ring_shift(tensors, axis: Axis, step: int = 1):
    """Post the sends of ``tensors`` to the rank ``step`` ahead on ``axis``
    and the receives of their counterparts from the rank ``step`` behind.
    Returns (received buffers, works): the buffers are valid after
    :func:`wait`. On an axis of one rank, or with nothing to send, returns
    the tensors themselves and no work."""
    tensors = [t.contiguous() for t in tensors]
    if axis.group is None or not tensors:
        return tensors, []
    nxt = axis.ranks[(axis.rank + step) % axis.size]
    prv = axis.ranks[(axis.rank - step) % axis.size]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, b in zip(tensors, bufs):
        ops.append(dist.P2POp(dist.isend, t, nxt, axis.group))
        ops.append(dist.P2POp(dist.irecv, b, prv, axis.group))
    return bufs, dist.batch_isend_irecv(ops)


def all_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis`` (a new tensor; ``x`` itself on
    an axis of one rank); not differentiable."""
    if axis.group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=axis.group)
    return x


def all_reduce_grads(params, axis: Axis) -> None:
    """Sum the ``.grad`` of every parameter that has one over ``axis``, in
    place, in one flat all_reduce (nothing to do on an axis of one rank)."""
    if axis.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=axis.group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def all_gather_rows(x: torch.Tensor, axis: Axis, device: torch.device) -> torch.Tensor:
    """(S, *x.shape): every rank's ``x`` in rank order over ``axis``, moved to
    ``device`` for the collective (a CPU generator state on a CUDA rank) and
    returned on the CPU; not differentiable. (``Generator.set_state`` takes
    a row of it only as a copy: ``.clone()``; a view crashes it.)"""
    return _all_gather(x.to(device)[None], axis).cpu()


def wait(works) -> None:
    for w in works:
        w.wait()
