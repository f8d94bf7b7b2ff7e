"""The device mesh as a torch.distributed process group, and the autograd
collectives of the partitioned backends (port of han_tpu/parallel/mesh.py).

han_tpu builds a ``jax.sharding.Mesh`` with ('graph', 'heads'[, 'mp'])
axes, and ``shard_map``'s AD writes the collectives of the backward for it.
Here one process drives one device, the 'graph' axis is the process group
(NCCL for CUDA tensors, gloo for CPU tensors; a CUDA rank never falls back
to gloo), and the collectives are autograd functions written out:

- :func:`gather_rows`: all_gather of row blocks in the forward, the local
  block of the gradient in the backward (the gradient downstream is the
  same on every rank, since the model outside attention runs replicated);
- :func:`local_rows`: its transpose: the local block in the forward, an
  all_gather of the gradient blocks in the backward;
- :func:`sum_grads`: the identity in the forward, an all_reduce of the
  gradient in the backward: the psum that ``shard_map`` gives a replicated
  input (han_tpu/parallel/flash_shard.py:14-16);
- :func:`ring_shift`: send each tensor to rank (r+1) mod S and receive from
  (r-1) mod S with ``dist.batch_isend_irecv``; nothing to do at S = 1 (the
  ppermute skip of han_tpu/parallel/ring_bcsr.py:190-194).

The 'heads' and 'mp' axes are not ported: a mesh with either above 1
raises ``NotImplementedError``. Without a process group (one process, no
``torch.distributed`` set-up) the mesh has one rank and every collective is
the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from han_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The graph axis: a process group of ``size`` ranks, one device each."""

    group: object | None  # torch.distributed ProcessGroup; None: one process
    rank: int
    size: int
    device: torch.device


def _backend() -> str | None:
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def make_mesh(graph: int = 0, heads: int = 1, mp: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The graph-axis mesh over the default process group; ``graph=0`` takes
    every rank. Raises when ``graph`` is not the world size, and when the
    device does not match the backend (CUDA needs NCCL, the CPU gloo).
    ``device`` defaults to the CPU in a gloo group and to the current CUDA
    device otherwise (with no process group too; raising when CUDA is
    unavailable: pass ``device="cpu"``)."""
    if heads != 1 or mp != 1:
        raise NotImplementedError(
            "only the graph mesh axis is ported (heads and mp axes raise)")
    backend = _backend()
    if backend is None:
        group, rank, size = None, 0, 1
    else:
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    graph = graph or size
    if graph != size:
        raise ValueError(
            f"mesh graph axis {graph} != world size {size}: one process per "
            f"device (torchrun --nproc-per-node {graph}, or parallel/launch.spawn)")
    device = resolve_device("cpu" if device is None and backend == "gloo" else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is not None and backend != ("nccl" if device.type == "cuda" else "gloo"):
        raise ValueError(f"{device.type} tensors need the "
                         f"{'nccl' if device.type == 'cuda' else 'gloo'} backend, "
                         f"the process group has {backend}")
    return Mesh(group, rank, size, device)


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def _block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh), None


class _LocalRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _block(x, mesh).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh), None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.mesh.group is None:
            return g, None
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(n, ...) per rank → (S·n, ...), rank-major; the backward keeps the
    local block of the (replicated) gradient."""
    return _GatherRows.apply(x, mesh)


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(S·n, ...) replicated → this rank's (n, ...) block; the backward
    all-gathers the blocks' gradients."""
    return _LocalRows.apply(x, mesh)


def sum_grads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The identity, whose backward sums the gradient over the ranks."""
    return _SumGrads.apply(x, mesh)


def ring_shift(tensors, mesh: Mesh):
    """Post the sends of ``tensors`` to rank (r+1) mod S and the receives of
    their counterparts from (r-1) mod S. Returns (received buffers, works):
    the buffers are valid after :func:`wait`. At S = 1, or with nothing to
    send, returns the tensors themselves and no work."""
    tensors = [t.contiguous() for t in tensors]
    if mesh.size == 1 or not tensors:
        return tensors, []
    nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    bufs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, b in zip(tensors, bufs):
        ops.append(dist.P2POp(dist.isend, t, nxt, mesh.group))
        ops.append(dist.P2POp(dist.irecv, b, prv, mesh.group))
    return bufs, dist.batch_isend_irecv(ops)


def wait(works) -> None:
    for w in works:
        w.wait()
