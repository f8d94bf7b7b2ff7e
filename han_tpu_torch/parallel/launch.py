"""Process-group start-up (port of han_tpu/parallel/launch.py).

han_tpu joins hosts through ``jax.distributed`` and lets XLA place one
program on every chip. Here each device has its own process:

- under ``torchrun`` every process calls :func:`init_distributed`, which
  reads the environment torchrun sets (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), pins the process to
  ``cuda:LOCAL_RANK`` and joins an NCCL group (gloo when the caller asks
  for the CPU); with no such environment it does nothing::

      torchrun --nproc-per-node 4 scripts/train_torch.py --dataset dblp_synthetic \\
          --set mesh.graph_axis=4 --set data.graph_format=ring_bcsr

- :func:`spawn` runs a function in S processes of one machine (start method
  ``spawn``), each joined to a group at ``tcp://localhost:<free port>``:
  the tests' gloo worlds on the CPU, the dry run, and ``chip_smoke.py``'s
  NCCL world.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist

from han_tpu_torch.utils.device import resolve_device


def init_distributed(device: torch.device | str = "cuda") -> None:
    """Join torchrun's process group, NCCL for a CUDA ``device`` (pinned to
    ``cuda:LOCAL_RANK``) and gloo for the CPU; a no-op when
    single-process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if resolve_device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            backend = "nccl"
        else:
            backend = "gloo"
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=world)


def is_coordinator() -> bool:
    """True on the process that logs (rank 0, or the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world_size, backend, port, env, out_dir):
    os.environ.update(env)  # before this process initializes CUDA
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # S CPU ranks share the machine's cores
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world_size: int, backend: str = "gloo", args: tuple = (),
          env: dict | None = None) -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes joined to one
    process group (rank r on ``cuda:r`` under NCCL, one CPU thread each
    under gloo) and return their results in rank order. ``env`` is set in
    each process before anything else runs. A failing rank raises here
    (``torch.multiprocessing.ProcessRaisedException``), after the others
    are stopped.

    ``fn`` and ``args`` reach the processes through a file, not through
    the pipe that starts them: CPython writes a process's start data into
    that pipe while holding its read end, so a process that dies before
    reading more than the pipe's 64 KiB (an argument that fails to load,
    a rank killed at start) would leave the parent blocked for good."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(out_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        torch.multiprocessing.start_processes(
            _worker, args=(world_size, backend, _free_port(), dict(env or {}), out_dir),
            nprocs=world_size, join=True, start_method="spawn")
        results = []
        for rank in range(world_size):
            with open(os.path.join(out_dir, f"{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
