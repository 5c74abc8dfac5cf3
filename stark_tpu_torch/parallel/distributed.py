"""Starting the process group of a sharded run.

Counterpart of stark_tpu/parallel/distributed.py, on ``torch.distributed``:
one process per device, each told its rank by the arguments or by the
environment that ``torchrun`` sets (``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the rank's card in
parallel/mesh.make_mesh).  Nothing tells a program of a cluster otherwise:

    torchrun --nproc-per-node=D prog.py          # prog.py calls:
    initialize_distributed(); mesh = global_mesh()

A fully absent configuration is a single-process run (a mesh of one rank);
a partial one raises, naming what is missing: a typo'd variable must fail
loudly, not prove on one process.
"""

from __future__ import annotations

import os

import torch.distributed as dist

from stark_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_distributed(master_addr: str | None = None, world_size: int | None = None,
                           rank: int | None = None, *, backend: str = "nccl"):
    """Join the process group.  ``master_addr`` may carry its port
    (``host:port``); else ``MASTER_PORT`` gives it.
    ``backend``: ``nccl`` (CUDA tensors, one card a rank) or ``gloo`` (CPU
    tensors; with a CUDA mesh device, several ranks sharing one card,
    parallel/mesh.py).  Returns the backend, or None for a single-process
    run."""
    env = os.environ
    addr = master_addr or env.get("MASTER_ADDR")
    if world_size is None and env.get("WORLD_SIZE") is not None:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK") is not None:
        rank = int(env["RANK"])
    master_port = env.get("MASTER_PORT")
    if addr is not None and ":" in addr:
        addr, master_port = addr.rsplit(":", 1)
    given = {"MASTER_ADDR": addr, "MASTER_PORT": master_port, "WORLD_SIZE": world_size,
             "RANK": rank}
    missing = [k for k, v in given.items() if v is None]
    if len(missing) == len(given):
        return None  # single-process run
    if missing:
        raise RuntimeError(
            "partial distributed configuration: set all of MASTER_ADDR / MASTER_PORT / "
            f"WORLD_SIZE / RANK (missing: {', '.join(missing)})")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{master_port}",
                                world_size=world_size, rank=rank)
    return backend


def global_mesh(device=None) -> Mesh:
    """The 1-D mesh over every rank of the process group (parallel/mesh.py
    make_mesh; ``device`` as there)."""
    return make_mesh(device=device)
