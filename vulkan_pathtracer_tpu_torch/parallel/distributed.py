"""Process groups for multi-device rendering (port of
``parallel/distributed.py``).

``torch.distributed`` forms the group: NCCL between CUDA ranks, gloo
between CPU ranks.  One process per rank, on one host or several:

- ``initialize`` joins a group described by its arguments or, where
  they are omitted, by torchrun's environment (``MASTER_ADDR`` /
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a single process forms no
  group, as in the JAX package;
- ``spawn`` starts the ranks of one host itself (``--devices N``):
  one process per rank, joined on a free ``localhost`` port.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vulkan_pathtracer_tpu_torch.parallel.mesh import (
    check_cuda_ranks,
    make_render_group,
)


def backend_for(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def form_group(address: str, world: int, rank: int, device) -> None:
    """Join the ``world``-rank group at ``host:port`` as ``rank``."""
    dist.init_process_group(backend_for(device),
                            init_method=f"tcp://{address}",
                            world_size=world, rank=rank)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> bool:
    """Join the process group when running as one of several processes.

    Arguments left out come from torchrun's environment:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  Returns
    True when a group of more than one process was formed; one process
    forms none."""
    coordinator = coordinator_address
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT') or 29500}")
    n = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE") or 0)
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK") or -1)
    if coordinator and n > 1 and rank >= 0:
        form_group(coordinator, n, rank, device)
        return True
    return False


def is_primary() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, device, *args) -> list:
    """Run ``fn(group, *args)`` on ``world`` ranks of this host, one
    process each, in a group formed on a free ``localhost`` port (NCCL
    for a CUDA ``device``, gloo for the CPU; a group of one too).
    ``group`` is the rank's mesh.RenderGroup, its device current;
    ``fn`` and ``args`` are pickled to the processes.  Returns the
    ranks' return values, by rank; raises when a rank fails."""
    if torch.device(device).type == "cuda":
        check_cuda_ranks(world)
    address = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="vkpt_ranks_") as out:
        mp.spawn(_rank_main, args=(fn, world, str(device), address, out,
                                   args), nprocs=world, join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _rank_main(rank: int, fn, world: int, device: str, address: str,
               out: str, args) -> None:
    """One rank of ``spawn``: form the group, run ``fn``, leave the
    group, and write ``fn``'s return value for the parent."""
    form_group(address, world, rank, device)
    try:
        result = fn(make_render_group(device), *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
