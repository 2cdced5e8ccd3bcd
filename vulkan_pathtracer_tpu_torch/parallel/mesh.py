"""The rank's render group (port of ``parallel/mesh.py``).

The JAX package renders on a 1-D mesh of the local chips; here each
rank is one process with one device, and ``RenderGroup`` holds what the
sharded renders need of it: the rank, the world size, the rank's device
and the process group.  A CUDA rank takes card ``LOCAL_RANK`` (its rank
when ``distributed.spawn`` started it).  There is no quiet run on fewer
devices and no carrying on on the CPU: asking for more CUDA ranks than
the host has cards raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class RenderGroup:
    rank: int
    world: int
    device: torch.device
    # The process group; None for a single process (no collectives).
    group: Optional[object] = None

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (same shape on each), by rank."""
        if self.group is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (an all-reduce)."""
        if self.group is None:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Row block r of ``t`` (``world`` equal blocks) to rank r; the
        result holds the blocks received, by source rank."""
        if self.group is None:
            return t
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        return out

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` (same shape on each rank)."""
        if self.group is None:
            return t
        t = t.clone()
        dist.broadcast(t, src=dist.get_global_rank(self.group, 0),
                       group=self.group)
        return t


def check_cuda_ranks(ranks: int) -> None:
    """Raise unless this host has a card for each of ``ranks`` CUDA
    ranks."""
    count = torch.cuda.device_count()
    if ranks > count:
        raise RuntimeError(f"{ranks} CUDA ranks asked for, but this host "
                           f"has {count} CUDA device(s)")


def make_render_group(device="cuda") -> RenderGroup:
    """This process's RenderGroup: the formed process group, else a
    world of one.  A CUDA rank's card becomes the current device."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        group = dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        check_cuda_ranks(local + 1)
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return RenderGroup(rank=rank, world=world, device=dev, group=group)
