"""Data-parallel training ranks over torch.distributed.

The JAX package trains data-parallel inside one program: shard_map over a
'data' mesh, pmean of the gradients and metrics. Here each rank is a
process with its own device and its share of the global batch; the
gradients and metrics are all-reduced between the backward pass and the
update (training/train.py), so every rank applies the same update and
keeps the same parameters, optimizer state and EMA.

A launcher starts the ranks (`python -m torch.distributed.run
--nproc_per_node N ...` sets RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT), or a caller passes them to
`init` (the tests do, with a file:// rendezvous). The rule for device and
backend, printed on rank 0's first line:
  * a card rank takes cuda:(LOCAL_RANK % device_count);
  * the backend is nccl when every rank on the host has a card of its own
    and gloo when ranks share a card (NCCL refuses two ranks on one
    card); CPU ranks always use gloo. Under gloo the tensors stay on the
    card: gloo stages its collectives through the host itself.
gloo has no averaging reduction, so a mean is a sum divided by the world
size.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from deepdenoiser_tpu_torch import device as device_lib


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's rank in the data-parallel group, its device and the
    group's backend. The group is torch.distributed's default one."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """In place: the mean of `t` over the ranks."""
        dist.all_reduce(t)
        return t.div_(self.world)

    def all_reduce_max_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def choose(local_rank: int, local_world: int,
           device: Optional[Union[str, torch.device]] = None) -> Tuple[torch.device, str, str]:
    """(device, backend, the reason) for a rank: see the module docstring.
    `device` "cpu" makes a CPU rank; None or any CUDA device a card rank."""
    dev = device_lib.for_rank(local_rank, device)
    if dev.type == "cpu":
        return dev, "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return dev, "nccl", f"{local_world} ranks on this host, {cards} cards: a card each"
    return dev, "gloo", (f"{local_world} ranks on this host share {cards} card(s); "
                         "NCCL needs a card per rank")


def init(rank: int, world: int, init_method: str,
         device: Optional[Union[str, torch.device]] = None,
         local_rank: Optional[int] = None, local_world: Optional[int] = None) -> DataGroup:
    """Join the default process group as `rank` of `world`. local_rank and
    local_world (the ranks on this host) default to rank and world."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    dev, backend, why = choose(local_rank, local_world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # ranks share the host's cores
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    if rank == 0:
        print(f"[dist] world {world}, backend {backend} ({why}), rank 0 on {dev}", flush=True)
    return DataGroup(rank, world, dev, backend)


def init_from_env(device: Optional[Union[str, torch.device]] = None) -> Optional[DataGroup]:
    """The group a launcher describes in the environment, or None when no
    launcher started more than one rank."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return init(rank, world, "env://", device, local_rank, local_world)


def shutdown(group: Optional[DataGroup]) -> None:
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()
