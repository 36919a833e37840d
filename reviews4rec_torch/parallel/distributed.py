"""Multi-process runtime of the port: one `torch.distributed` rank per
device. Counterpart of `reviews4rec_tpu/parallel/distributed.py`.

Where JAX runs one process per host that drives every local device, the
port runs one process per device: every rank runs the same program, and
`parallel.mesh.mesh_from_hp` lays the ranks out as the (data, model)
grid of `hp.mesh_shape`. Call `initialize()` once per process before
building a mesh. The training CLI (`python -m reviews4rec_torch`) does
this when `--coordinator host:port --num_processes N --process_id I` is
passed, or when torch's standard MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
RANK variables are set (the counterparts of JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID); single-process runs skip it.

Backend: NCCL when every rank has a card of its own, gloo otherwise: on
the CPU, or when several ranks share one card (NCCL refuses two ranks on
one device). Under gloo a collective on card tensors goes through host
memory. Each rank drives `cuda:(local_rank % device_count)`, where
local_rank is LOCAL_RANK or else the rank, unless the caller asks for
the CPU. Log, checkpoint and prediction writes happen on the primary
process only (`is_primary`).
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

_initialized = False
_device: Optional[torch.device] = None
_hosts = 1


def pick_backend(world_size: int, device: torch.device) -> str:
    """NCCL when every rank of this host can have a card of its own (the
    host's ranks: LOCAL_WORLD_SIZE, else the whole world), gloo
    otherwise."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def rank_device(process_id: int, device: DeviceLike = None) -> torch.device:
    """The device rank `process_id` drives: the CPU when asked for, else
    card local_rank % device_count (LOCAL_RANK, else the rank)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: DeviceLike = None,
               backend: Optional[str] = None) -> bool:
    """Bring up the process group. Arguments fall back to torch's env
    variables (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK).
    `coordinator_address` is host:port (tcp), or any torch init method
    (`file://...`). Returns True when a multi-process runtime was
    started, False for the single-process no-op (which changes nothing).
    Once a process group is up, calling it again does nothing."""
    global _initialized, _device, _hosts
    if _initialized:
        return dist.is_initialized() and dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])

    if coordinator_address is None and num_processes is None \
            and process_id is None:
        return False
    missing = [flag for flag, v in (("--coordinator", coordinator_address),
                                    ("--num_processes", num_processes),
                                    ("--process_id", process_id))
               if v is None]
    if missing:
        raise ValueError(f"a multi-process run needs --coordinator, "
                         f"--num_processes and --process_id (or MASTER_ADDR,"
                         f" WORLD_SIZE and RANK); missing {missing}")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} must lie in "
                         f"[0, --num_processes {num_processes})")
    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend or pick_backend(num_processes, dev),
                            init_method=init, world_size=num_processes,
                            rank=process_id)
    names = [None] * num_processes
    dist.all_gather_object(names, socket.gethostname())
    _initialized, _device, _hosts = True, dev, len(set(names))
    return num_processes > 1


def device() -> torch.device:
    """This rank's device, as `initialize` chose it."""
    if _device is None:
        raise RuntimeError("no process group: parallel.distributed."
                           "initialize brought none up")
    return _device


def host_count() -> int:
    """The hosts the ranks run on (the JAX package's process count): 1
    for the ranks of one machine."""
    return _hosts


def is_primary() -> bool:
    """True on the process that owns log, checkpoint and prediction
    writes: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Tear the process group down (so a process can start another)."""
    global _initialized, _device, _hosts
    from .mesh import _meshes
    _meshes.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _device, _hosts = False, None, 1
