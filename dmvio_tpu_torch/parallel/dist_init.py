"""Multi-process runtime initialization.

Counterpart of dmvio_tpu/parallel/dist_init.py, rewritten on
torch.distributed: the reference joins jax.distributed, after which its
GSPMD programs span every host; here each process joins one
torch.distributed process group, after which parallel/dist_ba.Placer
sums the window BA's camera-sized partials with all_reduce and gathers
per-point results with all_gather across the ranks.

It is triggered by the environment, so the same run_dataset CLI works in
one process (no variables: nothing happens) and in several (the launcher
exports the three DMVIO_* variables per process, the contract of
torchrun/mpirun rank files):

    DMVIO_COORDINATOR   host:port of rank 0 (e.g. "10.0.0.1:8476")
    DMVIO_NUM_PROCESSES total process count
    DMVIO_PROCESS_ID    this process's rank in [0, num_processes)

DMVIO_DIST=auto takes the rendezvous from torch's own environment
variables instead (init_method "env://": MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK). The backend is NCCL when the caller runs on CUDA and
gloo on the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _backend(device) -> str:
    from dmvio_tpu_torch import device as resolve_device

    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def maybe_initialize(coordinator: str = None, num_processes: int = None,
                     process_id: int = None, device=None) -> bool:
    """Join a torch.distributed process group from the arguments or the
    DMVIO_* variables. `device` is the device this process runs on (None
    means CUDA, as everywhere in the port): NCCL for CUDA, gloo for the
    CPU.

    Returns True when a process group was (or already is) set up, False
    for the single-process default. Idempotent."""
    if dist.is_initialized():
        return True
    if os.environ.get("DMVIO_DIST", "").lower() == "auto":
        dist.init_process_group(_backend(device), init_method="env://")
        return True
    coordinator = coordinator or os.environ.get("DMVIO_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("DMVIO_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid = os.environ.get("DMVIO_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or not num_processes:
        return False
    if process_id is None:
        raise ValueError(
            "DMVIO_COORDINATOR/DMVIO_NUM_PROCESSES set but "
            "DMVIO_PROCESS_ID missing")
    dist.init_process_group(_backend(device),
                            init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def is_multiprocess() -> bool:
    """True when this process belongs to a process group of more than one
    rank."""
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the process group, if any (a no-op otherwise)."""
    if dist.is_available() and dist.is_initialized():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dist.destroy_process_group()
