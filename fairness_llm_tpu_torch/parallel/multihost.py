"""Several processes, one rank each (counterpart of
``fairness_llm_tpu/parallel/multihost.py``).

The reference starts ``jax.distributed`` from ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` and runs one SPMD program over
every process's devices. The port runs one process a rank, as ``torchrun``
launches them, and reads that launcher's environment instead:
``MASTER_ADDR``/``MASTER_PORT`` (the rendezvous), ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``.

    torchrun --nproc-per-node 2 -m fairness_llm_tpu_torch.cli.main \\
        --phase 1 --mesh dp=2 ...

The backend is NCCL when every local rank has a card of its own, and gloo
otherwise: on the CPU, and for two ranks sharing one card (NCCL refuses
that). Under gloo a collective's tensors go through the CPU
(``collective_device``).

``make_multihost_mesh`` lays the mesh out as the reference does: ``dp``
outermost over the ranks in rank order, so a tp/sp group is made of
consecutive ranks, which ``torchrun`` places on one host.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from fairness_llm_tpu_torch.config import MeshConfig

logger = logging.getLogger(__name__)

# A rank that died leaves the others waiting in a collective: they give up
# after this long rather than the library's default of 30 minutes.
COLLECTIVE_TIMEOUT_S = 600


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group from the arguments or the launcher's
    environment. Returns True when a process group is (now) initialized,
    False in a single process with no rendezvous address. Raises when
    ``WORLD_SIZE > 1`` and no address is set.

    ``coordinator_address`` is ``host:port`` (else ``MASTER_ADDR`` and
    ``MASTER_PORT``). The backend is NCCL where each local rank has a card
    of its own and gloo otherwise; the choice is logged. With a card, the
    rank's current CUDA device becomes ``LOCAL_RANK`` modulo the cards, so
    ``device="cuda"`` means the rank's own card."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None:
        if num_processes and num_processes > 1:
            raise ValueError(
                "WORLD_SIZE > 1 but no rendezvous address: set MASTER_ADDR and "
                "MASTER_PORT (host:port of rank 0), as torchrun does")
        return False
    world = num_processes or 1
    rank = process_id or 0
    local_rank = _env_int("LOCAL_RANK") or 0
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards:
        torch.cuda.set_device(local_rank % cards)
    backend = "nccl" if cards >= local_world and cards > 0 else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    logger.info("torch.distributed initialized: rank %d/%d, backend %s (%d card(s), %d "
                "local rank(s))", rank, world, backend, cards, local_world)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process. The other ranks compute the same records and write nothing."""
    return process_index() == 0


def collective_device(compute: torch.device) -> torch.device:
    """Where a collective's tensors live: the card under NCCL, the CPU
    under gloo (which has no ``all_gather`` of CUDA tensors) or without a
    process group."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return compute
    return torch.device("cpu")


def make_multihost_mesh(mesh_config: MeshConfig):
    """The mesh over every rank, ``dp`` outermost. Raises when the mesh
    wants more ranks than the world has, or when a multi-process mesh does
    not span every rank (a rank left out would wait in the others'
    collectives)."""
    from fairness_llm_tpu_torch.parallel.sharding import make_mesh

    world = world_size()
    if mesh_config.num_devices != world:
        if mesh_config.num_devices < world:
            raise ValueError(
                f"multi-process mesh must span all {world} ranks; got {mesh_config.shape} = "
                f"{mesh_config.num_devices}")
        raise ValueError(
            f"mesh {mesh_config.shape} wants {mesh_config.num_devices} ranks, have {world}; "
            f"launch {mesh_config.num_devices} with torchrun --nproc-per-node "
            f"{mesh_config.num_devices}")
    return make_mesh(mesh_config)
