"""Multi-process bring-up for the port.

The port's counterpart of `nv_wavenet_tpu/parallel/mesh.py::
initialize_multihost` (`jax.distributed.initialize`; the reference's
`init_process_group(nccl, tcp://...)`, `pytorch/distributed.py:43-53`):
one process per card, joined by `torch.distributed`.  The batch-sharded
generation of the JAX module (its `data_mesh`, `stage` and sharded
generator) is not ported yet (ROADMAP.md, section 1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int, device="cuda") -> None:
    """Join the process group of `num_processes` ranks as rank
    `process_id`, rendezvous at `coordinator_address` ("host:port", rank
    0's; no environment variable is read).  The backend follows the device
    the ranks train on: NCCL for the card (each rank then takes card
    `process_id` modulo the cards it sees), gloo for the CPU."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, "
                         f"{num_processes})")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
