"""The data "mesh" of the port: this process's place in the process group.

The counterpart of ``distributed_tensorflow_tpu/parallel/mesh.py``. The
JAX package runs one process per host over a ``jax.sharding.Mesh`` of
its chips, whose ``"data"`` axis splits the batch. The port runs one
process per GPU (``--device cuda:<i>``), so the data axis is the
``torch.distributed`` process group itself: a rank, a world size and
this rank's device. There are no virtual devices, and no model axis yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataMesh:
    """One rank of the data-parallel group. ``group`` is the process
    group the collectives run on (None = the default group)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object = None


def make_mesh(device: torch.device | str, group=None) -> DataMesh:
    """The data mesh of this process, read from the initialized process
    group; ``device`` is this rank's device. Raises when no group is
    initialized (``cluster.maybe_initialize_distributed`` makes one)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the data mesh needs an initialized torch.distributed process "
            "group: call cluster.maybe_initialize_distributed first")
    device = torch.device(device)
    backend = dist.get_backend(group)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group runs on cuda devices, not {device}")
    return DataMesh(rank=dist.get_rank(group),
                    world_size=dist.get_world_size(group), device=device,
                    backend=backend, group=group)
