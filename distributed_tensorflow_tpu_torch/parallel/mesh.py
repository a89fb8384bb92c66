"""The mesh of the port: this process's place in the process group.

The counterpart of ``distributed_tensorflow_tpu/parallel/mesh.py``. The
JAX package runs one process per host over a ``jax.sharding.Mesh`` of
its chips, a ("data", "model") grid. The port runs one process per GPU
(``--device cuda:<i>``), so the grid is a grid of ranks of the
``torch.distributed`` group: rank ``r`` sits at ``(r // m, r % m)`` of a
data x m grid, the order of JAX's
``np.asarray(devices).reshape(data, model)``. Each row is a model group
(the ranks that split one model), each column a data group (the ranks
that hold the same shards and average their gradients). A grid of one
column is the data mesh, ``DataMesh``, which the data-parallel, ZeRO
and ps code take.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape: how many ways to split batch vs model dims."""

    data: int = -1  # -1 = all remaining ranks
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = self.model
        data = self.data if self.data != -1 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices"
            )
        return data, model


@dataclass(frozen=True)
class DataMesh:
    """One rank of the data-parallel group. ``group`` is the process
    group the collectives run on (None = the default group)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object = None


@dataclass(frozen=True)
class GridMesh:
    """One rank of a data x model grid of the joined group.

    ``rank``, ``world_size`` and ``group`` are the whole grid's (the stop
    vote, the exit agreement and a fresh state's broadcast run over
    every rank); ``data_index``/``model_index`` are this rank's place,
    ``model_group`` its row, ``data_group`` its column, and
    ``data_mesh`` the column as a ``DataMesh`` (the gradient average)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    data: int
    model: int
    data_index: int
    model_index: int
    model_group: object
    data_group: object
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_mesh(self) -> DataMesh:
        return DataMesh(rank=self.data_index, world_size=self.data,
                        device=self.device, backend=self.backend,
                        group=self.data_group)


def make_mesh(device: torch.device | str, spec: MeshSpec | None = None,
              group=None):
    """The mesh of this process, read from the initialized process
    group; ``device`` is this rank's device. A ``spec`` with a model
    axis of m > 1 makes the data x m grid (``GridMesh``): every rank
    creates every row's and every column's subgroup, rows first, in the
    same order (``dist.new_group`` is collective over the group). No
    spec, or m = 1, is the data mesh. Raises when no group is
    initialized (``cluster.maybe_initialize_distributed`` makes one)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the data mesh needs an initialized torch.distributed process "
            "group: call cluster.maybe_initialize_distributed first")
    device = torch.device(device)
    backend = dist.get_backend(group)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group runs on cuda devices, not {device}")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if spec is None or spec.model == 1:
        if spec is not None:
            spec.resolve(world)
        return DataMesh(rank=rank, world_size=world, device=device,
                        backend=backend, group=group)
    if group is not None:
        raise ValueError("a model axis is built over the default group")
    data, model = spec.resolve(world)
    rows = [dist.new_group(list(range(r * model, (r + 1) * model)))
            for r in range(data)]
    cols = [dist.new_group(list(range(c, world, model)))
            for c in range(model)]
    return GridMesh(rank=rank, world_size=world, device=device,
                    backend=backend, data=data, model=model,
                    data_index=rank // model, model_index=rank % model,
                    model_group=rows[rank // model],
                    data_group=cols[rank % model])
