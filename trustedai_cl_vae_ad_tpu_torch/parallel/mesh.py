"""The (data, model) mesh, process start-up and batch sharding.

Counterpart of ``trustedai_cl_vae_ad_tpu/parallel/mesh.py``. A mesh is one of:

  * a grid of the ranks of the default process group (one process, one
    device each; ``initialize_distributed`` starts the group). Rank
    ``d * n_model + m`` sits at data index d and model index m, as
    ``make_mesh`` reshapes the JAX package's devices; each rank knows the
    process group of its data axis (the ranks that share its model index)
    and of its model axis. Training runs on this kind;
  * a list of devices of one process, all on the data axis: one model
    replica per device, each scoring its rows of a batch (offline scoring)
    or a block of camera streams (the multi-camera engine). A device may be
    listed more than once: the split, the per-device state and the joins
    then run on one device.

Collectives run on the device of the rank for every backend: NCCL takes
only CUDA tensors, and gloo takes CUDA tensors as well as CPU ones.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (data, model) grid: ``shape`` {"data": n, "model": m}; ``device``
    is this process's device (the first of ``devices`` for a one-process
    mesh); ``data_group`` / ``model_group`` are the process groups of this
    rank's two axes (None on a one-process mesh)."""

    def __init__(self, n_data: int, n_model: int, devices: Sequence[torch.device],
                 data_group=None, model_group=None, distributed: bool = False):
        self.shape = {DATA_AXIS: int(n_data), MODEL_AXIS: int(n_model)}
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.data_group = data_group
        self.model_group = model_group
        self.distributed = bool(distributed)
        #: ``shard_batch`` prints its padding warning once a mesh
        self.pad_warned = False

    @property
    def data_rank(self) -> int:
        """This process's index on the data axis (0 on a one-process mesh)."""
        return dist.get_rank(self.data_group) if self.distributed else 0

    @property
    def is_primary(self) -> bool:
        """Whether this process writes the run's files (global rank 0)."""
        return not self.distributed or dist.get_rank() == 0

    def __repr__(self) -> str:
        kind = "ranks" if self.distributed else "local devices"
        return f"Mesh({self.shape}, {kind}, device={self.device})"


def is_distributed() -> bool:
    """Whether this process belongs to an initialized default process group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_device(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current CUDA device), so
    that two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def default_device(process_id: int = 0) -> torch.device:
    """The CUDA device a process of this host takes (``LOCAL_RANK``, else its
    rank, modulo the cards), or the CPU where there is no card."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device=None) -> None:
    """Join the default process group.

    ``coordinator`` is ``HOST:PORT`` (TCP, rank 0 listens) or an init URL
    (``file:///path`` for a shared file). With no arguments the standard
    environment is read (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); without it the process runs alone and nothing is
    joined. The backend is NCCL for a CUDA ``device`` (default: this
    process's ``default_device``) and gloo for the CPU, unless the caller
    names one: gloo with CUDA tensors is how two processes share one card,
    which NCCL refuses. A second call is harmless."""
    if is_distributed():
        return
    if coordinator is None and "MASTER_ADDR" not in os.environ:
        print("torch.distributed not initialized (no coordinator and no MASTER_ADDR); "
              "running single-process")
        return
    if coordinator is None:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    device = torch.device(device) if device is not None else default_device(process_id)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id))


def distributed_teardown() -> None:
    """End of a multi-process job: a barrier, so that no process leaves while
    the primary still writes, then the group is destroyed. Teardown errors
    are printed and swallowed: everything the job produced is on disk by
    then. No-op in a single process."""
    if not is_distributed():
        return
    try:
        dist.barrier()
    except Exception as e:  # noqa: BLE001 - teardown must not fail the job
        print(f"WARNING: exit barrier failed ({e}); proceeding to shutdown")
    try:
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001
        print(f"WARNING: process group shutdown failed ({e}); outputs are durable, "
              "exiting cleanly anyway")


def broadcast_str(s: str) -> str:
    """The string of process 0 on every process (the stamped log
    directory); identity in a single process."""
    if process_count() == 1:
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh; by default every rank (or device) on the data
    axis.

    In a process group: over all its ranks, ``n_data * n_model`` = world
    size; ``devices`` names this process's one device (default:
    ``default_device(rank)``). Every rank must call it, in the same order
    as its other group calls (it creates the axes' groups). Otherwise: over
    ``devices`` of this process (default: every CUDA device, else the CPU),
    with no model axis."""
    if is_distributed():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data is None:
            n_data = world // n_model
        if n_data * n_model != world:
            raise ValueError(f"mesh ({n_data}, {n_model}) does not cover the {world} ranks")
        if devices is not None and len(devices) != 1:
            raise ValueError("a rank of a process group holds one device")
        device = torch.device(devices[0]) if devices is not None else default_device(rank)
        data_group = model_group = None
        # every rank creates every group, in the same order
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                data_group = group
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                model_group = group
        return Mesh(n_data, n_model, [device], data_group, model_group, distributed=True)
    if n_model != 1:
        raise ValueError("a model axis needs one process per device: call "
                         "initialize_distributed first")
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")])
    devices = list(devices)
    if n_data is not None:
        devices = devices[:n_data]
    return Mesh(len(devices), 1, devices)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _moved(tree, device):
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def replicate(tree, mesh: Mesh) -> list:
    """A (nested) dict of tensors on every device of the mesh, in device
    order. In a process group each tensor is broadcast from global rank 0 in
    place (every rank then starts from rank 0's weights) and the one entry is
    ``tree`` itself; on a one-process mesh, a copy on each device (tensors
    that already lie there are not copied)."""
    if mesh.distributed:
        with torch.no_grad():
            for t in _tensors(tree):
                dist.broadcast(t, src=0)
        return [tree]
    return [_moved(tree, d) for d in mesh.devices]


def pad_rows(batch: torch.Tensor, multiple: int) -> torch.Tensor:
    """``batch`` with its last row repeated up to a multiple of ``multiple`` rows."""
    extra = -batch.shape[0] % multiple
    if extra == 0:
        return batch
    return torch.cat([batch, batch[-1:].expand(extra, *batch.shape[1:])], dim=0)


def shard_batch(batch, mesh: Mesh, pad: bool = True) -> List[torch.Tensor]:
    """This process's rows of a global batch, one block of rows a device of
    the mesh, in device order: in a process group the one block of this
    rank's data index; on a one-process mesh a block for each device (moved
    there).

    With ``pad`` a ragged batch is padded up to a multiple of the data axis
    by repeating its last frame. The repeated frames enter the loss
    statistics, biasing that batch toward the repeated frame; the first time
    it happens on a mesh a warning says so. Size batches as a multiple of
    the data axis (or drop the remainder batch) where exact parity matters."""
    batch = torch.as_tensor(batch)
    n_data = mesh.shape[DATA_AXIS]
    if batch.shape[0] % n_data:
        if not pad:
            raise ValueError(f"batch of {batch.shape[0]} does not divide over data={n_data}")
        if not mesh.pad_warned:
            extra = -batch.shape[0] % n_data
            print(f"shard_batch: padding ragged batch {batch.shape[0]} -> "
                  f"{batch.shape[0] + extra} by repeating the last frame "
                  f"(biases this batch's loss stats; size batches as a multiple "
                  f"of data={n_data} for exact parity)")
            mesh.pad_warned = True
        batch = pad_rows(batch, n_data)
    rows = batch.shape[0] // n_data
    if mesh.distributed:
        start = mesh.data_rank * rows
        return [batch[start:start + rows].to(mesh.device)]
    return [batch[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(mesh.devices)]


def global_batch_from_local(local_batch, mesh: Mesh) -> torch.Tensor:
    """The global batch of a multi-process run: every rank's local rows, in
    data-rank order (the ranks of one data index hold the same rows). Every
    rank calls it, with the same number of rows. In one process the local
    batch is the global one."""
    local_batch = torch.as_tensor(local_batch).to(mesh.device)
    if not mesh.distributed:
        return local_batch
    from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import all_gather_dim

    return all_gather_dim(local_batch.contiguous(), 0, mesh.data_group)
