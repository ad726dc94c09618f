"""The process group and the device mesh of data-parallel runs (counterpart
of plastic_unet_tpu.parallel.mesh).

JAX drives D devices from one process over a ``Mesh``. Here each device has
a process of its own (a rank, launched by ``torchrun``: ``python -m
torch.distributed.run --nproc-per-node D ...``), and a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks stands for the
JAX ``Mesh``: a 1-D ``("data",)`` mesh, or a 2-D ``("dcn", "data")`` one for
the multi-slice layout. The collectives run on the default process group:
NCCL for CUDA tensors, Gloo for CPU tensors, chosen from the device and
never one in place of the other.

A mesh spans the whole world, where JAX may take the first n devices of
more: a rank outside the mesh would have no share of the stream. The JAX
layout names ``replicated`` and ``lane_sharded`` have no counterpart, since
no caller here needs one: parameters are replicated by construction
(parallel.dp.dp_state_sharding broadcasts rank 0's once) and the lanes a
rank holds are its shard.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from plastic_unet_tpu_torch import resolve_device

DATA_AXIS = "data"
DCN_AXIS = "dcn"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _launch_hint(n) -> str:
    return f"launch one process per device with torchrun (python -m torch.distributed.run --nproc-per-node {n} ...)"


def init_distributed(device=None, *, init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, timeout: timedelta | None = None) -> torch.device:
    """Start the default process group of this rank and return the rank's
    device (``None`` means CUDA, as at every entry point).

    Without ``init_method`` the group comes from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and raises ``ValueError`` naming torchrun where it is
    missing; with one (``file://...``, ``tcp://host:port``) ``rank`` and
    ``world_size`` are the caller's. The backend is NCCL for a CUDA device
    and Gloo for the CPU. On CUDA the rank's device is ``cuda:LOCAL_RANK``
    (``cuda:rank`` without torchrun), made the current device, and
    ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` defaults to 0, which CUDA-graph
    capture of the collectives asks for (train.loop.GraphTrainStep)."""
    dev = resolve_device(device)
    if init_method is None:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(f"no process group to join ({', '.join(missing)} unset): {_launch_hint('N')}")
        init_method = "env://"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    kw = {} if timeout is None else {"timeout": timeout}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method, **kw)
    return dev


def rank_device(device=None) -> torch.device:
    """The device of this rank: a CUDA device without an index is the
    current one (set by init_distributed), the CPU is the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _world_mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    need = math.prod(shape)
    if not dist.is_initialized():
        raise ValueError(f"a mesh of {need} ranks needs an initialized process group: {_launch_hint(need)}")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"need {need} ranks, the process group has {world}: {_launch_hint(need)}")
    dev = resolve_device(device)
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise ValueError(f"the process group runs {backend}; a {dev.type} mesh needs {BACKENDS[dev.type]}")
    return DeviceMesh(dev.type, torch.arange(need).reshape(shape), mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, *, device=None) -> DeviceMesh:
    """1-D ``("data",)`` mesh over the world's ranks on ``device``'s type
    (``None``: CUDA). ``n_devices`` defaults to the world size; raises
    ``ValueError`` when no group is initialized, when the world has another
    size, or when the group's backend is not the device's."""
    if n_devices is None:
        if not dist.is_initialized():
            raise ValueError(f"make_mesh needs an initialized process group: {_launch_hint('N')}")
        n_devices = dist.get_world_size()
    return _world_mesh((n_devices,), (DATA_AXIS,), device)


def make_multislice_mesh(n_slices: int, devices_per_slice: int, *, device=None) -> DeviceMesh:
    """2-D ``("dcn", "data")`` mesh: rank ``i * devices_per_slice + j`` at
    (slice i, device j), as the JAX mesh lays out its devices. The step
    reduces over both axes, so over every rank."""
    return _world_mesh((n_slices, devices_per_slice), (DCN_AXIS, DATA_AXIS), device)

