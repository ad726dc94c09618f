"""Data-parallel lifetime training over the ranks of a mesh (counterpart of
plastic_unet_tpu.parallel.dp).

The hebb trace is sequential state (sample n+1 depends on n). Two
trace-coherence modes, as in the JAX package:

  * ``"per_device"``: every rank (and lane) carries its own lifetime trace
    over its shard of the sample stream;
  * ``"pmean"``: after each step the lanes' mean trace is averaged over the
    ranks and given to every lane, one coherent trace across the mesh.

Each step, on each rank: the forward with the detached trace on the rank's
L lanes, the lane-mean loss, the backward, then one all-reduce of every
gradient and the loss packed into one flat buffer, divided by the world
size (the JAX ``pmean``), then Adam and the per-sample StepLR, then the
trace. The parameters and Adam's state stay replicated, since every rank
applies the same averaged gradient; the losses returned are the global
mean, the same on every rank. The step is train.loop's step with a
:class:`MeshReducer`: eager, or captured with its collectives into the CUDA
graph of train.loop.GraphTrainStep. The model is not wrapped in
DistributedDataParallel, so the state_dict keys stay the reference's.

Augmentation choices are drawn for the global ``S*D*L`` stream from one
generator seeded alike on every rank, and each rank takes the rows of its
lanes (:func:`shard_choices`); the shuffle permutes a rank's own block from
that rank's generator (:func:`shard_perms`) and calls no collective. So a
K-epoch dispatch equals K one-epoch dispatches bit for bit, as in JAX.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from plastic_unet_tpu_torch.train.loop import TrainState, make_epoch_fn, make_multi_epoch_fn

TRACE_MODES = ("per_device", "pmean")


def all_reduce_mean(t: torch.Tensor, world: int) -> torch.Tensor:
    """``t`` in place: its sum over the ranks divided by their count (the
    JAX ``pmean``); counts its calls in ``all_reduce_mean.launches``."""
    all_reduce_mean.launches += 1
    dist.all_reduce(t)
    return t.div_(world)


all_reduce_mean.launches = 0


class MeshReducer:
    """The collectives of a data-parallel step over every rank of ``mesh``
    (train.loop's ``reducer``): :meth:`gradients` after the backward,
    :meth:`trace` on the new trace."""

    def __init__(self, mesh: DeviceMesh, trace_mode: str = "per_device"):
        if trace_mode not in TRACE_MODES:
            raise ValueError(f"unknown trace_mode {trace_mode!r} (use one of {TRACE_MODES})")
        if dist.get_world_size() != mesh.size():
            raise ValueError(f"the mesh has {mesh.size()} ranks, the process group {dist.get_world_size()}")
        self.world = mesh.size()
        self.trace_mode = trace_mode

    def gradients(self, model: torch.nn.Module, loss: torch.Tensor) -> torch.Tensor:
        """One all-reduce of every gradient and the loss, packed into one
        flat buffer by one multi-tensor copy (torch.cat of the 100-odd
        tensors took 72 us of the 3.8 ms B=1 graph step on an H100,
        chip_smoke.py phase 16); each ``.grad`` becomes its view of the
        averaged buffer. Returns the averaged loss."""
        params = [p for p in model.parameters() if p.grad is not None]
        flat = torch.empty(sum(p.numel() for p in params) + 1, device=loss.device)
        views = [part.view_as(p) for p, part in zip(params, flat[:-1].split([p.numel() for p in params]))]
        torch._foreach_copy_(views + [flat[-1:]], [p.grad for p in params] + [loss.detach().reshape(1)])
        all_reduce_mean(flat, self.world)
        for p, view in zip(params, views):
            p.grad = view
        return flat[-1]

    def trace(self, hebb: torch.Tensor) -> torch.Tensor:
        """``per_device``: the lanes' own traces. ``pmean``: the lanes' mean,
        averaged over the ranks, given to every lane."""
        if self.trace_mode == "per_device":
            return hebb
        mean = hebb.mean(dim=0, keepdim=True)
        return all_reduce_mean(mean, self.world).expand_as(hebb)


def make_dp_epoch_fn(mesh: DeviceMesh, *, loss_space: str = "logits", trace_mode: str = "per_device",
                     graph: bool | None = None) -> Callable:
    """The data-parallel whole-epoch function ``(state, X, Y) -> (state,
    losses)`` of train.loop.make_epoch_fn, on this rank's shard: X (S, L, H,
    W, C), Y (S, L, H, W) on the rank's device, ``state.hebb`` (L, nbf,
    nbf). ``graph`` as there (``None``: a CUDA graph on the card)."""
    return make_epoch_fn(loss_space=loss_space, graph=graph, reducer=MeshReducer(mesh, trace_mode))


def make_dp_multi_epoch_fn(mesh: DeviceMesh, *, loss_space: str = "logits", trace_mode: str = "per_device",
                           shuffle: bool = False, augment: bool = False) -> Callable:
    """The data-parallel K-epoch function of train.loop.make_multi_epoch_fn
    on this rank's shard: ``perms`` from :func:`shard_perms`, ``choices``
    from :func:`shard_choices`."""
    return make_multi_epoch_fn(loss_space=loss_space, shuffle=shuffle, augment=augment,
                               reducer=MeshReducer(mesh, trace_mode))


def shard_perms(X: torch.Tensor, generator: torch.Generator, epochs: int) -> torch.Tensor:
    """(epochs, S*L) permutations of this rank's flattened (S, L) block, one
    an epoch, from the rank's own generator: the shard-local shuffle. No
    sample crosses a rank and no collective runs (the single-device run is
    its one-rank case)."""
    n = X.shape[0] * X.shape[1]
    return torch.stack([torch.randperm(n, generator=generator, device=generator.device) for _ in range(epochs)])


def shard_choices(choices: torch.Tensor, lanes: int, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of augmentation choices drawn for the global stream:
    (K, S*D*L, 3) -> (K, S*L, 3), local (step s, lane l) taking global row
    ``s*D*L + d*L + l`` on rank d (JAX ``dp.py:207-221``)."""
    k, n = choices.shape[:2]
    world = mesh.size()
    s = n // (world * lanes)
    return choices.reshape(k, s, world, lanes, 3)[:, :, dist.get_rank()].reshape(k, s * lanes, 3)


def shard_stream(X, Y, mesh: DeviceMesh, lanes_per_device: int = 1):
    """This rank's (S, L, ...) columns ``[rank*L, (rank+1)*L)`` of the JAX
    (S, D*L, ...) layout of a stream (N, ...): lane l carries global samples
    ``[l*S, (l+1)*S)``, S = N // (D*L), the remainder dropped. On the mesh's
    device type (CUDA: the current device)."""
    world, lanes = mesh.size(), lanes_per_device
    lo = dist.get_rank() * lanes

    def columns(a):
        a = torch.as_tensor(a)
        s = a.shape[0] // (world * lanes)
        block = a[lo * s:(lo + lanes) * s].reshape(lanes, s, *a.shape[1:])
        return block.transpose(0, 1).contiguous().to(mesh.device_type)

    return columns(X), columns(Y)


def dp_state_sharding(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """Replicate the parameters and buffers: rank 0's, broadcast once (one
    flat buffer a dtype), so that every rank starts from the same model; the
    trace stays the rank's own lanes (the JAX layout: params replicated,
    hebb lane-sharded)."""
    tensors = [t for t in (*state.model.parameters(), *state.model.buffers())]
    with torch.no_grad():
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            group = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))
    return state
