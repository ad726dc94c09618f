"""Staging the sample stream by rank (counterpart of
plastic_unet_tpu.parallel.multihost).

In JAX a process may drive several devices and stages the slice of the
stream its devices hold. Here a process is a rank with one device, so each
rank loads and stages only its own contiguous slice of the stream.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def process_local_slice(n_total: int) -> slice:
    """The [start, stop) slice of a length-n_total sample stream this rank
    loads (contiguous blocks of ceil(n_total / world)); the whole stream
    without a process group."""
    pc, pi = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    per = -(-n_total // pc)
    return slice(pi * per, min((pi + 1) * per, n_total))


def local_lane_block(X_local: np.ndarray, Y_local: np.ndarray, process_count: int, total_lanes: int):
    """The layout math of a rank's block: its contiguous samples as its
    (S, lanes_local, ...) lane block, S = len(X_local) * process_count //
    total_lanes. Stacking the ranks' blocks along the lane axis gives
    parallel.dp.shard_stream's layout of the whole stream when its length
    is a multiple of total_lanes (lane l carries samples [l*S, (l+1)*S))."""
    n_local = X_local.shape[0]
    s = (n_local * process_count) // total_lanes
    lanes_local = total_lanes // process_count
    Xl = X_local[: s * lanes_local].reshape(lanes_local, s, *X_local.shape[1:]).swapaxes(0, 1)
    Yl = Y_local[: s * lanes_local].reshape(lanes_local, s, *Y_local.shape[1:]).swapaxes(0, 1)
    return Xl, Yl


def stage_global_stream(X_local: np.ndarray, Y_local: np.ndarray, mesh: DeviceMesh, lanes_per_device: int = 1):
    """This rank's (S, L, ...) block of the stream, on the rank's device,
    from the rank's own samples (``process_local_slice`` of a stream whose
    length is a multiple of D*L; with one rank, any stream, as
    parallel.dp.shard_stream)."""
    world = mesh.size()
    Xl, Yl = local_lane_block(np.asarray(X_local), np.asarray(Y_local), world, world * lanes_per_device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device_type) for a in (Xl, Yl))
