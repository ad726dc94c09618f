"""Checkpoints (counterpart of plastic_unet_tpu.train.checkpoint).

The reference writes three artifacts per save (src/train.py:150-203), and
so does :func:`save_reference_artifacts`:
  1. <prefix>_data.hdf5: gzip/shuffle/fletcher32 datasets net/{w,alpha,eta},
     train/all_losses, validation/{train_losses,test_losses,accuracies}, the
     schema the reference's visualizer reads. Where h5py is not installed
     this one file is not written, and the save prints a line saying so.
  2. <prefix>_parameters.dat: the pickled run-params dict.
  3. <prefix>_net.pth: the state_dict under the reference's names.

In place of the JAX package's Orbax state, :func:`save_train_state` and
:func:`load_train_state` keep everything an exact resume needs in one
``torch.save`` file: the parameters, the Adam moments and step counts, the
scheduler, the trace, the sample-step counter and the states of the
dropout, shuffle and augmentation generators. Loading writes into the
existing tensors, so a CUDA graph captured afterwards sees the resumed
values at the addresses the TrainState already has.

Under data parallel (a ``mesh``) the file is still one file: the
parameters and Adam's state are replicated, so rank 0's are written; the
trace lanes are gathered in rank order (D*L lanes) and every rank's
generator states beside them (``world_size`` says how many). Rank 0
writes while the others wait at a barrier; loading gives each rank its
lane block and its own generators back, and refuses a file of another
world size (or of a single-device run).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

H5_OPTS = dict(compression="gzip", shuffle=True, fletcher32=True)
STATE_FORMAT = 1


def state_dict_to_host(model: torch.nn.Module) -> dict:
    """The model's state_dict on the CPU through one device-to-host copy
    (every entry is packed into one flat tensor per dtype on the device)."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    out = {}
    for dtype in dict.fromkeys(v.dtype for v in sd.values()):
        keys = [k for k, v in sd.items() if v.dtype == dtype]
        flat = torch.cat([sd[k].reshape(-1) for k in keys]).cpu()
        for k, part in zip(keys, flat.split([sd[k].numel() for k in keys])):
            out[k] = part.reshape(sd[k].shape).clone()
    return {k: out[k] for k in sd}


def save_reference_artifacts(prefix: str, model: torch.nn.Module, run_params: dict, all_losses, val_train_losses,
                             val_test_losses, val_accuracies) -> None:
    """Write the reference's three checkpoint artifacts at <prefix>_*."""
    sd = state_dict_to_host(model)
    try:
        import h5py
    except ImportError:
        print(f"h5py is not installed: {prefix}_data.hdf5 was not written")
    else:
        with h5py.File(prefix + "_data.hdf5", "w") as f:
            # net/{w,alpha,eta} exist only for plastic models
            for key in ("w", "alpha", "eta"):
                if key in sd:
                    f.create_dataset(f"net/{key}", data=sd[key].numpy(), **H5_OPTS)
            f.create_dataset("train/all_losses", data=np.asarray(all_losses, dtype=np.float64), **H5_OPTS)
            f.create_dataset("validation/train_losses", data=np.asarray(val_train_losses, dtype=np.float64), **H5_OPTS)
            f.create_dataset("validation/test_losses", data=np.asarray(val_test_losses, dtype=np.float64), **H5_OPTS)
            f.create_dataset("validation/accuracies", data=np.asarray(val_accuracies, dtype=np.float64), **H5_OPTS)
            f.flush()

    with open(prefix + "_parameters.dat", "wb") as fo:
        pickle.dump(run_params, fo)

    torch.save(sd, prefix + "_net.pth")


def save_train_state(path: str, state, generators: dict, mesh=None) -> None:
    """Everything an exact resume needs, in one file. ``generators`` maps a
    name (e.g. "shuffle", "augment") to a torch.Generator or None; the
    dropout generator is the TrainState's own. Under a ``mesh`` every rank
    calls this (it gathers) and rank 0 writes."""
    gens = dict(generators, dropout=state.generator)
    states = {k: None if g is None else g.get_state() for k, g in gens.items()}
    hebb = state.hebb.detach()
    if mesh is not None:
        lanes = [torch.empty_like(hebb) for _ in range(mesh.size())]
        dist.all_gather(lanes, hebb.contiguous())
        hebb = torch.cat(lanes)
        per_rank = [None] * mesh.size()
        dist.all_gather_object(per_rank, states)  # CPU byte tensors, pickled through the rank's device
        states = {k: [s[k] for s in per_rank] for k in states}
    if mesh is None or dist.get_rank() == 0:
        payload = {
            "format": STATE_FORMAT,
            "model": state_dict_to_host(state.model),
            "optimizer": state.optimizer.state_dict()["state"],
            "scheduler_steps": state.scheduler.last_epoch,
            "hebb": hebb.cpu(),
            "step": state.step,
            "generators": states,
            "world_size": None if mesh is None else mesh.size(),
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        dist.barrier()


def load_train_state(path: str, state, generators: dict, mesh=None) -> None:
    """Restore a file of :func:`save_train_state` into ``state`` and the
    named generators, in place. Parameters and the trace are copied into
    their tensors; the optimizer's moments are loaded before any CUDA graph
    of the step is captured (they are new tensors); the learning rate is set
    from the scheduler's step count. Under a ``mesh`` each rank takes its
    lanes and its generators."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != STATE_FORMAT:
        raise ValueError(f"{path}: not a resume-state file of this package (format {payload.get('format')!r})")
    world = None if mesh is None else mesh.size()
    saved = payload.get("world_size")
    if saved != world:
        runs = {None: "a single-device run"}
        raise ValueError(f"{path} was saved by {runs.get(saved, f'{saved} ranks')}; this is "
                         f"{runs.get(world, f'{world} ranks')}")
    hebb, gen_states = payload["hebb"], payload["generators"]
    if mesh is not None:
        rank, lanes = dist.get_rank(), state.hebb.shape[0]
        hebb = hebb[rank * lanes:(rank + 1) * lanes]
        gen_states = {k: v[rank] for k, v in gen_states.items()}
    state.model.load_state_dict(payload["model"], strict=True)
    current = state.optimizer.state_dict()
    state.optimizer.load_state_dict({"state": payload["optimizer"], "param_groups": current["param_groups"]})
    state.scheduler.restore(payload["scheduler_steps"])
    with torch.no_grad():
        state.hebb.copy_(hebb)
    state.step = int(payload["step"])
    gens = dict(generators, dropout=state.generator)
    for name, saved in gen_states.items():
        if (gens.get(name) is None) != (saved is None):
            raise ValueError(f"{path}: the {name} generator was {'absent' if saved is None else 'present'} "
                             "when saved; the resuming run must have the same")
        if saved is not None:
            gens[name].set_state(saved)
