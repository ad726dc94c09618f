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
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

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


def save_train_state(path: str, state, generators: dict) -> None:
    """Everything an exact resume needs, in one file. ``generators`` maps a
    name (e.g. "shuffle", "augment") to a torch.Generator or None; the
    dropout generator is the TrainState's own."""
    gens = dict(generators, dropout=state.generator)
    payload = {
        "format": STATE_FORMAT,
        "model": state_dict_to_host(state.model),
        "optimizer": state.optimizer.state_dict()["state"],
        "scheduler_steps": state.scheduler.last_epoch,
        "hebb": state.hebb.detach().cpu(),
        "step": state.step,
        "generators": {k: None if g is None else g.get_state() for k, g in gens.items()},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, state, generators: dict) -> None:
    """Restore a file of :func:`save_train_state` into ``state`` and the
    named generators, in place. Parameters and the trace are copied into
    their tensors; the optimizer's moments are loaded before any CUDA graph
    of the step is captured (they are new tensors); the learning rate is set
    from the scheduler's step count."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != STATE_FORMAT:
        raise ValueError(f"{path}: not a resume-state file of this package (format {payload.get('format')!r})")
    state.model.load_state_dict(payload["model"], strict=True)
    current = state.optimizer.state_dict()
    state.optimizer.load_state_dict({"state": payload["optimizer"], "param_groups": current["param_groups"]})
    state.scheduler.restore(payload["scheduler_steps"])
    with torch.no_grad():
        state.hebb.copy_(payload["hebb"])
    state.step = int(payload["step"])
    gens = dict(generators, dropout=state.generator)
    for name, saved in payload["generators"].items():
        if (gens.get(name) is None) != (saved is None):
            raise ValueError(f"{path}: the {name} generator was {'absent' if saved is None else 'present'} "
                             "when saved; the resuming run must have the same")
        if saved is not None:
            gens[name].set_state(saved)
