"""Run configuration (counterpart of plastic_unet_tpu.config): one dataclass
in place of the reference's params dict (train.py:267-282) and flag sets,
with every field and default of the JAX package's TrainConfig.

Fields of options the port does not have keep their names and defaults so
that a configuration carries over; ``train.driver.build_model`` raises a
``ValueError`` naming each one set away from its default, with its reason
(``batch_norm``: the models have it, the JAX trainer cannot train it).
``compute_dtype`` "bfloat16" runs UNetPRes's trunk in bf16 (UNetP refuses
it), and ``matmul_precision`` is the cuDNN/cuBLAS policy the driver opens
around training, validation and the saves (utils.precision). ``arch`` is
``"unet_res"`` (UNetPRes) or ``"unet"`` (the classic UNetP, which refuses
the trunk options with the JAX driver's message).
``trunk_pad`` and ``remat_trunk`` reach the model. ``use_pallas``,
``pallas_trunk``, ``patch_conv`` and ``fast_dw`` are TPU lowerings of the
same math: accepted, they change nothing, since on CUDA the port's kernels
are its only path. ``bilinear_upsample`` is unused by UNetPRes, as in the
JAX package; ``rng_impl`` names a JAX PRNG, and the port draws from torch
generators whichever it names. ``devices > 1`` trains data parallel, one
rank a device under torchrun (train.driver.start_train, parallel);
``trace_mode`` matters only there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence


@dataclasses.dataclass
class TrainConfig:
    # --- reference hyperparameters (train.py:213-231 defaults) ---
    out_dir: str = "./out"
    epochs: int = 5
    lr: float = 3e-5
    val_ratio: float = 0.05  # stored but unused, as in the reference
    val_every: int = 50
    save_every: int = 100
    gamma: float = 0.666
    steplr: float = 1e6
    rollout: int = 50000
    prule: str = "hebb"
    max_train_time: int = -1  # seconds; predictive early stop (train.py:118-122)
    debug: bool = False
    load: bool = False
    model_path: str = "MODEL.pth"

    # --- geometry (train.py:370-372) ---
    im_width: int = 101
    im_height: int = 101
    im_chan: int = 1

    # --- model family / architecture ---
    arch: str = "unet_res"  # 'unet_res' (UNetPRes) | 'unet' (the classic UNetP)
    neurons: int = 16
    dropout_ratio: float = 0.5
    alfa_type: str = "free"
    batch_norm: bool = False  # the models have it; build_model raises (no trainer: the JAX one cannot train it)
    bilinear_upsample: bool = False  # UNetP's upsample; unused by UNetPRes, as in the JAX package

    # --- throughput and precision knobs (defaults = reference parity) ---
    lanes: int = 1  # parallel lifetime streams (1 == reference)
    devices: int = 1  # data-parallel devices, one rank each (torchrun); 1 = one device, no process group
    loss_space: str = "logits"  # 'logits' (stable) | 'probs' (torch-exact clamp)
    matmul_precision: str = "perf"  # cuDNN/cuBLAS may use TF32; 'parity' for true fp32 (TF32 off)
    use_pallas: bool = False  # accepted; the CUDA head is the only path on the card
    pallas_trunk: bool = False  # accepted; the CUDA residual tails are the only path on the card
    fast_dw: bool = False  # accepted; a TPU lowering of the same conv
    remat_trunk: bool = False  # torch.utils.checkpoint around each trunk module: the same bits, less memory
    patch_conv: int = 0  # accepted; a TPU lowering of the same conv
    trunk_pad: int = 0  # reflect-pad the input to (trunk_pad, trunk_pad), crop the logits back (0 = off)
    plastic: bool = True  # False = vanilla U-Net head (sigmoid on trunk logits)
    compute_dtype: str = "float32"  # 'bfloat16': UNetPRes's trunk in bf16 (params, head, loss fp32)
    augment: bool = False  # random flip/rotate per sample and epoch
    shuffle: bool = False  # per-epoch stream shuffle (the reference keeps a fixed order, train.py:91)
    tta: Sequence[str] = ("identity",)  # inference-time TTA views
    seed: int = 42
    rng_impl: str = "threefry"  # threefry | rbg | unsafe_rbg: the JAX PRNG; the port's torch generators either way
    epochs_per_dispatch: int = 1  # fold up to K epochs into one dispatch; chunks never cross a
    # validation/save/rollout boundary; >1 coarsens the stop check and NaN detection to chunks
    quirk_epoch_loss: bool = True  # reproduce train.py:115 (all_losses[-N] scalar)
    trace_mode: str = "per_device"  # 'per_device' | 'pmean' (several devices only)
    resume_orbax: str = ""  # path of a resume-state file (train.checkpoint.save_train_state)
    # for exact resume: parameters, Adam moments, scheduler, trace, step and the generators

    @property
    def stop_time(self) -> float:
        return time.time() + self.max_train_time if self.max_train_time > 0 else -1.0

    def as_run_params(self, stop_time: float | None = None, device: str = "cuda") -> dict:
        """The reference's pickled params-dict shape (train.py:267-282);
        ``device`` is the device the run used."""
        return {
            "out_dir": self.out_dir,
            "device": device,
            "epochs": self.epochs,
            "stop_time": self.stop_time if stop_time is None else stop_time,
            "lr": self.lr,
            "val_ratio": self.val_ratio,
            "val_every": self.val_every,
            "save_every": self.save_every,
            "rollout": self.rollout,
            "gamma": self.gamma,
            "steplr": self.steplr,
            "prule": self.prule,
            "im_width": self.im_width,
            "im_height": self.im_height,
            "im_chan": self.im_chan,
            "debug": self.debug,
        }
