"""Optimizer: Adam + StepLR with reference-exact semantics (counterpart of
plastic_unet_tpu.train.optimizer).

The reference steps Adam *and* the StepLR scheduler once per SAMPLE, so the
decay step size is measured in samples, not epochs. Update k (0-based) uses
``lr * gamma**floor(k / step_size)``: the scheduler steps after the optimizer.

:class:`StepLR` is torch's ``lr_scheduler.StepLR`` in closed form. It exists
because on the card the learning rate is a device tensor (Adam with
``capturable=True``, so that a CUDA graph of the step reads the current
rate instead of a constant frozen at capture) and is written with ``fill_``
between steps, which enqueues a kernel and does not wait for the device.
"""

from __future__ import annotations

import torch


class StepLR:
    """``lr * gamma**(k // step_size)`` after k calls of :meth:`step`;
    ``step_size`` is clamped to >= 1 as in the JAX package."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr: float, gamma: float, step_size: float):
        self.optimizer, self.base_lr, self.gamma = optimizer, float(lr), float(gamma)
        self.step_size = max(int(step_size), 1)
        self.last_epoch = 0
        self._set(self.get_last_lr())

    def get_last_lr(self) -> float:
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)

    def _set(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def restore(self, steps: int) -> None:
        """Set the count of :meth:`step` calls (a resume) and the rate that goes with it."""
        self.last_epoch = int(steps)
        self._set(self.get_last_lr())

    def step(self) -> None:
        self.last_epoch += 1
        if self.last_epoch % self.step_size == 0:
            self._set(self.get_last_lr())


def adam_step_lr(params, lr: float, gamma: float = 0.666, step_size: float = 1e6):
    """(Adam(lr, betas=(0.9, 0.999), eps=1e-8), StepLR stepped once per
    sample), matching the reference. For parameters on a CUDA device the
    optimizer is capturable and its rate a tensor on that device."""
    params = list(params)
    on_card = bool(params) and params[0].device.type == "cuda"
    rate = torch.tensor(float(lr), dtype=torch.float32, device=params[0].device) if on_card else float(lr)
    opt = torch.optim.Adam(params, lr=rate, betas=(0.9, 0.999), eps=1e-8, capturable=on_card)
    return opt, StepLR(opt, lr, gamma, step_size)
