"""The serving forward's kernels as ``torch.library`` custom ops, so that
``torch.export`` can trace the forward and a loaded program can launch them
(submit.export).

The kernels load through ``ctypes`` (ops._build) and run inside
``autograd.Function``s; ``torch.export`` traces neither. Each op here wraps
what the eager path calls, with a fake kernel that gives the output's shape:

  - ``plastic_unet_tpu_torch::plastic_head_forward``: ops.plastic_head's
    forward (one launch of ``csrc/plastic_head.cu`` with its ``head_plan`` on
    CUDA tensors, the plain head on CPU tensors);
  - ``plastic_unet_tpu_torch::residual_tail_forward``: ops.residual_tail's
    forward (on CUDA tensors one launch of ``csrc/residual_tail.cu`` or four
    ``conv3x3`` launches, by its ``tail_plan``; the plain chain on CPU
    tensors);
  - ``plastic_unet_tpu_torch::entry_conv_forward``: ops.conv3x3.conv3x3_same's
    forward (one ``conv3x3`` launch on CUDA tensors, the plain conv on CPU
    tensors), the trunks' entry convs that models.blocks.EntryConv routes
    to the kernel.

They are the only kernels the serving forward launches: each of its 9 tails
a chunk is one launch of the fused tail kernel or four ``conv3x3`` launches,
as ops.residual_tail.tail_plan routes its shape, and each routed entry conv
one ``conv3x3`` launch. Each op counts on its wrapper's counter of
utils.profiling (``kernel.head.all``,
``kernel.tail_fwd.all`` and, inside the tail, ``kernel.tail_fwd.fused`` or
``kernel.conv3x3.fwd``), as the eager path does. models.blocks and
models.unet_res call these ops only while ``torch.compiler.is_exporting()``
is true, so the eager path, the CUDA-graph training step and their bits are
unchanged. Importing this module registers the ops; a process that loads an
exported program imports it first (submit.export does).
"""

from __future__ import annotations

import torch

from plastic_unet_tpu_torch.ops import conv3x3 as _conv
from plastic_unet_tpu_torch.ops import plastic_head as _head
from plastic_unet_tpu_torch.ops import residual_tail as _tail
from plastic_unet_tpu_torch.ops.plasticity import check_head_args

Tensor = torch.Tensor


@torch.library.custom_op("plastic_unet_tpu_torch::plastic_head_forward", mutates_args=())
def plastic_head_forward(w: Tensor, alpha: Tensor, eta: Tensor, activin: Tensor, hebb: Tensor,
                         rule: str, alfa_type: str) -> tuple[Tensor, Tensor, Tensor]:
    """(activ, activout, new_hebb) of ops.plastic_head.plastic_head, outside autograd."""
    check_head_args(rule, alfa_type)
    return _head._forward(w, alpha, eta, activin, hebb, rule, alfa_type, None)


@plastic_head_forward.register_fake
def _(w, alpha, eta, activin, hebb, rule, alfa_type):
    return tuple(torch.empty_like(activin, memory_format=torch.contiguous_format) for _ in range(3))


@torch.library.custom_op("plastic_unet_tpu_torch::residual_tail_forward", mutates_args=())
def residual_tail_forward(x0: Tensor, w11: Tensor, b11: Tensor, w12: Tensor, b12: Tensor,
                          w21: Tensor, b21: Tensor, w22: Tensor, b22: Tensor) -> Tensor:
    """ops.residual_tail.residual_tail's output, outside autograd."""
    out, _, _ = _tail._launch_forward(x0, w11, b11, w12, b12, w21, b21, w22, b22)
    return out


@residual_tail_forward.register_fake
def _(x0, w11, b11, w12, b12, w21, b21, w22, b22):
    return torch.empty_like(x0, memory_format=torch.contiguous_format)


@torch.library.custom_op("plastic_unet_tpu_torch::entry_conv_forward", mutates_args=())
def entry_conv_forward(x: Tensor, weight: Tensor, bias: Tensor) -> Tensor:
    """ops.conv3x3.conv3x3_same's output, outside autograd."""
    return _conv.conv3x3(x.contiguous(), _conv.hwio(weight), bias.contiguous())


@entry_conv_forward.register_fake
def _(x, weight, bias):
    return x.new_empty((*x.shape[:3], weight.shape[0]))
