"""The lifetime training loop (counterpart of plastic_unet_tpu.train.loop).

Reference semantics being reproduced:
  per epoch:  hebb <- 0                       (the caller: ``state.hebb.zero_()``)
  per sample: forward(img, detached hebb) -> BCE -> backward -> Adam step
              -> StepLR step; hebb carries on; ``state.step`` counts samples.

The JAX package runs a whole epoch as one ``lax.scan`` over a stream resident
on the device, with no host transfer inside it. Here an epoch is a Python
loop over the same resident stream that never reads a value back: the
per-step losses stay on the device and come back as one tensor. On the card
the step is captured once into a CUDA graph and replayed per sample
(``graph=True``, the default there): a B=1 step is some hundred small kernel
launches, a few microseconds of device work each, so issued one by one the
host is the limit. The captured step is the eager step, kernel for kernel,
and gives the same bits (the step runs under utils.precision.training_numerics:
the precision policy in force, "parity" unless a matmul_precision block says
otherwise, and deterministic cuDNN algorithms; a graph is captured under the
policy in force at its capture). On the CPU the loop is eager. A model with
a bfloat16 ``compute_dtype`` trains the same way: its parameters, Adam and
the gradients Adam reads stay fp32, the gradients reaching them through the
model's casts.

Lanes (B>1): the sample stream is split into B independent lifetime streams
(:func:`reshape_stream`), each with its own trace, trained with one Adam
step per B samples on the lane-mean loss. The kernels are batched, so the
lanes are the batch dimension. B=1 reproduces the reference exactly.

PyTorch modules and optimizers are mutable: a step updates ``state`` in
place and returns it, where the JAX step returns a new state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from plastic_unet_tpu_torch import resolve_device
from plastic_unet_tpu_torch.ops.losses import bce_logits, bce_probs
from plastic_unet_tpu_torch.train.optimizer import StepLR, adam_step_lr
from plastic_unet_tpu_torch.utils.precision import training_numerics

LOSS_SPACES = ("logits", "probs")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: StepLR
    hebb: torch.Tensor  # (B, nbf, nbf), one lifetime trace per lane; updated in place
    step: int  # global sample-step counter
    generator: torch.Generator | None = None  # feeds the channel dropout, on the model's device


def create_train_state(model, lr: float, gamma: float = 0.666, step_size: float = 1e6, *, lanes: int = 1,
                       generator: torch.Generator | None = None, device=None) -> TrainState:
    """Move ``model`` to the device (``None`` means CUDA, and raises where
    there is none), put it in train mode and build the optimizer, the
    scheduler and a zero trace of ``lanes`` lanes. ``generator`` feeds the
    dropout and must live on that device; a model with ``dropout_ratio > 0``
    needs one."""
    dev = resolve_device(device)
    if generator is not None and generator.device.type != dev.type:
        raise ValueError(f"create_train_state: the dropout generator is on {generator.device}, the model on {dev}")
    model = model.to(dev).train()
    opt, sched = adam_step_lr(model.parameters(), lr, gamma, step_size)
    return TrainState(model, opt, sched, model.initial_zero_hebb(lanes, device=dev), 0, generator)


def _loss_fn(loss_space: str):
    if loss_space not in LOSS_SPACES:
        raise ValueError(f"loss_space must be one of {LOSS_SPACES}, got {loss_space!r}")
    if loss_space == "probs":
        return lambda out, mask: bce_probs(out.activout, mask)
    return lambda out, mask: bce_logits(out.activ, mask)


def _step_body(state: TrainState, loss_of, img: torch.Tensor, mask: torch.Tensor, reducer=None) -> torch.Tensor:
    """Forward with the detached trace, loss, backward, one Adam update and
    the trace carried on, all on the device; returns the detached loss. The
    same body runs eagerly and under graph capture. A data-parallel
    ``reducer`` (parallel.dp.MeshReducer) averages the gradients and the
    loss over the ranks before the update and gives the new trace its
    coherence mode before it is kept."""
    state.optimizer.zero_grad(set_to_none=True)
    out = state.model(img, state.hebb.detach(), generator=state.generator)
    loss = loss_of(out, mask)
    loss.backward()
    if reducer is not None:
        loss = reducer.gradients(state.model, loss)
    state.optimizer.step()
    hebb = out.hebb.detach()  # kept after the backward: the head keeps the old trace until then
    state.hebb.copy_(hebb if reducer is None else reducer.trace(hebb))
    return loss.detach()


def make_train_step(*, loss_space: str = "logits", reducer=None) -> Callable:
    """Build the eager per-step function: ``(state, (img, mask)) -> (state, loss)``.

    img: (B, H, W, C), mask: (B, H, W) or (B, H, W, 1), on the model's device.
    loss_space: 'logits' (stable, default) or 'probs' (reference-exact torch
    BCELoss clamp semantics). The loss is a 0-d tensor on the device.
    reducer: the data-parallel collectives of the step (see _step_body)."""
    loss_of = _loss_fn(loss_space)

    def train_step(state: TrainState, batch):
        img, mask = batch
        with training_numerics():
            loss = _step_body(state, loss_of, img, mask, reducer)
        state.scheduler.step()
        state.step += 1
        return state, loss

    return train_step


class GraphTrainStep:
    """The training step captured once into a CUDA graph and replayed per
    sample, with static input, target, trace and loss buffers (the
    counterpart of the whole-epoch ``lax.scan``). ``(state, (img, mask)) ->
    (state, loss)`` like the eager step; the loss is the graph's static
    output, valid until the next call.

    Before capture the step runs twice on a side stream, so that every kernel
    is built and loaded, cuDNN and cuBLAS hold their workspaces and Adam its
    moments; the model, the optimizer state, the trace and the dropout
    generator are then put back exactly as they were, so the captured
    trajectory is the eager one. The learning rate is a device tensor that
    the scheduler writes between replays.

    With a data-parallel ``reducer`` its NCCL all-reduces are captured too
    (they are issued on NCCL's stream, which joins the capture through
    events): every rank runs the warm-up steps, the restore and the capture
    in lockstep, and each replay runs the collectives again. The warm-up's
    first collective creates the communicator, which capture cannot."""

    def __init__(self, state: TrainState, batch_shape, mask_shape, *, loss_space: str = "logits", reducer=None):
        dev = state.hebb.device
        if dev.type != "cuda":
            raise RuntimeError("GraphTrainStep: a CUDA graph needs the model on a CUDA device")
        self.state = state
        loss_of = _loss_fn(loss_space)
        self.img = torch.zeros(batch_shape, device=dev)
        self.mask = torch.zeros(mask_shape, device=dev)
        self.hebb = state.hebb  # the static trace buffer
        self.graph = torch.cuda.CUDAGraph()
        if state.generator is not None:
            self.graph.register_generator_state(state.generator)

        kept = self._snapshot()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), training_numerics():
            for _ in range(2):
                _step_body(state, loss_of, self.img, self.mask, reducer)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._restore(kept)
        with training_numerics(), torch.cuda.graph(self.graph):
            self.loss = _step_body(state, loss_of, self.img, self.mask, reducer)

    def _tensors(self):
        st = self.state
        yield from st.model.parameters()
        yield from st.model.buffers()
        yield st.hebb
        for per_param in st.optimizer.state.values():
            yield from (v for v in per_param.values() if isinstance(v, torch.Tensor))

    def _snapshot(self):
        gen = self.state.generator
        return ({id(t): t.detach().clone() for t in self._tensors()}, None if gen is None else gen.get_state())

    def _restore(self, kept) -> None:
        """Every tensor back to its kept value, in place (the graph will hold
        these addresses); Adam state made by the warm-up starts from zero."""
        values, gen_state = kept
        with torch.no_grad():
            for t in self._tensors():
                if id(t) in values:
                    t.copy_(values[id(t)])
                else:
                    t.zero_()
        self.state.optimizer.zero_grad(set_to_none=True)
        if gen_state is not None:
            self.state.generator.set_state(gen_state)

    def __call__(self, state: TrainState, batch):
        if state is not self.state:
            raise ValueError("GraphTrainStep: the graph was captured for another TrainState")
        if state.hebb is not self.hebb:  # the caller rebound the trace: carry its values into the static buffer
            self.hebb.copy_(state.hebb)
            state.hebb = self.hebb
        img, mask = batch
        self.img.copy_(img)
        self.mask.copy_(mask.reshape(self.mask.shape))
        self.graph.replay()
        state.scheduler.step()
        state.step += 1
        return state, self.loss


def make_epoch_fn(*, loss_space: str = "logits", graph: bool | None = None, reducer=None) -> Callable:
    """Build the whole-epoch function.

    Signature: ``(state, X, Y) -> (state, losses)``
      X: (S, B, H, W, C), Y: (S, B, H, W), resident on the model's device:
      S sequential steps of B lanes. The caller re-zeroes the trace per
      epoch (``state.hebb.zero_()``).
    Returns the S per-step losses as one tensor on the device; nothing is
    read back to the host inside the epoch.

    graph: replay a CUDA graph of the step (captured at the first call, per
    state and batch shape) instead of issuing it eagerly. ``None`` means a
    graph for a model on a CUDA device and the eager step on the CPU; asking
    for a graph on the CPU raises. reducer: the data-parallel collectives of
    the step (parallel.dp.make_dp_epoch_fn), in the eager step and the
    graph alike."""
    eager_step = make_train_step(loss_space=loss_space, reducer=reducer)
    graphs: dict = {}

    def epoch(state: TrainState, X: torch.Tensor, Y: torch.Tensor):
        dev = state.hebb.device
        if X.device != dev or Y.device != dev:
            raise ValueError(f"make_epoch_fn: the stream must be resident on {dev}, got {X.device} and {Y.device}")
        step_fn = eager_step
        if dev.type == "cuda" if graph is None else graph:
            key = (id(state), tuple(X.shape[1:]), tuple(Y.shape[1:]))  # the graph keeps its state alive, so the id holds
            if key not in graphs:
                graphs[key] = GraphTrainStep(state, X.shape[1:], Y.shape[1:], loss_space=loss_space, reducer=reducer)
            step_fn = graphs[key]
        losses = torch.empty((X.shape[0],), dtype=torch.float32, device=dev)
        for s in range(X.shape[0]):
            state, loss = step_fn(state, (X[s], Y[s]))
            losses[s].copy_(loss)
        return state, losses

    return epoch


def make_multi_epoch_fn(*, loss_space: str = "logits", shuffle: bool = False, augment: bool = False,
                        reducer=None) -> Callable:
    """Build the K-epoch function (the counterpart of the JAX package's
    one-dispatch scan over epochs).

    Signature: ``(state, X, Y, perms, choices, *, epochs) -> (state, losses (K, S))``
      X: (S, B, H, W, C), Y: (S, B, H, W), resident on the model's device.
      perms: (K, S*B) int64 or None, a permutation of the flattened stream
      per epoch (when ``shuffle``); choices: (K, S*B, 3) or None, the
      augmentation choices per epoch (when ``augment``, see
      ops.augment.augment_stream). Both live on the device; the caller draws
      them in the order of the one-epoch path. ``epochs`` is K.
    Each epoch re-zeroes the trace in place, permutes the flattened stream,
    augments it and runs the per-sample loop of :func:`make_epoch_fn` (the
    CUDA graph on the card). The (K, S) losses stay on the device.
    reducer: as in :func:`make_epoch_fn` (parallel.dp.make_dp_multi_epoch_fn)."""
    from plastic_unet_tpu_torch.ops.augment import augment_stream

    epoch_fn = make_epoch_fn(loss_space=loss_space, reducer=reducer)

    def run(state: TrainState, X: torch.Tensor, Y: torch.Tensor, perms=None, choices=None, *, epochs: int):
        k, n = epochs, X.shape[0] * X.shape[1]
        if shuffle and tuple(perms.shape) != (k, n):
            raise ValueError(f"make_multi_epoch_fn: perms {tuple(perms.shape)} != ({k}, {n})")
        if augment and tuple(choices.shape) != (k, n, 3):
            raise ValueError(f"make_multi_epoch_fn: choices {tuple(choices.shape)} != ({k}, {n}, 3)")
        flat_x, flat_y = X.reshape((n,) + tuple(X.shape[2:])), Y.reshape((n,) + tuple(Y.shape[2:]))
        rows = []
        for j in range(k):
            xe, ye = flat_x, flat_y
            if shuffle:
                xe, ye = xe[perms[j]], ye[perms[j]]
            if augment:
                xe, ye = augment_stream(xe, ye, choices[j])
            state.hebb.zero_()  # fresh trace per epoch, in place: a captured graph holds its address
            state, losses = epoch_fn(state, xe.reshape(X.shape), ye.reshape(Y.shape))
            rows.append(losses)
        return state, torch.stack(rows)

    return run


def reshape_stream(X, Y, lanes: int):
    """Split a sample stream (N, ...) into (S, B, ...) lanes for the epoch.
    Trailing remainder samples are dropped in lane mode (B>1); B=1 keeps all.
    Lane l processes the contiguous stream chunk [l*S, (l+1)*S): each lane is
    an independent lifetime, preserving within-lane sequential order."""
    n = X.shape[0]
    s = n // lanes
    Xl = X[: s * lanes].reshape(lanes, s, *X.shape[1:]).transpose(0, 1).contiguous()
    Yl = Y[: s * lanes].reshape(lanes, s, *Y.shape[1:]).transpose(0, 1).contiguous()
    return Xl, Yl
