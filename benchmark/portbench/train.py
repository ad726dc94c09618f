"""Traffic kind ``train``: the port's lifetime training on a seeded stream.

Set-up builds one training object as ``train/driver.py`` builds it (the
model holding the seed's weights, ``create_train_state`` with its dropout
generator, ``make_multi_epoch_fn`` without shuffle or augment) and drives
it through its first steps by the window's own call: ``check_calls`` calls
on the stream's first rows (the first call captures the CUDA graph). The
window then calls it on the whole stream, one epoch a call (the trace
re-zeroed each epoch, the losses read back each epoch as the driver does),
until ``--seconds`` have passed. With ``--trace 1`` the window is instead
``trace_steps`` steps under the profiler, then ``attribution_steps`` eager
steps (the same kernels, outside the window) under the tail ranges.

Afterwards the program is freed and the plain reference follows the
checked steps from the same weights, rows and dropout seed.
"""

from __future__ import annotations

import math
import time

import torch

from portbench import check, tracing
from portbench.tiles import make_generator, synthetic_tiles
from portbench.tracing import free_cache, note, peak_bytes, sync
from portbench.weights import arch_file, build_port_model, build_reference, make_state_dict

DATA_STREAM, DROPOUT_STREAM = 0, 2
BETA1 = 0.9


def make_stream(cell, seed: int, device):
    """The cell's stream: images (N, H, W, 1) and masks (N, H, W) on the device."""
    size = cell.config["image_size"]
    x, y = synthetic_tiles(cell.workload["stream_tiles"], size, make_generator(seed, DATA_STREAM, device), device)
    return x[..., None], y


def lanes_of(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """(N, ...) -> (S, L, ...): lane l holds rows [l*S, (l+1)*S), the
    remainder dropped (the port's lane layout, worked out here again)."""
    s = x.shape[0] // lanes
    return x[: s * lanes].reshape(lanes, s, *x.shape[1:]).transpose(0, 1)


class Program:
    """The training object the window drives, and its readings of the checked steps."""

    def __init__(self, cell, sd: dict, x, y, seed: int, device):
        from plastic_unet_tpu_torch.train.loop import create_train_state, make_multi_epoch_fn, reshape_stream

        tc, wl = cell.config["train"], cell.workload
        self.model = build_port_model(cell.config, sd, device)
        gen = make_generator(seed, DROPOUT_STREAM, device)
        self.state = create_train_state(self.model, tc["lr"], tc["gamma"], tc["step_size"], lanes=wl["lanes"],
                                        generator=gen, device=device)
        self.run_epochs = make_multi_epoch_fn(loss_space=tc["loss_space"])
        self.X, self.Y = reshape_stream(x, y, wl["lanes"])
        self.loss_space = tc["loss_space"]

    def call(self, lo: int, hi: int) -> torch.Tensor:
        self.state, losses = self.run_epochs(self.state, self.X[lo:hi], self.Y[lo:hi], epochs=1)
        return losses[0]

    def checked_steps(self, sd: dict, calls: list) -> dict:
        """Run the checked steps through the window's call; read each loss,
        the first gradient from Adam's state, the parameters' change."""
        named = dict(self.model.named_parameters())
        losses, grad1, lo = [], None, 0
        for n in calls:
            losses.append(self.call(lo, lo + n))
            if grad1 is None:
                st = self.state.optimizer.state
                grad1 = check.leaf_norms({k: st[p]["exp_avg"] / (1 - BETA1) for k, p in named.items()
                                          if p in st and "exp_avg" in st[p]})
            lo += n
        change = check.leaf_norms({k: p.detach() - sd[k] for k, p in named.items()})
        return {"losses": torch.cat(losses).tolist(), "grad1": grad1, "change": change}

    def eager_steps(self, n: int) -> None:
        from plastic_unet_tpu_torch.train.loop import make_train_step

        step = make_train_step(loss_space=self.loss_space)
        for s in range(n):
            self.state, _ = step(self.state, (self.X[s], self.Y[s]))


def reference_steps(cell, sd: dict, x, y, seed: int, calls: list, device, tf32: bool = False) -> dict:
    """The plain reference over the checked steps: the same weights, rows,
    lanes and dropout seed, its state (a plastic model's trace) restarted
    where each call starts."""
    from reference.common import Adam, bce_logits, numerics

    tc, lanes = cell.config["train"], cell.workload["lanes"]
    with numerics(tf32):
        ref = build_reference(cell.config, sd, device).train()
        initial_state = arch_file(cell.config["arch"]).initial_state
        names = [k for k, _ in ref.named_parameters()]
        opt = Adam([p for _, p in ref.named_parameters()], tc["lr"])
        gen = make_generator(seed, DROPOUT_STREAM, device)
        X, Y = lanes_of(x, lanes), lanes_of(y, lanes)
        starts = {sum(calls[:i]) for i in range(len(calls))}
        losses, grad_steps = [], []
        state = None
        for s in range(sum(calls)):
            if s in starts:
                state = initial_state(ref, lanes, device)
            opt.lr = tc["lr"] * tc["gamma"] ** (s // max(int(tc["step_size"]), 1))
            for p in ref.parameters():
                p.grad = None
            activ, _, new_state = ref(X[s].permute(0, 3, 1, 2).contiguous(), state, generator=gen)
            if tc["loss_space"] != "logits":
                raise ValueError("the reference trains on the logits' loss only")
            loss = bce_logits(activ, Y[s])
            loss.backward()
            grad_steps.append(check.leaf_norms({k: p.grad for k, p in ref.named_parameters() if p.grad is not None}))
            opt.step()
            state = None if new_state is None else new_state.detach()
            losses.append(float(loss.detach()))
        change = check.leaf_norms({k: p.detach() - sd[k] for k, p in zip(names, ref.parameters())})
    return {"losses": losses, "grad1": grad_steps[0], "change": change, "grad_steps": grad_steps}


def setup(cell, seed: int, device, t_start: float | None = None):
    """(program, state_dict, x, y, program readings of the checked steps)."""
    x, y = make_stream(cell, seed, device)
    if t_start is not None:
        sync(device)
        note(t_start, "stream made")
    sd = make_state_dict(cell.config, seed, device)
    if t_start is not None:
        sync(device)
        note(t_start, "weights made")
    prog = Program(cell, sd, x, y, seed, device)
    if t_start is not None:
        sync(device)
        note(t_start, "weights and training state made")
    readings = prog.checked_steps(sd, cell.workload["check_calls"])
    return prog, sd, x, y, readings


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    wl = cell.workload
    lanes = wl["lanes"]
    out = {"counters": {"lanes": lanes}}
    with matmul_precision(cell.config["precision"]):
        prog, sd, x, y, readings = setup(cell, seed, device, t_start)
        sync(device)
        note(t_start, "checked steps run (graph captured): set-up ends")
        out["setup_s"] = time.perf_counter() - t_start
        steps_per_epoch = prog.X.shape[0]
        attempted = failed = 0
        if not trace:
            t0 = time.perf_counter()
            ends = []
            while True:
                losses = prog.call(0, steps_per_epoch).cpu()
                attempted += steps_per_epoch
                failed += int((~torch.isfinite(losses)).sum())
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            wall = time.perf_counter() - t0
            note(t_start, "window: epochs of " + " ".join(f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)) + " s")
            out["samples_per_s"] = attempted * lanes / wall
            out["counters"].update(steps=attempted, samples=attempted * lanes, window_s=wall)
        else:
            k = min(wl["trace_steps"], steps_per_epoch)
            calls = math.ceil(wl["trace_steps"] / k)
            with tracing.profiled() as held, tracing.DeviceClock(device) as clock:
                t0 = time.perf_counter()
                for _ in range(calls):
                    losses = prog.call(0, k)
                    attempted += k
                    failed += int((~torch.isfinite(losses)).sum())
                sync(device)
                wall = time.perf_counter() - t0
            out["trace"] = held.trace
            out["counters"].update(steps=attempted, samples=attempted * lanes, window_s=wall, event_ms=clock.ms)
        out["memory_peak_bytes"] = peak_bytes(device)
        if trace:
            n = wl["attribution_steps"]
            with tracing.tail_ranges(prog.model, backward=True), tracing.profiled("bench.attribution") as held:
                prog.eager_steps(n)
            out["attribution"] = held.trace
            out["counters"]["attribution_steps"] = n
    out["attempted"], out["failed"] = attempted, failed
    note(t_start, "window closed")
    del prog
    free_cache(device)
    ref = reference_steps(cell, sd, x, y, seed, wl["check_calls"], device)
    out["numbers"] = check.train_numbers(readings, ref)
    note(t_start, "reference compared")
    return out
