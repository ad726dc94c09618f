"""Training driver (counterpart of plastic_unet_tpu.train.driver): the
reference's train()/start_train() flow (src/train.py:29-314) around the
port's epoch loop.

Observable behaviour kept from the JAX driver:
  * the per-epoch trace re-zero (train.py:88) and the per-sample stream;
  * the predictive wall-clock stop: end when the estimated end of the next
    dispatch would pass stop_time (train.py:118-122), the per-epoch time
    scaled by the next chunk's length;
  * validation every val_every epochs and at the end; checkpoints every
    save_every epochs and at the end, with file names rolled every
    `rollout` epochs (train.py:131-203), in the reference's formats
    (train.checkpoint);
  * the NaN abort, which saves NAN_ABORT_* with the losses up to the first
    bad epoch of the dispatch;
  * KeyboardInterrupt and SIGTERM save INTERRUPTED_* (train.py:306-312);
  * resume from a reference .pth (``load``) or, exactly, from the port's
    resume-state file (``resume_orbax``, train.checkpoint.save_train_state);
  * both forms of the train.py:115 epoch-loss quirk (``quirk_epoch_loss``).

How the port runs it: the stream goes to the device once (NHWC); every
dispatch folds up to ``epochs_per_dispatch`` epochs (train.loop.
make_multi_epoch_fn, the step replayed from a CUDA graph on the card) and
its losses come back in one transfer. Dropout, shuffle and augmentation
each draw from their own ``torch.Generator`` on the device, seeded from
``cfg.seed`` (+0, +1, +2): their streams are not the JAX package's, so a
run with any of them on follows its own trajectory, reproducible from the
seed, and resumes bit for bit from the resume-state file.

Data parallel (``cfg.devices > 1``, or a mesh handed to
:func:`start_train`): one process per device under torchrun, each rank
holding ``cfg.lanes`` lanes of the JAX (S, D*L) layout (parallel.dp). Each
rank stages only its slice of the stream (parallel.multihost); the dropout
and shuffle generators are seeded from (seed, rank), so each rank draws its
own masks and permutes its own block, and the augmentation generator alike
on every rank, which draws for the global stream. The losses and the
validation are the same on every rank; rank 0 alone prints, writes the
artifacts and the resume-state file (the others wait at a barrier), and
the resume-state file keeps every rank's trace lanes and generators.
"""

from __future__ import annotations

import os
import sys
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from plastic_unet_tpu_torch import resolve_device
from plastic_unet_tpu_torch.config import TrainConfig
from plastic_unet_tpu_torch.eval.evaluate import eval_net
from plastic_unet_tpu_torch.models.unet_classic import UNetP
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops.augment import draw_augment_choices
from plastic_unet_tpu_torch.parallel import dp
from plastic_unet_tpu_torch.parallel.mesh import make_mesh, rank_device
from plastic_unet_tpu_torch.parallel.multihost import process_local_slice, stage_global_stream
from plastic_unet_tpu_torch.train import loop
from plastic_unet_tpu_torch.train.checkpoint import load_train_state, save_reference_artifacts, save_train_state
from plastic_unet_tpu_torch.train.loop import TrainState, create_train_state, reshape_stream
from plastic_unet_tpu_torch.utils.precision import matmul_precision

RESUME_STATE = "train_state.pt"  # the port's counterpart of the JAX driver's orbax_state directory


RNG_IMPLS = ("threefry", "rbg", "unsafe_rbg")  # the JAX CLI's choices; each is one more stream here
RANK_STRIDE = 0x9E3779B9  # between the ranks' seeds; odd, so the low 32 bits (all a CPU generator reads) differ


def build_model(cfg: TrainConfig) -> torch.nn.Module:
    """The configured model (nbf = image width, as at every reference call
    site), its weights drawn from ``cfg.seed``: UNetPRes for
    ``arch="unet_res"``, the classic UNetP for ``arch="unet"``. For
    UNetPRes ``trunk_pad``, ``remat_trunk`` and ``compute_dtype`` reach the
    model (the weights are the same fp32 draws whatever the dtype);
    ``patch_conv``, ``fast_dw``, ``use_pallas`` and ``pallas_trunk`` (TPU
    lowerings of the same math), ``bilinear_upsample`` (unused by UNetPRes,
    as in the JAX package) and ``rng_impl`` (the JAX PRNG; the port draws
    from torch generators, another stream whichever is named) are accepted
    and change nothing. UNetP rejects the trunk options with the JAX
    driver's message, takes ``bilinear_upsample`` and ``use_pallas``, and,
    as in the JAX driver, is built plastic whatever ``plastic`` says. Raises
    ValueError for ``batch_norm``, which no trainer runs, with the reason."""
    if cfg.arch not in ("unet_res", "unet"):
        raise ValueError(f"unknown arch {cfg.arch!r} (use 'unet_res' or 'unet')")
    if cfg.batch_norm:
        raise ValueError(f"plastic_unet_tpu_torch does not train batch_norm: "
                         f"{'UNetPRes' if cfg.arch == 'unet_res' else 'UNetP'} has it, but the JAX train step "
                         "applies a model with params only and cannot train one with batch_stats, so there is no "
                         "trainer to port (ROADMAP.md, queue A)")
    if cfg.rng_impl not in RNG_IMPLS:
        raise ValueError(f"rng_impl must be one of {RNG_IMPLS}, got {cfg.rng_impl!r}")
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.arch == "unet":
        # the JAX driver's list and message: UNetP has none of the trunk options
        unsupported = {"trunk_pad": cfg.trunk_pad, "patch_conv": cfg.patch_conv, "pallas_trunk": cfg.pallas_trunk,
                       "fast_dw": cfg.fast_dw, "remat_trunk": cfg.remat_trunk}
        bad = [k for k, v in unsupported.items() if v]
        if cfg.compute_dtype != "float32":
            bad.append("compute_dtype")
        if bad:
            raise ValueError(f"arch 'unet' does not support {bad}; these options apply to the unet_res trunk only")
        return UNetP(n_channels=cfg.im_chan, n_classes=1, alfa_type=cfg.alfa_type, rule=cfg.prule,
                     nbf=cfg.im_width, bilinear_upsample=cfg.bilinear_upsample, use_pallas=cfg.use_pallas,
                     generator=gen)
    return UNetPRes(n_channels=cfg.im_chan, n_classes=1, neurons=cfg.neurons, dropout_ratio=cfg.dropout_ratio,
                    alfa_type=cfg.alfa_type, rule=cfg.prule, nbf=cfg.im_width,
                    bilinear_upsample=cfg.bilinear_upsample, use_pallas=cfg.use_pallas,
                    pallas_trunk=cfg.pallas_trunk, fast_dw=cfg.fast_dw, patch_conv=cfg.patch_conv,
                    plastic=cfg.plastic, remat_trunk=cfg.remat_trunk, trunk_pad=cfg.trunk_pad,
                    compute_dtype=cfg.compute_dtype, generator=gen)


def name_map_for(cfg: TrainConfig) -> dict:
    """flax path -> (state_dict key, transpose) of the configured model; a
    plastic=False config has no head keys (for UNetP too, as in the JAX
    driver, though UNetP keeps its head: loading such a map then raises)."""
    from plastic_unet_tpu_torch.utils.torch_interop import unetp_name_map, unetp_res_name_map

    if cfg.arch not in ("unet_res", "unet"):
        raise ValueError(f"plastic_unet_tpu_torch has no name map for arch {cfg.arch!r}")
    m = unetp_res_name_map() if cfg.arch == "unet_res" else unetp_name_map(cfg.bilinear_upsample)
    if not cfg.plastic:
        m = {k: v for k, v in m.items() if k not in (("w",), ("alpha",), ("eta",))}
    return m


def load_reference_weights(model: torch.nn.Module, path: str, cfg: TrainConfig) -> None:
    """A reference-format .pth into ``model`` in place (strict over the
    configured model's keys; a plastic=False model ignores the head's)."""
    from plastic_unet_tpu_torch.utils.torch_interop import load_pth

    sd = load_pth(path)
    keys = [torch_key for torch_key, _ in name_map_for(cfg).values()]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{path}: missing {missing}")
    model.load_state_dict({k: sd[k] for k in keys}, strict=True)


def chunk_epochs(e: int, total_epochs: int, max_chunk: int, periods) -> int:
    """Multi-epoch-dispatch chunk size starting at epoch e (0-based): as
    many epochs as max_chunk allows, but never PAST an epoch where a periodic
    event fires (validation/save/rollout at (epoch+1) % period == 0); the
    chunk's last epoch may be the event epoch."""
    k = total_epochs - e
    for period in periods:
        if period > 0:
            k = min(k, period - (e % period))
    return max(1, min(k, max_chunk))


class TrainResult:
    def __init__(self, state, all_losses, val_train_losses, val_test_losses, val_accuracies, model):
        self.state = state
        self.all_losses = all_losses
        self.val_train_losses = val_train_losses
        self.val_test_losses = val_test_losses
        self.val_accuracies = val_accuracies
        self.model = model


def _nchw_to_device(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x, np.float32), (0, 2, 3, 1)))).to(dev)


def make_generators(cfg: TrainConfig, dev, rank: int = 0) -> tuple:
    """(dropout, {"shuffle", "augment"}) generators on ``dev``, seeded from
    ``cfg.seed`` +0, +1, +2. Under data parallel the dropout and shuffle
    streams are the rank's own, seeded from (seed, rank) as JAX folds the
    device index into its keys (rank 0 draws as the single-device run), and
    the augmentation stream is alike on every rank."""
    dropout, shuffle = (torch.Generator(device=dev).manual_seed(cfg.seed + i + rank * RANK_STRIDE) for i in range(2))
    return dropout, {"shuffle": shuffle, "augment": torch.Generator(device=dev).manual_seed(cfg.seed + 2)}


def _stage_stream(x_train, y_train, cfg: TrainConfig, dev, mesh):
    """The (S, L, H, W, C) and (S, L, H, W) stream on ``dev``: the whole
    stream in lanes, or under a mesh this rank's block, staged from its own
    slice of a stream cut to a multiple of D*L (so every rank has the same
    S; the JAX layout drops that remainder too)."""
    if mesh is None:
        X = _nchw_to_device(x_train, dev)
        Y = torch.from_numpy(np.asarray(y_train, np.float32).reshape(-1, cfg.im_height, cfg.im_width)).to(dev)
        return reshape_stream(X, Y, cfg.lanes)
    n = x_train.shape[0] - x_train.shape[0] % (mesh.size() * cfg.lanes)
    sl = process_local_slice(n)
    x = np.transpose(np.asarray(x_train[sl], np.float32), (0, 2, 3, 1))
    y = np.asarray(y_train[sl], np.float32).reshape(-1, cfg.im_height, cfg.im_width)
    return stage_global_stream(x, y, mesh, lanes_per_device=cfg.lanes)


def train(state: TrainState, x_train, x_val, y_train, y_val, cfg: TrainConfig, stop_time: float | None = None,
          generators: dict | None = None, mesh=None) -> TrainResult:
    """Run the epoch loop. Arrays arrive in the reference's NCHW contract and
    are staged to the device NHWC once. ``generators`` holds the "shuffle"
    and "augment" generators (needed when those are on). ``mesh``: the
    data-parallel route (parallel.mesh.make_mesh), ``state`` this rank's."""
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say("Train samples shape:", x_train.shape)
    say("Train labels shape:", y_train.shape)
    say("Validation samples shape:", x_val.shape)
    say("Validation labels shape:", y_val.shape)
    say(cfg)
    generators = generators or {}
    model, dev = state.model, state.hebb.device

    stop_time = cfg.stop_time if stop_time is None else stop_time
    if stop_time > 0:
        say(
            "Training started at: [%s] and set to stop at: [%s]"
            % (
                datetime.fromtimestamp(time.time()).strftime("%B %d, %Y %H:%M:%S"),
                datetime.fromtimestamp(stop_time).strftime("%B %d, %Y %H:%M:%S"),
            )
        )

    Xl, Yl = _stage_stream(x_train, y_train, cfg, dev, mesh)
    samples_count = Xl.shape[0]  # one recorded loss per step
    n_global = Xl.shape[0] * Xl.shape[1] * (1 if mesh is None else mesh.size())  # the augmentation draws for all
    xv = _nchw_to_device(x_val, dev)
    yv = torch.from_numpy(np.asarray(y_val, np.float32)).to(dev)

    if mesh is None:
        run_epochs = loop.make_multi_epoch_fn(loss_space=cfg.loss_space, shuffle=cfg.shuffle, augment=cfg.augment)
    else:
        run_epochs = dp.make_dp_multi_epoch_fn(mesh, loss_space=cfg.loss_space, trace_mode=cfg.trace_mode,
                                               shuffle=cfg.shuffle, augment=cfg.augment)
    run_params = cfg.as_run_params(stop_time, device=dev.type)

    def artifacts(prefix: str, wait: bool = True) -> None:
        """Rank 0 writes; under a mesh the others wait for it (``wait``)."""
        if lead:
            save_reference_artifacts(os.path.join(cfg.out_dir, prefix), model, run_params, all_losses,
                                     val_train_losses, val_test_losses, val_accuracies)
        if mesh is not None and wait:
            dist.barrier()

    all_losses: list[float] = []
    val_train_losses: list[float] = []
    val_test_losses: list[float] = []
    val_accuracies: list[float] = []
    loss_between_saves = 0.0
    last_save_epoch = 0
    use_chunks = cfg.epochs_per_dispatch > 1

    def _chunk_epochs(e: int) -> int:
        return chunk_epochs(e, cfg.epochs, cfg.epochs_per_dispatch, (cfg.val_every, cfg.save_every, cfg.rollout))

    try:
        epoch = 0
        while epoch < cfg.epochs:
            k_epochs = _chunk_epochs(epoch) if use_chunks else 1
            if cfg.debug:
                say("Starting epoch %d/%d." % (epoch + 1, cfg.epochs))
            epoch_start_time = time.time()

            # the draws of the K epochs, in the one-epoch path's order (each stream its own generator)
            perms = choices = None
            if cfg.shuffle:
                perms = dp.shard_perms(Xl, generators["shuffle"], k_epochs)
            if cfg.augment:
                choices = torch.stack([draw_augment_choices(n_global, generators["augment"])
                                       for _ in range(k_epochs)])
                if mesh is not None:
                    choices = dp.shard_choices(choices, cfg.lanes, mesh)
            state, losses = run_epochs(state, Xl, Yl, perms, choices, epochs=k_epochs)
            losses_rows = losses.cpu().numpy().astype(np.float64)  # the dispatch's one transfer

            if not np.all(np.isfinite(losses_rows)):
                # save before dying, with the losses up to the first non-finite epoch row
                # (later epochs of the chunk never happened from the loop's view)
                bad_row = int(np.argmax(~np.isfinite(losses_rows).all(axis=1)))
                all_losses.extend(losses_rows[: bad_row + 1].reshape(-1).tolist())
                artifacts("NAN_ABORT")
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch + bad_row} "
                    f"(dispatch chunk starting at epoch {epoch}, row {bad_row}); "
                    "state saved to NAN_ABORT_*"
                )

            epoch_time = (time.time() - epoch_start_time) / k_epochs
            for row in losses_rows:
                all_losses.extend(row.tolist())
                if cfg.quirk_epoch_loss:
                    # train.py:115 quirk: indexes ONE element (missing ':')
                    epoch_loss = float(np.mean(all_losses[-samples_count]))
                else:
                    epoch_loss = float(np.mean(all_losses[-samples_count:]))
                loss_between_saves += epoch_loss

            epoch += k_epochs - 1  # the bookkeeping below sees the chunk's last epoch
            next_k = _chunk_epochs(epoch + 1) if (use_chunks and epoch + 1 < cfg.epochs) else 1
            next_epoch_finish_time = epoch_time * next_k + time.time()
            timed_out = stop_time > 0 and next_epoch_finish_time >= stop_time
            if mesh is not None and stop_time > 0:  # rank 0's clock decides for all: no rank may stop alone
                flag = torch.tensor([float(timed_out)], device=dev)
                dist.broadcast(flag, src=0)
                timed_out = bool(flag.item())
            terminate_training = timed_out or (epoch + 1) == cfg.epochs

            if cfg.debug:
                say(
                    "Epoch finished! Loss: %f, time spent: %d, terminate due to time limits: %s"
                    % (epoch_loss, epoch_time, terminate_training)
                )

            if (epoch + 1) % cfg.val_every == 0 or terminate_training:
                val_acc, val_loss = eval_net(model, xv, yv, device=dev)
                model.train()  # eval_net leaves it in eval mode; the parameters stay where the graph holds them
                val_train_losses.append(epoch_loss)
                val_test_losses.append(val_loss)
                val_accuracies.append(val_acc)
                if cfg.debug:
                    say("Validation accuracy: %f, loss: %f" % (val_acc, val_loss))
                    if cfg.plastic:
                        say("Eta:", model.eta.detach().cpu().numpy())
                    sys.stdout.flush()

            if (epoch + 1) % cfg.save_every == 0 or terminate_training:
                if cfg.debug:
                    say("Saving checkpoint files for epoch:", epoch)
                epochs_since_last_cp = max(epoch - last_save_epoch, 1)
                last_save_epoch = epoch
                if cfg.debug:
                    say(
                        "Average loss over the last %d epochs: %f"
                        % (epochs_since_last_cp, loss_between_saves / epochs_since_last_cp)
                    )
                if epoch > 100:
                    # train.py:167-170: one element 100 epochs back under the same quirk flag
                    if cfg.quirk_epoch_loss:
                        loss_last_100 = float(np.mean(all_losses[-samples_count * 100]))
                    else:
                        loss_last_100 = float(np.mean(all_losses[-samples_count * 100 :]))
                    if cfg.debug:
                        say("Average loss over the last 100 epochs: ", loss_last_100)
                loss_between_saves = 0.0

                prefix = "train"
                if (epoch + 1) % cfg.rollout == 0 and not terminate_training:
                    prefix = prefix + "_" + str(epoch + 1)
                artifacts(prefix)
                save_train_state(os.path.join(cfg.out_dir, RESUME_STATE), state, generators, mesh=mesh)

            if terminate_training:
                if timed_out:
                    say("Training terminated due to the time limits!")
                    say("Current epoch %d, train loss: %s" % (epoch, epoch_loss))
                    say(
                        "Stop time limit: %d, estimated time of next epoch end: %d"
                        % (stop_time, next_epoch_finish_time)
                    )
                break
            epoch += 1
    except KeyboardInterrupt:
        artifacts("INTERRUPTED", wait=False)  # another rank may not have been interrupted
        say("Saved interrupt")
        raise

    return TrainResult(state, all_losses, val_train_losses, val_test_losses, val_accuracies, model)


class _sigterm_as_interrupt:
    """Route SIGTERM through the KeyboardInterrupt save path (cloud
    schedulers preempt with SIGTERM). No-op off the main thread, where
    signal.signal raises ValueError."""

    def __enter__(self):
        import signal

        def raise_interrupt(signum, frame):
            raise KeyboardInterrupt

        self._prev = None
        try:
            self._prev = signal.signal(signal.SIGTERM, raise_interrupt)
        except ValueError:
            pass
        return self

    def __exit__(self, *exc):
        import signal

        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
        return False


def start_train(x_train, x_valid, y_train, y_valid, cfg: TrainConfig, device=None, mesh=None) -> TrainResult:
    """Create (or resume) the model and run training (reference start_train,
    train.py:213-314). ``device=None`` means CUDA and raises without it;
    pass ``device="cpu"`` to run the plain versions on the CPU.

    ``cfg.devices > 1`` takes the data-parallel route, on a mesh of that
    many ranks (parallel.mesh.make_mesh: raises, naming torchrun, without a
    process group of that size and of the device's backend); a ``mesh``
    handed in takes it at its size, which must be ``cfg.devices``. Under a
    mesh each rank runs this on its own device (a CUDA device without an
    index is the rank's current one)."""
    dev = resolve_device(device)
    rank = 0
    if mesh is None and cfg.devices > 1:
        mesh = make_mesh(cfg.devices, device=dev)
    if mesh is not None:
        if mesh.size() != cfg.devices:
            raise ValueError(f"the mesh has {mesh.size()} ranks and cfg.devices is {cfg.devices}")
        dev, rank = rank_device(dev), dist.get_rank()
    os.makedirs(cfg.out_dir, exist_ok=True)

    with matmul_precision(cfg.matmul_precision):
        model = build_model(cfg)
        dropout, generators = make_generators(cfg, dev, rank)
        state = create_train_state(model, cfg.lr, cfg.gamma, cfg.steplr, lanes=cfg.lanes, generator=dropout,
                                   device=dev)
        if mesh is not None:
            dp.dp_state_sharding(state, mesh)
        say = print if rank == 0 else (lambda *a, **k: None)
        if cfg.resume_orbax:
            load_train_state(cfg.resume_orbax, state, generators, mesh=mesh)
            say("TrainState restored from %s (step %d)" % (cfg.resume_orbax, state.step))
        elif cfg.load:
            load_reference_weights(model, cfg.model_path, cfg)
            say("Model loaded from %s" % cfg.model_path)

        with _sigterm_as_interrupt():
            return train(state, x_train, x_valid, y_train, y_valid, cfg, stop_time=cfg.stop_time,
                         generators=generators, mesh=mesh)
