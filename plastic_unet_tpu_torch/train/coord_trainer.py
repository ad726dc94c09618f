"""CoordConv U-Net trainer (counterpart of plastic_unet_tpu.train.coord_trainer;
the reference's Keras path, src/coord_conv_script.py:203-299).

Behaviour kept from the JAX trainer:
  * minibatches of ``batch_size`` (8), Adam at 1e-3 (torch's Adam computes
    optax.adam's update, ``-lr * mu_hat / (sqrt(nu_hat) + 1e-8)``, in
    another order of rounding), binary cross-entropy on the sigmoid output
    with Keras's 1e-7 clip;
  * validation_split: the LAST 10% of the arrays, taken before any shuffle
    (Keras model.fit); each epoch permutes the training part with
    ``np.random.default_rng(seed)``, so both packages see the same batches,
    and drops the remainder batch;
  * the mean_iou metric (tf.metrics.mean_iou over the thresholds
    0.5:0.05:0.95, 2 classes, a class counted only where its union is
    nonzero), per epoch the mean over the batches;
  * ModelCheckpoint(save_best_only on val_loss) to ``model_file``, the last
    parameters to ``model_file + "_final"``, the history pickle
    ``{loss, val_loss, mean_iou, val_mean_iou}`` beside it;
  * TimedStopping: stop when the predicted end of the next epoch passes the
    budget.

The loop is a plain eager loop on the device (the JAX ``lax.scan`` over an
epoch is the TPU's design), under utils.precision.training_numerics.

Saved files: the port has no flax, so it neither reads nor writes the JAX
trainer's flax-msgpack parameter file. :func:`save_coord_model` writes
``torch.save`` of the model's state_dict at the same paths; parameters
trained by the JAX package reach the port through
utils.torch_interop.coord_conv_name_map and state_dict_from_jax_params.
"""

from __future__ import annotations

import pickle
import time

import numpy as np
import torch

from plastic_unet_tpu_torch import resolve_device
from plastic_unet_tpu_torch.models.coord_conv import CoordConvUNet
from plastic_unet_tpu_torch.utils.precision import serving_numerics, training_numerics

_KERAS_EPS = 1e-7
_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def keras_bce(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Keras binary_crossentropy: probs clipped to [eps, 1-eps]."""
    p = torch.clamp(probs, _KERAS_EPS, 1.0 - _KERAS_EPS)
    y = targets
    return -torch.mean(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


def keras_mean_iou(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """The reference's mean_iou metric: the 2-class mean IoU of a confusion
    matrix (a class counted where its union is nonzero), averaged over the
    thresholds 0.5:0.05:0.95."""
    t = (y_true > 0.5).reshape(1, -1)
    thr = torch.as_tensor(_THRESHOLDS, dtype=torch.float32, device=y_pred.device)[:, None]
    p = y_pred.reshape(1, -1) > thr  # (10, N)
    tp = (t & p).sum(dim=1).float()
    fp = (~t & p).sum(dim=1).float()
    fn = (t & ~p).sum(dim=1).float()
    tn = (~t & ~p).sum(dim=1).float()
    iou_fg = tp / torch.clamp_min(tp + fp + fn, 1.0)
    iou_bg = tn / torch.clamp_min(tn + fp + fn, 1.0)
    denom = (tp + fp + fn > 0).float() + (tn + fp + fn > 0).float()
    return torch.mean((iou_fg + iou_bg) / torch.clamp_min(denom, 1.0))


def construct_model(im_height: int, im_width: int, im_chan: int, with_r: bool = True,
                    scale_input: bool = True) -> CoordConvUNet:
    """The CoordConv U-Net with its weights drawn from seed 0, as the JAX
    function draws them from PRNGKey(0) (reference construct_model). The
    port's module carries its parameters, so where the JAX function returns
    (model, params) this returns the model; the height and width are the JAX
    signature's and size nothing."""
    return CoordConvUNet(im_chan=im_chan, with_r=with_r, scale_input=scale_input,
                         generator=torch.Generator().manual_seed(0))


def _as_device(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def fit_epoch(model: CoordConvUNet, opt: torch.optim.Optimizer, X: torch.Tensor, Y: torch.Tensor,
              perm: torch.Tensor, batch_size: int) -> tuple[list, list]:
    """One epoch of minibatch steps over ``X[perm]`` in full batches (the
    caller cuts ``perm`` to them); returns the per-batch losses and mean IoUs
    as device scalars, read by nothing until the caller syncs."""
    losses, ious = [], []
    with training_numerics():
        for i in range(len(perm) // batch_size):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            x, y = X[idx], Y[idx]
            opt.zero_grad(set_to_none=True)
            p = model(x)
            loss = keras_bce(p, y)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            ious.append(keras_mean_iou(y, p.detach()))
    return losses, ious


def do_training(model: CoordConvUNet, X_train: np.ndarray, Y_train: np.ndarray, epochs: int,
                max_train_time: float, model_file: str, batch_size: int = 8, validation_split: float = 0.1,
                lr: float = 1e-3, seed: int = 0, verbose: int = 0, device=None):
    """Train ``model`` in place with model.fit semantics (reference
    do_training); X (N, H, W, C) in 0..255, Y (N, H, W, 1). Returns (model,
    history). ``device=None`` means CUDA and raises without it."""
    print("Training started at: %d sec and set to be run for: %d sec" % (time.time(), max_train_time))
    stop_time = time.time() + max_train_time if max_train_time > 0 else -1
    dev = resolve_device(device)
    model = model.to(dev).train()

    n = len(X_train)
    n_val = int(n * validation_split)
    X_tr, Y_tr = _as_device(X_train[: n - n_val], dev), _as_device(Y_train[: n - n_val], dev)
    Xv, Yv = _as_device(X_train[n - n_val:], dev), _as_device(Y_train[n - n_val:], dev)

    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)  # optax.adam's update
    history = {"loss": [], "val_loss": [], "mean_iou": [], "val_mean_iou": []}
    best_val = np.inf
    rng = np.random.default_rng(seed)
    nb = len(X_tr) // batch_size  # full batches only, as the JAX scan

    ran_epochs = 0
    for epoch in range(epochs):
        epoch_start = time.time()
        perm = torch.from_numpy(rng.permutation(len(X_tr))[: nb * batch_size]).to(dev)
        losses, ious = fit_epoch(model, opt, X_tr, Y_tr, perm, batch_size)
        model.eval()
        with torch.no_grad(), serving_numerics():
            pv = model(Xv)
            val_loss, val_miou = keras_bce(pv, Yv), keras_mean_iou(Yv, pv)
        model.train()
        loss, miou = torch.stack(losses).mean(), torch.stack(ious).mean()
        loss, miou, val_loss, val_miou = (float(loss), float(miou), float(val_loss), float(val_miou))
        history["loss"].append(loss)
        history["mean_iou"].append(miou)
        history["val_loss"].append(val_loss)
        history["val_mean_iou"].append(val_miou)
        ran_epochs = epoch + 1
        if verbose:
            print(f"epoch {epoch + 1}: loss={loss:.4f} mean_iou={miou:.4f} val_loss={val_loss:.4f} "
                  f"val_mean_iou={val_miou:.4f}")

        if val_loss < best_val:  # ModelCheckpoint(save_best_only): monitor val_loss
            best_val = val_loss
            save_coord_model(model_file, model)

        epoch_time = time.time() - epoch_start  # TimedStopping: the predicted next-epoch end passes the budget
        if stop_time > 0 and (epoch_time + time.time()) >= stop_time:
            print("Training terminated due to the time limits............")
            break

    print("Traing Complete! In: %d epochs" % ran_epochs)
    final_file = model_file + "_final"
    save_coord_model(final_file, model)

    history_file_name = final_file + "_history.pickle"
    with open(history_file_name, "wb") as file_pi:
        pickle.dump(history, file_pi)
    print("History dump Complete to file: ", history_file_name)
    return model, history


def save_coord_model(path: str, model: CoordConvUNet) -> None:
    """``torch.save`` of the state_dict, on the CPU (the module docstring)."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_coord_model(path: str, im_height: int, im_width: int, im_chan: int, with_r: bool = True) -> CoordConvUNet:
    """A :func:`save_coord_model` file into a fresh model, on the CPU."""
    model = construct_model(im_height, im_width, im_chan, with_r)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return model


def start_prediction(model: CoordConvUNet, X_test: np.ndarray, sizes_test, batch_size: int = 8, verbose: int = 0,
                     device=None) -> list:
    """Predict in chunks of 64 and resize each mask back to its original
    size (reference start_prediction). X_test: (N, H, W, C) in 0..255.
    ``batch_size`` is the JAX signature's and unused, as there."""
    from plastic_unet_tpu_torch.data.images import _resize_bilinear

    dev = resolve_device(device)
    model = model.to(dev).eval()
    preds = []
    with torch.no_grad(), serving_numerics():
        for i in range(0, len(X_test), 64):
            preds.append(model(_as_device(X_test[i:i + 64], dev)).cpu().numpy())
    preds = np.concatenate(preds, axis=0)[..., 0]
    out = []
    for i in range(len(preds)):
        h, w = sizes_test[i]
        m = preds[i]
        out.append(m if m.shape == (h, w) else _resize_bilinear(m, (h, w)))
    print("Prediction complete! Output images shape:", out[0].shape)
    return out
