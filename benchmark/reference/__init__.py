"""Plain PyTorch references of the benchmark's models, frozen here: one file
per architecture, ``reference/<arch>.py``, named by the configuration's
``arch`` (as ``flops/<arch>.py`` is).

Each architecture is written from its published model in NCHW with
``torch.nn.functional`` alone, in float32: no kernel, cache or batching
trick. They import nothing of ``plastic_unet_tpu_torch`` nor of the JAX
package. Their state_dict keys are the published model's, which are the
keys the port loads, so the benchmark hands the same tensors to both.

Beside its model, an architecture's file exports all that the harness
needs to know of it:

* ``Reference``: the ``nn.Module`` class, built from the configuration's
  ``model``; ``forward(x_nchw, state, generator=None) -> (logits, probs,
  new_state)``, ``generator`` drawing the dropout masks (None is eval) and
  ``state`` None for an architecture that carries none.
* ``PORT``: ``"module:Class"``, the port's model class that takes the same
  state_dict; a string, imported only when the port's model is built.
* ``initial_state(ref, batch, device)``: the state at the start of each
  lifetime (training) and of each served chunk, or None.
* ``init_weights(shell, generator) -> dict``: the seeded rule for every key
  of the state_dict, drawn from ``generator`` on its device; ``shell`` is
  the ``Reference`` on the meta device.
"""
