"""Plain PyTorch references of the benchmark's models, frozen here.

Each architecture is written from the published model (yaricom/Plastic-UNet)
in NCHW with ``torch.nn.functional`` alone, in float32: no kernel, cache or
batching trick. They import nothing of ``plastic_unet_tpu_torch`` nor of the
JAX package. Their state_dict keys are the published model's, which are the
keys the port loads, so the benchmark hands the same tensors to both.
"""
