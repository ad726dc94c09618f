from plastic_unet_tpu_torch.utils.precision import matmul_precision  # noqa: F401
