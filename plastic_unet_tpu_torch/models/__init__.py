from plastic_unet_tpu_torch.models.unet_res import PlasticOutput, UNetPRes  # noqa: F401
