from plastic_unet_tpu_torch.models.coord_conv import CoordConvUNet  # noqa: F401
from plastic_unet_tpu_torch.models.unet_classic import UNetP  # noqa: F401
from plastic_unet_tpu_torch.models.unet_res import PlasticOutput, UNetPRes  # noqa: F401
