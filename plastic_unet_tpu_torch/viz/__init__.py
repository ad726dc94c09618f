"""Offline plots (counterpart of plastic_unet_tpu.viz); see viz.plots."""

from plastic_unet_tpu_torch.viz.plots import (  # noqa: F401
    load_train_history,
    moving_average,
    plot_best_iou,
    plot_coverage,
    plot_depth,
    plot_history,
    plot_image_mask,
    plot_test_check,
    plot_train_check,
    render_data,
)
