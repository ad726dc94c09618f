"""train.conv3x3_roofline: portbench.spans.conv3x3_roofline in cell unetpres-n16.train-l128 (moves train_samples_per_s)."""

from portbench.spans import conv3x3_roofline as read  # noqa: F401
