"""train.wgrad_roofline: portbench.spans.wgrad_roofline in cell unetpres-n16.train-l128 (moves train_samples_per_s)."""

from portbench.spans import wgrad_roofline as read  # noqa: F401
