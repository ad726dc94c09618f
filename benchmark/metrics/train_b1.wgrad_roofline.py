"""train_b1.wgrad_roofline: portbench.spans.wgrad_roofline in cell unetpres-n16.train-b1 (moves train_b1_samples_per_s)."""

from portbench.spans import wgrad_roofline as read  # noqa: F401
