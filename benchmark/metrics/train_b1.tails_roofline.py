"""train_b1.tails_roofline: portbench.readers.train_tails_roofline in cell unetpres-n16.train-b1 (moves train_b1_samples_per_s)."""

from portbench.readers import train_tails_roofline as read  # noqa: F401
