"""train.tails_roofline: portbench.readers.train_tails_roofline in cell unetpres-n16.train-l128 (moves train_samples_per_s)."""

from portbench.readers import train_tails_roofline as read  # noqa: F401
