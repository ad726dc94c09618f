"""train_b1.mfu: portbench.readers.train_mfu in cell unetpres-n16.train-b1 (moves train_b1_samples_per_s)."""

from portbench.readers import train_mfu as read  # noqa: F401
