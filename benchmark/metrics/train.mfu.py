"""train.mfu: portbench.readers.train_mfu in cell unetpres-n16.train-l128 (moves train_samples_per_s)."""

from portbench.readers import train_mfu as read  # noqa: F401
