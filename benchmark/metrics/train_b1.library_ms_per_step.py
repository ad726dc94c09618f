"""train_b1.library_ms_per_step: portbench.readers.library_ms_per_step in cell unetpres-n16.train-b1 (moves train_b1_samples_per_s)."""

from portbench.readers import library_ms_per_step as read  # noqa: F401
